"""The port's training loss (horovod_tpu_torch/models/transformer.py
``loss_fn`` under autograd) against ``jax.value_and_grad`` of the JAX
package's, on ``tiny()`` (dense; MoE is in test_torch_train_moe.py), and
two AdamW steps through ``make_train_step`` against ``optax.adamw``.

Every case compares the loss and every gradient leaf, for gather and
flash attention (flash runs the plain forward and backward on the CPU),
remat on and off, loss_chunk 0 and 16.

Tolerances: float32, the loss within 1e-5 and each leaf within 1e-5 in
relative norm |g - g_jax| / |g_jax| (summation order only; measured
<= 2e-6). bfloat16: the loss within 2e-3 and each leaf within 8e-2 in
relative norm: both compute in bf16 and round at different places; one
rounding is <= 2**-9 relative, and a leaf's gradient passes through some
twenty rounded ops of the two-layer backward, ~4e-2 where the errors add.
AdamW: after two steps of lr 1e-4 every param within 1e-5 of optax's (a
twentieth of the 2e-4 the steps move it; an element whose gradient is at
float32 noise can move by a different fraction of lr).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    make_train_step, tree_flatten_with_path, tree_leaves)
from .torch_train_parity import JaxRefs, rel_errors  # noqa: E402

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 8e-2)}


@pytest.fixture(scope="module")
def refs():
    return JaxRefs(0)


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["gather", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(refs, dtype, impl, remat, loss_chunk):
    want_loss, want = refs.get(dtype, impl)
    loss, got = refs.port(dtype, impl, remat, loss_chunk)
    tol_loss, tol_grad = TOL[dtype]
    assert abs(loss - want_loss) <= tol_loss
    rel = rel_errors(got, want)
    assert len(rel) == 20
    assert max(rel.values()) <= tol_grad, max(rel.items(), key=lambda x: x[1])


def test_remat_and_chunks_recompute_in_the_backward(refs, monkeypatch):
    """remat reruns every block's forward (its attention included) in the
    backward, and the chunked loss reruns each chunk's projection, as the
    reference's jax.checkpoint does; without remat nothing reruns."""
    calls = {"attn": 0, "chunk": 0}
    plain, nll_sum = fa._flash_plain, ttfm._nll_sum

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fa, "_flash_plain", count("attn", plain))
    monkeypatch.setattr(ttfm, "_nll_sum", count("chunk", nll_sum))
    for remat, want in ((False, (2, 6)), (True, (4, 6))):
        calls.update(attn=0, chunk=0)
        refs.port("float32", "flash", remat, 16)
        assert (calls["attn"], calls["chunk"]) == want   # 2 layers, 3 chunks


def test_two_adamw_steps_match_optax(refs):
    """make_train_step with AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=1e-4) against optax.adamw(1e-4), the bench's optimizer
    (torch's default weight_decay is 1e-2, optax's 1e-4)."""
    cfg = dataclasses.replace(jtfm.tiny(), dtype="float32",
                              attn_impl="gather")
    tx = optax.adamw(1e-4)

    @jax.jit
    def jstep(params, state, batch):
        loss, grads = jax.value_and_grad(jtfm.loss_fn)(params, batch, cfg)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    params, state = refs.params, tx.init(refs.params)
    want_losses = []
    for _ in range(2):
        params, state, loss = jstep(params, state, {"tokens": refs.tokens})
        want_losses.append(float(loss))

    tp = params_from_jax(jax.tree.map(np.asarray, refs.params), device="cpu")
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(tp)]
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    tcfg = dataclasses.replace(ttfm.tiny(), dtype="float32",
                               attn_impl="gather")
    step = make_train_step(lambda p, b: ttfm.loss_fn(p, b, tcfg), opt)
    batch = {"tokens": torch.tensor(refs.tokens).long()}
    losses = [step(tp, batch).item() for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=0)
    want = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = tree_flatten_with_path(tp)
    assert [p for p, _ in got] == list(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                   atol=1e-5, rtol=0, err_msg=path)
