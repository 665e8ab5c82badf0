"""The port's transformer (horovod_tpu_torch/models/transformer.py) against
the JAX package's, on the CPU, with params converted from the JAX init.

Tolerances: float32 logits within 1e-5 (same math, different summation
order in the matmuls); bfloat16 within 3e-2 (compute rounds to bf16 at
every op, and the two frameworks round at different places — 3e-2 is a
few bf16 steps at the logits' size of ~0.7); the loss within 1e-5 in
float32. bfloat16 MoE: top-1 routing at a near-tie of the bf16 gates can
send a token to the other expert (JAX's own jitted and eager forwards
disagree at one position of these inputs), so there up to 2 of the 128
positions may exceed the tolerance; every other position must hold it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402

_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jax_params():
    """JAX init per expert count, made once (params are float32 whatever
    the compute dtype, so every case of one expert count shares them)."""
    init = jax.jit(jtfm.init_params, static_argnums=1)
    return {ne: init(jax.random.PRNGKey(ne), jtfm.tiny(ne)) for ne in (0, 2)}


def _pair(jax_params, n_experts, **kw):
    jcfg = dataclasses.replace(jtfm.tiny(n_experts), **kw)
    tcfg = dataclasses.replace(ttfm.tiny(n_experts), **kw)
    jp = jax_params[n_experts]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def test_config_and_params_mirror_jax(jax_params):
    assert dataclasses.asdict(ttfm.bert_large()) == \
        dataclasses.asdict(jtfm.bert_large())
    for ne, jp in jax_params.items():
        tp = ttfm.init_params(ttfm.tiny(ne), torch.Generator().manual_seed(0),
                              device="cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        shapes_t = {jax.tree_util.keystr(p): tuple(np.shape(x))
                    for p, x in jax.tree_util.tree_leaves_with_path(
                        jax.tree.map(lambda t: t.numpy(), tp))}
        assert shapes_t == {jax.tree_util.keystr(p): tuple(x.shape)
                            for p, x in flat_j}
    with pytest.raises(ValueError):
        ttfm.TransformerConfig(attn_impl="fast")


@pytest.mark.parametrize("impl", ["gather", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_experts", [0, 2])
def test_logits_match_jax(jax_params, n_experts, dtype, impl):
    jcfg, tcfg, jp, tp = _pair(jax_params, n_experts, dtype=dtype,
                               attn_impl=impl)
    toks = _tokens(n_experts, (2, 64), jcfg.vocab_size)
    want = np.asarray(jax.jit(jtfm.forward, static_argnums=2)(
        jp, toks, jcfg)).astype(np.float32)
    got = ttfm.forward(tp, torch.tensor(toks).long(), tcfg)
    assert got.dtype == tcfg.compute_dtype
    err = np.abs(got.float().numpy() - want).max(-1)          # [B, S]
    allowed = 2 if (n_experts and dtype == "bfloat16") else 0
    assert (err > _TOL[dtype]).sum() <= allowed, err.max()


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("n_experts", [0, 2])
def test_loss_matches_jax(jax_params, n_experts, loss_chunk):
    jcfg, tcfg, jp, tp = _pair(jax_params, n_experts, dtype="float32",
                               loss_chunk=loss_chunk)
    toks = _tokens(10 + n_experts, (2, 49), jcfg.vocab_size)
    want = float(jax.jit(jtfm.loss_fn, static_argnums=2)(
        jp, {"tokens": toks}, jcfg))
    got = ttfm.loss_fn(tp, {"tokens": torch.tensor(toks).long()}, tcfg)
    assert abs(float(got) - want) < 1e-5
    if loss_chunk:   # chunked and full losses agree within the port too
        full = ttfm.loss_fn(tp, {"tokens": torch.tensor(toks).long()},
                            dataclasses.replace(tcfg, loss_chunk=0))
        assert abs(float(got) - float(full)) < 1e-5


def test_resolve_attn_rules():
    cfg = ttfm.bert_large()
    assert ttfm.resolve_attn(cfg, 4096, "cpu") == "gather"
    assert ttfm.resolve_attn(cfg, 1, "cuda", kv_len=8192) == "gather"
    assert ttfm.resolve_attn(cfg, 1024, "cuda") == "flash"
    assert ttfm.resolve_attn(cfg, 512, "cuda") == "gather"
    assert ttfm.resolve_attn(cfg, 512, "cuda", kv_len=8192) == "flash"
    forced = dataclasses.replace(cfg, attn_impl="flash")
    assert ttfm.resolve_attn(forced, 1, "cpu") == "flash"
