"""The port's flash-attention backward (horovod_tpu_torch/ops/flash_attention.py
``_FlashFn``) against ``jax.vjp`` of the JAX package's Pallas kernels
(``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), run in interpret mode on the CPU.

On the CPU the port's ``_FlashFn`` runs the plain forward and the plain
backward (``_flash_bwd_plain``), so these tests hold its wiring (saved
tensors, the Δ − dLSE fold, layouts) and the plain backward's arithmetic
to the reference; chip_smoke.py holds the CUDA kernels to the plain
backward on the card. Cotangents are random on both outputs, O and LSE.

Tolerances: float32 <= 1e-5 (the two sum the blocks in different orders;
the gradients are of size ~1-5). bfloat16: both compute in float32 from
the same bf16 inputs and round the gradients to bf16 at the end, from
float32 values that agree to ~1e-6; where that rounding falls
differently they differ by one bf16 step, at most 2**-7 of the value:
1e-5 + 1e-2 |dx|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.ops.pallas_attention import \
    flash_attention_lse as jax_flash_lse  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32, 1e-5, 0.0),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-5, 1e-2)}


def _inputs(seed, shape):
    """q, k, v, dO [B, S, H, D] and dLSE [B, H, S], float32."""
    rng = np.random.default_rng(seed)
    B, S, H, _ = shape
    return ([rng.standard_normal(shape).astype(np.float32)
             for _ in range(4)]
            + [rng.standard_normal((B, H, S)).astype(np.float32)])


def _port_grads(q, k, v, do, dlse, mode, dtype, block):
    q, k, v = (torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_lse(q, k, v, mode=mode, block=block)
    return torch.autograd.grad((o, lse), (q, k, v),
                               (torch.tensor(do).to(dtype),
                                torch.tensor(dlse)))


_MODES = ("none", "diag", "strict")
_SHAPE = (2, 128, 2, 32)


@functools.lru_cache(maxsize=None)
def _pallas_grads():
    """{(mode, dtype): (dq, dk, dv)} of ``jax.vjp`` of the Pallas kernels
    on ``_inputs(11, _SHAPE)``, every mode and dtype in one jitted
    program (one compile, where one a case would be six)."""
    def every(q, k, v, do, dlse):
        out = {}
        for m in _MODES:
            for d, (jdt, *_) in _DT.items():
                _, vjp = jax.vjp(lambda q, k, v, m=m: jax_flash_lse(
                    q, k, v, mode=m, block=64, interpret=True),
                    *(x.astype(jdt) for x in (q, k, v)))
                out[m, d] = vjp((do.astype(jdt), dlse))
        return out

    return jax.jit(every)(*_inputs(11, _SHAPE))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", _MODES)
def test_grads_match_pallas(mode, dtype):
    jdt, tdt, atol, rtol = _DT[dtype]
    q, k, v, do, dlse = _inputs(11, _SHAPE)
    want = _pallas_grads()[mode, dtype]
    got = _port_grads(q, k, v, do, dlse, mode, tdt, 64)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == (2, 128, 2, 32)
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                   rtol=rtol)
    if mode == "strict":   # row 0 sees no key: no gradient in or out
        assert torch.all(got[0][:, 0] == 0)
        assert np.all(np.asarray(want[0])[:, 0] == 0)


@pytest.mark.parametrize("mode", ["none", "diag", "strict"])
def test_ragged_grads_match_autograd_of_plain(mode):
    """S with no multiple-of-8 divisor (the reference refuses it): the
    port's _FlashFn over the ragged blocks against autograd through the
    plain forward in one block, LSE cotangent included."""
    q, k, v, do, dlse = _inputs(12, (2, 100, 2, 32))
    got = _port_grads(q, k, v, do, dlse, mode, torch.float32, 64)
    qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    o, lse = fa._flash_plain(qt, kt, vt, mode, 32 ** -0.5, 100)
    want = torch.autograd.grad((o, lse), (qt, kt, vt),
                               (torch.tensor(do), torch.tensor(dlse)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    if mode == "strict":
        assert torch.all(got[0][:, 0] == 0)


def test_unused_lse_counts_as_zero_cotangent():
    """Only O is used: the LSE's cotangent is zero (autograd materializes
    it), as the reference's custom_vjp gets an explicit zero."""
    q, k, v, do, _ = _inputs(13, (1, 64, 2, 32))
    zero = np.zeros((1, 2, 64), np.float32)
    want = _port_grads(q, k, v, do, zero, "diag", torch.float32, 32)
    qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=True, block=32)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
