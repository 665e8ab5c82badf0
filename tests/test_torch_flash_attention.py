"""The port's flash-attention forward (horovod_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and the wrapper's dispatch to the kernel or plain route (the backward's
parity tests are in test_torch_flash_attention_bwd.py).

On the CPU the port's wrapper runs the kernel's plain version (an
online-softmax loop over K blocks in float32), so these tests hold the
plain version to the Pallas ``_fwd_kernel``; chip_smoke.py holds the CUDA
kernel to the plain version on the card.

Tolerances: float32 <= 2e-5 (the two sum the blocks in different
orders); bfloat16 <= 2e-2 on O (O is rounded to bf16, whose spacing is
2**-7 near 1, and the f32 values it rounds from differ by rounding of the
block sums) and 2e-5 on the LSE, which stays float32.
"""

import functools
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from horovod_tpu.ops.pallas_attention import \
    flash_attention_lse as jax_flash_lse  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32, 2e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


_MODES = ("none", "diag", "strict")


@functools.lru_cache(maxsize=None)
def _pallas(S, D):
    """{(mode, dtype): (O, LSE)} of the Pallas kernel on ``_inputs`` of
    one shape, every mode and dtype in one jitted program (one compile
    a shape, where one a case would be six)."""
    q, k, v = _inputs(S * 7 + D, (2, S, 2, D))

    def every(q, k, v):
        return {(m, d): jax_flash_lse(
            *(x.astype(_DT[d][0]) for x in (q, k, v)), mode=m, block=64,
            interpret=True) for m in _MODES for d in _DT}

    return jax.jit(every)(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("S,D", [(128, 32), (128, 64), (192, 32), (192, 64)])
def test_plain_matches_pallas(S, D, mode, dtype):
    jdt, tdt, tol = _DT[dtype]
    q, k, v = _inputs(S * 7 + D, (2, S, 2, D))
    jo, jl = _pallas(S, D)[mode, dtype]
    to, tl = fa.flash_attention_lse(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), mode=mode, block=64)
    assert to.dtype == tdt and tuple(to.shape) == (2, S, 2, D)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 2, S)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)


def test_strict_masked_row_sentinel():
    """Row 0 under strict sees no key: O = 0 and LSE = -1e30, not NaN."""
    q, k, v = (torch.tensor(x) for x in _inputs(1, (1, 64, 2, 32)))
    o, lse = fa.flash_attention_lse(q, k, v, mode="strict", block=32)
    assert torch.all(o[:, 0] == 0)
    assert torch.all(lse[:, :, 0] == fa.NEG_INF)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()


def test_ragged_seq_is_masked_not_refused():
    """S with no multiple-of-8 divisor: the reference refuses it, the
    port masks the ragged last block; the result equals one big block."""
    q, k, v = (torch.tensor(x) for x in _inputs(2, (1, 100, 2, 32)))
    o, lse = fa.flash_attention_lse(q, k, v, mode="diag", block=64)
    o1, lse1 = fa._flash_plain(q, k, v, "diag", 32 ** -0.5, 100)
    torch.testing.assert_close(o, o1, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, lse1, atol=2e-6, rtol=0)


def _fake(device, requires_grad):
    return types.SimpleNamespace(device=torch.device(device),
                                 requires_grad=requires_grad)


def test_dispatch_routes_grad_calls_to_the_function():
    """The wrapper's dispatch alone: a CUDA call that needs a gradient
    goes to the kernel route through _FlashFn (it no longer raises), a CPU
    call to the plain route, and mixed devices still raise."""
    args = [_fake("cuda", True), _fake("cuda", False), _fake("cuda", False)]
    assert fa._route(*args) == ("kernel", True)
    with torch.no_grad():
        assert fa._route(*args) == ("kernel", False)
    assert fa._route(*[_fake("cuda", False)] * 3) == ("kernel", False)
    assert fa._route(*[_fake("cpu", True)] * 3) == ("plain", True)
    assert fa._route(*[_fake("cpu", False)] * 3) == ("plain", False)
    with pytest.raises(ValueError):
        fa._route(_fake("cpu", False), _fake("cuda", False),
                  _fake("cuda", False))
    q, k, v = (torch.tensor(x).requires_grad_()
               for x in _inputs(3, (1, 64, 2, 32)))
    o, lse = fa.flash_attention_lse(q, k, v, mode="diag", block=32)
    assert type(o.grad_fn).__name__ == "_FlashFnBackward"
    assert lse.grad_fn is o.grad_fn
    with torch.no_grad():
        assert fa.flash_attention_lse(q, k, v, block=32)[0].grad_fn is None


def test_kernel_route_wiring(monkeypatch):
    """The kernel route's autograd wiring, with the launches replaced by
    the plain versions (a CUDA kernel runs only on the card): the forward
    launches B1 once, the backward B2 and B3 once each, with Δ =
    rowsum(dO∘O) − dLSE, and the gradients equal the plain route's."""
    calls = []

    def fwd(q, k, v, mode, scale):
        calls.append("fwd")
        return fa._flash_plain(q, k, v, mode, scale, 64)

    def bwd(q, k, v, do, lse, delta, mode, scale):
        calls.append("bwd")
        return fa._flash_bwd_plain(q, k, v, None, lse, do, delta, mode,
                                   scale, 64)

    x = [torch.tensor(a) for a in _inputs(4, (2, 128, 2, 32))]
    rng = np.random.default_rng(5)
    do = torch.tensor(rng.standard_normal((2, 128, 2, 32)),
                      dtype=torch.float32)
    dlse = torch.tensor(rng.standard_normal((2, 2, 128)),
                        dtype=torch.float32)
    grads = {}
    for route in ("plain", "kernel"):
        if route == "kernel":
            monkeypatch.setattr(fa, "flash_fwd_cuda", fwd)
            monkeypatch.setattr(fa, "flash_bwd_cuda", bwd)
            monkeypatch.setattr(fa, "_route",
                                lambda q, k, v: ("kernel", True))
        q, k, v = (t.clone().requires_grad_() for t in x)
        o, lse = fa.flash_attention_lse(q, k, v, mode="strict", block=64)
        grads[route] = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    assert calls == ["fwd", "bwd"]
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
