"""The port's paired reduction and training-mode batch norm
(horovod_tpu_torch/ops/batch_norm.py) against the JAX package's
(horovod_tpu/ops/pallas_norm.py, Pallas in interpret mode on the CPU).

Inputs are made with numpy from a seed and given to both. Shapes: an
aligned ``(4, 8, 8, 16)`` and a ragged ``(3, 5, 7, 12)``; float32 and
bfloat16.

Tolerances: float32 outputs within 1e-5 (absolute and relative; the
sums run over at most 256 rows in another order). bfloat16 outputs
(``y``, ``dx``) within one bf16 step, 2^-7 relative plus 1e-5: both
sides compute the same float32 values and round them once to bf16,
where an input that lies on a rounding boundary can land one step
apart. The statistics and ``dγ``, ``dβ`` stay float32 in both, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.ops import pallas_norm as jnorm  # noqa: E402
from horovod_tpu_torch.ops import batch_norm as bn  # noqa: E402

SHAPES = [(4, 8, 8, 16), (3, 5, 7, 12)]
DTYPES = ["float32", "bfloat16"]
EPS = 1e-5
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)


def _inputs(seed, shape, n):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    xs = [(rng.standard_normal(shape) * 1.5 + 0.5).astype(np.float32)
          for _ in range(n)]
    gamma = (1.0 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(C)).astype(np.float32)
    return xs, gamma, beta


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, in JAX, and carried across as float32)."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("same", [True, False], ids=["x_x", "dy_x"])
def test_paired_reduce_matches_pallas(shape, dtype, same):
    (a, b), _, _ = _inputs(0, shape, 2)
    ja, ta = _both(a, dtype)
    jb, tb = (ja, ta) if same else _both(b, dtype)
    js, jp = jnorm.paired_reduce(ja, jb, interpret=True)
    ts, tp = bn.paired_reduce(ta, tb)
    assert ts.dtype == tp.dtype == torch.float32
    assert ts.shape == tp.shape == (shape[-1],)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **F32_TOL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **F32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_batch_norm_train_matches_pallas(shape, dtype):
    """y, mean, var and (dx, dγ, dβ) against ``jax.vjp`` of the
    reference's custom_vjp, with nonzero cotangents for mean and var: both
    ignore them (stop-grad), so they change no gradient."""
    (x, dy), gamma, beta = _inputs(1, shape, 2)
    rng = np.random.default_rng(2)
    dmean, dvar = (rng.standard_normal(shape[-1]).astype(np.float32)
                   for _ in range(2))
    jx, tx = _both(x, dtype)
    jdy, tdy = _both(dy, dtype)

    (jy, jmean, jvar), vjp = jax.vjp(
        lambda x, g, b: jnorm.batch_norm_train(x, g, b, EPS, True),
        jx, jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jdy, jnp.asarray(dmean), jnp.asarray(dvar)))

    tx.requires_grad_()
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    ty, tmean, tvar = bn.batch_norm_train(tx, tg, tb, EPS)
    tdx, tdg, tdb = torch.autograd.grad(
        (ty, tmean, tvar), (tx, tg, tb),
        (tdy, torch.tensor(dmean), torch.tensor(dvar)))

    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert ty.dtype == tdx.dtype == getattr(torch, dtype)
    for got, want in ((ty, jy), (tdx, jdx)):
        np.testing.assert_allclose(_np(got),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    for got, want in ((tmean, jmean), (tvar, jvar), (tdg, jdg), (tdb, jdb)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_stats_cotangents_are_ignored():
    """dx, dγ, dβ do not depend on the cotangents of mean and var."""
    (x, dy), gamma, beta = _inputs(3, (2, 3, 3, 8), 2)
    outs = []
    for scale in (0.0, 5.0):
        tx = torch.tensor(x, requires_grad=True)
        tg = torch.tensor(gamma, requires_grad=True)
        tb = torch.tensor(beta, requires_grad=True)
        y, mean, var = bn.batch_norm_train(tx, tg, tb, EPS)
        outs.append(torch.autograd.grad(
            (y, mean, var), (tx, tg, tb),
            (torch.tensor(dy), torch.full((8,), scale),
             torch.full((8,), -scale))))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper computes the plain version and never
    counts a launch; other devices raise."""
    before = (bn.paired_reduce_cuda.launches, bn.paired_reduce_cuda.copies)
    (a, b), gamma, beta = _inputs(4, (2, 4, 4, 8), 2)
    ta, tb = torch.tensor(a), torch.tensor(b)
    for got, want in zip(bn.paired_reduce(ta, tb),
                         bn.paired_reduce_plain(ta, tb)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    y, _, _ = bn.batch_norm_train(ta.requires_grad_(), torch.tensor(gamma),
                                  torch.tensor(beta), EPS)
    y.sum().backward()
    assert (bn.paired_reduce_cuda.launches,
            bn.paired_reduce_cuda.copies) == before
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or both on CUDA"):
        bn.paired_reduce(meta, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        bn.paired_reduce_cuda(ta, tb)


def test_rows_views_nhwc_memory_and_copies_the_rest():
    """The kernel's ``[R, C]`` operand: an NHWC-contiguous tensor (what a
    channels-last conv gives, permuted to ``[N, H, W, C]``) is viewed
    without a copy; any other layout (an NCHW-contiguous tensor, an
    expanded gradient) is copied once and counted."""
    x = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    nhwc = x.permute(0, 2, 3, 1)
    before = bn.paired_reduce_cuda.copies
    rows = bn._rows(nhwc)
    assert rows.data_ptr() == x.data_ptr() and rows.shape == (50, 8)
    assert bn.paired_reduce_cuda.copies == before
    for other in (torch.randn(2, 8, 5, 5).permute(0, 2, 3, 1),
                  torch.randn(2, 1, 1, 8).expand(2, 5, 5, 8),
                  torch.randn(8, 30).t()):
        rows = bn._rows(other)
        assert rows.is_contiguous()
        torch.testing.assert_close(rows, other.reshape(-1, other.shape[-1]),
                                   atol=0, rtol=0)
    assert bn.paired_reduce_cuda.copies == before + 3
