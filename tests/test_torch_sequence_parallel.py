"""The port's ring attention and Ulysses
(horovod_tpu_torch/parallel/ring_attention.py, ulysses.py) against the
JAX package's ``make_ring_attention`` / ``make_ulysses_attention`` on
its 8-device CPU mesh, and against attention over the whole sequence in
one process.

Ranks are threads (``run_worlds``), each with a gloo ``World``, on a
``{"data": 2, "seq": p}`` mesh; each holds its (batch, sequence) block
of q, k, v ``[B, S, H, D] = [2, 32, 4, 8]`` float32, made with numpy
from a seed. A case returns the output and the gradients of
``sum(out * w)`` (w random) for q, k and v, put back together from the
ranks. The JAX references compute the same on a ``Mesh`` of the same
shape, the flash step in Pallas ``interpret=True`` as the JAX package's
own tests run it; ``inner_block=8`` gives the plain flash version and
the Pallas kernel one block a pair.

Tolerances: against float64 attention in one process, 2e-5 absolute
and relative (float32 sums over 32 keys, split into p partials merged
by their max or log-sum-exp); against JAX, the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(1)

from horovod_tpu.parallel import (  # noqa: E402
    make_ring_attention as jax_ring,
    make_ulysses_attention as jax_ulysses,
    stripe_sequence as jax_stripe,
)
from horovod_tpu_torch.parallel import (  # noqa: E402
    create_mesh, make_ring_attention, make_ulysses_attention,
    stripe_sequence, unstripe_sequence)

from .torch_train_parity import run_worlds  # noqa: E402

SHAPE = (2, 32, 4, 8)                 # B, S, H, D
TOL = dict(atol=2e-5, rtol=2e-5)
_rng = np.random.default_rng(41)
Q, K, V, W = (_rng.standard_normal(SHAPE).astype(np.float32)
              for _ in range(4))


def _blocks(x, p, coords):
    """Rank ``coords``'s (data, seq) block of a global [B, S, ...]."""
    b, s = x.shape[0] // 2, x.shape[1] // p
    d, r = coords
    return torch.tensor(x[d * b:(d + 1) * b, r * s:(r + 1) * s])


def _port(p, make):
    """(out, dq, dk, dv) of ``make(mesh)`` over 2p ranks, whole."""
    def rank(world):
        mesh = create_mesh({"data": 2, "seq": p}, world)
        q, k, v = (_blocks(x, p, mesh.coords()).requires_grad_()
                   for x in (Q, K, V))
        out = make(mesh)(q, k, v)
        grads = torch.autograd.grad((out * _blocks(W, p, mesh.coords()))
                                    .sum(), (q, k, v))
        return [t.detach().numpy() for t in (out,) + grads]

    res = run_worlds(2 * p, rank)

    def whole(i):
        rows = [np.concatenate([res[d * p + r][i] for r in range(p)], 1)
                for d in range(2)]
        return np.concatenate(rows, 0)

    return [whole(i) for i in range(4)]


def _dense(causal):
    """(out, dq, dk, dv) of attention over the whole sequence, float64."""
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in (Q, K, V))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(SHAPE[-1])
    if causal:
        S = SHAPE[1]
        s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s,
                        -np.inf)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    grads = torch.autograd.grad((out * torch.tensor(W, dtype=torch.float64))
                                .sum(), (q, k, v))
    return [t.detach().numpy() for t in (out,) + grads]


# The JAX rings each case is held to (each compiles the whole ring
# with its backward; the flash ones run Pallas in interpret mode). The
# four flash masks are covered: contiguous causal gives none, diag and
# the skip, striped causal diag and strict.
JAX_RING_CASES = [
    (2, "einsum", "contiguous", True),
    (4, "einsum", "striped", True),
    (4, "einsum", "contiguous", False),
    (4, "flash", "contiguous", True),
    (2, "flash", "striped", True),
]


def _jax_fns(p):
    """{case: fn(mesh)} of the references on a ``{"data": 2, "seq": p}``
    mesh: the rings of ``JAX_RING_CASES`` and Ulysses, causal or not."""
    fns = {(p_, inner, layout, causal): (
        lambda mesh, inner=inner, layout=layout, causal=causal: jax_ring(
            mesh, axis="seq", causal=causal, batch_axis="data",
            layout=layout, inner=inner, inner_block=8, jit=False))
        for p_, inner, layout, causal in JAX_RING_CASES if p_ == p}
    if p == 4:
        for causal in (True, False):
            fns["ulysses", causal] = (
                lambda mesh, causal=causal: jax_ulysses(
                    mesh, axis="seq", causal=causal, batch_axis="data"))
    return fns


@functools.lru_cache(maxsize=None)
def _jax_refs(p):
    """{case: (out, dq, dk, dv)} of every reference of ``_jax_fns(p)``,
    each the gradients of ``sum(out * W)``, in one jitted program (one
    compile a mesh, where one a case would be five)."""
    mesh = Mesh(np.asarray(jax.devices()[:2 * p]).reshape(2, p),
                ("data", "seq"))
    fns = {case: make(mesh) for case, make in _jax_fns(p).items()}

    def every(q, k, v):
        out = {}
        for case, f in fns.items():
            def loss(q, k, v, f=f):
                o = f(q, k, v)
                return jnp.sum(o * W), o

            (_, o), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            out[str(case)] = (o,) + grads
        return out

    return {case: [np.asarray(t) for t in res]
            for case, res in jax.jit(every)(Q, K, V).items()}


def _jax(p, case):
    """(out, dq, dk, dv) of the reference ``case`` of ``_jax_fns(p)``."""
    return _jax_refs(p)[str(case)]


def _close(got, want, what):
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=f"{what}: {name}", **TOL)


def _port_ring(p, inner, layout, causal):
    return _port(p, lambda mesh: make_ring_attention(
        mesh, "seq", causal=causal, batch_axis="data", layout=layout,
        inner=inner, inner_block=8))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("inner", ["einsum", "flash"])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_matches_whole_sequence_attention(p, inner, layout, causal):
    _close(_port_ring(p, inner, layout, causal), _dense(causal),
           f"ring p={p} {inner} {layout} causal={causal}")


@pytest.mark.parametrize("p,inner,layout,causal", JAX_RING_CASES)
def test_ring_matches_jax_make_ring_attention(p, inner, layout, causal):
    want = _jax(p, (p, inner, layout, causal))
    _close(_port_ring(p, inner, layout, causal), want,
           f"ring p={p} {inner} {layout} causal={causal} against JAX")


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_whole_sequence(causal):
    got = _port(4, lambda mesh: make_ulysses_attention(
        mesh, "seq", causal=causal, batch_axis="data"))
    want = _jax(4, ("ulysses", causal))
    _close(got, want, f"ulysses causal={causal} against JAX")
    _close(got, _dense(causal), f"ulysses causal={causal}")


def test_ring_matches_ulysses():
    """The two schemes against each other, forward and gradients, at 4
    ranks of the sequence, both inner steps."""
    uly = _port(4, lambda mesh: make_ulysses_attention(mesh, "seq"))
    for inner in ("einsum", "flash"):
        _close(_port_ring(4, inner, "contiguous", True), uly,
               f"ring {inner} against ulysses")


def test_stripe_round_trip_matches_jax():
    x = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    y = stripe_sequence(torch.tensor(x), 4)
    # shard 0 of 4 (rows 0:3 of striped order) holds positions {0, 4, 8}
    np.testing.assert_array_equal(y[:, :3].numpy(), x[:, [0, 4, 8]])
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax_stripe(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(unstripe_sequence(y, 4).numpy(), x)
