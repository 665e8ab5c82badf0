"""The port's collectives (horovod_tpu_torch/ops/torch_ops.py) on CPU
tensors over gloo.

- The in-mesh ops at 2 and 4 ranks (Adasum also at 8) against their
  ``horovod_tpu.ops.jax_ops`` counterparts inside ``shard_map`` over a
  one-axis mesh of as many CPU devices, on inputs made with numpy from a
  seed, in float32, bfloat16 and int32. Tolerances: ops that only move
  data, and Min and Max, are exact in every dtype; reductions within
  1e-6 (float32) and 1e-2 (bf16) of the reference in relative norm (the
  same values combined in another order, rounded to the dtype at other
  places), int32 exact. Adasum is also held to a float64 numpy
  re-implementation of the VHDD recursion (the one in
  tests/test_jax_mesh.py) within 1e-5 in relative norm (float32's
  rounding over three levels).
- The Horovod ops (``hvd_*``, the object ops, ``metric_average``) at 2
  and 4 ranks against numpy, exact: they move data or sum integers and
  small floats exactly.

Ranks are threads, each with its own gloo ``World`` over one shared
``HashStore``; no process is spawned.
"""

import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

torch.set_num_threads(1)

from horovod_tpu.ops import jax_ops  # noqa: E402
from horovod_tpu_torch.exceptions import HorovodInternalError  # noqa: E402
from horovod_tpu_torch.ops import torch_ops as ops  # noqa: E402
from horovod_tpu_torch.process_sets import (  # noqa: E402
    ProcessSet, add_process_set, remove_process_set)

from .torch_train_parity import _on_threads, run_worlds  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}
TOL = {"float32": 1e-6, "bfloat16": 1e-2, "int32": 0.0}
CAPACITY = 3


def _inputs(n, dtype):
    """Per-rank inputs: x [n, 2n, 3] (row r is rank r's [2n, 3]) and
    ragged send counts [n, n], rank 0's first count past CAPACITY."""
    rng = np.random.default_rng(100 + n)
    if dtype == "int32":
        x = rng.integers(-50, 50, (n, 2 * n, 3)).astype(np.float32)
    else:
        x = (0.5 + rng.random((n, 2 * n, 3))).astype(np.float32) \
            * rng.choice([-1.0, 1.0], (n, 2 * n, 3)).astype(np.float32)
    counts = rng.integers(0, 2, (n, n)).astype(np.int32)
    counts[0, 0] = CAPACITY + 1
    counts[:, -1] = 2 * n - counts[:, :-1].sum(1)   # rows sum to 2n
    return x, counts


# name -> (in-mesh op of the reference, port op, dtypes, exact)
OPS = {
    "sum": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Sum),
            lambda v, g: ops.allreduce(v, g, ops.Sum), DTYPES, False),
    "average": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Average),
                lambda v, g: ops.allreduce(v, g, ops.Average),
                ("float32", "bfloat16"), False),
    "min": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Min),
            lambda v, g: ops.allreduce(v, g, ops.Min), DTYPES, True),
    "max": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Max),
            lambda v, g: ops.allreduce(v, g, ops.Max), DTYPES, True),
    "product": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Product),
                lambda v, g: ops.allreduce(v, g, ops.Product), DTYPES,
                False),
    "adasum": (lambda v, a: jax_ops.allreduce(v, a, jax_ops.Adasum),
               lambda v, g: ops.allreduce(v, g, ops.Adasum),
               ("float32", "bfloat16"), False),
    "allgather": (lambda v, a: jax_ops.allgather(v, a),
                  lambda v, g: ops.allgather(v, g), DTYPES, True),
    "broadcast": (lambda v, a: jax_ops.broadcast(v, a, root_index=1),
                  lambda v, g: ops.broadcast(v, g, root_index=1), DTYPES,
                  True),
    "alltoall_0_0": (lambda v, a: jax_ops.alltoall(v, a, 0, 0),
                     lambda v, g: ops.alltoall(v, g, 0, 0), DTYPES, True),
    "alltoall_0_1": (lambda v, a: jax_ops.alltoall(v, a, 0, 1),
                     lambda v, g: ops.alltoall(v, g, 0, 1), DTYPES, True),
    "reducescatter_sum": (
        lambda v, a: jax_ops.reducescatter(v, a, jax_ops.Sum),
        lambda v, g: ops.reducescatter(v, g, ops.Sum), DTYPES, False),
    "reducescatter_average": (
        lambda v, a: jax_ops.reducescatter(v, a, jax_ops.Average),
        lambda v, g: ops.reducescatter(v, g, ops.Average),
        ("float32", "bfloat16"), False),
}


def _jax(n, fn, *args):
    """``fn`` on device r's row r of each arg, inside shard_map over a mesh
    of n CPU devices; every output stacked on a new dim0."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P("x"),
                       out_specs=P("x"), check_vma=False)
    def run(*vs):
        out = fn(*(v[0] for v in vs))
        return jax.tree.map(lambda o: o[None], out)

    return jax.tree.map(np.asarray, run(*args))


@functools.lru_cache(maxsize=None)
def _jax_in_mesh(n):
    """{(op, dtype): outputs stacked by rank} of every op of ``OPS`` and
    ``ragged_alltoall`` in every dtype on ``_inputs``, in one jitted
    ``shard_map`` over n devices (one compile, where one an op and dtype
    would be thirty)."""
    args = {}
    for dtype, (jdt, _) in DTYPES.items():
        x, counts = _inputs(n, dtype)
        args[dtype] = (jnp.asarray(x, jdt), jnp.asarray(counts))

    def every(args):
        out = {}
        for dtype, (v, c) in args.items():
            for name, (jfn, _, dts, _) in OPS.items():
                if dtype in dts:
                    out[name, dtype] = jfn(v, "x")
            out["ragged", dtype] = jax_ops.ragged_alltoall(v, c, "x",
                                                           CAPACITY)
        return out

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P("x"),
                       out_specs=P("x"), check_vma=False)
    def run(args):
        out = every(jax.tree.map(lambda v: v[0], args))
        return jax.tree.map(lambda o: o[None], out)

    return jax.tree.map(np.asarray, run(args))


def _f32(t):
    return t.float().numpy()


def _close(got, want, dtype, exact):
    want = np.asarray(want, np.float32)
    if exact or dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("n", [2, 4])
def test_in_mesh_ops_equal_jax(n):
    def body(world):
        g, r = world.group, world.rank
        out = {}
        for dtype, (_, tdt) in DTYPES.items():
            x, counts = _inputs(n, dtype)
            v = torch.tensor(x[r]).to(tdt)
            for name, (_, fn, dts, _) in OPS.items():
                if dtype in dts:
                    out[name, dtype] = _f32(fn(v, g))
            recv, rc = ops.ragged_alltoall(v, torch.tensor(counts[r]), g,
                                           CAPACITY)
            out["ragged", dtype] = (_f32(recv), rc.numpy())
        return out

    ranks = run_worlds(n, body)
    jax_out = _jax_in_mesh(n)
    for dtype in DTYPES:
        for name, (_, _, dts, exact) in OPS.items():
            if dtype not in dts:
                continue
            want = jax_out[name, dtype]
            for r in range(n):
                _close(ranks[r][name, dtype], want[r], dtype, exact)
        recv, rc = jax_out["ragged", dtype]
        for r in range(n):
            np.testing.assert_array_equal(ranks[r]["ragged", dtype][0],
                                          np.asarray(recv[r], np.float32))
            np.testing.assert_array_equal(ranks[r]["ragged", dtype][1],
                                          rc[r])
        # The clamp shows: rank 0 sent CAPACITY + 1 rows to rank 0.
        assert ranks[0]["ragged", dtype][1][0] == CAPACITY


def _np_adasum(vs):
    vs = [v.astype(np.float64) for v in vs]
    m, d = len(vs), 1
    while d < m:
        nxt = list(vs)
        for i in range(m):
            a, b = vs[i], vs[i ^ d]
            ab, aa, bb = a @ b, a @ a, b @ b
            sa = 1.0 - ab / (2 * aa) if aa > 0 else 1.0
            sb = 1.0 - ab / (2 * bb) if bb > 0 else 1.0
            nxt[i] = sa * a + sb * b
        vs = nxt
        d <<= 1
    return vs[0]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_adasum_equals_jax_and_numpy(n):
    """Whole 33-element vectors; the analytic anchors too: identical
    vectors come back unchanged, orthogonal ones add exactly."""
    vecs = np.random.default_rng(7).standard_normal((n, 33)).astype(
        np.float32)
    ortho = np.zeros((n, 33), np.float32)
    ortho[np.arange(n), np.arange(n)] = np.arange(1, n + 1)
    same = np.broadcast_to(vecs[0], (n, 33)).copy()

    def body(world):
        return [ops.adasum(torch.tensor(v[world.rank]), world.group).numpy()
                for v in (vecs, ortho, same)]

    ranks = run_worlds(n, body)
    want = _jax(n, lambda v: jax_ops.adasum(v, "x"), jnp.asarray(vecs))
    ref = _np_adasum(list(vecs))
    for r in range(n):
        got = ranks[r][0]
        assert np.linalg.norm(got - want[r]) / np.linalg.norm(want[r]) \
            <= 1e-6
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5
        np.testing.assert_array_equal(ranks[r][1], ortho.sum(0))
        np.testing.assert_allclose(ranks[r][2], same[0], rtol=1e-6)
    np.testing.assert_array_equal(ranks[0][0], ranks[-1][0])


def test_adasum_needs_a_power_of_two():
    def body(world):
        with pytest.raises(ValueError, match="power-of-two"):
            ops.adasum(torch.ones(4), world.group)
        with pytest.raises(ValueError, match="power-of-two"):
            ops.hvd_allreduce(torch.ones(4), ops.Adasum,
                              process_set=ProcessSet.from_world(world))

    run_worlds(3, body)


@pytest.mark.parametrize("n", [2, 4])
def test_horovod_ops_equal_numpy(n):
    """Uneven allgather, alltoall with splits, reducescatter (the first
    members take the remainder rows), broadcast and its pytree form from
    root 1, the object ops and metric_average, over the world's set."""
    rng = np.random.default_rng(200 + n)
    rows = [r + 1 for r in range(n)]                    # uneven dim0
    xs = [rng.integers(-9, 9, (k, 2)).astype(np.float32) for k in rows]
    splits = [[(r + j) % 3 for j in range(n)] for r in range(n)]
    sends = [rng.integers(0, 99, (sum(s), 2)).astype(np.int64)
             for s in splits]
    rs_in = rng.integers(-9, 9, (n, 2 * n + 1, 3)).astype(np.float32)

    def body(world):
        ps = ProcessSet.from_world(world)
        r = world.rank
        tree = {"a": torch.full((2,), float(r)), "b": [torch.arange(3) + r]}
        out, recv_splits = ops.hvd_alltoall(torch.tensor(sends[r]),
                                            splits[r], process_set=ps)
        return {
            "allgather": ops.hvd_allgather(torch.tensor(xs[r]),
                                           process_set=ps).numpy(),
            "alltoall": (out.numpy(), recv_splits.tolist()),
            "alltoall_even": ops.hvd_alltoall(
                torch.arange(2 * n) + 10 * r, process_set=ps).tolist(),
            "rs_sum": ops.hvd_reducescatter(torch.tensor(rs_in[r]), ops.Sum,
                                            process_set=ps).numpy(),
            "rs_avg": ops.hvd_reducescatter(
                torch.tensor(rs_in[r]), ops.Average, process_set=ps,
                prescale_factor=2.0, postscale_factor=0.5).numpy(),
            "allreduce": ops.hvd_allreduce(torch.tensor(xs[0]) + r, ops.Sum,
                                           process_set=ps).numpy(),
            "broadcast": ops.hvd_broadcast(torch.tensor(xs[0]) * (r + 1),
                                           root_rank=1,
                                           process_set=ps).numpy(),
            "tree": ops.hvd_broadcast_pytree(tree, root_rank=1,
                                             process_set=ps),
            "objects": ops.allgather_object({"rank": r, "s": "x" * r},
                                            process_set=ps),
            "object": ops.broadcast_object(("from", r), root_rank=1,
                                           process_set=ps),
            "metric": ops.metric_average(float(r), process_set=ps),
        }

    ranks = run_worlds(n, body)
    rs_total = rs_in.sum(0)
    base, rem = divmod(2 * n + 1, n)
    starts = np.cumsum([0] + [base + (i < rem) for i in range(n)])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["allgather"], np.concatenate(xs))
        want_splits = [splits[j][r] for j in range(n)]
        offs = [sum(splits[j][:r]) for j in range(n)]
        want = np.concatenate([sends[j][offs[j]:offs[j] + want_splits[j]]
                               for j in range(n)])
        assert got["alltoall"][1] == want_splits
        np.testing.assert_array_equal(got["alltoall"][0], want)
        assert got["alltoall_even"] == [10 * j + 2 * r + i for j in range(n)
                                        for i in range(2)]
        lo, hi = starts[r], starts[r + 1]
        np.testing.assert_array_equal(got["rs_sum"], rs_total[lo:hi])
        np.testing.assert_array_equal(got["rs_avg"], rs_total[lo:hi] / n)
        np.testing.assert_array_equal(got["allreduce"],
                                      n * xs[0] + sum(range(n)))
        np.testing.assert_array_equal(got["broadcast"], xs[0] * 2)
        assert torch.equal(got["tree"]["a"], torch.full((2,), 1.0))
        assert torch.equal(got["tree"]["b"][0], torch.arange(3) + 1)
        assert got["objects"] == [{"rank": j, "s": "x" * j}
                                  for j in range(n)]
        assert got["object"] == ("from", 1)
        assert got["metric"] == (n - 1) / 2


def test_process_set_reduces_among_its_members():
    """add_process_set([0, 2]) at 4 ranks: a Sum over it adds ranks 0 and
    2 only; rank 1 and 3 are outside it and its ops raise there; removing
    it ends it."""
    def body(world):
        ps = add_process_set([0, 2], world)
        r = world.rank
        out = {"included": ps.included(), "rank": ps.rank(),
               "size": ps.size()}
        if ps.included():
            out["sum"] = ops.hvd_allreduce(torch.tensor([float(r)]), ops.Sum,
                                           process_set=ps).item()
            out["bcast"] = ops.hvd_broadcast(torch.tensor([r]), root_rank=2,
                                             process_set=ps).item()
            ops.barrier(ps)
        else:
            with pytest.raises(ValueError, match="no group"):
                ops.hvd_allreduce(torch.ones(1), process_set=ps)
        remove_process_set(ps)
        with pytest.raises(ValueError, match="no group"):
            ops.hvd_allreduce(torch.ones(1), process_set=ps)
        return out

    ranks = run_worlds(4, body)
    assert [o["included"] for o in ranks] == [True, False, True, False]
    assert [o["rank"] for o in ranks] == [0, -1, 1, -1]
    assert all(o["size"] == 2 for o in ranks)
    assert ranks[0]["sum"] == ranks[2]["sum"] == 2.0
    assert ranks[0]["bcast"] == ranks[2]["bcast"] == 2


def test_failed_collective_raises_horovod_internal_error():
    """A peer that has left: the survivor's allreduce raises
    HorovodInternalError, not the backend's error."""
    store = dist.HashStore()
    groups = _on_threads(2, lambda r: dist.ProcessGroupGloo(
        dist.PrefixStore("t", store), r, 2, datetime.timedelta(seconds=60)),
        timeout=60)
    groups[1].set_timeout(datetime.timedelta(seconds=1))
    groups[0].abort()
    with pytest.raises(HorovodInternalError, match="collective failed"):
        ops.allreduce(torch.ones(3), groups[1], ops.Sum)
