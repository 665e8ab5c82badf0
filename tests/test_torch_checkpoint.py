"""The port's sharded checkpoint (horovod_tpu_torch/checkpoint.py) against
the JAX package's (horovod_tpu/checkpoint.py), and its own contract.

Ranks are threads, each with a gloo ``World`` over one store
(``graft_entry._on_ranks``); the JAX package runs in this process at
size 1 on the 8-device CPU mesh (``horovod_tpu.init()``).

- Format: the port's save of a tree (f32, f16, bf16, i32, an i64 scalar,
  bool) and the JAX package's save of the same numpy tree give equal
  manifests and byte-identical files.
- JAX -> port: a ``{model: 8}``-sharded save restores bit-exact at 1, 2
  and 4 ranks under ``{model: n}``, into marked and unmarked likes.
- Port -> JAX: saves at 2 and 4 ranks restore bit-exact in the JAX
  package into ``P("model")`` shardings and numpy likes; the bf16 leaf,
  which the JAX package cannot read back, is held from its bytes.
- ``latest_step`` (the JAX test's cases), the legacy orbax raise, torn
  checkpoints, crash safety (a failed commit, a re-save, an async save
  against an in-place update, an async failure), process sets and
  ``coordinate``, the counters, metrics and spans, and no collective on
  the process group during a save.
"""

import json
import os
import re
import shutil
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

import horovod_tpu as jhvd  # noqa: E402
from horovod_tpu import checkpoint as jck  # noqa: E402
from horovod_tpu_torch import checkpoint as ck  # noqa: E402
from horovod_tpu_torch import hvd  # noqa: E402
from horovod_tpu_torch.exceptions import CheckpointError  # noqa: E402
from horovod_tpu_torch.graft_entry import _on_ranks  # noqa: E402
from horovod_tpu_torch.observability import metrics, spans  # noqa: E402
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.parallel.mesh import (  # noqa: E402
    World, create_mesh, leaf_spec, set_leaf_spec)
from horovod_tpu_torch.process_sets import (  # noqa: E402
    ProcessSet, add_process_set)
from horovod_tpu_torch.tree import tree_flatten_with_path  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_init():
    jhvd.init()
    yield
    jhvd.shutdown()


def _solo():
    """The process set of a world of one rank."""
    return ProcessSet.from_world(World(dist.HashStore(), 0, 1, "cpu"))


def _tensor(x):
    """A tensor holding numpy ``x``'s bits (bf16 from ml_dtypes)."""
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _same(a, b):
    """Two tensors of one dtype and shape with the same bytes."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def _mark(x, spec, mesh):
    """This rank's block of whole numpy ``x`` along dim 0 over ``spec``'s
    axis, marked, as shard_params cuts and marks."""
    t = _tensor(x)
    n, c = mesh.shape[spec[0]], mesh.coords()[0]
    t = t.chunk(n, 0)[c].clone()
    return set_leaf_spec(t, spec)


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


RNG = np.random.default_rng(0)
FMT = {
    "f32": RNG.normal(size=(4, 6)).astype(np.float32),
    "f16": RNG.normal(size=(3, 5)).astype(np.float16),
    "bf16": RNG.normal(size=(2, 7)).astype(ml_dtypes.bfloat16),
    "i32": RNG.integers(-9, 9, size=(5,)).astype(np.int32),
    "i64": np.asarray(12345, np.int64),
    "bool": RNG.random((3, 2)) > 0.5,
    "layers": [{"w": RNG.normal(size=(2, 2)).astype(np.float32)}],
}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def test_format_is_byte_identical_to_the_jax_package(tmp_path):
    jck.save(str(tmp_path / "jax"), 3, FMT)
    ck.save(str(tmp_path / "port"), 3, _tree_map(_tensor, FMT),
            process_set=_solo())
    want, got = _files(tmp_path / "jax" / "3"), _files(tmp_path / "port" / "3")
    assert sorted(want) == sorted(got)
    assert json.loads(got[ck.MANIFEST]) == json.loads(want[jck.MANIFEST])
    manifest = json.loads(got[ck.MANIFEST])
    assert manifest["tensors"]["['bf16']"]["dtype"] == "bfloat16"
    for name in want:
        assert got[name] == want[name], name
    # and both read back bit-exact in the port, bf16 included
    like = _tree_map(_tensor, FMT)
    for d in ("jax", "port"):
        out, step = ck.restore(str(tmp_path / d), like, coordinate=False)
        assert step == 3
        for (name, a), (_, b) in zip(tree_flatten_with_path(out),
                                     tree_flatten_with_path(like)):
            assert _same(a, b), (d, name)


# JAX -> port: the reference's reshard worker's tree, 8-way sharded.
TP = np.arange(32.0, dtype=np.float32).reshape(8, 4) * 1.5
TP16 = (np.arange(48.0, dtype=np.float16) / 3.0).reshape(8, 6)
REP = np.arange(15, dtype=np.int32).reshape(3, 5) * 7
REPF = np.arange(32.0, dtype=np.float32).reshape(8, 4) - 11.0
COUNT = np.asarray(12345, np.int64)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ck"))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("model",))
    shd = NamedSharding(mesh, P("model"))

    def mk(full):
        return jax.make_array_from_callback(full.shape, shd,
                                            lambda idx: full[idx])

    jck.save(d, 2, {"tp": mk(TP), "tp16": mk(TP16), "rep": REP,
                    "repf": REPF, "count": COUNT})
    return d


@pytest.mark.parametrize("n", [1, 2, 4])
def test_jax_checkpoint_restores_in_the_port(jax_saved, n):
    def rank(world):
        mesh = create_mesh({"model": n}, world)
        ps = ProcessSet.from_world(world)
        spec = ("model", None)
        marked = {"tp": _mark(np.zeros_like(TP), spec, mesh),
                  "tp16": _mark(np.zeros_like(TP16), spec, mesh),
                  "rep": torch.zeros(3, 5, dtype=torch.int32),
                  # saved whole by the root: each rank reads a sub-region
                  "repf": _mark(np.zeros_like(REPF), spec, mesh),
                  "count": np.zeros_like(COUNT)}
        out, step = ck.restore(jax_saved, marked, process_set=ps, mesh=mesh)
        assert step == 2
        for k, full in (("tp", TP), ("tp16", TP16), ("repf", REPF)):
            assert _same(out[k], _mark(full, spec, mesh)), (n, k)
            assert leaf_spec(out[k]) == spec
        assert torch.equal(out["rep"], torch.from_numpy(REP))
        assert isinstance(out["count"], np.ndarray)
        assert out["count"] == COUNT and out["count"].dtype == np.int64
        whole = {"tp": torch.zeros(8, 4), "tp16": torch.zeros(8, 6),
                 "repf": torch.zeros(8, 4)}
        out, _ = ck.restore(jax_saved, whole, process_set=ps)
        for k, full in (("tp", TP), ("tp16", TP16), ("repf", REPF)):
            assert _same(out[k], _tensor(full)), (n, k)
            assert leaf_spec(out[k]) == ()
        return True

    assert all(_on_ranks(n, rank, timeout=60))


BF = RNG.normal(size=(8, 6)).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("n", [2, 4])
def test_port_checkpoint_restores_in_the_jax_package(tmp_path, n):
    d = str(tmp_path / "ck")

    def rank(world):
        mesh = create_mesh({"model": n}, world)
        spec = ("model", None)
        ck.save(d, 4, {"tp": _mark(TP, spec, mesh),
                       "tp16": _mark(TP16, spec, mesh),
                       "bf": _mark(BF, spec, mesh),
                       "rep": _tensor(REP), "count": _tensor(COUNT),
                       "npy": REPF},
                process_set=ProcessSet.from_world(world), mesh=mesh)

    _on_ranks(n, rank, timeout=60)
    manifest = json.loads(open(os.path.join(d, "4", ck.MANIFEST)).read())
    assert manifest["world_size"] == n
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("model",))
    shd = NamedSharding(jmesh, P("model"))

    def zeros(full):
        return jax.make_array_from_callback(
            full.shape, shd, lambda idx: np.zeros_like(full)[idx])

    out, step = jck.restore(d, {"tp": zeros(TP), "tp16": zeros(TP16),
                                "rep": np.zeros_like(REP),
                                "count": np.zeros_like(COUNT),
                                "npy": zeros(REPF)})
    assert step == 4
    for k, full in (("tp", TP), ("tp16", TP16), ("npy", REPF)):
        assert out[k].sharding == shd
        assert np.array_equal(np.asarray(out[k]), full), k
    assert np.array_equal(out["rep"], REP) and out["count"] == COUNT
    out, _ = jck.restore(d, {"tp": np.zeros_like(TP),
                             "tp16": np.zeros_like(TP16)})
    assert np.array_equal(out["tp"], TP) and np.array_equal(out["tp16"], TP16)
    # bf16: the JAX package cannot read it back; held from the bytes.
    assert manifest["tensors"]["['bf']"] == {"global_shape": [8, 6],
                                             "dtype": "bfloat16"}
    got = np.zeros((8, 6), np.uint16)
    shards = [s for s in manifest["shards"] if s["name"] == "['bf']"]
    assert len(shards) == n
    for sh in shards:
        raw = np.load(os.path.join(d, "4", f"rank_{sh['rank']}", sh["file"]))
        assert raw.dtype == np.dtype("V2")
        (s0, e0), (s1, e1) = sh["index"]
        got[s0:e0, s1:e1] = raw.view(np.uint16)
    assert np.array_equal(got, BF.view(np.uint16))


def test_latest_step_ignores_uncommitted(tmp_path):
    """The JAX package's own cases (tests/test_checkpoint.py)."""
    d = tmp_path / "ck"
    (d / "7.tmp" / "rank_0").mkdir(parents=True)  # crashed writer staging
    (d / "5").mkdir()                             # no commit marker
    (d / "junk").mkdir()                          # non-integer name
    (d / "8").write_text("x")                     # a FILE, not a step dir
    (d / "3").mkdir()
    (d / "3" / "MANIFEST.json").write_text("{}")
    assert ck.latest_step(d) == 3
    (d / "4").mkdir()
    (d / "4" / "_METADATA").write_text("")        # legacy orbax
    assert ck.latest_step(d) == 4
    (d / "6" / "default").mkdir(parents=True)
    (d / "6" / "default" / "_METADATA").write_text("")  # older nesting
    assert ck.latest_step(d) == 6
    assert ck.latest_step(d / "absent") is None
    assert ck.restore(str(d / "absent"), {}, coordinate=False) == (None,
                                                                    None)


def test_legacy_orbax_step_raises_on_restore(tmp_path):
    (tmp_path / "6" / "default").mkdir(parents=True)
    (tmp_path / "6" / "default" / "_METADATA").write_text("")
    with pytest.raises(CheckpointError, match="legacy orbax.*JAX package"):
        ck.restore(str(tmp_path), {"w": torch.zeros(2)}, coordinate=False)


# Torn checkpoints, as tests/workers/torn_ckpt_worker.py corrupts them:
# one save of 2 ranks, copied per case.
TORN_W = np.arange(64.0, dtype=np.float32).reshape(8, 8)


@pytest.fixture(scope="module")
def torn_source(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torn"))

    def rank(world):
        mesh = create_mesh({"model": 2}, world)
        ck.save(d, 5, {"w": _mark(TORN_W, ("model", None), mesh),
                       "b": torch.ones(3)},
                process_set=ProcessSet.from_world(world), async_=True,
                mesh=mesh)
        ck.wait(ProcessSet.from_world(world))

    _on_ranks(2, rank, timeout=60)
    return d


def _corrupt(step_dir, case):
    mpath = os.path.join(step_dir, ck.MANIFEST)
    text = open(mpath).read()
    if case == "truncated manifest":
        open(mpath, "w").write(text[: len(text) // 2])
    elif case == "format tag":
        open(mpath, "w").write(json.dumps({"format": "bogus-v9"}))
    elif case == "bit flip":
        fpath = os.path.join(step_dir, "rank_0", "shard_0000.npy")
        data = open(fpath, "rb").read()
        open(fpath, "wb").write(data[:-1] + bytes([data[-1] ^ 0xFF]))
    elif case == "missing rank dir":
        shutil.rmtree(os.path.join(step_dir, "rank_1"))
    elif case == "partial cover":
        m = json.loads(text)
        m["shards"] = [s for s in m["shards"]
                       if not (s["name"] == "['w']" and s["rank"] == 1)]
        open(mpath, "w").write(json.dumps(m))


TORN = [("truncated manifest", "torn manifest"),
        ("format tag", "unknown format 'bogus-v9'"),
        ("bit flip", re.escape("checksum mismatch in shard "
                               "rank_0/shard_0000.npy for tensor ['b']")),
        ("missing rank dir", re.escape("missing shard rank_1/shard_0000.npy "
                                       "for tensor ['w']")),
        ("partial cover", r"tensor \['w'\]: region .* only 32/64 elements"),
        ("tree mismatch", r"no tensor \['extra'\]"),
        ("shape mismatch", r"tensor \['w'\]: tree_like shape \(8, 4\)")]


@pytest.mark.parametrize("case,match", TORN, ids=[c for c, _ in TORN])
def test_torn_checkpoint_fails_loudly(torn_source, tmp_path, case, match):
    d = str(tmp_path / "ck")
    shutil.copytree(torn_source, d)
    like = {"w": torch.zeros(8, 8), "b": torch.zeros(3)}
    out, step = ck.restore(d, like, coordinate=False)
    assert step == 5 and torch.equal(out["w"], torch.from_numpy(TORN_W))
    _corrupt(os.path.join(d, "5"), case)
    if case == "tree mismatch":
        like["extra"] = torch.zeros(2)
    elif case == "shape mismatch":
        like["w"] = torch.zeros(8, 4)
    with pytest.raises(CheckpointError, match=match):
        ck.restore(d, like, step=5, coordinate=False)


def test_missing_manifest_is_not_committed(torn_source, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(torn_source, d)
    os.remove(os.path.join(d, "5", ck.MANIFEST))
    assert ck.latest_step(d) is None
    with pytest.raises(CheckpointError, match="no committed checkpoint"):
        ck.restore(d, {"b": torch.zeros(3)}, step=5, coordinate=False)


def test_marked_leaf_needs_a_mesh(tmp_path):
    w = set_leaf_spec(torch.zeros(4), ("model",))
    with pytest.raises(ValueError, match="pass the mesh"):
        ck.save(str(tmp_path), 1, {"w": w}, process_set=_solo())
    with pytest.raises(ValueError, match="not registered"):
        ck.save(str(tmp_path), 1, {"w": torch.zeros(2)},
                process_set=ProcessSet([0]))


# Crash safety.

def test_failed_commit_keeps_the_previous_step(tmp_path, monkeypatch):
    """The root fails between the two barriers: every rank raises (the
    other one from the root's verdict, not a timeout), each counts an
    aborted commit, and the previous step stays latest."""
    d = str(tmp_path)

    def save(step, value):
        def rank(world):
            ck.save(d, step, {"w": torch.full((4,), value)},
                    process_set=ProcessSet.from_world(world))
        return rank

    _on_ranks(2, save(1, 1.0), timeout=60)

    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_merge_and_commit", fail)
    before = ck.checkpoint_stats()

    def rank(world):
        with pytest.raises((OSError, CheckpointError)) as e:
            save(2, 2.0)(world)
        return type(e.value), str(e.value)

    got = _on_ranks(2, rank, timeout=60)
    assert got[0] == (OSError, "disk full")
    assert got[1][0] is CheckpointError and "rank 0, did not commit: " \
        "OSError: disk full" in got[1][1]
    after = ck.checkpoint_stats()
    assert after["aborted_commits"] - before["aborted_commits"] == 2
    assert after["commits"] == before["commits"]
    assert ck.latest_step(d) == 1
    out, step = ck.restore(d, {"w": torch.zeros(4)}, coordinate=False)
    assert step == 1 and torch.equal(out["w"], torch.ones(4))


def test_resave_of_a_step_replaces_it(tmp_path):
    ps, d = _solo(), str(tmp_path)
    ck.save(d, 3, {"w": torch.zeros(4)}, process_set=ps)
    ck.save(d, 3, {"w": torch.full((4,), 7.0)}, process_set=ps)
    assert sorted(os.listdir(d)) == ["3"]
    out, _ = ck.restore(d, {"w": torch.zeros(4)}, process_set=ps)
    assert torch.equal(out["w"], torch.full((4,), 7.0))


def test_async_save_owns_its_snapshot(tmp_path, monkeypatch):
    """The caller updates every leaf in place as soon as ``save``
    returns, while the writer is held before it writes: the checkpoint
    holds the values of the call."""
    ps, d = _solo(), str(tmp_path)
    mesh = create_mesh({"model": 1}, ps.world)
    gate = threading.Event()
    write = ck._write_shards

    def held(*a):
        assert gate.wait(30)
        return write(*a)

    monkeypatch.setattr(ck, "_write_shards", held)
    tree = {"p": torch.randn(5, 3, generator=torch.Generator().manual_seed(1)
                             ).requires_grad_(),
            "bf": torch.randn(4, 4).to(torch.bfloat16),
            "marked": set_leaf_spec(torch.arange(6.0), ("model",)),
            "np": np.arange(4.0), "step": torch.tensor(3)}
    want = {k: (v.copy() if isinstance(v, np.ndarray) else v.detach().clone())
            for k, v in tree.items()}
    ck.save(d, 1, tree, process_set=ps, async_=True, mesh=mesh)
    with torch.no_grad():
        for k in ("p", "bf", "marked", "step"):
            tree[k].add_(1)
    tree["np"] += 1
    gate.set()
    ck.wait(ps)
    like = {k: (v.detach().clone() if torch.is_tensor(v) else v)
            for k, v in tree.items()}
    like["marked"] = set_leaf_spec(torch.zeros(6), ("model",))
    like["p"].requires_grad_()
    out, _ = ck.restore(d, like, process_set=ps, mesh=mesh)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(out[k], v)
        else:
            assert _same(out[k], v), k
    assert out["p"].requires_grad and leaf_spec(out["marked"]) == ("model",)


def test_async_failure_reraises_at_next_save_or_wait(tmp_path, monkeypatch):
    ps, d = _solo(), str(tmp_path)

    called = threading.Event()

    def fail(*a):
        called.set()
        raise OSError("no space left")

    monkeypatch.setattr(ck, "_write_shards", fail)
    ck.save(d, 1, {"w": torch.zeros(2)}, process_set=ps, async_=True)
    with pytest.raises(OSError, match="no space left"):
        ck.wait(ps)
    ck.wait(ps)                                  # surfaced once
    called.clear()
    ck.save(d, 2, {"w": torch.zeros(2)}, process_set=ps, async_=True)
    assert called.wait(30)
    monkeypatch.undo()
    with pytest.raises(OSError, match="no space left"):
        ck.save(d, 3, {"w": torch.zeros(2)}, process_set=ps)
    ck.save(d, 3, {"w": torch.zeros(2)}, process_set=ps)
    assert ck.latest_step(d) == 3


def test_save_makes_no_collective_on_the_group(tmp_path, monkeypatch):
    """Both barriers are on the store: a save of 2 ranks, sync then
    async, with every collective of torch_ops failing."""
    def no_collective(*a):
        raise AssertionError("a save ran a collective on the group")

    monkeypatch.setattr(torch_ops, "_run", no_collective)
    d = str(tmp_path)

    def rank(world):
        ps = ProcessSet.from_world(world)
        ck.save(d, 1, {"w": torch.ones(2)}, process_set=ps)
        ck.save(d, 2, {"w": torch.ones(2)}, process_set=ps, async_=True)
        ck.wait(ps)

    _on_ranks(2, rank, timeout=60)
    assert ck.latest_step(d) == 2


# Process sets and coordinate.

def test_non_global_set_commits_at_its_lowest_member(tmp_path, monkeypatch):
    d, ranks_of = str(tmp_path), {}
    merge, committed = ck._merge_and_commit, []

    def recording(*a):
        committed.append(ranks_of[threading.get_ident()])
        return merge(*a)

    monkeypatch.setattr(ck, "_merge_and_commit", recording)

    def rank(world):
        ranks_of[threading.get_ident()] = world.rank
        ps = add_process_set([1, 2], world)
        if world.rank == 0:
            return
        ck.save(d, 1, {"w": torch.full((3,), 5.0), "n": np.arange(2)},
                process_set=ps)

    _on_ranks(3, rank, timeout=60)
    assert committed == [1]
    manifest = json.loads(open(os.path.join(d, "1", ck.MANIFEST)).read())
    assert manifest["world_size"] == 2
    assert {s["rank"] for s in manifest["shards"]} == {1}
    assert sorted(os.listdir(os.path.join(d, "1"))) == [
        ck.MANIFEST, "rank_1", "rank_2"]


def test_coordinate_gives_every_rank_the_roots_step(tmp_path):
    """Rank 1 sees a newer step 3 that the root does not: coordinate=True
    restores the root's step 2 on both, coordinate=False step 3 on rank 1."""
    ps = _solo()
    d0, d1 = str(tmp_path / "r0"), str(tmp_path / "r1")
    for s in (1, 2):
        ck.save(d0, s, {"w": torch.full((2,), float(s))}, process_set=ps)
    shutil.copytree(d0, d1)
    ck.save(d1, 3, {"w": torch.full((2,), 3.0)}, process_set=ps)

    def rank(world):
        mine = (d0, d1)[world.rank]
        like = {"w": torch.zeros(2)}
        out, step = ck.restore(mine, like,
                               process_set=ProcessSet.from_world(world))
        _, local = ck.restore(mine, like, coordinate=False)
        return step, out["w"][0].item(), local

    assert _on_ranks(2, rank, timeout=60) == [(2, 2.0, 2), (2, 2.0, 3)]


def test_counters_metrics_and_spans_move(tmp_path):
    ps, d = _solo(), str(tmp_path)
    was = metrics.enabled()
    metrics.enable()
    try:
        families = {f: getattr(metrics, f) for f in dir(metrics)
                    if f.startswith("CKPT_")}
        assert len(families) == 10

        def value(m):
            got = m.collect()
            return got[0][1]["value"] if got else 0.0

        m0 = {f: value(m) for f, m in families.items()}
        s0 = hvd.checkpoint_stats()
        n_events = len(spans.recorder.events())
        tree = {"a": torch.ones(4, 4), "b": np.arange(3)}
        ck.save(d, 7, tree, process_set=ps)
        ck.save(d, 8, tree, process_set=ps, async_=True)
        ck.wait(ps)
        out, step = ck.restore(d, tree, process_set=ps)
        s1 = hvd.checkpoint_stats()
        assert step == 8 and torch.equal(out["a"], tree["a"])
        d_ = {k: s1[k] - s0[k] for k in ("saves", "commits", "restores",
                                         "bytes", "bytes_read",
                                         "fragments_fetched",
                                         "aborted_commits")}
        assert d_ == {"saves": 2, "commits": 2, "restores": 1,
                      "bytes": d_["bytes"], "bytes_read": d_["bytes"] // 2,
                      "fragments_fetched": 2, "aborted_commits": 0}
        assert d_["bytes"] > 0
        assert s1["last_committed_step"] == 8
        assert s1["snapshot_stall_ms"] > 0 and s1["write_ms"] > 0
        m1 = {f: value(m) for f, m in families.items()}
        assert m1["CKPT_SAVES"] - m0["CKPT_SAVES"] == 2
        assert m1["CKPT_COMMITS"] - m0["CKPT_COMMITS"] == 2
        assert m1["CKPT_RESTORES"] - m0["CKPT_RESTORES"] == 1
        assert m1["CKPT_BYTES_WRITTEN"] - m0["CKPT_BYTES_WRITTEN"] == \
            d_["bytes"]
        assert m1["CKPT_BYTES_READ"] - m0["CKPT_BYTES_READ"] == \
            d_["bytes_read"]
        assert m1["CKPT_FRAGMENTS"] - m0["CKPT_FRAGMENTS"] == 2
        assert m1["CKPT_LAST_COMMITTED_STEP"] == 8
        assert m1["CKPT_WRITE_SECONDS"] > 0
        assert m1["CKPT_SNAPSHOT_STALL_SECONDS"] > 0
        assert m1["CKPT_ABORTED_COMMITS"] == m0["CKPT_ABORTED_COMMITS"]
        names = [e["name"] for e in spans.recorder.events()[n_events:]
                 if e.get("cat") == "ckpt"]
        for name in ("ckpt.save", "ckpt.snapshot_stall", "ckpt.write",
                     "ckpt.commit", "ckpt.restore"):
            assert name in names, name
        assert names.count("ckpt.save") == 2
    finally:
        if not was:
            metrics.disable()


def test_bf16_into_a_numpy_like_raises(tmp_path):
    ck.save(str(tmp_path), 1, {"bf": torch.ones(3, dtype=torch.bfloat16)},
            process_set=_solo())
    with pytest.raises(CheckpointError, match="bfloat16.*tensor like"):
        ck.restore(str(tmp_path), {"bf": np.zeros(3)}, coordinate=False)
    out, _ = ck.restore(str(tmp_path), {"bf": torch.zeros(3)},
                        coordinate=False)
    assert out["bf"].dtype == torch.bfloat16 and bool((out["bf"] == 1).all())
