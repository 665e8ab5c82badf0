"""Sharded, async, crash-safe checkpoints: the port of
``horovod_tpu/checkpoint.py``, in its ``hvd-sharded-v1`` format file for
file and byte for byte (docs/checkpoint.md has the spec). Each rank
writes only its own blocks; no rank gathers a whole tensor:

    <dir>/<step>.tmp/rank_<r>/shard_NNNN.npy   per-shard payloads
    <dir>/<step>.tmp/rank_<r>/shards.json      per-rank shard manifest
    <dir>/<step>/MANIFEST.json                 global manifest (committed)

Trees are the port's nested dicts and lists (``tree.py``), whose paths
are written as ``jax.tree_util.keystr`` writes them, so a tensor's name
in the manifest is the reference's. Where a leaf lies:

- A tensor marked with a spec (``parallel/mesh.py::set_leaf_spec``, as
  ``models/convert.py::shard_params`` and ``shard_stage_params`` mark
  theirs) is this rank's block of a whole tensor, cut along each dim the
  spec names an axis of ``mesh=`` for, the block at the rank's
  coordinate: ``shard_params``' rule. The rank whose coordinate is 0 on
  every mesh axis the leaf is not cut over writes it, so exactly one rank
  writes each block (the reference's ``replica_id == 0``). A marked leaf
  without ``mesh=`` raises. A dim that ``shard_params`` padded to a
  multiple of its axis (``mesh.PaddedAxis``: an uneven vocabulary) is
  saved at its true size, the pad rows never written, and restored
  with zeros in them.
- Any other tensor, numpy array or number is written whole by the set's
  root, its lowest member.

Commit: every member writes and fsyncs its shards and its rank manifest,
then meets a barrier (``ckpt.shards.<step>.<n>``); the root merges the
rank manifests, checks that the shards tile every tensor, fsyncs
``MANIFEST.json``, renames ``<step>.tmp`` to ``<step>`` and publishes its
verdict (``ckpt.commit.<step>.<n>``), which every member waits for and
raises on if the root failed. A crash before the rename leaves the
previous step as latest: :func:`latest_step` never resolves a staging
directory or one without a committed manifest. Both barriers are keys on
the job's store (``World.store``), never a collective on the set's
process group: an async save commits on a writer thread while the
training thread runs its collectives on that group, and two threads
interleaving calls on one NCCL communicator can hang. ``<n>`` counts the
set's saves, so a re-save of a step never meets an old key. A member
missing for the world's timeout (``HVD_JAX_COORD_TIMEOUT`` seconds by
default) raises ``HorovodInternalError``; in an elastic job so does a
newer epoch from the driver, as soon as the rank sees it. The root
reports each commit to the elastic driver (``_report_commit``).

Async: ``save(..., async_=True)`` copies this rank's blocks to the host
(CUDA tensors into pinned buffers, synchronised; CPU tensors and numpy
arrays copied, since the port's optimizers update in place) and returns;
a writer thread serialises, writes and commits. The copy is the only
part that blocks the step (``snapshot_stall_ms``, the
``ckpt.snapshot_stall`` span). One save is in flight per world (each
rank's ``World``, as ranks run as threads in the tests); the next
``save`` or :func:`wait` joins it and re-raises its failure.

Restore reshards: a marked tensor of ``tree_like`` reads only its block
under ``mesh=``, which may differ in size from the saver's, and comes
back on the like's device with the like's spec; an unmarked tensor comes
back whole on its device, a numpy leaf as numpy, each in the dtype the
checkpoint holds.

bfloat16 without ``ml_dtypes``: a bf16 payload is written as the
reference writes one (``np.save`` of an ``ml_dtypes`` array: a ``'<V2'``
``.npy`` of the raw 16-bit words) and read back through an int16 view.
(The reference itself cannot read one back: it casts the ``V2`` payload
into a ``bfloat16`` buffer, which numpy refuses.)

Kept deviations: the legacy orbax read path is not ported (a step with
only ``_METADATA`` counts as committed, but restoring it raises
``CheckpointError``). Counters (:func:`checkpoint_stats`) are per process, as
in the reference: ranks that are threads of one process add to the same
counters.
"""

import datetime
import io
import json
import os
import shutil
import signal
import threading
import time
import weakref
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .exceptions import CheckpointError, HorovodInternalError
from .observability import metrics as _metrics
from .observability import spans as _spans
from .ops import torch_ops
from .parallel.mesh import is_marked, leaf_spec, set_leaf_spec
from .process_sets import global_process_set
from .tree import tree_flatten_with_path, tree_leaves, tree_unflatten

FORMAT = "hvd-sharded-v1"
MANIFEST = "MANIFEST.json"
_RANK_MANIFEST = "shards.json"

# torch dtype -> the numpy name the manifest records. A payload is held
# in numpy as that dtype, bf16 as its int16 words (_storage).
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
# np.save's header for an ml_dtypes bfloat16 array.
_BF16_DESCR = "<V2"


def _storage(dtype):
    """The numpy dtype a payload of manifest dtype ``dtype`` is held in."""
    return np.dtype(np.int16 if dtype == "bfloat16" else dtype)


def _dtype_name(t):
    try:
        return _DTYPE_NAMES[t.dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {t.dtype}") from None


def _resolve_set(process_set):
    """(world, root, members): the root is the set's lowest member."""
    world = process_set.world
    if world is None:
        raise ValueError(f"{process_set} is not registered: call hvd.init() "
                         f"or pass a registered ProcessSet")
    if not process_set.included():
        raise ValueError(f"rank {world.rank} is not a member of "
                         f"{process_set}")
    return world, process_set.ranks[0], list(process_set.ranks)


# ---------------------------------------------------------------------------
# Stats (hvd.checkpoint_stats()): plain counters, always on; the CKPT_*
# metric families mirror them only under HVD_METRICS.

_stats_lock = threading.Lock()
_stats = {
    "saves": 0,              # save() calls entered
    "commits": 0,            # checkpoints durably committed (renamed)
    "aborted_commits": 0,    # saves that died before the rename
    "bytes": 0,              # shard bytes this process wrote
    "snapshot_stall_ms": 0.0,  # last device->host snapshot stall
    "write_ms": 0.0,         # last write+commit time (off-path if async)
    "restores": 0,           # restore() calls that returned a tree
    "bytes_read": 0,         # shard-file bytes this process fetched
    "fragments_fetched": 0,  # shard files read during reshard assembly
    "last_committed_step": -1,
}


def checkpoint_stats():
    """Snapshot of this process's checkpoint counters (see module doc)."""
    with _stats_lock:
        return dict(_stats)


def _bump(**kv):
    with _stats_lock:
        for k, v in kv.items():
            if k in ("snapshot_stall_ms", "write_ms", "last_committed_step"):
                _stats[k] = v
            else:
                _stats[k] += v


# ---------------------------------------------------------------------------
# latest_step

def _is_committed(path):
    """A step directory counts only when its commit marker is present:
    the sharded format's MANIFEST.json, or the legacy orbax _METADATA
    (possibly nested under <step>/default/ by an older revision)."""
    return (os.path.exists(os.path.join(path, MANIFEST))
            or os.path.exists(os.path.join(path, "_METADATA"))
            or os.path.exists(os.path.join(path, "default", "_METADATA")))


def latest_step(directory):
    """Newest COMMITTED checkpoint step in `directory`, or None.

    ``<step>.tmp`` staging dirs and integer-named dirs lacking a commit
    marker (a crashed writer's leftovers) are never resolved as latest.
    """
    d = str(directory)
    if not os.path.isdir(d):
        return None
    steps = [int(n) for n in os.listdir(d)
             if n.isdigit() and os.path.isdir(os.path.join(d, n))
             and _is_committed(os.path.join(d, n))]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# Per-world state: the in-flight async save and the sets' save counts.

class _InFlight:
    __slots__ = ("thread", "error")

    def __init__(self):
        self.thread = None
        self.error = None


class _WorldState:
    def __init__(self):
        self.inflight = None
        self.saves = {}      # the members of a set -> its saves so far


_worlds = weakref.WeakKeyDictionary()
_worlds_lock = threading.Lock()


def _state(world):
    with _worlds_lock:
        st = _worlds.get(world)
        if st is None:
            st = _worlds[world] = _WorldState()
        return st


def wait(process_set=global_process_set):
    """Block until the in-flight async save of ``process_set``'s world (if
    any) commits; re-raises the writer thread's failure here, on the
    caller's thread."""
    world = process_set.world
    if world is None:
        return
    st = _state(world)
    inf, st.inflight = st.inflight, None
    if inf is None:
        return
    inf.thread.join()
    if inf.error is not None:
        raise inf.error


def _resolve_dir(directory):
    d = directory if directory is not None else os.environ.get("HVD_CKPT_DIR")
    if not d:
        raise ValueError(
            "no checkpoint directory: pass one or set HVD_CKPT_DIR")
    return str(d)


# ---------------------------------------------------------------------------
# Save: snapshot (step-blocking) + write/commit (inline or background)

def _box(name, spec, shape, mesh):
    """(global shape, [[start, stop], ...], writes) of a leaf of local
    ``shape`` cut by ``spec`` under ``mesh``, for this rank: ``writes``
    when its coordinate is 0 on every axis the leaf is not cut over. A
    dim padded to a multiple of its axis (``mesh.PaddedAxis``) counts
    its true size: the global shape is unpadded, and the rank's range
    stops there (it may be empty)."""
    if mesh is None:
        raise ValueError(f"tensor {name} is marked with spec {spec}: pass "
                         f"the mesh it is cut under (mesh=)")
    coords = dict(zip(mesh.axis_names, mesh.coords()))
    gshape, index = [], []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            gshape.append(int(n))
            index.append([0, int(n)])
            continue
        if axis not in mesh.shape:
            raise ValueError(f"tensor {name} is cut over '{axis}', which "
                             f"{mesh} does not have")
        k, c = mesh.shape[axis], coords[axis]
        whole = getattr(axis, "size", int(n) * k)
        gshape.append(whole)
        index.append([min(c * int(n), whole), min((c + 1) * int(n), whole)])
    writes = all(coords[a] == 0 for a in mesh.axis_names if a not in spec)
    return gshape, index, writes


def _numpy(x):
    """A host tensor as numpy, sharing its bytes (bf16 as its int16
    words); a numpy array as it is."""
    if not torch.is_tensor(x):
        return x
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _snapshot(tree, me, root, mesh):
    """Copy this rank's contribution to the host: the ONLY part of a save
    that blocks the step. Returns the manifest's tensors and
    ``[(name, index, numpy payload)]``, each payload owning its bytes."""
    t0 = time.perf_counter()
    tensors, shards, devices = {}, [], set()
    for name, leaf in tree_flatten_with_path(tree):
        if torch.is_tensor(leaf):
            dtype = _dtype_name(leaf)
            t = leaf.detach()
            if is_marked(leaf):
                gshape, index, writes = _box(name, leaf_spec(leaf),
                                             leaf.shape, mesh)
                # a padded dim's pad rows stay behind
                for dim, (a, b) in enumerate(index):
                    if b - a != t.shape[dim]:
                        t = t.narrow(dim, 0, b - a)
                writes = writes and (t.numel() > 0 or leaf.numel() == 0)
            else:
                gshape = [int(d) for d in leaf.shape]
                index, writes = [[0, d] for d in gshape], me == root
            if writes:
                if t.is_cuda:
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    devices.add(t.device)
                else:
                    host = t.clone(memory_format=torch.contiguous_format)
                shards.append((name, index, host))
        else:
            arr = np.asarray(leaf)
            gshape, dtype = [int(d) for d in arr.shape], arr.dtype.name
            if me == root:
                shards.append((name, [[0, d] for d in gshape],
                               np.array(arr)))
        tensors[name] = {"global_shape": gshape, "dtype": dtype}
    for device in devices:
        torch.cuda.synchronize(device)
    shards = [(name, index, _numpy(host)) for name, index, host in shards]
    stall_ms = (time.perf_counter() - t0) * 1e3
    _bump(snapshot_stall_ms=stall_ms)
    if _metrics.enabled():
        _metrics.CKPT_SNAPSHOT_STALL_SECONDS.set(stall_ms / 1e3)
        _spans.event("ckpt.snapshot_stall",
                     time.time_ns() // 1000 - int(stall_ms * 1e3),
                     int(stall_ms * 1e3), cat="ckpt")
    return tensors, shards


def _npy_bytes(arr, dtype):
    """What ``np.save`` writes for the payload, bf16 (int16 words) with
    the header it gives an ``ml_dtypes`` bfloat16 array."""
    arr = np.ascontiguousarray(arr)
    buf = io.BytesIO()
    if dtype == "bfloat16":
        header = np.lib.format.header_data_from_array_1_0(arr)
        header["descr"] = _BF16_DESCR
        np.lib.format.write_array_header_1_0(buf, header)
        buf.write(arr.tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_shards(rankdir, tensors, shards, step, rank):
    """Write this rank's shard payloads + per-rank manifest, all fsynced
    before returning: the barrier that follows asserts durability."""
    if os.path.isdir(rankdir):
        shutil.rmtree(rankdir)  # stale leftovers from an aborted attempt
    os.makedirs(rankdir)
    entries, nbytes = [], 0
    for i, (name, index, arr) in enumerate(shards):
        fname = f"shard_{i:04d}.npy"
        data = _npy_bytes(arr, tensors[name]["dtype"])
        with open(os.path.join(rankdir, fname), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        entries.append({"name": name, "index": index, "file": fname,
                        "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                        "nbytes": len(data)})
        nbytes += len(data)
    rm = {"format": FORMAT, "step": int(step), "rank": int(rank),
          "tensors": tensors, "shards": entries}
    with open(os.path.join(rankdir, _RANK_MANIFEST), "w") as f:
        json.dump(rm, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(rankdir)
    _bump(bytes=nbytes)
    if _metrics.enabled():
        _metrics.CKPT_BYTES_WRITTEN.inc(nbytes)
    return nbytes


def _box_volume(index):
    v = 1
    for s, e in index:
        v *= max(0, e - s)
    return v


def _merge_and_commit(directory, staging, final, step, members):
    """Root half of the commit: merge rank manifests, validate coverage,
    fsync MANIFEST.json, atomically rename the staging dir."""
    tensors, merged = None, []
    for r in members:
        rman = os.path.join(staging, f"rank_{r}", _RANK_MANIFEST)
        try:
            with open(rman) as f:
                rm = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"step {step}: rank {r} manifest {rman} unreadable: {e}")
        if tensors is None:
            tensors = rm["tensors"]
        for sh in rm["shards"]:
            merged.append(dict(sh, rank=int(r)))
    # Drop rank dirs that are not part of this commit (a crashed attempt
    # at a different world size leaves them behind in the staging dir).
    keep = {f"rank_{r}" for r in members}
    for n in os.listdir(staging):
        if n.startswith("rank_") and n not in keep:
            shutil.rmtree(os.path.join(staging, n), ignore_errors=True)
    # Coverage: the deduped shard boxes of every tensor must tile its
    # global shape exactly, else the checkpoint could restore silently
    # wrong.
    by_name = {}
    for sh in merged:
        by_name.setdefault(sh["name"], set()).add(
            tuple((s, e) for s, e in sh["index"]))
    for name, meta in tensors.items():
        vol = int(np.prod([int(d) for d in meta["global_shape"]] or [1]))
        got = sum(_box_volume(b) for b in by_name.get(name, ()))
        if got != vol:
            raise CheckpointError(
                f"step {step}: tensor {name} shards cover {got} of {vol} "
                f"elements — refusing to commit a torn checkpoint")
    manifest = {"format": FORMAT, "step": int(step),
                "world_size": len(members), "tensors": tensors,
                "shards": merged}
    mpath = os.path.join(staging, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(staging)
    if os.path.isdir(final):  # re-save of an existing step
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
        os.rename(staging, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(staging, final)
    _fsync_dir(directory)


# Seconds between an elastic worker's looks at the driver's epoch while
# it waits on a checkpoint key.
_EPOCH_POLL_S = 0.5


def _wait_key(store, key, what, timeout):
    """Wait for ``key``, at most ``timeout`` seconds. In an elastic job it
    also gives up, at once, when the driver has published a newer epoch:
    a member died, and no key it owed will come (a writer killed before
    the shards barrier would hold the survivors the whole timeout)."""
    from .runner.elastic import worker as _worker

    elastic = _worker.is_elastic()
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        wait = min(left, _EPOCH_POLL_S) if elastic else left
        try:
            store.wait([key], datetime.timedelta(seconds=max(wait, 0.001)))
            return
        except RuntimeError as e:     # the store's timeout
            if elastic and _worker.notification_manager.newer_epoch():
                raise HorovodInternalError(
                    f"checkpoint {what}: the elastic driver published "
                    f"epoch {_worker.notification_manager.latest} while "
                    f"this rank waited in epoch "
                    f"{_worker.notification_manager.epoch}") from e
            if wait >= left:
                raise HorovodInternalError(
                    f"checkpoint {what}: a member did not arrive within "
                    f"{timeout} s ({e})") from e


def _barrier(store, key, n, timeout):
    """Return once all ``n`` members have reached barrier ``key``."""
    if store.add(key, 1) == n:
        store.set(key + ".done", "1")
    _wait_key(store, key + ".done", f"barrier {key}", timeout)


def _write_and_commit(directory, step, tensors, shards, world, root,
                      members, n):
    """Serialization + IO + the two-barrier commit: everything a save
    does OFF the step path when async. Runs on the caller's thread for
    sync saves and on the background writer thread for async ones."""
    me = world.rank
    store = dist.PrefixStore(
        "ckpt/" + ",".join(str(r) for r in members), world.store)
    t0 = time.perf_counter()
    try:
        with _spans.span("ckpt.write", cat="ckpt", step=int(step)):
            staging = os.path.join(directory, f"{int(step)}.tmp")
            final = os.path.join(directory, str(int(step)))
            rankdir = os.path.join(staging, f"rank_{me}")
            os.makedirs(staging, exist_ok=True)
            _write_shards(rankdir, tensors, shards, step, me)
            if (os.environ.get("HVD_CKPT_TEST_CRASH") == str(int(step))
                    and me == root):
                # Chaos hook: the writer dies with durable shards but NO
                # commit; survivors must restore the previous step.
                os.kill(os.getpid(), signal.SIGKILL)
            _barrier(store, f"ckpt.shards.{int(step)}.{n}", len(members),
                     world.timeout)
            with _spans.span("ckpt.commit", cat="ckpt", step=int(step)):
                verdict = f"ckpt.commit.{int(step)}.{n}"
                if me == root:
                    try:
                        _merge_and_commit(directory, staging, final, step,
                                          members)
                    except BaseException as e:
                        store.set(verdict, f"{type(e).__name__}: {e}")
                        raise
                    store.set(verdict, "ok")
                else:
                    _wait_key(store, verdict, f"commit of step {step}",
                              world.timeout)
                    said = store.get(verdict).decode()
                    if said != "ok":
                        raise CheckpointError(
                            f"step {step}: the root, rank {root}, did not "
                            f"commit: {said}")
    except BaseException:
        _bump(aborted_commits=1)
        if _metrics.enabled():
            _metrics.CKPT_ABORTED_COMMITS.inc()
        raise
    write_ms = (time.perf_counter() - t0) * 1e3
    _bump(commits=1, write_ms=write_ms, last_committed_step=int(step))
    if _metrics.enabled():
        _metrics.CKPT_COMMITS.inc()
        _metrics.CKPT_WRITE_SECONDS.set(write_ms / 1e3)
        _metrics.CKPT_LAST_COMMITTED_STEP.set(int(step))
    if me == root:
        _report_commit(int(step))


def _report_commit(step):
    """Tell the elastic driver the last committed step (the set root
    calls this after each commit): it rides every later epoch's
    assignments, so a promoted spare or a respawned rank restores it
    without a collective (``elastic.restore_from_checkpoint``)."""
    from .runner.elastic import worker as _worker

    if _worker.is_elastic():
        _worker.report_ckpt_commit(step)


def save(directory, step, tree, process_set=global_process_set,
         async_=None, *, mesh=None):
    """Write `tree` (a tree of tensors, numpy arrays and numbers) as
    checkpoint `step`.

    Every member of ``process_set`` (a registered ``ProcessSet``; default
    the world of ``hvd.init()``) writes its own blocks; the set's root
    commits only after a barrier confirms every member's shards are
    durable. ``mesh``: the ``Mesh`` the marked leaves are cut under.
    Sync saves return after the commit; ``async_=True`` returns right
    after the host snapshot and commits on a writer thread (:func:`wait`
    joins it; a failure re-raises on the next ``save``/``wait``).
    ``async_=None`` reads ``HVD_CKPT_ASYNC``. ``directory=None`` falls
    back to ``HVD_CKPT_DIR``.
    """
    if async_ is None:
        async_ = os.environ.get("HVD_CKPT_ASYNC", "0") == "1"
    directory = _resolve_dir(directory)
    world, root, members = _resolve_set(process_set)
    wait(process_set)  # one in flight; surfaces the previous failure
    _bump(saves=1)
    if _metrics.enabled():
        _metrics.CKPT_SAVES.inc()
    st = _state(world)
    n = st.saves.get(tuple(members), 0)
    st.saves[tuple(members)] = n + 1
    with _spans.span("ckpt.save", cat="ckpt", step=int(step),
                     mode="async" if async_ else "sync"):
        tensors, shards = _snapshot(tree, world.rank, root, mesh)
        args = (directory, step, tensors, shards, world, root, members, n)
        if not async_:
            _write_and_commit(*args)
            return
        inf = _InFlight()

        def _run():
            try:
                _write_and_commit(*args)
            except BaseException as e:  # surfaced on the next save/wait
                inf.error = e

        inf.thread = threading.Thread(
            target=_run, name=f"ckpt-writer-{int(step)}", daemon=True)
        st.inflight = inf
        inf.thread.start()


# ---------------------------------------------------------------------------
# Restore (with reshard)

def _load_manifest(path):
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except OSError as e:
        raise CheckpointError(f"{mpath}: unreadable: {e}")
    except ValueError as e:
        raise CheckpointError(
            f"{mpath}: torn manifest (not parseable as JSON: {e}) — the "
            f"checkpoint did not commit intact")
    if manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"{mpath}: unknown format {manifest.get('format')!r} "
            f"(expected {FORMAT})")
    return manifest


class _ShardReader:
    """Reads + verifies shard files on demand, caching per restore call."""

    def __init__(self, path, manifest):
        self.path = path
        self.by_name = {}
        for sh in manifest["shards"]:
            self.by_name.setdefault(sh["name"], []).append(sh)
        self._cache = {}

    def load(self, sh, dtype):
        key = (sh["rank"], sh["file"])
        if key in self._cache:
            return self._cache[key]
        where = f"shard rank_{sh['rank']}/{sh['file']}"
        fpath = os.path.join(self.path, f"rank_{sh['rank']}", sh["file"])
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            raise CheckpointError(
                f"missing {where} for tensor {sh['name']}: {e}")
        if (zlib.crc32(data) & 0xFFFFFFFF) != sh["crc32"]:
            raise CheckpointError(
                f"checksum mismatch in {where} for tensor {sh['name']}")
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        if dtype == "bfloat16" and arr.dtype == np.dtype(_BF16_DESCR):
            arr = arr.view(np.int16)
        if arr.dtype != _storage(dtype):
            raise CheckpointError(
                f"{where} holds {arr.dtype}, the manifest says {dtype} "
                f"for tensor {sh['name']}")
        self._cache[key] = arr
        _bump(bytes_read=len(data), fragments_fetched=1)
        if _metrics.enabled():
            _metrics.CKPT_BYTES_READ.inc(len(data))
            _metrics.CKPT_FRAGMENTS.inc()
        return arr

    def read_region(self, name, bounds, dtype):
        """Assemble the [start, stop) region `bounds` of tensor `name`
        from only the shard fragments that overlap it."""
        out = np.empty([e - s for s, e in bounds], _storage(dtype))
        want = _box_volume(bounds)
        covered = 0
        for sh in self.by_name.get(name, ()):
            inter = []
            for (ws, we), (ss, se) in zip(bounds, sh["index"]):
                s, e = max(ws, ss), min(we, se)
                if s >= e:
                    inter = None
                    break
                inter.append((s, e))
            if inter is None and bounds:
                continue
            arr = self.load(sh, dtype)
            if bounds:
                dst = tuple(slice(s - ws, e - ws)
                            for (s, e), (ws, we) in zip(inter, bounds))
                src = tuple(slice(s - ss, e - ss)
                            for (s, e), (ss, se) in zip(inter, sh["index"]))
                out[dst] = arr[src]
                covered += _box_volume(inter)
            else:  # scalar (np.save may have stored it with shape (1,))
                out[()] = arr.reshape(())
                covered += 1
        if covered != want:
            raise CheckpointError(
                f"tensor {name}: region {bounds} only {covered}/{want} "
                f"elements covered by shards — refusing a partial restore")
        return out


def _as_tensor(arr, dtype, like):
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    t = t.to(like.device)
    if like.requires_grad and t.is_floating_point():
        t.requires_grad_()
    return t


def _restore_sharded(path, tree_like, mesh):
    """Reshard-on-read: every target leaf fetches only the index ranges
    it needs."""
    manifest = _load_manifest(path)
    reader = _ShardReader(path, manifest)
    tensors = manifest["tensors"]
    out = []
    for name, leaf in tree_flatten_with_path(tree_like):
        if name not in tensors:
            raise CheckpointError(
                f"{os.path.join(path, MANIFEST)}: no tensor {name} in the "
                f"checkpoint (saved tree differs from tree_like)")
        meta = tensors[name]
        gshape = [int(d) for d in meta["global_shape"]]
        dtype = meta["dtype"]
        whole = [[0, d] for d in gshape]
        if not torch.is_tensor(leaf):
            if dtype == "bfloat16":
                raise CheckpointError(
                    f"tensor {name} is bfloat16, which numpy does not "
                    f"hold: restore it into a tensor like")
            out.append(reader.read_region(name, whole, dtype))
            continue
        if dtype not in _DTYPE_NAMES.values():
            raise CheckpointError(f"tensor {name}: no torch dtype for "
                                  f"{dtype}")
        if is_marked(leaf):
            spec = leaf_spec(leaf)
            want, bounds, _ = _box(name, spec, leaf.shape, mesh)
        else:
            spec, want, bounds = None, [int(d) for d in leaf.shape], whole
        if want != gshape:
            raise CheckpointError(
                f"tensor {name}: tree_like shape {tuple(leaf.shape)} "
                f"(whole {tuple(want)}) != saved shape {tuple(gshape)}")
        arr = reader.read_region(name, bounds, dtype)
        if spec is not None and arr.shape != tuple(leaf.shape):
            # a padded dim (mesh.PaddedAxis): zeros past the true rows
            full = np.zeros(tuple(leaf.shape), arr.dtype)
            full[tuple(slice(0, d) for d in arr.shape)] = arr
            arr = full
        t = _as_tensor(arr, dtype, leaf)
        out.append(t if spec is None else set_leaf_spec(t, spec))
    return tree_unflatten(tree_like, out)


def restore(directory, tree_like, step=None, process_set=global_process_set,
            coordinate=True, *, mesh=None):
    """Restore a checkpoint into the structure (and, for marked tensors
    under ``mesh``, the layout) of `tree_like`; returns (tree, step) or
    (None, None) when no committed checkpoint exists.

    With ``coordinate=True`` the set's root resolves which step to load
    (`step` or the latest) and broadcasts its choice over the set, on the
    caller's thread, so every member reads the SAME checkpoint even if a
    newer one lands mid-call. ``coordinate=False`` resolves locally and
    makes no collective call (and needs no registered set).
    """
    directory = _resolve_dir(directory)
    if not coordinate:
        chosen = step if step is not None else latest_step(directory)
    else:
        world, root, _ = _resolve_set(process_set)
        if world.rank == root:
            chosen = step if step is not None else latest_step(directory)
        else:
            chosen = None
        chosen = torch_ops.broadcast_object(chosen, root_rank=root,
                                            process_set=process_set)
    if chosen is None:
        return None, None
    path = os.path.join(directory, str(int(chosen)))
    with _spans.span("ckpt.restore", cat="ckpt", step=int(chosen)):
        if os.path.exists(os.path.join(path, MANIFEST)):
            out = _restore_sharded(path, tree_like, mesh)
        elif _is_committed(path):
            raise CheckpointError(
                f"{path}: a legacy orbax checkpoint (_METADATA), which the "
                f"port does not read: restore it with the JAX package "
                f"(horovod_tpu.checkpoint.restore) and save it again")
        else:
            raise CheckpointError(
                f"{path}: no committed checkpoint ({MANIFEST} and the "
                f"legacy _METADATA marker are both absent)")
    _bump(restores=1)
    if _metrics.enabled():
        _metrics.CKPT_RESTORES.inc()
    return out, int(chosen)


# ---------------------------------------------------------------------------
# The optimizer's state as a tree (optax's state, as the reference saves it)

def _check_params(optimizer, leaves):
    held = [p for g in optimizer.param_groups for p in g["params"]]
    if len(held) != len(leaves) or any(a is not b
                                       for a, b in zip(held, leaves)):
        raise ValueError("the optimizer must be built over "
                         "tree_leaves(params), in that order")


def optimizer_state_tree(optimizer, params):
    """``{state key: tree shaped as params}`` of a torch optimizer built
    over ``tree_leaves(params)``. A state tensor shaped as its param
    carries the param's spec, so AdamW's moments save cut as their params
    are and reshard with them; others (AdamW's ``step``) are unmarked. The
    leaves share storage with the optimizer's state (``save`` copies).
    The optimizer must have stepped: torch builds its state then."""
    leaves = tree_leaves(params)
    _check_params(optimizer, leaves)
    states = [optimizer.state.get(p) for p in leaves]
    if not states or not all(states):
        raise ValueError(
            "the optimizer holds no state for some leaf before its first "
            "step: restore into a like built from the params (see "
            "load_optimizer_state_tree)")
    keys = sorted(k for k, v in states[0].items() if torch.is_tensor(v))
    if any(sorted(k for k, v in s.items() if torch.is_tensor(v)) != keys
           for s in states):
        raise ValueError("the optimizer's state keys differ between leaves")

    def leaf(p, t):
        t = t.detach()
        if is_marked(p) and t.shape == p.shape:
            set_leaf_spec(t, leaf_spec(p))
        return t

    return {k: tree_unflatten(params, [leaf(p, s[k])
                                       for p, s in zip(leaves, states)])
            for k in keys}


def load_optimizer_state_tree(optimizer, params, tree):
    """The inverse of :func:`optimizer_state_tree`: load ``tree`` into
    ``optimizer`` (built over ``tree_leaves(params)``, fresh or not)
    through its ``load_state_dict``, which moves each moment to its
    param's dtype and device. A restore like for a fresh AdamW reads only
    each like leaf's shape, spec and device, so the params stand in for
    the moments: ``{"exp_avg": params, "exp_avg_sq": params, "step":
    tree_map(lambda p: torch.zeros(()), params)}`` (``step`` on the CPU,
    where AdamW keeps it)."""
    leaves = tree_leaves(params)
    _check_params(optimizer, leaves)
    cols = {k: tree_leaves(sub) for k, sub in tree.items()}
    for k, col in cols.items():
        if len(col) != len(leaves):
            raise ValueError(f"state {k!r} has {len(col)} leaves, the "
                             f"params {len(leaves)}")
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: col[i] for k, col in cols.items()}
                   for i in range(len(leaves))}
    optimizer.load_state_dict(sd)
