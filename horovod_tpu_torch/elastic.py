"""Elastic training: state commit/restore/sync + the retry loop. The port
of ``horovod_tpu/elastic.py``, with the same public names.

Reference parity: `horovod/common/elastic.py` (`State`, `ObjectState`,
`run_fn`) — the framework-agnostic heart of `hvd.elastic.run`:

    @hvd.elastic.run
    def train(state):
        for batch in ...:
            ...
            state.commit()

    state = hvd.elastic.TorchState(params=params, opt=opt_state, batch=0)
    train(state)

Semantics:
- `HorovodInternalError` (a peer died mid-collective) → `state.restore()`
  to the last `commit()`, re-rendezvous, `state.sync()`, retry.
- `HostsUpdatedInterrupt` (membership changed) → re-rendezvous and
  `state.sync()` WITHOUT rollback (no work lost).
- `commit()` = save to host RAM + check for pending host updates.

Re-rendezvous in the port = tear the world down (its NCCL groups
aborted), fetch the new epoch's assignment from the elastic driver's KV
store and build a new world (``runner.elastic.worker.rendezvous_reset``,
``distributed.teardown``).
"""

import copy
import functools
import os
import time

import torch
import torch.distributed as dist
import torch.utils.data

from .exceptions import (  # noqa: F401  (hvd.elastic.HostsUpdatedInterrupt)
    HorovodInternalError, HostsUpdatedInterrupt, RankEvictedError)
from .observability import metrics as _metrics
from .observability import spans as _spans
from .observability import stall as _stall
from .ops import torch_ops as _ops
from .process_sets import global_process_set
from .tree import tree_leaves


_evictions = [0]         # RankEvictedErrors this process has seen


def _note_eviction(e):
    """A RankEvictedError names the culprit. Clear its ops from the
    stall inspector (a survivor must not be shut down for a stall the
    evictee caused) and push the eviction to the elastic driver so it
    SIGKILLs the wedged process now instead of waiting for the liveness
    backstop to notice."""
    if not isinstance(e, RankEvictedError) or e.rank < 0:
        return
    from .runner.elastic import worker as _worker

    _stall.inspector.mark_rank_evicted(e.rank)
    _evictions[0] += 1
    if _metrics.enabled():
        _metrics.ELASTIC_EVENTS.labels(event="evict").inc()
        _metrics.ELASTIC_EVICTIONS.set(_evictions[0])
        _spans.instant("RANK_EVICTED", rank=e.rank)
    if _worker.is_elastic():
        _worker.report_eviction(e.rank, _worker.notification_manager.epoch)


def restore_from_checkpoint(tree_like, directory=None, step=None, *,
                            mesh=None):
    """Manifest-path restore for (re)joiners and promoted spares: resolve
    the step LOCALLY (``coordinate=False`` — a joiner reaches this while
    veterans sit in ``state.sync()``, so a collective here would deadlock)
    and read only the blocks this rank's leaves need under ``mesh``
    (checkpoint.py restore-with-reshard).

    ``step=None`` prefers the driver-published last committed step (it
    rides every epoch assignment — ``runner.elastic.worker
    .last_committed_step``) over ``latest_step()`` on the directory: the
    driver's number can never name a checkpoint another rank is still
    committing. ``directory=None`` falls back to ``HVD_CKPT_DIR``.
    Returns (tree, step) or (None, None) when nothing is committed yet.
    """
    from . import checkpoint as _checkpoint
    from .runner.elastic import worker as _worker

    if step is None and _worker.is_elastic():
        step = _worker.last_committed_step()
    return _checkpoint.restore(directory, tree_like, step=step,
                               coordinate=False, mesh=mesh)


class State:
    """Base elastic state. Subclasses implement save/restore/sync.
    ``sync`` broadcasts over ``_process_set``: the world of
    ``hvd.init()`` (``global_process_set``), or the set a caller puts
    there (ranks that are threads of one process each hand theirs)."""

    def __init__(self):
        self._reset_callbacks = []
        self._host_messages_pending = False
        self._process_set = global_process_set

    def register_reset_callbacks(self, callbacks):
        """Callbacks invoked after every re-rendezvous (reference: used to
        rebuild optimizer internals for the new world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages_pending = False
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self):
        self._host_messages_pending = True

    def prepare_reset(self):
        """Called BEFORE re-rendezvous tears the world down."""

    def commit(self):
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        if self._host_messages_pending:
            self._host_messages_pending = False
            raise HostsUpdatedInterrupt()

    # Subclass surface ----------------------------------------------------
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """State holding arbitrary picklable attributes (reference:
    `ObjectState`): save = deep-copy to host RAM; sync = broadcast from
    rank 0; restore = reload last save."""

    def __init__(self, **kwargs):
        super().__init__()
        self._attrs = dict(kwargs)
        self._saved = copy.deepcopy(self._attrs)

    def __getattr__(self, name):
        attrs = object.__getattribute__(self, "__dict__").get("_attrs", {})
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_") or "_attrs" not in self.__dict__:
            object.__setattr__(self, name, value)
        else:
            self._attrs[name] = value

    def save(self):
        self._saved = copy.deepcopy(self._attrs)

    def restore(self):
        self._attrs = copy.deepcopy(self._saved)

    def sync(self):
        self._attrs = _ops.broadcast_object(self._attrs, root_rank=0,
                                            process_set=self._process_set)
        self.save()


class _Slot:
    """A tensor's place in a saved or broadcast skeleton: its index into
    the flat list, its shape, dtype and device kind, and whether it
    required grad."""

    def __init__(self, i, t):
        self.i, self.shape, self.dtype = i, tuple(t.shape), t.dtype
        self.device = t.device
        self.requires_grad = t.requires_grad


def _split(tree, tensors):
    """``tree`` with each tensor appended to ``tensors`` and replaced by a
    :class:`_Slot`; anything else deep-copied (a pass-through would alias
    the live state)."""
    if isinstance(tree, dict):
        return {k: _split(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, tensors) for v in tree)
    if torch.is_tensor(tree):
        tensors.append(tree)
        return _Slot(len(tensors) - 1, tree)
    return copy.deepcopy(tree)


def _fill(skel, cur, make):
    """``skel`` with each slot replaced by ``make(slot, t)``, where ``t``
    is the working tensor at the same place in ``cur`` or None."""
    if isinstance(skel, dict):
        cur = cur if isinstance(cur, dict) else {}
        return {k: _fill(v, cur.get(k), make) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        cur = cur if (isinstance(cur, (list, tuple))
                      and len(cur) == len(skel)) else [None] * len(skel)
        return type(skel)(_fill(v, c, make) for v, c in zip(skel, cur))
    if isinstance(skel, _Slot):
        return make(skel, cur if torch.is_tensor(cur) else None)
    return copy.deepcopy(skel)


def _fits(slot, t):
    return t is not None and tuple(t.shape) == slot.shape \
        and t.dtype == slot.dtype


class TorchState(ObjectState):
    """Elastic state for trees of tensors (the port's params,
    ``checkpoint.optimizer_state_tree``) and, as the JAX package's torch
    binding takes them (``horovod_tpu/torch/__init__.py:771``), a
    ``model=`` module and an ``optimizer=``: the counterpart of
    ``JaxState``.

    - ``save`` copies every tensor leaf into a host buffer, pinned for a
      CUDA tensor and reused by the next save of a tensor of the same
      shape and dtype (the kind of buffer checkpoint.py's async snapshot
      fills), so a later in-place update of the working tensor never
      reaches the committed copy; anything else is deep-copied.
    - ``restore`` copies each committed value back onto its leaf's
      device: in place into the working tensor at the same place when it
      still has the shape and dtype (so an optimizer built over it keeps
      it), else into a new tensor. The model's state goes back through
      ``load_state_dict``, the optimizer's too.
    - ``sync`` broadcasts from rank 0 over ``_process_set`` (the
      world's, by default): the tensors
      in place (``hvd.broadcast_parameters``; a rank that lacks a leaf,
      a joiner, gets a new one) and the rest, with the layout, through
      ``broadcast_object``; the optimizer through
      ``hvd.broadcast_optimizer_state``.
    - ``prepare_reset`` keeps the working tensors where they are: an NCCL
      abort frees no tensor, where the reference's PJRT teardown kills
      every device array (ROADMAP, kept deviations).
    """

    def __init__(self, model=None, optimizer=None, **kwargs):
        State.__init__(self)
        self._attrs = dict(kwargs)
        self.model = model
        self.optimizer = optimizer
        self._host = []          # the committed tensors, reused buffers
        self._saved = None
        self.save()

    def __setattr__(self, name, value):
        if name in ("model", "optimizer"):
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    def _parts(self):
        parts = {"attrs": self._attrs}
        if self.model is not None:
            parts["model"] = self.model.state_dict()
        if self.optimizer is not None:
            parts["optimizer"] = self.optimizer.state_dict()
        return parts

    def save(self):
        tensors = []
        skel = _split(self._parts(), tensors)
        host, synced = [], set()
        for i, t in enumerate(tensors):
            t = t.detach()
            buf = self._host[i] if i < len(self._host) else None
            if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                    or buf.is_pinned() != t.is_cuda):
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                synced.add(t.device)
            host.append(buf)
        for device in synced:
            torch.cuda.synchronize(device)
        self._host, self._saved = host, skel

    def restore(self):
        host, synced = self._host, set()

        def put(slot, cur):
            src = host[slot.i]
            if _fits(slot, cur) and cur.device == slot.device:
                cur.detach().copy_(src, non_blocking=cur.is_cuda)
                out = cur
            else:
                out = src.to(slot.device, copy=True)
                out.requires_grad_(slot.requires_grad)
            if out.is_cuda:
                synced.add(out.device)
            return out

        saved = self._saved
        self._attrs = _fill(saved["attrs"], self._attrs, put)
        if self.model is not None:
            self.model.load_state_dict(_fill(saved["model"], {}, put))
        if self.optimizer is not None:
            self.optimizer.load_state_dict(_fill(saved["optimizer"], {}, put))
        for device in synced:
            torch.cuda.synchronize(device)

    def sync(self):
        from . import hvd

        ps = self._process_set
        _ops._group(ps)                  # raises before init
        if self.model is not None:
            hvd.broadcast_parameters(self.model.state_dict(), root_rank=0,
                                     process_set=ps)
        if self.optimizer is not None:
            hvd.broadcast_optimizer_state(self.optimizer, root_rank=0,
                                          process_set=ps)
        skel = _ops.broadcast_object(_split(self._attrs, []), root_rank=0,
                                     process_set=ps)
        device = ps.world.device

        def take(slot, cur):
            if _fits(slot, cur):
                return cur
            t = torch.empty(slot.shape, dtype=slot.dtype,
                            device=device if slot.device.type != "cpu"
                            else "cpu")
            return t.requires_grad_(slot.requires_grad)

        attrs = _fill(skel, self._attrs, take)
        hvd.broadcast_parameters(
            [x for x in tree_leaves(attrs) if torch.is_tensor(x)],
            root_rank=0, process_set=ps)
        self._attrs = attrs
        self.save()


class ElasticSampler(torch.utils.data.Sampler):
    """Shard-aware resumable sampler (reference:
    horovod/torch/elastic/sampler.py; the JAX package's torch binding,
    ``horovod_tpu/torch/__init__.py:834``): shards indices by rank/size,
    reshards on reset, skips already-processed indices after restore."""

    def __init__(self, dataset, shuffle=True, seed=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices = set()
        self.reset()

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx, batch_size):
        start = batch_idx * batch_size
        self.processed_indices.update(
            self.indices[start:start + batch_size])

    def reset(self):
        from . import distributed

        up = distributed.is_initialized()
        self.rank = distributed.rank() if up else 0
        self.world = distributed.size() if up else 1
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            import random
            random.Random(self.seed + self.epoch).shuffle(idx)
        idx = [i for i in idx if i not in self.processed_indices]
        self.indices = idx[self.rank::self.world]

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


# What a peer's death looks like when it strikes a collective outside
# torch_ops._run (which raises HorovodInternalError itself): NCCL's
# abort and remote-error spellings, the store's and gloo's.
_TRANSPORT_DEATH = ("communicator was aborted", "NCCL communicator",
                    "ncclRemoteError", "ncclSystemError",
                    "remote process exited", "Connection closed by peer",
                    "Connection reset by peer", "Broken pipe",
                    "Connection refused", "Timed out waiting")


def _is_transport_failure(e):
    """True iff ``e`` is a failed collective's error carrying a
    transport-death marker: a ``torch.distributed.DistError`` (NCCL, the
    store) or a gloo ``RuntimeError`` (gloo names its own sources in the
    message). The counterpart of the reference's
    ``_is_native_op_failure``: every other exception, a deterministic
    error (a bad dtype, a size mismatch, an unregistered set) above all,
    must surface; looping restore/rendezvous on it would retry forever."""
    msg = str(e)
    if isinstance(e, dist.DistError):
        pass
    elif not (isinstance(e, RuntimeError) and "gloo" in msg):
        return False
    return any(m in msg for m in _TRANSPORT_DEATH)


def _retry_reset(reset):
    """Run `reset()` (teardown → new assignment → init), retrying when the
    rendezvous itself fails. Membership can change AGAIN while a reset is
    in flight — e.g. a just-spawned replacement is excluded because
    discovery shrank, so the epoch this worker is re-initializing for
    never completes registration. That is a normal elastic transition,
    not a worker bug: ask the driver for the newer assignment and try
    again instead of crashing a healthy worker."""
    # max(1, ·): zero/negative would skip reset() entirely and hand the
    # caller no world.
    attempts = max(1, int(os.environ.get("HVD_ELASTIC_RESET_ATTEMPTS",
                                         "3")))
    for attempt in range(attempts):
        try:
            return reset()
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception as e:  # noqa: BLE001 — any rendezvous failure
            if attempt + 1 >= attempts:
                raise
            if _metrics.enabled():
                _metrics.ELASTIC_EVENTS.labels(event="reset_retry").inc()
            print(f"[hvd elastic] reset attempt {attempt + 1} failed "
                  f"({e}); re-entering rendezvous", flush=True)


def run_fn(func, reset):
    """Build the elastic retry wrapper around `func(state, ...)`.

    `reset()` performs re-rendezvous (teardown → new assignment → init).
    """
    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from .runner.elastic import worker as _worker

        _worker.notification_manager.init()
        _worker.notification_manager.register_listener(state)

        reset_required = False
        try:
            while True:
                if reset_required:
                    state.prepare_reset()
                    if _metrics.enabled():
                        t0 = time.perf_counter()
                        with _spans.span("elastic.reset", cat="elastic"):
                            _retry_reset(reset)
                        _metrics.ELASTIC_EVENTS.labels(
                            event="reset").inc()
                        _metrics.ELASTIC_RESET_SECONDS.observe(
                            time.perf_counter() - t0)
                    else:
                        _retry_reset(reset)
                    # The old world's ops, aborted in flight, never
                    # report done; a verdict taken while the reset ran
                    # (its NCCL aborts take seconds) is the old world's.
                    _stall.inspector.reset()
                    state.on_reset()
                    reset_required = False
                state.sync()
                try:
                    return func(state, *args, **kwargs)
                except HorovodInternalError as e:
                    _note_eviction(e)
                    if _metrics.enabled():
                        _metrics.ELASTIC_EVENTS.labels(
                            event="failure").inc()
                    state.restore()
                    reset_required = True
                except HostsUpdatedInterrupt:
                    if _metrics.enabled():
                        _metrics.ELASTIC_EVENTS.labels(
                            event="host_update").inc()
                    reset_required = True
                except RuntimeError as e:
                    # A collective outside torch_ops._run (which raises
                    # HorovodInternalError itself) that failed because a
                    # peer died; anything else surfaces.
                    if not _is_transport_failure(e):
                        raise
                    if _metrics.enabled():
                        _metrics.ELASTIC_EVENTS.labels(
                            event="failure").inc()
                    state.restore()
                    reset_required = True
        finally:
            _worker.notification_manager.remove_listener(state)

    return wrapper


def run(func):
    """`@hvd.elastic.run` decorator (reference: horovod/tensorflow/elastic
    `run` / common run_fn)."""
    from .runner.elastic import worker as _worker

    return run_fn(func, _worker.rendezvous_reset)
