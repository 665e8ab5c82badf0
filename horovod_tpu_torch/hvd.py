"""The Horovod API of the port: the counterpart of
``horovod_tpu/jax/__init__.py`` for torch tensors and optimizers.

Usage, one process per card (launched by ``tpurun``, which exports
``HVD_RANK``, ``HVD_SIZE``, ``HVD_LOCAL_RANK`` and
``HVD_JAX_COORD_ADDR``):

    import horovod_tpu_torch.hvd as hvd

    hvd.init()                      # NCCL on card HVD_LOCAL_RANK
    hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(leaves, lr=1e-4))
    loss = loss_fn(params, batch)
    loss.backward()
    opt.step()                      # one grouped allreduce, then AdamW
    opt.zero_grad()

``hvd.init(device="cpu")`` runs the same over gloo on the CPU. The ops
take ``process_set=`` (default: every rank); for the compiled-step
analog see :func:`horovod_tpu_torch.parallel.make_train_step`. Under
``HVD_PROFILER=1`` or :func:`horovod_tpu_torch.profiler.start` every op,
and each ``DistributedOptimizer`` reduction, is a profiler range named
``hvd.<op>``; under ``HVD_METRICS=1`` each is counted in the metrics
registry (calls, bytes, latency by op and process set) and watched by
the stall inspector, and ``HVD_METRICS_PORT`` makes ``hvd.init()`` serve
them at ``/metrics`` (:mod:`horovod_tpu_torch.observability`).
"""

import torch

from .compression import Compression  # noqa: F401
from .distributed import (  # noqa: F401
    cross_rank,
    cross_size,
    ep_report,
    ep_stats,
    global_mesh,
    init,
    is_initialized,
    is_multiprocess,
    local_rank,
    local_size,
    process_allgather,
    rank,
    shard_local_batch,
    shutdown,
    size,
)
from . import profiler as _profiler
from .observability import metrics as _metrics
from .exceptions import HorovodInternalError, HostsUpdatedInterrupt  # noqa: F401
from .ops import torch_ops as _ops
from .ops.torch_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather_object,
    barrier,
    broadcast_object,
    hvd_allgather as allgather,
    hvd_allreduce as allreduce,
    hvd_allreduce_pytree as allreduce_pytree,
    hvd_alltoall as alltoall,
    hvd_broadcast as broadcast,
    hvd_broadcast_pytree as broadcast_pytree,
    hvd_reducescatter as reducescatter,
    metric_average,
)
from .process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    global_process_set,
    remove_process_set,
)
from .parallel.mesh import cut_axes
from .tree import tree_leaves
from . import elastic  # noqa: F401,E402  (hvd.elastic.run, TorchState)


def _refuse_cut(tensors, what):
    """Raise for a tensor cut over mesh axes (``shard_params`` marks
    it): it holds other values on other ranks, which a process set's
    allreduce or broadcast would mix."""
    for t in tensors:
        if torch.is_tensor(t) and cut_axes(t):
            raise ValueError(
                f"{what} got a leaf cut over mesh axes {cut_axes(t)}: "
                f"train a sharded tree with parallel.make_train_step and "
                f"parallel.replicate over its Mesh")


def broadcast_parameters(params, root_rank=0, process_set=global_process_set):
    """Give every member world rank ``root_rank``'s values, in place, so an
    optimizer built over the tensors keeps them; returns ``params``. Takes
    a tree of tensors (the port's params, a ``state_dict()``) or an
    iterable of them or of ``(name, tensor)`` pairs
    (``named_parameters()``). A tensor on another device than the set's
    (AdamW's ``step`` on the CPU under NCCL) crosses on the set's device.
    A leaf cut over mesh axes (``shard_params``) raises."""
    if not isinstance(params, (dict, list, tuple)):
        params = list(params)
    _refuse_cut(tree_leaves(params), "broadcast_parameters")
    _ops._group(process_set)
    device = process_set.world.device
    for leaf in tree_leaves(params):
        if torch.is_tensor(leaf):
            t = leaf.detach()
            t.copy_(_ops.hvd_broadcast(t.to(device), root_rank,
                                       process_set=process_set))
    return params


def checkpoint_stats():
    """This process's checkpoint counters (``checkpoint.py``): saves,
    commits and aborted commits; bytes written and read and the shard
    files fetched; the last snapshot stall and write time in ms (the
    async save's overlap); the last committed step."""
    from . import checkpoint as _checkpoint

    return _checkpoint.checkpoint_stats()


class _DistributedOptimizer:
    """See :func:`DistributedOptimizer`. Every attribute it does not define
    (``zero_grad``, ``param_groups``, ``state``, ``state_dict``, ...) is
    the wrapped optimizer's."""

    def __init__(self, optimizer, op, compression, process_set,
                 backward_passes_per_step):
        if backward_passes_per_step < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.optimizer = optimizer
        self.op, self.process_set = op, process_set
        self.compression = compression
        self.backward_passes_per_step = int(backward_passes_per_step)
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        _refuse_cut(self._params, "DistributedOptimizer")
        self._cuda = bool(self._params) and self._params[0].is_cuda
        # Decided and counted once, as make_train_step does.
        self._wire = _ops._wire_route(compression)
        self._acc, self._count = None, 0

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def step(self):
        """Replace every parameter's ``.grad`` by its reduction over the
        set (zeros for a parameter without one), then step the wrapped
        optimizer. With ``backward_passes_per_step=N``, N-1 of N calls add
        the gradients into the wrapper's own sum and leave the parameters
        as they are; the N-th reduces sum/N and steps."""
        grads = [p.grad.detach() if p.grad is not None
                 else torch.zeros_like(p) for p in self._params]
        n = self.backward_passes_per_step
        if n > 1:
            if self._acc is None:
                self._acc = [g.clone() for g in grads]
            else:
                for a, g in zip(self._acc, grads):
                    a.add_(g)
            self._count += 1
            if self._count < n:
                return None
            grads = [a.div_(n) for a in self._acc]
            self._acc, self._count = None, 0
        def reduce():
            return _ops._reduce_leaves(grads, self.op,
                                       _ops._group(self.process_set),
                                       self.compression, self._wire)

        # The reduction is a Horovod op: ranged, and with metrics on
        # counted per leaf and watched, as ops/torch_ops.py's wrapper does.
        if _metrics.enabled():
            reduced = _ops.instrumented_call(
                "allreduce", "hvd.grouped_allreduce", None, self.process_set,
                [g.nbytes for g in grads], self._cuda, reduce)
        else:
            with _profiler.op_range("hvd.grouped_allreduce", self._cuda):
                reduced = reduce()
        for p, g in zip(self._params, reduced):
            p.grad = g
        return self.optimizer.step()


def DistributedOptimizer(optimizer, op=Average, compression=None,
                         process_set=global_process_set,
                         backward_passes_per_step=1):
    """Wrap a ``torch.optim.Optimizer`` so that ``step()`` first replaces
    every parameter's gradient by one grouped allreduce over
    ``process_set`` (dtype-pure buckets), then steps it
    (``jax/__init__.py:86-156``).

    ``compression=Compression.fp16`` or ``bf16`` sends each float bucket
    in that dtype and casts it back, counted once in
    ``compression.stats()``. ``backward_passes_per_step=N`` accumulates N
    backward passes locally, in the wrapper (a ``zero_grad()`` between
    them drops nothing), and reduces and steps on every N-th call. A
    parameter cut over mesh axes (``shard_params``) raises."""
    return _DistributedOptimizer(optimizer, op, compression, process_set,
                                 backward_passes_per_step)


def broadcast_optimizer_state(optimizer, root_rank=0,
                              process_set=global_process_set):
    """Give every member world rank ``root_rank``'s optimizer state
    (``jax/__init__.py:159``): the root's ``state_dict()`` (its layout by
    object, its tensors over the set's group) is loaded on the others."""
    if isinstance(optimizer, _DistributedOptimizer):
        optimizer = optimizer.optimizer
    device = process_set.world.device
    state = optimizer.state_dict()
    tensors = [t for t in tree_leaves(state) if torch.is_tensor(t)]
    # Where each tensor lives on the root (AdamW keeps "step" on the
    # CPU), and the layout; the values cross on the set's device.
    layout = _ops.broadcast_object(
        (_strip(state), [(t.shape, t.dtype, t.device.type == "cpu")
                         for t in tensors]),
        root_rank, process_set=process_set)
    skeleton, specs = layout
    is_root = process_set.world.rank == root_rank
    got = []
    for i, (shape, dtype, on_cpu) in enumerate(specs):
        t = tensors[i].to(device) if is_root else torch.empty(
            shape, dtype=dtype, device=device)
        t = _ops.hvd_broadcast(t, root_rank, process_set=process_set)
        got.append(t.cpu() if on_cpu else t)
    if not is_root:
        optimizer.load_state_dict(_fill(skeleton, iter(got)))


class _Slot:
    """A tensor's place in the layout of a ``state_dict()``."""


def _strip(tree):
    """``tree`` with every tensor replaced by a :class:`_Slot`."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip(v) for v in tree)
    return _Slot() if torch.is_tensor(tree) else tree


def _fill(skeleton, tensors):
    """``skeleton`` with its slots, in ``tree_leaves`` order, taken by
    ``tensors``."""
    if isinstance(skeleton, dict):
        filled = {k: _fill(skeleton[k], tensors) for k in sorted(skeleton)}
        return {k: filled[k] for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, tensors) for v in skeleton)
    return next(tensors) if isinstance(skeleton, _Slot) else skeleton
