"""The job's ranks and their process groups: the port of
``horovod_tpu/jax/distributed.py``.

In the reference, each process launched by ``tpurun`` joins the
``jax.distributed`` coordination service at ``HVD_JAX_COORD_ADDR``
(rank 0 hosts it), and collectives then run over a global device mesh;
its docstring names NCCL communicators as the analog
(``distributed.py:3-7``). Here :func:`init` reads the same environment,
meets the other ranks in a ``TCPStore`` that rank 0 hosts at that
address, and builds the world's process group on it: NCCL with the
card, gloo on the CPU when the caller asks for it. Every other group
(mesh axes, process sets) is made from the same store
(:class:`~.parallel.mesh.World`).

Elastic jobs (``HVD_ELASTIC=1``, workers the elastic driver spawned):
:func:`init` goes through ``runner.elastic.worker.rendezvous_init``,
which applies the driver's epoch assignment to the environment and then
builds the world (:func:`init_world`). The driver hosts each epoch's
``TCPStore`` and every rank, rank 0 too, joins it as a client
(``HVD_JAX_COORD_MODE=client``, the reference's client mode), so a
rank's death does not take the meeting point with it. A reset calls
:func:`teardown`, which aborts the world's NCCL groups, and builds a new
world for the next epoch on the device :func:`init` was given.
"""

import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .ops import torch_ops
from .parallel.mesh import World, create_mesh
from .process_sets import global_process_set
from .tree import tree_leaves, tree_map


class _EpGauges:
    """The expert-dispatch counters of the C++ core's gauge plane
    (``horovod_tpu/csrc/core.cc`` ``hvd_ep_report``/``hvd_ep_stats``),
    in this process: dispatches reported, tokens, dropped tokens, and the
    last dropped fraction, kept in units of 1e-6 as the core keeps it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reports = self._tokens = self._dropped = self._last_micro = 0

    def report(self, dropped_fraction, tokens, dropped_tokens):
        tokens, dropped_tokens = int(tokens), int(dropped_tokens)
        if tokens < 0 or dropped_tokens < 0 or dropped_tokens > tokens:
            raise ValueError(f"invalid ep report: tokens={tokens!r} "
                             f"dropped={dropped_tokens!r}")
        micro = float(dropped_fraction) * 1e6
        # llround: half away from zero
        micro = int(abs(micro) + 0.5) * (1 if micro >= 0 else -1)
        with self._lock:
            self._reports += 1
            self._tokens += tokens
            self._dropped += dropped_tokens
            self._last_micro = micro
        return 0

    def stats(self):
        with self._lock:
            return (self._reports, self._tokens, self._dropped,
                    self._last_micro / 1e6)


class _Job:
    def __init__(self, world, local_rank, local_size, cross_rank,
                 cross_size):
        self.world = world
        self.local_rank, self.local_size = local_rank, local_size
        self.cross_rank, self.cross_size = cross_rank, cross_size
        self.ep = _EpGauges()


_job = None
# The device init() was given: a reset builds the next world on it.
_device = None


def _env(name, default):
    return int(os.environ.get(name, default))


def init(device=None):
    """Join the job. Reads ``HVD_RANK``, ``HVD_SIZE``, ``HVD_LOCAL_RANK``,
    ``HVD_LOCAL_SIZE``, ``HVD_CROSS_RANK``, ``HVD_CROSS_SIZE`` (with the
    C++ core's defaults: rank 0 of 1, local = global, cross 0 of 1) and
    ``HVD_JAX_COORD_ADDR``, the ``host:port`` of the ``TCPStore`` that
    rank 0 hosts (or, under ``HVD_JAX_COORD_MODE=client``, that the
    elastic driver hosts); a job of one rank without an address meets in
    a ``HashStore``. ``HVD_JAX_COORD_TIMEOUT`` (seconds, default 120)
    bounds every wait: the store's and each process group's. Under
    ``HVD_ELASTIC=1`` the ranks come from the elastic driver's epoch
    (``runner.elastic.worker.rendezvous_init``).

    ``device=None`` means the CUDA card ``HVD_LOCAL_RANK`` (made current)
    and NCCL; it raises where there is no card. ``device="cpu"`` means
    gloo. The device is remembered: an elastic reset builds the next
    world on it. Idempotent."""
    global _device
    if _job is not None:
        return
    resolve_device(device)       # no card: raise before any rendezvous
    _device = device
    from .runner.elastic import worker

    if worker.is_elastic():
        worker.rendezvous_init()
    else:
        init_world()


def init_world():
    """Build this process's world from the environment, on the device
    :func:`init` was given (see there)."""
    global _job
    device = resolve_device(_device)
    rank, size = _env("HVD_RANK", 0), _env("HVD_SIZE", 1)
    local_rank = _env("HVD_LOCAL_RANK", rank)
    local_size = _env("HVD_LOCAL_SIZE", size)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    timeout = _env("HVD_JAX_COORD_TIMEOUT", 120)
    addr = os.environ.get("HVD_JAX_COORD_ADDR")
    if addr:
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"HVD_JAX_COORD_ADDR={addr!r} is not host:port (a "
                f"multi-host launch that negotiates its addresses is not "
                f"ported yet)")
        wait = datetime.timedelta(seconds=timeout)
        if os.environ.get("HVD_JAX_COORD_MODE") == "client":
            store = dist.TCPStore(host, int(port), None, False, timeout=wait)
        else:
            store = dist.TCPStore(host, int(port), size, rank == 0,
                                  timeout=wait)
    elif size == 1:
        store = dist.HashStore()
    else:
        raise ValueError(
            f"HVD_SIZE={size} needs HVD_JAX_COORD_ADDR, the host:port of "
            f"the store that rank 0 hosts")
    world = World(store, rank, size, device, timeout)
    global_process_set.bind(world)
    _job = _Job(world, local_rank, local_size, _env("HVD_CROSS_RANK", 0),
                _env("HVD_CROSS_SIZE", 1))


def shutdown():
    """Leave the job; symmetric with :func:`init`."""
    _leave(abort=False)


def teardown():
    """The reset's half of the NCCL-communicator rebuild (the counterpart
    of ``jax/distributed.py:182``): abort the world's NCCL groups, where
    :func:`shutdown` shuts them down gracefully and can wait on a
    collective whose peer is dead; drop every subgroup, every ``Mesh``
    and every process-set binding built on the world. The next
    :func:`init_world` builds a new world. No-op before :func:`init`."""
    _leave(abort=True)


def _leave(abort):
    global _job
    if _job is None:
        return
    global_process_set.unbind()
    _job.world.close(abort=abort)
    _job = None


def _check():
    if _job is None:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "call hvd.init()")
    return _job


def is_initialized():
    return _job is not None


def ep_report(dropped_fraction, tokens, dropped_tokens):
    """Publish one expert-dispatch capacity report (``basics.py:692``):
    the tokens the router saw, the tokens the capacity clamp dropped, and
    the dropped fraction; returns 0. Raises ``ValueError`` before
    :func:`init` and for a report with a negative count or more dropped
    than seen."""
    return _check().ep.report(dropped_fraction, tokens, dropped_tokens)


def ep_stats():
    """``(reports, tokens, dropped_tokens, last_dropped_fraction)`` of
    this job's :func:`ep_report` calls (``basics.py:707``); raises
    ``ValueError`` before :func:`init`."""
    return _check().ep.stats()


def world():
    """The :class:`~.parallel.mesh.World` of :func:`init`."""
    return _check().world


def rank():
    return _check().world.rank


def size():
    return _check().world.size


def local_rank():
    return _check().local_rank


def local_size():
    return _check().local_size


def cross_rank():
    return _check().cross_rank


def cross_size():
    return _check().cross_size


def is_multiprocess():
    """True when this process is one of several ranks of a job."""
    return _job is not None and _job.world.size > 1


def global_mesh(axis_sizes=None):
    """A :class:`~.parallel.mesh.Mesh` over every rank of the job
    (``distributed.py:268``); ``None`` is one ``data`` axis."""
    return create_mesh(axis_sizes, world=world())


def shard_local_batch(batch, mesh, data_axis="data"):
    """Each rank's own rows of the global batch (``distributed.py:283``):
    every rank feeds only its shard, as each Horovod rank reads its own
    part of the dataset, so the rows stay where they are. Checks that the
    leaves agree on dim0 and that every rank along ``data_axis`` holds as
    many rows, as the reference's global array requires; returns the
    batch on the mesh's device."""
    dims = {leaf.shape[0] for leaf in tree_leaves(batch)}
    if len(dims) != 1:
        raise ValueError(f"batch leaves disagree on dim0: {sorted(dims)}")
    dim0 = torch.tensor([dims.pop()], device=mesh.device)
    for axis in (data_axis,) if isinstance(data_axis, str) else data_axis:
        got = torch_ops.allgather(dim0, mesh.group(axis)).tolist()
        if len(set(got)) != 1:
            raise ValueError(f"ranks along {axis!r} hold {got} rows; each "
                             f"must hold as many")
    return tree_map(lambda x: x.to(mesh.device), batch)


def process_allgather(x):
    """Gather a per-process host value to every process, stacked on a new
    dim0 (``distributed.py:299``; the reference's
    ``multihost_utils.process_allgather``)."""
    t = torch.as_tensor(np.asarray(x)).to(world().device)
    out = torch_ops.hvd_allgather(t[None], process_set=global_process_set)
    return out.cpu().numpy()
