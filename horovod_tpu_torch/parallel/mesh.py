"""Named axes over the ranks of a job: the port of
``horovod_tpu/parallel/mesh.py``.

The reference's ``Mesh`` names axes over a grid of devices, and its
collectives run along one axis inside ``shard_map``. Here each rank is
one process (or, in the tests, one thread) with one device, and an axis
is a set of ``torch.distributed`` process groups: rank r's group along
axis a holds the ranks whose coordinates differ from r's only in a. Rank
r has the coordinates of device r in the reference's
``np.asarray(devices).reshape(sizes)`` (``mesh.py:39``).

Every group is built from the job's store, one ``PrefixStore`` per
group (:func:`new_group`), and never from the process-global default
group, so several worlds can live in one process.
"""

import datetime
import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist


def coord_timeout():
    """Seconds a rank waits for its peers: ``HVD_JAX_COORD_TIMEOUT``
    (default 120), the timeout ``distributed.init`` gives its store."""
    return int(os.environ.get("HVD_JAX_COORD_TIMEOUT", "120"))


def new_group(store, prefix, rank, size, device, timeout=None):
    """A process group of ``size`` ranks that meet in ``store`` under
    ``prefix``: NCCL for a CUDA device, gloo for the CPU. Each member
    calls it with the same prefix and its own rank in the group. Every
    wait of the group (its connect and each collective) fails after
    ``timeout`` seconds (default :func:`coord_timeout`), where the
    backends' own default is 30 minutes: a rank whose peer died raises."""
    store = dist.PrefixStore(prefix, store)
    wait = datetime.timedelta(
        seconds=coord_timeout() if timeout is None else timeout)
    kind = torch.device(device).type
    if kind == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = wait
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    if kind == "cpu":
        return dist.ProcessGroupGloo(store, rank, size, wait)
    raise ValueError(f"no process group backend for device {device!r}")


class World:
    """The ranks of one job as this rank sees them: the store they share,
    this rank, their number, this rank's device, and ``group``, the
    process group of all of them. Every other group of the job is made by
    :meth:`subgroup`. ``timeout``: seconds any group of the world waits
    for its peers (:func:`new_group`). What is built on the world (a
    :class:`Mesh`, a registered process set) is bound to it and unbound
    by :meth:`close`."""

    def __init__(self, store, rank, size, device, timeout=None):
        self.store = store
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.timeout = coord_timeout() if timeout is None else timeout
        self._ids = itertools.count()
        self._groups = []
        self._nccl = []          # NCCL groups not yet released
        self._bound = []         # what close() unbinds
        self._set_ids = itertools.count(1)   # 0 is the global set's
        self.group = self.subgroup(range(self.size))

    def subgroup(self, ranks):
        """The group of ``ranks`` (ranks of the world; the list's order
        gives each member its rank in the group), or None on a rank that
        is not one of them. A collective: every rank of the world calls
        it, with the same ranks, in the same order among its calls."""
        ranks = [int(r) for r in ranks]
        prefix = f"hvd/{next(self._ids)}"
        if self.rank not in ranks:
            return None
        group = new_group(self.store, prefix, ranks.index(self.rank),
                          len(ranks), self.device, self.timeout)
        self._groups.append(group)
        if group.name() == "nccl":
            self._nccl.append(group)
        return group

    @property
    def live_nccl_groups(self):
        """How many of the world's NCCL groups are not yet shut down or
        aborted."""
        return len(self._nccl)

    def next_set_id(self):
        """The id of the next process set registered on this world, as
        the core numbers them: 1, 2, ... in registration order, which is
        the same on every rank."""
        return next(self._set_ids)

    def bind(self, obj):
        """Have :meth:`close` call ``obj.unbind()``."""
        self._bound.append(obj)

    def _release(self, how):
        for group in self._nccl:
            getattr(group, how)()
        self._nccl = []

    def abort(self):
        """Abort every NCCL group of the world (``ncclCommAbort``): a
        collective issued on one afterwards fails, and none can hang on a
        dead peer. The groups stay in place until :meth:`close`."""
        self._release("abort")

    def close(self, abort=False):
        """Release the NCCL groups' resources: shut them down, as
        ``destroy_process_group`` does, or with ``abort`` abort them (an
        elastic reset: a graceful shutdown can wait on a collective whose
        peer is dead); gloo groups need neither. Then drop every group and
        unbind what was built on the world."""
        self._release("abort" if abort else "shutdown")
        self._groups = []
        for obj in self._bound:
            obj.unbind()
        self._bound = []


class Mesh:
    """Named axes over a :class:`World`'s ranks (see the module's
    docstring). Built by :func:`create_mesh`."""

    def __init__(self, world, axis_sizes):
        self.world = world
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        self._grid = np.arange(world.size).reshape(tuple(self.shape.values()))
        self._groups = {}
        self._closed = False
        for axis in self.axis_names:
            self._build((axis,))
        world.bind(self)

    def unbind(self):
        """Drop the mesh's groups (its world was closed); a later call
        for one raises."""
        self._groups, self._closed = {}, True

    @property
    def rank(self):
        return self.world.rank

    @property
    def device(self):
        return self.world.device

    def coords(self, rank=None):
        """Rank ``rank``'s (default: this rank's) index along each axis."""
        rank = self.rank if rank is None else rank
        return tuple(int(i) for i in np.unravel_index(rank, self._grid.shape))

    def _slices(self, axes):
        """[the world ranks of each group along ``axes``], a group's ranks
        in row-major order over ``axes`` as given."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        grid = self._grid.transpose(rest + idx)
        return grid.reshape(-1, math.prod(self.shape[a] for a in axes))

    def members(self, axes, rank=None):
        """The world ranks of rank ``rank``'s group along ``axes`` (a name
        or a tuple of names), in the order of their ranks in it."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        rank = self.rank if rank is None else rank
        for row in self._slices(axes):
            if rank in row:
                return [int(r) for r in row]

    def _build(self, axes):
        if self._closed:
            raise ValueError("this mesh's world was closed (an elastic "
                             "reset); build a new mesh on the new world")
        for row in self._slices(axes):
            group = self.world.subgroup(row)
            if group is not None:
                self._groups[axes] = group

    def group(self, axis):
        """This rank's process group along ``axis``."""
        return self.groups((axis,))

    def groups(self, axes):
        """This rank's process group over the ranks that differ from it
        only along ``axes`` (a tuple of names; a group's rank is the
        row-major index over them). A group of more than one axis is
        built at its first call, which is then a collective: every rank
        of the world makes it, in the same order among its group calls."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            self._build(axes)
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def create_mesh(axis_sizes=None, world=None):
    """Build a :class:`Mesh` from ``{axis_name: size}`` over ``world``
    (default: the world of ``distributed.init``). One axis may be -1
    (inferred). A collective: every rank of the world calls it.

    Defaults to a single 'data' axis over all ranks, the pure-DP layout.
    """
    if world is None:
        from .. import distributed

        world = distributed.world()
    n = world.size
    if not axis_sizes:
        axis_sizes = {"data": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("at most one axis size may be -1")
    if n_infer == 1:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes = [n // known if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {n}")
    return Mesh(world, dict(zip(names, sizes)))


def mesh_axis_size(mesh, axis):
    return mesh.shape[axis]


class PaddedAxis(str):
    """A spec entry for a dim cut over mesh axis ``self`` after zero
    padding to a multiple of the axis size (``convert.shard_params``
    pads the embedding's vocabulary rows so; ROADMAP Queue C, C4). It
    compares and hashes as the axis name, so every reader of a spec
    takes it as that axis; ``size`` is the dim's true, unpadded length
    over the whole mesh, which the checkpoint and ``gather_params``
    read so that no pad row is written or handed out."""

    def __new__(cls, axis, size):
        obj = super().__new__(cls, axis)
        obj.size = int(size)
        return obj

    def __reduce__(self):       # copy and pickle keep ``size``
        return (PaddedAxis, (str(self), self.size))


def set_leaf_spec(x, spec):
    """Record on a param leaf the mesh axis each of its dims is cut over
    (``None``: kept whole), as ``models/convert.py::shard_params`` cuts
    it; returns ``x``. The train step and ``replicate`` read it back
    (:func:`leaf_spec`), so the spec is written in one place."""
    x.mesh_spec = tuple(spec)
    return x


def leaf_spec(x):
    """The spec :func:`set_leaf_spec` recorded on ``x``; ``()`` (whole on
    every rank) for a leaf it did not mark."""
    return getattr(x, "mesh_spec", ())


def is_marked(x):
    """Whether :func:`set_leaf_spec` recorded a spec on ``x``, one that
    cuts nothing included."""
    return hasattr(x, "mesh_spec")


def cut_axes(x):
    """The mesh axes a leaf is cut over: it holds other values on each
    rank of them."""
    return [a for a in leaf_spec(x) if a is not None]
