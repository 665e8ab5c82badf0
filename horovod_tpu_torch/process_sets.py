"""Process sets: collectives over subsets of ranks. The port of
``horovod_tpu/process_sets.py``.

A :class:`ProcessSet` names a subset of the world's ranks and holds the
process group its members share; every Horovod op of the port
(``ops/torch_ops.py``) takes ``process_set=`` and runs over that group
alone. Registration is itself a collective: every rank of the world
calls :func:`add_process_set` with the same ranks. A set's
``process_set_id`` is the core's: 0 for the global set, then 1, 2, ...
in the order the world registers sets, None when not registered (the
metrics label each op with it).
"""


class ProcessSet:
    def __init__(self, ranks):
        self.ranks = sorted(int(r) for r in ranks)
        self.world = None   # set when registered
        self.group = None   # this rank's group; None off the set
        self.process_set_id = None

    @classmethod
    def from_world(cls, world):
        """The set of all of ``world``'s ranks over ``world.group``. Ranks
        that share a process (threads, as in the tests) each hand their
        ops their own."""
        ps = cls(range(world.size))
        ps.world, ps.group = world, world.group
        ps.process_set_id = 0
        return ps

    def included(self):
        return self.world is not None and self.world.rank in self.ranks

    def rank(self):
        """This process's rank within the set, or -1 if not a member."""
        if self.world is None:
            raise ValueError("process set has not been registered")
        return self.ranks.index(self.world.rank) if self.included() else -1

    def size(self):
        return len(self.ranks)

    def unbind(self):
        """Forget the world and group (the world was closed); the set's
        ops raise after this."""
        self.world, self.group = None, None

    def __repr__(self):
        return f"ProcessSet(ranks={self.ranks})"


class _GlobalProcessSet(ProcessSet):
    """All ranks of the world of ``distributed.init``, bound there."""

    def __init__(self):
        super().__init__([])
        self.process_set_id = 0

    def bind(self, world):
        self.ranks = list(range(world.size))
        self.world, self.group = world, world.group

    def unbind(self):
        super().unbind()
        self.ranks = []


global_process_set = _GlobalProcessSet()


def add_process_set(process_set_or_ranks, world=None):
    """Collectively register a process set over ``world`` (default: the
    world of ``distributed.init``); every rank of the world calls this
    with the same ranks in the same order relative to other
    registrations."""
    if world is None:
        from . import distributed

        world = distributed.world()
    if isinstance(process_set_or_ranks, ProcessSet):
        ps = process_set_or_ranks
    else:
        ps = ProcessSet(process_set_or_ranks)
    if ps.world is not None:
        raise ValueError(f"{ps} is already registered")
    if not ps.ranks or not all(0 <= r < world.size for r in ps.ranks):
        raise ValueError(f"{ps} does not name ranks of a world of "
                         f"{world.size}")
    ps.group = world.subgroup(ps.ranks)
    ps.world = world
    ps.process_set_id = world.next_set_id()
    world.bind(ps)
    return ps


def remove_process_set(process_set):
    """Deregister a process set; its ops raise after this."""
    if isinstance(process_set, _GlobalProcessSet):
        raise ValueError("cannot remove the global process set")
    if process_set.world is None:
        raise ValueError("process set has not been registered")
    process_set.unbind()
    process_set.process_set_id = None
