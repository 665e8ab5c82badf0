"""Exceptions shared across the port: a copy of ``horovod_tpu/exceptions.py``
(which the port does not import).

Counterpart of the reference's ``horovod/common/exceptions.py``:
``HorovodInternalError`` signals that a collective failed mid-flight (a peer
died, the control/data plane broke) — the elastic retry loop catches it and
rolls back to the last committed state. ``HostsUpdatedInterrupt`` signals a
membership change discovered by the driver — state is synced, not rolled back.
"""


class HorovodInternalError(RuntimeError):
    """Collective failed: a peer died or the communication plane broke.

    The port's collectives (``ops/torch_ops.py``) raise it in place of the
    error a process group gives for a failed collective
    (``torch.distributed.DistBackendError``, or gloo's ``RuntimeError``
    from a collective in flight)."""


class RankEvictedError(HorovodInternalError):
    """A rank was evicted from the job (wedged, partitioned, or dead peer).

    Subclasses :class:`HorovodInternalError` so the elastic retry loop
    treats it as the same retriable signal; ``rank`` carries the evicted
    rank when the core could name it (-1 otherwise) so the worker can push
    the eviction to the driver for targeted kill + spare promotion.
    """

    def __init__(self, message, rank=-1):
        super().__init__(message)
        self.rank = rank


class HostsUpdatedInterrupt(RuntimeError):
    """Host membership changed (elastic); re-initialize and continue.

    ``skip_sync`` mirrors the reference: when True the worker may continue
    without a state sync (the update did not invalidate its state).
    """

    def __init__(self, skip_sync=False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """Native library and Python package versions disagree."""


class CheckpointError(RuntimeError):
    """A checkpoint could not be committed or restored intact.

    Raised by the checkpoint format (``horovod_tpu/checkpoint.py``) whenever the sharded format's
    invariants fail — a torn ``MANIFEST.json``, a missing rank directory
    or shard file, a checksum mismatch, or shard coverage that does not
    tile a tensor's global shape. The message always names the offending
    tensor/shard: a partial restore must be loud, never silently wrong.
    """
