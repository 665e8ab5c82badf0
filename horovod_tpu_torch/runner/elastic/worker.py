"""Worker-side elastic runtime: epoch rendezvous + host-update polling.
The port's copy of ``horovod_tpu/runner/elastic/worker.py``: the same
epoch wait, assignments and reports over the driver's KV store; a
rendezvous (re)builds the port's world (``distributed.py``), not the C++
core.

Reference parity: `horovod/runner/elastic/worker.py`
(`WorkerNotificationManager/Service`) — except the reference pushes
HostsUpdatedInterrupt to an HTTP server inside each worker; here workers
poll the driver's KV store epoch counter (`/ctl/epoch`), which needs no
per-worker server and survives NAT/loopback setups identically.

Env contract (set by the elastic driver at spawn):
- HVD_ELASTIC=1
- HVD_RENDEZVOUS_ADDR=host:port  (driver KV store)
- HVD_WORKER_ID=host/slot-uuid   (stable identity across epochs)
"""

import json
import os
import threading
import time

from .. import http_server

POLL_INTERVAL_S = 0.5


def is_elastic():
    return os.environ.get("HVD_ELASTIC") == "1"


def _rdv_addr():
    return os.environ["HVD_RENDEZVOUS_ADDR"]


def _rdv_secret():
    """Per-job HMAC key (hex in the spawn env); None for legacy/unsigned."""
    s = os.environ.get("HVD_RENDEZVOUS_SECRET")
    return bytes.fromhex(s) if s else None


def _worker_id():
    return os.environ["HVD_WORKER_ID"]


def _liveness_enabled():
    """KV liveness heartbeats ride the same knob as the control-plane
    heartbeat (HVD_PEER_TIMEOUT_MS > 0): off means zero extra traffic."""
    try:
        return int(os.environ.get("HVD_PEER_TIMEOUT_MS", "0")) > 0
    except ValueError:
        return False


def current_epoch():
    try:
        return int(http_server.read_kv(_rdv_addr(), "ctl", "epoch",
                                       secret_key=_rdv_secret()))
    except Exception:
        return -1


def fetch_assignment(epoch, timeout=600.0):
    """Wait for this worker's assignment in `epoch`. Returns dict or the
    string directive "exit"."""
    raw = http_server.read_kv(_rdv_addr(), f"assign-{epoch}", _worker_id(),
                              secret_key=_rdv_secret(), wait=True,
                              timeout=timeout)
    val = raw.decode()
    if val == "exit":
        return "exit"
    return json.loads(val)


def report_eviction(rank, epoch):
    """Tell the driver a named rank was evicted from the control plane
    (RankEvictedError reached this worker). The driver maps the rank back
    to a worker id via its per-epoch rank map, kills the wedged process,
    and records a transient failure — without this push it would wait for
    the liveness backstop to notice. Best-effort: the epoch poll + stale
    liveness remain the fallback."""
    try:
        http_server.put_kv(
            _rdv_addr(), "ctl", f"evict/{_worker_id()}",
            json.dumps({"rank": int(rank), "epoch": int(epoch)}).encode(),
            secret_key=_rdv_secret())
    except Exception:
        pass


def report_ckpt_commit(step):
    """Publish the last durably committed checkpoint step to the driver
    (/ctl/ckpt/<wid>). The set root calls this after every commit
    (checkpoint.py); the driver consumes the keys, tracks the max, and
    republishes it both in /ctl/elastic_stats (→ hvd.elastic_stats()
    ['last_ckpt_step']) and in every subsequent epoch's assignments — so
    a promoted spare resolves its restore step WITHOUT a collective
    (checkpoint.restore coordinate=False + last_committed_step()). Best
    effort like report_eviction: a lost report just means joiners fall
    back to latest_step() on the shared directory."""
    try:
        http_server.put_kv(
            _rdv_addr(), "ctl", f"ckpt/{_worker_id()}",
            str(int(step)).encode(), secret_key=_rdv_secret())
    except Exception:
        pass


def last_committed_step():
    """The newest checkpoint step the driver has confirmed committed, or
    None. Reads the epoch assignment first (HVD_CKPT_STEP, no network),
    then falls back to the driver stats snapshot — for (re)joiners and
    promoted spares picking their manifest-path restore step."""
    v = os.environ.get("HVD_CKPT_STEP")
    if v not in (None, ""):
        try:
            return int(v)
        except ValueError:
            pass
    s = fetch_driver_stats().get("last_ckpt_step", -1)
    return int(s) if int(s) >= 0 else None


_driver_stats_cache = {}
_driver_stats_ts = 0.0
_DRIVER_STATS_TTL_S = 2.0


def fetch_driver_stats():
    """Best-effort snapshot of the driver-side elastic counters
    (promotions, incremental/full epochs, driver evictions, heartbeat
    misses) published at
    `/ctl/elastic_stats`. Cached briefly so hvd.elastic_stats() stays
    cheap enough to sample per step; {} when the driver has published
    nothing (e.g. pre-eviction) or the KV store is unreachable."""
    global _driver_stats_cache, _driver_stats_ts
    now = time.monotonic()
    if now - _driver_stats_ts < _DRIVER_STATS_TTL_S:
        return dict(_driver_stats_cache)
    try:
        raw = http_server.read_kv(_rdv_addr(), "ctl", "elastic_stats",
                                  secret_key=_rdv_secret())
        _driver_stats_cache = {k: int(v)
                               for k, v in json.loads(raw.decode()).items()}
        from ...observability import metrics

        metrics.ELASTIC_PROMOTIONS.set(
            _driver_stats_cache.get("promotions", 0))
        metrics.ELASTIC_HEARTBEAT_MISSES.set(
            _driver_stats_cache.get("heartbeat_misses", 0))
    except Exception:
        _driver_stats_cache = dict(_driver_stats_cache)
    _driver_stats_ts = now
    return dict(_driver_stats_cache)


def request_reset(epoch):
    """Push a reset request to the driver (reference:
    WorkerNotificationService): this worker hit an internal error and needs
    a NEW rendezvous epoch even though every process may still be alive.
    The driver marks membership dirty and publishes one promptly instead of
    the worker stalling toward the rendezvous timeout."""
    try:
        http_server.put_kv(_rdv_addr(), "ctl", f"reset/{_worker_id()}",
                           str(epoch).encode(), secret_key=_rdv_secret())
    except Exception:
        pass  # best-effort: the epoch poll remains the fallback


def apply_assignment(a):
    os.environ["HVD_RANK"] = str(a["rank"])
    os.environ["HVD_SIZE"] = str(a["size"])
    os.environ["HVD_LOCAL_RANK"] = str(a["local_rank"])
    os.environ["HVD_LOCAL_SIZE"] = str(a["local_size"])
    os.environ["HVD_CROSS_RANK"] = str(a["cross_rank"])
    os.environ["HVD_CROSS_SIZE"] = str(a["cross_size"])
    # Last committed checkpoint step rides every assignment so a promoted
    # spare knows where to restore from before it runs any collective.
    if a.get("ckpt_step") is not None:
        os.environ["HVD_CKPT_STEP"] = str(a["ckpt_step"])
    # The driver hosts a TCPStore per epoch of two or more workers; every
    # rank joins it as a client (distributed.py), so a rank's death never
    # takes the meeting point with it. A single-worker epoch publishes no
    # address (its world meets in a HashStore) — clear any stale one.
    if a.get("jax_coord"):
        os.environ["HVD_JAX_COORD_ADDR"] = a["jax_coord"]
        os.environ["HVD_JAX_COORD_MODE"] = "client"
    else:
        os.environ.pop("HVD_JAX_COORD_ADDR", None)
        os.environ.pop("HVD_JAX_COORD_MODE", None)


def _rendezvous(epoch):
    """Fetch this worker's assignment in ``epoch`` (parking as a spare
    until promoted), apply it and build the epoch's world. Returns the
    epoch joined."""
    from ... import distributed

    a = fetch_assignment(epoch)
    if a == "exit":
        raise SystemExit(0)
    if isinstance(a, dict) and a.get("spare"):
        epoch, a = _park_as_spare(epoch)
    apply_assignment(a)
    notification_manager.set_epoch(epoch)
    distributed.init_world()
    return epoch


def rendezvous_init():
    """First init for an elastic worker: wait for the first epoch that can
    include this worker (HVD_SPAWN_EPOCH, set by the driver at spawn — a
    stale current epoch's assignment table will never contain this id),
    then build the world. Called from ``distributed.init()`` when
    HVD_ELASTIC=1. (The reference's ``_negotiate`` has no counterpart:
    the port has no controller to negotiate an address for, and a
    negotiated store address is ROADMAP Queue A item 16.)"""
    # Start the poll thread before parking: a hot spare heartbeats from it
    # while it waits, long before elastic.run() would have started it.
    notification_manager.init()
    return _rendezvous(
        _wait_epoch_at_least(int(os.environ.get("HVD_SPAWN_EPOCH", 0))))


def rendezvous_reset():
    """Re-rendezvous after a failure/membership change: tear the world
    down (its NCCL groups aborted, not shut down gracefully: a peer may be
    dead mid-collective; reference: ncclCommAbort + communicator rebuild),
    wait for a NEW epoch and build a new world with its assignment, on
    the device ``distributed.init`` was given."""
    from ... import distributed

    distributed.teardown()
    # Tell the driver we need a new epoch NOW: if this reset came from a
    # HorovodInternalError with every process still alive, no death will
    # ever bump the epoch for us. (A membership-change reset already has a
    # newer epoch pending; the driver ignores stale requests.)
    request_reset(notification_manager.epoch)
    return _rendezvous(_wait_epoch_at_least(notification_manager.epoch + 1))


def _wait_epoch_at_least(n, timeout=600.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        e = current_epoch()
        if e >= n:
            return e
        time.sleep(POLL_INTERVAL_S)
    raise TimeoutError(f"no rendezvous epoch >= {n} within {timeout}s")


def _park_as_spare(epoch):
    """Hot-spare parking: this worker is rendezvoused with the driver but
    holds no rank. Keep heartbeating (the notification poll thread does
    that) and wait for a promotion — an epoch whose assignment table gives
    this id a real rank. Parking is unbounded on purpose: a spare's whole
    job is to wait. Returns (epoch, assignment) on promotion; raises
    SystemExit when the driver retires the spare."""
    notification_manager.set_epoch(epoch)
    while True:
        try:
            epoch = _wait_epoch_at_least(epoch + 1)
        except TimeoutError:
            continue  # still parked; keep waiting
        a = fetch_assignment(epoch)
        if a == "exit":
            raise SystemExit(0)
        if isinstance(a, dict) and a.get("spare"):
            notification_manager.set_epoch(epoch)
            continue
        # promotion marker for merged traces
        from ...observability import spans as _spans

        _spans.instant("ELASTIC_PROMOTE", epoch=epoch,
                       rank=a.get("rank", -1) if isinstance(a, dict) else -1)
        return epoch, a


class WorkerNotificationManager:
    """Polls the driver's epoch counter; a bump while training means the
    membership changed → notify registered States so the next commit()
    raises HostsUpdatedInterrupt. ``latest`` is the newest epoch the poll
    has read (-1 before the first read): a wait that should give up when
    the driver moves on (the checkpoint's barriers) compares it with
    ``epoch``, the one this worker is in."""

    def __init__(self):
        self._listeners = []
        self._lock = threading.Lock()
        self._thread = None
        self.epoch = -1
        self.latest = -1

    def newer_epoch(self):
        """Whether the driver has published an epoch past this worker's."""
        return self.epoch >= 0 and self.latest > self.epoch

    def init(self):
        if not is_elastic() or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def set_epoch(self, e):
        self.epoch = e

    def register_listener(self, state):
        with self._lock:
            self._listeners.append(state)

    def remove_listener(self, state):
        with self._lock:
            if state in self._listeners:
                self._listeners.remove(state)

    def _poll(self):
        liveness_on = _liveness_enabled()
        seq = 0
        while True:
            time.sleep(POLL_INTERVAL_S)
            if liveness_on:
                # Driver-side wedge backstop: PUT a monotonically
                # increasing sequence number; the driver tracks *when the
                # value last changed* on its own clock (no cross-host
                # clock comparison). A SIGSTOP'd worker stops bumping it
                # even when the core's control plane is mid-collective and
                # the coordinator cannot observe the wedge.
                seq += 1
                try:
                    http_server.put_kv(
                        _rdv_addr(), "ctl", f"alive/{_worker_id()}",
                        str(seq).encode(), secret_key=_rdv_secret())
                except Exception:
                    pass
            e = current_epoch()
            self.latest = max(self.latest, e)
            if self.epoch >= 0 and e > self.epoch:
                with self._lock:
                    listeners = list(self._listeners)
                for s in listeners:
                    s.on_hosts_updated()


notification_manager = WorkerNotificationManager()
