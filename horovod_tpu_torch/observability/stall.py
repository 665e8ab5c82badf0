"""Python-side stall / straggler inspector: the port of
``horovod_tpu/observability/stall.py``.

A table of per-op last-progress timestamps and a background watcher that
flags ops stalled past a warning threshold and, past a shutdown
threshold, records a :class:`StallError` that the next Horovod op
raises on its caller's thread. ``ops/torch_ops.py`` reports every
Horovod op's start and end into the process-wide :data:`inspector`
whenever metrics are enabled (``HVD_METRICS=1``, so the disabled hot
path pays nothing). The port's ops block, so an op is in the table for
as long as its collective runs: an op that never returns, a peer that
never joins, is what the watcher sees. Async handles, when the port has
them (ROADMAP Queue A item 16a), report their start at enqueue and
their end at ``synchronize``, as the reference's do.

Thresholds share the core's knobs: ``HVD_STALL_CHECK_TIME_SECONDS``
(warn; default 60, <= 0 disables warnings),
``HVD_STALL_SHUTDOWN_TIME_SECONDS`` (default -1 = never shut down), and
``HVD_STALL_CHECK_INTERVAL_SECONDS`` for the watcher's period.

Two differences from the reference: :meth:`StallInspector.stop` ends
the watcher and lets the next :meth:`~StallInspector.report_start` start
a new one, so ``hvd.shutdown()`` can stop it and a later ``hvd.init()``
watch again (the reference's stop is final); and the watcher makes its
``StallError`` pending before it sets ``shutdown_fired``, so a thread
that sees the verdict finds the error (the reference sets the flag
first, and on the card an op issued in between ran on).
"""

import logging
import os
import threading
import time

from . import metrics as _metrics

LOG = logging.getLogger("horovod_tpu_torch.stall")


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class StallError(RuntimeError):
    """Raised (by the default shutdown action) on the caller's thread by
    :meth:`StallInspector.check_shutdown`."""


class StallInspector:
    """Watches per-op last-progress timestamps from a daemon thread.

    The watcher starts at the first :meth:`report_start` (a process that
    runs no collective never spawns it); :meth:`stop` joins it.
    ``on_warn(op, stalled_seconds)`` fires once per op per stall episode
    (re-armed when the op progresses); ``on_shutdown(op,
    stalled_seconds)`` fires at most once, and without it the inspector
    records a pending :class:`StallError` that :meth:`check_shutdown`
    raises on the caller's thread: a daemon thread cannot usefully raise
    into user code itself.
    """

    def __init__(self, warning_sec=None, shutdown_sec=None,
                 check_interval=None, on_warn=None, on_shutdown=None):
        self.warning_sec = (
            _env_float("HVD_STALL_CHECK_TIME_SECONDS", 60.0)
            if warning_sec is None else float(warning_sec))
        self.shutdown_sec = (
            _env_float("HVD_STALL_SHUTDOWN_TIME_SECONDS", -1.0)
            if shutdown_sec is None else float(shutdown_sec))
        if check_interval is None:
            check_interval = _env_float(
                "HVD_STALL_CHECK_INTERVAL_SECONDS", 0.0)
        if check_interval <= 0:
            # Half the tightest active threshold, clamped sane.
            active = [t for t in (self.warning_sec, self.shutdown_sec)
                      if t > 0]
            check_interval = min(10.0, max(0.05, min(active) / 2.0)) \
                if active else 10.0
        self.check_interval = check_interval
        self.on_warn = on_warn
        self.on_shutdown = on_shutdown
        self._lock = threading.Lock()
        self._ops = {}      # name -> last-progress monotonic timestamp
        self._op_ranks = {}  # name -> rank that owns the op (when tagged)
        self._evicted_ranks = set()
        self._warned = set()
        self._thread = None
        self._stop = threading.Event()
        self.shutdown_fired = False
        self._pending_error = None

    def configure(self, warning_sec=None, shutdown_sec=None,
                  check_interval=None):
        """Reload thresholds at runtime. Only the arguments given change;
        the watcher takes the new values at its next scan. A new shutdown
        threshold also clears a pending (not yet raised) StallError
        decided under the old one."""
        with self._lock:
            if warning_sec is not None:
                self.warning_sec = float(warning_sec)
                self._warned.clear()  # re-warn under the new threshold
            if shutdown_sec is not None:
                self.shutdown_sec = float(shutdown_sec)
                self.shutdown_fired = False
                self._pending_error = None
            if check_interval is not None and float(check_interval) > 0:
                self.check_interval = float(check_interval)

    def mark_rank_evicted(self, rank):
        """A peer rank was evicted: the ops attributed to it leave the
        table, and a pending shutdown verdict is withdrawn (an op that
        stalled because the peer died must not kill the survivor after
        it recovered)."""
        with self._lock:
            self._evicted_ranks.add(rank)
            for name, r in list(self._op_ranks.items()):
                if r == rank:
                    self._ops.pop(name, None)
                    self._op_ranks.pop(name, None)
                    self._warned.discard(name)
            self.shutdown_fired = False
            self._pending_error = None

    def evicted_ranks(self):
        with self._lock:
            return set(self._evicted_ranks)

    # -- reporting surface (instrumentation sites) -----------------------
    def report_start(self, name, rank=None):
        """An op entered flight. ``rank`` optionally attributes it to a
        peer rank, so that an eviction clears it (:meth:`mark_rank_evicted`)."""
        with self._lock:
            if rank is not None and rank in self._evicted_ranks:
                return  # the rank is gone; never track its ops
            self._ops[name] = time.monotonic()
            if rank is not None:
                self._op_ranks[name] = rank
            self._warned.discard(name)
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._watch, name="hvd-stall-inspector",
                    daemon=True)
                self._thread.start()

    def report_progress(self, name):
        """The op moved (bytes flowed, a retry round completed, ...)."""
        with self._lock:
            if name in self._ops:
                self._ops[name] = time.monotonic()
                self._warned.discard(name)

    def report_done(self, name):
        with self._lock:
            self._ops.pop(name, None)
            self._op_ranks.pop(name, None)
            self._warned.discard(name)

    def check_shutdown(self):
        """Raise a watcher-detected fatal stall on the caller's thread,
        once. Every instrumented Horovod op calls this first, so a
        stalled job dies with a diagnosable error instead of hanging."""
        err = self._pending_error
        if err is not None:
            self._pending_error = None
            raise err

    def stalled(self):
        """``[(name, seconds since progress)]``, the longest first."""
        now = time.monotonic()
        with self._lock:
            return sorted(((n, now - t) for n, t in self._ops.items()),
                          key=lambda p: -p[1])

    # -- watcher ---------------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self.check_interval):
            self._scan()

    def _scan(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            items = [(n, now - t) for n, t in self._ops.items()]
            warned = set(self._warned)
        worst_name, worst = None, -1.0
        for name, dt in items:
            if dt > worst:
                worst_name, worst = name, dt
            if (self.warning_sec > 0 and dt >= self.warning_sec
                    and name not in warned):
                with self._lock:
                    self._warned.add(name)
                _metrics.STALL_WARNINGS.labels(op=name).inc()
                LOG.warning(
                    "potential stall: op '%s' has made no progress for "
                    "%.1fs (HVD_STALL_CHECK_TIME_SECONDS=%g)",
                    name, dt, self.warning_sec)
                if self.on_warn is not None:
                    self.on_warn(name, dt)
        if (self.shutdown_sec > 0 and worst >= self.shutdown_sec
                and not self.shutdown_fired):
            # The error is pending before the verdict shows, so a thread
            # that sees shutdown_fired also finds it (the reference sets
            # the flag first).
            if self.on_shutdown is None:
                self._pending_error = StallError(
                    f"op '{worst_name}' stalled {worst:.1f}s, past the "
                    f"{self.shutdown_sec:g}s shutdown threshold")
            self.shutdown_fired = True
            LOG.error(
                "stall shutdown: op '%s' stalled %.1fs, past "
                "HVD_STALL_SHUTDOWN_TIME_SECONDS=%g", worst_name, worst,
                self.shutdown_sec)
            if self.on_shutdown is not None:
                self.on_shutdown(worst_name, worst)

    def stop(self):
        """End the watcher thread; the next :meth:`report_start` starts a
        new one."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        self._stop.clear()

    def reset(self):
        """Forget all state: the ops in flight, the evicted ranks, the
        warnings and a pending verdict (tests, elastic reset)."""
        with self._lock:
            self._ops.clear()
            self._op_ranks.clear()
            self._evicted_ranks.clear()
            self._warned.clear()
        self.shutdown_fired = False
        self._pending_error = None


# The process-wide inspector the instrumented op layer reports into.
inspector = StallInspector()
