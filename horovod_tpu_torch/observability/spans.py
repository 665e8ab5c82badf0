"""Chrome-trace span recorder, the part of
``horovod_tpu/observability/spans.py`` the port uses: :func:`span`
(a context manager), :func:`event` (caller-supplied timestamps) and
:func:`instant` (a point in time: the elastic plane's markers).
Recording is a no-op unless metrics are enabled (``HVD_METRICS=1``)."""

import contextlib
import os
import threading
import time

from . import metrics as _metrics

_NOOP = contextlib.nullcontext()


class SpanRecorder:
    def __init__(self, pid=None):
        self._lock = threading.Lock()
        self._events = []
        self.pid = os.getpid() if pid is None else pid

    def _add(self, name, ts_us, dur_us, cat, args):
        ev = {"name": name, "ph": "X", "ts": int(ts_us),
              "dur": max(0, int(dur_us)), "pid": self.pid,
              "tid": threading.current_thread().name}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def _span(self, name, cat, args):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur_us = (time.perf_counter_ns() - t0) // 1000
            self._add(name, time.time_ns() // 1000 - dur_us, dur_us, cat,
                      args)

    def span(self, name, cat="python", **args):
        """One complete event around the block; a shared no-op context
        while disabled."""
        if not _metrics.enabled():
            return _NOOP
        return self._span(name, cat, args)

    def event(self, name, ts_us, dur_us, cat="python", **args):
        """One complete event with wall-clock timestamps in µs."""
        if _metrics.enabled():
            self._add(name, ts_us, dur_us, cat, args)

    def instant(self, name, **args):
        """One instant event (``"ph": "i"``) now, process-scoped."""
        if not _metrics.enabled():
            return
        ev = {"name": name, "ph": "i", "ts": time.time_ns() // 1000,
              "pid": self.pid, "s": "p"}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def events(self):
        """The recorded Chrome-trace events (``{"name", "ph": "X", "ts",
        "dur", "pid", "tid", ...}``)."""
        with self._lock:
            return list(self._events)


recorder = SpanRecorder()
span = recorder.span
event = recorder.event
instant = recorder.instant
