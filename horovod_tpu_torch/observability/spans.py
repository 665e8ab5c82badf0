"""Python-side span recorder and Chrome-trace merge: the port of
``horovod_tpu/observability/spans.py``.

:func:`span` (a context manager), :func:`event` (caller-supplied
timestamps) and :func:`instant` (a point in time: the elastic plane's
markers) record the Python half of a job, the serve loop's steps, the
checkpoint's phases, elastic resets and anything a caller wraps, in the
Chrome-trace event schema. :func:`dump` writes them out, and
:func:`merge_traces` folds any number of such files into one
Perfetto-loadable JSON. The port has no C++ core timeline: what a merge
puts beside the Python spans is the trace that
:func:`horovod_tpu_torch.profiler.stop` exports (torch.profiler's ops,
the ``hvd.<op>`` ranges and, on the card, the kernels).

Recording is a no-op unless metrics are enabled (``HVD_METRICS=1``): the
disabled :func:`span` returns a shared nullcontext, with no clock read
and no lock.
"""

import contextlib
import json
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

    def clear(self):
        with self._lock:
            self._events.clear()

    def dump(self, path):
        """Write the recorded events as Chrome-trace JSON (the object
        form, ``{"traceEvents": [...]}``, which Perfetto reads); returns
        ``path``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f)
        return path


recorder = SpanRecorder()
span = recorder.span
event = recorder.event
instant = recorder.instant
dump = recorder.dump


# ---------------------------------------------------------------------------
# Merge

def _load_trace_events(path):
    """Events from a Chrome-trace file in either shape (a bare array or
    ``{"traceEvents": ...}``). A trace file snapshotted while its writer
    still runs lacks its closing ``]``: the common truncations are
    repaired instead of failing the whole merge; anything else raises
    ``ValueError``."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        t = text.rstrip().rstrip(",")
        for suffix in ("]", "}]", '"}]'):
            try:
                data = json.loads(t + suffix)
                break
            except ValueError:
                continue
        else:
            raise ValueError(f"{path}: not parseable as Chrome-trace JSON "
                             f"(even after truncation repair)")
    if isinstance(data, dict):
        data = data.get("traceEvents", [])
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected an event array or "
                         f"{{'traceEvents': [...]}}")
    return [e for e in data if isinstance(e, dict)]


def merge_traces(out_path, *paths, extra_events=()):
    """Merge Chrome-trace files (a profiler window's export, span dumps
    of several processes) into one Perfetto-loadable JSON at
    ``out_path``: the events concatenated and sorted by ``ts``, each
    file's pid/tid rows kept apart. Returns ``out_path``."""
    events = list(extra_events)
    for p in paths:
        events.extend(_load_trace_events(p))
    events.sort(key=lambda e: e.get("ts", 0))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return out_path
