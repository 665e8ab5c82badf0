"""Process-local metrics registry: Counter / Gauge / Histogram. The
port's copy of ``horovod_tpu/observability/metrics.py``.

Where a trace answers "what happened when", the registry answers "how
much, how often, how slow": bytes moved per collective, call latency,
stall warnings, elastic resize events, the serve loop's load, scrapeable
from a live job as the Prometheus text served at ``/metrics``
(:mod:`horovod_tpu_torch.runner.http_server`).

Everything is **off unless ``HVD_METRICS=1``** (or :func:`enable`), and
the disabled path costs one module attribute check per call: no lock, no
label lookup, no clock read.

Threading: one registry per process (each rank serves its own
``/metrics``; a scraper aggregates across ranks). Every mutation holds
the family's lock, so the stall inspector's watcher, the elastic reset
loop and user threads can record at once.

The families are the reference's whose emitters the port has: the
Horovod ops (:func:`record_call`, ``ops/torch_ops.py``), the stall
inspector, the elastic plane, the pipeline, the serve loop and the
checkpoint, under the reference's names, kinds, labels and buckets. The
reference's families that only its ``sample_core_stats`` fills from the
C++ core (ring pipeline, shm plane, reduce kernels and pool, wire,
alltoall tiers, expert dispatch, autotune) and those of its JAX bridge
wait for the port of that core (ROADMAP Queue A item 16b).
``hvd_elastic_heartbeat_misses`` is the one family whose meaning
differs: the port counts the workers its elastic driver killed for a
stale heartbeat, where the reference snapshots its core's counter.
Three more say what the port counts in their help: ``hvd_op_calls_total``
(the port's module), ``hvd_pipeline_traces_total`` and
``hvd_pipeline_bubble_measured_fraction`` (no compile: a construction
per call or built step, the tables of the tick loop).
"""

import os
import threading
import time

_enabled = os.environ.get("HVD_METRICS", "0") == "1"


def enabled():
    """One attribute read: the gate every instrumentation site checks
    before doing any metric work."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


# ---------------------------------------------------------------------------
# Metric types

class _NoopChild:
    """The shared do-nothing child ``labels()`` returns while disabled: a
    call site that skipped the ``enabled()`` gate still takes no lock."""

    __slots__ = ()

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass


_NOOP_CHILD = _NoopChild()


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount=1):
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value):
        if not _enabled:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount=1):
        if not _enabled:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount=1):
        self.inc(-amount)


# Prometheus' default latency buckets (seconds).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock, buckets):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        if not _enabled:
            return
        value = float(value)
        with self._lock:
            i = 0
            for b in self.buckets:
                if value <= b:
                    break
                i += 1
            self.counts[i] += 1
            self.sum += value
            self.count += 1


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class Metric:
    """One named family; a child per label set, made at first use. A
    family without labels keeps one child, under ``()``; ``value`` (a
    histogram's ``count``) reads it, 0 before any sample."""

    def __init__(self, name, help_, kind, labelnames=(), buckets=None):
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets or DEFAULT_BUCKETS)
        self._lock = threading.Lock()
        self._children = {}

    @property
    def buckets(self):
        return self._buckets

    def labels(self, **kv):
        """The child for one label set; the shared no-op child while
        disabled, so even a caller that skipped the ``enabled()`` gate
        never takes this lock on a disabled hot path."""
        if not _enabled:
            return _NOOP_CHILD
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _make_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self._lock, self._buckets)
        return _CHILD_TYPES[self.kind](self._lock)

    # Label-less convenience: metric.inc() == metric.labels().inc()
    def inc(self, amount=1):
        self.labels().inc(amount)

    def dec(self, amount=1):
        self.labels().dec(amount)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value):
        self.labels().observe(value)

    def _solo(self, field):
        child = self._children.get(())
        return 0 if child is None else getattr(child, field)

    @property
    def value(self):
        return self._solo("value")

    @property
    def count(self):
        return self._solo("count")

    def collect(self):
        """``[(label values, state)]`` under the lock, sorted by label
        values: a histogram's state is its per-bucket ``buckets``, ``sum``
        and ``count``, the others' ``value``."""
        with self._lock:
            out = []
            for key, c in sorted(self._children.items()):
                if self.kind == "histogram":
                    out.append((key, {"buckets": list(c.counts),
                                      "sum": c.sum, "count": c.count}))
                else:
                    out.append((key, {"value": c.value}))
            return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _register(self, name, help_, kind, labelnames, buckets=None):
        """The family ``name``, made at the first call; a later call with
        the same kind and labels returns it, another kind or other labels
        raise."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered with a different "
                        f"type/labels ({m.kind}{m.labelnames} vs "
                        f"{kind}{tuple(labelnames)})")
                return m
            m = Metric(name, help_, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labelnames=()):
        return self._register(name, help_, "counter", labelnames)

    def gauge(self, name, help_="", labelnames=()):
        return self._register(name, help_, "gauge", labelnames)

    def histogram(self, name, help_="", labelnames=(), buckets=None):
        return self._register(name, help_, "histogram", labelnames,
                              buckets)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self):
        """Drop every recorded sample (tests). The families stay
        registered, so module-level metric objects keep working."""
        with self._lock:
            families = list(self._metrics.values())
        for m in families:
            with m._lock:
                m._children.clear()


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram


# ---------------------------------------------------------------------------
# Exposition

def _escape(v):
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
             .replace('"', '\\"'))


def _fmt_labels(names, values, extra=()):
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v):
    if v == int(v):
        return str(int(v))
    return repr(float(v))


def render_text():
    """Prometheus text exposition (format version 0.0.4) of every family
    in the process registry, sorted by name."""
    lines = []
    for m in REGISTRY.metrics():
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, state in m.collect():
            if m.kind == "histogram":
                cum = 0
                for b, c in zip(m._buckets + (float("inf"),),
                                state["buckets"]):
                    cum += c
                    le = "+Inf" if b == float("inf") else _fmt_value(b)
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labelnames, key, [('le', le)])}"
                        f" {cum}")
                lines.append(f"{m.name}_sum"
                             f"{_fmt_labels(m.labelnames, key)}"
                             f" {_fmt_value(state['sum'])}")
                lines.append(f"{m.name}_count"
                             f"{_fmt_labels(m.labelnames, key)}"
                             f" {state['count']}")
            else:
                lines.append(f"{m.name}{_fmt_labels(m.labelnames, key)}"
                             f" {_fmt_value(state['value'])}")
    return "\n".join(lines) + "\n"


def snapshot():
    """JSON-able dump of the registry: ``{name: {"type", "help",
    "samples": [{"labels": {...}, <state>}]}}``."""
    out = {}
    for m in REGISTRY.metrics():
        samples = []
        for key, state in m.collect():
            samples.append({"labels": dict(zip(m.labelnames, key)),
                            **state})
        out[m.name] = {"type": m.kind, "help": m.help, "samples": samples}
    return out


# ---------------------------------------------------------------------------
# The standard hvd instrument set. Families are registered at import
# (cheap, once); they record nothing until enabled.

OP_CALLS = counter(
    "hvd_op_calls_total",
    "Collective API calls through ops.torch_ops (a grouped op counts "
    "once per tensor)",
    ("op", "process_set"))
OP_BYTES = counter(
    "hvd_op_bytes_total",
    "Input payload bytes submitted to collectives",
    ("op", "process_set"))
OP_SECONDS = histogram(
    "hvd_op_latency_seconds",
    "Wall time of collective API calls (async ops: enqueue; sync "
    "wrappers and synchronize: full completion wait)",
    ("op", "process_set"))
ELASTIC_EVENTS = counter(
    "hvd_elastic_events_total",
    "Elastic lifecycle events (failure / host_update / reset / "
    "reset_retry)",
    ("event",))
ELASTIC_RESET_SECONDS = histogram(
    "hvd_elastic_reset_seconds",
    "Re-rendezvous duration (shutdown -> new assignment -> init)",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
PIPELINE_TRACES = counter(
    "hvd_pipeline_traces_total",
    "pipeline_apply schedule constructions (one per call or built "
    "step)",
    ("stages", "microbatches", "schedule"))
PIPELINE_BUBBLE = gauge(
    "hvd_pipeline_bubble_fraction",
    "Ideal (closed-form) bubble fraction of the last-built pipeline "
    "schedule — e.g. (S-1)/(M+S-1) for gpipe; see docs/perf_tuning.md "
    "section 'Pipeline schedules'")
PIPELINE_BUBBLE_MEASURED = gauge(
    "hvd_pipeline_bubble_measured_fraction",
    "Measured bubble fraction of the last-built schedule: 1 - occupied "
    "rank-tick slots / (ticks x stages), counted from the very tables "
    "the tick loop runs")
PIPELINE_TICKS = gauge(
    "hvd_pipeline_schedule_ticks",
    "Total tick count T of the last-built pipeline schedule (training "
    "accounting: forward-only schedules mirror the forward table)")
PIPELINE_STEPS = counter(
    "hvd_pipeline_steps_total",
    "Instrumented pipeline train steps executed (only counted when "
    "metrics were enabled at step-build time)", ("schedule",))
PIPELINE_ZB_FALLBACKS = counter(
    "hvd_pipeline_zb_fallbacks_total",
    "ZB-H1 requests that fell back to plain 1F1B because the split "
    "schedule could not be made shape-stable", ("reason",))
STALL_WARNINGS = counter(
    "hvd_stall_warnings_total",
    "Python-side stall inspector warnings", ("op",))
ELASTIC_HEARTBEAT_MISSES = gauge(
    "hvd_elastic_heartbeat_misses",
    "Workers the elastic driver killed because their liveness heartbeat "
    "went stale (HVD_PEER_TIMEOUT_MS; the driver's count)")
ELASTIC_EVICTIONS = gauge(
    "hvd_elastic_evictions",
    "Rank evictions this process observed (decided on rank 0, received "
    "via the shutdown broadcast elsewhere)")
ELASTIC_KV_RETRIES = gauge(
    "hvd_elastic_kv_retries",
    "Transient rendezvous KV-client retries performed by this process "
    "(bounded exponential backoff, HVD_KV_RETRIES)")
ELASTIC_PROMOTIONS = gauge(
    "hvd_elastic_promotions",
    "Hot-spare promotions the driver reported (spare swapped in for an "
    "evicted/dead rank via an incremental epoch)")
SERVE_QUEUE_DEPTH = gauge(
    "hvd_serve_queue_depth",
    "Requests waiting for admission into the decode batch (the "
    "autoscale policy's primary input — docs/serving.md)")
SERVE_KV_OCCUPANCY = gauge(
    "hvd_serve_kv_occupancy",
    "Fraction of usable KV pages currently owned by running requests "
    "(page 0 is the reserved trash page and never counts)")
SERVE_BATCH_FILL = gauge(
    "hvd_serve_batch_fill",
    "Fraction of decode-batch slots doing useful work this step — the "
    "quantity static batching wastes and continuous batching recovers")
SERVE_TOKENS = counter(
    "hvd_serve_tokens",
    "Decode tokens generated (all requests, this serve loop)")
SERVE_PREEMPTIONS = counter(
    "hvd_serve_preemptions",
    "Running requests preempted back to the queue on KV-page starvation "
    "(their generated prefix replays through prefill on re-admission)")
SERVE_TTFT_SECONDS = histogram(
    "hvd_serve_ttft_seconds",
    "Per-request time-to-first-token: arrival to first decoded token "
    "(includes queueing + prefill)",
    buckets=(.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10, 30))
SERVE_ITL_SECONDS = histogram(
    "hvd_serve_itl_seconds",
    "Per-request mean inter-token latency over its decode life",
    buckets=(.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1, 2.5))
SERVE_PREFIX_HIT_RATIO = gauge(
    "hvd_serve_prefix_hit_ratio",
    "Fraction of admitted prompt tokens served from radix-tree-cached "
    "KV pages instead of prefill (shared-prefix reuse — docs/serving.md; "
    "stays untouched with HVD_SERVE_PREFIX_CACHE=0)")
SERVE_SPEC_ACCEPTED_PER_STEP = gauge(
    "hvd_serve_spec_accepted_per_step",
    "Mean accepted draft tokens per speculative step (0..draft_k; the "
    "speedup lever — each accepted token is a decode step the target "
    "model skipped; stays untouched with spec_tokens=0)")
SERVE_PREFIX_EVICTIONS = counter(
    "hvd_serve_prefix_evictions",
    "Cached prefix pages LRU-evicted back to the pool under page "
    "pressure (only pages no live request shares are ever evicted)")
SERVE_SPEC_REJECTED = counter(
    "hvd_serve_spec_rejected",
    "Draft tokens the target model rejected (their K/V is dead until "
    "overwritten — pure block-table truncation, no copy)")
CKPT_SAVES = counter(
    "hvd_ckpt_saves",
    "checkpoint.save() calls entered on this rank")
CKPT_COMMITS = counter(
    "hvd_ckpt_commits",
    "Checkpoints durably committed (MANIFEST fsynced + staging dir "
    "atomically renamed — docs/checkpoint.md commit protocol)")
CKPT_ABORTED_COMMITS = counter(
    "hvd_ckpt_aborted_commits",
    "Saves that died before the rename (crash/eviction mid-save; the "
    "previous checkpoint stays latest)")
CKPT_BYTES_WRITTEN = counter(
    "hvd_ckpt_bytes_written",
    "Shard bytes this rank wrote (its own addressable shards only)")
CKPT_BYTES_READ = counter(
    "hvd_ckpt_bytes_read",
    "Shard-file bytes this rank fetched during restore")
CKPT_FRAGMENTS = counter(
    "hvd_ckpt_fragments",
    "Shard files read during restore-with-reshard assembly (fetch-only-"
    "your-shard: far below world_size x leaves on a resized restore)")
CKPT_RESTORES = counter(
    "hvd_ckpt_restores",
    "checkpoint.restore() calls that returned a tree")
CKPT_SNAPSHOT_STALL_SECONDS = gauge(
    "hvd_ckpt_snapshot_stall_seconds",
    "Last device->host snapshot stall — the ONLY step-blocking part of "
    "an async save (span: ckpt.snapshot_stall)")
CKPT_WRITE_SECONDS = gauge(
    "hvd_ckpt_write_seconds",
    "Last serialize+IO+commit time (overlapped with compute when async)")
CKPT_LAST_COMMITTED_STEP = gauge(
    "hvd_ckpt_last_committed_step",
    "Step of the newest checkpoint this rank committed")


def record_call(op, seconds, nbytes, process_set=0):
    """One instrumented collective call. The caller holds the
    :func:`enabled` gate, so the disabled path never reaches this
    function and pays for no clock read and no byte count."""
    ps = str(process_set)
    OP_CALLS.labels(op=op, process_set=ps).inc()
    if nbytes:
        OP_BYTES.labels(op=op, process_set=ps).inc(nbytes)
    OP_SECONDS.labels(op=op, process_set=ps).observe(seconds)


class _Timer:
    """``with metrics.timer(hist_child):`` records on exit."""

    __slots__ = ("_child", "_t0")

    def __init__(self, child):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


def timer(child):
    return _Timer(child)
