"""In-process Counter / Gauge / Histogram objects under the names
``horovod_tpu/observability/metrics.py`` gives them: the serve loop's,
the pipeline's, the checkpoint's and the elastic plane's.

Off unless ``HVD_METRICS=1`` (or :func:`enable`): a disabled metric does
nothing, so the serve loop's instrumentation costs one flag check. A
family with label names (``ELASTIC_EVENTS``: ``event``) keeps one child
per label value, reached by ``labels(...)``; the older families are
label-less (the pipeline metrics at the end say how they stand in for
the reference's labels). :func:`render_text` is the Prometheus text of
every family, which the launcher's KV store serves at ``/metrics``.
"""

import os
import threading

_enabled = os.environ.get("HVD_METRICS", "0") == "1"


def enabled():
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


REGISTRY = []       # every family, in the order made


class Metric:
    """One family: ``inc`` and ``set`` move ``value``; ``observe`` adds to
    a histogram's bucket counts, ``sum`` and ``count``. With
    ``labelnames`` the family holds no value itself: ``labels(...)``
    gives the child for those values. ``collect()`` is ``[(label values,
    state)]`` for what saw activity."""

    def __init__(self, name, help_, kind, buckets=(), labelnames=(),
                 register=True):
        self.name, self.help, self.kind = name, help_, kind
        self.buckets = tuple(buckets)
        self.labelnames = tuple(labelnames)
        self._children = {}
        if register:
            REGISTRY.append(self)
        self._lock = threading.Lock()
        self.touched = False
        self.value = 0.0
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def inc(self, amount=1):
        if not _enabled:
            return
        if self.kind == "counter" and amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount
            self.touched = True

    def set(self, value):
        if not _enabled:
            return
        with self._lock:
            self.value = float(value)
            self.touched = True

    def observe(self, value):
        if not _enabled:
            return
        value = float(value)
        with self._lock:
            i = next((i for i, b in enumerate(self.buckets) if value <= b),
                     len(self.buckets))
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            self.touched = True

    def labels(self, *values, **kw):
        """The child for these label values (positional, or by name)."""
        key = tuple(str(v) for v in values) if values else tuple(
            str(kw[n]) for n in self.labelnames)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {key}")
        with self._lock:
            if key not in self._children:
                self._children[key] = Metric(self.name, self.help,
                                             self.kind, self.buckets,
                                             register=False)
            return self._children[key]

    def collect(self):
        if self.labelnames:
            with self._lock:
                children = list(self._children.items())
            return [(key, state) for key, child in children
                    for _, state in child.collect()]
        with self._lock:
            if not self.touched:
                return []
            if self.kind == "histogram":
                return [((), {"buckets": list(self.counts), "sum": self.sum,
                              "count": self.count})]
            return [((), {"value": self.value})]


def counter(name, help_="", labelnames=()):
    return Metric(name, help_, "counter", labelnames=labelnames)


def gauge(name, help_="", labelnames=()):
    return Metric(name, help_, "gauge", labelnames=labelnames)


def histogram(name, help_="", buckets=(), labelnames=()):
    return Metric(name, help_, "histogram", buckets, labelnames)


def _fmt_value(v):
    v = float(v)
    return str(int(v)) if v.is_integer() else repr(v)


def _fmt_labels(names, values, extra=()):
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def render_text():
    """Prometheus text exposition (format version 0.0.4) of every family
    (``horovod_tpu/observability/metrics.py::render_text``)."""
    lines, named = [], set()
    for m in REGISTRY:
        if m.name not in named:      # PIPELINE_ZB_FALLBACKS: one name
            named.add(m.name)
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        for key, state in m.collect():
            labels = _fmt_labels(m.labelnames, key)
            if m.kind != "histogram":
                lines.append(f"{m.name}{labels} {_fmt_value(state['value'])}")
                continue
            cum = 0
            for b, c in zip(m.buckets + (float("inf"),), state["buckets"]):
                cum += c
                le = "+Inf" if b == float("inf") else _fmt_value(b)
                lines.append(f"{m.name}_bucket"
                             f"{_fmt_labels(m.labelnames, key, [('le', le)])}"
                             f" {cum}")
            lines.append(f"{m.name}_sum{labels} {_fmt_value(state['sum'])}")
            lines.append(f"{m.name}_count{labels} {state['count']}")
    return "\n".join(lines) + "\n"


SERVE_QUEUE_DEPTH = gauge(
    "hvd_serve_queue_depth",
    "Requests waiting for admission into the decode batch")
SERVE_KV_OCCUPANCY = gauge(
    "hvd_serve_kv_occupancy",
    "Fraction of usable KV pages owned by running requests")
SERVE_BATCH_FILL = gauge(
    "hvd_serve_batch_fill",
    "Fraction of decode-batch slots doing useful work this step")
SERVE_TOKENS = counter(
    "hvd_serve_tokens", "Decode tokens generated")
SERVE_PREEMPTIONS = counter(
    "hvd_serve_preemptions",
    "Running requests preempted back to the queue on KV-page starvation")
SERVE_TTFT_SECONDS = histogram(
    "hvd_serve_ttft_seconds",
    "Per-request time-to-first-token, arrival to first token",
    buckets=(.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10, 30))
SERVE_ITL_SECONDS = histogram(
    "hvd_serve_itl_seconds",
    "Per-request mean inter-token latency over its decode life",
    buckets=(.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1, 2.5))
SERVE_PREFIX_HIT_RATIO = gauge(
    "hvd_serve_prefix_hit_ratio",
    "Fraction of admitted prompt tokens served from cached prefix pages")
SERVE_SPEC_ACCEPTED_PER_STEP = gauge(
    "hvd_serve_spec_accepted_per_step",
    "Mean accepted draft tokens per speculative step")
SERVE_PREFIX_EVICTIONS = counter(
    "hvd_serve_prefix_evictions",
    "Cached prefix pages LRU-evicted back to the pool")
SERVE_SPEC_REJECTED = counter(
    "hvd_serve_spec_rejected", "Draft tokens the target model rejected")

# Pipeline parallelism (parallel/pipeline.py). The reference labels
# PIPELINE_TRACES by (stages, microbatches, schedule), PIPELINE_STEPS by
# schedule and PIPELINE_ZB_FALLBACKS by reason; these metrics have no
# labels yet, so the first two count every schedule together and the
# fallbacks are one counter per reason, all under the reference's name,
# in PIPELINE_ZB_FALLBACKS[reason].
PIPELINE_TRACES = counter(
    "hvd_pipeline_traces_total",
    "pipeline_apply schedule constructions (one per call or built step)")
PIPELINE_BUBBLE = gauge(
    "hvd_pipeline_bubble_fraction",
    "Ideal (closed-form) bubble fraction of the last-built pipeline "
    "schedule — e.g. (S-1)/(M+S-1) for gpipe")
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
    "metrics were enabled at step-build time)")
ZB_FALLBACK_REASONS = ("single_stage", "ring_alias", "unplaced_bw",
                       "table_error")
PIPELINE_ZB_FALLBACKS = {
    reason: counter(
        "hvd_pipeline_zb_fallbacks_total",
        f"ZB-H1 requests that fell back to plain 1F1B, reason={reason}")
    for reason in ZB_FALLBACK_REASONS}

# The sharded checkpoint (checkpoint.py); counted per process, as
# checkpoint.checkpoint_stats() is.
CKPT_SAVES = counter(
    "hvd_ckpt_saves",
    "checkpoint.save() calls entered on this rank")
CKPT_COMMITS = counter(
    "hvd_ckpt_commits",
    "Checkpoints durably committed (MANIFEST fsynced + staging dir "
    "atomically renamed)")
CKPT_ABORTED_COMMITS = counter(
    "hvd_ckpt_aborted_commits",
    "Saves that died before the rename (the previous checkpoint stays "
    "latest)")
CKPT_BYTES_WRITTEN = counter(
    "hvd_ckpt_bytes_written",
    "Shard bytes this rank wrote (its own blocks only)")
CKPT_BYTES_READ = counter(
    "hvd_ckpt_bytes_read",
    "Shard-file bytes this rank fetched during restore")
CKPT_FRAGMENTS = counter(
    "hvd_ckpt_fragments",
    "Shard files read during restore-with-reshard assembly")
CKPT_RESTORES = counter(
    "hvd_ckpt_restores",
    "checkpoint.restore() calls that returned a tree")
CKPT_SNAPSHOT_STALL_SECONDS = gauge(
    "hvd_ckpt_snapshot_stall_seconds",
    "Last device->host snapshot stall, the only step-blocking part of an "
    "async save (span: ckpt.snapshot_stall)")
CKPT_WRITE_SECONDS = gauge(
    "hvd_ckpt_write_seconds",
    "Last serialize+IO+commit time (overlapped with compute when async)")
CKPT_LAST_COMMITTED_STEP = gauge(
    "hvd_ckpt_last_committed_step",
    "Step of the newest checkpoint this rank committed")

# The elastic plane (elastic.py, runner/elastic/), under the reference's
# names and labels. The four gauges are snapshots: the KV client's
# retries, the evictions this process met, and the driver's promotions
# and heartbeat misses, which workers read from the driver's stats.
ELASTIC_EVENTS = counter(
    "hvd_elastic_events_total",
    "Elastic lifecycle events (failure / host_update / reset / "
    "reset_retry)",
    ("event",))
ELASTIC_RESET_SECONDS = histogram(
    "hvd_elastic_reset_seconds",
    "Re-rendezvous duration (teardown -> new assignment -> init)",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
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
