"""In-process Counter / Gauge / Histogram objects under the names
``horovod_tpu/observability/metrics.py`` gives them: the serve loop's,
the pipeline's and the checkpoint's.

Off unless ``HVD_METRICS=1`` (or :func:`enable`): a disabled metric does
nothing, so the serve loop's instrumentation costs one flag check.
Label-less only (the pipeline metrics at the end say how they stand in
for the reference's labels); the Prometheus exposition waits for a later
slice.
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


class Metric:
    """One label-less family: ``inc`` and ``set`` move ``value``;
    ``observe`` adds to a histogram's bucket counts, ``sum`` and
    ``count``. ``collect()`` is ``[]`` until the metric saw activity."""

    def __init__(self, name, help_, kind, buckets=()):
        self.name, self.help, self.kind = name, help_, kind
        self.buckets = tuple(buckets)
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

    def collect(self):
        with self._lock:
            if not self.touched:
                return []
            if self.kind == "histogram":
                return [((), {"buckets": list(self.counts), "sum": self.sum,
                              "count": self.count})]
            return [((), {"value": self.value})]


def counter(name, help_=""):
    return Metric(name, help_, "counter")


def gauge(name, help_=""):
    return Metric(name, help_, "gauge")


def histogram(name, help_="", buckets=()):
    return Metric(name, help_, "histogram", buckets)


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
