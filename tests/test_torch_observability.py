"""The port's observability plane (horovod_tpu_torch/observability/ and the
op wrapper of ops/torch_ops.py) against the JAX package's, on the CPU, in
this process: the port's counterpart of tests/test_observability.py.

- The registry: counter, gauge and histogram semantics, idempotent
  registration and its conflicts, label isolation; one scripted sequence
  of ``inc``/``dec``/``set``/``observe``/``record_call``/``timer`` calls
  (the timer on a fake clock) fed to both registries gives, for every
  family both declare, the same ``render_text`` lines (HELP aside for the
  four whose help says what the port counts) and the same ``snapshot()``.
  The reference's families the port lacks are exactly the ones its C++
  core or JAX bridge fills (ROADMAP Queue A item 16b).
- The disabled path: no lock, no sample, no clock read, and the op
  wrapper never reaches ``record_call`` or the stall inspector.
- Spans: ``dump`` and ``merge_traces`` write what the reference writes
  for the same events and files, a truncated file repaired and garbage
  refused with the reference's words.
- The stall inspector: both packages' inspectors driven through one
  sequence of ``report_*`` events, ``configure``, ``mark_rank_evicted``
  and ``reset`` with ``_scan(now=)`` on a fake clock: the same warnings,
  ``stalled()`` order, shutdown verdicts, ``StallError`` messages and
  warning counts. The port's ``stop`` lets a later op start a new watcher,
  and its verdict shows only once its error is pending.
- The endpoint: an ephemeral start, a no-op with metrics off, a busy port
  (offset by ``HVD_LOCAL_RANK``) that warns and returns None, and
  ``hvd.init()`` starting it and ``hvd.shutdown()`` stopping it; the
  config file's metrics, stall-check and autoscale keys as the
  reference's.
- The op wrapper over gloo threads at 2 ranks: calls, bytes and latency
  counts by op and process-set id equal to the reference's wrapper fed the
  same tensors (a grouped op once per tensor, through the reference's own
  fan-out), ``DistributedOptimizer.step`` counted per leaf, a pending
  stall raised by the next op, and nothing left in flight.
- The elastic plane: an eviction clears the evictee's ops, a reset clears
  the inspector.
"""

import json
import logging
import socket
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.observability import metrics as jmetrics  # noqa: E402
from horovod_tpu.observability import spans as jspans  # noqa: E402
from horovod_tpu.observability import stall as jstall  # noqa: E402
from horovod_tpu.ops import collective_ops as jops  # noqa: E402
import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch import distributed, elastic  # noqa: E402
from horovod_tpu_torch import observability as obs  # noqa: E402
from horovod_tpu_torch.exceptions import (  # noqa: E402
    HorovodInternalError, RankEvictedError)
from horovod_tpu_torch.graft_entry import _on_ranks  # noqa: E402
from horovod_tpu_torch.observability import metrics, spans, stall  # noqa: E402
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.process_sets import (  # noqa: E402
    ProcessSet, add_process_set)

# Families whose help says what the port counts (metrics.py's docstring).
HELP_DIFFERS = {"hvd_op_calls_total", "hvd_pipeline_traces_total",
                "hvd_pipeline_bubble_measured_fraction",
                "hvd_elastic_heartbeat_misses"}
# The reference's families that only its C++ core (sample_core_stats) or
# its JAX bridge fill: ROADMAP Queue A item 16b.
CORE_FED = {
    "hvd_bridge_traces_total", "hvd_bridge_buffers_total",
    "hvd_bridge_copy_bytes_total", "hvd_ring_stream_steps",
    "hvd_ring_stream_blocks", "hvd_ring_serial_steps",
    "hvd_ring_overlap_seconds", "hvd_reduce_fast_ops",
    "hvd_reduce_scalar_ops", "hvd_shm_ops", "hvd_shm_bytes",
    "hvd_shm_fallbacks", "hvd_reduce_pool_jobs", "hvd_reduce_pool_spans",
    "hvd_wire_tier", "hvd_wire_ops", "hvd_wire_syscalls",
    "hvd_wire_uring_submits", "hvd_wire_zc_sends", "hvd_wire_pinned_lanes",
    "hvd_alltoall_ops", "hvd_alltoall_bytes", "hvd_alltoall_shm_ops",
    "hvd_alltoall_sg_rounds", "hvd_ep_reports", "hvd_ep_tokens",
    "hvd_ep_dropped", "hvd_ep_last_fraction", "hvd_autotune_samples",
    "hvd_autotune_budget", "hvd_autotune_dims", "hvd_autotune_bracket_round",
    "hvd_autotune_survivors", "hvd_autotune_profile_status",
    "hvd_autotune_profile_adopted", "hvd_autotune_prior_seeded"}


def _reset_both():
    for m in (metrics, jmetrics):
        m.REGISTRY.clear()
    for s in (spans, jspans):
        s.recorder.clear()


@pytest.fixture
def metrics_on():
    """Both registries on and empty for one test; off and empty after
    (tier-1 runs with HVD_METRICS unset)."""
    _reset_both()
    metrics.enable()
    jmetrics.enable()
    yield
    metrics.disable()
    jmetrics.disable()
    _reset_both()


class _Clock:
    """A fake ``time`` module: ``monotonic`` and ``perf_counter`` read
    ``now``, which the test moves."""

    def __init__(self, now=100.0):
        self.now = now

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


# ---------------------------------------------------------------------------
# Registry semantics, side by side

@pytest.mark.parametrize("mod", [metrics, jmetrics], ids=["port", "ref"])
def test_metric_semantics(mod, metrics_on):
    c = mod.counter("t_obs_counter", "help", ("op",))
    child = c.labels(op="allreduce")
    child.inc()
    child.inc(5)
    assert c.collect() == [(("allreduce",), {"value": 6.0})]
    with pytest.raises(ValueError):
        child.inc(-1)
    g = mod.gauge("t_obs_gauge", "help")
    g.set(3.5)
    g.inc(2)
    g.dec(1)
    assert g.collect() == [((), {"value": 4.5})]
    h = mod.histogram("t_obs_hist", "help", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    [(key, state)] = h.collect()
    assert key == () and state["buckets"] == [1, 1, 1, 1]
    assert state["count"] == 4 and state["sum"] == pytest.approx(55.55)


@pytest.mark.parametrize("mod", [metrics, jmetrics], ids=["port", "ref"])
def test_register_idempotent_conflicts_and_label_isolation(mod, metrics_on):
    a = mod.counter("t_obs_idem", "h", ("op",))
    assert mod.counter("t_obs_idem", "h", ("op",)) is a
    with pytest.raises(ValueError):
        mod.gauge("t_obs_idem")             # another kind
    with pytest.raises(ValueError):
        mod.counter("t_obs_idem", "h", ("other",))   # other labels
    c = mod.counter("t_obs_labels", "h", ("op", "process_set"))
    c.labels(op="allreduce", process_set="0").inc(7)
    c.labels(op="allreduce", process_set="1").inc(1)
    c.labels(op="allgather", process_set="0").inc(2)
    assert dict((k, v["value"]) for k, v in c.collect()) == {
        ("allreduce", "0"): 7.0, ("allreduce", "1"): 1.0,
        ("allgather", "0"): 2.0}
    with pytest.raises(ValueError):
        c.labels(op="allreduce")
    with pytest.raises(ValueError):
        c.labels(op="x", process_set="0", extra="y")


def _family_lines(text, m):
    names = {m.name} | ({m.name + s for s in ("_bucket", "_sum", "_count")}
                        if m.kind == "histogram" else set())
    out = []
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            if line.split(" ")[2] == m.name:
                out.append(line)
        elif line.split("{")[0].split(" ")[0] in names:
            out.append(line)
    return out


def _feed(mod, fams, clock):
    """One scripted sequence of calls on every family in ``fams``, label
    values and amounts from one seed."""
    rng = np.random.default_rng(5)
    for name in fams:
        m = mod.REGISTRY._metrics[name]
        for _ in range(3):
            labels = {n: f"{n}{rng.integers(0, 2)}" for n in m.labelnames}
            child = m.labels(**labels)
            if m.kind == "counter":
                child.inc(float(rng.integers(1, 9)))
                child.inc()
            elif m.kind == "gauge":
                child.set(float(rng.normal()))
                child.inc(0.25)
                child.dec(2)
            else:
                for v in rng.exponential(2.0, size=4):
                    child.observe(float(v))
                clock.now += 0.3
                with mod.timer(child):
                    clock.now += float(rng.exponential(0.5))
    for op, ps, nbytes in (("allreduce", 0, 4096), ("allreduce", 3, 0),
                           ("broadcast", 1, 12), ("allreduce", 0, 4)):
        mod.record_call(op, float(rng.exponential(0.1)), nbytes, ps)


def test_render_text_and_snapshot_match_reference(metrics_on, monkeypatch):
    port_names = {m.name for m in metrics.REGISTRY.metrics()}
    ref_names = {m.name for m in jmetrics.REGISTRY.metrics()}
    assert port_names <= ref_names
    assert ref_names - port_names == CORE_FED
    shared = sorted(port_names)
    for name in shared:
        a = metrics.REGISTRY._metrics[name]
        b = jmetrics.REGISTRY._metrics[name]
        assert (a.kind, a.labelnames, a.buckets) == \
            (b.kind, b.labelnames, b._buckets), name
        assert (a.help == b.help) == (name not in HELP_DIFFERS), name
    for mod in (metrics, jmetrics):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        _feed(mod, shared, clock)
    text, jtext = metrics.render_text(), jmetrics.render_text()
    snap, jsnap = metrics.snapshot(), jmetrics.snapshot()
    for name in shared:
        got = _family_lines(text, metrics.REGISTRY._metrics[name])
        want = _family_lines(jtext, jmetrics.REGISTRY._metrics[name])
        if name in HELP_DIFFERS:
            got, want = got[1:], want[1:]
        assert got == want and got[-1].startswith(name), name
        a, b = dict(snap[name]), dict(jsnap[name])
        if name in HELP_DIFFERS:
            a.pop("help"), b.pop("help")
        assert a == b and a["samples"], name
    json.dumps(snap)
    op = snap["hvd_op_bytes_total"]["samples"]
    assert {(s["labels"]["op"], s["labels"]["process_set"]): s["value"]
            for s in op if not s["labels"]["op"].startswith("op")} == {
        ("allreduce", "0"): 4100.0, ("broadcast", "1"): 12.0}


# ---------------------------------------------------------------------------
# The disabled path

class _PoisonLock:
    def __enter__(self):
        raise AssertionError("lock acquired on the disabled path")

    def __exit__(self, *exc):
        return False

    def acquire(self, *a, **k):
        raise AssertionError("lock acquired on the disabled path")

    def release(self):
        pass


def test_disabled_path_touches_no_lock_clock_or_inspector(monkeypatch):
    assert not metrics.enabled()
    for fam in (metrics.OP_CALLS, metrics.OP_SECONDS, metrics.SERVE_TOKENS):
        monkeypatch.setattr(fam, "_lock", _PoisonLock())
    child = metrics.OP_CALLS.labels(op="allreduce", process_set="0")
    assert child is metrics._NOOP_CHILD
    child.inc()
    metrics.SERVE_TOKENS.inc()
    metrics.OP_SECONDS.labels(op="x", process_set="0").observe(1.0)
    monkeypatch.setattr(spans.recorder, "_lock", _PoisonLock())
    assert spans.span("x") is spans.span("y", step=1) is spans._NOOP
    spans.instant("z")

    def boom(*a, **k):
        raise AssertionError("reached on the disabled path")

    monkeypatch.setattr(metrics, "record_call", boom)
    monkeypatch.setattr(stall.inspector, "report_start", boom)
    monkeypatch.setattr(stall.inspector, "check_shutdown", boom)
    monkeypatch.setattr(torch_ops, "_time",
                        types.SimpleNamespace(perf_counter=boom))
    ps = ProcessSet([0])
    with pytest.raises(ValueError, match="has no group"):
        torch_ops.hvd_allreduce(torch.ones(3), process_set=ps)
    monkeypatch.undo()
    assert metrics.OP_CALLS.collect() == [] == metrics.SERVE_TOKENS.collect()


# ---------------------------------------------------------------------------
# Spans: dump and merge

def _trace_files(tmp_path):
    core = tmp_path / "core.json"
    core.write_text(json.dumps([
        {"name": "NEGOTIATE_ALLREDUCE", "ph": "X", "ts": 5, "dur": 10,
         "pid": 0, "tid": "t.0"},
        {"name": "cycle", "ph": "i", "ts": 1, "pid": 0, "s": "p"}]))
    trunc = tmp_path / "trunc.json"
    trunc.write_text('[\n{"name": "a", "ph": "X", "ts": 3, "dur": 2, '
                     '"pid": 0, "tid": "t"},\n{"name": "b", "ph": "i", '
                     '"ts": 7, "pid": 0, "s": "p"},\n')
    obj = tmp_path / "obj.json"
    obj.write_text(json.dumps({"traceEvents": [
        {"name": "kernel", "ph": "X", "ts": 4, "dur": 1, "pid": 1,
         "tid": 2}, "junk"], "displayTimeUnit": "ns"}))
    return [str(p) for p in (core, trunc, obj)]


def test_dump_and_merge_match_reference(tmp_path, metrics_on):
    out = {}
    for name, mod in (("port", spans), ("ref", jspans)):
        rec = mod.SpanRecorder(pid=17)
        rec.event("py.work", 6, 3, cat="python", step=1)
        rec.event("py.load", 2, 1)
        d = tmp_path / name
        d.mkdir()
        py = rec.dump(str(d / "py.json"))
        assert json.loads(open(py).read())["displayTimeUnit"] == "ms"
        merged = mod.merge_traces(str(d / "merged.json"),
                                  *_trace_files(d), py,
                                  extra_events=[{"name": "x", "ts": 0}])
        out[name] = json.loads(open(merged).read())
    assert out["port"] == out["ref"]
    evs = out["port"]["traceEvents"]
    assert [e["name"] for e in evs] == ["x", "cycle", "py.load", "a",
                                        "kernel", "NEGOTIATE_ALLREDUCE",
                                        "py.work", "b"]
    with spans.span("py.step"):
        pass
    assert [e["name"] for e in spans.recorder.events()] == ["py.step"]
    spans.recorder.clear()
    assert spans.recorder.events() == []


def test_merge_refuses_garbage_as_reference(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("this is not a trace {{{")
    arr = tmp_path / "scalar.json"
    arr.write_text("3")
    for path in (bad, arr):
        with pytest.raises(ValueError) as want:
            jspans.merge_traces(str(tmp_path / "o.json"), str(path))
        with pytest.raises(ValueError) as got:
            spans.merge_traces(str(tmp_path / "o.json"), str(path))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The stall inspector, side by side on a fake clock

def _stall_script(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    warns, log = [], []
    insp = mod.StallInspector(warning_sec=2.0, shutdown_sec=-1,
                              check_interval=1000,
                              on_warn=lambda n, dt: warns.append((n, dt)))

    def step(label):
        err = None
        try:
            insp.check_shutdown()
        except mod.StallError as e:
            err = str(e)
        log.append((label, list(warns), insp.stalled(), insp.shutdown_fired,
                    err, sorted(insp.evicted_ranks())))

    try:
        insp.report_start("allreduce.noname.0")
        clock.now += 1.0
        insp.report_start("send.2", rank=2)
        insp.report_start("send.3", rank=3)
        clock.now += 1.5
        insp._scan()
        step("one warning")
        insp.report_progress("allreduce.noname.0")     # re-arms
        clock.now += 1.0
        insp._scan(now=clock.now + 0.5)
        step("sends warn")
        insp._scan(now=clock.now + 3.0)
        step("re-armed warning")
        insp.configure(shutdown_sec=4.0)
        insp._scan(now=clock.now + 2.0)
        step("shutdown verdict")
        insp.configure(shutdown_sec=3.0)
        insp._scan(now=clock.now + 2.0)
        insp.mark_rank_evicted(2)
        step("eviction withdraws the verdict")
        insp.report_start("send2.2", rank=2)
        insp.report_done("allreduce.noname.0")
        insp.configure(warning_sec=0.5)
        insp._scan(now=clock.now + 1.0)
        step("re-warn under a new threshold")
        insp.reset()
        step("reset")
    finally:
        insp.stop()
    return log


def test_stall_inspector_matches_reference(monkeypatch, metrics_on):
    got = _stall_script(stall, monkeypatch)
    want = _stall_script(jstall, monkeypatch)
    assert got == want
    assert want[3][3] and "'send.2' stalled 4.5s" in want[3][4]
    assert want[4][4] is None and want[4][5] == [2]
    assert "send.2" not in dict(want[4][2])
    counts = [{s["labels"]["op"]: s["value"] for s in
               m.snapshot()["hvd_stall_warnings_total"]["samples"]}
              for m in (metrics, jmetrics)]
    assert counts[0] == counts[1] and sum(counts[0].values()) >= 4


def test_pending_stall_raises_once_with_the_references_words(monkeypatch):
    msgs = []
    for mod in (stall, jstall):
        monkeypatch.setattr(mod, "time", _Clock())
        insp = mod.StallInspector(warning_sec=-1, shutdown_sec=1.0,
                                  check_interval=1000)
        try:
            insp.report_start("bcast.noname.4")
            insp._scan(now=112.25)
            with pytest.raises(mod.StallError) as e:
                insp.check_shutdown()
            insp.check_shutdown()                  # consumed
            msgs.append(str(e.value))
        finally:
            insp.stop()
    assert msgs[0] == msgs[1] and "'bcast.noname.4' stalled 12.2s" in msgs[0]


def test_a_verdict_shows_only_with_its_error_pending():
    """The port's watcher makes the StallError pending before it sets
    ``shutdown_fired``: a thread that sees the verdict and calls the next
    op finds the error (the reference's order let an op run on)."""
    seen = []

    class Watched(stall.StallInspector):
        @property
        def shutdown_fired(self):
            return self._fired

        @shutdown_fired.setter
        def shutdown_fired(self, value):
            if value:
                seen.append(self._pending_error is not None)
            self._fired = value

    insp = Watched(warning_sec=-1, shutdown_sec=1.0, check_interval=1000)
    try:
        insp.report_start("x")
        insp._scan(now=time.monotonic() + 5.0)
        assert seen == [True]
        with pytest.raises(stall.StallError):
            insp.check_shutdown()
    finally:
        insp.stop()


def test_stop_lets_a_later_op_watch_again():
    insp = stall.StallInspector(warning_sec=-1, shutdown_sec=-1,
                                check_interval=1000)
    insp.report_start("a")
    first = insp._thread
    insp.stop()
    assert insp._thread is None and not first.is_alive()
    insp.report_start("b")
    assert insp._thread is not None and insp._thread.is_alive()
    insp.stop()


def test_env_thresholds_are_the_references(monkeypatch):
    monkeypatch.setenv("HVD_STALL_CHECK_TIME_SECONDS", "7")
    monkeypatch.setenv("HVD_STALL_SHUTDOWN_TIME_SECONDS", "30")
    for interval in ("0", "2.5"):
        monkeypatch.setenv("HVD_STALL_CHECK_INTERVAL_SECONDS", interval)
        a, b = stall.StallInspector(), jstall.StallInspector()
        assert (a.warning_sec, a.shutdown_sec, a.check_interval) == \
            (b.warning_sec, b.shutdown_sec, b.check_interval)


# ---------------------------------------------------------------------------
# The endpoint

def _get(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        return r.status, r.read().decode()


def test_endpoint_ephemeral_and_disabled(monkeypatch, metrics_on):
    monkeypatch.setenv("HVD_METRICS_PORT", "0")
    metrics.OP_CALLS.labels(op="allreduce", process_set="0").inc(2)
    port = obs.maybe_start_endpoint()
    try:
        assert port and port == obs.endpoint_port()
        status, body = _get(port)
        assert status == 200 and \
            'hvd_op_calls_total{op="allreduce",process_set="0"} 2' in body
        assert obs.maybe_start_endpoint() == port        # one per process
    finally:
        obs.stop_endpoint()
    assert obs.endpoint_port() is None
    metrics.disable()
    assert obs.maybe_start_endpoint() is None            # metrics off
    metrics.enable()
    monkeypatch.delenv("HVD_METRICS_PORT")
    assert obs.maybe_start_endpoint() is None            # no port named


def test_busy_port_warns_and_training_goes_on(monkeypatch, metrics_on,
                                              caplog):
    busy = socket.socket()
    busy.bind(("0.0.0.0", 0))
    busy.listen(1)
    try:
        port = busy.getsockname()[1]
        monkeypatch.setenv("HVD_METRICS_PORT", str(port - 1))
        monkeypatch.setenv("HVD_LOCAL_RANK", "1")      # offset onto it
        with caplog.at_level(logging.WARNING):
            assert obs.maybe_start_endpoint() is None
        assert f"port {port - 1}" in caplog.text
        assert obs.endpoint_port() is None
    finally:
        busy.close()


def test_init_starts_and_shutdown_stops_the_endpoint(monkeypatch,
                                                     metrics_on):
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_JAX_COORD_ADDR", "HVD_ELASTIC",
              "HVD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_METRICS_PORT", "0")
    hvd.init(device="cpu")
    try:
        port = obs.endpoint_port()
        assert port
        hvd.allreduce(torch.ones(4))
        status, body = _get(port)
        assert 'hvd_op_bytes_total{op="allreduce",process_set="0"} 16' \
            in body
        assert stall.inspector._thread is not None
    finally:
        hvd.shutdown()
    assert obs.endpoint_port() is None and stall.inspector._thread is None


def test_config_file_sections_as_the_reference(tmp_path):
    """The config file's ``metrics``, ``stall-check`` and ``serve``
    autoscale keys export what the reference's export."""
    from horovod_tpu.runner import config_parser as jconfig
    from horovod_tpu_torch.runner import config_parser

    cfg = tmp_path / "hvd.yaml"
    cfg.write_text("metrics:\n  enable: true\n  port: 9100\n"
                   "stall-check:\n  warning-time-seconds: 30\n"
                   "  shutdown-time-seconds: 90\n"
                   "serve:\n  autoscale: true\n  autoscale-high: 6\n")
    keys = ("metrics", "metrics_port", "stall_check_warning_time_seconds",
            "stall_check_shutdown_time_seconds", "serve_autoscale",
            "serve_autoscale_high")
    envs = []
    for mod in (config_parser, jconfig):
        args = types.SimpleNamespace(**dict.fromkeys(keys))
        envs.append(mod.args_to_env(mod.apply_config_file(args, str(cfg))))
    want = {"HVD_METRICS": "1", "HVD_METRICS_PORT": "9100",
            "HVD_STALL_CHECK_TIME_SECONDS": "30",
            "HVD_STALL_SHUTDOWN_TIME_SECONDS": "90",
            "HVD_SERVE_AUTOSCALE": "1", "HVD_SERVE_AUTOSCALE_HIGH": "6"}
    assert envs[0] == want == envs[1]


# ---------------------------------------------------------------------------
# The op wrapper at 2 ranks against the reference's wrapper

def _payloads(rank):
    g = torch.Generator().manual_seed(rank)
    return {"x": torch.randn(100, generator=g),
            "tree": {"a": torch.randn(6, 5, generator=g),
                     "b": [torch.randn(7, generator=g).double()]},
            "rows": torch.randn(4, 3, generator=g)}


def _port_rank(world):
    ps0 = ProcessSet.from_world(world)
    ps1 = add_process_set([0, 1], world)
    p = _payloads(world.rank)
    torch_ops.hvd_allreduce(p["x"], process_set=ps0)
    torch_ops.hvd_allreduce_pytree(p["tree"], process_set=ps1)
    torch_ops.hvd_allgather(p["rows"], process_set=ps0)
    torch_ops.hvd_broadcast(p["x"], 0, process_set=ps1)
    torch_ops.hvd_broadcast_pytree(p["tree"], 0, process_set=ps0)
    torch_ops.hvd_reducescatter(p["rows"], process_set=ps0)
    torch_ops.hvd_alltoall(p["rows"], process_set=ps1)
    torch_ops.barrier(process_set=ps0)
    torch_ops.allgather_object({"r": world.rank}, process_set=ps1)
    # DistributedOptimizer: one grouped allreduce, counted per leaf
    w = [torch.ones(3, requires_grad=True), torch.ones(2, 2,
                                                       requires_grad=True)]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(w, lr=0.1),
                                   process_set=ps1)
    (w[0].sum() + w[1].sum() * world.rank).backward()
    opt.step()
    return ps1.process_set_id, [x.detach().clone() for x in w]


def _ref_rank(rank):
    """The reference's wrapper around a stand-in for its core call, fed
    what one rank of the port's job sends, its grouped ops through its
    own fan-out."""
    p = {k: (v.numpy() if torch.is_tensor(v) else v)
         for k, v in _payloads(rank).items()}
    leaves = [p["tree"]["a"].numpy(), p["tree"]["b"][0].numpy()]
    w = {op: jops._instrumented(lambda *a, **k: "ok", op) for op in
         ("allreduce", "allgather", "broadcast", "alltoall",
          "reducescatter", "barrier")}
    w["allreduce"](p["x"], 1, None, 1.0, 1.0, 0)
    jops._grouped("grouped_allreduce", None, leaves,
                  lambda t, n, grp: w["allreduce"](t, 1, n, 1.0, 1.0, 1,
                                                   _group=grp))
    w["allgather"](p["rows"], None, 0)
    w["broadcast"](p["x"], 0, None, 1)
    jops._grouped("grouped_broadcast", None, leaves,
                  lambda t, n, grp: w["broadcast"](t, 0, n, 0))
    w["reducescatter"](p["rows"], 1, None, 1.0, 1.0, 0)
    w["alltoall"](p["rows"], None, None, 1)
    w["barrier"](0)
    grads = [np.ones(3, np.float32), np.full((2, 2), rank, np.float32)]
    jops._grouped("grouped_allreduce", None, grads,
                  lambda t, n, grp: w["allreduce"](t, 1, n, 1.0, 1.0, 1,
                                                   _group=grp))


def _op_samples(mod, family, field="value"):
    return {(s["labels"]["op"], s["labels"]["process_set"]): s[field]
            for s in mod.snapshot()[family]["samples"]}


def test_op_wrapper_counts_as_the_reference(metrics_on):
    out = _on_ranks(2, _port_rank)
    assert [r[0] for r in out] == [1, 1]
    # the optimizer stepped on the mean gradient: ones and 0.5
    for _, (w0, w1) in out:
        assert torch.equal(w0, torch.full((3,), 0.9))
        assert torch.allclose(w1, torch.full((2, 2), 0.95))
    for rank in range(2):
        _ref_rank(rank)
    calls = _op_samples(metrics, "hvd_op_calls_total")
    jcalls = _op_samples(jmetrics, "hvd_op_calls_total")
    objs = {("allgather_object", "1"): 2.0}
    assert calls == {**jcalls, **objs}
    assert _op_samples(metrics, "hvd_op_bytes_total") == \
        _op_samples(jmetrics, "hvd_op_bytes_total")
    lat = _op_samples(metrics, "hvd_op_latency_seconds", "count")
    assert lat == {**_op_samples(jmetrics, "hvd_op_latency_seconds",
                                   "count"), **objs}
    assert all(v > 0 for v in _op_samples(
        metrics, "hvd_op_latency_seconds", "sum").values())
    # grouped: one call per tensor (2 leaves x 2 ranks, twice, on set 1)
    assert calls[("allreduce", "1")] == 8 and \
        calls[("broadcast", "0")] == 4
    assert stall.inspector.stalled() == []


def test_a_pending_stall_is_raised_by_the_next_op(metrics_on):
    insp = stall.inspector
    insp.report_start("forced")
    try:
        insp.configure(shutdown_sec=1.0)
        insp._scan(now=time.monotonic() + 5.0)

        def rank(world):
            ps = ProcessSet.from_world(world)
            try:
                torch_ops.hvd_allreduce(torch.ones(2), process_set=ps)
            except stall.StallError as e:
                return str(e)
            return None

        got = _on_ranks(1, rank)[0]
        assert got is not None and "'forced'" in got
        assert _on_ranks(1, rank) == [None]        # raised once
    finally:
        insp.reset()
        insp.configure(shutdown_sec=-1)
        insp.stop()
    assert insp.stalled() == []


# ---------------------------------------------------------------------------
# The elastic plane

class _State(elastic.State):
    def reset(self):
        pass

    def save(self):
        pass

    def restore(self):
        pass

    def sync(self):
        pass


def test_eviction_and_reset_clear_the_inspector(metrics_on, monkeypatch):
    monkeypatch.delenv("HVD_ELASTIC", raising=False)
    insp = stall.inspector
    try:
        insp.report_start("send.2", rank=2)
        insp.report_start("send.3", rank=3)
        elastic._note_eviction(RankEvictedError("gone", rank=2))
        assert [n for n, _ in insp.stalled()] == ["send.3"]
        assert insp.evicted_ranks() == {2}
        calls = []

        def train(state):
            calls.append(len(insp.stalled()))
            if len(calls) == 1:
                insp.report_start("aborted.in.flight")
                raise HorovodInternalError("peer died")
            return "done"

        assert elastic.run_fn(train, lambda: None)(_State()) == "done"
        assert calls == [1, 0] and insp.evicted_ranks() == set()
        assert metrics.snapshot()["hvd_elastic_events_total"]["samples"]
    finally:
        insp.reset()
        insp.stop()
