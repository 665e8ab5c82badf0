"""Serving autoscale in the port (horovod_tpu_torch/serving/autoscale.py,
the elastic driver's autoscale branch, ``worker.report_serve_load`` and
the launcher's ``--serve-autoscale``) against the JAX package's, on the
CPU, in this process: no test here spawns one.

- ``AutoscalePolicy``: the cases of tests/test_serving_scheduler.py
  (patience, a streak reset in the band, scale-down needing an idle
  batch, the bounds, the constructor's checks) and hypothesis-drawn load
  traces, each decision the reference's.
- ``ElasticDriver``: the port's and the reference's drivers, fed one
  ``/ctl/serve_load`` trace (malformed samples included) and republishing
  an epoch whenever the target moves, as their main loops do: the same
  ``target_np``, ``autoscale_events``, epochs, assignment tables (the
  per-epoch store addresses aside), spares and rank maps, through epochs
  of one worker (whose world meets in a ``HashStore``) and of two and
  three (a ``TCPStore`` the port's driver hosts).
- ``report_serve_load``: both packages' reports reach a real in-process
  ``RendezvousServer`` with the same bytes, and the driver consumes them.
- ``--serve-autoscale``: the launcher builds the reference's policy.
"""

import json

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(1)

from horovod_tpu.runner import launch as jlaunch  # noqa: E402
from horovod_tpu.runner.elastic import driver as jdriver  # noqa: E402
from horovod_tpu.runner.elastic import worker as jworker  # noqa: E402
from horovod_tpu.runner.elastic.discovery import (  # noqa: E402
    FixedHosts as JFixedHosts)
from horovod_tpu.serving import autoscale as jautoscale  # noqa: E402
from horovod_tpu_torch.runner import launch  # noqa: E402
from horovod_tpu_torch.runner.elastic import driver, worker  # noqa: E402
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts  # noqa: E402
from horovod_tpu_torch.serving import autoscale  # noqa: E402


@pytest.fixture(autouse=True)
def _no_job_env(monkeypatch):
    for k in ("HVD_ELASTIC", "HVD_RENDEZVOUS_ADDR", "HVD_WORKER_ID",
              "HVD_RENDEZVOUS_SECRET", "HVD_SERVE_AUTOSCALE",
              "HVD_SERVE_AUTOSCALE_HIGH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_JAX_DISTRIBUTED", "0")   # the reference's JAX


def _decisions(mod, kwargs, target, trace):
    p = mod.AutoscalePolicy(**kwargs)
    if target is not None:
        p.target = target
    return [p.observe(d, f) for d, f in trace], p.target


# (constructor kwargs, a preset target, the trace, the decisions the
# reference's own tests expect)
_CASES = {
    "scale-up-needs-patience": (
        dict(min_np=1, max_np=4, high_depth=8, patience=3), None,
        [(20, 1.0)] * 6, [None, None, 2, None, None, 3]),
    "streak-resets-in-band": (
        dict(min_np=1, max_np=4, high_depth=8, patience=3), None,
        [(20, 1.0), (20, 1.0), (4, 1.0), (20, 1.0), (20, 1.0), (20, 1.0)],
        [None, None, None, None, None, 2]),
    "scale-down-needs-idle-batch": (
        dict(min_np=1, max_np=4, low_depth=1, low_fill=0.5, patience=2), 3,
        [(0, 0.9), (0, 0.9), (0, 0.2), (0, 0.2)], [None, None, None, 2]),
    "clamps-to-bounds": (
        dict(min_np=2, max_np=3, patience=1), None,
        [(0, 0.0), (99, 1.0), (99, 1.0), (0, 0.0), (0, 0.0)],
        [None, 3, None, 2, None]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_policy_cases_match_reference(case):
    kwargs, target, trace, want = _CASES[case]
    got = _decisions(autoscale, kwargs, target, trace)
    assert got == _decisions(jautoscale, kwargs, target, trace)
    assert got[0] == want


@pytest.mark.parametrize("kwargs", [
    dict(min_np=4, max_np=2), dict(min_np=1, max_np=4, high_depth=1,
                                   low_depth=1)], ids=["bounds", "band"])
def test_policy_refuses_what_the_reference_refuses(kwargs):
    with pytest.raises(ValueError) as want:
        jautoscale.AutoscalePolicy(**kwargs)
    with pytest.raises(ValueError) as got:
        autoscale.AutoscalePolicy(**kwargs)
    assert str(got.value) == str(want.value)


def test_policy_defaults_are_the_references():
    for name in ("DEFAULT_HIGH_DEPTH", "DEFAULT_LOW_DEPTH",
                 "DEFAULT_LOW_FILL", "DEFAULT_PATIENCE"):
        assert getattr(autoscale, name) == getattr(jautoscale, name)


@settings(max_examples=60, deadline=None, database=None)
@given(min_np=st.integers(1, 3), extra=st.integers(0, 3),
       band=st.tuples(st.integers(0, 4), st.integers(1, 12)),
       low_fill=st.floats(0.0, 1.0), patience=st.integers(0, 4),
       trace=st.lists(st.tuples(st.integers(0, 30), st.floats(0.0, 1.0)),
                      max_size=40))
def test_policy_traces_match_reference(min_np, extra, band, low_fill,
                                       patience, trace):
    kwargs = dict(min_np=min_np, max_np=min_np + extra, low_depth=band[0],
                  high_depth=band[0] + band[1], low_fill=low_fill,
                  patience=patience)
    assert _decisions(autoscale, kwargs, None, trace) == \
        _decisions(jautoscale, kwargs, None, trace)


# ---------------------------------------------------------------------------
# The driver's autoscale branch against the reference's

class _Proc:
    code = None

    def poll(self):
        return self.code

    def kill(self):
        self.code = -9


# Depth 20 breaches the band, (0, 0.1) is idle; patience 2.
_TRACE = ([b"not json", {"queue_depth": 20, "batch_fill": 1.0}]
          + [{"queue_depth": 20, "batch_fill": 1.0}] * 3
          + [{"queue_depth": 4, "batch_fill": 0.9}]
          + [{"queue_depth": 0, "batch_fill": 0.1}] * 4
          + [{"queue_depth": 20}, {"batch_fill": 0.5}])


def _drive(mod, drv, policy):
    """Three workers on one host; the trace pushed one sample at a time,
    a new epoch whenever the driver says the target moved. Returns what
    each step left behind, and which assignments carried a store's
    address."""
    drv.autoscale = policy
    for i in range(3):
        drv.workers[f"w{i}"] = mod._Worker(f"w{i}", "localhost", i, _Proc(),
                                           0)
    desired = {"localhost": 3}
    log, stores = [], []

    def table():
        rows, addr = {}, set()
        for path, val in drv.rdv.scan(f"/assign-{drv.epoch}/").items():
            v = val.decode()
            if v != "exit":
                v = json.loads(v)
                v.pop("controller", None)
                v.pop("scope", None)
                if v.pop("jax_coord", None) is not None:
                    addr.add(path)
            rows[path] = v
        stores.append(addr)
        return (drv.epoch, rows, sorted(drv._spares),
                dict(drv._active_ranks))

    drv._new_epoch(desired)
    log.append(table())
    for sample in _TRACE:
        raw = sample if isinstance(sample, bytes) else \
            json.dumps(sample).encode()
        drv.rdv.put("/ctl/serve_load/w0", raw)
        moved = drv._check_serve_load()
        assert not drv.rdv.scan("/ctl/serve_load")      # consumed
        if moved:
            drv._new_epoch(desired)
        log.append((moved, drv._target_np, drv.stats["autoscale_events"],
                    drv.stats["target_np"], table()))
    return log, stores


def test_driver_autoscale_matches_reference():
    ref = jdriver.ElasticDriver(["true"], JFixedHosts({}), 1, 3)
    port = driver.ElasticDriver(["true"], FixedHosts({}), 1, 3)
    try:
        want, ref_stores = _drive(jdriver, ref, jautoscale.AutoscalePolicy(
            1, 3, high_depth=8, patience=2))
        got, stores = _drive(driver, port, autoscale.AutoscalePolicy(
            1, 3, high_depth=8, patience=2))
        published = json.loads(port.rdv.get("/ctl/elastic_stats"))
    finally:
        for d in (ref, port):
            d.workers.clear()
            d.stop()
    assert got == want
    # up to 2 and 3, down to 2 and 1: four events, the target back at 1
    assert [e[1] for e in want if e[0]] == [2, 3, 2, 1]
    assert want[-1][2] == 4
    # every epoch's active set is capped at the target; under autoscale
    # the rest park as spares, none exits
    sizes = [(len(t[-1][3]), len(t[-1][2])) for t in want[1:] if t[0]]
    assert sizes == [(2, 1), (3, 0), (2, 1), (1, 2)]
    # 12 samples, 10 well-formed; the port publishes its count
    assert port.stats["serve_loads"] == published["serve_loads"] == 10
    assert published["target_np"] == 1 and published["autoscale_events"] == 4
    # the port hosts a store for each epoch of two or more workers (a
    # one-worker epoch meets in a HashStore); the reference, its JAX
    # service off, publishes none
    assert not any(ref_stores)
    tables = [want[0]] + [e[-1] for e in want[1:]]
    for t, addr in zip(tables, stores):
        active = {p for p, a in t[1].items()
                  if a != "exit" and not a.get("spare")}
        assert addr == (active if len(active) > 1 else set()), t


def test_report_serve_load_reaches_the_drivers_kv(monkeypatch):
    port = driver.ElasticDriver(["true"], FixedHosts({}), 1, 2)
    try:
        port.autoscale = autoscale.AutoscalePolicy(1, 2, patience=1)
        monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", f"127.0.0.1:{port.rdv_port}")
        monkeypatch.setenv("HVD_RENDEZVOUS_SECRET", port.secret.hex())
        sent = {}
        for name, mod in (("port", worker), ("reference", jworker)):
            monkeypatch.setenv("HVD_WORKER_ID", f"localhost-0-{name}")
            mod.report_serve_load(12, 0.75, 0.5)
            sent[name] = port.rdv.get(f"/ctl/serve_load/localhost-0-{name}")
        assert sent["port"] == sent["reference"]
        assert json.loads(sent["port"]) == {
            "queue_depth": 12, "batch_fill": 0.75, "kv_occupancy": 0.5}
        assert port._check_serve_load() is True     # depth 12 > 8: up
        assert port._target_np == 2 and port.stats["serve_loads"] == 2
        assert not port.rdv.scan("/ctl/serve_load")
        # best effort: no driver, no raise
        monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1:1")
        monkeypatch.setenv("HVD_KV_RETRIES", "0")
        worker.report_serve_load(1, 0.0)
    finally:
        port.stop()


# ---------------------------------------------------------------------------
# The launcher's flag

@pytest.mark.parametrize("argv,env", [
    (["--serve-autoscale", "--serve-autoscale-high", "5"], {}),
    (["--serve-autoscale"], {"HVD_SERVE_AUTOSCALE_HIGH": "6"}),
    ([], {"HVD_SERVE_AUTOSCALE": "1"}),
], ids=["flags", "high-from-env", "env"])
def test_serve_autoscale_flag_builds_the_drivers_policy(argv, env,
                                                        monkeypatch):
    """``tpurun --serve-autoscale --min-np 1 --max-np 3`` gives the
    elastic driver the reference's policy (the same band, bounds and
    patience); the port's driver publishes the policy's start target."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = argv + ["--min-np", "1", "--max-np", "3", "true"]
    built = {}

    def capture(name):
        def run(self):
            built[name] = self
            return 0
        return run

    monkeypatch.setattr(driver.ElasticDriver, "run", capture("port"))
    monkeypatch.setattr(jdriver.ElasticDriver, "run", capture("reference"))
    assert launch.run_commandline(argv) == 0
    assert jdriver.run_elastic(jlaunch.parse_args(argv)) == 0

    def policy(d):
        p = d.autoscale
        return (p.min_np, p.max_np, p.high_depth, p.low_depth, p.low_fill,
                p.patience, p.target)

    assert policy(built["port"]) == policy(built["reference"])
    assert built["port"].stats["target_np"] == 1
    assert built["port"].autoscale.high_depth == (
        5 if "--serve-autoscale-high" in argv
        else int(env.get("HVD_SERVE_AUTOSCALE_HIGH",
                         autoscale.DEFAULT_HIGH_DEPTH)))


def test_no_flag_no_policy(monkeypatch):
    built = []

    def run(self):
        built.append(self)
        return 0

    monkeypatch.setattr(driver.ElasticDriver, "run", run)
    assert launch.run_commandline(["--min-np", "1", "--max-np", "2",
                                   "true"]) == 0
    assert built[0].autoscale is None
    assert (built[0].stats["target_np"], built[0].stats["serve_loads"]) \
        == (0, 0)
