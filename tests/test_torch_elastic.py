"""The port's elastic plane (horovod_tpu_torch/elastic.py and
horovod_tpu_torch/runner/) against the JAX package's on the CPU, in this
process: no test here spawns one.

- States: ``ObjectState`` against ``ObjectState`` and ``TorchState``
  against ``JaxState``, the same numpy-made trees through the same
  mutate/commit/restore sequence, equal values at every stage, an
  in-place update after a commit included (it must not reach the
  committed copy); ``TorchState(model=, optimizer=)``; ``TorchState.sync``
  giving a joiner rank 0's tree.
- ``run_fn`` against the JAX package's ``run_fn`` over gloo threads at 2
  and 4 ranks, on a train fn in the shape of
  ``__graft_entry__._elastic_epoch_exercise``: ``HostsUpdatedInterrupt``
  (no rollback) and ``HorovodInternalError`` (rollback of an in-place
  update made after the commit); each rank's epochs, total and resets
  equal. The reference's states sync through the port's broadcast over
  the thread's world, the one thing its core would do.
- The driver's ``_new_epoch`` and ``_incremental_order`` against the
  reference's over one scripted sequence (join, death, blacklist with
  transient decay, spare park and promotion, scale-down), as
  tests/test_elastic.py drives the reference: equal assignment tables
  (the per-epoch addresses aside), stats, spares and rank maps.
- The KV store's wire both ways (port server, reference client and the
  reverse) with one secret; unsigned or wrongly signed requests get 403;
  ``/metrics`` is served unsigned.
- The transport-failure classifier's accept and reject cases, and
  ``run_fn`` surfacing a deterministic error while retrying a gloo peer
  death.
- ``checkpoint._report_commit`` publishing the committed step to the
  driver, and ``restore_from_checkpoint`` preferring the step the driver
  published over the directory's latest.
- The ``ELASTIC_*`` metric families under the reference's names, kinds,
  labels and buckets.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from horovod_tpu import elastic as jelastic  # noqa: E402
from horovod_tpu import exceptions as jexc  # noqa: E402
from horovod_tpu.observability import metrics as jmetrics  # noqa: E402
from horovod_tpu.runner import http_server as jkv  # noqa: E402
from horovod_tpu.runner.elastic import driver as jdriver  # noqa: E402
from horovod_tpu.runner.elastic.discovery import (  # noqa: E402
    FixedHosts as JFixedHosts)
from horovod_tpu_torch import checkpoint, elastic  # noqa: E402
from horovod_tpu_torch.exceptions import (  # noqa: E402
    HorovodInternalError, HostsUpdatedInterrupt)
from horovod_tpu_torch.graft_entry import _on_ranks  # noqa: E402
from horovod_tpu_torch.observability import metrics  # noqa: E402
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.parallel.mesh import World  # noqa: E402
from horovod_tpu_torch.process_sets import ProcessSet  # noqa: E402
from horovod_tpu_torch.runner import http_server as kv  # noqa: E402
from horovod_tpu_torch.runner.elastic import driver  # noqa: E402
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts  # noqa: E402


@pytest.fixture(autouse=True)
def _not_elastic(monkeypatch):
    """No test here runs under a driver unless it says so."""
    for k in ("HVD_ELASTIC", "HVD_CKPT_STEP", "HVD_RENDEZVOUS_ADDR",
              "HVD_WORKER_ID", "HVD_RENDEZVOUS_SECRET"):
        monkeypatch.delenv(k, raising=False)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy().copy()
    return np.asarray(x).copy()


def _values(tree):
    """The tree's leaves as numpy (tensors, jax arrays, numbers)."""
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_values(v) for v in tree]
    return _np(tree)


def _equal(a, b):
    assert type(a) is type(b) or not isinstance(a, (dict, list)), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(5).astype(np.float32)},
                         {"b": rng.standard_normal(5).astype(np.float32)}]}
    extra = rng.standard_normal(3).astype(np.float32)
    return params, extra


# ---------------------------------------------------------------------------
# States

@pytest.mark.parametrize("kind", ["object", "torch"])
def test_state_sequence_matches_reference(kind):
    """ObjectState against ObjectState (numpy leaves on both sides), and
    TorchState (tensors) against JaxState (jax arrays, a numpy leaf):
    construct, replace a leaf and commit, update leaves in place and
    append to a list after the commit, restore; then the same once more
    without a commit between. Every stage's values are equal."""
    params, extra = _trees(1)
    if kind == "object":
        ref = jelastic.ObjectState(params=params, extra=extra.copy(),
                                   log=[0], step=0)
        port = elastic.ObjectState(params=_trees(1)[0], extra=extra.copy(),
                                   log=[0], step=0)
    else:
        ref = jelastic.JaxState(params=jax.tree.map(jnp.asarray, params),
                                extra=extra.copy(), log=[0], step=0)
        port = elastic.TorchState(
            params=jax.tree.map(torch.from_numpy, _trees(1)[0]),
            extra=torch.from_numpy(extra.copy()), log=[0], step=0)

    def check():
        for name in ("params", "extra", "log", "step"):
            _equal(_values(getattr(port, name)),
                   _values(getattr(ref, name)))

    def bump(state, amount):
        """Replace a leaf (a new object) and move the step."""
        state.params["w"] = state.params["w"] + amount
        state.step += 1

    check()
    for s, amount in ((ref, 1.0), (port, 1.0)):
        bump(s, amount)
        s.commit()
    check()
    # In place after the commit: the committed copy must not move.
    ref.extra += 5.0
    port.extra.add_(5.0) if kind == "torch" else port.extra.__iadd__(5.0)
    if kind == "torch":
        port.params["layers"][1]["b"].add_(2.0)
    else:
        port.params["layers"][1]["b"] += 2.0
        ref.params["layers"][1]["b"] += 2.0
    if kind == "torch":   # JaxState's arrays are immutable: a new one
        ref.params["layers"][1]["b"] = ref.params["layers"][1]["b"] + 2.0
    ref.log.append(1)
    port.log.append(1)
    check()
    ref.restore()
    port.restore()
    check()
    assert port.step == 1 and _np(port.extra)[0] == extra[0]
    for s in (ref, port):
        bump(s, 3.0)
    check()
    ref.restore()
    port.restore()
    check()


def test_torch_state_restores_in_place():
    """A leaf that keeps its shape and dtype is restored into the same
    tensor (an optimizer built over it keeps it); one whose shape changed
    gets a new tensor with the committed value."""
    w = torch.arange(6.0).reshape(2, 3)
    state = elastic.TorchState(params={"w": w, "v": torch.ones(4)})
    w.mul_(0.0)
    state.params["v"] = torch.zeros(7)
    state.restore()
    assert state.params["w"] is w
    assert torch.equal(w, torch.arange(6.0).reshape(2, 3))
    assert torch.equal(state.params["v"], torch.ones(4))


def test_torch_state_model_and_optimizer():
    """``model=``/``optimizer=``, as the JAX package's torch binding takes
    them: two SGD-momentum steps after a commit, then restore: the
    module's parameters and the optimizer's momentum equal the commit's;
    a step after the restore equals the step after the commit."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(8, 4)

    def step():
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()

    step()
    state = elastic.TorchState(model=model, optimizer=opt, epoch=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    mom = [opt.state[p]["momentum_buffer"].clone()
           for p in model.parameters()]
    step()
    after = {k: v.clone() for k, v in model.state_dict().items()}
    step()
    state.epoch = 5
    state.restore()
    assert state.epoch == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for p, m in zip(model.parameters(), mom):
        assert torch.equal(opt.state[p]["momentum_buffer"], m)
    step()
    for k, v in model.state_dict().items():
        assert torch.equal(v, after[k]), k


def test_torch_state_sync_gives_a_joiner_rank0s_tree():
    """Rank 0 holds a params tree, a CPU step tensor and a counter; rank
    1 is a joiner with none of them. After ``sync`` both hold rank 0's
    values, rank 0 in its own tensors."""
    def rank(world):
        ps = ProcessSet.from_world(world)
        if world.rank == 0:
            w = torch.arange(6.0).reshape(2, 3)
            state = elastic.TorchState(params={"w": w},
                                       step=torch.tensor(7.0), it=3)
        else:
            state = elastic.TorchState(it=0)
        state._process_set = ps
        state.sync()
        if world.rank == 0:
            assert state.params["w"] is w
        return (_np(state.params["w"]), float(state.step), state.it)

    a, b = _on_ranks(2, rank, timeout=30)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:] == (7.0, 3)


# ---------------------------------------------------------------------------
# run_fn against the reference's, ranks as gloo threads

class _RefState(jelastic.ObjectState):
    """The reference's ObjectState, its sync broadcast over the thread's
    world (the reference's would go through its C++ core)."""

    def sync(self):
        self._attrs = torch_ops.broadcast_object(
            self._attrs, root_rank=0, process_set=self._process_set)
        self.save()


def _run(n, side, kind, error):
    """Each rank's (epochs, total, resets) of ``run_fn`` on the train fn
    of ``_elastic_epoch_exercise``'s shape: three epochs of an allreduce
    of ones into ``total``; after the first commit, once, ``total`` gets
    +100 in place and the error is raised. The reset builds a new world
    over the same store."""
    mod = jelastic if side == "ref" else elastic
    exc = jexc if side == "ref" else None
    err = {"hosts": (jexc.HostsUpdatedInterrupt if side == "ref"
                     else HostsUpdatedInterrupt),
           "internal": (jexc.HorovodInternalError if side == "ref"
                        else HorovodInternalError)}[error]
    del exc

    def rank(world):
        cur = {"world": world, "epoch": 0}
        if side == "ref":
            state = _RefState(total=np.zeros(2, np.float32), epoch=0)
        elif kind == "torch":
            state = elastic.TorchState(total=torch.zeros(2), epoch=0)
        else:
            state = elastic.ObjectState(total=np.zeros(2, np.float32),
                                        epoch=0)
        state._process_set = ProcessSet.from_world(world)
        resets = []

        def reset():
            cur["epoch"] += 1
            w = cur["world"]
            cur["world"] = World(
                dist.PrefixStore(f"epoch{cur['epoch']}", w.store), w.rank,
                w.size, "cpu", timeout=30)
            state._process_set = ProcessSet.from_world(cur["world"])
            resets.append(1)

        def train(state):
            while state.epoch < 3:
                out = torch_ops.hvd_allreduce(
                    torch.ones(2), op=torch_ops.Sum,
                    process_set=state._process_set)
                total = state.total
                state.total = total + (out if torch.is_tensor(total)
                                       else out.numpy())
                state.epoch += 1
                state.commit()
                if state.epoch == 1 and not resets:
                    state.total += 100.0      # in place, uncommitted
                    raise err()
            return state.epoch

        epochs = mod.run_fn(train, reset)(state)
        return epochs, _np(state.total).tolist(), len(resets)

    return _on_ranks(n, rank, timeout=30)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("error", ["hosts", "internal"])
@pytest.mark.parametrize("kind", ["object", "torch"])
def test_run_fn_matches_reference(n, error, kind):
    ref = _run(n, "ref", None, error)
    got = _run(n, "port", kind, error)
    assert got == ref
    want = 3.0 * n + (100.0 if error == "hosts" else 0.0)
    assert ref == [(3, [want, want], 1)] * n


def test_classifier_accepts_transport_deaths_only():
    accept = [
        dist.DistBackendError("NCCL communicator was aborted on rank 0."),
        dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1, "
                              "remote process exited or there was a "
                              "network error, NCCL version 2.21"),
        dist.DistNetworkError("Connection reset by peer"),
        dist.DistStoreError("Broken pipe"),
        RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534]"
                     " Connection closed by peer [127.0.0.1]:4242"),
        RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buf"
                     "fer.cc:81] Timed out waiting 30000ms for recv "
                     "operation to complete"),
    ]
    reject = [
        RuntimeError("Connection reset by peer"),      # not a collective's
        ValueError("NCCL communicator was aborted"),   # not an error type
        dist.DistBackendError("Tensors must be CUDA and dense"),
        RuntimeError("[gloo] size mismatch: 4 vs 8"),
        HorovodInternalError("collective failed"),     # caught before
    ]
    assert [elastic._is_transport_failure(e) for e in accept] == \
        [True] * len(accept)
    assert [elastic._is_transport_failure(e) for e in reject] == \
        [False] * len(reject)


def test_run_fn_retries_a_peer_death_and_surfaces_a_deterministic_error():
    """A gloo peer death raised outside torch_ops rolls back and resets;
    a DistBackendError without a transport marker surfaces at once."""
    def run(error):
        world = World(dist.HashStore(), 0, 1, "cpu")
        state = elastic.TorchState(x=torch.zeros(1), epoch=0)
        state._process_set = ProcessSet.from_world(world)
        resets = []

        def train(state):
            state.x.add_(1.0)
            if not resets:
                raise error
            return float(state.x)

        return elastic.run_fn(train, lambda: resets.append(1))(state), \
            len(resets)

    death = RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc"
                         ":534] Connection closed by peer [127.0.0.1]:1")
    assert run(death) == (1.0, 1)       # the first +1 was rolled back
    with pytest.raises(dist.DistBackendError, match="invalid argument"):
        run(dist.DistBackendError("invalid argument"))


# ---------------------------------------------------------------------------
# The driver's epoch tables against the reference's

class _Proc:
    def __init__(self):
        self.code = None

    def poll(self):
        return self.code

    def kill(self):
        self.code = -9


T0 = 1000.0
# The driver stats both drivers keep. The reference's autoscale_events and
# target_np wait for the port's autoscaler (ROADMAP Queue A item 1); the
# port's heartbeat_misses is tested on its own.
_SHARED_STATS = ("promotions", "incremental_epochs", "full_epochs",
                 "driver_evictions", "last_ckpt_step")


def _script(mod, drv):
    """The scripted sequence; returns what each step left behind, and
    for each epoch the assignments that carry a store's address. Two
    local hostnames stand in for two hosts (no name lookup)."""
    procs, log, stores = {}, [], []

    def spawn(wid, host, slot, epoch):
        procs[wid] = _Proc()
        drv.workers[wid] = mod._Worker(wid, host, slot, procs[wid], epoch)

    def table():
        e, rows, addr = drv.epoch, {}, set()
        for path, val in drv.rdv.scan(f"/assign-{e}/").items():
            v = val.decode()
            if v != "exit":
                v = json.loads(v)
                # the reference's core addresses (its controller's free
                # port, its endpoint scope): the port's carry neither
                v.pop("controller", None)
                v.pop("scope", None)
                if v.pop("jax_coord", None) is not None:
                    addr.add(path)
            rows[path] = v
        stores.append(addr)
        stats = {k: drv.stats[k] for k in _SHARED_STATS}
        return (e, rows, stats, sorted(drv._spares),
                dict(drv._active_ranks), dict(drv._rank_hosts))

    desired = {"localhost": 3, "127.0.0.1": 2}
    # join: five workers for four ranks and one hot spare
    for i, (h, s) in enumerate([("localhost", 0), ("localhost", 1),
                                ("localhost", 2), ("127.0.0.1", 0),
                                ("127.0.0.1", 1)]):
        spawn(f"w{i}", h, s, 0)
    drv._new_epoch(desired)
    log.append(table())
    # death of an active rank: the parked spare is promoted into its rank
    procs["w0"].code = 1
    drv._record_failure("localhost", now=T0)
    drv._new_epoch(desired)
    log.append(table())
    # the respawn refills the spare pool; a survivor order check
    spawn("w5", "localhost", 0, drv.epoch + 1)
    drv._new_epoch(desired)
    log.append(table())
    log.append([w.id for w in drv._incremental_order(
        [drv.workers[w] for w in ("w4", "w5", "w1", "w3")],
        drv._active_ranks) or []])
    # three driver evictions (transient) blacklist 127.0.0.1; the
    # blacklist decays once they age out, well before the cooldown
    for i in range(mod.FAILURES_TO_BLACKLIST):
        drv._record_failure("127.0.0.1", transient=True, now=T0 + i)
    log.append((drv._blacklisted("127.0.0.1", T0 + 3),
                drv._blacklisted("127.0.0.1",
                                 T0 + mod.TRANSIENT_DECAY_S + 3)))
    # while 127.0.0.1 is out of the desired set, its workers exit
    drv._new_epoch({"localhost": 3})
    log.append(table())
    # scale-down to one host slot: min_np keeps two ranks
    drv._new_epoch({"localhost": 1})
    log.append(table())
    return log, stores


def test_driver_epochs_match_reference(monkeypatch):
    monkeypatch.setenv("HVD_JAX_DISTRIBUTED", "0")  # the reference's JAX
    ref = jdriver.ElasticDriver(["true"], JFixedHosts({}), 2, 4,
                                hot_spares=1, cooldown_range=(30.0, 60.0))
    port = driver.ElasticDriver(["true"], FixedHosts({}), 2, 4,
                                hot_spares=1, cooldown_range=(30.0, 60.0))
    try:
        want, ref_stores = _script(jdriver, ref)
        got, stores = _script(driver, port)
    finally:
        for d in (ref, port):
            d.workers.clear()       # fakes: nothing to terminate
            d.stop()
    assert got == want
    assert port.stats["heartbeat_misses"] == 0
    # the spare was promoted incrementally, and the blacklist decayed
    assert want[1][2]["promotions"] == 1 and want[4] == (True, False)
    # The port publishes a store for every epoch (each has two or more
    # ranks here) to every rank, and to no spare; the reference, its
    # JAX service off, publishes none.
    assert not any(ref_stores)
    assert stores == [{p for p, a in t[1].items()
                       if a != "exit" and not a.get("spare")}
                      for t in (want[0], want[1], want[2], want[5],
                                want[6])]


def test_stale_heartbeat_is_killed_counted_and_published(monkeypatch):
    """A worker whose alive-sequence stops changing for longer than the
    stale window is killed as a transient failure, as the reference's
    driver does, and counted in ``heartbeat_misses``, which a worker
    reads into ``hvd_elastic_heartbeat_misses``."""
    from horovod_tpu_torch.runner.elastic import worker

    monkeypatch.setenv("HVD_JAX_DISTRIBUTED", "0")  # the reference's JAX
    ref = jdriver.ElasticDriver(["true"], JFixedHosts({}), 1, 2,
                                extra_env={"HVD_PEER_TIMEOUT_MS": "1000"})
    port = driver.ElasticDriver(["true"], FixedHosts({}), 1, 2,
                                extra_env={"HVD_PEER_TIMEOUT_MS": "1000"})
    try:
        seen = []
        for mod, drv in ((jdriver, ref), (driver, port)):
            procs = [_Proc(), _Proc()]
            for i, p in enumerate(procs):
                drv.workers[f"w{i}"] = mod._Worker(f"w{i}", "localhost", i,
                                                   p, 0)
                drv.rdv.put(f"/ctl/alive/w{i}", b"1")
            drv._check_liveness(T0)              # first sight of both
            drv.rdv.put("/ctl/alive/w1", b"2")   # w1 heartbeats, w0 not
            # the stale window is max(5 s, ten peer timeouts) = 10 s
            marks = [drv._check_liveness(T0 + 9.0)]
            drv.rdv.put("/ctl/alive/w1", b"3")
            marks.append(drv._check_liveness(T0 + 10.5))
            seen.append((marks, [p.code for p in procs],
                         drv.stats["driver_evictions"],
                         [tr for _, tr in drv._host_failures["localhost"]]))
        # w0 killed at 10.5 s and not at 9 s, as one transient failure
        assert seen[0] == seen[1] == ([False, True], [-9, None], 1, [True])
        assert port.stats["heartbeat_misses"] == 1
        port._publish_stats()
        monkeypatch.setenv("HVD_RENDEZVOUS_ADDR",
                           f"127.0.0.1:{port.rdv_port}")
        monkeypatch.setenv("HVD_RENDEZVOUS_SECRET", port.secret.hex())
        monkeypatch.setattr(worker, "_driver_stats_ts", 0.0)
        was = metrics.enabled()
        metrics.enable()
        try:
            assert worker.fetch_driver_stats()["heartbeat_misses"] == 1
            text = metrics.render_text()
        finally:
            if not was:
                metrics.disable()
        assert "hvd_elastic_heartbeat_misses 1" in text, text
    finally:
        for d in (ref, port):
            d.workers.clear()
            d.stop()


# ---------------------------------------------------------------------------
# The launcher's surface

def test_launcher_flags_set_only_variables_the_port_reads():
    """Every variable a launcher flag or config-file key exports has a
    reader in the port outside the launcher's own parsing; the
    reference's tunables of its C++ core are refused."""
    import pathlib

    from horovod_tpu_torch.runner import config_parser, launch

    root = pathlib.Path(elastic.__file__).parent
    skip = {root / "runner" / "config_parser.py",
            root / "runner" / "launch.py"}
    text = "".join(f.read_text() for f in root.rglob("*.py")
                   if f not in skip)
    for attr, (var, _) in config_parser.ARG_TO_ENV.items():
        assert f'"{var}"' in text, (attr, var)
    for section, keys in config_parser._FILE_SECTIONS.items():
        for attr in keys.values():
            assert attr in config_parser.ARG_TO_ENV or \
                attr == "serve_autoscale", (section, attr)
    for flag in ("--fusion-threshold-mb", "--cycle-time-ms", "--wire",
                 "--compression", "--autotune", "--ssh-port",
                 "--metrics-port", "--timeline-filename"):
        with pytest.raises(SystemExit):
            launch.parse_args([flag, "1", "true"])
    args = launch.parse_args(["--bucket", "1", "--peer-timeout-ms", "900",
                              "--ckpt-async", "true"])
    assert config_parser.args_to_env(args) == {
        "HVD_BUCKET": "1", "HVD_PEER_TIMEOUT_MS": "900",
        "HVD_CKPT_ASYNC": "1"}


@pytest.mark.parametrize("argv", [
    ["-H", "localhost:1,otherhost:1", "true"],
    ["--min-np", "1", "--host-discovery-script", "echo otherhost:1",
     "true"],
    ["--serve-autoscale", "true"],
], ids=["static-remote", "elastic-remote", "serve-autoscale"])
def test_launcher_refuses_what_the_port_cannot_run(argv):
    """A remote host (item 16) and queue-depth autoscale (item 1) raise
    before any worker starts, naming the item."""
    from horovod_tpu_torch.runner import launch

    with pytest.raises(NotImplementedError, match="Queue A item 1"):
        launch.run_commandline(argv)


# ---------------------------------------------------------------------------
# The KV store's wire

def _status(method, url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


@pytest.mark.parametrize("server,client", [(kv, jkv), (jkv, kv)],
                         ids=["port-server", "reference-server"])
def test_kv_wire_both_ways(server, client):
    secret = os.urandom(32)
    srv = server.RendezvousServer(secret_key=secret, addr="127.0.0.1")
    addr = f"127.0.0.1:{srv.start()}"
    try:
        client.put_kv(addr, "ctl", "ckpt/w0", b"3", secret_key=secret)
        assert srv.get("/ctl/ckpt/w0") == b"3"
        srv.put("/assign-0/w0", b'{"rank": 0}')
        assert client.read_kv(addr, "assign-0", "w0",
                              secret_key=secret) == b'{"rank": 0}'
        with pytest.raises(urllib.error.HTTPError, match="404"):
            client.read_kv(addr, "assign-0", "nobody", secret_key=secret,
                           wait=True, timeout=0.3)
        url = f"http://{addr}/ctl/epoch"
        assert _status("PUT", url, b"999")[0] == 403
        assert _status("GET", f"http://{addr}/assign-0/w0")[0] == 403
        assert _status("DELETE", f"http://{addr}/assign-0/w0")[0] == 403
        with pytest.raises(urllib.error.HTTPError, match="403"):
            client.put_kv(addr, "ctl", "epoch", b"9",
                          secret_key=os.urandom(32))
        assert srv.get("/ctl/epoch") is None
        code, body = _status("GET", f"http://{addr}/metrics")
        assert code == 200 and body.startswith(b"# HELP")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The checkpoint and the driver

def test_report_commit_and_restore_prefer_the_published_step(tmp_path,
                                                             monkeypatch):
    """Under an elastic job the set root's commit reaches the driver's
    KV; the driver folds it into its stats; ``restore_from_checkpoint``
    then takes the step the assignment carries (``HVD_CKPT_STEP``), not
    the directory's latest."""
    drv = driver.ElasticDriver(["true"], FixedHosts({}), 1, 1)
    try:
        monkeypatch.setenv("HVD_ELASTIC", "1")
        monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", f"127.0.0.1:{drv.rdv_port}")
        monkeypatch.setenv("HVD_RENDEZVOUS_SECRET", drv.secret.hex())
        monkeypatch.setenv("HVD_WORKER_ID", "localhost-0-test")
        ps = ProcessSet.from_world(World(dist.HashStore(), 0, 1, "cpu"))
        for step in (1, 2):
            checkpoint.save(tmp_path, step,
                            {"w": torch.full((3,), float(step))},
                            process_set=ps, async_=False)
        assert drv.rdv.scan("/ctl/ckpt/") == {
            "/ctl/ckpt/localhost-0-test": b"2"}
        drv._check_ckpt_commits()
        assert drv.stats["last_ckpt_step"] == 2 and not drv.rdv.scan(
            "/ctl/ckpt/")
        like = {"w": torch.zeros(3)}
        monkeypatch.setenv("HVD_CKPT_STEP", "1")     # the assignment's
        out, step = elastic.restore_from_checkpoint(like, tmp_path)
        assert step == 1 and torch.equal(out["w"], torch.ones(3))
        monkeypatch.delenv("HVD_ELASTIC")
        out, step = elastic.restore_from_checkpoint(like, tmp_path)
        assert step == 2 and torch.equal(out["w"], torch.full((3,), 2.0))
    finally:
        drv.stop()


def test_elastic_metrics_are_the_references():
    for name in ("ELASTIC_EVENTS", "ELASTIC_RESET_SECONDS",
                 "ELASTIC_HEARTBEAT_MISSES", "ELASTIC_EVICTIONS",
                 "ELASTIC_KV_RETRIES", "ELASTIC_PROMOTIONS"):
        a, b = getattr(metrics, name), getattr(jmetrics, name)
        assert (a.name, a.kind, a.labelnames) == \
            (b.name, b.kind, tuple(b.labelnames)), name
        if a.kind == "histogram":
            assert a.buckets == b._buckets, name
    was = metrics.enabled()
    metrics.enable()
    try:
        metrics.ELASTIC_EVENTS.labels(event="reset").inc()
        text = metrics.render_text()
    finally:
        if not was:
            metrics.disable()
    assert 'hvd_elastic_events_total{event="reset"}' in text
