"""The port's pipeline parallelism (horovod_tpu_torch/parallel/pipeline.py)
against the JAX package's (horovod_tpu/parallel/pipeline.py) on the
same inputs, float32.

Ranks are threads, each with a gloo ``World`` over one store
(``torch_train_parity.run_worlds``); the reference runs on the
8-device CPU mesh. Each JAX reference is computed once per file and
mesh shape, every schedule of a mesh in one jitted program
(module-level caches), and so are the port's results of a mesh.

- ``pipeline_apply`` gpipe and interleaved:2 at S = 2 and 4 against
  JAX's ``pipeline_apply``, atol 1e-5, from this rank's slice
  (``shard_stage_params``) or from the whole stage-leading tree.
- ``make_pipeline_value_and_grad`` under gpipe, 1f1b, interleaved:2 and
  zb at (S, dp) = (2, 1), (4, 1) and (2, 2) against JAX's on the same
  mesh shape, and at (4, 2), the rest of the reference's own matrix
  (tests/test_pipeline.py, without S = 8), against its sequential
  oracle; the loss within 1e-5 and the gradients within 1e-4, the
  reference test's tolerances.
- Four ``tiny`` transformer blocks as four stages against JAX's
  ``forward``, within 2e-4, as tests/test_pipeline.py holds its own.
- One ``make_pipeline_train_step`` step with SGD against JAX's with
  ``optax.sgd``.
- The stage-dim, divisibility and virtual-slice errors, with the
  reference's words; zb's fallbacks counted by reason, and ``single_stage``
  still correct; the ``PIPELINE_*`` spans with metrics on.
- A rank that raises inside ``stage_fn`` fails the call within the
  groups' timeout, and no rank is left blocked.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu.parallel import pipeline as jpipe  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.observability import metrics, spans  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    create_mesh, make_pipeline_train_step, make_pipeline_value_and_grad,
    pipeline_apply, shard_batch, shard_stage_params)
from horovod_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

from .torch_train_parity import run_worlds  # noqa: E402

TOL_OUT, TOL_LOSS, TOL_GRAD = 1e-5, 1e-5, 1e-4
D, B = 8, 16
SCHEDULES = ["gpipe", "1f1b", "interleaved", "zb"]
FWD_M = 4


def _virtual(schedule):
    return 2 if schedule == "interleaved" else 1


def _case(S, schedule):
    """The reference test's inputs (tests/test_pipeline.py
    ``_schedule_parity_setup``): W [S·V, D, D], x, y [B, D]."""
    rng = np.random.default_rng(7)
    W = (rng.normal(size=(S * _virtual(schedule), D, D)).astype(np.float32)
         / np.sqrt(D)).astype(np.float32)   # JAX rounds it so
    x = rng.normal(size=(B, D)).astype(np.float32)
    return W, x, np.roll(x, 1, axis=1) * 0.5


def _jax_mesh(S, dp):
    cpus = jax.devices("cpu")
    if dp > 1:
        return Mesh(np.asarray(cpus[:S * dp]).reshape(S, dp),
                    ("pipe", "data"))
    return Mesh(np.asarray(cpus[:S]), ("pipe",))


def _jstage(p, h):
    return jnp.tanh(h @ p["w"])


def _jloss(out, batch):
    return jnp.mean((out - batch["y"]) ** 2)


def _tstage(p, h):
    return torch.tanh(h @ p["w"])


def _tloss(out, batch):
    return ((out - batch["y"]) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _jax_refs(S, dp):
    """{schedule: (loss, grad [S·V, D, D] in network order)} and, at
    dp = 1, {"fwd <schedule>": outputs} of gpipe and interleaved:2 with
    FWD_M microbatches, all from one jitted program on the mesh."""
    mesh = _jax_mesh(S, dp)
    batch_axis = "data" if dp > 1 else None
    cases = {s: _case(S, s) for s in SCHEDULES}

    def body(cases):
        out = {}
        for s, (W, x, y) in cases.items():
            V = _virtual(s)
            vg = jpipe.make_pipeline_value_and_grad(
                _jstage, _jloss, mesh, n_microbatches=S,
                batch_axis=batch_axis, schedule=s,
                virtual_stages=V if V > 1 else None)
            loss, g = vg({"w": W}, {"x": x, "y": y})
            out[s] = (loss, g["w"])
            if dp == 1 and s in ("gpipe", "interleaved"):
                out["fwd " + s] = jpipe.pipeline_apply(
                    _jstage, {"w": W}, x, mesh, n_microbatches=FWD_M,
                    schedule=s)
        return out

    got = jax.jit(body)({s: tuple(map(jnp.asarray, c))
                         for s, c in cases.items()})
    return jax.tree.map(np.asarray, got)


@functools.lru_cache(maxsize=None)
def _seq_oracle(S, schedule):
    """The reference test's sequential composition, value and grad."""
    W, x, y = _case(S, schedule)

    def seq_loss(Wf):
        h = jnp.asarray(x)
        for j in range(W.shape[0]):
            h = jnp.tanh(h @ Wf[j])
        return jnp.mean((h - jnp.asarray(y)) ** 2)

    loss, g = jax.jit(jax.value_and_grad(seq_loss))(jnp.asarray(W))
    return float(loss), np.asarray(g)


def _rows(S, V, s):
    return tpipe._rows(s, S, V)


@functools.lru_cache(maxsize=None)
def _port(S, dp):
    """Per rank: (pipe index, data index, {schedule: (loss, grad)},
    {"fwd <schedule>": outputs}) of the port on S·dp thread ranks."""
    batch_axis = "data" if dp > 1 else None

    def rank(world):
        axes = {"pipe": S, "data": dp} if dp > 1 else {"pipe": S}
        mesh = create_mesh(axes, world)
        res = {}
        for s in SCHEDULES:
            W, x, y = _case(S, s)
            V = _virtual(s)
            params = shard_stage_params({"w": W}, mesh, virtual_stages=V)
            batch = {"x": torch.tensor(x), "y": torch.tensor(y)}
            if dp > 1:
                batch = shard_batch(batch, mesh, "data")
            vg = make_pipeline_value_and_grad(
                _tstage, _tloss, mesh, n_microbatches=S,
                batch_axis=batch_axis, schedule=s,
                virtual_stages=V if V > 1 else None)
            loss, g = vg(params, batch)
            res[s] = (loss.item(), g["w"].numpy())
            if dp == 1 and s in ("gpipe", "interleaved"):
                # this rank's slice, and the whole tree it cuts for itself
                for key, p in (("fwd ", params),
                               ("fwd whole ", {"w": torch.tensor(W)})):
                    res[key + s] = pipeline_apply(
                        _tstage, p, batch["x"], mesh, n_microbatches=FWD_M,
                        schedule=s).numpy()
        coords = mesh.coords()
        return coords[0], coords[1] if dp > 1 else 0, res

    return run_worlds(S * dp, rank)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_apply_matches_jax(schedule, S):
    want = _jax_refs(S, 1)["fwd " + schedule]
    W, x, _ = _case(S, schedule)
    seq = x
    for j in range(W.shape[0]):
        seq = np.tanh(seq @ W[j])
    np.testing.assert_allclose(want, seq, atol=TOL_OUT, rtol=0)
    for _, _, res in _port(S, 1):   # the outputs on every rank
        np.testing.assert_allclose(res["fwd " + schedule], want,
                                   atol=TOL_OUT, rtol=0)
        np.testing.assert_array_equal(res["fwd whole " + schedule],
                                      res["fwd " + schedule])


def _check_vg(S, dp, schedule, want_loss, want_grad):
    V = _virtual(schedule)
    for s, _, res in _port(S, dp):
        loss, g = res[schedule]
        assert abs(loss - want_loss) <= TOL_LOSS, (schedule, loss, want_loss)
        np.testing.assert_allclose(g, want_grad[_rows(S, V, s)],
                                   atol=TOL_GRAD, rtol=0)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("S,dp", [(2, 1), (4, 1), (2, 2)])
def test_value_and_grad_matches_jax(schedule, S, dp):
    want_loss, want_grad = _jax_refs(S, dp)[schedule]
    _check_vg(S, dp, schedule, float(want_loss), want_grad)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_value_and_grad_matches_sequential_at_4x2(schedule):
    _check_vg(4, 2, schedule, *_seq_oracle(4, schedule))


def test_pipelined_transformer_matches_jax_forward():
    """Four ``tiny`` blocks as four stages (embedding and head outside)
    against JAX's ``forward`` on the same params and tokens."""
    import dataclasses

    jcfg = dataclasses.replace(jtfm.tiny(), n_layers=4, dtype="float32")
    tcfg = dataclasses.replace(ttfm.tiny(), n_layers=4, dtype="float32")
    jparams = jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 16))
    want = np.asarray(jax.jit(jtfm.forward, static_argnums=2)(
        jparams, jnp.asarray(tokens, jnp.int32), jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    stacked = {k: torch.stack([layer[k] for layer in params["layers"]])
               for k in ("wqkv", "wo", "w_in", "w_out")}
    for ln in ("ln1", "ln2"):
        stacked[ln] = {k: torch.stack([layer[ln][k]
                                       for layer in params["layers"]])
                       for k in ("scale", "bias")}
    tok = torch.tensor(tokens)
    x = params["embed"][tok] + params["pos_embed"][:16][None]

    def rank(world):
        mesh = create_mesh({"pipe": 4}, world)
        sp = shard_stage_params(stacked, mesh)
        with torch.no_grad():
            h = pipeline_apply(lambda layer, h: ttfm.apply_block(
                layer, h, tcfg), sp, x, mesh, n_microbatches=4)
            h = ttfm._layer_norm(h, params["final_ln"])
            return torch.einsum("bsd,vd->bsv", h, params["embed"]).numpy()

    for got in run_worlds(4, rank):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_train_step_sgd_matches_jax():
    """One 1f1b step at S = 2, M = 4 with SGD(0.1): the updated stage
    params against JAX's ``make_pipeline_train_step`` with
    ``optax.sgd(0.1)``, and the loss."""
    S, lr = 2, 0.1
    W, x, y = _case(S, "1f1b")
    tx = optax.sgd(lr)
    mesh = _jax_mesh(S, 1)
    jstep = jpipe.make_pipeline_train_step(_jstage, _jloss, tx, mesh,
                                           n_microbatches=4, schedule="1f1b")
    jp = jpipe.shard_stage_params({"w": W}, mesh)
    jp, _, jloss = jstep(jp, tx.init(jp), {"x": jnp.asarray(x),
                                           "y": jnp.asarray(y)})
    want = np.asarray(jp["w"])

    def rank(world):
        mesh = create_mesh({"pipe": S}, world)
        p = shard_stage_params({"w": W}, mesh)
        opt = torch.optim.SGD([p["w"].requires_grad_()], lr=lr)
        step = make_pipeline_train_step(_tstage, _tloss, opt, mesh,
                                        n_microbatches=4, schedule="1f1b")
        loss = step(p, {"x": torch.tensor(x), "y": torch.tensor(y)})
        return mesh.coords()[0], loss.item(), p["w"].detach().numpy()

    for s, loss, got in run_worlds(S, rank):
        assert abs(loss - float(jloss)) <= TOL_LOSS
        np.testing.assert_allclose(got, want[s:s + 1], atol=1e-6, rtol=0)


def _errors(n, fn):
    """The ValueError text each of n ranks meets in ``fn(mesh)``."""
    def rank(world):
        mesh = create_mesh({"pipe": n}, world)
        with pytest.raises(ValueError) as e:
            fn(mesh)
        return str(e.value)

    return run_worlds(n, rank)


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn(_jax_mesh(4, 1))
    return str(e.value)


def test_stage_dim_error_is_the_reference_error():
    W8 = np.zeros((8, 4, 4), np.float32)
    want = _jax_error(lambda m: jpipe.shard_stage_params({"w": W8}, m))
    assert "stage" in want
    assert _errors(4, lambda m: shard_stage_params({"w": W8}, m)) == [want] * 4
    want = _jax_error(lambda m: jpipe.pipeline_apply(
        lambda p, h: h, {"w": jnp.zeros((8, 4, 4))}, jnp.zeros((8, 4)), m,
        n_microbatches=4))
    assert _errors(4, lambda m: pipeline_apply(
        lambda p, h: h, {"w": torch.zeros(8, 4, 4)}, torch.zeros(8, 4), m,
        n_microbatches=4)) == [want] * 4


def test_divisibility_error_is_the_reference_error():
    W = np.zeros((4, 4, 4), np.float32)
    want = _jax_error(lambda m: jpipe.pipeline_apply(
        lambda p, h: h @ p["w"], jpipe.shard_stage_params({"w": W}, m),
        jnp.zeros((16, 4)), m, n_microbatches=5))
    assert "nearest valid n_microbatches is 4" in want
    assert _errors(4, lambda m: pipeline_apply(
        lambda p, h: h @ p["w"], shard_stage_params({"w": W}, m),
        torch.zeros(16, 4), m, n_microbatches=5)) == [want] * 4


def test_virtual_slice_error_is_the_reference_error():
    W6 = np.zeros((6, 4, 4), np.float32)
    want = _jax_error(lambda m: jpipe.shard_stage_params(
        {"w": W6}, m, virtual_stages=2))
    assert "virtual slices" in want
    assert _errors(4, lambda m: shard_stage_params(
        {"w": W6}, m, virtual_stages=2)) == [want] * 4


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    yield
    if not was:
        metrics.disable()


def test_zb_single_stage_falls_back_and_stays_correct(metrics_on):
    """S = 1: zb falls back to 1f1b, counts ``single_stage`` and gives
    the sequential loss and gradients, as the reference's own test."""
    rng = np.random.default_rng(9)
    W = (rng.normal(size=(1, D, D)).astype(np.float32)
         / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = np.roll(x, 1, axis=1) * 0.5

    def seq_loss(Wf):
        h = jnp.tanh(jnp.asarray(x) @ Wf[0])
        return jnp.mean((h - jnp.asarray(y)) ** 2)

    ref_loss, ref_grad = jax.jit(jax.value_and_grad(seq_loss))(
        jnp.asarray(W))
    counter = metrics.PIPELINE_ZB_FALLBACKS.labels(reason="single_stage")

    def rank(world):
        mesh = create_mesh({"pipe": 1}, world)
        before = counter.value
        vg = make_pipeline_value_and_grad(_tstage, _tloss, mesh,
                                          n_microbatches=4, schedule="zb")
        counted = counter.value - before
        loss, g = vg(shard_stage_params({"w": W}, mesh),
                     {"x": torch.tensor(x), "y": torch.tensor(y)})
        return counted, vg.schedule_label, loss.item(), g["w"].numpy()

    (counted, label, loss, g), = run_worlds(1, rank)
    assert counted == 1 and label == "1f1b"
    assert abs(loss - float(ref_loss)) <= TOL_LOSS
    np.testing.assert_allclose(g, np.asarray(ref_grad), atol=TOL_GRAD, rtol=0)


def _bad_tables(reason):
    """A ``_zb_tables`` that makes ``_plan_zb`` fall back for ``reason``."""
    def tables(S, M):
        tabs = tpipe._schedules._onef1b_tables(S, M)
        w_mb = tabs["b_mb"].copy()
        if reason == "table_error":
            raise RuntimeError("no tables")
        if reason == "unplaced_bw":
            w_mb[w_mb == 0] = -1
            return dict(tabs, w_mb=w_mb, w_ring=1)
        # ring_alias: every Bw three ticks late in a one-slot ring
        w_mb = np.roll(w_mb, 3, axis=0)
        return dict(tabs, w_mb=w_mb, w_ring=1)
    return tables


@pytest.mark.parametrize("reason", ["ring_alias", "unplaced_bw",
                                    "table_error"])
def test_zb_fallback_reasons_are_counted(reason, metrics_on, monkeypatch):
    monkeypatch.setattr(tpipe._schedules, "_zb_tables", _bad_tables(reason))
    assert tpipe._plan_zb(2, 4) == (None, reason)
    counter = metrics.PIPELINE_ZB_FALLBACKS.labels(reason=reason)

    def rank(world):
        mesh = create_mesh({"pipe": 2}, world)
        return make_pipeline_value_and_grad(
            _tstage, _tloss, mesh, n_microbatches=4,
            schedule="zb").schedule_label

    before = counter.value
    assert run_worlds(2, rank) == ["1f1b", "1f1b"]
    assert counter.value - before == 2   # one per rank


def test_pipeline_spans_and_metrics(metrics_on):
    """With metrics on when the step is built, a step emits the
    PIPELINE_STEP span and the three phase estimates, counts
    PIPELINE_STEPS, and the schedule's gauges hold ``schedule_info``'s
    numbers."""
    S, M = 2, 4
    W, x, y = _case(S, "gpipe")
    info = tpipe.schedule_info("gpipe", S, M)

    def rank(world):
        mesh = create_mesh({"pipe": S}, world)
        p = shard_stage_params({"w": W}, mesh)
        opt = torch.optim.SGD([p["w"].requires_grad_()], lr=0.1)
        step = make_pipeline_train_step(_tstage, _tloss, opt, mesh,
                                        n_microbatches=M)
        step(p, {"x": torch.tensor(x), "y": torch.tensor(y)})
        return threading.current_thread().name

    steps = metrics.PIPELINE_STEPS.labels(schedule="gpipe")
    traces = metrics.PIPELINE_TRACES.labels(
        stages=str(S), microbatches=str(M), schedule="gpipe")
    n_steps, n_traces = steps.value, traces.value
    names = run_worlds(S, rank)
    assert steps.value - n_steps == S
    assert traces.value - n_traces >= S
    assert metrics.PIPELINE_BUBBLE_MEASURED.value == info.bubble_fraction
    assert metrics.PIPELINE_BUBBLE.value == info.ideal_bubble
    assert metrics.PIPELINE_TICKS.value == info.ticks
    for name in names:
        mine = [e for e in spans.recorder.events() if e["tid"] == name]
        kinds = {e["name"] for e in mine}
        assert {"PIPELINE_STEP", "PIPELINE_WARMUP", "PIPELINE_STEADY",
                "PIPELINE_COOLDOWN"} <= kinds, kinds
        step = next(e for e in mine if e["name"] == "PIPELINE_STEP")
        assert step["args"]["schedule"] == "gpipe"
        assert step["args"]["ticks"] == info.ticks


def test_failing_rank_fails_fast_and_blocks_no_rank():
    """Rank 1 raises inside ``stage_fn``; rank 0 waits in a hop or a
    collective until its group's timeout and raises too. The call raises
    rank 1's error once both have ended, inside the join timeout."""
    W, x, _ = _case(2, "gpipe")
    threads, timeout = [], 3.0

    def rank(world):
        threads.append(threading.current_thread())
        mesh = create_mesh({"pipe": 2}, world)

        def stage(p, h):
            if world.rank == 1:
                raise ValueError("boom in stage_fn")
            return _tstage(p, h)

        return pipeline_apply(stage, shard_stage_params({"w": W}, mesh),
                              torch.tensor(x), mesh, n_microbatches=4)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom in stage_fn"):
        run_worlds(2, rank, timeout=timeout)
    took = time.monotonic() - t0
    assert took < timeout + 5.0, took
    assert len(threads) == 2 and not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_stage_calls_follow_the_tables(schedule):
    """Each rank runs ``stage_fn`` on its busy ticks only: its forward
    cells of the tables (gpipe and interleaved's forward; 1f1b and zb's
    F half), plus one recompute per backward cell that needs one (B on
    every stage under 1f1b; under zb, Bx on every stage but the first,
    which sends no dx, and W on every stage)."""
    S, M = 4, 8
    W, x, y = _case(S, schedule)
    V = _virtual(schedule)
    if schedule in ("gpipe", "interleaved"):
        fwd = tpipe._schedules._forward_tables(S, M, V)["exec_mb"] \
            if V > 1 else tpipe._schedules._onef1b_tables(S, M)["f_mb"]
        want = [int((fwd[:, s] >= 0).sum()) for s in range(S)]
    else:
        tabs = tpipe._schedules._zb_tables(S, M)
        want = [int((tabs["f_mb"][:, s] >= 0).sum())
                + int((tabs["b_mb"][:, s] >= 0).sum()) * (
                    schedule == "1f1b" or s > 0)
                + int((tabs["w_mb"][:, s] >= 0).sum()) * (schedule == "zb")
                for s in range(S)]

    def rank(world):
        mesh = create_mesh({"pipe": S}, world)
        calls = []

        def stage(p, h):
            calls.append(1)
            return _tstage(p, h)

        vg = make_pipeline_value_and_grad(
            stage, _tloss, mesh, n_microbatches=M, schedule=schedule,
            virtual_stages=V if V > 1 else None)
        vg(shard_stage_params({"w": W}, mesh, virtual_stages=V),
           {"x": torch.tensor(x), "y": torch.tensor(y)})
        return len(calls)

    assert run_worlds(S, rank) == want
