"""The port's ``dryrun_multichip`` (horovod_tpu_torch/graft_entry.py)
against ``__graft_entry__``'s, whose exercises it ports as far as the
port reaches.

- ``dryrun_multichip(n)`` at 8 ranks (inside 30 s), 4 and 2 runs and
  prints its one line, with the reference's mesh factoring and the
  serve-prefix exercise's hit ratio.
- ``_sharded_train_step`` from the JAX init (``PRNGKey(0)``, converted by
  ``params_from_jax``) over ``{data: 2, seq: 2, model: 2}`` gives the loss
  of ``__graft_entry__._sharded_train_step`` on the 8-device CPU mesh
  within 1e-5, both in float32 (the same products, summed in another
  order), and the port's loss in one process on the whole batch.
- ``_ragged_moe_exercise``'s output equals the reference's
  ``shard_map`` version's within 1e-5 (the reference's exercise checks
  its output but does not return it, so its body is repeated here to
  return it).
- The pipeline exercises against their JAX counterparts, whose bodies
  are repeated here to return what they check: the gpipe forward
  against JAX's ``pipeline_apply`` within 1e-5; each schedule's loss
  (1e-5) and gradients (1e-4) against JAX's
  ``make_pipeline_value_and_grad`` on the same slices; the composed
  16-rank step's loss and gradients against the reference's
  single-device composition in JAX (its 16-device mesh needs a process
  of its own, as the reference spawns one), within 1e-5 and 1e-4.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

import __graft_entry__ as jentry  # noqa: E402
from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu.parallel import moe_dispatch_combine_ragged  # noqa: E402
from horovod_tpu.parallel import pipeline as jpipe  # noqa: E402
from horovod_tpu_torch import graft_entry  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.parallel import create_mesh  # noqa: E402

from .torch_train_parity import run_worlds  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("n", [8, 4, 2])
def test_dryrun_multichip_prints_its_line(n, capsys):
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n)
    took = time.perf_counter() - t0
    data, seq, model = jentry._mesh_shape(n)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert lines[0].startswith(f"dryrun_multichip({n}): mesh=({data},{seq},"
                               f"{model}) loss=")
    # The pipeline exercises, named as the reference names them, and the
    # serve-prefix exercise's hit ratio: 24 cached prompt tokens of the
    # two 26-token prompts admitted with the cache on.
    assert lines[0].endswith(
        "ragged-moe ok, pipeline ok, pipeline-schedules ok "
        "(gpipe/1f1b/interleaved/zb grad-parity, bubble orderings hold), "
        "composed-16dev ok (pp x dp x tp x ep grad parity), serve-prefix "
        f"ok (warm hit ratio {24 / 52:.2f}) — OK")
    assert took < 30.0, took


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_is_the_reference_factoring(n):
    assert graft_entry._mesh_shape(n) == jentry._mesh_shape(n)


def _jax_mesh(data, seq, model):
    devices = np.asarray(jax.devices()[:data * seq * model])
    return Mesh(devices.reshape(data, seq, model), ("data", "seq", "model"))


def test_sharded_train_step_matches_reference(monkeypatch):
    """Both steps in float32: for this test each package's ``tiny()``
    gives ``dtype="float32"`` (the dry run's default is bfloat16, whose
    roundings XLA and torch take in other orders), and the reference's
    own init is kept and handed to the port."""
    def f32(tiny):
        return lambda *a, **k: dataclasses.replace(tiny(*a, **k),
                                                   dtype="float32")

    # The reference calls init_params op by op; here it runs as one
    # jitted program compiled without XLA's backend optimizations, which
    # takes a third of the time (its last bits may differ from the
    # op-by-op init's). Both steps start from what it returns.
    inits, jit_init = [], jax.jit(jtfm.init_params, static_argnums=1)

    def init(key, cfg):
        fn = jit_init.lower(key, cfg)
        inits.append(fn.compile({"xla_backend_optimization_level": 0})(key))
        return inits[-1]

    monkeypatch.setattr(jtfm, "tiny", f32(jtfm.tiny))
    monkeypatch.setattr(ttfm, "tiny", f32(ttfm.tiny))
    monkeypatch.setattr(jtfm, "init_params", init)
    want = jentry._sharded_train_step(_jax_mesh(2, 2, 2), 2, 2, 2)
    params = jax.tree.map(np.asarray, inits[0])

    def rank(world):
        mesh = create_mesh({"data": 2, "seq": 2, "model": 2}, world)
        return graft_entry._sharded_train_step(
            mesh, 2, 2, 2, params=params_from_jax(params, device="cpu"))

    losses = run_worlds(8, rank)
    assert len(set(losses)) == 1
    assert abs(losses[0] - want) <= TOL, (losses[0], want)
    # ... and the port's one-process loss on the whole batch.
    cfg = dataclasses.replace(ttfm.tiny(n_experts=2), attn_impl="gather")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    with torch.no_grad():
        one = ttfm.loss_fn(params_from_jax(params, device="cpu"),
                           {"tokens": torch.tensor(tokens)}, cfg).item()
    assert abs(losses[0] - one) <= TOL, (losses[0], one)


def _jax_ragged(mesh, data):
    """The body of ``__graft_entry__._ragged_moe_exercise``, returning its
    output [T, D]."""
    E, D, T = 2 * data, 8, 16 * data
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((T, D)), jnp.float32)
    logits = jnp.asarray(rng.standard_normal((T, E)).astype(np.float32))
    logits = logits.at[:, 0].add(1.5)  # skewed routing

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("data", None), P("data", None)),
                       out_specs=P("data", None), check_vma=False)
    def fn(x, logits):
        out, aux = moe_dispatch_combine_ragged(
            x, logits, lambda buf: buf * 2.0, "data",
            peer_capacity=T // data)
        return out + 0.0 * aux["load_balance_loss"]

    sh = NamedSharding(mesh, P("data", None))
    return np.asarray(fn(jax.device_put(x, sh), jax.device_put(logits, sh)))


def test_ragged_moe_exercise_matches_shard_map():
    """At 8 ranks, the one size of the three whose data axis (2) makes
    the dispatch cross ranks."""
    n = 8
    data, seq, model = jentry._mesh_shape(n)
    want = _jax_ragged(_jax_mesh(data, seq, model), data)
    rows = want.shape[0] // data

    def rank(world):
        mesh = create_mesh({"data": data, "seq": seq, "model": model},
                           world)
        out = graft_entry._ragged_moe_exercise(mesh, data)
        return mesh.coords()[0], out.numpy()

    for i, got in run_worlds(n, rank):
        np.testing.assert_allclose(got, want[i * rows:(i + 1) * rows],
                                   atol=TOL, rtol=0)


def test_pipeline_exercise_matches_jax():
    """The body of ``__graft_entry__._pipeline_exercise`` at 8 devices
    (4 stages), returning JAX's outputs."""
    S, D = 4, 8
    rng = np.random.default_rng(5)
    W = rng.normal(size=(S, D, D)).astype(np.float32) / np.sqrt(D)
    x = rng.normal(size=(8, D)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))
    want = np.asarray(jax.jit(lambda w, x: jpipe.pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"]), {"w": w}, x, mesh,
        n_microbatches=4))(jnp.asarray(W), jnp.asarray(x)))
    got = graft_entry._pipeline_exercise(8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_pipeline_schedule_exercise_matches_jax():
    """At 4 devices (4 stage slices): each schedule's loss and gradient,
    JAX's from one jitted program per mesh over the same slices."""
    SV, D, B = 4, 8, 16
    rng = np.random.default_rng(11)
    W = rng.normal(size=(SV, D, D)).astype(np.float32) / np.sqrt(D)
    x = rng.normal(size=(B, D))
    y = rng.normal(size=(B, D))
    runs = (("gpipe", SV, None), ("1f1b", SV, None),
            ("interleaved", SV // 2, 2), ("zb", SV, None))

    def body(w, batch, S):
        out = {}
        mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))
        for name, S_, V in runs:
            if S_ != S:
                continue
            vg = jpipe.make_pipeline_value_and_grad(
                lambda p, h: jnp.tanh(h @ p["w"]),
                lambda o, b: jnp.mean((o - b["y"]) ** 2), mesh,
                n_microbatches=SV, schedule=name, virtual_stages=V)
            loss, g = vg({"w": w}, batch)
            out[name] = (loss, g["w"])
        return out

    batch = {"x": jnp.asarray(x, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    want = {}
    for S in (SV, SV // 2):
        want.update(jax.jit(body, static_argnums=2)(jnp.asarray(W), batch, S))
    got = graft_entry._pipeline_schedule_exercise(4)
    assert got.keys() == want.keys()
    for name, (loss, g) in got.items():
        assert abs(loss - float(want[name][0])) <= TOL, name
        np.testing.assert_allclose(g, np.asarray(want[name][1]), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_composed_exercise_matches_jax_composition():
    """``ref_loss`` of ``__graft_entry__._composed_child``: the same
    two stages' math on one device, with the same parameters."""
    W, x, y, _ = graft_entry._composed_params()

    def ref_loss(params, xb, yb):
        h = xb
        for s in range(2):
            h2 = jnp.tanh(h @ params["proj"][s])
            probs = jax.nn.softmax(h2 @ params["router"][s], axis=-1)
            e = jnp.argmax(probs, axis=-1)
            gate = jnp.take_along_axis(probs, e[:, None], 1)[:, 0]
            hh = jax.nn.gelu(jnp.einsum("td,tdf->tf", h2,
                                        params["w_in"][s][e]))
            moe = jnp.einsum("tf,tfd->td", hh, params["w_out"][s][e])
            h = h2 + gate[:, None] * moe
        return jnp.mean((h - yb) ** 2)

    want, want_grads = jax.jit(jax.value_and_grad(ref_loss))(
        jax.tree.map(jnp.asarray, W), jnp.asarray(x), jnp.asarray(y))
    loss, grads = graft_entry._composed_16dev_exercise()
    assert abs(loss - float(want)) <= TOL, (loss, float(want))
    for k in W:
        np.testing.assert_allclose(grads[k], np.asarray(want_grads[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
