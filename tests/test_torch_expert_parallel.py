"""Expert parallelism (horovod_tpu_torch/parallel/expert_parallel.py)
against the JAX package's ``horovod_tpu.parallel.expert_parallel`` on a
2- and a 4-device CPU ``Mesh``.

Ranks are threads (``run_worlds``), each with a gloo ``World`` and a
``create_mesh({"expert": P})``; rank r passes its rows of the global
tokens and logits and its block of the experts, as the body of the
reference's ``shard_map`` sees them. Inputs are float32, made with numpy
from a seed. Tolerances:

- outputs against JAX: 1e-5 absolute (|out| < 1; the same float32
  products, summed in another order);
- ``aux`` floats within 1e-6 absolute plus 1e-6 relative (the
  load-balance loss is ~E = 8: a float32 sum of E products, its rounding
  ~1e-6), capacities equal;
- dropped tokens: the same rows are exactly zero in both;
- gradients of ``sum(out * w)`` with respect to x, ``w_in`` and
  ``w_out`` against ``jax.grad`` of the same: 1e-5 absolute;
- at a generous capacity, against a numpy dense routing (every token
  through its argmax expert, gate-weighted): 2e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

torch.set_num_threads(1)

from horovod_tpu.parallel import expert_parallel as jep  # noqa: E402
import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    create_mesh, env_capacity_factor, make_moe_layer, moe_dispatch_combine,
    moe_dispatch_combine_ragged, report_dispatch)

from .torch_train_parity import run_worlds  # noqa: E402

TOL, TOL_AUX, TOL_DENSE = 1e-5, 1e-6, 2e-5
E, D, F = 8, 8, 16
T_RANK = 32                  # tokens per rank


def _inputs(P, seed, skew=0.0):
    """Global x [P*T_RANK, D], logits [.., E], w_in [E, D, F], w_out [E,
    F, D] and the loss weights w [.., D], float32."""
    rng = np.random.default_rng(seed)
    T = P * T_RANK
    x = rng.standard_normal((T, D)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += skew
    w_in = (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((E, F, D)) * 0.3).astype(np.float32)
    w = rng.standard_normal((T, D)).astype(np.float32)
    return x, logits, w_in, w_out, w


def _jax_expert_fn(w_in_l, w_out_l):
    def expert_fn(buf):           # make_moe_layer's expert
        h = jnp.einsum("end,edf->enf", buf.astype(jnp.float32),
                       w_in_l.astype(jnp.float32))
        h = jax.nn.gelu(h)
        return jnp.einsum("enf,efd->end", h,
                          w_out_l.astype(jnp.float32)).astype(buf.dtype)
    return expert_fn


def _overflow_inputs(n):
    """Every token the same and routed to expert 0."""
    x, _, w_in, w_out, w = _inputs(n, seed=5)
    logits = np.zeros((n * T_RANK, E), np.float32)
    logits[:, 0] = 10.0
    return np.ones_like(x), logits, w_in, w_out, w


def _cases(n):
    """case: (ragged, dispatch kwargs, inputs) of the tests below."""
    skewed, plain, full = (_inputs(n, seed=3, skew=1.5), _inputs(n, seed=7),
                           _overflow_inputs(n))
    return {
        "skewed dense": (False, {}, skewed),
        "skewed ragged": (True, {}, skewed),
        "generous dense": (False, {"capacity_factor": float(E)}, plain),
        "generous ragged": (True, {"peer_capacity": T_RANK,
                                   "expert_capacity": n * T_RANK}, plain),
        "overflow dense": (False, {"capacity_factor": 0.0}, full),
        "overflow ragged": (True, {"peer_capacity": 1,
                                   "expert_capacity": 16}, full),
    }


# make_moe_layer's cases: (capacity_factor, ragged) on these inputs.
LAYER_INPUTS = dict(seed=13, skew=1.5)
LAYER_CASES = [(cf, rg) for cf in (float(E), 1.25) for rg in (False, True)]


@functools.lru_cache(maxsize=None)
def _jax_refs(n):
    """The reference on ``n`` devices, every case in one jitted program
    (one compile, where one a case would be ten): ({case: (out, aux
    floats, grads of sum(out * w) with respect to x, w_in, w_out)} of
    the dispatch functions in ``shard_map``, {(capacity_factor, ragged):
    out} of ``make_moe_layer``)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("expert",))
    espec = P("expert", None, None)
    cases = _cases(n)

    def grad_fn(ragged, kw):
        dispatch = (jep.moe_dispatch_combine_ragged if ragged
                    else jep.moe_dispatch_combine)

        @functools.partial(shard_map, mesh=mesh,
                           in_specs=(P("expert", None), P("expert", None),
                                     espec, espec),
                           out_specs=(P("expert", None), P()),
                           check_vma=False)
        def layer(x, logits, w_in_l, w_out_l):
            out, aux = dispatch(x, logits, _jax_expert_fn(w_in_l, w_out_l),
                                "expert", **kw)
            return out, (aux["load_balance_loss"], aux["dropped_fraction"])

        def loss(x, logits, w_in, w_out, w):
            out, aux = layer(x, logits, w_in, w_out)
            return jnp.sum(out * w), (out, aux)

        return jax.grad(loss, (0, 2, 3), has_aux=True)

    x, logits, w_in, w_out, _ = _inputs(n, **LAYER_INPUTS)
    layers = {key: jep.make_moe_layer(
        mesh, "expert", jnp.asarray(w_in), jnp.asarray(w_out),
        capacity_factor=key[0], ragged=key[1], report=False)
        for key in LAYER_CASES}

    def every(inputs, x, logits):
        return ({case: grad_fn(rg, kw)(*inputs[case])
                 for case, (rg, kw, _) in cases.items()},
                [layers[key](x, logits) for key in LAYER_CASES])

    grads, outs = jax.jit(every)(
        {case: c[2] for case, c in cases.items()}, x, logits)
    return ({case: (np.asarray(out), tuple(float(a) for a in aux),
                    tuple(np.asarray(g) for g in gs))
             for case, (gs, (out, aux)) in grads.items()},
            dict(zip(LAYER_CASES, map(np.asarray, outs))))


def _port_layer(n, ragged, kw, x, logits, w_in, w_out, w):
    """The port on ``n`` thread ranks: (out, aux floats, capacities,
    grads) put back together as the reference's global arrays."""
    dispatch = moe_dispatch_combine_ragged if ragged else moe_dispatch_combine
    rows, experts = x.shape[0] // n, E // n

    def rank(world):
        group = create_mesh({"expert": n}, world).group("expert")
        r = world.rank
        mine = slice(r * rows, (r + 1) * rows)
        ours = slice(r * experts, (r + 1) * experts)
        xr = torch.tensor(x[mine], requires_grad=True)
        wi = torch.tensor(w_in[ours], requires_grad=True)
        wo = torch.tensor(w_out[ours], requires_grad=True)

        def expert_fn(buf):
            h = torch.einsum("end,edf->enf", buf.float(), wi)
            h = torch.nn.functional.gelu(h, approximate="tanh")
            return torch.einsum("enf,efd->end", h, wo).to(buf.dtype)

        out, aux = dispatch(xr, torch.tensor(logits[mine]), expert_fn,
                            group, **kw)
        grads = torch.autograd.grad((out * torch.tensor(w[mine])).sum(),
                                    (xr, wi, wo))
        caps = {k: v for k, v in aux.items() if isinstance(v, int)}
        return (out.detach().numpy(),
                (float(aux["load_balance_loss"]),
                 float(aux["dropped_fraction"])), caps,
                [g.numpy() for g in grads])

    ranks = run_worlds(n, rank)
    for other in ranks[1:]:
        assert other[1] == ranks[0][1] and other[2] == ranks[0][2]
    cat = np.concatenate
    return (cat([r[0] for r in ranks]), ranks[0][1], ranks[0][2],
            [cat([r[3][i] for r in ranks]) for i in range(3)])


def _dense_reference(x, logits, w_in, w_out):
    """Every token through its argmax expert, gate-weighted (numpy)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    eidx = probs.argmax(-1)
    gate = probs[np.arange(len(eidx)), eidx]
    h = np.einsum("td,edf->tef", x.astype(np.float64), w_in)
    h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
    y = np.einsum("tef,efd->ted", h, w_out)
    return y[np.arange(len(eidx)), eidx] * gate[:, None]


def _zero_rows(out):
    return np.flatnonzero(np.abs(out).sum(-1) == 0)


def _check_against_jax(n, case):
    ragged, kw, inputs = _cases(n)[case]
    want_out, want_aux, want_grads = _jax_refs(n)[0][case]
    out, aux, caps, grads = _port_layer(n, ragged, kw, *inputs)
    np.testing.assert_array_equal(_zero_rows(out), _zero_rows(want_out))
    np.testing.assert_allclose(out, want_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux, want_aux, atol=TOL_AUX, rtol=TOL_AUX)
    for got, want, name in zip(grads, want_grads, ("x", "w_in", "w_out")):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=f"d{name}")
    return out, aux, caps


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("n", [2, 4])
def test_skewed_routing_matches_jax(n, ragged):
    """``logits[:, 0] += 1.5`` (``__graft_entry__._ragged_moe_exercise``)
    at the default capacity factor: expert 0's queue overflows, and the
    port drops the same tokens, gives the same outputs, aux and float32
    gradients as the reference."""
    out, (_, dropped), caps = _check_against_jax(
        n, "skewed ragged" if ragged else "skewed dense")
    assert dropped > 0 and len(_zero_rows(out)) > 0
    T = n * T_RANK
    if ragged:
        cap = int(T_RANK * 1.25 / n)
        assert caps == {"peer_capacity": cap, "expert_capacity":
                        int(n * cap * 1.25 / (E // n))}
    else:
        assert caps == {"capacity": int(T_RANK * 1.25 / E)}
    # the dropped fraction is the share of zero rows over the group
    assert abs(dropped - len(_zero_rows(out)) / T) < TOL_AUX


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("n", [2, 4])
def test_generous_capacity_is_dense_routing(n, ragged):
    """``capacity_factor=E`` (nothing dropped; ``ragged`` with lossless
    capacities, as in tests/test_sequence_parallel.py): every token
    through its argmax expert, gate-weighted, as JAX computes it."""
    case = "generous ragged" if ragged else "generous dense"
    out, (_, dropped), _ = _check_against_jax(n, case)
    assert dropped == 0.0
    np.testing.assert_allclose(out, _dense_reference(*_cases(n)[case][2][:4]),
                               atol=TOL_DENSE, rtol=0)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("n", [2, 4])
def test_overflow_keeps_one_token_per_rank(n, ragged):
    """Every token routed to expert 0 with one slot: ``capacity_factor=0``
    clamps the dense queue to 1, ``peer_capacity=1`` the ragged slot.
    One token a rank survives, the rest are zero, as in JAX."""
    out, (_, dropped), _ = _check_against_jax(
        n, "overflow ragged" if ragged else "overflow dense")
    assert (np.abs(out).sum(-1) > 0).sum() == n
    assert abs(dropped - (1 - 1 / T_RANK)) < TOL_AUX


@pytest.mark.parametrize("n", [2, 4])
def test_make_moe_layer_dense_and_ragged(n):
    """``make_moe_layer`` over ``mesh.group("expert")`` against the
    reference's jitted ``make_moe_layer`` on the same mesh size, dense
    and ``ragged=True``, at a generous capacity (the two agree) and at
    the default one under skew (each matches its reference)."""
    x, logits, w_in, w_out, _ = _inputs(n, **LAYER_INPUTS)
    rows, experts = x.shape[0] // n, E // n
    for cf in (float(E), 1.25):
        want = {rg: _jax_refs(n)[1][cf, rg] for rg in (False, True)}

        def rank(world):
            mesh = create_mesh({"expert": n}, world)
            r = world.rank
            ours = slice(r * experts, (r + 1) * experts)
            mine = slice(r * rows, (r + 1) * rows)
            return {rg: make_moe_layer(
                mesh, "expert", torch.tensor(w_in[ours]),
                torch.tensor(w_out[ours]), capacity_factor=cf, ragged=rg,
                report=False)(torch.tensor(x[mine]),
                              torch.tensor(logits[mine])).numpy()
                for rg in (False, True)}

        ranks = run_worlds(n, rank)
        for rg in (False, True):
            got = np.concatenate([r[rg] for r in ranks])
            np.testing.assert_allclose(got, want[rg], atol=TOL, rtol=0)
        if cf == float(E):
            np.testing.assert_allclose(want[True], want[False], atol=TOL,
                                       rtol=0)


def test_env_capacity_factor(monkeypatch):
    monkeypatch.delenv("HVD_EP_CAPACITY_FACTOR", raising=False)
    assert env_capacity_factor() == jep.env_capacity_factor() == 1.25
    for value, want in (("2.5", 2.5), ("not-a-number", 1.25)):
        monkeypatch.setenv("HVD_EP_CAPACITY_FACTOR", value)
        assert env_capacity_factor() == jep.env_capacity_factor() == want


@pytest.fixture
def cpu_hvd(monkeypatch):
    """hvd.init(device="cpu") at size 1, shut down after."""
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_JAX_COORD_ADDR",
              "HVD_EP_CAPACITY_FACTOR"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_report_dispatch_before_init_returns_false():
    """No job, no gauge plane: False and nothing published, as the
    reference returns without a core; ep_report and ep_stats raise."""
    hvd.shutdown()
    assert report_dispatch(0.25, 64) is False
    assert jep.report_dispatch(0.25, 64) is False
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.ep_stats()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.ep_report(0.25, 64, 16)


def test_ep_report_counts_at_one_rank(cpu_hvd):
    """The core's contract (``horovod_tpu/basics.py:692-720``): counts
    add up, the last fraction is kept to 1e-6, a report with a negative
    count or more dropped than seen raises and counts nothing."""
    assert hvd.ep_stats() == (0, 0, 0, 0.0)
    assert report_dispatch(0.25, 64) is True            # 16 dropped
    assert hvd.ep_report(0.1234567, 10, 1) == 0
    assert hvd.ep_stats() == (2, 74, 17, 0.123457)
    assert report_dispatch(0.5, 10, dropped_tokens=99) is True   # clamped
    assert hvd.ep_stats() == (3, 84, 27, 0.5)
    for bad in ((0.0, -1, 0), (0.0, 4, -1), (0.0, 4, 5)):
        with pytest.raises(ValueError, match="invalid ep report"):
            hvd.ep_report(*bad)
    assert hvd.ep_stats() == (3, 84, 27, 0.5)


def test_ep_report_from_a_two_rank_layer(cpu_hvd):
    """Both ranks of a 2-rank ``make_moe_layer(report=True)`` publish
    their dispatch to the process's job: two reports, each of the
    group's tokens and the group's dropped fraction (the same on both
    ranks), as JAX's dispatch computes it."""
    n = 2
    x, logits, w_in, w_out, _ = _cases(n)["skewed dense"][2]
    _, (_, dropped), _ = _jax_refs(n)[0]["skewed dense"]
    rows = x.shape[0] // n

    def rank(world):
        mesh = create_mesh({"expert": n}, world)
        r = world.rank
        ours = slice(r * E // n, (r + 1) * E // n)
        make_moe_layer(mesh, "expert", torch.tensor(w_in[ours]),
                       torch.tensor(w_out[ours]))(
            torch.tensor(x[r * rows:(r + 1) * rows]),
            torch.tensor(logits[r * rows:(r + 1) * rows]))
        return True

    assert run_worlds(n, rank) == [True, True]
    reports, tokens, lost, last = hvd.ep_stats()
    T = n * rows
    assert (reports, tokens) == (2, 2 * T)
    assert lost == 2 * round(dropped * T) and abs(last - dropped) < 1e-6
