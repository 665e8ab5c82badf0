"""The transformer under a mesh (horovod_tpu_torch/models/transformer.py
``mesh=``, ``param_specs``/``filter_specs``; models/convert.py
``shard_params``/``gather_params``; parallel/sharding.py) against the
JAX package's ``transformer`` on its 8-device CPU mesh.

Ranks are threads (``run_worlds``), each with a gloo ``World``; each
holds its shard of the params (``shard_params`` of one JAX init) and its
rows of the tokens, made with numpy from a seed. Model:
``dataclasses.replace(tiny(), dtype="float32")``, so the tolerances are
float32's:

- logits against JAX ``forward(mesh=...)``: 2e-5 absolute (|logit| <
  0.5; XLA and the port sum the row-parallel partials and the attention
  in other orders, a few float32 ulps each over 2 layers);
- loss within 1e-5 and every gradient leaf within 1e-4 relative to its
  norm, against ``jax.value_and_grad`` (sums over the data and seq ranks
  in another order than XLA's); SGD(1e-3) updated params within 1e-6
  absolute (lr times the gradient's error);
- against the port's own step in one process: the same.
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import (  # noqa: E402
    gather_params, params_from_jax, shard_params)
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    all_to_all, copy_to, create_mesh, gather, gather_replicated,
    make_train_step, reduce_from, replicate, ring_blocks, shard_batch,
    tree_flatten_with_path, tree_leaves)
from horovod_tpu_torch.tree import tree_unflatten  # noqa: E402

from .torch_train_parity import run_worlds  # noqa: E402

TOL_LOGITS = 2e-5
TOL_LOSS, TOL_GRAD, TOL_PARAM = 1e-5, 1e-4, 1e-6
DSM = {"data": 2, "seq": 2, "model": 2}
DM = {"data": 2, "model": 2}


def _cfgs(**kw):
    return (dataclasses.replace(jtfm.tiny(), dtype="float32", **kw),
            dataclasses.replace(ttfm.tiny(), dtype="float32", **kw))


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())),
                tuple(shape))


def _place(params, cfg, mesh):
    specs = jtfm.filter_specs(jtfm.param_specs(cfg), mesh)
    return jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))


def _np(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _paths(tree):
    return {p: x.detach().numpy() for p, x in tree_flatten_with_path(tree)}


def _n(shape):
    return int(np.prod(list(shape.values())))


@pytest.mark.parametrize("cfg_fn", ["tiny", "bert_large"])
def test_param_specs_match_reference(cfg_fn):
    jcfg, tcfg = getattr(jtfm, cfg_fn)(), getattr(ttfm, cfg_fn)()
    want = jax.tree.map(tuple, jtfm.param_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, P))
    assert ttfm.param_specs(tcfg) == want
    for shape in (DM, DSM, {"data": 8}):
        mesh = _jax_mesh(shape)
        got = ttfm.filter_specs(ttfm.param_specs(tcfg),
                                types.SimpleNamespace(axis_names=tuple(shape)))
        want = jax.tree.map(tuple, jtfm.filter_specs(
            jtfm.param_specs(jcfg), mesh), is_leaf=lambda x: isinstance(x, P))
        assert got == want, shape


def test_resolve_attn_mesh_branch_matches_reference():
    """"auto" over a sequence-sharded mesh is "ring" for self-attention
    only; otherwise the mesh changes nothing (on the CPU: "gather")."""
    jcfg, tcfg = jtfm.tiny(), ttfm.tiny()
    for shape in ({"data": 2, "seq": 2}, {"data": 4}, {"seq": 1, "model": 2}):
        mesh = types.SimpleNamespace(axis_names=tuple(shape), shape=shape)
        for S, kv in ((16, None), (16, 64), (1, 64)):
            assert (ttfm.resolve_attn(tcfg, S, "cpu", kv_len=kv, mesh=mesh)
                    == jtfm.resolve_attn(jcfg, S, _jax_mesh(shape),
                                         kv_len=kv)), (shape, S, kv)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference step's init (``_sharded_train_step``: key 0)."""
    return jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jtfm.tiny())


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def test_shard_params_takes_jax_shards_and_gather_inverts(jax_params):
    """Each rank's shard is the block JAX places on the device at the
    same mesh coordinates; gather_params puts the whole back."""
    jcfg, tcfg = _cfgs()
    mesh_j = _jax_mesh(DSM)
    full = jax.tree.map(np.asarray, jax_params)
    specs = jtfm.filter_specs(jtfm.param_specs(jcfg), mesh_j)
    index = jax.tree.map(
        lambda s, x: NamedSharding(mesh_j, s).devices_indices_map(x.shape),
        specs, full, is_leaf=lambda x: isinstance(x, P))

    def rank(world):
        mesh = create_mesh(DSM, world)
        params = params_from_jax(full, device="cpu")
        shard = shard_params(params, tcfg, mesh)
        device = mesh_j.devices[mesh.coords()]
        want = jax.tree.map(lambda x, idx: x[idx[device]], full, index,
                            is_leaf=lambda x: isinstance(x, dict)
                            and device in x)
        for (path, got), w in zip(tree_flatten_with_path(shard),
                                  jax.tree.leaves(want)):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=path)
        back = gather_params(shard, tcfg, mesh)
        for (path, got), w in zip(tree_flatten_with_path(back),
                                  tree_leaves(params)):
            assert torch.equal(got, w), path
        return True

    assert all(run_worlds(8, rank))


def _port_forward(jax_params, tcfg, shape, tokens):
    """The port's logits under ``shape``, put back together [B, S, V]."""
    full = jax.tree.map(np.asarray, jax_params)

    def rank(world):
        mesh = create_mesh(shape, world)
        params = shard_params(params_from_jax(full, device="cpu"), tcfg, mesh)
        with torch.no_grad():
            return mesh.coords(), ttfm.forward(
                params, shard_batch(torch.tensor(tokens).long(), mesh,
                                    "data"), tcfg,
                mesh=mesh).numpy()

    out = {}
    for coords, logits in run_worlds(_n(shape), rank):
        c = dict(zip(shape, coords))
        out[c["data"], c.get("seq", 0)] = logits
    seq = shape.get("seq", 1)
    return np.concatenate([np.concatenate([out[d, s] for s in range(seq)], 1)
                           for d in range(shape["data"])], 0)


FORWARD_TOKENS = np.random.default_rng(3).integers(0, 256, (4, 16),
                                                    np.int32)
# The attention paths held on each mesh.
FORWARD_IMPLS = {"dm": (DM, ("gather", "flash")),
                 "dsm": (DSM, ("gather", "ring"))}


@functools.lru_cache(maxsize=None)
def _jax_forwards(name):
    """{impl: logits} of the reference's ``forward(mesh=...)`` on
    ``FORWARD_TOKENS`` for every impl of ``FORWARD_IMPLS[name]``, in one
    jitted program (one compile a mesh, where one an impl would be
    two)."""
    shape, impls = FORWARD_IMPLS[name]
    mesh = _jax_mesh(shape)
    cfgs = {impl: _cfgs(attn_impl=impl)[0] for impl in impls}
    out = jax.jit(lambda p, t: {impl: jtfm.forward(p, t, cfg, mesh=mesh)
                                for impl, cfg in cfgs.items()})(
        _place(_jax_params(), cfgs[impls[0]], mesh),
        jax.device_put(FORWARD_TOKENS, NamedSharding(mesh, P("data", None))))
    return {impl: np.asarray(x) for impl, x in out.items()}


@pytest.mark.parametrize("name,impl", [
    ("dm", "gather"), ("dm", "flash"), ("dsm", "gather"), ("dsm", "ring")],
    ids=["dm-gather", "dm-flash", "dsm-gather", "dsm-ring"])
def test_forward_matches_jax(jax_params, name, impl):
    _, tcfg = _cfgs(attn_impl=impl)
    want = _jax_forwards(name)[impl]
    got = _port_forward(jax_params, tcfg, FORWARD_IMPLS[name][0],
                        FORWARD_TOKENS)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL_LOGITS,
                               rtol=0)


# The dense dp x sp x tp step of __graft_entry__._sharded_train_step
# (n_experts=0; experts under a mesh are in test_torch_moe_mesh.py) at 8
# devices: tiny ring, B = 2 * data, S = 32, SGD(1e-3).
STEP_TOKENS = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(
    np.int32)


@pytest.fixture(scope="module")
def jax_step(jax_params):
    """(params, loss, grads, params after one step) of the reference
    step."""
    jcfg, _ = _cfgs(attn_impl="ring")
    mesh = _jax_mesh(DSM)
    params0 = jax_params
    tx = optax.sgd(1e-3)

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jtfm.loss_fn)(params, batch, jcfg,
                                                       mesh=mesh)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, grads

    params = _place(params0, jcfg, mesh)
    tokens = jax.device_put(STEP_TOKENS, NamedSharding(mesh, P("data", None)))
    new, loss, grads = jax.jit(train_step)(params, tx.init(params),
                                           {"tokens": tokens})
    return (jax.tree.map(np.asarray, params0), float(loss), _np(grads),
            _np(new))


class _RecordingSGD(torch.optim.SGD):
    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]
        return super().step(closure)


def _port_step(params0, shape, data_axis, **cfg_kw):
    """(loss, whole grads, whole params after one SGD(1e-3) step) of the
    port's ``make_train_step`` under ``shape``, or in one process for
    ``shape=None``."""
    _, tcfg = _cfgs(**cfg_kw)

    def rank(world):
        mesh = None if world is None else create_mesh(shape, world)
        params = params_from_jax(params0, device="cpu")
        if mesh is not None:
            params = shard_params(params, tcfg, mesh)
        leaves = [x.requires_grad_() for x in tree_leaves(params)]
        opt = _RecordingSGD(leaves, lr=1e-3)
        step = make_train_step(
            lambda p, b: ttfm.loss_fn(p, b, tcfg, mesh=mesh), opt, mesh,
            data_axis=data_axis)
        batch = {"tokens": torch.tensor(STEP_TOKENS).long()}
        if mesh is not None:
            batch = shard_batch(batch, mesh, "data")
        loss = step(params, batch).item()
        grads = tree_unflatten(params, opt.grads)
        if mesh is not None:
            grads = gather_params(grads, tcfg, mesh)
            params = gather_params(params, tcfg, mesh)
        return loss, _paths(grads), _paths(params)

    if shape is None:
        return rank(None)
    ranks = run_worlds(_n(shape), rank)
    for other in ranks[1:]:                     # every rank has the whole
        assert other[0] == ranks[0][0]
    return ranks[0]


def _assert_step(got, want):
    loss, grads, params = got
    want_loss, want_grads, want_params = want
    assert abs(loss - want_loss) <= TOL_LOSS, (loss, want_loss)
    assert grads.keys() == want_grads.keys()
    for path, w in want_grads.items():
        rel = np.linalg.norm(grads[path] - w) / np.linalg.norm(w)
        assert rel <= TOL_GRAD, (path, rel)
    for path, w in want_params.items():
        np.testing.assert_allclose(params[path], w, atol=TOL_PARAM, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("remat,loss_chunk", [(False, 0), (True, 8)],
                         ids=["plain", "remat-chunked"])
def test_sharded_train_step_matches_jax(jax_step, remat, loss_chunk):
    """Loss, every gradient leaf (the ranks' gradients averaged over
    ``data`` and ``seq`` and gathered over ``model``) and every updated
    leaf of one dp x sp x tp step; with remat and the chunked loss the
    function is the same."""
    params0, loss, grads, new = jax_step
    got = _port_step(params0, DSM, ("data", "seq"), attn_impl="ring",
                     remat=remat, loss_chunk=loss_chunk)
    _assert_step(got, (loss, grads, new))


@pytest.mark.parametrize("impl", ["gather", "flash"])
def test_two_way_tp_step_equals_one_process(jax_step, impl):
    """Loss, gradients and update under {data: 2, model: 2} against the
    port's own step in one process (ROADMAP item 7's condition)."""
    params0 = jax_step[0]
    _assert_step(_port_step(params0, DM, ("data",), attn_impl=impl),
                 _port_step(params0, None, "data", attn_impl=impl))


def test_replicate_leaves_model_shards_alone():
    """``replicate`` over ("data", "seq") gives every rank the values the
    rank at data 0, seq 0 with its own model coordinate had: a model
    shard is never overwritten by another model rank's."""
    _, tcfg = _cfgs()

    def rank(world):
        mesh = create_mesh(DSM, world)
        full = ttfm.init_params(tcfg, torch.Generator().manual_seed(5),
                                device="cpu")
        params = shard_params(full, tcfg, mesh)
        for x in tree_leaves(params):
            x.add_(world.rank)               # every rank's values differ
        before = [x.clone() for x in tree_leaves(params)]
        replicate(params, mesh, ("data", "seq"))
        return mesh.coords(), (before, tree_leaves(params))

    out = dict(run_worlds(8, rank))
    for (d, s, m), (_, after) in out.items():
        for a, b in zip(after, out[0, 0, m][0]):
            assert torch.equal(a, b)


def test_mesh_errors_match_reference(jax_params):
    """The reference's ValueErrors, raised by both packages before any
    work: a ring whose sequence or heads do not divide, flash on a
    sequence-sharded mesh or with heads that do not divide. (Experts
    under a mesh no longer raise: tests/test_torch_moe_mesh.py holds them
    to the reference.)"""
    cases = [({"seq": 2}, "ring", 15, "seq len 15 divisible"),
             ({"seq": 1, "model": 3}, "ring", 16, "n_heads 4 divisible"),
             ({"seq": 2}, "flash", 16, "sequence-sharded mesh"),
             ({"model": 3}, "flash", 16, "n_heads 4 divisible")]
    for shape, impl, S, msg in cases:
        jcfg, tcfg = _cfgs(attn_impl=impl)
        tokens = np.zeros((2, S), np.int32)
        mesh = _jax_mesh(shape)
        with pytest.raises(ValueError, match=msg):
            jax.eval_shape(lambda p, t: jtfm.forward(p, t, jcfg, mesh=mesh),
                           jax_params, tokens)

        def rank(world):
            mesh = create_mesh(shape, world)
            with pytest.raises(ValueError, match=msg):
                ttfm.forward({}, torch.tensor(tokens).long(), tcfg,
                             mesh=mesh)
            return True

        assert all(run_worlds(_n(shape), rank))


# Each collective of parallel/sharding.py at 4 ranks against the same
# global function in one process: outputs and the gradients of
# sum over ranks of <out_r, w_r>.
_X = np.random.default_rng(9).standard_normal((4, 8, 8)).astype(np.float32)
_W = np.random.default_rng(10).standard_normal((4, 256)).astype(np.float32)


def _weighted(out, w):
    return (out * w[:out.numel()].reshape(out.shape)).sum()


def _global(name, x, w):
    """(per-rank outputs, the gradient of x) in one process; x: the
    ranks' inputs [4, 8, 8] (replicated ones are x[0] on every rank), w:
    each rank's weights on its output."""
    x = torch.tensor(x, requires_grad=True)
    w = torch.tensor(w)
    if name == "copy_to":           # x[0] on every rank -> itself
        outs = [x[0]] * 4
    elif name == "reduce_from":     # partials -> their sum on every rank
        outs = [x.sum(0)] * 4
    elif name in ("gather", "gather_replicated"):
        outs = [torch.cat(list(x), 0)] * 4
    elif name == "all_to_all":      # rank j gets block j of dim 1 of each
        outs = [torch.cat([x[i][:, 2 * j:2 * j + 2] for i in range(4)], 0)
                for j in range(4)]
    else:                           # ring_blocks: rank r holds x[r - i]
        outs = [torch.stack([x[(r - i) % 4] for i in range(4)])
                for r in range(4)]
    if name in ("reduce_from", "gather_replicated"):
        # an output used the same on every rank counts once
        loss = _weighted(outs[0], w[0])
    else:
        loss = sum(_weighted(o, w[r]) for r, o in enumerate(outs))
    return [o.detach().numpy() for o in outs], torch.autograd.grad(
        loss, x)[0].numpy()


@pytest.mark.parametrize("name", ["copy_to", "reduce_from", "gather",
                                  "gather_replicated", "all_to_all",
                                  "ring_blocks"])
def test_sharding_collectives_and_their_backward(name):
    outs_want, grad_want = _global(name, _X, _W)

    def rank(world):
        g = world.group
        r = world.rank
        x = torch.tensor(_X[0 if name == "copy_to" else r],
                         requires_grad=True)
        w = torch.tensor(_W[0 if name in ("reduce_from",
                                          "gather_replicated") else r])
        if name == "copy_to":
            out = copy_to(x, g)
        elif name == "reduce_from":
            out = reduce_from(x, g)
        elif name == "gather":
            out = gather(x, g, 0)
        elif name == "gather_replicated":
            out = gather_replicated(x, g, 0)
        elif name == "all_to_all":
            out = all_to_all(x, g, 1, 0)
        else:
            out = torch.stack(ring_blocks(x, g))
        grad, = torch.autograd.grad(_weighted(out, w), x)
        return out.detach().numpy(), grad.numpy()

    ranks = run_worlds(4, rank)
    for r, (out, grad) in enumerate(ranks):
        np.testing.assert_allclose(out, outs_want[r], rtol=1e-6, atol=1e-6)
        # copy_to's input is one tensor held by every rank: its gradient
        # is whole on each
        want = grad_want[0 if name == "copy_to" else r]
        np.testing.assert_allclose(grad, want, rtol=1e-5, atol=1e-5)


def test_sendrecv_pairs_any_ring():
    """``sendrecv`` to rank r+2 from rank r-2 on 5 ranks: every rank gets
    its source's tensor, whatever order the ranks reach it in."""
    def rank(world):
        g, r = world.group, world.rank
        got = torch_ops.sendrecv(torch.full((3,), float(r)), g, (r + 2) % 5,
                                 (r - 2) % 5)
        return got.tolist()

    assert run_worlds(5, rank) == [[float((r - 2) % 5)] * 3
                                   for r in range(5)]
