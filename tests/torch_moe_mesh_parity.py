"""Shared by test_torch_moe_mesh.py and test_torch_moe_mesh_dp_ep.py:
the MoE transformer under a mesh (horovod_tpu_torch/models/transformer.py
``_moe_ffn``/``_expert_plan``; ``make_train_step``/``replicate`` on
the leaves ``shard_params`` marks as cut) against the JAX package's ``transformer`` on its 8-device CPU
mesh, where GSPMD shards the experts by ``param_specs``. The two layouts
of the ``expert`` axis are in a file each, so that each file stays well
inside its time on the CPU.

``tiny(n_experts=4)``, attention ``"gather"``, B = 4, S = 16:

- (a) an axis of its own, ``{"data": 2, "expert": 2}`` and ``{"expert":
  2, "model": 2}``: each rank runs its experts on the tokens it shares
  with the axis;
- (b) the reference's dp=ep reuse (``expert_axis="data"``,
  ``__graft_entry__._sharded_train_step``), ``{"data": 2}`` and
  ``{"data": 2, "model": 2}``: each rank gathers the experts and runs
  them on its own tokens.

Ranks are threads (``run_worlds``), each with a gloo ``World``, its shard
of one JAX init (``shard_params``) and its rows of the tokens (numpy,
seeded). Tolerances:

- float32: logits within 1e-5 absolute (|logit| < 0.5), the loss within
  1e-5, every gradient leaf within 1e-5 in relative norm, against
  ``jax.value_and_grad(loss_fn)(..., mesh=)`` (the same products, summed
  in another order);
- bfloat16: test_torch_train_moe.py's (loss 2e-3, each leaf 8e-2) with
  its near-tie allowance: the expert leaves (router, ``w_in``,
  ``w_out``) of at most one layer may exceed the tolerance;
- one SGD(1e-3) step through ``make_train_step`` against the
  port's step in one process: the loss within 1e-5, every gradient leaf
  within 1e-5 in relative norm, every updated leaf within 1e-6 absolute
  (lr times the gradient's error).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
import horovod_tpu_torch.hvd as hvd
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.models.convert import (
    gather_params, params_from_jax, shard_params)
from horovod_tpu_torch.parallel import (
    create_mesh, make_train_step, replicate, shard_batch,
    tree_flatten_with_path, tree_leaves)
from horovod_tpu_torch.parallel.mesh import cut_axes, leaf_spec
from horovod_tpu_torch.tree import tree_unflatten

from .torch_train_parity import rel_errors, run_worlds

N_EXPERTS = 4
TOL_LOGITS = 1e-5
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 8e-2)}
TOL_PARAM = 1e-6
EXPERT_LEAVES = ("['router']", "['w_in']", "['w_out']")
# name: (mesh shape, expert axis)
LAYOUTS = {
    "data-expert": ({"data": 2, "expert": 2}, "expert"),
    "expert-model": ({"expert": 2, "model": 2}, "expert"),
    "dp=ep": ({"data": 2}, "data"),
    "dp=ep-model": ({"data": 2, "model": 2}, "data"),
}
TOKENS = np.random.default_rng(17).integers(0, 256, (4, 17)).astype(np.int32)


def _cfgs(dtype, expert_axis):
    kw = dict(dtype=dtype, attn_impl="gather", expert_axis=expert_axis)
    return (dataclasses.replace(jtfm.tiny(N_EXPERTS), **kw),
            dataclasses.replace(ttfm.tiny(N_EXPERTS), **kw))


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())),
                tuple(shape))


def _data_axis(shape):
    return tuple(a for a in ("data",) if a in shape)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference's init, key 0 (``_sharded_train_step``'s)."""
    return jax.tree.map(np.asarray, jax.jit(
        jtfm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                            jtfm.tiny(N_EXPERTS)))


# The layouts held in bfloat16 as well as in float32.
BF16_LAYOUTS = ("expert-model", "dp=ep-model")


@functools.lru_cache(maxsize=None)
def _jax_refs(layout):
    """{dtype: (loss, {leaf path: grad}, logits [B, S, V])} of the
    reference on its mesh, every dtype of the layout in one jitted
    program."""
    shape, expert_axis = LAYOUTS[layout]
    dtypes = ("float32", "bfloat16") if layout in BF16_LAYOUTS \
        else ("float32",)
    mesh = _jax_mesh(shape)
    specs = jtfm.filter_specs(jtfm.param_specs(_cfgs("float32",
                                                     expert_axis)[0]), mesh)
    params = jax.device_put(_jax_params(), jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    tokens = jax.device_put(TOKENS, NamedSharding(
        mesh, P(*_data_axis(shape), None)))

    def ref(params, tokens):
        out = {}
        for dtype in dtypes:
            jcfg, _ = _cfgs(dtype, expert_axis)
            loss, grads = jax.value_and_grad(jtfm.loss_fn)(
                params, {"tokens": tokens}, jcfg, mesh=mesh)
            out[dtype] = loss, grads, jtfm.forward(
                params, tokens[:, :-1], jcfg, mesh=mesh)
        return out

    return {dtype: (float(loss), {
        jax.tree_util.keystr(p): np.asarray(g, np.float32)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)},
        np.asarray(logits, np.float32))
        for dtype, (loss, grads, logits) in jax.jit(ref)(params,
                                                         tokens).items()}


class _RecordingSGD(torch.optim.SGD):
    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]
        return super().step(closure)


def _paths(tree):
    return {p: x.detach().float().numpy()
            for p, x in tree_flatten_with_path(tree)}


def _port(layout, dtype):
    """The port under ``layout``: (logits [B, S, V], loss, {path: grad},
    {path: param after one SGD(1e-3) step}), each put back together."""
    shape, expert_axis = LAYOUTS[layout]
    _, tcfg = _cfgs(dtype, expert_axis)
    data_axis = _data_axis(shape)

    def rank(world):
        mesh = create_mesh(shape, world)
        params = shard_params(params_from_jax(_jax_params(), device="cpu"),
                              tcfg, mesh)
        batch = shard_batch({"tokens": torch.tensor(TOKENS).long()}, mesh,
                            data_axis)
        with torch.no_grad():
            logits = ttfm.forward(params, batch["tokens"][:, :-1], tcfg,
                                  mesh=mesh).float().numpy()
        leaves = [x.requires_grad_() for x in tree_leaves(params)]
        opt = _RecordingSGD(leaves, lr=1e-3)
        step = make_train_step(
            lambda p, b: ttfm.loss_fn(p, b, tcfg, mesh=mesh), opt, mesh,
            data_axis=data_axis)
        loss = step(params, batch).item()
        grads = gather_params(tree_unflatten(params, opt.grads), tcfg, mesh)
        return (dict(zip(mesh.axis_names, mesh.coords())).get("data", 0),
                logits, loss, _paths(grads),
                _paths(gather_params(params, tcfg, mesh)))

    ranks = run_worlds(int(np.prod(list(shape.values()))), rank)
    for other in ranks[1:]:                 # every rank has the whole
        assert other[2] == ranks[0][2]
    by_data = {r[0]: r[1] for r in ranks}
    logits = np.concatenate([by_data[d] for d in sorted(by_data)])
    return logits, ranks[0][2], ranks[0][3], ranks[0][4]


@functools.lru_cache(maxsize=None)
def _one_process(dtype):
    """(loss, {path: grad}, {path: param after the step}) of the port's
    step in one process (no mesh) from the same params and tokens."""
    _, tcfg = _cfgs(dtype, "expert")
    params = params_from_jax(_jax_params(), device="cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    opt = _RecordingSGD(leaves, lr=1e-3)
    step = make_train_step(lambda p, b: ttfm.loss_fn(p, b, tcfg), opt)
    loss = step(params, {"tokens": torch.tensor(TOKENS).long()}).item()
    return loss, _paths(tree_unflatten(params, opt.grads)), _paths(params)


def check_float32(layout):
    """Logits, loss and every gradient leaf against JAX's sharded
    reference; the loss, gradients and updated params of one
    ``make_train_step`` against the port's step in one process."""
    want_loss, want_grads, want_logits = _jax_refs(layout)["float32"]
    logits, loss, grads, params = _port(layout, "float32")
    tol_loss, tol_grad = TOL["float32"]
    np.testing.assert_allclose(logits, want_logits, atol=TOL_LOGITS, rtol=0)
    assert abs(loss - want_loss) <= tol_loss, (loss, want_loss)
    rel = rel_errors(grads, want_grads)
    assert len(rel) == 22
    assert max(rel.values()) <= tol_grad, rel

    one_loss, one_grads, one_params = _one_process("float32")
    assert abs(loss - one_loss) <= tol_loss
    rel = rel_errors(grads, one_grads)
    assert max(rel.values()) <= tol_grad, rel
    for path, w in one_params.items():
        np.testing.assert_allclose(params[path], w, atol=TOL_PARAM, rtol=0,
                                   err_msg=path)


def check_bfloat16(layout):
    """The loss and every gradient leaf in bf16, with the near-tie
    allowance: a bf16 gate tie can send a token to another expert."""
    want_loss, want_grads, _ = _jax_refs(layout)["bfloat16"]
    _, loss, grads, _ = _port(layout, "bfloat16")
    tol_loss, tol_grad = TOL["bfloat16"]
    assert abs(loss - want_loss) <= tol_loss, (loss, want_loss)
    over = {p: e for p, e in rel_errors(grads, want_grads).items()
            if e > tol_grad}
    layers = {p.split("]")[1] for p in over if p.endswith(EXPERT_LEAVES)}
    assert len(layers) <= 1 and all(p.endswith(EXPERT_LEAVES)
                                    for p in over), over


def check_shard_params(layout):
    """``shard_params`` on ``(expert, None, model)`` and ``(expert, model,
    None)``: each rank's block is the one JAX places on the device at the
    same coordinates; ``gather_params`` puts the whole back."""
    shape, expert_axis = LAYOUTS[layout]
    jcfg, tcfg = _cfgs("float32", expert_axis)
    mesh_j = _jax_mesh(shape)
    full = _jax_params()
    specs = jtfm.filter_specs(jtfm.param_specs(jcfg), mesh_j)
    assert specs["layers"][0]["w_in"] == P(expert_axis, None,
                                           "model")
    index = jax.tree.map(
        lambda s, x: NamedSharding(mesh_j, s).devices_indices_map(x.shape),
        specs, full, is_leaf=lambda x: isinstance(x, P))

    def rank(world):
        mesh = create_mesh(shape, world)
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
        return all(torch.equal(g, w) for g, w in
                   zip(tree_leaves(back), tree_leaves(params)))

    assert all(run_worlds(4, rank))


def check_replicate_leaves_expert_shards_alone():
    """Under ``expert_axis="data"``, ``replicate`` gives every rank data
    rank 0's replicated leaves and leaves each rank's experts, which
    ``shard_params`` marks as cut over ``data``, as they were."""
    shape, expert_axis = LAYOUTS["dp=ep"]
    _, tcfg = _cfgs("float32", expert_axis)

    def rank(world):
        mesh = create_mesh(shape, world)
        params = shard_params(params_from_jax(_jax_params(), device="cpu"),
                              tcfg, mesh)
        for x in tree_leaves(params):
            x.add_(world.rank)               # every rank's values differ
        before = {p: x.clone() for p, x in tree_flatten_with_path(params)}
        replicate(params, mesh, "data")
        return before, dict(tree_flatten_with_path(params))

    (before0, after0), (before1, after1) = run_worlds(2, rank)
    for path, x in after1.items():
        if path.endswith(("['w_in']", "['w_out']")):
            assert torch.equal(x, before1[path]), path
            assert not torch.equal(x, after0[path]), path
        else:
            assert torch.equal(x, before0[path]), path


def check_cut_leaves_refuse_a_plain_group():
    """The marks ``shard_params`` puts on the leaves under
    ``expert_axis="data"``: ``w_in`` on ``("data", None, None)``, a
    replicated leaf on no axis, none on what ``gather_params`` returns.
    A plain process group names no axis, so ``make_train_step``,
    ``replicate``, ``hvd.DistributedOptimizer`` and
    ``hvd.broadcast_parameters`` raise on a tree with a cut leaf."""
    shape, expert_axis = LAYOUTS["dp=ep"]
    _, tcfg = _cfgs("float32", expert_axis)

    def rank(world):
        mesh = create_mesh(shape, world)
        params = shard_params(params_from_jax(_jax_params(), device="cpu"),
                              tcfg, mesh)
        assert leaf_spec(params["layers"][0]["w_in"]) == ("data", None, None)
        assert cut_axes(params["embed"]) == []
        assert all(leaf_spec(x) == () for x in
                   tree_leaves(gather_params(params, tcfg, mesh)))
        leaves = [x.requires_grad_() for x in tree_leaves(params)]
        opt = torch.optim.SGD(leaves, lr=1e-3)
        step = make_train_step(
            lambda p, b: ttfm.loss_fn(p, b, tcfg, mesh=mesh), opt,
            world.group)
        batch = {"tokens": torch.tensor(TOKENS[:2]).long()}
        with pytest.raises(ValueError, match="cut over mesh axes"):
            step(params, batch)
        with pytest.raises(ValueError, match="cut over mesh axes"):
            replicate(params, world.group)
        with pytest.raises(ValueError, match="cut over mesh axes"):
            hvd.DistributedOptimizer(opt)
        with pytest.raises(ValueError, match="cut over mesh axes"):
            hvd.broadcast_parameters(params)
        return True

    assert all(run_worlds(2, rank))
