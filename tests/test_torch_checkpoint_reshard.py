"""The port's checkpoint (horovod_tpu_torch/checkpoint.py) across world
sizes and through a training step, on the CPU, ranks as threads
(``graft_entry._on_ranks``).

- Reshard matrix: a save at 1, 2 or 4 ranks restores at 4, 2 and 1 (all
  nine pairs), for the ``tiny`` transformer's params cut by
  ``shard_params`` over ``{model: n}`` with their AdamW state from
  ``optimizer_state_tree``, and for ``tiny(4)``'s experts over
  ``{expert: n}`` with theirs. Each restored leaf, gathered over the
  restoring mesh (``gather_params``), is bit-equal to the whole tree the
  savers were cut from, and carries the like's spec. The whole AdamW
  state is one AdamW step over the whole params and gradients, which is
  elementwise, so each rank's state is exactly its block of it.
- Resume: ``tiny`` in float32 through ``make_train_step`` + AdamW, saved
  after step 0, restored into fresh params and a fresh AdamW, then step
  1: the loss and every leaf bit-equal to the uninterrupted run's.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from horovod_tpu_torch import checkpoint as ck  # noqa: E402
from horovod_tpu_torch.graft_entry import _on_ranks  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.models.convert import (  # noqa: E402
    gather_params, shard_params)
from horovod_tpu_torch.parallel import make_train_step  # noqa: E402
from horovod_tpu_torch.parallel.mesh import (  # noqa: E402
    World, create_mesh, leaf_spec)
from horovod_tpu_torch.process_sets import ProcessSet  # noqa: E402
from horovod_tpu_torch.tree import (  # noqa: E402
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten)

ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
KINDS = {"dense": (tfm.tiny(), "model"), "moe": (tfm.tiny(4), "expert")}


def _draw(cfg, seed):
    return tfm.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")


def _adamw_state(params, grads):
    """One AdamW step of ``params`` (a tree of leaves) under ``grads``;
    returns the optimizer."""
    leaves = tree_leaves(params)
    opt = torch.optim.AdamW(leaves, **ADAMW)
    for p, g in zip(leaves, tree_leaves(grads)):
        p.grad = g.clone()
    opt.step()
    return opt


def _whole(kind):
    """The whole tree the savers are cut from: params after one AdamW
    step and that step's state."""
    cfg, _ = KINDS[kind]
    params, grads = _draw(cfg, 0), _draw(cfg, 1)
    opt = _adamw_state(params, grads)
    return cfg, params, grads, ck.optimizer_state_tree(opt, params)


WHOLE = {}


def _whole_cached(kind):
    if kind not in WHOLE:
        WHOLE[kind] = _whole(kind)
    return WHOLE[kind]


def _like(params):
    """A restore like for params and a fresh AdamW's state."""
    return {"params": params,
            "opt": {"exp_avg": params, "exp_avg_sq": params,
                    "step": tree_map(lambda p: torch.zeros(()), params)}}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n,m", [(n, m) for n in (1, 2, 4)
                                 for m in (4, 2, 1)])
def test_reshard_matrix(tmp_path, kind, n, m):
    cfg, params, grads, state = _whole_cached(kind)
    axis = KINDS[kind][1]
    d = str(tmp_path)

    def save(world):
        mesh = create_mesh({axis: n}, world)
        # each rank steps its own blocks from the same start
        opt = _adamw_state(shard_params(_draw(cfg, 0), cfg, mesh),
                           shard_params(grads, cfg, mesh))
        p = tree_unflatten(params, opt.param_groups[0]["params"])
        ck.save(d, 1, {"params": p, "opt": ck.optimizer_state_tree(opt, p)},
                process_set=ProcessSet.from_world(world), mesh=mesh)

    _on_ranks(n, save, timeout=60)

    def restore(world):
        mesh = create_mesh({axis: m}, world)
        like = _like(shard_params(_draw(cfg, 2), cfg, mesh))
        out, step = ck.restore(d, like, process_set=ProcessSet.from_world(
            world), mesh=mesh)
        assert step == 1
        for (name, got), (_, want) in zip(tree_flatten_with_path(out),
                                          tree_flatten_with_path(like)):
            assert leaf_spec(got) == leaf_spec(want), name
            assert got.device == want.device, name
        whole = {"params": gather_params(out["params"], cfg, mesh),
                 "opt": {k: gather_params(out["opt"][k], cfg, mesh)
                         for k in ("exp_avg", "exp_avg_sq")}}
        whole["opt"]["step"] = out["opt"]["step"]
        return whole

    for got in _on_ranks(m, restore, timeout=60):
        want = {"params": params, "opt": state}
        for (name, a), (_, b) in zip(tree_flatten_with_path(got),
                                     tree_flatten_with_path(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (kind, n, m, name)


def test_resumed_step_is_bit_equal(tmp_path):
    cfg = dataclasses.replace(tfm.tiny(), dtype="float32")
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 17)))} for _ in range(2)]
    ps = ProcessSet.from_world(World(dist.HashStore(), 0, 1, "cpu"))
    d = str(tmp_path)

    def trainable(params):
        return tree_map(lambda t: t.detach().clone().requires_grad_(), params)

    def stepper(params):
        opt = torch.optim.AdamW(tree_leaves(params), **ADAMW)
        return opt, make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)

    p = trainable(_draw(cfg, 0))
    opt, step = stepper(p)
    step(p, batches[0])
    ck.save(d, 1, {"params": p, "opt": ck.optimizer_state_tree(opt, p)},
            process_set=ps)
    loss = step(p, batches[1])

    out, at = ck.restore(d, _like(trainable(_draw(cfg, 5))), process_set=ps)
    assert at == 1
    rp = out["params"]
    assert all(t.requires_grad for t in tree_leaves(rp))
    ropt, rstep = stepper(rp)
    ck.load_optimizer_state_tree(ropt, rp, out["opt"])
    rloss = rstep(rp, batches[1])
    assert torch.equal(rloss, loss)
    for (name, a), (_, b) in zip(tree_flatten_with_path(rp),
                                 tree_flatten_with_path(p)):
        assert torch.equal(a, b), name
    st, rst = (ck.optimizer_state_tree(o, t) for o, t in ((opt, p),
                                                           (ropt, rp)))
    for (name, a), (_, b) in zip(tree_flatten_with_path(rst),
                                 tree_flatten_with_path(st)):
        assert a.device == b.device and torch.equal(a, b), name


def test_optimizer_state_tree_contract():
    cfg = tfm.tiny()
    p = _draw(cfg, 0)
    opt = torch.optim.AdamW(tree_leaves(p), **ADAMW)
    with pytest.raises(ValueError, match="before its first step"):
        ck.optimizer_state_tree(opt, p)
    with pytest.raises(ValueError, match="tree_leaves"):
        ck.optimizer_state_tree(opt, {"x": p["embed"]})
    opt = _adamw_state(p, _draw(cfg, 1))
    tree = ck.optimizer_state_tree(opt, p)
    assert sorted(tree) == ["exp_avg", "exp_avg_sq", "step"]
    leaves = tree_leaves(p)
    for k in ("exp_avg", "exp_avg_sq"):
        for leaf, t in zip(leaves, tree_leaves(tree[k])):
            assert t.data_ptr() == opt.state[leaf][k].data_ptr()
            assert not hasattr(opt.state[leaf][k], "mesh_spec")
