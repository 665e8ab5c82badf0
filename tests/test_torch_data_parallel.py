"""The port's data-parallel step (horovod_tpu_torch/parallel/data_parallel.py)
against itself on one process and against the JAX package's
``make_train_step`` on a 2-device CPU mesh.

Two ranks run in one process: two threads, each with its own
``torch.distributed.ProcessGroupGloo`` over one shared ``HashStore``;
each thread is joined with a timeout, and a thread still alive fails the
test. No process is spawned.

Model: ``tiny()`` dense, float32, gather attention; AdamW(lr=1e-4,
weight_decay=1e-4) on both sides (optax.adamw(1e-4) in JAX).

Tolerances: the 2-rank step against the 1-process full-batch step,
params within 1e-6 and the loss within 1e-6 (the two average the same
per-row gradients in another order); against JAX, params within 1e-5
(as test_torch_train.py's AdamW check: an element whose gradient is at
float32 noise can move by a different fraction of lr) and the loss
within 1e-5.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(1)

from horovod_tpu import compression as jax_compression  # noqa: E402
from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu.parallel import data_parallel as jdp  # noqa: E402
from horovod_tpu_torch import compression  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    bucket_plan, make_train_step, replicate, shard_batch,
    tree_flatten_with_path, tree_leaves)

from .torch_train_parity import run_ranks  # noqa: E402

JCFG = dataclasses.replace(jtfm.tiny(), dtype="float32", attn_impl="gather")
TCFG = dataclasses.replace(ttfm.tiny(), dtype="float32", attn_impl="gather")
TOKENS = np.random.default_rng(30).integers(0, 256, (4, 17), dtype=np.int32)


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jtfm.tiny())


def _port_train(jax_params, group, steps=1, **kw):
    """Params and losses after ``steps`` steps of the port's step on this
    rank's shard of TOKENS."""
    params = params_from_jax(jax.tree.map(np.asarray, jax_params),
                             device="cpu")
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = make_train_step(lambda p, b: ttfm.loss_fn(p, b, TCFG), opt,
                           group, **kw)
    batch = shard_batch({"tokens": torch.tensor(TOKENS).long()}, group)
    losses = [step(params, batch).item() for _ in range(steps)]
    return {p: x.detach().numpy().copy()
            for p, x in tree_flatten_with_path(params)}, losses


def _jax_train(jax_params, steps=1, **kw):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    tx = optax.adamw(1e-4)
    step = jdp.make_train_step(lambda p, b: jtfm.loss_fn(p, b, JCFG), tx,
                               mesh, donate=False, **kw)
    params = jdp.replicate(jax_params, mesh)
    state = jdp.replicate(tx.init(jax_params), mesh)
    batch = jdp.shard_batch({"tokens": TOKENS}, mesh)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(params)}, losses


def _assert_close(got, want, atol):
    params_g, losses_g = got
    params_w, losses_w = want
    np.testing.assert_allclose(losses_g, losses_w, atol=atol, rtol=0)
    assert list(params_g) == list(params_w)
    for path in params_w:
        np.testing.assert_allclose(params_g[path], params_w[path], atol=atol,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("bucket_bytes", [0, 16 << 10])
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_two_ranks_equal_one_process_and_jax(jax_params, accum_steps,
                                             bucket_bytes):
    kw = dict(accum_steps=accum_steps, bucket_bytes=bucket_bytes)
    ranks = run_ranks(2, lambda g, r: _port_train(jax_params, g, **kw))
    _assert_close(ranks[1], ranks[0], atol=0)         # replicas stay equal
    single = _port_train(jax_params, None, **kw)
    _assert_close(ranks[0], single, atol=1e-6)
    _assert_close(ranks[0], _jax_train(jax_params, **kw), atol=1e-5)


def test_bf16_wire_cast_equals_jax(jax_params):
    """Compression.bf16 on the bucketed path: each bucket crosses the wire
    in bf16, on both sides (the step's first update is ~lr * sign(g), so
    the bf16 rounding of the mean moves the params by no more than the
    float32 case's tolerance)."""
    kw = dict(bucket_bytes=16 << 10)
    ranks = run_ranks(2, lambda g, r: _port_train(
        jax_params, g, compression=compression.Compression.bf16, **kw))
    _assert_close(ranks[0], _jax_train(
        jax_params, compression=jax_compression.Compression.bf16, **kw),
        atol=1e-5)


def test_bucket_plan_matches_the_reference_rule(jax_params):
    """The port's plan over its leaves equals the reference's rule
    (_bucketed_grad_reduce, data_parallel.py:121-159) over
    jax.tree.flatten's leaf order, by leaf path, including a dtype split."""
    def reference(leaves, bucket_bytes):
        buckets, cur, cur_bytes = [], [], 0
        for i in reversed(range(len(leaves))):
            nbytes = leaves[i].size * leaves[i].dtype.itemsize
            if cur and (cur_bytes + nbytes > bucket_bytes
                        or leaves[cur[-1]].dtype != leaves[i].dtype):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
        return buckets

    mixed = dict(jax_params, final_ln=jax.tree.map(
        lambda x: x.astype(np.float16), jax_params["final_ln"]))
    for tree in (jax_params, mixed):
        jpaths, jleaves = zip(*(
            (jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)))
        items = tree_flatten_with_path(
            params_from_jax(jax.tree.map(np.asarray, tree), device="cpu"))
        assert [p for p, _ in items] == list(jpaths)
        assert len(items) == 20
        for nbytes in (0, 4096, 16 << 10, 64 << 10, 1 << 30):
            want = [[jpaths[i] for i in b]
                    for b in reference(jleaves, nbytes)]
            got = [[items[i][0] for i in b]
                   for b in bucket_plan([x for _, x in items], nbytes)]
            assert got == want, nbytes


def test_wire_cast_routing_is_counted():
    """One count per step built: bf16/fp16 with buckets engage; without
    buckets, or for a subclass (no cast equivalent), a fallback;
    Compression.none and no compression count nothing."""
    class Custom(compression.FP16Compressor):
        pass

    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    cases = [(compression.Compression.bf16, 1024, (1, 0)),
             (compression.Compression.fp16, 1024, (1, 0)),
             (compression.Compression.fp16, 0, (0, 1)),
             (Custom, 1024, (0, 1)),
             (compression.Compression.none, 1024, (0, 0)),
             (None, 1024, (0, 0))]
    for comp, nbytes, (engaged, fallback) in cases:
        before = compression.stats()
        make_train_step(lambda p, b: 0, opt, compression=comp,
                        bucket_bytes=nbytes)
        after = compression.stats()
        assert (after["engaged"] - before["engaged"],
                after["fallback"] - before["fallback"]) == (engaged, fallback)


def test_bad_arguments_raise(jax_params):
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        make_train_step(lambda p, b: 0, None, grad_reduce="adasum")
    with pytest.raises(ValueError):
        make_train_step(lambda p, b: 0, None, grad_reduce="max")
    with pytest.raises(ValueError, match="divisible by accum_steps"):
        _port_train(jax_params, None, accum_steps=3)


def test_replicate_and_shard_batch():
    """replicate gives every rank rank 0's values in place; shard_batch
    gives rank r rows [r*b/n, (r+1)*b/n) of every leaf."""
    def body(group, rank):
        tree = {"a": torch.full((3,), float(rank)), "b": [torch.arange(4.0)
                                                          + 10 * rank]}
        replicate(tree, group)
        batch = shard_batch({"x": torch.arange(8).reshape(4, 2)}, group)
        return tree, batch

    for tree, batch in run_ranks(2, body):
        assert torch.equal(tree["a"], torch.zeros(3))
        assert torch.equal(tree["b"][0], torch.arange(4.0))
    assert torch.equal(run_ranks(2, body)[1][1]["x"],
                       torch.tensor([[4, 5], [6, 7]]))
    with pytest.raises(ValueError, match="divisible by the group size"):
        run_ranks(2, lambda g, r: shard_batch({"x": torch.zeros(3)}, g))


@pytest.mark.parametrize("bucket_bytes", [0, 16 << 10])
def test_allreduce_gets_contiguous_tensors(jax_params, bucket_bytes):
    """NCCL refuses a non-contiguous tensor, and autograd hands some
    gradients back with permuted strides (embed's, from the tied output
    projection's einsum): every tensor the step all-reduces is
    contiguous. A group of one that records what it is given."""
    class Recorder:
        def __init__(self):
            self.seen = []

        def size(self):
            return 1

        def rank(self):
            return 0

        def allreduce(self, tensors):
            self.seen += tensors
            return self

        def wait(self):
            pass

    group = Recorder()
    got = _port_train(jax_params, group, bucket_bytes=bucket_bytes)
    assert len(group.seen) >= 2   # the gradients, then the loss
    assert all(t.is_contiguous() for t in group.seen)
    _assert_close(got, _port_train(jax_params, None,
                                   bucket_bytes=bucket_bytes), atol=0)
