"""The port's data-parallel step (horovod_tpu_torch/parallel/data_parallel.py)
against itself on one process and against the JAX package's
``make_train_step`` on a 2-device CPU mesh; Adasum at 2 and 4 ranks, a
tuple ``data_axis`` over a ``{"data": 2, "seq": 2}`` mesh and an
``extra_reduce`` hook against the same on 2- and 4-device meshes.

Ranks run in one process: threads, each with its own
``torch.distributed.ProcessGroupGloo`` (or a ``World`` of them, for a
mesh) over one shared ``HashStore``; each thread is joined with a
timeout, and a thread still alive fails the test. No process is
spawned.

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
import functools
from concurrent.futures import ThreadPoolExecutor

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
    bucket_plan, create_mesh, make_train_step, replicate, shard_batch,
    tree_flatten_with_path, tree_leaves)

from .torch_train_parity import run_ranks, run_worlds  # noqa: E402

JCFG = dataclasses.replace(jtfm.tiny(), dtype="float32", attn_impl="gather")
TCFG = dataclasses.replace(ttfm.tiny(), dtype="float32", attn_impl="gather")
TOKENS = np.random.default_rng(30).integers(0, 256, (4, 17), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jtfm.tiny())


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def _port_train(jax_params, group, steps=1, data_axis="data", **kw):
    """Params and losses after ``steps`` steps of the port's step on this
    rank's shard of TOKENS."""
    params = params_from_jax(jax.tree.map(np.asarray, jax_params),
                             device="cpu")
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = make_train_step(lambda p, b: ttfm.loss_fn(p, b, TCFG), opt,
                           group, data_axis=data_axis, **kw)
    batch = shard_batch({"tokens": torch.tensor(TOKENS).long()}, group,
                        data_axis)
    losses = [step(params, batch).item() for _ in range(steps)]
    return {p: x.detach().numpy().copy()
            for p, x in tree_flatten_with_path(params)}, losses


def _jax_hook(g):
    """test_extra_reduce_equals_jax's hook on the reference's side."""
    return dict(g, embed=-g["embed"], final_ln=jax.tree.map(
        lambda v: 0.0 * v, g["final_ln"]))


# Every reference step of this file (the JAX package's make_train_step
# with these arguments, one step from the same params), by mesh. Each
# step is its own jitted program, traced one after another and compiled
# side by side (XLA compiles outside the GIL), which takes less time
# than one program of all of a mesh's steps and gives the same bits.
JAX_CASES = {
    (("data", 2),): {
        **{f"accum {a}, buckets {b}": dict(accum_steps=a, bucket_bytes=b)
           for a in (1, 2) for b in (0, 16 << 10)},
        "bf16": dict(bucket_bytes=16 << 10,
                     compression=jax_compression.Compression.bf16),
        "adasum": dict(grad_reduce="adasum", bucket_bytes=16 << 10),
        "extra_reduce": dict(extra_reduce=_jax_hook),
    },
    (("data", 4),): {
        "adasum": dict(grad_reduce="adasum", bucket_bytes=16 << 10)},
    (("data", 2), ("seq", 2)): {
        "tuple": dict(data_axis=("data", "seq"))},
}


@functools.lru_cache(maxsize=None)
def _jax_refs(shape):
    """{case: (params after one step by path, [loss])} of every case of
    ``JAX_CASES[shape]``."""
    sizes = dict(shape)
    devices = np.array(jax.devices()[:int(np.prod(list(sizes.values())))])
    mesh = Mesh(devices.reshape(tuple(sizes.values())), tuple(sizes))
    tx = optax.adamw(1e-4)
    steps, batches = {}, {}
    for case, kw in JAX_CASES[shape].items():
        kw = dict(kw)
        data_axis = kw.pop("data_axis", "data")
        steps[case] = jdp.make_train_step(
            lambda p, b: jtfm.loss_fn(p, b, JCFG), tx, mesh,
            data_axis=data_axis, donate=False, **kw)
        batches[case] = jdp.shard_batch({"tokens": TOKENS}, mesh, data_axis)
    params = jdp.replicate(_jax_params(), mesh)
    state = jdp.replicate(tx.init(_jax_params()), mesh)
    lowered = [jax.jit(steps[case]).lower(params, state, batches[case])
               for case in steps]
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    out = {case: fn(params, state, batches[case])
           for case, fn in zip(steps, compiled)}
    return {case: ({jax.tree_util.keystr(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_leaves_with_path(new)}, [float(loss)])
            for case, (new, _, loss) in out.items()}


def _jax_train(case, shape=(("data", 2),)):
    return _jax_refs(shape)[case]


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
    _assert_close(ranks[0], _jax_train(
        f"accum {accum_steps}, buckets {bucket_bytes}"), atol=1e-5)


def test_bf16_wire_cast_equals_jax(jax_params):
    """Compression.bf16 on the bucketed path: each bucket crosses the wire
    in bf16, on both sides (the step's first update is ~lr * sign(g), so
    the bf16 rounding of the mean moves the params by no more than the
    float32 case's tolerance)."""
    kw = dict(bucket_bytes=16 << 10)
    ranks = run_ranks(2, lambda g, r: _port_train(
        jax_params, g, compression=compression.Compression.bf16, **kw))
    _assert_close(ranks[0], _jax_train("bf16"), atol=1e-5)


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


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_equals_jax(jax_params, n):
    """grad_reduce="adasum" over a mesh of n ranks (every gradient leaf
    through the VHDD recursion, buckets off, the loss averaged) against
    the reference's on an n-device mesh; it moves the params otherwise
    than the mean (the one-process step) does."""
    shape = {"data": n}
    kw = dict(grad_reduce="adasum", bucket_bytes=16 << 10)
    ranks = run_worlds(n, lambda w: _port_train(
        jax_params, create_mesh(shape, w), **kw))
    for r in ranks[1:]:
        _assert_close(r, ranks[0], atol=0)
    with pytest.raises(AssertionError):
        _assert_close(ranks[0], _port_train(jax_params, None), atol=1e-5)
    _assert_close(ranks[0], _jax_train("adasum", (("data", n),)),
                  atol=1e-5)


def test_tuple_data_axis_equals_jax(jax_params):
    """data_axis=("data", "seq") over {"data": 2, "seq": 2}: the batch
    split over both axes (data major) and the gradients and the loss
    averaged over each in turn, as the reference's P(("data", "seq"))
    and per-axis pmean."""
    shape, axes = {"data": 2, "seq": 2}, ("data", "seq")
    ranks = run_worlds(4, lambda w: _port_train(
        jax_params, create_mesh(shape, w), data_axis=axes))
    _assert_close(ranks[3], ranks[0], atol=0)
    _assert_close(ranks[0], _port_train(jax_params, None), atol=1e-6)
    _assert_close(ranks[0], _jax_train("tuple", tuple(shape.items())),
                  atol=1e-5)


def test_extra_reduce_equals_jax(jax_params):
    """An extra_reduce hook that scales the reduced gradients, negating
    embed's and zeroing final_ln's (AdamW cancels a positive common
    factor, not these), runs before the optimizer on both sides."""
    def port_hook(g):
        return dict(g, embed=-g["embed"], final_ln={
            k: 0.0 * v for k, v in g["final_ln"].items()})

    ranks = run_ranks(2, lambda g, r: _port_train(
        jax_params, g, extra_reduce=port_hook))
    with pytest.raises(AssertionError):     # the hook moved the params
        _assert_close(ranks[0], _port_train(jax_params, None), atol=1e-5)
    _assert_close(ranks[0], _jax_train("extra_reduce"), atol=1e-5)
