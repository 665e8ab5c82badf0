"""The port's Horovod API (horovod_tpu_torch/hvd.py) on the CPU.

- ``DistributedOptimizer`` around ``torch.optim.AdamW`` at 2 ranks, after
  ``broadcast_parameters``, against the JAX package's ``make_train_step``
  with ``optax.adamw`` on a 2-device mesh: one step on each rank's half
  of the batch; ``backward_passes_per_step=2`` over two microbatches
  against ``accum_steps=2`` on the same split, the params untouched by
  the first call; ``Compression.bf16`` against the reference's bf16 wire
  cast. Params and the loss within 1e-5 (as test_torch_data_parallel.py:
  an element whose gradient is at float32 noise can move by a different
  fraction of lr).
- ``broadcast_optimizer_state`` gives rank 1 rank 0's AdamW state.
- ``init``/``shutdown`` in this process: gloo at size 1, from a
  ``HashStore`` or from a ``TCPStore`` at ``HVD_JAX_COORD_ADDR``.

Ranks are threads, each with its own gloo ``World`` over one shared
``HashStore`` and its own ``ProcessSet``; no process is spawned.
"""

import dataclasses
import functools
import socket

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu.parallel import data_parallel as jdp  # noqa: E402
from horovod_tpu import compression as jax_compression  # noqa: E402
import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch import compression  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    tree_flatten_with_path, tree_leaves)

from .torch_train_parity import run_worlds  # noqa: E402

JCFG = dataclasses.replace(jtfm.tiny(), dtype="float32", attn_impl="gather")
TCFG = dataclasses.replace(ttfm.tiny(), dtype="float32", attn_impl="gather")
TOKENS = np.random.default_rng(31).integers(0, 256, (4, 17), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(5), jtfm.tiny())


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def _params(jax_params):
    params = params_from_jax(jax.tree.map(np.asarray, jax_params),
                             device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    return params


def _adamw(params):
    return torch.optim.AdamW(tree_leaves(params), lr=1e-4,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _snapshot(params):
    return {p: x.detach().numpy().copy()
            for p, x in tree_flatten_with_path(params)}


def _hvd_train(jax_params, world, micro=1, **kw):
    """One optimizer step of rank ``world.rank`` on its rows of TOKENS,
    in ``micro`` backward passes, through DistributedOptimizer; returns
    (params after each call, the loss averaged over the ranks)."""
    ps = hvd.ProcessSet.from_world(world)
    params = _params(jax_params)
    if world.rank == 1:   # broadcast_parameters has to undo this
        with torch.no_grad():
            for leaf in tree_leaves(params):
                leaf.add_(1.0)
    hvd.broadcast_parameters(params, root_rank=0, process_set=ps)
    opt = hvd.DistributedOptimizer(_adamw(params), process_set=ps,
                                   backward_passes_per_step=micro, **kw)
    rows = TOKENS.shape[0] // world.size
    mine = torch.tensor(TOKENS[world.rank * rows:(world.rank + 1) * rows])
    snaps, losses = [], []
    for m in range(micro):
        n = rows // micro
        loss = ttfm.loss_fn(params, {"tokens": mine[m * n:(m + 1) * n]
                                     .long()}, TCFG)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        snaps.append(_snapshot(params))
    return snaps, hvd.metric_average(np.mean(losses), process_set=ps)


# The reference steps of this file (the JAX package's make_train_step
# with these arguments, one step on a 2-device mesh), all in one jitted
# program: one compile, where one a case would be three.
JAX_CASES = {
    "accum 1": dict(accum_steps=1),
    "accum 2": dict(accum_steps=2),
    "bf16": dict(bucket_bytes=1 << 30,
                 compression=jax_compression.Compression.bf16),
}


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """{case: (params after the step by path, loss)}."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    tx = optax.adamw(1e-4)
    steps = {case: jdp.make_train_step(
        lambda p, b: jtfm.loss_fn(p, b, JCFG), tx, mesh, donate=False, **kw)
        for case, kw in JAX_CASES.items()}
    out = jax.jit(lambda params, state, batch: {
        case: step(params, state, batch) for case, step in steps.items()})(
        jdp.replicate(_jax_params(), mesh),
        jdp.replicate(tx.init(_jax_params()), mesh),
        jdp.shard_batch({"tokens": TOKENS}, mesh))
    return {case: ({jax.tree_util.keystr(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_leaves_with_path(params)},
                   float(loss))
            for case, (params, _, loss) in out.items()}


def _jax_train(case):
    return _jax_refs()[case]


def _assert_close(got, want, atol=1e-5):
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("micro", [1, 2])
def test_distributed_optimizer_equals_jax(jax_params, micro):
    ranks = run_worlds(2, lambda w: _hvd_train(jax_params, w, micro=micro))
    want, want_loss = _jax_train(f"accum {micro}")
    start = _snapshot(_params(jax_params))
    for snaps, loss in ranks:
        if micro == 2:      # the first call leaves the params as they were
            _assert_close(snaps[0], start, atol=0)
        _assert_close(snaps[-1], want)
        assert abs(loss - want_loss) <= 1e-5
    _assert_close(ranks[1][0][-1], ranks[0][0][-1], atol=0)


def test_distributed_optimizer_bf16_wire_equals_jax(jax_params):
    """Compression.bf16: each float bucket crosses in bf16, on both sides;
    the wrapper counts the decision once, as engaged."""
    before = compression.stats()["engaged"]
    ranks = run_worlds(2, lambda w: _hvd_train(
        jax_params, w, compression=hvd.Compression.bf16))
    assert compression.stats()["engaged"] - before == 2   # one per rank
    want, _ = _jax_train("bf16")
    for snaps, _ in ranks:
        _assert_close(snaps[-1], want)


def test_broadcast_optimizer_state(jax_params):
    """Rank 0 steps its AdamW once and rank 1 twice, on other data (no
    reduction); then rank 1 holds rank 0's state, tensor for tensor, each
    on the device it was on ("step" on the CPU), and its hyperparameters."""
    def body(world):
        ps = hvd.ProcessSet.from_world(world)
        params = _params(jax_params)
        opt = _adamw(params)
        for _ in range(world.rank + 1):
            rows = torch.tensor(TOKENS[world.rank:world.rank + 2]).long()
            ttfm.loss_fn(params, {"tokens": rows}, TCFG).backward()
            opt.step()
            opt.zero_grad()
        hvd.broadcast_optimizer_state(opt, root_rank=0, process_set=ps)
        return opt.state_dict()

    ranks = run_worlds(2, body)
    s0, s1 = ranks[0]["state"], ranks[1]["state"]
    assert s0.keys() == s1.keys()
    for i in s0:
        for k in s0[i]:
            assert s1[i][k].device == s0[i][k].device
            assert torch.equal(s1[i][k], s0[i][k]), (i, k)
    assert ranks[1]["param_groups"] == ranks[0]["param_groups"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("store", ["hash", "tcp"])
def test_init_shutdown_on_cpu(monkeypatch, store):
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE",
              "HVD_CROSS_RANK", "HVD_CROSS_SIZE", "HVD_JAX_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    if store == "tcp":
        monkeypatch.setenv("HVD_JAX_COORD_ADDR", f"127.0.0.1:{_free_port()}")
    hvd.init(device="cpu")
    try:
        hvd.init(device="cpu")                      # idempotent
        assert hvd.is_initialized() and not hvd.is_multiprocess()
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.global_process_set.ranks == [0]
        assert hvd.global_process_set.group.name() == "gloo"
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allgather(x), x)
        np.testing.assert_array_equal(hvd.process_allgather(np.arange(3)),
                                      np.arange(3)[None])
        mesh = hvd.global_mesh({"data": -1})
        assert mesh.shape == {"data": 1}
        batch = hvd.shard_local_batch({"x": x}, mesh)
        assert torch.equal(batch["x"], x)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()
    assert hvd.global_process_set.group is None
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.rank()


@pytest.mark.parametrize("addr", [None, "negotiate", "127.0.0.1:"])
def test_init_needs_a_host_port_for_more_ranks(monkeypatch, addr):
    monkeypatch.setenv("HVD_SIZE", "2")
    if addr is None:
        monkeypatch.delenv("HVD_JAX_COORD_ADDR", raising=False)
    else:
        monkeypatch.setenv("HVD_JAX_COORD_ADDR", addr)
    with pytest.raises(ValueError, match="HVD_JAX_COORD_ADDR"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
