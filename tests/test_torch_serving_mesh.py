"""Serving under a mesh (horovod_tpu_torch/serving with ``mesh=``): the
engine's steps and the cache against the JAX package's engine on its
8-device CPU mesh, where GSPMD shards the heads and the vocabulary by
``param_specs``. ``ServeLoop`` under a mesh is in
test_torch_serving_mesh_loop.py.

``tiny`` in float32, dense and with ``n_experts=2``
(``torch_serving_mesh_parity``), at ``{"model": 2}`` and ``{"model":
4}``. The port's ranks are threads (``run_worlds``), each with a gloo
``World``, its shard of the params (``shard_params``) and its heads of
the cache (``make_cache(mesh=)``).

- The engine's four steps (prefill, batched prefill, decode, chunk) in
  turn on one cache: every logit within 1e-4 of JAX's engine under
  ``Mesh(devices[:m], ("model",))`` (both configs' four steps in one
  jitted program per mesh) and of the port's mesh-free engine, and
  bit-equal on every rank; each rank's K/V within 1e-5 of its head block
  of the mesh-free cache.
- The reference's error for heads that do not divide the model axis.
- C4, a vocabulary the model axis does not divide: ``tiny`` with
  bert-large's 30522 rows under ``{"model": 4}`` (padded to 4 x 7631
  rows by ``shard_params``). Prefill and three greedy decode steps hold
  every logit within 1e-4 of the reference's engine on replicated params
  (its GSPMD pads the split), the same tokens, 30522 logits and no pad
  column. A train step gives the pad rows no gradient and AdamW leaves
  them zero; a checkpoint of the params and AdamW's moments records the
  unpadded shape, writes no pad row, restores under ``{"model": 4}``
  with zeros in the pad and under ``{"model": 2}`` (no pad) and whole;
  ``gather_params`` returns the 30522 rows.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

torch.set_num_threads(1)

from horovod_tpu.serving import engine as jeng  # noqa: E402
from horovod_tpu.serving import kv_cache as jkv  # noqa: E402
from horovod_tpu_torch import checkpoint  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import (  # noqa: E402
    gather_params, shard_params)
from horovod_tpu_torch.parallel import create_mesh  # noqa: E402
from horovod_tpu_torch.parallel.mesh import leaf_spec  # noqa: E402
from horovod_tpu_torch.process_sets import ProcessSet  # noqa: E402
from horovod_tpu_torch.tree import tree_leaves, tree_map  # noqa: E402
from horovod_tpu_torch.serving import engine, kv_cache  # noqa: E402
from horovod_tpu_torch.serving import loop as tloop  # noqa: E402

from .torch_serving_mesh_parity import (  # noqa: E402
    _to_numpy, cfgs, jax_mesh, params, place)
from .torch_train_parity import run_worlds  # noqa: E402

TOL_LOGITS = 1e-4
TOL_KV = 1e-5
GEO = dict(n_pages=16, page_size=8, max_context=32)    # max_kv 32
B, Q = 3, 4          # batch slots; chunk window
EXPERTS = (0, 2)


def _inputs():
    """Step inputs, numpy from a seed: request A (11 tokens, pages 1-2)
    prefilled alone, B (7, pages 3-4) and C (13, pages 5-6) in one batched
    prefill beside an inactive row, then one decode step of A and B (C's
    slot inactive) and one chunk of Q tokens for A and C."""
    rng = np.random.default_rng(9)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    lens = np.array([11, 7, 13], np.int32)
    toks = np.zeros((B, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    return {
        "prefill": (toks[0], np.int32(lens[0]), tables[0]),
        "bprefill": (np.stack([toks[1], toks[2], toks[0]]),
                     np.array([7, 13, 1], np.int32), tables[[1, 2, 0]],
                     np.array([True, True, False])),
        "decode": (rng.integers(0, 256, B).astype(np.int32),
                   np.array([11, 7, 13], np.int32), tables,
                   np.array([True, True, False])),
        "chunk": (rng.integers(0, 256, (B, Q)).astype(np.int32),
                  np.array([12, 0, 13], np.int32), tables,
                  np.array([True, False, True])),
    }


INPUTS = _inputs()
STEPS = ("prefill", "bprefill", "decode", "chunk")


def _run_steps(steps, params, cache):
    logits = {}
    for name in STEPS:
        cache, logits[name] = steps[name](params, cache, *INPUTS[name])
    return cache, logits


_JAX_STEPS = {}


def _jax_steps(n_experts, m):
    """JAX's logits of the four steps under ``{"model": m}``; both
    configs' in one jitted program, computed once per mesh."""
    if (n_experts, m) not in _JAX_STEPS:
        mesh = jax_mesh(m)
        geo = jkv.geometry(**GEO)
        runs, args = [], []
        for e in EXPERTS:
            jcfg, _ = cfgs(e)
            runs.append({
                "prefill": jeng.make_prefill(jcfg, geo, mesh),
                "bprefill": jeng.make_batched_prefill(jcfg, geo, mesh),
                "decode": jeng.make_decode_step(jcfg, geo, mesh, B),
                "chunk": jeng.make_chunk_step(jcfg, geo, mesh, q_len=Q)})
            args.append((place(params(e)[1], jcfg, mesh),
                         jkv.make_cache(jcfg, geo, mesh)))
        out = jax.jit(lambda a: [_run_steps(st, *pc)[1]
                                 for st, pc in zip(runs, a)])(args)
        for e, logits in zip(EXPERTS, out):
            _JAX_STEPS[e, m] = {k: np.asarray(v) for k, v in logits.items()}
    return _JAX_STEPS[n_experts, m]


def _port_steps(tcfg, params, mesh=None):
    geo = kv_cache.geometry(**GEO)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    steps = {"prefill": engine.make_prefill(tcfg, geo, **kw),
             "bprefill": engine.make_batched_prefill(tcfg, geo, **kw),
             "decode": engine.make_decode_step(tcfg, geo, max_batch=B, **kw),
             "chunk": engine.make_chunk_step(tcfg, geo, q_len=Q, **kw)}
    return _run_steps(steps, params, kv_cache.make_cache(tcfg, geo, **kw))


@pytest.mark.parametrize("n_experts", EXPERTS, ids=["dense", "moe"])
@pytest.mark.parametrize("m", [2, 4])
def test_engine_steps_match_jax_and_mesh_free(m, n_experts):
    _, tcfg = cfgs(n_experts)
    full = params(n_experts)[0]
    want = _jax_steps(n_experts, m)
    free_cache, free = _port_steps(tcfg, full)

    def rank(world):
        mesh = create_mesh({"model": m}, world)
        return _port_steps(tcfg, shard_params(full, tcfg, mesh), mesh)

    ranks = run_worlds(m, rank)
    h = tcfg.n_heads // m
    for r, (cache, logits) in enumerate(ranks):
        for name in STEPS:
            got = logits[name]
            assert torch.equal(got, ranks[0][1][name]), (r, name)
            np.testing.assert_allclose(got.numpy(), want[name],
                                       atol=TOL_LOGITS, rtol=0,
                                       err_msg=f"{name} vs JAX")
            torch.testing.assert_close(got, free[name], atol=TOL_LOGITS,
                                       rtol=0)
        for kv in ("k", "v"):
            assert cache[kv].shape[3] == h
            torch.testing.assert_close(
                cache[kv], free_cache[kv][..., r * h:(r + 1) * h, :],
                atol=TOL_KV, rtol=0)


def test_cache_holds_its_heads_only():
    """``make_cache(mesh=)`` allocates n_heads / model heads per rank on
    the mesh's device; ``spec`` and ``cache_bytes`` (the whole cache's)
    are the reference's."""
    jcfg, tcfg = cfgs(0)
    geo = kv_cache.geometry(**GEO)

    def rank(world):
        mesh = create_mesh({"data": 2, "model": 2}, world)
        c = kv_cache.make_cache(tcfg, geo, mesh=mesh)
        return tuple(c["k"].shape), c["v"].device.type

    want = (tcfg.n_layers, 16, 8, tcfg.n_heads // 2, tcfg.head_dim)
    assert run_worlds(4, rank) == [(want, "cpu")] * 4
    assert kv_cache.spec(tcfg) == tuple(jkv.spec(jcfg))
    assert kv_cache.cache_bytes(tcfg, geo) == jkv.cache_bytes(
        jcfg, jkv.geometry(**GEO))


def test_heads_that_do_not_divide_raise_as_the_reference():
    """4 heads over a model axis of 3: the reference refuses the cache's
    placement; the port refuses the cache, every engine step and the
    loop, with the reference's words."""
    jcfg, tcfg = cfgs(0)
    msg = "dimension 3 should be divisible by 3, but it is equal to 4"
    with pytest.raises(ValueError, match=msg):
        jkv.make_cache(jcfg, jkv.geometry(**GEO), jax_mesh(3))
    geo = kv_cache.geometry(**GEO)

    def rank(world):
        mesh = create_mesh({"model": 3}, world)
        calls = [lambda: kv_cache.make_cache(tcfg, geo, mesh=mesh),
                 lambda: engine.make_prefill(tcfg, geo, mesh=mesh),
                 lambda: engine.make_batched_prefill(tcfg, geo, mesh=mesh),
                 lambda: engine.make_decode_step(tcfg, geo, mesh=mesh),
                 lambda: engine.make_chunk_step(tcfg, geo, mesh=mesh),
                 lambda: tloop.ServeLoop(params(0)[0], tcfg, geo=geo,
                                         mesh=mesh)]
        for call in calls:
            with pytest.raises(ValueError, match=msg):
                call()
        with pytest.raises(ValueError, match="not the mesh's device"):
            kv_cache.make_cache(tcfg, geo, device="meta", mesh=mesh)
        return True

    assert all(run_worlds(3, rank))


# ---------------------------------------------------------------------------
# C4: a vocabulary the model axis does not divide

VOCAB = 30522          # bert-large's: 2 * 3 * 5087, not a multiple of 4
M4 = 4
DECODE_STEPS = 3
_UNEVEN = {}


def _uneven():
    """(JAX config, port config, port params, the same as numpy) of
    ``tiny`` in float32 with bert-large's vocabulary."""
    if not _UNEVEN:
        jcfg, tcfg = (dataclasses.replace(c, vocab_size=VOCAB)
                      for c in cfgs(0))
        tp = ttfm.init_params(tcfg, torch.Generator().manual_seed(44),
                              device="cpu")
        _UNEVEN.update(cfgs=(jcfg, tcfg), params=(tp, _to_numpy(tp)))
    return _UNEVEN["cfgs"] + _UNEVEN["params"]


def _uneven_prompt():
    """11 prompt tokens from a seed, with the table's last real row and
    rows on each side of the ranks' block edges."""
    toks = np.zeros(32, np.int32)
    toks[:11] = np.random.default_rng(12).integers(0, VOCAB, 11)
    toks[[2, 5, 8]] = [VOCAB - 1, 7630, 7631]
    return toks


def _greedy_chain(prefill, decode, params, cache, greedy):
    """Prefill the prompt into pages 1-2, then DECODE_STEPS greedy decode
    steps of slot 0 (the other slots inactive); every step's logits."""
    tables = np.array([[1, 2, 0, 0]] * B, np.int32)
    cache, logits = prefill(params, cache, _uneven_prompt(), np.int32(11),
                            tables[0])
    out = [logits]
    for i in range(DECODE_STEPS):
        tok = np.zeros(B, np.int32)
        tok[0] = greedy(out[-1])
        cache, logits = decode(params, cache, tok,
                               np.array([11 + i, 0, 0], np.int32), tables,
                               np.array([True, False, False]))
        out.append(logits[0])
    return out


def test_uneven_vocab_serves_as_the_reference():
    jcfg, tcfg, tp, npp = _uneven()
    geo = jkv.geometry(**GEO)
    mesh = jax_mesh(M4)
    replicated = jax.device_put(npp, NamedSharding(mesh, PartitionSpec()))
    want = [np.asarray(x) for x in _greedy_chain(
        jeng.make_prefill(jcfg, geo, mesh),
        jeng.make_decode_step(jcfg, geo, mesh, B), replicated,
        jkv.make_cache(jcfg, geo, mesh), lambda x: int(np.argmax(x)))]

    def rank(world):
        mesh = create_mesh({"model": M4}, world)
        shard = shard_params(tp, tcfg, mesh)
        embed = shard["embed"]
        g = kv_cache.geometry(**GEO)
        got = _greedy_chain(
            engine.make_prefill(tcfg, g, mesh=mesh),
            engine.make_decode_step(tcfg, g, max_batch=B, mesh=mesh), shard,
            kv_cache.make_cache(tcfg, g, mesh=mesh),
            lambda x: int(engine.greedy(x)))
        return tuple(embed.shape), leaf_spec(embed), got

    ranks = run_worlds(M4, rank)
    pad = M4 * 7631 - VOCAB
    for r, (shape, spec, got) in enumerate(ranks):
        assert shape == (7631, tcfg.d_model)
        assert spec == ("model", None) and spec[0].size == VOCAB
        for i, (a, w) in enumerate(zip(got, want)):
            assert tuple(a.shape) == (VOCAB,), (r, i)
            assert torch.equal(a, ranks[0][2][i]), (r, i)
            np.testing.assert_allclose(a.numpy(), w, atol=TOL_LOGITS, rtol=0,
                                       err_msg=f"step {i} vs JAX")
            assert int(a.argmax()) == int(np.argmax(w)), (r, i)
    # the last block: its real rows, then the pad's zero rows
    last = shard_params(tp, tcfg, _FakeMesh(M4, M4 - 1))["embed"]
    assert torch.equal(last[-pad:], torch.zeros(pad, tcfg.d_model))
    assert torch.equal(last[:-pad], tp["embed"][3 * 7631:])


class _FakeMesh:
    """A one-axis ``{"model": n}`` layout at coordinate ``c``, for
    ``shard_params`` alone (no process group)."""

    def __init__(self, n, c):
        self.axis_names, self.shape, self._c = ("model",), {"model": n}, c

    def coords(self):
        return (self._c,)


def test_uneven_vocab_trains_and_saves_no_pad_row(tmp_path):
    _, tcfg, tp, _ = _uneven()
    pad = M4 * 7631 - VOCAB
    tokens = np.random.default_rng(13).integers(0, VOCAB, (2, 17))
    tokens[0, :3] = [VOCAB - 1, VOCAB - 2, 7631]
    batch = {"tokens": torch.tensor(tokens).long()}
    free = {k: tree_map(lambda x: x.detach().clone().requires_grad_(), v)
            for k, v in tp.items()}
    free_loss = ttfm.loss_fn(free, batch, tcfg)
    free_grad = torch.autograd.grad(free_loss, free["embed"])[0]
    d = str(tmp_path)

    def train_and_save(world):
        mesh = create_mesh({"model": M4}, world)
        sp = shard_params(tp, tcfg, mesh)
        leaves = [x.requires_grad_() for x in tree_leaves(sp)]
        opt = torch.optim.AdamW(leaves, lr=1e-2, weight_decay=0.1)
        loss = ttfm.loss_fn(sp, batch, tcfg, mesh=mesh)
        loss.backward()
        grad = sp["embed"].grad.clone()
        opt.step()
        checkpoint.save(d, 1, {"params": sp, "opt": checkpoint
                               .optimizer_state_tree(opt, sp)},
                        process_set=ProcessSet.from_world(world), mesh=mesh,
                        async_=False)
        whole = gather_params(sp, tcfg, mesh)["embed"]
        return loss.item(), grad, sp["embed"].detach().clone(), whole

    out = _on_ranks4(train_and_save)
    rows = 7631
    for r, (loss, grad, embed, whole) in enumerate(out):
        assert abs(loss - free_loss.item()) <= 1e-5
        n = min(rows, VOCAB - r * rows)
        torch.testing.assert_close(grad[:n], free_grad[r * rows:][:n],
                                   atol=1e-6, rtol=1e-5)
        assert torch.equal(grad[n:], torch.zeros_like(grad[n:]))
        assert torch.equal(embed[n:], torch.zeros_like(embed[n:]))
        assert tuple(whole.shape) == (VOCAB, tcfg.d_model)
        assert torch.equal(whole, out[0][3])
    saved = torch.cat([o[2] for o in out])[:VOCAB]
    assert torch.equal(out[0][3], saved)

    with open(os.path.join(d, "1", "MANIFEST.json")) as f:
        tensors = json.load(f)["tensors"]
    shapes = {n: t["global_shape"] for n, t in tensors.items()
              if "'embed'" in n and "'step'" not in n}
    assert len(shapes) == 3 and all(v == [VOCAB, tcfg.d_model]
                                    for v in shapes.values()), shapes

    def restore(m):
        def fn(world):
            mesh = create_mesh({"model": m}, world)
            like = shard_params(tp, tcfg, mesh)
            got, _ = checkpoint.restore(
                d, {"params": like}, process_set=ProcessSet.from_world(world),
                mesh=mesh)
            return got["params"]["embed"], leaf_spec(got["params"]["embed"])
        return fn

    for r, (embed, spec) in enumerate(_on_ranks4(restore(M4))):
        assert torch.equal(embed, out[r][2]) and spec[0].size == VOCAB
    halves = run_worlds(2, restore(2))
    assert not hasattr(halves[0][1][0], "size")     # 30522 = 2 * 15261
    assert torch.equal(torch.cat([h[0] for h in halves]), saved)
    whole, _ = checkpoint.restore(d, {"params": {"embed": torch.zeros(
        VOCAB, tcfg.d_model)}}, process_set=ProcessSet.from_world(
            _one_world()), coordinate=False)
    assert torch.equal(whole["params"]["embed"], saved)
    assert pad == 2


def _on_ranks4(fn):
    return run_worlds(M4, fn)


def _one_world():
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import World

    return World(dist.HashStore(), 0, 1, "cpu")
