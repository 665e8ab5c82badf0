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
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.serving import engine as jeng  # noqa: E402
from horovod_tpu.serving import kv_cache as jkv  # noqa: E402
from horovod_tpu_torch.models.convert import shard_params  # noqa: E402
from horovod_tpu_torch.parallel import create_mesh  # noqa: E402
from horovod_tpu_torch.serving import engine, kv_cache  # noqa: E402
from horovod_tpu_torch.serving import loop as tloop  # noqa: E402

from .torch_serving_mesh_parity import cfgs, jax_mesh, params, place  # noqa: E402
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
