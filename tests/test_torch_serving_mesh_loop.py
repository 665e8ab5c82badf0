"""``ServeLoop`` under a mesh (horovod_tpu_torch/serving/loop.py with
``mesh=``) against the JAX package's ``ServeLoop(mesh=)`` on its CPU
mesh. The engine's steps under a mesh are in test_torch_serving_mesh.py.

``tiny`` in float32, dense and with ``n_experts=2``
(``torch_serving_mesh_parity``). Every rank (a thread with a gloo
``World``, ``run_worlds``) runs its own loop on the same requests with
its shard of the params. Each rank reads its own clock, skewed against
the others (rank r's runs 1 + 4r times as fast), so that admissions
agree only through the loop's broadcast of rank 0's clock.

- With the prefix cache and speculation off and on, at ``{"model": 2}``
  and ``{"model": 4}``: the same greedy chains and admission order on
  every rank, and the chains of JAX's ``ServeLoop(mesh=)`` at ``{"model":
  2}`` (once per config; both features are invisible to greedy chains).
- The group the clock is broadcast over.
- At ``{"model": 1}`` every group has one rank and moves nothing
  (``sharding.solo``): the loop issues no collective and its chains are
  the mesh-free loop's.
- The load reporter is called on rank 0 of the decision group only.
"""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.serving import kv_cache as jkv  # noqa: E402
from horovod_tpu.serving import loop as jloop  # noqa: E402
from horovod_tpu_torch.models.convert import shard_params  # noqa: E402
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.parallel import create_mesh  # noqa: E402
from horovod_tpu_torch.serving import kv_cache  # noqa: E402
from horovod_tpu_torch.serving import loop as tloop  # noqa: E402

from .torch_serving_mesh_parity import cfgs, jax_mesh, params, place  # noqa: E402
from .torch_train_parity import run_worlds  # noqa: E402

GEO = dict(n_pages=32, page_size=8, max_context=64)


def _requests(make):
    """Shared-prefix traffic arriving over ~30 ms (the prefix cache hits
    it; the chains do not depend on when a request is admitted)."""
    return make.shared_prefix_requests(6, 200.0, np.random.default_rng(11),
                                       prefix_len=24, tail_len=(2, 6),
                                       max_new=(3, 8), vocab=256)


def _chains(finished):
    return {r.rid: (list(r.generated), r.finish_reason) for r in finished}


def _skewed_clock(rank):
    """A clock that runs 1 + 4 * rank times as fast as the host's."""
    t0, speed = time.monotonic(), 1 + 4 * rank
    return lambda: (time.monotonic() - t0) * speed


_JAX_CHAINS = {}


def _jax_chains(n_experts):
    """The chains of JAX's ``ServeLoop(mesh=)`` at ``{"model": 2}``, once
    per config, with the prefix cache, speculation and the batched
    prefill off (each is invisible to greedy chains; off, the loop
    compiles two steps)."""
    if n_experts not in _JAX_CHAINS:
        jcfg, _ = cfgs(n_experts)
        mesh = jax_mesh(2)
        jl = jloop.ServeLoop(place(params(n_experts)[1], jcfg, mesh), jcfg,
                             geo=jkv.geometry(**GEO), mesh=mesh,
                             max_batch=3, prefix_cache=False, spec_tokens=0,
                             batch_prefill=False)
        _JAX_CHAINS[n_experts] = _chains(jl.run(_requests(jloop))[1])
    return _JAX_CHAINS[n_experts]


@pytest.mark.parametrize("n_experts,m,prefix_cache,spec_tokens", [
    (0, 2, False, 0), (0, 4, True, 2), (2, 2, True, 2)],
    ids=["dense-m2-plain", "dense-m4-prefix-spec", "moe-m2-prefix-spec"])
def test_serveloop_ranks_agree_with_jax(n_experts, m, prefix_cache,
                                        spec_tokens):
    _, tcfg = cfgs(n_experts)
    full = params(n_experts)[0]
    kw = dict(max_batch=3, prefix_cache=prefix_cache, spec_tokens=spec_tokens)

    def rank(world):
        tmesh = create_mesh({"model": m}, world)
        tl = tloop.ServeLoop(shard_params(full, tcfg, tmesh), tcfg,
                             geo=kv_cache.geometry(**GEO), mesh=tmesh, **kw)
        tl.warmup()
        summary, fin = tl.run(_requests(tloop),
                              clock=_skewed_clock(world.rank))
        return summary, _chains(fin), {r.rid: r.admit_seq for r in fin}

    ranks = run_worlds(m, rank)
    summary, chains, admits = ranks[0]
    assert summary["requests"] == 6
    for other in ranks[1:]:
        assert other[1] == chains and other[2] == admits
    assert chains == _jax_chains(n_experts)
    if prefix_cache:
        assert summary["prefix_hit_ratio"] > 0
    if spec_tokens:
        assert summary["spec_steps"] > 0


def test_decisions_are_taken_over_the_collective_axes():
    """The group the loop broadcasts its clock over: none for one model
    rank, the model axis for a dense model, expert x model for MoE."""
    def rank(world):
        mesh = create_mesh({"data": 2, "expert": 2, "model": 2}, world)
        dense = tloop._decision_group(cfgs(0)[1], mesh)
        moe = tloop._decision_group(cfgs(2)[1], mesh)
        none = tloop._decision_group(
            cfgs(0)[1], create_mesh({"data": 8, "model": 1}, world))
        return dense.size(), moe.size(), none

    assert run_worlds(8, rank) == [(2, 4, None)] * 8


@pytest.mark.parametrize("n_experts", [0, 2], ids=["dense", "moe"])
def test_one_rank_mesh_issues_no_collective(n_experts, monkeypatch):
    """``ServeLoop`` through ``{"model": 1}`` with the prefix cache and
    speculation on: after the mesh is built, no c10d call is issued (every
    collective goes through ``torch_ops._run``), and the chains are the
    mesh-free loop's."""
    _, tcfg = cfgs(n_experts)
    full = params(n_experts)[0]
    kw = dict(max_batch=3, prefix_cache=True, spec_tokens=2)
    free = tloop.ServeLoop(full, tcfg, geo=kv_cache.geometry(**GEO),
                           device="cpu", **kw)
    want = _chains(free.run(_requests(tloop))[1])
    calls = []

    def rank(world):
        tmesh = create_mesh({"model": 1}, world)
        monkeypatch.setattr(torch_ops, "_run",
                            lambda call, *args: calls.append(call))
        tl = tloop.ServeLoop(shard_params(full, tcfg, tmesh), tcfg,
                             geo=kv_cache.geometry(**GEO), mesh=tmesh, **kw)
        return _chains(tl.run(_requests(tloop))[1])

    assert run_worlds(1, rank) == [want]
    assert calls == []


def test_only_rank_0_of_the_decision_group_reports_load():
    """``load_reporter`` (``worker.report_serve_load`` in a job) is called
    on rank 0 of the group the loop's decisions are taken over, and on no
    other rank: the ranks serve the same requests, so one report stands
    for them. Mesh-free, the loop reports itself."""
    _, tcfg = cfgs(0)
    full = params(0)[0]
    seen = []

    def rank(world):
        tmesh = create_mesh({"model": 2}, world)
        tl = tloop.ServeLoop(
            shard_params(full, tcfg, tmesh), tcfg,
            geo=kv_cache.geometry(**GEO), mesh=tmesh, max_batch=3,
            load_reporter=lambda *load: seen.append((world.rank, load)),
            report_interval=2)
        summary, _ = tl.run(_requests(tloop),
                            clock=_skewed_clock(world.rank))
        return summary["requests"]

    assert run_worlds(2, rank) == [6, 6]
    assert seen and {r for r, _ in seen} == {0}
    depth, fill, occupancy = seen[0][1]
    assert depth >= 0 and 0.0 <= fill <= 1.0 and 0.0 <= occupancy <= 1.0
    free = []
    tloop.ServeLoop(full, tcfg, geo=kv_cache.geometry(**GEO), device="cpu",
                    max_batch=3, load_reporter=lambda *load: free.append(load),
                    report_interval=2).run(_requests(tloop))
    assert free
