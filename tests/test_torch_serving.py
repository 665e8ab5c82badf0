"""The port's serving plane (horovod_tpu_torch/serving) against the JAX
package's, on the CPU, with params converted from the JAX init.

- The port's ServeLoop and JAX's ServeLoop serve the same requests and
  must produce the same greedy token chains, with the prefix cache and
  speculation on and off. float32, so the two only differ by summation
  order and an argmax near-tie is not expected at this size.
- The port's paged decode logits equal the port's full ``forward`` over
  the growing sequence (the contract tests/test_serving.py pins for JAX),
  within 1e-4 relative / 1e-5 absolute in float32.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.models import transformer as jtfm  # noqa: E402
from horovod_tpu.serving import kv_cache as jkv  # noqa: E402
from horovod_tpu.serving import loop as jloop  # noqa: E402
from horovod_tpu_torch.models import transformer as ttfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.serving import engine, kv_cache  # noqa: E402
from horovod_tpu_torch.serving import loop as tloop  # noqa: E402

_CFG = dict(vocab_size=256, d_model=64, n_heads=8, n_layers=2, d_ff=128,
            max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jtfm.TransformerConfig(**_CFG)
    tcfg = ttfm.TransformerConfig(**_CFG)
    jp = jtfm.init_params(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(kind, make):
    rng = np.random.default_rng(11)
    if kind == "poisson":
        return make.poisson_requests(6, 1e6, rng, prompt_len=(4, 24),
                                     max_new=(4, 12), vocab=256)
    return make.shared_prefix_requests(6, 1e6, rng, prefix_len=24,
                                       tail_len=(2, 6), max_new=(4, 12),
                                       vocab=256)


def _chains(finished):
    return {r.rid: (list(r.generated), r.finish_reason) for r in finished}


@pytest.mark.parametrize("prefix_cache,spec_tokens,traffic", [
    (False, 0, "poisson"), (True, 2, "shared_prefix")])
def test_chains_match_jax_serveloop(models, prefix_cache, spec_tokens,
                                    traffic):
    jcfg, tcfg, jp, tp = models
    kw = dict(max_batch=3, prefix_cache=prefix_cache,
              spec_tokens=spec_tokens)
    jl = jloop.ServeLoop(jp, jcfg, geo=jkv.geometry(32, 8, 64), **kw)
    jl.warmup()
    _, jfin = jl.run(_requests(traffic, jloop))
    tl = tloop.ServeLoop(tp, tcfg, geo=kv_cache.geometry(32, 8, 64),
                         device="cpu", **kw)
    tl.warmup()
    summary, tfin = tl.run(_requests(traffic, tloop))
    assert summary["requests"] == 6
    assert all(r.finish_reason for r in tfin)
    assert _chains(tfin) == _chains(jfin)
    if prefix_cache:
        assert summary["prefix_hit_ratio"] > 0
    if spec_tokens:
        assert summary["spec_steps"] > 0


@pytest.mark.parametrize("prefix_cache,spec_tokens", [
    (True, 0), (False, 3)])
def test_features_leave_chains_unchanged(models, prefix_cache, spec_tokens):
    """Prefix reuse and speculation are invisible to greedy output within
    the port too (the other on/off corners of the JAX comparison)."""
    _, tcfg, _, tp = models
    runs = []
    for pc, sk in ((False, 0), (prefix_cache, spec_tokens)):
        tl = tloop.ServeLoop(tp, tcfg, geo=kv_cache.geometry(32, 8, 64),
                             device="cpu", max_batch=3, prefix_cache=pc,
                             spec_tokens=sk)
        runs.append(_chains(tl.run(_requests("shared_prefix", tloop))[1]))
    assert runs[0] == runs[1]


def test_decode_logits_match_forward(models):
    _, tcfg, _, tp = models
    geo = kv_cache.geometry(n_pages=16, page_size=8, max_context=64)
    prefill = engine.make_prefill(tcfg, geo, "cpu")
    decode = engine.make_decode_step(tcfg, geo, "cpu", max_batch=1)
    cache = kv_cache.make_cache(tcfg, geo, "cpu")
    rng = np.random.default_rng(3)
    prompt = [int(x) for x in rng.integers(0, 256, size=9)]
    n_new = 10
    pages = list(range(1, 1 + (len(prompt) + n_new + 7) // 8))
    bt = np.asarray(pages + [0] * (geo.max_blocks - len(pages)), np.int32)
    toks = np.zeros(geo.max_kv, np.int32)
    toks[:len(prompt)] = prompt
    cache, logits = prefill(tp, cache, toks, len(prompt), bt)
    step_logits = [logits]
    seq = prompt + [int(engine.greedy(logits))]
    for _ in range(n_new - 1):
        cache, logits = decode(tp, cache, [seq[-1]], [len(seq) - 1],
                               bt[None], [True])
        step_logits.append(logits[0])
        seq.append(int(engine.greedy(logits)[0]))
    ref = ttfm.forward(tp, torch.tensor([seq]), tcfg)[0]
    for i, got in enumerate(step_logits):
        pos = len(prompt) + i - 1
        torch.testing.assert_close(got, ref[pos], rtol=1e-4, atol=1e-5)
        assert seq[pos + 1] == int(ref[pos].argmax())


def test_engine_refuses_flash_decode(models):
    _, tcfg, _, _ = models
    geo = kv_cache.geometry(16, 8, 64)
    with pytest.raises(ValueError, match="gather"):
        engine.make_decode_step(dataclasses.replace(tcfg, attn_impl="flash"),
                                geo, "cpu")
    assert kv_cache.cache_bytes(tcfg, geo) == 2 * 2 * 16 * 8 * 8 * 8 * 4


def test_metrics_and_spans_record_a_run(models):
    """With metrics on, a run moves the SERVE_* counters and records one
    serve.request span per request; the gauge of a feature that is off
    (the prefix cache here) is never touched."""
    from horovod_tpu_torch.observability import metrics, spans

    _, tcfg, _, tp = models
    tl = tloop.ServeLoop(tp, tcfg, geo=kv_cache.geometry(32, 8, 64),
                         device="cpu", max_batch=3, prefix_cache=False)
    was = metrics.enabled()
    n_events = len(spans.recorder.events())
    metrics.enable()
    try:
        tokens0 = metrics.SERVE_TOKENS.value
        ttft0 = metrics.SERVE_TTFT_SECONDS.count
        summary, _ = tl.run(_requests("poisson", tloop))
    finally:
        if not was:
            metrics.disable()
    assert metrics.SERVE_TOKENS.value - tokens0 == summary["tokens"]
    assert metrics.SERVE_TTFT_SECONDS.count - ttft0 == 6
    assert metrics.SERVE_PREFIX_HIT_RATIO.collect() == []   # feature off
    new = spans.recorder.events()[n_events:]
    assert sum(e["name"] == "serve.request" for e in new) == 6
    assert any(e["name"] == "serve.decode_step" for e in new)
