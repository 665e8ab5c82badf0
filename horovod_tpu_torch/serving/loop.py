"""The serve loop: the port of ``horovod_tpu/serving/loop.py``.

Open-loop Poisson load in, tokens + latency spans out, over the port's
kernel-free engine (:mod:`.engine`) on one device, or tensor-parallel
over a mesh (``mesh=``; see "Under a mesh" below).

One iteration = one token boundary:

1. submit every request whose (open-loop) arrival time has passed —
   arrivals do NOT wait for capacity; the queue absorbs bursts and the
   queue DEPTH is what the autoscaler watches,
2. admit + prefill newcomers. Same-boundary cache-miss admissions are
   prefilled in ONE batched call (``engine.make_batched_prefill``;
   singleton fallback counted); prefix-cache hits fill only their novel
   suffix, one ``prefill_chunk``-token chunk per boundary, so a long
   cold prompt never monopolizes a decode boundary. Completing a
   prefill emits the request's first token — TTFT is arrival → that
   token, queueing and prefill included — and registers the prompt's
   pages in the prefix cache,
3. one decode step over every fully-prefilled slot — or, with
   ``spec_tokens > 0``, one SPECULATIVE step: draft k tokens per slot
   (:mod:`.speculate`), score them all in a single q_len=k+1 target
   pass, and emit the accepted run + bonus token (bit-identical to
   plain greedy; rejected drafts are just block-table truncations),
4. feed the tokens back through the scheduler boundary (evict finished,
   grow pages, admit into the freed slots) and sample the SERVE_* gauges.

Latency accounting (docs/serving.md has the formal definitions):
TTFT = first_token_t - arrival_t per request; inter-token latency (ITL)
= the gaps between a request's consecutive token timestamps. The
summary reports p50/p99 over all requests' TTFTs and over ALL gaps.

Every request also becomes one ``serve.request`` span (arrival →
finish, with rid/tokens/ttft_ms args) on the observability timeline, so
a merged trace shows request lifetimes above the per-step
``serve.prefill`` / ``serve.chunk_prefill`` / ``serve.decode_step`` /
``serve.spec_step`` spans.

Kill switches: ``HVD_SERVE_PREFIX_CACHE=0`` (or ``prefix_cache=False``)
and ``spec_tokens=0`` restore the plain paths exactly — no prefix /
speculation engine is even built and the new SERVE_* metrics see zero
activity.

Under a mesh: the reference is single-controller, one process driving
every device with one scheduler. The port is multi-controller: every
rank of the mesh runs its own ``ServeLoop`` on the same requests, and
each engine step is a collective over the ranks that share its
``model`` (and, for MoE, ``expert``) axis. Those ranks must take every
decision alike, or they call different steps and deadlock in the first
mismatched collective. Admission reads the clock (``arrival_t <=
now``), and two ranks' clocks differ; so once per loop iteration rank 0
of that group reads its clock and broadcasts it over the group, and
every rank admits, preempts, hits the prefix cache and speculates from
the same ``now`` and the same (all-gathered) logits. Token timestamps,
which feed only the latency summary, stay on each rank's own clock.
"""

import time

import numpy as np
import torch

from ..observability import metrics as _metrics
from ..observability import spans as _spans
from ..ops import torch_ops
from ..parallel.sharding import solo
from . import engine, kv_cache, speculate
from .prefix_cache import PrefixCache
from .scheduler import (DEFAULT_KV_PAGES, DEFAULT_MAX_BATCH,
                        DEFAULT_PAGE_SIZE, ContinuousBatcher, PageAllocator,
                        Request, serve_knobs)


# Latest ServeLoop snapshot, read through serve_stats().
_LAST_STATS = {}


def serve_stats():
    """Most recent ServeLoop boundary snapshot (empty dict before any
    loop has run) — queue/fill/occupancy gauges plus the prefix-cache
    and speculation counters."""
    return dict(_LAST_STATS)


def poisson_requests(n, rate, rng, prompt_len=(4, 32), max_new=(4, 64),
                     vocab=256, eos_id=-1):
    """Synthetic open-loop load: `n` requests with exponential
    inter-arrival gaps (rate = requests/second) and uniform prompt /
    max-new-token draws. The max_new spread is what continuous batching
    monetizes: short requests finish early and their slots refill while
    a static batch would idle them until the longest request drains."""
    reqs, t = [], 0.0
    lo_p, hi_p = prompt_len
    lo_n, hi_n = max_new
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        prompt = rng.integers(0, vocab,
                              size=int(rng.integers(lo_p, hi_p + 1)))
        reqs.append(Request(
            rid=i, prompt=[int(x) for x in prompt],
            max_new_tokens=int(rng.integers(lo_n, hi_n + 1)),
            arrival_t=t, eos_id=eos_id))
    return reqs


def shared_prefix_requests(n, rate, rng, prefix_len=24, tail_len=(2, 8),
                           max_new=(4, 16), vocab=256, eos_id=-1):
    """The prefix-cache A/B workload: every prompt is one common
    ``prefix_len``-token system prompt plus a short unique tail — the
    shape real traffic has (shared templates, per-user suffixes). With
    the cache on, every admission after the first should hit the shared
    prefix's pages."""
    prefix = [int(x) for x in rng.integers(0, vocab, size=prefix_len)]
    reqs, t = [], 0.0
    lo_t, hi_t = tail_len
    lo_n, hi_n = max_new
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        tail = [int(x) for x in
                rng.integers(0, vocab,
                             size=int(rng.integers(lo_t, hi_t + 1)))]
        reqs.append(Request(
            rid=i, prompt=prefix + tail,
            max_new_tokens=int(rng.integers(lo_n, hi_n + 1)),
            arrival_t=t, eos_id=eos_id))
    return reqs


class ServeLoop:
    """Continuous-batching serve loop over one model replica.

    `mode` picks the scheduler ("continuous" vs the "static" A/B
    baseline); the engine paths are identical either way — the A/B
    isolates the scheduling policy. `load_reporter`, when set, is called
    every `report_interval` boundaries with (queue_depth, batch_fill,
    kv_occupancy); the reference wires it to its elastic driver's
    queue-depth autoscaler, which the port does not have yet (ROADMAP
    Queue A item 1, rest).

    Serving-v2 knobs (None = read the HVD_SERVE_* env knob):

    - ``prefix_cache``: radix-tree shared-prefix KV reuse
      (HVD_SERVE_PREFIX_CACHE, default on). Hits share pages and
      chunk-fill only the novel suffix.
    - ``spec_tokens``: speculative draft length k
      (HVD_SERVE_SPEC_TOKENS, default 0 = off). ``drafter`` plugs in
      any ``propose(context, k)`` implementation (default
      :class:`~horovod_tpu_torch.serving.speculate.NGramDrafter`).
    - ``prefill_chunk``: tokens per chunked-prefill call (default
      2 pages); ``batch_prefill=False`` forces the per-request prefill
      fallback (the counted A/B baseline).

    ``mesh``: serve tensor-parallel over a
    :class:`~..parallel.mesh.Mesh`, every rank with its own loop on the
    same requests and ``params`` its shard (``convert.shard_params``);
    the device is the mesh's. See the module's docstring.
    """

    def __init__(self, params, cfg, geo=None,
                 max_batch=DEFAULT_MAX_BATCH, mode="continuous",
                 load_reporter=None, report_interval=16,
                 prefix_cache=None, spec_tokens=None, drafter=None,
                 prefill_chunk=None, batch_prefill=True, device=None,
                 mesh=None):
        if geo is None:
            geo = kv_cache.geometry(DEFAULT_KV_PAGES, DEFAULT_PAGE_SIZE,
                                    cfg.max_seq_len)
        knobs = serve_knobs()
        use_prefix = (knobs["prefix_cache"] != 0 if prefix_cache is None
                      else bool(prefix_cache))
        self.spec_tokens = max(0, knobs["spec_tokens"]
                               if spec_tokens is None else int(spec_tokens))
        self.params = params
        self.cfg = cfg
        self.geo = geo
        self.device = device = kv_cache.placement(cfg, device, mesh)[0]
        self._clock_group = _decision_group(cfg, mesh)
        self.max_batch = int(max_batch)
        self.mode = mode
        self.load_reporter = load_reporter
        self.report_interval = int(report_interval)
        self.prefill_chunk = (min(geo.max_kv, 2 * geo.page_size)
                              if prefill_chunk is None
                              else int(prefill_chunk))
        self.prefill_fn = engine.make_prefill(cfg, geo, device, mesh=mesh)
        self.decode_fn = engine.make_decode_step(cfg, geo, device, max_batch,
                                                 mesh=mesh)
        self.bprefill_fn = (engine.make_batched_prefill(cfg, geo, device,
                                                        mesh=mesh)
                            if batch_prefill and self.max_batch > 1
                            else None)
        self.chunk_fn = (engine.make_chunk_step(
            cfg, geo, device, q_len=self.prefill_chunk, mesh=mesh)
            if use_prefix else None)
        self.spec_fn = (engine.make_chunk_step(
            cfg, geo, device, q_len=self.spec_tokens + 1, mesh=mesh)
            if self.spec_tokens > 0 else None)
        self.drafter = drafter if drafter is not None \
            else speculate.NGramDrafter()
        self.cache = kv_cache.make_cache(cfg, geo, device, mesh)
        self.alloc = PageAllocator(geo.n_pages, geo.page_size)
        self.prefix = PrefixCache(self.alloc) if use_prefix else None
        self.batcher = ContinuousBatcher(self.alloc, max_batch, mode,
                                         prefix_cache=self.prefix,
                                         spec_tokens=self.spec_tokens)
        self.loop_stats = {"prefill_single": 0, "prefill_batched": 0,
                           "prefill_batch_calls": 0, "chunk_fills": 0}
        self._fills = {}   # rid -> (admit_seq, tokens materialized)

    def warmup(self):
        """Run every engine path once outside any measured window (the
        first CUDA calls pay for library set-up and allocation); under a
        mesh every rank runs each once, together. Every
        cache write routes to trash page 0 (all-zero block table,
        all-inactive batch), so the cache stays semantically untouched."""
        toks = np.zeros(self.geo.max_kv, np.int32)
        bt = np.zeros(self.geo.max_blocks, np.int32)
        self.cache, logits = self.prefill_fn(
            self.params, self.cache, toks, np.int32(1), bt)
        int(_tokens(logits))
        B, mb = self.max_batch, self.geo.max_blocks
        self.cache, logits = self.decode_fn(
            self.params, self.cache, np.zeros(B, np.int32),
            np.zeros(B, np.int32), np.zeros((B, mb), np.int32),
            np.zeros(B, bool))
        _tokens(logits)
        if self.bprefill_fn is not None:
            self.cache, logits = self.bprefill_fn(
                self.params, self.cache,
                np.zeros((B, self.geo.max_kv), np.int32),
                np.ones(B, np.int32), np.zeros((B, mb), np.int32),
                np.zeros(B, bool))
            _tokens(logits)
        if self.chunk_fn is not None:
            self.cache, logits = self.chunk_fn(
                self.params, self.cache,
                np.zeros((1, self.prefill_chunk), np.int32),
                np.zeros(1, np.int32), np.zeros((1, mb), np.int32),
                np.zeros(1, bool))
            _tokens(logits)
        if self.spec_fn is not None:
            self.cache, logits = self.spec_fn(
                self.params, self.cache,
                np.zeros((B, self.spec_tokens + 1), np.int32),
                np.zeros(B, np.int32), np.zeros((B, mb), np.int32),
                np.zeros(B, bool))
            _tokens(logits)

    # -- per-request engine calls ----------------------------------------

    def _prefill(self, req):
        """Run the request's full (re-)prefill and return its next
        token — the counted singleton fallback path."""
        ctx = list(req.prompt) + list(req.generated)
        toks = np.zeros(self.geo.max_kv, np.int32)
        toks[:len(ctx)] = ctx
        bt = np.asarray(self.batcher.block_table(req, self.geo.max_blocks),
                        np.int32)
        with _spans.span("serve.prefill", cat="serve", rid=req.rid,
                         context=len(ctx)):
            self.cache, logits = self.prefill_fn(
                self.params, self.cache, toks, np.int32(len(ctx)), bt)
        self.loop_stats["prefill_single"] += 1
        return int(_tokens(logits))

    def _batched_prefill(self, group):
        """All of `group`'s full prefills in ONE padded call; returns
        {slot: first token}. Rows beyond the group are inactive (trash
        writes)."""
        B, mb, pad = self.max_batch, self.geo.max_blocks, self.geo.max_kv
        toks = np.zeros((B, pad), np.int32)
        lengths = np.ones(B, np.int32)
        tables = np.zeros((B, mb), np.int32)
        active = np.zeros(B, bool)
        for row, req in enumerate(group):
            ctx = list(req.prompt) + list(req.generated)
            toks[row, :len(ctx)] = ctx
            lengths[row] = len(ctx)
            tables[row] = self.batcher.block_table(req, mb)
            active[row] = True
        with _spans.span("serve.prefill", cat="serve", batched=len(group),
                         context=int(lengths[:len(group)].sum())):
            self.cache, logits = self.bprefill_fn(
                self.params, self.cache, toks, lengths, tables, active)
        out = _tokens(logits)
        self.loop_stats["prefill_batched"] += len(group)
        self.loop_stats["prefill_batch_calls"] += 1
        return {req.slot: int(out[row]) for row, req in enumerate(group)}

    def _chunk_fill(self, req):
        """Advance a prefix-hit request's suffix fill by ONE chunk.
        Returns (done, first_token_or_None); `done` means the whole
        context is materialized and the final chunk's last real
        position produced the request's next token."""
        ctx = list(req.prompt) + list(req.generated)
        target = len(ctx)
        state = self._fills.get(req.rid)
        filled = (state[1] if state is not None
                  and state[0] == req.admit_seq else req.cached_tokens)
        end = min(filled + self.prefill_chunk, target)
        toks = np.zeros((1, self.prefill_chunk), np.int32)
        toks[0, :end - filled] = ctx[filled:end]
        bt = np.asarray(
            self.batcher.block_table(req, self.geo.max_blocks),
            np.int32)[None]
        with _spans.span("serve.chunk_prefill", cat="serve", rid=req.rid,
                         start=filled, end=end, target=target):
            self.cache, logits = self.chunk_fn(
                self.params, self.cache, toks,
                np.asarray([filled], np.int32), bt, np.ones(1, bool))
        self.loop_stats["chunk_fills"] += 1
        if end >= target:
            self._fills.pop(req.rid, None)
            out = _tokens(logits)
            return True, int(out[0, end - 1 - filled])
        self._fills[req.rid] = (req.admit_seq, end)
        return False, None

    def _decode(self, ready):
        """One decode step over the fully-prefilled slots; returns
        {slot: token}."""
        B, mb = self.max_batch, self.geo.max_blocks
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        tables = np.zeros((B, mb), np.int32)
        active = np.zeros(B, bool)
        for slot, req in ready.items():
            tokens[slot] = req.generated[-1]
            positions[slot] = req.context_len - 1
            tables[slot] = self.batcher.block_table(req, mb)
            active[slot] = True
        with _spans.span("serve.decode_step", cat="serve",
                         fill=self.batcher.batch_fill()):
            self.cache, logits = self.decode_fn(
                self.params, self.cache, tokens, positions, tables, active)
        out = _tokens(logits)
        return {s: int(out[s]) for s in ready}

    def _spec_decode(self, ready):
        """One speculative step over the fully-prefilled slots: draft k
        tokens per slot, score [last, d_1..d_k] in a single q_len=k+1
        target pass, resolve accept/reject host-side. Returns
        {slot: [accepted tokens + bonus]} — 1 to k+1 tokens per slot,
        bit-identical to what k+1 plain greedy steps would emit."""
        B, mb = self.max_batch, self.geo.max_blocks
        k = self.spec_tokens
        tokens = np.zeros((B, k + 1), np.int32)
        positions = np.zeros(B, np.int32)
        tables = np.zeros((B, mb), np.int32)
        active = np.zeros(B, bool)
        drafts = {}
        for slot, req in ready.items():
            ctx = list(req.prompt) + list(req.generated)
            d = list(self.drafter.propose(ctx, k))[:k]
            d += [0] * (k - len(d))   # padded lanes are just cheap guesses
            drafts[slot] = d
            tokens[slot] = [ctx[-1]] + d
            positions[slot] = len(ctx) - 1
            tables[slot] = self.batcher.block_table(req, mb)
            active[slot] = True
        with _spans.span("serve.spec_step", cat="serve", draft_k=k,
                         fill=self.batcher.batch_fill()):
            self.cache, logits = self.spec_fn(
                self.params, self.cache, tokens, positions, tables, active)
        out = _tokens(logits)        # [B, k+1]
        result = {}
        st = self.batcher.stats
        for slot, req in ready.items():
            emitted, _, rejected = speculate.accept_drafts(
                drafts[slot], [int(x) for x in out[slot]])
            # The request's remaining token budget (max_new and cache
            # room) bounds what the boundary may consume.
            room = min(req.max_new_tokens - len(req.generated),
                       self.geo.max_kv - req.context_len)
            emitted = emitted[:max(1, room)]
            st["spec_steps"] += 1
            st["spec_accepted"] += len(emitted) - 1
            st["spec_rejected"] += rejected
            result[slot] = emitted
        return result

    # -- the loop ---------------------------------------------------------

    def run(self, requests, clock=time.monotonic):
        """Serve `requests` (arrival_t = seconds from start) to
        completion; returns (summary dict, finished Request list)."""
        for r in requests:
            if r.prompt_len >= self.geo.max_kv:
                raise ValueError(f"request {r.rid}: prompt {r.prompt_len} "
                                 f">= cache context {self.geo.max_kv}")
            # Cap generation to the cache geometry so a block table can
            # never overflow mid-decode.
            r.max_new_tokens = min(r.max_new_tokens,
                                   self.geo.max_kv - r.prompt_len)
        pending = sorted(requests, key=lambda r: r.arrival_t)
        token_times = {}          # rid -> [t, ...] production timestamps
        finished = []
        prefilled = {}            # rid -> admit_seq at last prefill
        fill_samples, occ_samples = [], []
        boundaries = 0
        wall_t0_us = time.time_ns() // 1000
        t0 = clock()
        preempt_seen = 0
        pfx_evict_seen = 0
        spec_rej_seen = 0

        def _now():
            return clock() - t0

        def _shared_now():
            """The time every rank of the decision group takes its
            decisions from: rank 0's, broadcast (module docstring)."""
            if self._clock_group is None:
                return _now()
            t = torch.tensor([_now()], dtype=torch.float64,
                             device=self.device)
            return float(torch_ops.broadcast(t, self._clock_group, 0)[0])

        def _boundary(done, produced_at):
            nonlocal preempt_seen, boundaries, pfx_evict_seen, spec_rej_seen
            for req in done:
                prefilled.pop(req.rid, None)
                self._fills.pop(req.rid, None)
                finished.append(req)
                ttft = req.first_token_t - req.arrival_t
                _metrics.SERVE_TTFT_SECONDS.observe(max(0.0, ttft))
                gaps = np.diff(token_times.get(req.rid, []))
                if len(gaps):
                    _metrics.SERVE_ITL_SECONDS.observe(float(np.mean(gaps)))
                _spans.event("serve.request",
                             wall_t0_us + req.arrival_t * 1e6,
                             (req.finished_t - req.arrival_t) * 1e6,
                             cat="serve", rid=req.rid,
                             tokens=len(req.generated),
                             reason=req.finish_reason,
                             preemptions=req.preemptions,
                             cached_tokens=req.cached_tokens,
                             ttft_ms=round(ttft * 1e3, 3))
            _metrics.SERVE_QUEUE_DEPTH.set(self.batcher.queue_depth())
            _metrics.SERVE_BATCH_FILL.set(self.batcher.batch_fill())
            _metrics.SERVE_KV_OCCUPANCY.set(self.batcher.kv_occupancy())
            _metrics.SERVE_TOKENS.inc(len(produced_at))
            new_preempt = self.batcher.stats["preemptions"] - preempt_seen
            if new_preempt:
                _metrics.SERVE_PREEMPTIONS.inc(new_preempt)
                preempt_seen = self.batcher.stats["preemptions"]
            # Kill-switch contract: with the feature off these metric
            # objects see ZERO activity (no set, no inc).
            if self.prefix is not None:
                _metrics.SERVE_PREFIX_HIT_RATIO.set(
                    self.batcher.prefix_hit_ratio())
                new_ev = self.prefix.stats["evictions"] - pfx_evict_seen
                if new_ev:
                    _metrics.SERVE_PREFIX_EVICTIONS.inc(new_ev)
                    pfx_evict_seen = self.prefix.stats["evictions"]
            if self.spec_tokens > 0:
                st = self.batcher.stats
                if st["spec_steps"]:
                    _metrics.SERVE_SPEC_ACCEPTED_PER_STEP.set(
                        st["spec_accepted"] / st["spec_steps"])
                new_rej = st["spec_rejected"] - spec_rej_seen
                if new_rej:
                    _metrics.SERVE_SPEC_REJECTED.inc(new_rej)
                    spec_rej_seen = st["spec_rejected"]
            fill_samples.append(self.batcher.batch_fill())
            occ_samples.append(self.batcher.kv_occupancy())
            boundaries += 1
            self._publish()
            if (self.load_reporter is not None
                    and boundaries % self.report_interval == 0):
                self.load_reporter(self.batcher.queue_depth(),
                                   self.batcher.batch_fill(),
                                   self.batcher.kv_occupancy())

        def _emit(by_slot):
            """Feed produced tokens through the scheduler boundary with
            timestamps for exactly the tokens the boundary will keep."""
            t = _now()
            rids = []
            for s, toks in by_slot.items():
                req = self.batcher.running[s]
                rids.append(req.rid)
                toks = [toks] if isinstance(toks, int) else toks
                kept, gen = 0, len(req.generated)
                for tok in toks:
                    kept += 1
                    gen += 1
                    if tok == req.eos_id or gen >= req.max_new_tokens:
                        break
                token_times.setdefault(req.rid, []).extend([t] * kept)
            done = self.batcher.on_tokens(by_slot, t)
            _boundary(done, rids)

        while pending or not self.batcher.idle():
            now = _shared_now()
            while pending and pending[0].arrival_t <= now:
                self.batcher.submit(pending.pop(0), now)
            self.batcher.admit(now)
            # Prefill anything (re-)admitted since its last prefill.
            # Cache-miss prompts (cached_tokens == 0) take the full
            # prefill — batched when several admitted at this boundary —
            # and each completion's token runs a boundary which may
            # admit more, so rescan. Prefix hits advance ONE chunk per
            # outer boundary (the `advanced` set) so a long suffix
            # interleaves with decode steps instead of stalling them.
            advanced = set()
            while True:
                todo = [r for r in self.batcher.running.values()
                        if prefilled.get(r.rid) != r.admit_seq]
                plain = sorted((r for r in todo if r.cached_tokens == 0),
                               key=lambda r: r.admit_seq)
                if plain:
                    if self.bprefill_fn is not None and len(plain) > 1:
                        by_slot = self._batched_prefill(plain)
                        for r in plain:
                            prefilled[r.rid] = r.admit_seq
                            self.batcher.register_prefilled(r)
                        _emit(by_slot)
                    else:
                        req = plain[0]
                        tok = self._prefill(req)
                        prefilled[req.rid] = req.admit_seq
                        self.batcher.register_prefilled(req)
                        _emit({req.slot: tok})
                    continue
                progressed = False
                for req in sorted(todo, key=lambda r: r.admit_seq):
                    if req.rid in advanced:
                        continue
                    advanced.add(req.rid)
                    progressed = True
                    done_fill, tok = self._chunk_fill(req)
                    if done_fill:
                        prefilled[req.rid] = req.admit_seq
                        self.batcher.register_prefilled(req)
                        _emit({req.slot: tok})
                        break   # boundary may have changed the todo set
                if not progressed:
                    break
            ready = {s: r for s, r in self.batcher.running.items()
                     if prefilled.get(r.rid) == r.admit_seq}
            if ready:
                if self.spec_fn is not None:
                    _emit(self._spec_decode(ready))
                else:
                    _emit(self._decode(ready))
            elif not self.batcher.running and pending:
                # Idle until the next arrival (open loop: don't spin).
                time.sleep(min(0.005,
                               max(0.0, pending[0].arrival_t - _now())))

        summary = self._summary(finished, token_times, _now(),
                                fill_samples, occ_samples)
        self._publish()
        return summary, finished

    def _publish(self):
        """Refresh the serve_stats() snapshot."""
        st = self.batcher.stats
        snap = {
            "mode": self.mode,
            "queue_depth": self.batcher.queue_depth(),
            "batch_fill": round(self.batcher.batch_fill(), 4),
            "kv_occupancy": round(self.batcher.kv_occupancy(), 4),
            "tokens": st["tokens"],
            "admissions": st["admissions"],
            "preemptions": st["preemptions"],
            "prefix_cache": self.prefix is not None,
            "prefix_hit_ratio": round(self.batcher.prefix_hit_ratio(), 4),
            "prefix_evictions": (self.prefix.stats["evictions"]
                                 if self.prefix is not None else 0),
            "prefix_nodes": (len(self.prefix)
                             if self.prefix is not None else 0),
            "spec_tokens": self.spec_tokens,
            "spec_steps": st["spec_steps"],
            "spec_accepted_per_step": round(
                st["spec_accepted"] / st["spec_steps"], 4)
            if st["spec_steps"] else 0.0,
            "spec_rejected": st["spec_rejected"],
        }
        snap.update(self.loop_stats)
        _LAST_STATS.clear()
        _LAST_STATS.update(snap)

    def _summary(self, finished, token_times, duration, fills, occs):
        ttfts = [r.first_token_t - r.arrival_t for r in finished]
        gaps = np.concatenate(
            [np.diff(ts) for ts in token_times.values() if len(ts) > 1]
        ) if any(len(ts) > 1 for ts in token_times.values()) else np.array([0.0])
        tokens = sum(len(r.generated) for r in finished)
        st = self.batcher.stats
        return {
            "mode": self.mode,
            "requests": len(finished),
            "tokens": int(tokens),
            "duration_s": round(float(duration), 4),
            "tok_s": round(tokens / max(duration, 1e-9), 2),
            "ttft_p50_ms": _pct_ms(ttfts, 50),
            "ttft_p99_ms": _pct_ms(ttfts, 99),
            "itl_p50_ms": _pct_ms(gaps, 50),
            "itl_p99_ms": _pct_ms(gaps, 99),
            "batch_fill_mean": round(float(np.mean(fills)), 4) if fills
            else 0.0,
            "kv_occupancy_mean": round(float(np.mean(occs)), 4) if occs
            else 0.0,
            "preemptions": st["preemptions"],
            "prefix_hit_ratio": round(self.batcher.prefix_hit_ratio(), 4),
            "prefix_evictions": (self.prefix.stats["evictions"]
                                 if self.prefix is not None else 0),
            "spec_steps": st["spec_steps"],
            "spec_accepted_per_step": round(
                st["spec_accepted"] / st["spec_steps"], 4)
            if st["spec_steps"] else 0.0,
            "spec_rejected": st["spec_rejected"],
            "prefill_single": self.loop_stats["prefill_single"],
            "prefill_batched": self.loop_stats["prefill_batched"],
            "prefill_batch_calls": self.loop_stats["prefill_batch_calls"],
            "chunk_fills": self.loop_stats["chunk_fills"],
        }


def _decision_group(cfg, mesh):
    """The group over which every rank must take the loop's decisions
    alike: the ranks an engine step's collectives join (the model axis,
    and the expert axis of an MoE model), or None where those
    collectives move nothing (``sharding.solo``, as the steps decide)."""
    if mesh is None:
        return None
    axes = tuple(a for a in ((cfg.expert_axis,) if cfg.n_experts > 0
                             else ()) + (cfg.model_axis,)
                 if a in mesh.axis_names)
    group = mesh.groups(axes) if axes else None
    return None if solo(group) else group


def _tokens(logits):
    """Greedy tokens of a logits tensor as a numpy array on the host."""
    return engine.greedy(logits).cpu().numpy()


def _pct_ms(xs, q):
    if not len(xs):
        return 0.0
    return round(float(np.percentile(np.asarray(xs), q)) * 1e3, 3)
