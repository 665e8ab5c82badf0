"""Continuous-batching scheduler + paged-KV page accounting (jax-free).

The port's own copy of ``horovod_tpu/serving/scheduler.py`` (plain
Python and numpy; the port imports nothing of the JAX package).

The serving plane's control half. Everything here is deliberately plain
Python/numpy — no jax import anywhere in this module — so the scheduling
invariants (admission, eviction, page conservation, batch-fill
monotonicity) are testable without an accelerator stack, the same way
the JAX package's ``parallel/schedules.py`` keeps its pipeline tables
numpy-only (tests/test_pipeline_schedules.py is the idiom this module's
tests mirror).

Model (vLLM-style continuous batching, scoped to what the decode engine
in :mod:`.engine` executes):

- The KV cache is ``n_pages`` fixed-size pages of ``page_size`` token
  slots each. A request owns ceil(context_len / page_size) pages,
  recorded in its **block table** — the indirection that lets requests
  of wildly different lengths share ONE jit'd decode step
  (``docs/serving.md``).
- The batch is ``max_batch`` *slots*. A request keeps its slot for its
  whole running life (the engine indexes cache writes by slot-stable
  block tables, so slot churn would mean recompilation or copies).
- **Admission happens at token boundaries**: after every decode step the
  scheduler evicts finished requests (EOS / max-tokens), grows pages for
  requests crossing a page boundary, and admits waiting requests into
  free slots while their first allocation (prompt pages + one decode
  page) fits. That is the whole continuous-batching optimization — a
  static batch instead holds admissions until the ENTIRE batch drains.
- **Preemption**: when a running request crosses a page boundary and no
  page is free, the *youngest* running request is evicted back to the
  waiting queue (its pages freed, its generated tokens kept so the
  re-prefill replays prompt + generated prefix). Admission-reserved
  pages can therefore never deadlock the batch: the oldest request can
  always finish.

Page accounting contract (tests/test_serving_scheduler.py pins these):
``free + distinct-owned == n_pages - 1`` at every boundary (page 0 is
the engine's trash page for masked writes and is never handed out), a
page's refcount equals the number of holders referencing it (requests
plus at most one prefix-cache reference), and ``free()``/``share()`` of
a page not currently owned raise BEFORE mutation instead of corrupting
the pool.
"""

import collections
import dataclasses
import math
import os


def _int(raw, default):
    try:
        return int(raw or default)
    except ValueError:
        return default


# Knob defaults (CLI `--serve-*` / YAML `serve:` / env HVD_SERVE_* —
# docs/running.md knob table; parity held by tools/hvdlint.py).
DEFAULT_PAGE_SIZE = 16
DEFAULT_KV_PAGES = 256
DEFAULT_MAX_BATCH = 8
DEFAULT_PREFIX_CACHE = 1   # radix-tree shared-prefix KV reuse (ISSUE 16)
DEFAULT_SPEC_TOKENS = 0    # speculative decoding draft-k (0 = off)


def serve_knobs():
    """The serve loop's HVD_SERVE_* env knobs (set directly or via the
    tpurun --serve-* flags / YAML `serve:` section — docs/running.md)."""
    mode = os.environ.get("HVD_SERVE_MODE", "") or "continuous"
    return {
        "page_size": _int(os.environ.get("HVD_SERVE_PAGE_SIZE", ""),
                          DEFAULT_PAGE_SIZE),
        "kv_pages": _int(os.environ.get("HVD_SERVE_KV_PAGES", ""),
                         DEFAULT_KV_PAGES),
        "max_batch": _int(os.environ.get("HVD_SERVE_MAX_BATCH", ""),
                          DEFAULT_MAX_BATCH),
        "mode": mode,
        "prefix_cache": _int(os.environ.get("HVD_SERVE_PREFIX_CACHE", ""),
                             DEFAULT_PREFIX_CACHE),
        "spec_tokens": _int(os.environ.get("HVD_SERVE_SPEC_TOKENS", ""),
                            DEFAULT_SPEC_TOKENS),
    }


class PageError(RuntimeError):
    """KV-page accounting violation (double-free / foreign page)."""


class PageAllocator:
    """Fixed pool of KV pages with a free list and refcounted ownership.

    Page 0 is reserved as the engine's trash page (inactive batch slots
    route their cache writes there) and is never allocated. ``alloc`` is
    all-or-nothing so a half-admitted request can never leak pages.

    Sharing is copy-on-write in the degenerate (and only) case paged
    prefix reuse needs: pages are shared exclusively at page-aligned
    *prefix* boundaries, and a request only ever writes K/V at positions
    >= its own context length — which always land in pages it owns
    exclusively. So "copy" never actually happens; ``share`` bumps a
    refcount and ``free`` decrements it, returning the page to the pool
    only when the last reference drops. Double-free and
    refcount-underflow raise :class:`PageError` BEFORE any mutation.
    """

    def __init__(self, n_pages, page_size):
        if n_pages < 2:
            raise ValueError(f"need >= 2 KV pages (1 is the reserved "
                             f"trash page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = collections.deque(range(1, self.n_pages))
        self._ref = {}             # page -> refcount (>= 1 while owned)

    @property
    def usable_pages(self):
        """Pages that can ever be handed out (excludes the trash page)."""
        return self.n_pages - 1

    def free_pages(self):
        return len(self._free)

    def used_pages(self):
        """Distinct pages currently owned (each counted once however
        many references it has — physical pool pressure)."""
        return len(self._ref)

    def refcount(self, page):
        """Current reference count of `page` (0 when free/unallocated)."""
        return self._ref.get(page, 0)

    def occupancy(self):
        """Fraction of usable pages currently owned — the
        SERVE_KV_OCCUPANCY gauge."""
        return len(self._ref) / max(1, self.usable_pages)

    def alloc(self, n):
        """Take `n` pages or none. Returns the page list (each at
        refcount 1), or None when the pool cannot cover the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, pages):
        """Take an additional reference on already-owned pages (a
        prefix-cache hit forking a cached prefix into a new request).
        Sharing a page that is not currently owned raises PageError
        BEFORE any refcount changes."""
        pages = list(pages)
        for p in pages:
            if p not in self._ref:
                raise PageError(f"share of unowned KV page {p} (stale "
                                f"prefix-cache entry or foreign page)")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages):
        """Drop one reference per page; a page returns to the pool only
        at refcount 0. A page not currently owned (double free,
        refcount underflow, or a number that was never allocated) raises
        PageError BEFORE any state changes — the pool stays consistent."""
        pages = list(pages)
        counts = collections.Counter(pages)
        for p, n in counts.items():
            if self._ref.get(p, 0) < n:
                raise PageError(f"free of unowned KV page {p} (double "
                                f"free, refcount underflow, or foreign "
                                f"page)")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)


_WAITING, _RUNNING, _DONE = "waiting", "running", "done"


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is the token list; the
    scheduler only reads its length — the engine feeds the tokens."""
    rid: int
    prompt: list
    max_new_tokens: int
    arrival_t: float = 0.0
    eos_id: int = -1           # -1: never matches (length-capped only)

    # lifecycle (scheduler-owned)
    state: str = _WAITING
    slot: int = -1
    pages: list = dataclasses.field(default_factory=list)
    generated: list = dataclasses.field(default_factory=list)
    admitted_t: float = 0.0
    first_token_t: float = 0.0  # TTFT anchor (0 until the first token)
    finished_t: float = 0.0
    finish_reason: str = ""
    preemptions: int = 0
    admit_seq: int = -1         # admission order (preemption picks max)
    cached_tokens: int = 0      # prompt tokens covered by a prefix hit

    @property
    def prompt_len(self):
        return len(self.prompt)

    @property
    def context_len(self):
        """Tokens currently in the KV cache once running: the prompt plus
        every generated token (each decode step appends one)."""
        return len(self.prompt) + len(self.generated)

    def pages_needed(self, page_size, extra_tokens=1):
        """Pages for the current context plus `extra_tokens` upcoming
        positions (admission reserves the first decode slot too, so a
        fresh admit can always take at least one step)."""
        return math.ceil((self.context_len + extra_tokens) / page_size)


class ContinuousBatcher:
    """Token-boundary scheduler over a PageAllocator and `max_batch`
    engine slots.

    mode="continuous": admit into any free slot whenever pages allow.
    mode="static": the A/B baseline — admissions only happen when the
    running set is EMPTY (classic padded static batching: the batch
    drains fully, finished requests' slots idle until the last one ends).
    """

    def __init__(self, allocator, max_batch=DEFAULT_MAX_BATCH,
                 mode="continuous", prefix_cache=None, spec_tokens=0):
        if mode not in ("continuous", "static"):
            raise ValueError(f"serve mode must be 'continuous' or "
                             f"'static', got {mode!r}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got "
                             f"{spec_tokens}")
        self.alloc = allocator
        self.max_batch = int(max_batch)
        self.mode = mode
        self.prefix = prefix_cache  # PrefixCache or None (reuse off)
        self.spec_tokens = int(spec_tokens)
        self.waiting = collections.deque()
        self.running = {}          # slot -> Request
        self.done = []
        self._admit_seq = 0
        self.stats = {"admissions": 0, "evictions": 0, "preemptions": 0,
                      "tokens": 0, "prefix_hit_tokens": 0,
                      "prefix_prompt_tokens": 0, "spec_steps": 0,
                      "spec_accepted": 0, "spec_rejected": 0}

    @property
    def _lookahead(self):
        """Token positions a request must own pages for beyond its
        current context before the next step: 1 for the plain decode
        write, plus draft-k when speculating (a spec step writes K/V for
        the last token AND all k drafts before accept/reject resolves,
        so page growth must reserve the whole window up front)."""
        return 1 + self.spec_tokens

    # -- gauges -----------------------------------------------------------

    def queue_depth(self):
        return len(self.waiting)

    def batch_fill(self):
        """Fraction of engine slots doing useful work this step — the
        SERVE_BATCH_FILL gauge (the quantity static batching wastes)."""
        return len(self.running) / max(1, self.max_batch)

    def kv_occupancy(self):
        return self.alloc.occupancy()

    # -- submission -------------------------------------------------------

    def submit(self, req, now=0.0):
        req.arrival_t = now if req.arrival_t == 0.0 else req.arrival_t
        req.state = _WAITING
        self.waiting.append(req)

    # -- token boundary ---------------------------------------------------

    def on_tokens(self, tokens_by_slot, now=0.0):
        """Record one decode step's outputs (slot -> token id, or slot ->
        token id LIST when a speculative step emitted several accepted
        tokens at once), then run the boundary: evict finished, grow
        pages (preempting if starved), admit. A list is consumed in
        order and truncated at the first EOS / max-tokens hit — trailing
        accepted drafts past a finish are dropped, exactly as if they
        were never accepted (rejection IS just not appending: the block
        table simply never extends over the stale K/V). Returns the list
        of requests evicted as DONE this boundary."""
        finished = []
        for slot, toks in tokens_by_slot.items():
            req = self.running.get(slot)
            if req is None:
                continue
            if isinstance(toks, int):
                toks = [toks]
            for tok in toks:
                req.generated.append(tok)
                self.stats["tokens"] += 1
                if req.first_token_t == 0.0:
                    req.first_token_t = now
                if tok == req.eos_id:
                    req.finish_reason = "eos"
                elif len(req.generated) >= req.max_new_tokens:
                    req.finish_reason = "max_tokens"
                if req.finish_reason:
                    finished.append(self._finish(req, now))
                    break
        self._grow_pages(now)
        self.admit(now)
        return finished

    def _finish(self, req, now):
        del self.running[req.slot]
        self.alloc.free(req.pages)
        req.pages = []
        req.state = _DONE
        req.finished_t = now
        req.slot = -1
        self.done.append(req)
        self.stats["evictions"] += 1
        return req

    def _take_pages(self, n):
        """alloc(n), reclaiming LRU unreferenced prefix-cache pages
        first when the pool alone cannot cover it. Cached prefixes are
        opportunistic — live requests always outrank them."""
        got = self.alloc.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict(n - self.alloc.free_pages())
            got = self.alloc.alloc(n)
        return got

    def _grow_pages(self, now):
        """Every running request must own page slots for its next
        ``1 + spec_tokens`` token positions before the next step.
        Requests crossing a page boundary take pages (evicting stale
        prefix-cache pages first); page starvation preempts the youngest
        running request (freeing its pages) until the growth fits."""
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None:
                continue  # preempted by an earlier growth this boundary
            while len(req.pages) < req.pages_needed(
                    self.alloc.page_size, extra_tokens=self._lookahead):
                got = self._take_pages(1)
                if got is not None:
                    req.pages.extend(got)
                    continue
                victim = max(self.running.values(),
                             key=lambda r: r.admit_seq)
                if victim is req:
                    # Nothing younger to preempt: this request IS the
                    # youngest. Preempt it rather than stall the batch.
                    self._preempt(req, now)
                    break
                self._preempt(victim, now)

    def _preempt(self, req, now):
        """Back to the waiting queue, pages freed, generated prefix kept
        (the re-prefill replays prompt + generated so no tokens are
        lost). Preempted requests go to the FRONT of the queue — they
        have priority over never-admitted work."""
        del self.running[req.slot]
        self.alloc.free(req.pages)
        req.pages = []
        req.slot = -1
        req.state = _WAITING
        req.cached_tokens = 0   # re-resolved against the cache at readmit
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.waiting.appendleft(req)

    def admit(self, now=0.0):
        """Fill free slots from the waiting queue while the first
        allocation fits. With a prefix cache attached, admission first
        resolves the longest cached page-aligned strict prefix of the
        prompt: those pages are SHARED (refcount bump, no copy — the
        request never writes below its own context length) and only the
        novel remainder is allocated. Returns newly admitted requests
        (they need a prefill of their uncached suffix before the next
        decode step)."""
        if self.mode == "static" and self.running:
            return []
        admitted = []
        free_slots = [s for s in range(self.max_batch)
                      if s not in self.running]
        while self.waiting and free_slots:
            req = self.waiting[0]
            shared, cached = [], 0
            if self.prefix is not None:
                shared, cached = self.prefix.lookup(req.prompt)
                # Pin the hit before any allocation can LRU-evict it:
                # at refcount 2 these pages are invisible to evict().
                self.alloc.share(shared)
            need = req.pages_needed(self.alloc.page_size,
                                    extra_tokens=self._lookahead)
            pages = self._take_pages(need - len(shared))
            if pages is None:
                if shared:
                    self.alloc.free(shared)  # unpin the aborted hit
                break  # head-of-line: keep arrival order, wait for pages
            self.waiting.popleft()
            req.pages = shared + pages
            req.cached_tokens = cached
            req.slot = free_slots.pop(0)
            req.state = _RUNNING
            req.admitted_t = now
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.running[req.slot] = req
            self.stats["admissions"] += 1
            if self.prefix is not None:
                self.stats["prefix_hit_tokens"] += cached
                self.stats["prefix_prompt_tokens"] += req.prompt_len
            admitted.append(req)
        return admitted

    def register_prefilled(self, req):
        """Publish a freshly prefilled request's full prompt pages into
        the prefix cache (no-op without one). Called by the serve loop
        once the prompt's K/V is actually materialized — registering at
        admission would let a second request hit pages whose suffix was
        never written."""
        if self.prefix is not None and req.slot >= 0:
            self.prefix.insert(req.prompt, req.pages)

    def prefix_hit_ratio(self):
        """Fraction of admitted prompt tokens served from cached pages —
        the SERVE_PREFIX_HIT_RATIO gauge (0.0 until the first admission
        with a cache attached)."""
        total = self.stats["prefix_prompt_tokens"]
        return self.stats["prefix_hit_tokens"] / total if total else 0.0

    def block_table(self, req, max_blocks):
        """The request's page list padded with trash page 0 to the
        engine's fixed block-table width."""
        if len(req.pages) > max_blocks:
            raise ValueError(
                f"request {req.rid} holds {len(req.pages)} pages > "
                f"max_blocks {max_blocks} (context "
                f"{req.context_len} too long for the cache geometry)")
        return list(req.pages) + [0] * (max_blocks - len(req.pages))

    def idle(self):
        return not self.waiting and not self.running
