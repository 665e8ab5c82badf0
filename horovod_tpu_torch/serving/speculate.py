"""Speculative decoding drafters + the accept/reject rule (jax-free).

The port's own copy of ``horovod_tpu/serving/speculate.py`` (plain
Python; the port imports nothing of the JAX package).

Speculative decoding turns k sequential decode steps into ONE batched
target step: a cheap **drafter** proposes ``k`` candidate tokens, the
target model scores ``[last_token, d_1 .. d_k]`` in a single forward
pass through the same paged block tables (``engine.make_chunk_step``
with ``q_len = k + 1``), and the token boundary keeps the longest
draft prefix the target agrees with.

Accept rule (greedy target — provably bit-identical to plain greedy
decoding, tests/test_serving.py pins it):

    g_i = argmax(logits at position i)        # i = 0 .. k
    a   = max prefix length with d_{i+1} == g_i for all i < a
    emit g_0 .. g_a                           # a accepted + 1 bonus

Position ``i``'s logits condition on ``last_token, d_1 .. d_i`` — valid
target output only while every consumed draft was itself accepted,
which is exactly ``i <= a``. The bonus token ``g_a`` is the target's
own next choice after the accepted run, so even a fully rejected draft
(a = 0) still emits one token: a spec step NEVER does worse than a
plain decode step, it only risks wasted draft-lane FLOPs.

Rejected drafts cost nothing to undo: their K/V was written at
positions ``context + a .. context + k - 1``, but the request's context
length only advances over accepted tokens, so the block table simply
never extends over the stale entries — the next step overwrites
position ``context'`` (= context + a + 1) first, and the causal mask
(``kv_pos <= position``) hides anything beyond. Rejection IS a
block-table truncation; preemption replay and EOS eviction semantics
are untouched.

Drafters are pluggable: anything with ``propose(context, k) ->
list[int]`` (at MOST k tokens; short or empty proposals are fine — the
serve loop pads, and padded lanes that match by luck are still
correct). :class:`NGramDrafter` is the zero-cost self-drafting
baseline; a learned draft model drops in behind the same method.
"""


class NGramDrafter:
    """Prompt-lookup / self-drafting: find the most recent earlier
    occurrence of the context's trailing ``n``-gram and propose the
    tokens that followed it.

    Free (no model, no state) and surprisingly effective wherever
    output echoes input or repeats itself — templated answers, code,
    retrieval-augmented prompts. ``n = 2`` is the standard
    prompt-lookup setting: long enough to avoid random unigram matches,
    short enough to fire often.
    """

    def __init__(self, n=2):
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.n = int(n)

    def propose(self, context, k):
        n = self.n
        if k <= 0 or len(context) <= n:
            return []
        pattern = tuple(context[-n:])
        # Most recent match with a FULL k-token continuation wins:
        # recent continuations track the current "register" of the text
        # best, but a match too close to the end (the common case in a
        # repetition cycle — the trailing n-gram IS the cycle) has its
        # continuation cut off and would waste draft lanes. Fall back
        # to the longest partial continuation if no full one exists.
        best = []
        for i in range(len(context) - n - 1, -1, -1):
            if tuple(context[i:i + n]) == pattern:
                cont = list(context[i + n:i + n + k])
                if len(cont) == k:
                    return cont
                if len(cont) > len(best):
                    best = cont
        return best


class FixedDrafter:
    """Always proposes the same token sequence — a deterministic test
    double for pinning accept/reject arithmetic (not for serving)."""

    def __init__(self, tokens):
        self.tokens = list(tokens)

    def propose(self, context, k):
        return self.tokens[:k]


def accept_drafts(drafts, greedy):
    """Apply the accept rule: ``drafts`` are the k proposed tokens,
    ``greedy`` the k+1 target argmaxes from the spec step. Returns
    ``(emitted, accepted, rejected)`` where ``emitted`` is the token
    list to feed the boundary (``a`` accepted drafts + 1 bonus),
    ``accepted == a`` and ``rejected == k - a``."""
    k = len(drafts)
    if len(greedy) != k + 1:
        raise ValueError(f"spec step returned {len(greedy)} logits "
                         f"positions for {k} drafts (want k + 1)")
    a = 0
    while a < k and drafts[a] == greedy[a]:
        a += 1
    return list(greedy[:a + 1]), a, k - a
