"""Ring attention, context parallelism over a mesh axis: the port of
``horovod_tpu/parallel/ring_attention.py``.

The sequence is split over the ranks of one process group; each rank
holds its block of q, k and v, ``[B, S_blk, H, D]``. K and V travel the
ring (:func:`~.sharding.ring_blocks`: one ``sendrecv`` a step, to rank
r+1, from rank r-1; the backward goes the other way) while each rank
folds every block into its output with an online softmax, so no rank
holds more than a block pair's logits. The blocks that arrive stay for
the backward, as the products that use them would keep them anyway.

- The local block comes first, then p-1 rotations.
- ``layout="contiguous"``: shard i holds positions ``[i*S_blk,
  (i+1)*S_blk)``; under ``causal=True`` a block from a later shard is
  all masked and :func:`accumulate` skips it. ``"striped"``: shard i
  holds ``{i, i+p, i+2p, ...}``, every pair is about half masked and
  every rank does equal work (:func:`stripe_sequence`).
- ``inner="einsum"`` computes a pair with the ``[S_blk, S_blk]`` logits
  in float32; ``inner="flash"`` (the reference's
  ``_ring_attention_flash``) runs the flash kernels
  (``ops/flash_attention.py`` ``flash_attention_lse``: B1 forward, B2 and
  B3 backward, on a CUDA tensor) in mode none, diag or strict by the
  pair's layout and merges the partials by their log-sum-exp, whose
  gradient then reaches the backward kernels as a nonzero dLSE. Both
  are :func:`accumulate`, one call a block pair.

Call it on each rank's own blocks, as the body of the reference's
``shard_map`` sees them, or wrap a mesh's group with
:func:`make_ring_attention`.
"""

import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention_lse
from .sharding import gather, ring_blocks


def _merge_partials(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions by their log-sum-exp:
    o = o1*exp(lse1-lse) + o2*exp(lse2-lse), lse = logaddexp(lse1, lse2).
    o*: [B, S, H, D] f32; lse*: [B, H, S] f32 (-1e30 sentinel = empty —
    finite, so the exp/logaddexp algebra never produces inf-inf NaNs)."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse).transpose(1, 2)[..., None]
    return o1 * w1 + o2 * w2, lse


def _positions(shard, S, p, layout, device):
    """The global positions of shard ``shard``'s ``S`` rows."""
    i = torch.arange(S, device=device)
    return shard + p * i if layout == "striped" else shard * S + i


def _flash_mode(my, src, causal, layout):
    """The kernel's mask mode for q of shard ``my`` against k of shard
    ``src``, or None for a pair that is all masked. Striped: q at my +
    p·i sees k at src + p·j iff i > j, or i == j when my >= src.
    Contiguous: earlier shards in full, its own causally, later ones
    not at all."""
    if not causal:
        return "none"
    if layout == "striped":
        return "diag" if my >= src else "strict"
    if src == my:
        return "diag"
    return "none" if src < my else None


def init_acc(q, inner):
    """The empty accumulator of :func:`accumulate` for this rank's q:
    (o, m, l) for the einsum step (m = -inf), (o, lse) for the flash
    step (lse = the finite -1e30)."""
    B, S, H, D = q.shape
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    if inner == "flash":
        return o, torch.full((B, H, S), NEG_INF, device=q.device)
    return (o, torch.full((B, H, S), -math.inf, device=q.device),
            torch.zeros((B, H, S), device=q.device))


def accumulate(acc, q, k_blk, v_blk, my, src, p, *, causal, layout, inner,
               scale, block=256):
    """Fold the block pair (q of shard ``my``, k/v of shard ``src``) of a
    ring of ``p`` into ``acc`` (:func:`init_acc`), as the reference's
    ``accumulate`` closures do; returns the new accumulator. A pair that
    the causal mask hides whole (contiguous, ``src > my``) is skipped."""
    if inner == "flash":
        mode = _flash_mode(my, src, causal, layout)
        if mode is None:
            return acc
        o_p, lse_p = flash_attention_lse(q, k_blk, v_blk, mode=mode,
                                         sm_scale=scale, block=block)
        return _merge_partials(acc[0], acc[1], o_p.float(), lse_p)
    if causal and layout == "contiguous" and src > my:
        return acc
    o, m, l = acc
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    mask = None
    if causal:
        S = q.shape[1]
        mask = (_positions(my, S, p, layout, q.device)[:, None]
                >= _positions(src, S, p, layout, q.device)[None, :])
        s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    # all-masked rows keep m = -inf; guard the exp against inf - inf
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    corr = torch.exp(torch.where(torch.isneginf(m), m, m - m_safe))
    w = torch.exp(s - m_safe[..., None])
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    l = l * corr + w.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", w, v_blk.float())
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, m_new, l


def finish(acc, inner, dtype):
    """The output ``[B, S_blk, H, D]`` in ``dtype`` from a full
    accumulator; a row that saw no key comes out 0."""
    if inner == "flash":
        return acc[0].to(dtype)
    o, _, l = acc
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)[..., None]).to(dtype)


def ring_attention(q, k, v, group, causal=True, scale=None,
                   layout="contiguous", inner="einsum", inner_block=256):
    """Blockwise ring attention over ``group`` (a mesh axis's process
    group; None for one rank). q, k, v: ``[B, S_blk, H, D]``, this rank's
    block, its rank in ``group`` its shard index. Returns ``[B, S_blk, H,
    D]`` in q's dtype; softmax statistics in float32. ``inner_block`` is
    the block size of the flash step's plain version (the kernel tiles by
    64)."""
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout: {layout!r}")
    if inner not in ("einsum", "flash"):
        raise ValueError(f"unknown inner: {inner!r}")
    p, my = (1, 0) if group is None else (group.size(), group.rank())
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = init_acc(q, inner)
    # K and V ride the ring together: one rotation a step.
    for i, kv in enumerate(ring_blocks(torch.stack([k, v]), group)):
        acc = accumulate(acc, q, kv[0], kv[1], my, (my - i) % p, p,
                         causal=causal, layout=layout, inner=inner,
                         scale=scale, block=inner_block)
    return finish(acc, inner, q.dtype)


def stripe_sequence(x, p, seq_dim=1):
    """Permute a contiguous global sequence into striped order: after
    sharding dim ``seq_dim`` into p equal blocks, shard i holds global
    positions {i, i+p, ...} in increasing order."""
    S = x.shape[seq_dim]
    idx = torch.arange(S, device=x.device).reshape(S // p, p).T.reshape(-1)
    return x.index_select(seq_dim, idx)


def unstripe_sequence(x, p, seq_dim=1):
    """Inverse of :func:`stripe_sequence`."""
    S = x.shape[seq_dim]
    idx = torch.arange(S, device=x.device).reshape(S // p, p).T.reshape(-1)
    return x.index_select(seq_dim, torch.argsort(idx))


def make_ring_attention(mesh, axis="seq", causal=True, batch_axis=None,
                        head_axis=None, layout="contiguous", inner="einsum",
                        inner_block=256):
    """``fn(q, k, v)`` over this rank's contiguous blocks ``[B_blk, S_blk,
    H_blk, D]`` of a global ``[B, S, H, D]`` that is sequence-sharded on
    ``axis`` of ``mesh`` and, optionally, batch-sharded on ``batch_axis``
    and head-sharded on ``head_axis`` (each head group runs its own ring;
    the blocks are already this rank's, so those two only name the
    layout and must be axes of the mesh).

    ``layout="striped"`` with ``causal=True`` re-orders the sequence into
    striped order on the way in and back on the way out, so the caller
    keeps contiguous blocks while every rank does equal causal work. As
    in the reference that costs global permutations per call (here an
    all-gather of q, k and v and one of the output over ``axis``); a
    many-layer model should stripe its tokens once instead."""
    for name in (axis, batch_axis, head_axis):
        if name is not None and name not in mesh.axis_names:
            raise ValueError(f"{name!r} is not an axis of {mesh}")
    group = mesh.group(axis)
    p = mesh.shape[axis]
    striped = layout == "striped" and causal

    def ring(q, k, v):
        return ring_attention(q, k, v, group, causal=causal,
                              layout="striped" if striped else "contiguous",
                              inner=inner, inner_block=inner_block)

    if not striped:
        return ring

    def own(x):
        n = x.shape[1] // p
        return x[:, group.rank() * n:(group.rank() + 1) * n]

    def wrapped(q, k, v):
        qkv = gather(torch.stack([q, k, v]), group, 2)    # [3, B, S, H, D]
        q, k, v = (own(stripe_sequence(t, p)) for t in qkv)
        out = gather(ring(q, k, v), group, 1)
        return own(unstripe_sequence(out, p))

    return wrapped
