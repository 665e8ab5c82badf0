"""Ulysses-style sequence parallelism, an all-to-all head scatter: the
port of ``horovod_tpu/parallel/ulysses.py``.

Activations arrive sequence-sharded ``[B, S/P, H, D]``; one all-to-all
re-shards them by heads, ``[B, S, H/P, D]``, so every rank runs
full-sequence attention on a slice of the heads, and a second one
restores the sequence sharding. Both all-to-alls are
:func:`~.sharding.all_to_all` over the axis's process group, whose
backward is the inverse all-to-all.
"""

import math

import torch

from .sharding import all_to_all


def seq_to_heads(x, group):
    """[..., B, S_blk, H, D] seq-sharded -> [..., B, S, H_blk, D]
    head-sharded."""
    return all_to_all(x, group, -2, -3)


def heads_to_seq(x, group):
    """Inverse of :func:`seq_to_heads`."""
    return all_to_all(x, group, -3, -2)


def _full_attention(q, k, v, causal, scale):
    q32, k32, v32 = (t.float() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        S = s.shape[-1]
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, -math.inf)
    w = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v32).to(q.dtype)


def ulysses_attention(q, k, v, group, causal=True, scale=None):
    """Attention over a sequence-sharded axis (its process group) by
    all-to-all head scatter. q/k/v: ``[B, S_blk, H, D]``; H must divide by
    the group's size. Returns ``[B, S_blk, H, D]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # q, k and v cross in one all-to-all, so one backward node returns
    # them: no two backward collectives can swap order between ranks.
    qh, kh, vh = seq_to_heads(torch.stack([q, k, v]), group)
    oh = _full_attention(qh, kh, vh, causal, scale)
    return heads_to_seq(oh, group)


def make_ulysses_attention(mesh, axis="seq", causal=True, batch_axis=None):
    """``fn(q, k, v)`` over this rank's blocks of a global ``[B, S, H, D]``
    sequence-sharded on ``axis`` of ``mesh`` (and batch-sharded on
    ``batch_axis``, which must then be an axis of the mesh)."""
    for name in (axis, batch_axis):
        if name is not None and name not in mesh.axis_names:
            raise ValueError(f"{name!r} is not an axis of {mesh}")
    group = mesh.group(axis)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal)

    return fn
