"""Decode engine: the port of ``horovod_tpu/serving/engine.py``.

Prefill, single-token decode and multi-token chunk steps over the paged
KV cache, built on :mod:`horovod_tpu_torch.models.transformer` params.
Like the reference, the engine runs no attention kernel: every path
computes attention as einsum + softmax over the gathered pages (a decode
step is q_len=1 against ``max_kv`` cached tokens, which
``transformer.resolve_attn`` files as "gather").

The reference's jitted steps donate the cache and return a new one; the
port's steps update the cache tensors IN PLACE and return the same dict,
so callers keep the ``cache, logits = step(params, cache, ...)`` form.
Masked writes (inactive batch slots, padding, positions past the cache)
go to trash page 0, and reads are masked by ``kv_pos <= position``.

Step inputs (tokens, positions, block tables, ...) may be numpy arrays
or tensors; they are moved to the cache's device.

Tensor parallelism: under a :class:`~..parallel.mesh.Mesh` (``mesh=``)
every rank of it calls each step with the same inputs, ``params`` is its
shard (``models/convert.py::shard_params``) and the cache its heads
(``kv_cache.make_cache(mesh=)``). Where the reference's GSPMD inserts
the collectives, they are written out over ``Mesh.group("model")``:

- heads: ``wqkv`` column-parallel, the rank's heads attend over its own
  pages, and the row-parallel ``wo`` is summed (one all-reduce);
- the FFN: ``w_in`` column-parallel, ``w_out`` row-parallel (one
  all-reduce); MoE layers as ``transformer._moe_ffn`` runs them;
- the vocab-sharded embedding is never gathered whole: the lookup is
  vocab-parallel (each rank takes the rows it holds, zeros for the rest,
  one all-reduce), and the tied logits are each rank's rows, all-gathered
  on the vocab dim, so every rank holds the same float32 logits, bit for
  bit.
"""

import math

import torch

from ..models import transformer as tfm
from ..models.transformer import _ffn, _layer_norm, _moe_ffn, _out, _qkv
from ..parallel.sharding import gather, reduce_from, solo
from . import kv_cache


def _check_decode_impl(cfg, geo, device, mesh=None):
    impl = tfm.resolve_attn(cfg, 1, device, kv_len=geo.max_kv, causal=True,
                            mesh=mesh)
    if impl != "gather":
        raise ValueError(
            f"serving decode needs the gather attention path for its "
            f"q_len=1 paged reads, but attn_impl={cfg.attn_impl!r} "
            f"resolved to {impl!r}; use attn_impl='auto' or 'gather'")


def _setup(cfg, geo, device, mesh):
    """The checks every step makes when it is built; returns its model
    group, or None where that group moves nothing (``sharding.solo``: no
    mesh, no model axis, or one rank on it), and the step is then the
    mesh-free one."""
    device, _ = kv_cache.placement(cfg, device, mesh)
    _check_decode_impl(cfg, geo, device, mesh)
    if mesh is None or cfg.model_axis not in mesh.axis_names:
        return None
    group = mesh.group(cfg.model_axis)
    return None if solo(group) else group


def _check_pad(cfg, geo, prefill_pad):
    pad = geo.max_kv if prefill_pad is None else int(prefill_pad)
    if pad % geo.page_size != 0:
        raise ValueError(f"prefill_pad {pad} must be a multiple of "
                         f"page_size {geo.page_size}")
    if pad > cfg.max_seq_len:
        raise ValueError(
            f"prefill_pad {pad} exceeds the model's max_seq_len "
            f"{cfg.max_seq_len} (pos_embed rows); shrink the cache "
            f"geometry or raise max_seq_len")
    return pad


def _idx(x, device):
    return torch.as_tensor(x, device=device).long()


def _embed(params, tokens, cfg, group):
    """Rows ``tokens`` of the embedding table in the compute dtype. Over
    ``group`` the table is this rank's block of the vocabulary: the rank
    looks up the rows it holds, zeros for the others, and one all-reduce
    sums the blocks (each row is nonzero on one rank only)."""
    table, dt = params["embed"], cfg.compute_dtype
    if group is None:
        return table[tokens].to(dt)
    n = table.shape[0]
    local = tokens - group.rank() * n
    held = ((local >= 0) & (local < n))[..., None]
    x = table[local.clamp(0, n - 1)].to(dt)
    return reduce_from(torch.where(held, x, torch.zeros((), dtype=dt,
                                                        device=x.device)),
                       group)


def _logits(x, params, cfg, group):
    """Float32 logits ``[..., vocab]`` of the hidden states ``x [...,
    D]`` through the tied table; over ``group`` each rank projects onto
    its block of the vocabulary and the blocks are all-gathered."""
    out = torch.einsum("...d,vd->...v", x,
                       params["embed"].to(cfg.compute_dtype))
    return gather(out, group, out.ndim - 1).float()


def _ffn_block(x, layer, cfg, mesh, group):
    h = _layer_norm(x, layer["ln2"])
    if cfg.n_experts > 0:
        return x + _moe_ffn(h, layer, cfg, mesh)
    return x + _ffn(h, layer, cfg, group)


def _attend(q, kp, vp, mask, layer, cfg, group):
    """Masked softmax attention of q [B,Q,H,dh] over kp/vp [B,T,H,dh]
    (mask broadcastable to [B,H,Q,T]; H this rank's heads), projected
    back to d_model — the math of ``transformer._attention``."""
    dt = cfg.compute_dtype
    logits = torch.einsum("bshk,bthk->bhst", q, kp) * (1.0 / math.sqrt(
        cfg.head_dim))
    logits = torch.where(mask, logits, torch.finfo(dt).min)
    probs = torch.softmax(logits.float(), -1).to(dt)
    ctx = torch.einsum("bhst,bthk->bshk", probs, vp)
    return _out(ctx, layer, cfg, group)


def make_prefill(cfg, geo, device=None, prefill_pad=None, mesh=None):
    """``(params, cache, tokens, length, block_table) -> (cache, logits)``.

    tokens: [prefill_pad] (zero-padded); length: real token count;
    block_table: [max_blocks] page ids (trash 0 past the owned pages).
    Returns the cache and the last REAL position's next-token logits
    [vocab] (float32). ``prefill_pad`` defaults to ``geo.max_kv`` so a
    preempted request can replay prompt + generated prefix. ``mesh``:
    see the module's docstring."""
    group = _setup(cfg, geo, device, mesh)
    pad = _check_pad(cfg, geo, prefill_pad)
    n_blocks = pad // geo.page_size
    dt = cfg.compute_dtype

    @torch.no_grad()
    def prefill(params, cache, tokens, length, block_table):
        ck, cv = cache["k"], cache["v"]
        dev = ck.device
        tokens, bt = _idx(tokens, dev), _idx(block_table, dev)[:n_blocks]
        x = _embed(params, tokens, cfg, group)[None]
        x = x + params["pos_embed"].to(dt)[:pad][None]
        mask = torch.ones((pad, pad), dtype=torch.bool, device=dev).tril()
        for li, layer in enumerate(params["layers"]):
            h = _layer_norm(x, layer["ln1"])
            q, k, v = _qkv(h, layer, cfg, group)
            # Page write through the block table: positions past `length`
            # land in owned slots the decode mask hides, or in page 0.
            ck[li, bt] = k[0].reshape(n_blocks, geo.page_size,
                                      *k.shape[2:])
            cv[li, bt] = v[0].reshape(n_blocks, geo.page_size,
                                      *v.shape[2:])
            x = x + _attend(q, k, v, mask, layer, cfg, group)
            x = _ffn_block(x, layer, cfg, mesh, group)
        x = _layer_norm(x, params["final_ln"])
        return cache, _logits(x[0, int(length) - 1], params, cfg, group)

    return prefill


def make_decode_step(cfg, geo, device=None, max_batch=8, mesh=None):
    """``(params, cache, tokens, positions, block_tables, active) ->
    (cache, logits)`` — one token for every slot.

    tokens/positions/active: [max_batch]; block_tables: [max_batch,
    max_blocks]. ``positions[b]`` is the index the slot's token is
    written at; the read mask is ``kv_pos <= position``. Inactive slots
    write to trash page 0 and their logits are never read."""
    group = _setup(cfg, geo, device, mesh)
    dt = cfg.compute_dtype
    max_kv = geo.max_kv

    @torch.no_grad()
    def decode(params, cache, tokens, positions, block_tables, active):
        ck, cv = cache["k"], cache["v"]
        dev = ck.device
        tokens, positions = _idx(tokens, dev), _idx(positions, dev)
        tables = _idx(block_tables, dev)
        active = torch.as_tensor(active, device=dev).bool()
        x = (_embed(params, tokens, cfg, group)
             + params["pos_embed"].to(dt)[positions])[:, None, :]
        page_ids = tables.gather(1, (positions // geo.page_size)[:, None])
        page_ids = torch.where(active, page_ids[:, 0], 0)   # trash route
        slot_w = torch.where(active, positions % geo.page_size, 0)
        kv_mask = (torch.arange(max_kv, device=dev)[None, None, :]
                   <= positions[:, None, None])             # [B, 1, KV]
        for li, layer in enumerate(params["layers"]):
            h = _layer_norm(x, layer["ln1"])
            q, k, v = _qkv(h, layer, cfg, group)            # [B, 1, H, dh]
            ck[li, page_ids, slot_w] = k[:, 0]
            cv[li, page_ids, slot_w] = v[:, 0]
            kp = ck[li][tables].reshape(-1, max_kv, *ck.shape[3:])
            vp = cv[li][tables].reshape(-1, max_kv, *cv.shape[3:])
            x = x + _attend(q, kp, vp, kv_mask[:, None], layer, cfg, group)
            x = _ffn_block(x, layer, cfg, mesh, group)
        x = _layer_norm(x, params["final_ln"])
        return cache, _logits(x[:, 0], params, cfg, group)

    return decode


def _chunk_forward(params, cache, tokens, positions, block_tables, active,
                   *, cfg, geo, mesh, group):
    """Shared body of every multi-token paged step: embed a [B, Q] window
    starting at ``positions[b]``, scatter its K/V through the block
    tables, attend over the gathered pages under ``kv_pos <= position``.
    The window's own K/V is written before the gather, so within-window
    causality falls out of the same mask. Returns x [B, Q, D] after
    final_ln (the cache is updated in place)."""
    dt = cfg.compute_dtype
    ck, cv = cache["k"], cache["v"]
    dev = ck.device
    tokens, positions = _idx(tokens, dev), _idx(positions, dev)
    tables = _idx(block_tables, dev)
    active = torch.as_tensor(active, device=dev).bool()
    max_kv = geo.max_kv
    pos = positions[:, None] + torch.arange(tokens.shape[1],
                                            device=dev)[None, :]   # [B, Q]
    pe = pos.clamp(0, cfg.max_seq_len - 1)
    x = _embed(params, tokens, cfg, group) + params["pos_embed"].to(dt)[pe]
    blk = (pos // geo.page_size).clamp(max=geo.max_blocks - 1)
    valid = (pos < max_kv) & active[:, None]
    page_ids = torch.where(valid, tables.gather(1, blk), 0)       # trash
    slot_w = torch.where(valid, pos % geo.page_size, 0)
    kv_mask = (torch.arange(max_kv, device=dev)[None, None, :]
               <= pos[:, :, None])                                # [B,Q,KV]
    for li, layer in enumerate(params["layers"]):
        h = _layer_norm(x, layer["ln1"])
        q, k, v = _qkv(h, layer, cfg, group)                      # [B,Q,H,dh]
        ck[li, page_ids, slot_w] = k
        cv[li, page_ids, slot_w] = v
        kp = ck[li][tables].reshape(-1, max_kv, *ck.shape[3:])
        vp = cv[li][tables].reshape(-1, max_kv, *cv.shape[3:])
        x = x + _attend(q, kp, vp, kv_mask[:, None], layer, cfg, group)
        x = _ffn_block(x, layer, cfg, mesh, group)
    return _layer_norm(x, params["final_ln"])


def make_chunk_step(cfg, geo, device=None, q_len=None, mesh=None):
    """``(params, cache, tokens, positions, block_tables, active) ->
    (cache, logits)`` — a ``q_len``-token window for every slot.

    tokens: [B, q_len]; positions: [B] (where ``tokens[b, 0]`` is
    written); block_tables: [B, max_blocks]; active: [B]. Returns logits
    for every window position [B, q_len, vocab] (float32). Used for
    chunked prefill of prefix-cache hits (B=1) and speculative scoring
    (q_len = draft_k + 1)."""
    group = _setup(cfg, geo, device, mesh)
    q_len = geo.page_size if q_len is None else int(q_len)
    if q_len < 1:
        raise ValueError(f"chunk q_len must be >= 1, got {q_len}")
    if geo.max_kv > cfg.max_seq_len:
        raise ValueError(
            f"cache width {geo.max_kv} exceeds the model's max_seq_len "
            f"{cfg.max_seq_len} (pos_embed rows); shrink the geometry")

    @torch.no_grad()
    def chunk(params, cache, tokens, positions, block_tables, active):
        x = _chunk_forward(params, cache, tokens, positions, block_tables,
                           active, cfg=cfg, geo=geo, mesh=mesh, group=group)
        return cache, _logits(x, params, cfg, group)

    return chunk


def make_batched_prefill(cfg, geo, device=None, prefill_pad=None,
                         mesh=None):
    """``(params, cache, tokens, lengths, block_tables, active) ->
    (cache, logits)`` — all same-boundary admissions' prompts in one
    padded call. tokens: [B, prefill_pad]; lengths: [B]; block_tables:
    [B, max_blocks]; active: [B] (padding rows write to page 0). Returns
    each row's last real position's logits [B, vocab] (float32)."""
    pad = _check_pad(cfg, geo, prefill_pad)
    group = _setup(cfg, geo, device, mesh)

    @torch.no_grad()
    def bprefill(params, cache, tokens, lengths, block_tables, active):
        dev = cache["k"].device
        tokens = _idx(tokens, dev)
        positions = torch.zeros(tokens.shape[0], dtype=torch.long,
                                device=dev)
        x = _chunk_forward(params, cache, tokens, positions, block_tables,
                           active, cfg=cfg, geo=geo, mesh=mesh, group=group)
        last = (_idx(lengths, dev) - 1).clamp(0, pad - 1)
        x = x[torch.arange(x.shape[0], device=dev), last]
        return cache, _logits(x, params, cfg, group)

    return bprefill


def greedy(logits):
    """Greedy next token per row (float32 logits [.., vocab])."""
    return logits.argmax(-1).to(torch.int32)
