"""Decoder Transformer (optionally MoE): the port of
``horovod_tpu/models/transformer.py``.

Params are a nested dict of tensors with the JAX pytree's names and
shapes (``wqkv [D,3,H,dh]``, ``wo [H,dh,D]``, ...), so a JAX init copies
1:1 through :func:`horovod_tpu_torch.models.convert.params_from_jax`.
float32 params, compute in ``cfg.dtype`` (bfloat16 by default).

Differentiable end to end: ``loss_fn`` under autograd is the training
loss, with flash attention's backward on the card's kernels (B2, B3)
and ``cfg.remat`` as ``torch.utils.checkpoint``.

Under a :class:`~..parallel.mesh.Mesh` (``forward``/``loss_fn``
``mesh=``) each rank holds its shard of the params
(:func:`param_specs`, ``convert.shard_params``) and of the batch over
``data``, and takes its own block of the sequence over ``seq``. Heads
and the FFN are split over ``model`` (Megatron: ``wqkv`` and ``w_in``
column-parallel, ``wo`` and ``w_out`` row-parallel), with the
collectives that XLA inserts in the reference written out
(``parallel/sharding.py``). Attention over a sequence-sharded mesh
gathers K/V (``"gather"``) or rotates them on a ring (``"ring"``);
``"flash"`` splits heads and batch only. Experts are split over
``expert`` (:func:`_expert_plan`): on an axis of its own, each rank runs
its experts on the tokens it shares with the axis; on an axis that
splits the tokens (``expert_axis="data"``, the reference's dp=ep reuse),
each rank gathers the experts and runs all of them on its own tokens.
"""

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import copy_to, gather, gather_replicated, reduce_from

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 4096
    max_seq_len: int = 2048
    n_experts: int = 0          # 0 = dense FFN; >0 = MoE every layer
    # "gather" (einsum + softmax; K/V all-gathered over a seq axis) |
    # "flash" (csrc/flash_*.cu on CUDA) | "ring" (K/V rotate over a seq
    # axis, parallel/ring_attention.py) | "auto" (resolve_attn)
    attn_impl: str = "auto"
    # Block size of the plain flash version (the kernel tiles by 64).
    attn_block: int = 512
    # >0: the loss projects to vocab + log-softmax per chunk of this many
    # positions, so the [S, vocab] float32 tensor never exists whole.
    loss_chunk: int = 0
    # Training: recompute each block in the backward instead of keeping its
    # activations (torch.utils.checkpoint, the reference's jax.checkpoint).
    remat: bool = False
    dtype: str = "bfloat16"
    data_axis: str = "data"
    model_axis: str = "model"
    seq_axis: str = "seq"
    expert_axis: str = "expert"

    def __post_init__(self):
        if self.attn_impl not in ("auto", "gather", "ring", "flash"):
            raise ValueError(
                f"attn_impl must be 'auto', 'gather', 'ring' or 'flash', "
                f"got {self.attn_impl!r}")

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]


def bert_large() -> TransformerConfig:
    """BERT-large scale (340M)."""
    return TransformerConfig(vocab_size=30522, d_model=1024, n_heads=16,
                             n_layers=24, d_ff=4096, max_seq_len=512)


def tiny(n_experts: int = 0) -> TransformerConfig:
    """Tiny config for tests."""
    return TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                             n_layers=2, d_ff=128, max_seq_len=64,
                             n_experts=n_experts)


# ---------------------------------------------------------------------------
# Params

def init_params(cfg: TransformerConfig, generator=None, device=None):
    """Random params with the reference's names, shapes and scales, drawn
    from ``generator`` (on its own device) and placed on ``device``.
    torch's and JAX's generators give different numbers from one seed:
    tests that compare the two packages convert the JAX init instead."""
    device = resolve_device(device)
    gen_dev = generator.device if generator is not None else device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=gen_dev)
                * scale).to(device)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def ln():
        return {"scale": torch.ones(D, device=device),
                "bias": torch.zeros(D, device=device)}

    D, F_, H, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    params = {
        "embed": normal((cfg.vocab_size, D), 0.02),
        "pos_embed": normal((cfg.max_seq_len, D), 0.02),
        "final_ln": ln(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {"ln1": ln(), "ln2": ln(),
                 "wqkv": dense((D, 3, H, dh), D),
                 "wo": dense((H, dh, D), D)}
        if cfg.n_experts > 0:
            E = cfg.n_experts
            layer["router"] = dense((D, E), D)
            layer["w_in"] = dense((E, D, F_), D)
            layer["w_out"] = dense((E, F_, D), F_)
        else:
            layer["w_in"] = dense((D, F_), D)
            layer["w_out"] = dense((F_, D), F_)
        params["layers"].append(layer)
    return params


def param_specs(cfg: TransformerConfig):
    """The sharding of each leaf of :func:`init_params`, a tree of the
    same shape whose leaves are tuples with one mesh axis name or None
    per dim (the reference's ``PartitionSpec``s; ``()`` replicated).

    tp: QKV/FFN-in column-parallel (output dim on ``model``), the out
    projections row-parallel (input dim on ``model``). ep: expert dim on
    ``expert``. The embedding table vocab-sharded on ``model``."""
    m, e = cfg.model_axis, cfg.expert_axis
    layer = {
        "ln1": {"scale": (), "bias": ()},
        "ln2": {"scale": (), "bias": ()},
        "wqkv": (None, None, m, None),    # heads sharded over model axis
        "wo": (m, None, None),            # row-parallel
    }
    if cfg.n_experts > 0:
        layer["router"] = ()
        layer["w_in"] = (e, None, m)
        layer["w_out"] = (e, m, None)
    else:
        layer["w_in"] = (None, m)
        layer["w_out"] = (m, None)
    return {
        "embed": (m, None),
        "pos_embed": (),
        "final_ln": {"scale": (), "bias": ()},
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def filter_specs(specs, mesh):
    """``specs`` with every axis name that ``mesh`` does not have set to
    None, so one model definition serves any mesh shape."""
    if isinstance(specs, dict):
        return {k: filter_specs(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [filter_specs(v, mesh) for v in specs]
    return tuple(a if a in mesh.axis_names else None for a in specs)


# ---------------------------------------------------------------------------
# Forward

def _layer_norm(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)   # jnp.var: population
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _groups(cfg, mesh):
    """This rank's (seq, model) process groups under ``mesh``; None for
    an axis the mesh lacks, and both None without a mesh."""
    if mesh is None:
        return None, None
    return tuple(mesh.group(a) if a in mesh.axis_names else None
                 for a in (cfg.seq_axis, cfg.model_axis))


def _qkv(x, layer, cfg, model_group=None):
    """q, k, v ``[B, S, H, dh]`` over this rank's heads: column-parallel
    over ``model_group``, whose ranks all hold the whole ``x``."""
    qkv = torch.einsum("bsd,dchk->cbshk", copy_to(x, model_group),
                       layer["wqkv"].to(cfg.compute_dtype))
    return qkv[0], qkv[1], qkv[2]


def _out(ctx, layer, cfg, model_group=None):
    """The row-parallel output projection, summed over ``model_group``."""
    out = torch.einsum("bshk,hkd->bsd", ctx, layer["wo"].to(cfg.compute_dtype))
    return reduce_from(out, model_group)


def _attention(x, layer, cfg, seq_group=None, model_group=None):
    """Causal multi-head attention with the logits materialized (the
    reference's gather path). Over ``seq_group`` the queries stay this
    rank's block and K/V are all-gathered; the block of rank r holds
    global rows ``[r*s, (r+1)*s)``, which the mask is built for (without
    a seq group the last s of t rows, as the reference's
    ``tril(...)[-s:, :]``)."""
    dt = cfg.compute_dtype
    q, k, v = _qkv(x, layer, cfg, model_group)
    if seq_group is not None:
        kv = gather(torch.stack([k, v]), seq_group, 2)    # [2, B, t, H, dh]
        k, v = kv[0], kv[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bshk,bthk->bhst", q, k) * scale
    s, t = logits.shape[-2], logits.shape[-1]
    q0 = t - s if seq_group is None else seq_group.rank() * s
    rows = torch.arange(q0, q0 + s, device=x.device)
    mask = rows[:, None] >= torch.arange(t, device=x.device)[None, :]
    logits = torch.where(mask, logits, torch.finfo(dt).min)
    probs = torch.softmax(logits.float(), -1).to(dt)
    ctx = torch.einsum("bhst,bthk->bshk", probs, v)
    return _out(ctx, layer, cfg, model_group)


def _attention_flash(x, layer, cfg, model_group=None):
    """Flash path: the [B,H,S,S] logits never exist in device memory. On
    a CUDA tensor this launches csrc/flash_fwd.cu, and csrc/flash_bwd.cu
    in the backward; on a CPU tensor it runs the kernels' plain
    versions. Under a mesh each rank runs it on its batch shard and its
    heads, as the reference's ``shard_map`` does."""
    q, k, v = _qkv(x, layer, cfg, model_group)
    ctx = flash_attention(q, k, v, causal=True, block=cfg.attn_block)
    return _out(ctx, layer, cfg, model_group)


def _attention_ring(x, layer, cfg, seq_group, model_group=None):
    """Ring path: K/V stay sequence-sharded and rotate over
    ``seq_group`` (parallel/ring_attention.py, the einsum step, as the
    reference calls it); each head group on ``model`` runs its own
    ring."""
    q, k, v = _qkv(x, layer, cfg, model_group)
    ctx = ring_attention(q, k, v, seq_group, causal=True)
    return _out(ctx, layer, cfg, model_group)


def _expert_plan(cfg, mesh):
    """How this rank runs the MoE FFN under ``mesh``, whose
    ``param_specs`` put ``w_in`` on ``(expert, None, model)`` and
    ``w_out`` on ``(expert, model, None)`` (the reference leaves the
    collectives to GSPMD): ``(gather_group, block, reduce_group)``.

    - ``expert`` an axis of its own: the tokens are the same on every
      rank of it, so each rank runs its block of experts (``block``, its
      coordinate along ``expert``: columns ``[block * E_loc, (block + 1)
      * E_loc)`` of the one-hot mask) and the partial outputs are summed
      over ``expert`` and ``model`` in one reduction (``reduce_group``,
      whose ``copy_to`` sums the input's gradient in the backward);
    - ``expert`` an axis that splits the tokens (``data`` or ``seq``):
      each rank all-gathers the experts over it (``gather_group``; the
      backward reduce-scatters their gradient, which then sums every
      rank's loss over that axis: ``make_train_step`` divides it by the
      axis size instead of averaging it, as ``shard_params`` marks the
      leaf cut over it) and runs all of them
      on its own tokens;
    - no ``expert`` axis: every expert on every rank.

    ``w_in``'s columns and ``w_out``'s rows are split over ``model`` in
    each case, and ``reduce_group`` includes ``model``."""
    if mesh is None:
        return None, 0, None
    names, e, m = mesh.axis_names, cfg.expert_axis, cfg.model_axis
    model = mesh.group(m) if m in names else None
    if e not in names:
        return None, 0, model
    if e in (cfg.data_axis, cfg.seq_axis):
        return mesh.group(e), 0, model
    group = mesh.groups((e, m)) if m in names else mesh.group(e)
    return None, mesh.coords()[names.index(e)], group


def _moe_ffn(x, layer, cfg, mesh=None):
    """Top-1 routed MoE, dense dispatch (einsum over one-hot masks); under
    ``mesh`` see :func:`_expert_plan`."""
    dt = cfg.compute_dtype
    gather_group, block, reduce_group = _expert_plan(cfg, mesh)
    gates = torch.einsum("bsd,de->bse", x, layer["router"].to(dt))
    gate_w = torch.softmax(gates.float(), -1)
    top = gate_w.argmax(-1)
    mask = F.one_hot(top, cfg.n_experts).to(dt)                  # [b,s,E]
    w = (gate_w.to(dt) * mask).sum(-1, keepdim=True)             # [b,s,1]
    w_in = gather(layer["w_in"], gather_group, 0).to(dt)
    w_out = gather(layer["w_out"], gather_group, 0).to(dt)
    e_loc = w_in.shape[0]
    mask = mask[..., block * e_loc:(block + 1) * e_loc]
    h = torch.einsum("bsd,edf->bsef", copy_to(x, reduce_group), w_in)
    h = F.gelu(h, approximate="tanh")                            # jax.nn.gelu
    y = torch.einsum("bsef,efd->bsed", h, w_out)
    return reduce_from(torch.einsum("bsed,bse->bsd", y, mask),
                       reduce_group) * w


def _ffn(x, layer, cfg, model_group=None):
    """``w_in`` column-parallel and ``w_out`` row-parallel over
    ``model_group``."""
    dt = cfg.compute_dtype
    h = F.gelu(torch.einsum("bsd,df->bsf", copy_to(x, model_group),
                            layer["w_in"].to(dt)),
               approximate="tanh")                               # jax.nn.gelu
    return reduce_from(torch.einsum("bsf,fd->bsd", h, layer["w_out"].to(dt)),
                       model_group)


# The flash-vs-gather crossover as LIVE score elements: causal
# self-attention at S=1024 materializes S*S/2 logits. This value is the
# JAX package's calibration on a TPU v5e; it awaits a measurement of the
# crossover on the H100.
_FLASH_SCORE_ELEMS = 1024 * 1024 // 2


def resolve_attn(cfg: TransformerConfig, seq_len: int, device,
                 kv_len=None, causal=True, mesh=None) -> str:
    """Resolve ``attn_impl="auto"`` for one (seq_len, kv_len, device,
    mesh); ``seq_len`` is the whole sequence, not a rank's block.

    - a mesh whose ``seq`` axis is larger than 1 -> "ring", for full
      self-attention only (``kv_len == seq_len``);
    - a CPU device -> "gather" (the plain flash version is right, not
      fast);
    - decode (``seq_len == 1``) -> "gather" whatever ``kv_len``: the
      [B,H,1,KV] score tensor is linear in KV;
    - otherwise the live score footprint ``seq_len * kv_len`` (halved for
      the causal self-attention triangle) against _FLASH_SCORE_ELEMS.
    """
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    kv = seq_len if kv_len is None else int(kv_len)
    if (mesh is not None and cfg.seq_axis in mesh.axis_names
            and mesh.shape[cfg.seq_axis] > 1 and kv == seq_len):
        return "ring"
    if torch.device(device).type != "cuda":
        return "gather"
    if seq_len == 1:
        return "gather"
    score = seq_len * kv
    if causal and kv == seq_len:
        score //= 2  # only the lower triangle is live
    return "flash" if score >= _FLASH_SCORE_ELEMS else "gather"


def _check_mesh(cfg, impl, mesh, seq_len):
    """The reference's errors for a mesh it cannot run, raised before any
    collective; ``seq_len`` is the whole sequence."""
    if mesh is None:
        return
    s, m = cfg.seq_axis, cfg.model_axis
    seq = mesh.shape.get(s, 1)
    model = mesh.shape.get(m, 1)
    if impl == "flash":
        if seq > 1:
            raise ValueError("attn_impl='flash' does not compose with a "
                             "sequence-sharded mesh; use 'ring'")
        if cfg.n_heads % model != 0:
            raise ValueError(
                f"attn_impl='flash' needs n_heads {cfg.n_heads} divisible "
                f"by the '{m}' axis size {model}")
    if impl == "ring" and s in mesh.axis_names:
        if seq_len % seq != 0:
            raise ValueError(
                f"attn_impl='ring' needs seq len {seq_len} divisible by the "
                f"'{s}' axis size {seq}")
        if cfg.n_heads % model != 0:
            raise ValueError(
                f"attn_impl='ring' needs n_heads {cfg.n_heads} divisible by "
                f"the '{m}' axis size {model}")
    if seq_len % seq != 0:
        raise ValueError(f"seq len {seq_len} must divide by the '{s}' axis "
                         f"size {seq}")


def apply_block(layer, x, cfg: TransformerConfig, impl=None, mesh=None):
    """One transformer block, ``(layer_params, x) -> x``; under ``mesh``
    ``x`` is this rank's block of the sequence and ``layer`` its shard."""
    seq_group, model_group = _groups(cfg, mesh)
    p = 1 if seq_group is None else seq_group.size()
    if impl is None:
        impl = resolve_attn(cfg, x.shape[1] * p, x.device, mesh=mesh)
    _check_mesh(cfg, impl, mesh, x.shape[1] * p)
    h = _layer_norm(x, layer["ln1"])
    if impl == "ring" and seq_group is not None:
        x = x + _attention_ring(h, layer, cfg, seq_group, model_group)
    elif impl == "flash":
        x = x + _attention_flash(h, layer, cfg, model_group)
    else:
        x = x + _attention(h, layer, cfg, seq_group, model_group)
    h = _layer_norm(x, layer["ln2"])
    if cfg.n_experts > 0:
        return x + _moe_ffn(h, layer, cfg, mesh)
    return x + _ffn(h, layer, cfg, model_group)


def _seq_block(x, seq_group):
    """This rank's block of dim 1."""
    if seq_group is None:
        return x
    n = x.shape[1] // seq_group.size()
    return x[:, seq_group.rank() * n:(seq_group.rank() + 1) * n]


def _hidden(params, tokens, cfg, mesh):
    """(final-layernorm hidden states of this rank's sequence block, the
    whole embedding table)."""
    dt = cfg.compute_dtype
    S = tokens.shape[1]
    impl = resolve_attn(cfg, S, tokens.device, mesh=mesh)
    _check_mesh(cfg, impl, mesh, S)
    seq_group, model_group = _groups(cfg, mesh)
    tokens = _seq_block(tokens, seq_group)
    # Activations are the same on every rank of `model`: the gathered
    # table's gradient is whole on each, which keeps its own rows. A
    # padded vocabulary (convert.shard_params) loses its pad rows here,
    # so they reach no logit and get a zero gradient.
    embed = gather_replicated(params["embed"], model_group,
                              0)[:cfg.vocab_size]
    x = embed.to(dt)[tokens]
    x = x + _seq_block(params["pos_embed"].to(dt)[:S][None], seq_group)
    remat = cfg.remat and torch.is_grad_enabled()
    # A recomputation must run every collective of the block on every
    # rank: no early stop once the saved tensors are back.
    with (contextlib.nullcontext() if mesh is None
          else set_checkpoint_early_stop(False)):
        for layer in params["layers"]:
            if remat:   # the model draws no random numbers: no RNG to replay
                x = checkpoint(apply_block, layer, x, cfg, impl, mesh,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = apply_block(layer, x, cfg, impl=impl, mesh=mesh)
    return _layer_norm(x, params["final_ln"]), embed


def forward(params, tokens, cfg: TransformerConfig, return_hidden=False,
            mesh=None):
    """tokens [B, S] integer tensor on the params' device -> logits
    [B, S, vocab] (compute dtype), or the final-layernorm hidden states
    [B, S, d] with ``return_hidden=True``. The output projection is tied
    to ``embed``.

    Under ``mesh`` (a :class:`~..parallel.mesh.Mesh` over the ranks that
    call it together) ``params`` is this rank's shard
    (``convert.shard_params``) and ``tokens`` its rows of the batch,
    ``[B/data, S]``; the result is this rank's block of the sequence,
    ``[B/data, S/seq, ...]``."""
    x, embed = _hidden(params, tokens, cfg, mesh)
    if return_hidden:
        return x
    return torch.einsum("bsd,vd->bsv", x, embed.to(cfg.compute_dtype))


def _nll(hidden, targets, embed):
    """-log p(target) per position from pre-projection hidden states."""
    logits = torch.einsum("bsd,vd->bsv", hidden, embed.to(hidden.dtype))
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def _nll_sum(hidden, targets, embed):
    return _nll(hidden, targets, embed).sum()


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy; differentiable (the training loss).
    batch = {"tokens": [B, S+1]}. With ``cfg.loss_chunk > 0`` the vocab
    projection and log-softmax run one sequence chunk at a time, each
    under ``torch.utils.checkpoint`` (the reference's
    ``lax.scan(jax.checkpoint(body))``), so the backward keeps no chunk's
    ``[B, C, vocab]`` float32 logits; the chunked and full losses are the
    same.

    Under ``mesh`` (see :func:`forward`) it is the mean over this rank's
    rows and sequence block, ``loss_chunk`` applying to the block; the
    mean of it over the ``data`` and ``seq`` axes (``make_train_step``
    with ``data_axis=("data", "seq")``) is the reference's loss."""
    tokens = batch["tokens"]
    hidden, embed = _hidden(params, tokens[:, :-1], cfg, mesh)
    targets = _seq_block(tokens[:, 1:], _groups(cfg, mesh)[0])
    C = cfg.loss_chunk
    S = targets.shape[1]
    if not C or S <= C:
        return _nll(hidden, targets, embed).mean()
    if S % C != 0:
        raise ValueError(f"seq len {S} must divide by loss_chunk {C}")
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, C):
        args = (hidden[:, c0:c0 + C], targets[:, c0:c0 + C], embed)
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if grad else _nll_sum(*args))
    return total / (targets.shape[0] * S)
