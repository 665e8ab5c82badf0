"""Decoder Transformer (optionally MoE): the port of
``horovod_tpu/models/transformer.py``.

Params are a nested dict of tensors with the JAX pytree's names and
shapes (``wqkv [D,3,H,dh]``, ``wo [H,dh,D]``, ...), so a JAX init copies
1:1 through :func:`horovod_tpu_torch.models.convert.params_from_jax`.
float32 params, compute in ``cfg.dtype`` (bfloat16 by default).

Differentiable end to end: ``loss_fn`` under autograd is the training
loss, with flash attention's backward on the card's kernels (B2, B3)
and ``cfg.remat`` as ``torch.utils.checkpoint``. Single device only:
the mesh paths (``ring`` attention, tensor-parallel specs, flash under
``shard_map``) come with the process-group slice.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.flash_attention import flash_attention

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
    # "gather" (einsum + softmax) | "flash" (csrc/flash_*.cu on CUDA) |
    # "ring" (needs the process-group slice) | "auto" (resolve_attn)
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


# ---------------------------------------------------------------------------
# Forward

def _layer_norm(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)   # jnp.var: population
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _qkv(x, layer, cfg):
    qkv = torch.einsum("bsd,dchk->cbshk", x,
                       layer["wqkv"].to(cfg.compute_dtype))
    return qkv[0], qkv[1], qkv[2]


def _attention(x, layer, cfg):
    """Causal multi-head attention with the logits materialized (the
    reference's gather path on one device)."""
    dt = cfg.compute_dtype
    q, k, v = _qkv(x, layer, cfg)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bshk,bthk->bhst", q, k) * scale
    s, t = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((t, t), dtype=torch.bool,
                      device=x.device).tril()[-s:, :]
    logits = torch.where(mask, logits, torch.finfo(dt).min)
    probs = torch.softmax(logits.float(), -1).to(dt)
    ctx = torch.einsum("bhst,bthk->bshk", probs, v)
    return torch.einsum("bshk,hkd->bsd", ctx, layer["wo"].to(dt))


def _attention_flash(x, layer, cfg):
    """Flash path: the [B,H,S,S] logits never exist in device memory. On
    a CUDA tensor this launches csrc/flash_fwd.cu, and csrc/flash_bwd.cu
    in the backward; on a CPU tensor it runs the kernels' plain
    versions."""
    dt = cfg.compute_dtype
    q, k, v = _qkv(x, layer, cfg)
    ctx = flash_attention(q, k, v, causal=True, block=cfg.attn_block)
    return torch.einsum("bshk,hkd->bsd", ctx, layer["wo"].to(dt))


def _moe_ffn(x, layer, cfg):
    """Top-1 routed MoE, dense dispatch (einsum over one-hot masks)."""
    dt = cfg.compute_dtype
    gates = torch.einsum("bsd,de->bse", x, layer["router"].to(dt))
    gate_w = torch.softmax(gates.float(), -1)
    top = gate_w.argmax(-1)
    mask = F.one_hot(top, cfg.n_experts).to(dt)                  # [b,s,E]
    w = (gate_w.to(dt) * mask).sum(-1, keepdim=True)             # [b,s,1]
    h = torch.einsum("bsd,edf->bsef", x, layer["w_in"].to(dt))
    h = F.gelu(h, approximate="tanh")                            # jax.nn.gelu
    y = torch.einsum("bsef,efd->bsed", h, layer["w_out"].to(dt))
    return torch.einsum("bsed,bse->bsd", y, mask) * w


def _ffn(x, layer, cfg):
    dt = cfg.compute_dtype
    h = F.gelu(torch.einsum("bsd,df->bsf", x, layer["w_in"].to(dt)),
               approximate="tanh")                               # jax.nn.gelu
    return torch.einsum("bsf,fd->bsd", h, layer["w_out"].to(dt))


# The flash-vs-gather crossover as LIVE score elements: causal
# self-attention at S=1024 materializes S*S/2 logits. This value is the
# JAX package's calibration on a TPU v5e; it awaits a measurement of the
# crossover on the H100.
_FLASH_SCORE_ELEMS = 1024 * 1024 // 2


def resolve_attn(cfg: TransformerConfig, seq_len: int, device,
                 kv_len=None, causal=True) -> str:
    """Resolve ``attn_impl="auto"`` for one (seq_len, kv_len, device).

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
    if torch.device(device).type != "cuda":
        return "gather"
    if seq_len == 1:
        return "gather"
    score = seq_len * kv
    if causal and kv == seq_len:
        score //= 2  # only the lower triangle is live
    return "flash" if score >= _FLASH_SCORE_ELEMS else "gather"


def apply_block(layer, x, cfg: TransformerConfig, impl=None):
    """One transformer block, ``(layer_params, x) -> x``."""
    if impl is None:
        impl = resolve_attn(cfg, x.shape[1], x.device)
    if impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' needs a sequence-sharded process group, "
            "which this port does not have yet")
    h = _layer_norm(x, layer["ln1"])
    if impl == "flash":
        x = x + _attention_flash(h, layer, cfg)
    else:
        x = x + _attention(h, layer, cfg)
    h = _layer_norm(x, layer["ln2"])
    if cfg.n_experts > 0:
        return x + _moe_ffn(h, layer, cfg)
    return x + _ffn(h, layer, cfg)


def forward(params, tokens, cfg: TransformerConfig, return_hidden=False):
    """tokens [B, S] integer tensor on the params' device -> logits
    [B, S, vocab] (compute dtype), or the final-layernorm hidden states
    [B, S, d] with ``return_hidden=True``. The output projection is tied
    to ``embed``."""
    dt = cfg.compute_dtype
    S = tokens.shape[1]
    x = params["embed"].to(dt)[tokens]
    x = x + params["pos_embed"].to(dt)[:S][None]
    impl = resolve_attn(cfg, S, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:   # the model draws no random numbers: no RNG to replay
            x = checkpoint(apply_block, layer, x, cfg, impl,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = apply_block(layer, x, cfg, impl=impl)
    x = _layer_norm(x, params["final_ln"])
    if return_hidden:
        return x
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(dt))


def _nll(hidden, targets, embed):
    """-log p(target) per position from pre-projection hidden states."""
    logits = torch.einsum("bsd,vd->bsv", hidden, embed.to(hidden.dtype))
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def _nll_sum(hidden, targets, embed):
    return _nll(hidden, targets, embed).sum()


def loss_fn(params, batch, cfg: TransformerConfig):
    """Next-token cross-entropy; differentiable (the training loss).
    batch = {"tokens": [B, S+1]}. With ``cfg.loss_chunk > 0`` the vocab
    projection and log-softmax run one sequence chunk at a time, each
    under ``torch.utils.checkpoint`` (the reference's
    ``lax.scan(jax.checkpoint(body))``), so the backward keeps no chunk's
    ``[B, C, vocab]`` float32 logits; the chunked and full losses are the
    same."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    C = cfg.loss_chunk
    S = targets.shape[1]
    hidden = forward(params, tokens[:, :-1], cfg, return_hidden=True)
    if not C or S <= C:
        return _nll(hidden, targets, params["embed"]).mean()
    if S % C != 0:
        raise ValueError(f"seq len {S} must divide by loss_chunk {C}")
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, C):
        args = (hidden[:, c0:c0 + C], targets[:, c0:c0 + C], params["embed"])
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if grad else _nll_sum(*args))
    return total / (targets.shape[0] * S)
