"""Flash attention, forward and backward: the port of
``horovod_tpu/ops/pallas_attention.py``.

Public functions keep the reference's ``[B, S, H, D]`` layout and
signatures, minus ``interpret``. The LSE comes back as ``[B, H, S]``
float32, ``-1e30`` on fully masked rows. Both outputs are
differentiable, the LSE too, as in the reference's ``_flash``
custom_vjp: a call that needs a gradient goes through
:class:`_FlashFn`, whose backward folds the LSE cotangent into
Δ = rowsum(dO∘O) − dLSE, as ``_flash_bwd`` does.

Two implementations of each pass live here:

- the kernels, hand-written for sm_90a: ``csrc/flash_fwd.cu`` (the
  reference's ``_fwd_kernel``; three variants, picked by
  :func:`_fwd_variant`) and ``csrc/flash_bwd.cu`` (its
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), which a tensor on a CUDA
  device always goes to;
- the plain PyTorch versions, :func:`_flash_plain` and
  :func:`_flash_bwd_plain`, float32 loops over blocks, which a tensor on
  the CPU goes to. They are also what the kernels are held against on
  the card.
"""

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
MODES = ("none", "diag", "strict")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k, v, block):
    """Shape check plus the reference's block rule: the largest
    multiple-of-8 divisor of S not above ``block``. Where S has none
    the reference raises; the port keeps ``min(block, S)`` and masks the
    ragged last block instead (both implementations here do)."""
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes must match, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    block = min(int(block), S)
    if S % block != 0 or block % 8 != 0:
        block = next((b for b in range(block - (block % 8 or 8), 7, -8)
                      if S % b == 0), min(block, S))
    return block


def _flash_plain(q, k, v, mode, sm_scale, block):
    """Online softmax over K blocks in float32, as ``_fwd_kernel`` does.
    Returns (o [B,S,H,D] in q's dtype, lse [B,H,S] float32)."""
    B, S, H, D = q.shape
    qf = q.permute(0, 2, 1, 3).float() * sm_scale          # [B,H,S,D]
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    o = torch.empty(B, H, S, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    pos = torch.arange(S, device=q.device)
    for i0 in range(0, S, block):
        qb = qf[:, :, i0:i0 + block]
        bq = qb.shape[2]
        m = torch.full((B, H, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, D), device=q.device)
        k_end = S if mode == "none" else min(i0 + bq, S)   # causal skip
        for j0 in range(0, k_end, block):
            kb, vb = kf[:, :, j0:j0 + block], vf[:, :, j0:j0 + block]
            s = qb @ kb.transpose(-1, -2)
            keep = None
            if mode != "none":
                qpos = pos[i0:i0 + bq, None]
                kpos = pos[None, j0:j0 + kb.shape[2]]
                keep = qpos > kpos if mode == "strict" else qpos >= kpos
                s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if keep is not None:
                # explicit zero: the -1e30 sentinel is finite, so a fully
                # masked row would otherwise get exp(0) = 1 everywhere.
                p = torch.where(keep, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        l_safe = torch.where(l > 0, l, 1.0)
        o[:, :, i0:i0 + bq] = acc / l_safe
        lse[:, :, i0:i0 + bq] = torch.where(
            l > 0, m + torch.log(l_safe), NEG_INF)[..., 0]
    return o.to(q.dtype).permute(0, 2, 1, 3), lse


def _flash_bwd_plain(q, k, v, o, lse, do, delta, mode, sm_scale, block):
    """The FA2 backward in float32 over blocks, as ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` compute it: P = exp(S - LSE), zeroed explicitly
    outside the mask; dP = dO V^T; dS = P (dP - Δ); dQ = sm_scale ΣdS K;
    dK = ΣdS^T (Q sm_scale); dV = ΣP^T dO. ``delta`` is Δ = rowsum(dO O)
    - dLSE, ``[B, H, S]`` float32 (``o`` only enters through it).
    Returns (dq, dk, dv), ``[B, S, H, D]`` in q's, k's and v's dtypes."""
    B, S, H, D = q.shape
    qf = q.permute(0, 2, 1, 3).float() * sm_scale          # [B,H,S,D]
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    dof = do.permute(0, 2, 1, 3).float()
    dq, dk, dv = (torch.zeros(B, H, S, D, device=q.device) for _ in range(3))
    pos = torch.arange(S, device=q.device)
    for i0 in range(0, S, block):
        qb, dob = qf[:, :, i0:i0 + block], dof[:, :, i0:i0 + block]
        bq = qb.shape[2]
        lse_b = lse[:, :, i0:i0 + bq, None]
        delta_b = delta[:, :, i0:i0 + bq, None]
        k_end = S if mode == "none" else min(i0 + bq, S)   # causal skip
        for j0 in range(0, k_end, block):
            kb, vb = kf[:, :, j0:j0 + block], vf[:, :, j0:j0 + block]
            p = torch.exp(qb @ kb.transpose(-1, -2) - lse_b)
            if mode != "none":
                # select, not multiply: a fully masked row has LSE = -1e30,
                # so exp(S - LSE) is +inf there and inf * 0 would be NaN.
                qpos = pos[i0:i0 + bq, None]
                kpos = pos[None, j0:j0 + kb.shape[2]]
                keep = qpos > kpos if mode == "strict" else qpos >= kpos
                p = torch.where(keep, p, 0.0)
            ds = p * (dob @ vb.transpose(-1, -2) - delta_b)
            dq[:, :, i0:i0 + bq] += ds @ kb
            dk[:, :, j0:j0 + block] += ds.transpose(-1, -2) @ qb
            dv[:, :, j0:j0 + block] += p.transpose(-1, -2) @ dob
    return ((dq * sm_scale).to(q.dtype).permute(0, 2, 1, 3),
            dk.to(k.dtype).permute(0, 2, 1, 3),
            dv.to(v.dtype).permute(0, 2, 1, 3))


def _route(q, k, v):
    """Where a call goes: ``(impl, grad)`` with impl 'plain' for CPU
    tensors and 'kernel' for CUDA tensors (it raises for mixed or other
    devices), and grad True when autograd needs the backward, in which
    case the call runs through :class:`_FlashFn` with the same impl."""
    devs = {t.device.type for t in (q, k, v)}
    if devs == {"cpu"}:
        impl = "plain"
    elif devs == {"cuda"}:
        impl = "kernel"
    else:
        raise ValueError(f"q/k/v must all be on the CPU or all on CUDA, "
                         f"got {sorted(devs)}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return impl, grad


def _forward(impl, q, k, v, mode, sm_scale, block):
    if impl == "plain":
        return _flash_plain(q, k, v, mode, sm_scale, block)
    return flash_fwd_cuda(q, k, v, mode, sm_scale)


class _FlashFn(torch.autograd.Function):
    """``(q, k, v) -> (o, lse)``, both outputs differentiable, as the
    reference's ``_flash`` custom_vjp. Forward: B1 or the plain forward.
    Backward: Δ = rowsum(dO∘O) − dLSE in float32, then B2 and B3 or the
    plain backward. Which of the two is decided by the tensors' device,
    as everywhere in this module."""

    @staticmethod
    def forward(ctx, q, k, v, impl, mode, sm_scale, block):
        o, lse = _forward(impl, q, k, v, mode, sm_scale, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (impl, mode, sm_scale, block)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        impl, mode, sm_scale, block = ctx.args
        # Autograd hands an unused output's cotangent in as zeros.
        delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,S]
                 - dlse.float()).contiguous()
        if impl == "plain":
            dq, dk, dv = _flash_bwd_plain(q, k, v, o, lse, do, delta, mode,
                                          sm_scale, block)
        else:
            dq, dk, dv = flash_bwd_cuda(q, k, v, do, lse, delta, mode,
                                        sm_scale)
        return dq, dk, dv, None, None, None, None


def _check_args(name, q, k, v):
    """The checks every kernel wrapper makes before a launch."""
    dev = q.device
    if any(t.device != dev for t in (k, v)):
        raise ValueError("q/k/v must be on one CUDA device")
    if q.dtype not in _DTYPE_ID or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if not 0 < q.shape[-1] <= 128:
        raise ValueError(f"{name} takes head dim 1..128, got {q.shape[-1]}")


def _bhs(*tensors):
    """Element strides of the B, S and H dims of each [B, S, H, D]."""
    return [c for t in tensors for c in (t.stride(0), t.stride(1),
                                         t.stride(2))]


def _check_launch(lib, fn, err, dev):
    if err != 0:
        raise RuntimeError(f"{fn} launch failed on {dev}: "
                           + lib.hvd_cuda_error_string(err).decode())


# B1's kernels in csrc/flash_fwd.cu, by the id its C interface takes:
# "fma" float32 on CUDA cores, "mma" bf16 through mma.sync (the PR 3
# kernel), "tma" bf16 through TMA, mbarriers and wgmma.
_FWD_VARIANTS = {"fma": 0, "mma": 1, "tma": 2}


def _tma_ready(t):
    """A bf16 ``[B, S, H, D]`` tensor that a TMA map takes as it lies:
    every [B, S, H] row start on a 16-byte boundary (the pointer and the
    B, S and H strides) and positive B, S and H strides (an expanded
    zero has stride 0, which no map takes)."""
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) % 8 == 0 and t.stride(i) > 0
                    for i in range(3)))


def _fwd_takes(variant, q, k, v):
    """Whether B1's ``variant`` takes q, k, v (one dtype, D <= 128, unit
    last stride, as :func:`flash_fwd_cuda` has checked)."""
    if variant == "fma":
        return q.dtype == torch.float32
    if variant == "mma":
        return q.dtype == torch.bfloat16
    return (variant == "tma" and q.dtype == torch.bfloat16
            and q.shape[-1] % 8 == 0
            and all(_tma_ready(t) for t in (q, k, v)))


def _fwd_variant(q, k, v):
    """The B1 kernel a call takes, from dtype, shape, strides and
    pointers alone: "tma" for bf16 with D % 8 == 0 and q, k and v
    :func:`_tma_ready` (every call of the serving and training paths),
    "mma" for any other bf16 (an expanded K/V among them), "fma" for
    float32."""
    if q.dtype == torch.float32:
        return "fma"
    return "tma" if _fwd_takes("tma", q, k, v) else "mma"


def flash_fwd_cuda(q, k, v, mode, sm_scale, variant=None):
    """Launch ``csrc/flash_fwd.cu`` on the current stream. q, k, v:
    ``[B, S, H, D]`` CUDA tensors (bf16 or f32, D <= 128). ``variant``
    names the kernel (:data:`_FWD_VARIANTS`); by default
    :func:`_fwd_variant` picks it, and a named one that does not take the
    arguments raises before any launch. Returns (o [B,S,H,D],
    lse [B,H,S] float32). Counts each launch in
    ``flash_fwd_cuda.launches`` and, by variant, in
    ``flash_fwd_cuda.variant_launches``."""
    _check_args("flash_fwd", q, k, v)
    B, S, H, D = q.shape
    dev = q.device
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if variant is None:
        variant = _fwd_variant(q, k, v)
    elif variant not in _FWD_VARIANTS or not _fwd_takes(variant, q, k, v):
        raise ValueError(f"flash_fwd variant {variant!r} does not take "
                         f"{q.dtype} q/k/v of shape {tuple(q.shape)}, "
                         f"strides {q.stride()} {k.stride()} {v.stride()}")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = _lib("flash_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(),
                                _FWD_VARIANTS[variant], B, S, H, D,
                                *_bhs(q, k, v), float(sm_scale),
                                _MODE_ID[mode], stream)
    _check_launch(lib, "flash_fwd", err, dev)
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.variant_launches[variant] += 1
    flash_fwd_cuda.mode_launches[mode] += 1
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.variant_launches = dict.fromkeys(_FWD_VARIANTS, 0)
flash_fwd_cuda.mode_launches = dict.fromkeys(MODES, 0)


# B2's and B3's kernels in csrc/flash_bwd.cu take B1's variant ids.
_BWD_VARIANTS = _FWD_VARIANTS


def _bwd_takes(variant, q, k, v, do):
    """Whether B2's and B3's ``variant`` takes q, k, v, dO (as
    :func:`_bwd_args` has made them): B1's rule for q, k, v, and for
    "tma" dO :func:`_tma_ready` too."""
    return _fwd_takes(variant, q, k, v) and (
        variant != "tma" or _tma_ready(do))


def _bwd_variant(q, k, v, do):
    """The B2 and B3 kernels a call takes, from dtype, shape, strides and
    pointers alone: "tma" for bf16 with D % 8 == 0 and q, k, v and dO
    :func:`_tma_ready` (every call of the training paths), "mma" for any
    other bf16, "fma" for float32."""
    if q.dtype == torch.float32:
        return "fma"
    return "tma" if _bwd_takes("tma", q, k, v, do) else "mma"


def _bwd_args(q, k, v, do, lse, delta):
    """Checked kernel arguments of the backward: q, k, v, dO with unit
    last stride (other strides are passed through), LSE and Δ as
    contiguous ``[B, H, S]`` float32."""
    _check_args("flash_bwd", q, k, v)
    B, S, H, D = q.shape
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"dO must be {tuple(q.shape)} on {q.device}, got "
                         f"{tuple(do.shape)} on {do.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be [B, H, S] float32 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    # dO often comes from autograd non-contiguous (an einsum's backward,
    # an expanded zero): strides are passed, only a D stride != 1 copies.
    q, k, v, do = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v, do.to(q.dtype)))
    # Where q, k and v would take the TMA kernels and dO alone would not
    # (stride 0, a row off 16 bytes), dO is copied so that they do.
    if _fwd_takes("tma", q, k, v) and not _tma_ready(do):
        do = do.clone(memory_format=torch.contiguous_format)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def _pick_variant(name, variant, takes, pick, *ts):
    """``variant``, or ``pick(*ts)`` when it is None; a named variant that
    ``takes`` refuses for the tensors raises here, before anything is
    built or launched."""
    if variant is None:
        return pick(*ts)
    if not takes(variant, *ts):
        raise ValueError(
            f"{name} variant {variant!r} does not take {ts[0].dtype} "
            f"tensors of shape {tuple(ts[0].shape)}, strides "
            + " ".join(str(t.stride()) for t in ts))
    return variant


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, mode, sm_scale,
                      variant=None):
    """Launch B2 (``csrc/flash_bwd.cu`` ``hvd_flash_bwd_dq``) on the
    current stream: dQ ``[B, S, H, D]`` in q's dtype. ``variant`` names
    the kernel (:data:`_BWD_VARIANTS`); by default :func:`_bwd_variant`
    picks it. Counts each launch in ``flash_bwd_dq_cuda.launches`` and,
    by variant and by mask mode, in ``flash_bwd_dq_cuda.variant_launches``
    and ``.mode_launches``."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    variant = _pick_variant("flash_bwd_dq", variant, _bwd_takes,
                            _bwd_variant, q, k, v, do)
    B, S, H, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _lib("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _BWD_VARIANTS[variant], B, S, H, D, *_bhs(q, k, v, do),
            float(sm_scale), _MODE_ID[mode], stream)
    _check_launch(lib, "flash_bwd_dq", err, q.device)
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.variant_launches[variant] += 1
    flash_bwd_dq_cuda.mode_launches[mode] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mode, sm_scale,
                       variant=None):
    """Launch B3 (``csrc/flash_bwd.cu`` ``hvd_flash_bwd_dkv``) on the
    current stream: (dK, dV) ``[B, S, H, D]`` in k's and v's dtype.
    ``variant`` as in :func:`flash_bwd_dq_cuda`. Counts each launch in
    ``flash_bwd_dkv_cuda.launches`` and, by variant and by mask mode, in
    ``flash_bwd_dkv_cuda.variant_launches`` and ``.mode_launches``."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    variant = _pick_variant("flash_bwd_dkv", variant, _bwd_takes,
                            _bwd_variant, q, k, v, do)
    B, S, H, D = q.shape
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    lib = _lib("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _BWD_VARIANTS[variant], B, S, H, D, *_bhs(q, k, v, do),
            float(sm_scale), _MODE_ID[mode], stream)
    _check_launch(lib, "flash_bwd_dkv", err, q.device)
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.variant_launches[variant] += 1
    flash_bwd_dkv_cuda.mode_launches[mode] += 1
    return dk, dv


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.variant_launches = dict.fromkeys(_BWD_VARIANTS, 0)
flash_bwd_dq_cuda.mode_launches = dict.fromkeys(MODES, 0)
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.variant_launches = dict.fromkeys(_BWD_VARIANTS, 0)
flash_bwd_dkv_cuda.mode_launches = dict.fromkeys(MODES, 0)


def flash_bwd_cuda(q, k, v, do, lse, delta, mode, sm_scale):
    """B2 then B3 on the current stream: (dq, dk, dv)."""
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, mode, sm_scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mode, sm_scale)
    return dq, dk, dv


# ctypes signatures: pointers, then ints (the variant; B, S, H, D), the
# B/S/H strides of each [B, S, H, D] input, sm_scale, mode, stream.
_SIGNATURES = {
    "flash_fwd": {"hvd_flash_fwd": (5, 3)},
    "flash_bwd": {"hvd_flash_bwd_dq": (7, 4), "hvd_flash_bwd_dkv": (8, 4)},
}


def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_hvd_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, (n_ptr, n_strided) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = ([p] * n_ptr + [i] * 5
                                         + [ll] * (3 * n_strided)
                                         + [ctypes.c_float, i, p])
            getattr(lib, fn).restype = i
        lib.hvd_cuda_error_string.argtypes = [i]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        lib._hvd_typed = True
    return lib


def flash_attention_lse(q, k, v, *, mode="diag", sm_scale=None, block=256):
    """Like :func:`flash_attention` but also returns the per-row
    log-sum-exp ``[B, H, S]`` (float32, ``-1e30`` on fully masked rows).
    mode: "diag" (causal, q >= k), "strict" (q > k), "none" (full)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode!r}")
    block = _validate(q, k, v, block)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    impl, grad = _route(q, k, v)
    if grad:
        return _FlashFn.apply(q, k, v, impl, mode, float(sm_scale), block)
    return _forward(impl, q, k, v, mode, float(sm_scale), block)


def flash_attention(q, k, v, *, causal=True, sm_scale=None, block=256):
    """Fused multi-head attention. q, k, v: ``[B, S, H, D]``. Returns
    ``[B, S, H, D]`` in the input dtype; softmax and accumulation run in
    float32. ``block`` sizes the plain version's blocks; the kernel tiles
    by 64 whatever it is."""
    o, _ = flash_attention_lse(q, k, v, mode="diag" if causal else "none",
                               sm_scale=sm_scale, block=block)
    return o
