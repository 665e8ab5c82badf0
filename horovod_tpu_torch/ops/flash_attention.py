"""Flash attention forward: the port of ``horovod_tpu/ops/pallas_attention.py``.

Public functions keep the reference's ``[B, S, H, D]`` layout and
signatures, minus ``interpret``. The LSE comes back as ``[B, H, S]``
float32, ``-1e30`` on fully masked rows.

Two implementations of one function live here:

- the kernel, ``csrc/flash_fwd.cu`` (hand-written for sm_90a), which a
  tensor on a CUDA device always goes to;
- the plain PyTorch version, :func:`_flash_plain`, an online-softmax loop
  over K blocks in float32, which a tensor on the CPU goes to. It is also
  what the kernel is held against on the card.

This slice ports the forward only. A CUDA call that would need a gradient
raises ``NotImplementedError``: the backward kernels (the reference's
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) come with the training slice.
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


def _route(q, k, v):
    """'plain' for CPU tensors, 'kernel' for CUDA tensors; raises for a
    CUDA call that needs a gradient (no backward kernel in this slice)
    and for any other device."""
    devs = {t.device.type for t in (q, k, v)}
    if devs == {"cpu"}:
        return "plain"
    if devs != {"cuda"}:
        raise ValueError(f"q/k/v must all be on the CPU or all on CUDA, "
                         f"got {sorted(devs)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only in this slice: the "
            "backward kernels (dQ and dK/dV) come with the training slice; "
            "call it under torch.no_grad() or on tensors that need no grad")
    return "kernel"


def flash_fwd_cuda(q, k, v, mode, sm_scale):
    """Launch ``csrc/flash_fwd.cu`` on the current stream. q, k, v:
    ``[B, S, H, D]`` CUDA tensors (bf16 or f32, D <= 128, last stride 1).
    Returns (o [B,S,H,D], lse [B,H,S] float32). Counts each launch in
    ``flash_fwd_cuda.launches``."""
    B, S, H, D = q.shape
    dev = q.device
    if any(t.device != dev for t in (k, v)):
        raise ValueError("q/k/v must be on one CUDA device")
    if q.dtype not in _DTYPE_ID or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if not 0 < D <= 128:
        raise ValueError(f"flash_fwd takes head dim 1..128, got {D}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = _lib()
    strides = [c for t in (q, k, v) for c in (t.stride(0), t.stride(1),
                                              t.stride(2))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(),
                                _DTYPE_ID[q.dtype], B, S, H, D, *strides,
                                float(sm_scale), _MODE_ID[mode], stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.hvd_cuda_error_string(err).decode())
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _lib():
    lib = _build.load("flash_fwd")
    if not getattr(lib, "_hvd_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hvd_flash_fwd.argtypes = ([p] * 5 + [i] * 5 + [ll] * 9
                                      + [ctypes.c_float, i, p])
        lib.hvd_flash_fwd.restype = i
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
    if _route(q, k, v) == "plain":
        return _flash_plain(q, k, v, mode, float(sm_scale), block)
    return flash_fwd_cuda(q, k, v, mode, sm_scale)


def flash_attention(q, k, v, *, causal=True, sm_scale=None, block=256):
    """Fused multi-head attention. q, k, v: ``[B, S, H, D]``. Returns
    ``[B, S, H, D]`` in the input dtype; softmax and accumulation run in
    float32. ``block`` sizes the plain version's blocks; the kernel tiles
    by 64 whatever it is."""
    o, _ = flash_attention_lse(q, k, v, mode="diag" if causal else "none",
                               sm_scale=sm_scale, block=block)
    return o
