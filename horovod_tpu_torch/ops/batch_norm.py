"""BatchNorm's paired reduction and the training-mode batch norm built on
it: the port of ``horovod_tpu/ops/pallas_norm.py``.

:func:`paired_reduce` returns ``(Σ_r a[r,c], Σ_r a[r,c]·b[r,c])`` per
channel over all leading dims of ``[..., C]``, accumulated and returned
in float32. :func:`batch_norm_train` calls it twice, as the reference's
``custom_vjp`` does: as ``(x, x)`` in the forward (mean and variance)
and as ``(dy, x)`` in the backward (Σdy and Σdy·x). Its elementwise legs
(the affine apply, dx) stay torch ops, as the reference leaves them to
XLA.

Two implementations of the reduction live here:

- the kernel, hand-written for sm_90a: ``csrc/paired_reduce.cu`` (the
  reference's ``_paired_kernel``), which a tensor on a CUDA device always
  goes to (:func:`paired_reduce_cuda`);
- the plain PyTorch version, :func:`paired_reduce_plain`, which a tensor
  on the CPU goes to, and which the kernel is held against on the card.
"""

import ctypes
import functools

import torch

from .. import _build

_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 2     # partial-sum blocks the kernel launches per SM


def paired_reduce_plain(a, b):
    """``(Σ a, Σ a·b)`` over all leading dims, in float32."""
    C = a.shape[-1]
    a2 = a.reshape(-1, C).float()
    b2 = b.reshape(-1, C).float()
    return a2.sum(0), (a2 * b2).sum(0)


def _rows(t):
    """``t [..., C]`` as a row-major ``[R, C]`` view, or one copy of it
    where no such view exists (counted in ``paired_reduce_cuda.copies``).
    For ``[N, H, W, C]`` the copy is NHWC memory: the channels-last
    layout of the NCHW tensor it views."""
    if not t.is_contiguous():
        paired_reduce_cuda.copies += 1
        t = t.contiguous()
    return t.view(-1, t.shape[-1])


def paired_reduce_cuda(a, b):
    """Launch ``csrc/paired_reduce.cu`` on the current stream. a, b: CUDA
    tensors of one shape ``[..., C]`` and one dtype (bf16 or f32), any
    strides (a tensor that is not row-major ``[R, C]`` is copied once,
    counted in ``paired_reduce_cuda.copies``). ``a is b`` reads the
    tensor once. Returns (s, p), float32 ``[C]``. Counts each launch in
    ``paired_reduce_cuda.launches``."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"paired_reduce_cuda takes two tensors on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPE_ID or b.dtype != a.dtype:
        raise TypeError(f"paired_reduce takes float32 or bfloat16 a and b "
                        f"of one dtype, got {a.dtype} {b.dtype}")
    if a.shape != b.shape or a.dim() == 0 or a.numel() == 0:
        raise ValueError(f"paired_reduce takes a and b of one non-empty "
                         f"shape [..., C], got {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    same = a is b
    a2 = _rows(a)
    b2 = a2 if same else _rows(b)
    R, C = a2.shape
    dev = a.device
    max_parts = _BLOCKS_PER_SM * _sm_count(dev)
    # One allocation: s, p, then the kernel's partial sums.
    out = torch.empty((max_parts + 1, 2, C), dtype=torch.float32, device=dev)
    s, p = out[0]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hvd_paired_reduce(a2.data_ptr(), b2.data_ptr(),
                                    out[1:].data_ptr(), s.data_ptr(),
                                    p.data_ptr(), _DTYPE_ID[a.dtype], R, C,
                                    max_parts, stream)
    if err != 0:
        raise RuntimeError(f"paired_reduce launch failed on {dev}: "
                           + lib.hvd_cuda_error_string(err).decode())
    paired_reduce_cuda.launches += 1
    return s, p


paired_reduce_cuda.launches = 0
paired_reduce_cuda.copies = 0


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lib():
    lib = _build.load("paired_reduce")
    if not getattr(lib, "_hvd_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hvd_paired_reduce.argtypes = [p] * 5 + [i, ll, i, i, p]
        lib.hvd_paired_reduce.restype = i
        lib.hvd_cuda_error_string.argtypes = [i]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        lib._hvd_typed = True
    return lib


def paired_reduce(a, b):
    """``(Σ_r a[r,c], Σ_r a[r,c]·b[r,c])`` over all leading dims of
    ``[..., C]``, float32 ``[C]`` each, with float32 accumulation for
    bf16 or f32 input. CPU tensors take the plain version; CUDA tensors
    the kernel."""
    devs = {a.device.type, b.device.type}
    if devs == {"cpu"}:
        return paired_reduce_plain(a, b)
    if devs == {"cuda"}:
        return paired_reduce_cuda(a, b)
    raise ValueError(f"a and b must both be on the CPU or both on CUDA, "
                     f"got {sorted(devs)}")


class _BatchNormTrain(torch.autograd.Function):
    """``(x, gamma, beta) -> (y, mean, var)`` with the reference's
    rounding points (``_bn_fwd_impl``, ``_bn_bwd``). The cotangents of
    mean and var are ignored: the running-average update must not
    backprop, as in the reference and in flax's BatchNorm."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        R = x.numel() // x.shape[-1]
        s, q = paired_reduce(x, x)
        mean = s / R
        var = torch.clamp_min(q / R - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a = (gamma * inv).to(x.dtype)
        b = (beta - gamma * inv * mean).to(x.dtype)
        y = x * a + b
        ctx.save_for_backward(x, gamma, mean, inv)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        R = x.numel() // x.shape[-1]
        sdy, sdyx = paired_reduce(dy.to(x.dtype), x)
        # Σ dy·x̂ with x̂ = (x - mean)·inv
        sdyxh = inv * (sdyx - mean * sdy)
        c1 = (gamma * inv).to(x.dtype)
        m_dy = sdy / R
        m_dyxh = sdyxh / R
        xhat = (x.float() - mean) * inv
        dx = c1 * (dy.float() - m_dy - xhat * m_dyxh).to(x.dtype)
        return dx, sdyxh, sdy, None


def batch_norm_train(x, gamma, beta, eps):
    """Training-mode batch norm over all leading dims of ``x [..., C]``.
    Returns ``(y, mean, var)``: y in x's dtype, mean and var the float32
    batch statistics (biased var) for the caller's running averages.
    gamma, beta: float32 ``[C]``."""
    return _BatchNormTrain.apply(x, gamma, beta, float(eps))
