"""Gradient compression for the port: its own copy of what the train step
needs from ``horovod_tpu/compression.py`` (which it does not import).

``Compression.fp16`` and ``Compression.bf16`` cast float32/float64
tensors to a 16-bit dtype for the all-reduce and back after, halving
wire bytes; bf16 keeps float32's exponent range, so it cannot overflow
the way fp16 can. The codecs here act on torch tensors. The int8 and
top-k codecs belong to the core's host plane and come with it.

``make_train_step`` consults :func:`wire_cast_dtype` once when it is
built and counts the decision with :func:`record_wire_cast`, so
:func:`stats` shows whether a ``compression=`` argument did anything.
"""

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def _cast(tensor, dtype):
    if tensor.dtype in (torch.float32, torch.float64):
        return tensor.to(dtype), tensor.dtype
    return tensor, None


class FP16Compressor(Compressor):
    @staticmethod
    def compress(tensor):
        return _cast(tensor, torch.float16)

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BF16Compressor(Compressor):
    """bfloat16 keeps float32's exponent range, so gradient compression
    cannot overflow the way fp16 can."""

    @staticmethod
    def compress(tensor):
        return _cast(tensor, torch.bfloat16)

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor


# Wire-cast engagement counters: every fast path that consults
# wire_cast_dtype reports whether the cast engaged (`engaged`) or fell
# back to no cast (`fallback`), so the `compression=` argument is
# measurably live rather than silently ignored. Process-global, as in
# the reference; read via stats().
_wire_cast_engaged = 0
_wire_cast_fallback = 0


def record_wire_cast(engaged):
    """Count one wire-cast routing decision (True = the bucketed path
    casts the payload to the compressor's wire dtype; False = counted
    fallback: custom compressor, or a path without the cast hook)."""
    global _wire_cast_engaged, _wire_cast_fallback
    if engaged:
        _wire_cast_engaged += 1
    else:
        _wire_cast_fallback += 1


def stats():
    """{"engaged": n, "fallback": n} wire-cast routing decisions since
    process start."""
    return {"engaged": _wire_cast_engaged, "fallback": _wire_cast_fallback}


def wire_cast_dtype(compression):
    """The wire dtype name implementing `compression` as a bare cast on a
    fast path ("float16" / "bfloat16"), None for no compression, or
    ``...`` when the compressor has no cast equivalent (custom
    compressors). Exact-class match only: a SUBCLASS may override
    compress/decompress logic a bare cast would silently skip."""
    if compression is None:
        return None
    cls = compression if isinstance(compression, type) else type(compression)
    if cls is FP16Compressor:
        return "float16"
    if cls is BF16Compressor:
        return "bfloat16"
    if cls is NoneCompressor:
        return None
    return ...
