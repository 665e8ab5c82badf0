"""PyTorch/CUDA port of :mod:`horovod_tpu` for NVIDIA Hopper (H100).

Module names mirror the JAX package, so ``horovod_tpu_torch/x/y.py`` is
the counterpart of ``horovod_tpu/x/y.py``. The port imports ``torch``
and never JAX, nor anything of the JAX package; where it needs one of
that package's framework-neutral modules it keeps its own copy.

What is ported so far is inference at full width:

- :mod:`.models.transformer` — config, params, ``forward`` (gather and
  flash attention) and the forward-only ``loss_fn``;
- :mod:`.ops.flash_attention` — the flash-attention forward, a
  hand-written sm_90a CUDA kernel (``csrc/flash_fwd.cu``) with its plain
  PyTorch version beside it;
- :mod:`.serving` — paged KV cache, kernel-free engine, scheduler and
  :class:`~.serving.loop.ServeLoop`.

Entry points take an explicit ``device``; ``None`` means the CUDA card
and raises when there is none (see :mod:`.device`).
"""

from .device import resolve_device  # noqa: F401
