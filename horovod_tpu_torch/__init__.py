"""PyTorch/CUDA port of :mod:`horovod_tpu` for NVIDIA Hopper (H100).

Module names mirror the JAX package, so ``horovod_tpu_torch/x/y.py`` is
the counterpart of ``horovod_tpu/x/y.py``. The port imports ``torch``
and never JAX, nor anything of the JAX package; where it needs one of
that package's framework-neutral modules it keeps its own copy.

What is ported so far is inference and single-card training at full
width:

- :mod:`.models.transformer` — config, params, ``forward`` (gather and
  flash attention) and the differentiable ``loss_fn`` (``remat``,
  chunked loss);
- :mod:`.ops.flash_attention` — flash attention forward and backward,
  hand-written sm_90a CUDA kernels (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``) with their plain PyTorch versions beside them;
- :mod:`.parallel` — ``make_train_step`` (gradients and loss averaged
  over a ``torch.distributed`` group, accumulation, buckets, wire-cast
  compression), ``shard_batch`` and ``replicate``;
- :mod:`.compression` — the fp16/bf16 compressors and wire-cast counters;
- :mod:`.serving` — paged KV cache, kernel-free engine, scheduler and
  :class:`~.serving.loop.ServeLoop`.

Entry points take an explicit ``device``; ``None`` means the CUDA card
and raises when there is none (see :mod:`.device`).
"""

from .device import resolve_device  # noqa: F401
