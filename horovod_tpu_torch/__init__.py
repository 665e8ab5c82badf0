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
- :mod:`.models.resnet` — ResNet-50/101 v1.5 (classic and s2d stems;
  flax, kernel and bf16-stats BatchNorms), ``create_train_state`` and
  ``make_loss_fn`` for ``make_train_step``; :mod:`.models.convert` loads
  JAX params and flax ResNet variables;
- :mod:`.ops.flash_attention` — flash attention forward and backward,
  hand-written sm_90a CUDA kernels (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``) with their plain PyTorch versions beside them;
- :mod:`.ops.batch_norm` — BatchNorm's paired reduction, a hand-written
  sm_90a CUDA kernel (``csrc/paired_reduce.cu``) with its plain version,
  and the training-mode ``batch_norm_train`` built on it;
- :mod:`.parallel` — ``make_train_step`` (gradients and loss averaged
  over a ``torch.distributed`` group, accumulation, buckets, wire-cast
  compression), ``shard_batch`` and ``replicate``;
- :mod:`.compression` — the fp16/bf16 compressors and wire-cast counters;
- :mod:`.serving` — paged KV cache, kernel-free engine, scheduler and
  :class:`~.serving.loop.ServeLoop`;
- :mod:`.graft_entry` — ``entry()``, the ResNet-50 eval forward.

Entry points take an explicit ``device``; ``None`` means the CUDA card
and raises when there is none (see :mod:`.device`).
"""

from .device import resolve_device  # noqa: F401
