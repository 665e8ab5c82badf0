"""PyTorch/CUDA port of :mod:`horovod_tpu` for NVIDIA Hopper (H100).

Module names mirror the JAX package, so ``horovod_tpu_torch/x/y.py`` is
the counterpart of ``horovod_tpu/x/y.py``. The port imports ``torch``
and never JAX, nor anything of the JAX package; where it needs one of
that package's framework-neutral modules it keeps its own copy.

What is ported so far is inference, training at full width, and the
Horovod API over process groups:

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
- :mod:`.hvd` — the Horovod API (``init``, ``DistributedOptimizer``,
  ``broadcast_parameters``, ``broadcast_optimizer_state``, the
  collectives, process sets) over :mod:`.distributed` (the job's world
  from the launcher's environment: NCCL on the card, gloo on the CPU),
  :mod:`.process_sets` and :mod:`.ops.torch_ops` (the collectives on
  torch tensors, in-mesh and Horovod);
- :mod:`.parallel` — ``create_mesh`` (named axes over the ranks, one
  process group per axis slice), ``make_train_step`` (gradients and
  loss averaged over a group or a mesh's data axes, Adasum,
  ``extra_reduce``, accumulation, buckets, wire-cast compression),
  ``shard_batch`` and ``replicate``;
- :mod:`.checkpoint` — the sharded checkpoint in the JAX package's
  ``hvd-sharded-v1`` format: per-rank shards, the two-barrier commit,
  async snapshots, restore with reshard;
- :mod:`.compression` — the fp16/bf16 compressors and wire-cast counters;
- :mod:`.serving` — paged KV cache, kernel-free engine, scheduler and
  :class:`~.serving.loop.ServeLoop`;
- :mod:`.graft_entry` — ``entry()``, the ResNet-50 eval forward.

Entry points take an explicit ``device``; ``None`` means the CUDA card
and raises when there is none (see :mod:`.device`).

Importing the package imports no torch (``resolve_device`` loads
:mod:`.device` at first use), so the launcher, ``python -m
horovod_tpu_torch.runner.launch``, spawns its workers without paying for
torch's import first.
"""


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
