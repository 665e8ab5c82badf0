"""Launcher package: the port's own copy of ``horovod_tpu/runner/``
(reference: horovod/runner/), which the port does not import.

Import submodules directly (``horovod_tpu_torch.runner.local``,
``horovod_tpu_torch.runner.launch``) — kept lazy here so ``python -m
horovod_tpu_torch.runner.launch`` does not re-execute an already-imported
module.
"""
