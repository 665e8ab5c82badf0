"""Data parallelism over ``torch.distributed`` process groups: the port of
``horovod_tpu/parallel/`` as far as the single-card training path needs
it. The mesh layer (``create_mesh``), ring attention, Ulysses, expert
and pipeline parallelism come in later slices (ROADMAP Queue A).
"""

from .data_parallel import (  # noqa: F401
    bucket_plan,
    make_train_step,
    replicate,
    shard_batch,
    tree_flatten_with_path,
    tree_leaves,
)
