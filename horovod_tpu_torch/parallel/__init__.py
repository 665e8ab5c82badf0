"""Data parallelism and meshes over ``torch.distributed`` process groups:
the port of ``horovod_tpu/parallel/`` as far as it is done. Ring
attention, Ulysses, tensor, expert and pipeline parallelism come in
later slices (ROADMAP Queue A).
"""

from .data_parallel import (  # noqa: F401
    bucket_plan,
    make_train_step,
    replicate,
    shard_batch,
    tree_flatten_with_path,
    tree_leaves,
)
from .mesh import Mesh, World, create_mesh, mesh_axis_size  # noqa: F401
