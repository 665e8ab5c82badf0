"""Data, tensor, sequence and expert parallelism and meshes over
``torch.distributed`` process groups: the port of
``horovod_tpu/parallel/`` as far as it is done. Pipeline parallelism
comes in a later slice (ROADMAP Queue A).
"""

from .data_parallel import (  # noqa: F401
    bucket_plan,
    make_train_step,
    replicate,
    shard_batch,
    tree_flatten_with_path,
    tree_leaves,
)
from .expert_parallel import (  # noqa: F401
    env_capacity_factor,
    make_moe_layer,
    moe_dispatch_combine,
    moe_dispatch_combine_ragged,
    report_dispatch,
)
from .mesh import Mesh, World, create_mesh, mesh_axis_size  # noqa: F401
from .ring_attention import (  # noqa: F401
    make_ring_attention,
    ring_attention,
    stripe_sequence,
    unstripe_sequence,
)
from .sharding import (  # noqa: F401
    all_to_all,
    copy_to,
    gather,
    gather_replicated,
    ragged_all_to_all,
    reduce_from,
    ring_blocks,
)
from .ulysses import (  # noqa: F401
    heads_to_seq,
    make_ulysses_attention,
    seq_to_heads,
    ulysses_attention,
)
