"""Data, tensor, sequence, expert and pipeline parallelism and meshes
over ``torch.distributed`` process groups: the port of
``horovod_tpu/parallel/``.
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
from .pipeline import (  # noqa: F401
    make_pipeline_train_step,
    make_pipeline_value_and_grad,
    pipeline_apply,
    shard_stage_params,
)
from .ring_attention import (  # noqa: F401
    make_ring_attention,
    ring_attention,
    stripe_sequence,
    unstripe_sequence,
)
from .schedules import (  # noqa: F401
    resolve_schedule,
    schedule_info,
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
