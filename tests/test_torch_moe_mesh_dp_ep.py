"""The MoE transformer under a mesh, layout (b): the ``expert`` axis
riding the data axis (``expert_axis="data"``, the reference's dp=ep
reuse), ``{"data": 2}`` and ``{"data": 2, "model": 2}``, where each rank
gathers the experts and runs them on its own tokens and
``make_train_step``/``replicate`` leave alone the leaves that
``shard_params`` marks as cut over ``data``, against the JAX package's
GSPMD-sharded MoE on its CPU mesh. Setup and tolerances:
tests/torch_moe_mesh_parity.py; layout (a) is in test_torch_moe_mesh.py.
"""

import pytest
import torch

torch.set_num_threads(1)

from .torch_moe_mesh_parity import (  # noqa: E402
    check_bfloat16, check_cut_leaves_refuse_a_plain_group, check_float32,
    check_replicate_leaves_expert_shards_alone, check_shard_params)


@pytest.mark.parametrize("layout", ["dp=ep", "dp=ep-model"])
def test_float32_matches_jax_and_one_process(layout):
    """Logits, loss and every gradient leaf against JAX's sharded
    reference; the loss, gradients and updated params of one
    ``make_train_step`` against the port's step in one
    process."""
    check_float32(layout)


def test_bfloat16_matches_jax():
    """``{"data": 2, "model": 2}`` in bf16: the loss and every gradient
    leaf, with the near-tie allowance."""
    check_bfloat16("dp=ep-model")


def test_shard_params_cuts_experts_as_jax_places_them():
    """``(data, None, model)`` and ``(data, model, None)`` over
    ``{"data": 2, "model": 2}``: each rank's block is the one JAX places
    at its coordinates; ``gather_params`` inverts it."""
    check_shard_params("dp=ep-model")


def test_replicate_leaves_expert_shards_alone():
    """``replicate`` over ``data`` gives every rank data rank 0's
    replicated leaves and leaves each rank's experts as they were."""
    check_replicate_leaves_expert_shards_alone()


def test_cut_leaves_refuse_a_plain_group():
    """``shard_params`` marks each leaf with its spec; ``make_train_step``,
    ``replicate``, ``hvd.DistributedOptimizer`` and
    ``hvd.broadcast_parameters`` raise on a cut leaf under a plain
    process group, which names no axis to leave it alone on."""
    check_cut_leaves_refuse_a_plain_group()
