"""The MoE transformer under a mesh, layout (a): the ``expert`` axis an
axis of its own, ``{"data": 2, "expert": 2}`` and ``{"expert": 2,
"model": 2}``, where each rank runs its experts on the tokens it shares
with the axis, against the JAX package's GSPMD-sharded MoE on its CPU
mesh. Setup and tolerances: tests/torch_moe_mesh_parity.py; layout (b)
is in test_torch_moe_mesh_dp_ep.py.
"""

import pytest
import torch

torch.set_num_threads(1)

from .torch_moe_mesh_parity import (  # noqa: E402
    check_bfloat16, check_float32, check_shard_params)


@pytest.mark.parametrize("layout", ["data-expert", "expert-model"])
def test_float32_matches_jax_and_one_process(layout):
    """Logits, loss and every gradient leaf against JAX's sharded
    reference; the loss, gradients and updated params of one
    ``make_train_step`` against the port's step in one process."""
    check_float32(layout)


def test_bfloat16_matches_jax():
    """``{"expert": 2, "model": 2}`` in bf16: the loss and every gradient
    leaf, with the near-tie allowance."""
    check_bfloat16("expert-model")


def test_shard_params_cuts_experts_as_jax_places_them():
    """``(expert, None, model)`` and ``(expert, model, None)`` over
    ``{"expert": 2, "model": 2}``: each rank's block is the one JAX
    places at its coordinates; ``gather_params`` inverts it."""
    check_shard_params("expert-model")
