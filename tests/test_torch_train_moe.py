"""The port's training loss against ``jax.value_and_grad`` of the JAX
package's on ``tiny(n_experts=2)``: test_torch_train.py's comparison for
the top-1 MoE FFN (router, expert ``w_in``/``w_out``), kept in a file of
its own so that each file stays well inside its time on the CPU.

Tolerances as in test_torch_train.py (float32: loss 1e-5, each leaf 1e-5
in relative norm; bfloat16: loss 2e-3, each leaf 8e-2). bfloat16 also
keeps test_torch_transformer.py's near-tie allowance: top-1 routing at a
near-tie of the bf16 gates can send a token to the other expert, which
moves that layer's router and expert gradients by that token's share, so
the three expert leaves of at most one layer may exceed the tolerance;
every other leaf must hold it.
"""

import pytest
import torch

torch.set_num_threads(1)

from .torch_train_parity import JaxRefs, rel_errors  # noqa: E402

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 8e-2)}
EXPERT_LEAVES = ("['router']", "['w_in']", "['w_out']")


@pytest.fixture(scope="module")
def refs():
    return JaxRefs(2)


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["gather", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_loss_and_grads_match_jax(refs, dtype, impl, remat, loss_chunk):
    want_loss, want = refs.get(dtype, impl)
    loss, got = refs.port(dtype, impl, remat, loss_chunk)
    tol_loss, tol_grad = TOL[dtype]
    assert abs(loss - want_loss) <= tol_loss
    rel = rel_errors(got, want)
    assert len(rel) == 22
    over = {p: e for p, e in rel.items() if e > tol_grad}
    if dtype == "bfloat16":    # the near-tie allowance, one layer at most
        layers = {p.split("]")[1] for p in over if p.endswith(EXPERT_LEAVES)}
        assert len(layers) <= 1 and all(p.endswith(EXPERT_LEAVES)
                                        for p in over), over
    else:
        assert not over, over
