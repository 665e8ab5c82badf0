"""The port's ResNet (horovod_tpu_torch/models/resnet.py) in training
mode, against the JAX package's flax ResNet with the same variables:
logits from batch statistics, and every running mean and var after the
update (momentum 0.9, biased variance). Net, images and the strict
compile of the reference as in test_torch_resnet.py.

Tolerances (|port − flax| ≤ atol + rtol·|flax|, elementwise):

- float32: summation order only, 1e-5 + 1e-5·|flax| on logits and
  running statistics.
- bfloat16: every conv and BN output is rounded to bf16 on both sides
  (one step is 2^-8 relative, compounding over 17 convolutions), and
  batch statistics amplify it where a channel has few rows (stage 4
  holds 8 a channel): 3e-2 + 3e-2·|flax| on logits; the statistics
  stay float32, taken over bf16 activations, 1e-2 + 1e-2·|flax|.
- ``bf16stats`` is held to flax's own ``BatchNorm`` on the same
  variables, not to the reference's ``Bf16StatsBatchNorm``. On XLA:CPU
  that variant's ``jnp.mean(..., dtype=bfloat16)`` rounds to bf16 after
  every add: at this net's sizes its second moment falls below the
  squared mean for some channels, their variance clips to 0, and
  ``stage1_block1.proj_bn``'s output reaches ~700 where flax's stays
  under 4. The port rounds each moment to bf16 once (torch's bf16
  reductions accumulate in float32); test_torch_resnet.py holds that
  layer to the reference where the reference's sums are exact. Against
  flax it differs by the variant's own cost: the variance
  E[x²] − E[x]² of bf16-rounded moments (2^-9 relative each) loses most
  of its digits where a channel's mean is large against its spread,
  which stage 4's 8 rows a channel make common. Logits within
  0.15 + 0.05·|flax| (measured 0.11 at |logit| ≈ 1.1), statistics
  within 3e-2 + 3e-2·|flax| (measured 0.019).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from .torch_train_parity import (  # noqa: E402
    flat, flax_model, images, port_with, random_variables, strict_jit)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 3e-2)}
TOL_STATS = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
TOL_BF16STATS, TOL_BF16STATS_STATS = (0.15, 5e-2), (3e-2, 3e-2)

_VARIABLES = {}


def _variables(stem):
    if stem not in _VARIABLES:
        _VARIABLES[stem] = random_variables(stem, seed=11)
    return _VARIABLES[stem]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["flax", "pallas", "bf16stats"])
@pytest.mark.parametrize("stem", ["classic", "s2d"])
def test_train_forward_matches_flax(stem, norm, dtype):
    v, x = _variables(stem), images(13)
    ref_norm = "flax" if norm == "bf16stats" else norm
    logits, upd = strict_jit(
        lambda v, x: flax_model(stem, ref_norm, dtype).apply(
            v, x, train=True, mutable=["batch_stats"]), v, x)
    model = port_with(v, stem, norm, dtype)
    with torch.no_grad():
        got = model(torch.tensor(x), train=True)
    tol, tol_stats = TOL[dtype], TOL_STATS[dtype]
    if norm == "bf16stats":
        tol, tol_stats = TOL_BF16STATS, TOL_BF16STATS_STATS
    np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                               atol=tol[0], rtol=tol[1], err_msg="logits")
    want, before = flat(upd["batch_stats"]), flat(v["batch_stats"])
    bufs = dict(model.named_buffers())
    assert bufs.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(bufs[name].numpy(), want[name],
                                   atol=tol_stats[0], rtol=tol_stats[1],
                                   err_msg=name)
        assert not np.array_equal(bufs[name].numpy(), before[name]), name
