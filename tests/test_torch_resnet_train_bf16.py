"""The port's ResNet train step in bfloat16 against the reference's
(see test_torch_resnet_train.py for the step, the net and the batch);
the reference is compiled with excess precision off, as in
test_torch_resnet.py.

One step. At this size bf16 gradients are noisy in both frameworks: the
reference's own bf16 gradient lies ~39% (in norm, over all leaves) from
the float32 gradient, because batch statistics over few rows (16 a
channel in stage 4) amplify every rounding, so a last-bit difference
anywhere sends two runs to different points of that noise. So the
port's bf16 gradient must lie no farther from the reference's bf16
gradient than that lies from the float32 one, and no farther from the
float32 gradient than 1.1 times the reference's own distance: it is as
good an estimate as the reference's. (Measured: norm="pallas" 0.0097
against 0.386; norm="flax" 0.233 against 0.386.) The float32 gradient is
the port's, which test_torch_resnet_train.py holds to the reference's
within 1e-4. The loss within 1e-2 and the running statistics (a forward
quantity, float32 over bf16 activations) within 2e-2 + 2e-2·|flax|; the
params follow the gradient (p − 0.1·g). A second step is not compared:
after a step of lr 0.1 the noise compounds (the losses differ by up to
0.07 of ~1.0).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from .torch_train_parity import (  # noqa: E402
    close_all, flax_steps, grad_vector, port_steps, train_batch)

TOL = dict(loss=1e-2, stats=(2e-2, 2e-2), noise=1.0, own=1.1)


@pytest.mark.parametrize("norm", ["pallas", "flax"])
def test_sgd_step_matches_flax(norm):
    (loss, grads, _, stats), = port_steps(norm, "bfloat16", *train_batch(),
                                          steps=1)
    (jloss, jgrads, _, jstats), = flax_steps(norm, "bfloat16",
                                             *train_batch(), steps=1)
    truth = grad_vector(port_steps(norm, "float32", *train_batch(),
                                   steps=1)[0][1])
    g, jg = grad_vector(grads), grad_vector(jgrads)
    noise = np.linalg.norm(jg - truth)
    assert abs(loss - jloss) <= TOL["loss"], (loss, jloss)
    assert np.linalg.norm(g - jg) <= TOL["noise"] * noise
    assert np.linalg.norm(g - truth) <= TOL["own"] * noise
    close_all(stats, jstats, TOL["stats"], 0)
