"""The port's ResNet train step (``make_loss_fn`` through
horovod_tpu_torch/parallel ``make_train_step``, ``torch.optim.SGD(lr=0.1,
momentum=0.9)``) against the reference's bench-style step
(``value_and_grad(has_aux=True)`` with the batch statistics as the aux,
``optax.sgd(0.1, momentum=0.9)``; ``bench.py``'s resnet50 config), in
float32; test_torch_resnet_train_bf16.py does bfloat16.

Net: one bottleneck block a stage, 8 filters, 10 classes, random
variables from numpy; images ``[4, 40, 40, 3]`` and labels from a seed
(``torch_train_parity``). The gradients compared are the ones the step
hands the optimizer. Two steps: the first equals plain SGD (both
optimizers start the momentum buffer at the gradient), the second
exercises the buffer (0.9·buf + g).

Tolerances, summation order only: every gradient leaf within 1e-4 in
relative norm (|g_port − g_flax| / |g_flax|), params and running
statistics within 1e-5 + 1e-5·|flax| elementwise, the loss within 3e-5
(step 1's loss, ~1.2, is taken after a step of lr 0.1 from params that
already differ by step 0's rounding).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu_torch.models import resnet as tresnet  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    make_train_step, tree_leaves)

from .torch_train_parity import (  # noqa: E402
    TRAIN_STEM, close_all, flax_steps, port_steps, port_with, rel_errors,
    run_ranks, train_batch, train_variables)

TOL = dict(loss=3e-5, grad=1e-4, params=(1e-5, 1e-5), stats=(1e-5, 1e-5))


@pytest.mark.parametrize("norm", ["pallas", "flax"])
def test_two_sgd_momentum_steps_match_flax(norm):
    port = port_steps(norm, "float32", *train_batch())
    for i, ((loss, grads, params, stats),
            (jloss, jgrads, jparams, jstats)) in enumerate(
                zip(port, flax_steps(norm, "float32", *train_batch()))):
        assert abs(loss - jloss) <= TOL["loss"], (i, loss, jloss)
        rel = rel_errors(grads, jgrads)
        worst = max(rel, key=rel.get)
        assert rel[worst] <= TOL["grad"], (i, worst, rel[worst])
        close_all(params, jparams, TOL["params"], i)
        close_all(stats, jstats, TOL["stats"], i)


def test_two_ranks_average_gradients_and_keep_their_own_stats():
    """One step on 2 ranks (norm="pallas", float32): the gradient the
    step applies is the mean of the two half-batch 1-process gradients,
    params end equal on both ranks, and each rank's running statistics
    are those of its own half (nothing reduces them). Within 1e-6: the
    mean is taken in another order."""
    x, labels = train_batch()
    ranks = run_ranks(2, lambda g, r: port_steps(
        "pallas", "float32", x, labels, group=g, steps=1)[0])
    halves = [port_steps("pallas", "float32", x[h:h + 2], labels[h:h + 2],
                          steps=1)[0] for h in (0, 2)]
    (_, g0, p0, s0), (_, g1, p1, s1) = ranks
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
    for name, g in g0.items():
        want = (halves[0][1][name] + halves[1][1][name]) / 2
        np.testing.assert_allclose(g, want, atol=1e-6, rtol=0, err_msg=name)
        np.testing.assert_array_equal(g, g1[name], err_msg=name)
    for stats, half in ((s0, halves[0]), (s1, halves[1])):
        for name, s in stats.items():
            np.testing.assert_allclose(s, half[3][name], atol=1e-6, rtol=0,
                                       err_msg=name)
    assert not np.allclose(s0["bn_init.mean"], s1["bn_init.mean"])


def test_accum_steps_update_the_running_stats_once_per_microbatch():
    """With accum_steps=2 each norm's running statistics take two
    momentum updates a step, one per microbatch (make_loss_fn's
    docstring)."""
    x, labels = train_batch()
    model = port_with(train_variables(), TRAIN_STEM, "pallas", "float32")
    params = dict(model.named_parameters())
    opt = torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9)
    step = make_train_step(tresnet.make_loss_fn(model), opt, accum_steps=2)
    before = model.bn_init.mean.clone()
    step(params, {"images": torch.tensor(x),
                  "labels": torch.tensor(labels).long()})
    ref = port_with(train_variables(), TRAIN_STEM, "pallas", "float32")
    with torch.no_grad():
        for half in (x[:2], x[2:]):
            ref(torch.tensor(half), train=True)
    assert not torch.equal(model.bn_init.mean, before)
    torch.testing.assert_close(model.bn_init.mean, ref.bn_init.mean,
                               atol=1e-6, rtol=0)
