"""The port's ResNet (horovod_tpu_torch/models/resnet.py) in eval mode,
its layout and its converter, against the JAX package's flax ResNet with
the same variables carried across by ``resnet_from_flax``. Training-mode
forwards are in test_torch_resnet_batch_stats.py.

Net: one bottleneck block a stage, 8 filters, 10 classes; images
``[2, 40, 40, 3]`` from numpy with a seed. At 40 the stem gives 20, the
max pool 10, and the stride-2 3x3 convs see 10, 5 and 3: flax's ``SAME``
pads (0, 1) on the even size and (1, 1) on the odd ones. The reference
is compiled with XLA's excess precision off (``strict_jit``), so that
both sides round to bf16 where the reference's source says.

Tolerances (|port − flax| ≤ atol + rtol·|flax|, elementwise):

- float32: summation order only (convolutions are summed in another
  order on each side), 1e-5 + 1e-5·|flax| on the logits.
- bfloat16: both sides round every conv and BN output to bf16, where a
  value on a rounding boundary lands one step (2^-8 relative) apart,
  and that compounds over the net's 17 convolutions: 3e-2 + 3e-2·|flax|
  on logits of magnitude ~1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu.models import resnet as jresnet  # noqa: E402
from horovod_tpu_torch.models import resnet as tresnet  # noqa: E402
from horovod_tpu_torch.models.convert import resnet_from_flax  # noqa: E402
from .torch_train_parity import (  # noqa: E402
    flat, flax_model, images, port_model, port_with, random_variables,
    strict_jit)

NORMS = ["flax", "pallas", "bf16stats"]
STEMS = ["classic", "s2d"]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 3e-2)}

_VARIABLES = {}


def _variables(stem):
    if stem not in _VARIABLES:
        _VARIABLES[stem] = random_variables(stem, seed=11)
    return _VARIABLES[stem]


def _close(got, want, tol, what):
    atol, rtol = tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("stem", STEMS)
def test_eval_forward_matches_flax(stem, norm, dtype):
    v, x = _variables(stem), images(12)
    want = strict_jit(lambda v, x: flax_model(stem, norm, dtype).apply(
        v, x, train=False), v, x)
    model = port_with(v, stem, norm, dtype)
    with torch.no_grad():
        got = model(torch.tensor(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    _close(got.numpy(), np.asarray(want), TOL[dtype], "logits")
    # eval mode leaves the running statistics alone
    for name, buf in model.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), flat(
            v["batch_stats"])[name])


@pytest.mark.parametrize("depth", ["ResNet50", "ResNet101"])
@pytest.mark.parametrize("stem", STEMS)
def test_names_and_shapes_equal_flax(depth, stem):
    """Every param and batch_stats name of the full-width nets, 1000
    classes, equals flax's, and each shape is flax's after the layout
    map (HWIO -> OIHW, the head's [in, out] -> [out, in])."""
    jmodel = getattr(jresnet, depth)(num_classes=1000, stem=stem)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 224, 224, 3)), train=False))
    model = tresnet.ResNet(
        jmodel.stage_sizes, num_classes=1000, stem=stem, device="meta")
    layout = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
    for coll, mine in (("params", dict(model.named_parameters())),
                       ("batch_stats", dict(model.named_buffers()))):
        theirs = {".".join(k.key for k in p): s.shape
                  for p, s in jax.tree_util.tree_leaves_with_path(
                      shapes[coll])}
        assert mine.keys() == theirs.keys(), coll
        for name, shape in theirs.items():
            want = tuple(shape[i] for i in layout[len(shape)])
            assert tuple(mine[name].shape) == want, name
            assert mine[name].dtype == torch.float32, name


def test_same_padding_is_xla_s():
    """``same_pads`` equals ``lax.padtype_to_pads(..., "SAME")`` for the
    kernel sizes and strides the net uses, on even and odd sizes."""
    for size in range(1, 30):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (4, 1), (7, 2)):
            want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert tresnet.same_pads(size, k, s) == tuple(want), (size, k, s)


def test_converter_raises_on_a_mismatch():
    v = jax.tree.map(np.asarray, _variables("s2d"))
    model = port_model("s2d", "flax", "float32")
    bad = {"params": dict(v["params"], extra={"kernel": np.zeros(3)}),
           "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="only in flax"):
        resnet_from_flax(model, bad)
    head = dict(v["params"]["head"], bias=np.zeros(11, np.float32))
    bad = {"params": dict(v["params"], head=head),
           "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="head.bias"):
        resnet_from_flax(model, bad)
    with pytest.raises(ValueError, match="conv_init.kernel"):
        resnet_from_flax(port_model("classic", "flax", "float32"), v)
    stats = dict(v["batch_stats"])
    del stats["bn_init"]
    with pytest.raises(ValueError, match="only in the module"):
        resnet_from_flax(model, {"params": v["params"],
                                 "batch_stats": stats})


def test_bf16stats_layer_matches_the_reference_where_its_sums_are_exact():
    """One ``Bf16StatsBatchNorm`` layer, training mode, against the
    reference's. The reference's bf16 reduction on XLA:CPU rounds after
    every add, the port's once (see test_torch_resnet_batch_stats.py), so
    the inputs are chosen where every partial sum is exact in bf16:
    values in {-1, -0.5, 0, 0.5, 1} over 16 rows. Then the two functions
    must agree to the output's rounding (one bf16 step) and the running
    statistics exactly."""
    rng = np.random.default_rng(14)
    x = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (2, 2, 4, 8)).astype(
        np.float32)
    scale = (1 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    ref = jresnet.Bf16StatsBatchNorm()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(8, np.float32),
                                 "var": np.ones(8, np.float32)}}
    want, upd = strict_jit(lambda v, x: ref.apply(
        v, x, mutable=["batch_stats"]), variables, x)
    layer = tresnet.Bf16StatsBatchNorm(8, device="cpu")
    with torch.no_grad():
        layer.scale.copy_(torch.tensor(scale))
        layer.bias.copy_(torch.tensor(bias))
        got = layer(torch.tensor(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6, rtol=2 ** -7)
    for name in ("mean", "var"):
        np.testing.assert_array_equal(
            getattr(layer, name).numpy(),
            np.asarray(upd["batch_stats"][name]))
