"""ResNet-50/101 v1.5: the port of ``horovod_tpu/models/resnet.py``.

``nn.Module``s with flax's names: ``named_parameters()`` gives
``conv_init.kernel``, ``bn_init.scale``, ``stage1_block1.conv2.kernel``,
``head.bias`` and so on, and ``named_buffers()`` the BatchNorms' running
``mean`` and ``var``, where flax has ``params`` and ``batch_stats``. Conv
kernels are OIHW (flax's HWIO transposed), the head's kernel
``[out, in]`` (flax's ``[in, out]`` transposed); ``convert.py`` maps a
flax tree onto them.

The public layout is the reference's: images ``[N, H, W, 3]`` and
activations ``[N, H, W, C]`` between layers, so every BatchNorm sees
``[..., C]``. Inside, each conv views its input as NCHW in
``torch.channels_last`` memory (a permute, no copy), so convolutions run
on NHWC memory and the BatchNorm's ``[R, C]`` view needs no copy either.
Float32 params, compute in ``dtype`` (bfloat16 by default), as in the
reference.

Three norms, under the reference's names:

- ``"flax"``: :class:`BatchNorm`, flax ``nn.BatchNorm``'s function in
  torch ops (float32 statistics as E[x²] − E[x]² clipped at 0,
  normalized in float32, then cast to ``dtype``);
- ``"pallas"``: :class:`KernelBatchNorm`, the reference's
  ``PallasBatchNorm``: training-mode statistics and their backward
  through :func:`~..ops.batch_norm.batch_norm_train`, whose reductions
  are the B4 kernel (``csrc/paired_reduce.cu``) on the card;
- ``"bf16stats"``: :class:`Bf16StatsBatchNorm`, mean and second moment
  of the bf16 activations taken as bf16, finalized in float32. torch has
  no reduction that accumulates in bf16 (its bf16 sums accumulate in
  float32 registers), so the moments are rounded to bf16 once, where
  the reference's ``jnp.mean(..., dtype=bfloat16)`` may round at every
  partial sum; the variant's point, reading the activations at their
  native width, is kept.

Each norm keeps float32 ``scale`` and ``bias`` params and float32
running ``mean`` and ``var`` buffers, updated in training mode as
``m·running + (1 − m)·batch`` with momentum 0.9 and the biased batch
variance, as flax does (torch's ``nn.BatchNorm2d`` uses the other
momentum convention and the unbiased variance, and is not used).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.batch_norm import batch_norm_train

MOMENTUM = 0.9
EPSILON = 1e-5


def _lecun_normal_(t, fan_in, generator):
    """flax's ``lecun_normal``: a normal truncated at ±2 standard
    deviations, scaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        draw = torch.empty(t.shape, device=generator.device
                           if generator is not None else t.device)
        nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        t.copy_(draw)


def same_pads(size, k, stride):
    """XLA's ``SAME`` padding of one spatial dim: (lo, hi). For a
    stride-2 3x3 conv on an even size it is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: ``kernel`` OIHW float32 (kept in
    channels-last memory), computed in ``dtype``. ``padding`` is
    ``"SAME"`` or ``((top, bottom), (left, right))``; an asymmetric pad
    goes through ``F.pad``."""

    def __init__(self, in_ch, out_ch, kernel_size, strides=1,
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(torch.empty(
            (out_ch, in_ch, kh, kw), device=device).contiguous(
            memory_format=torch.channels_last))
        self.strides, self.padding, self.dtype = strides, padding, dtype

    def reset_parameters(self, generator):
        o, i, kh, kw = self.kernel.shape
        _lecun_normal_(self.kernel, i * kh * kw, generator)

    def forward(self, x):
        """x: ``[N, H, W, C]`` in ``dtype`` -> ``[N, H', W', O]``."""
        _, _, kh, kw = self.kernel.shape
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (same_pads(x.shape[1], kh, self.strides),
                                  same_pads(x.shape[2], kw, self.strides))
        else:
            (pt, pb), (pl, pr) = self.padding
        xc = x.permute(0, 3, 1, 2)        # NCHW view of NHWC memory
        if (pt, pl) != (pb, pr):
            xc, pt, pl = F.pad(xc, (pl, pr, pt, pb)), 0, 0
        y = F.conv2d(xc, self.kernel.to(self.dtype), stride=self.strides,
                     padding=(pt, pl))
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [out, in]`` and ``bias``, float32,
    computed in ``dtype``."""

    def __init__(self, in_features, out_features, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((out_features, in_features),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.dtype = dtype

    def reset_parameters(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype))


class _Norm(nn.Module):
    """What the three norms share: float32 ``scale``/``bias`` params,
    float32 running ``mean``/``var`` buffers and the running-average
    update. ``self.training`` is the reference's ``not
    use_running_average`` (``ResNet.forward`` sets it from ``train``).
    Input and output are ``[..., C]``."""

    def __init__(self, channels, dtype=torch.bfloat16, scale_init=1.0,
                 device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("mean", torch.empty(channels, device=device))
        self.register_buffer("var", torch.empty(channels, device=device))
        self.dtype, self.scale_init = dtype, scale_init
        self.reset_parameters(None)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(self.scale_init)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _update(self, mean, var):
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)

    def _apply_running(self, x):
        """Eval mode of the reference's kernel and bf16-stats norms: an
        affine in ``dtype`` from the running statistics."""
        inv = self.scale * torch.rsqrt(self.var + EPSILON)
        a = inv.to(self.dtype)
        b = (self.bias - self.mean * inv).to(self.dtype)
        return x.to(self.dtype) * a + b


class BatchNorm(_Norm):
    """flax ``nn.BatchNorm`` (``norm="flax"``)."""

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            self._update(mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        return ((x.float() - mean) * mul + self.bias).to(self.dtype)


class KernelBatchNorm(_Norm):
    """The reference's ``PallasBatchNorm`` (``norm="pallas"``): training
    mode through :func:`batch_norm_train` (B4 on the card)."""

    def forward(self, x):
        if not self.training:
            return self._apply_running(x)
        y, mean, var = batch_norm_train(x.to(self.dtype), self.scale,
                                        self.bias, EPSILON)
        self._update(mean.detach(), var.detach())
        return y


class Bf16StatsBatchNorm(_Norm):
    """The reference's ``Bf16StatsBatchNorm`` (``norm="bf16stats"``):
    the batch mean and second moment of the bf16 activations, each
    rounded to bf16, then float32 from there on."""

    def forward(self, x):
        if not self.training:
            return self._apply_running(x)
        xh = x.to(torch.bfloat16)
        axes = tuple(range(x.dim() - 1))
        mean = xh.mean(axes).float()
        mean2 = (xh * xh).mean(axes).float()
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        self._update(mean.detach(), var.detach())
        inv = self.scale * torch.rsqrt(var + EPSILON)
        a = inv.to(self.dtype)
        b = (self.bias - mean * inv).to(self.dtype)
        return x.to(self.dtype) * a + b


NORMS = {"flax": BatchNorm, "pallas": KernelBatchNorm,
         "bf16stats": Bf16StatsBatchNorm}


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (carrying the stride, v1.5) -> 1x1 x4, with a projection
    shortcut where the shape changes; ``bn3`` starts with scale 0."""

    def __init__(self, in_ch, filters, strides, dtype, norm, device=None):
        super().__init__()
        nc = NORMS[norm]
        self.conv1 = Conv(in_ch, filters, (1, 1), dtype=dtype, device=device)
        self.bn1 = nc(filters, dtype, device=device)
        self.conv2 = Conv(filters, filters, (3, 3), strides, dtype=dtype,
                          device=device)
        self.bn2 = nc(filters, dtype, device=device)
        self.conv3 = Conv(filters, 4 * filters, (1, 1), dtype=dtype,
                          device=device)
        self.bn3 = nc(4 * filters, dtype, scale_init=0.0, device=device)
        if in_ch != 4 * filters or strides != 1:
            self.proj = Conv(in_ch, 4 * filters, (1, 1), strides,
                             dtype=dtype, device=device)
            self.proj_bn = nc(4 * filters, dtype, device=device)
        else:
            self.proj = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5. ``stem``: ``"classic"`` (7x7/2, pad 3) or ``"s2d"``
    (space-to-depth 2x2, then 4x4/1 with pad (2, 1), the reference's
    exact embedding of the 7x7 stem). ``norm``: ``"flax"``, ``"pallas"``
    or ``"bf16stats"``. ``forward(x, train=True)``: images
    ``[N, H, W, 3]`` -> float32 logits ``[N, num_classes]``; ``train``
    picks batch statistics (and updates the running ones in place) or
    the running statistics, whatever ``self.training`` is."""

    def __init__(self, stage_sizes, num_classes=1000, num_filters=64,
                 dtype=torch.bfloat16, stem="classic", norm="flax",
                 device=None):
        super().__init__()
        if stem not in ("classic", "s2d"):
            raise ValueError(f"stem must be 'classic' or 's2d', got {stem!r}")
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {sorted(NORMS)}, got "
                             f"{norm!r}")
        self.stage_sizes, self.stem, self.norm = tuple(stage_sizes), stem, norm
        self.dtype = dtype
        if stem == "s2d":
            self.conv_init = Conv(12, num_filters, (4, 4),
                                  padding=((2, 1), (2, 1)), dtype=dtype,
                                  device=device)
        else:
            self.conv_init = Conv(3, num_filters, (7, 7), 2,
                                  padding=((3, 3), (3, 3)), dtype=dtype,
                                  device=device)
        self.bn_init = NORMS[norm](num_filters, dtype, device=device)
        in_ch = num_filters
        self.blocks = []
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                name = f"stage{i + 1}_block{j + 1}"
                block = BottleneckBlock(in_ch, num_filters * 2 ** i,
                                        2 if i > 0 and j == 0 else 1, dtype,
                                        norm, device=device)
                self.add_module(name, block)
                self.blocks.append(block)
                in_ch = 4 * num_filters * 2 ** i
        self.head = Dense(in_ch, num_classes, dtype=dtype, device=device)

    def reset_parameters(self, generator):
        """flax's initializers, drawn from ``generator`` in module order:
        ``lecun_normal`` conv and head kernels, zero head bias, BN scale 1
        (0 for ``bn3``) and bias 0, running mean 0 and var 1."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x, train=True):
        for m in self.modules():
            if isinstance(m, _Norm):
                m.training = train
        x = x.to(self.dtype)
        if self.stem == "s2d":
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(1, 2))).float()


def ResNet50(num_classes=1000, dtype=torch.bfloat16, stem="classic",
             norm="flax", device=None):
    return ResNet((3, 4, 6, 3), num_classes=num_classes, dtype=dtype,
                  stem=stem, norm=norm, device=device)


def ResNet101(num_classes=1000, dtype=torch.bfloat16, stem="classic",
              norm="flax", device=None):
    return ResNet((3, 4, 23, 3), num_classes=num_classes, dtype=dtype,
                  stem=stem, norm=norm, device=device)


def create_train_state(generator=None, image_size=224, num_classes=1000,
                       dtype=torch.bfloat16, model=None, stem="classic",
                       norm="flax", device=None):
    """A ResNet-50 (or ``model``) on ``device`` with flax's initializers
    drawn from ``generator`` (on its own device), checked with one eval
    forward on a ones batch of ``image_size``, as the reference's init
    runs one. Returns the module: its params and running statistics live
    in it (the reference returns ``(model, variables)``). torch's and
    JAX's generators give different numbers from one seed: tests that
    compare the two packages convert the flax variables instead."""
    device = resolve_device(device)
    model = model or ResNet50(num_classes=num_classes, dtype=dtype,
                              stem=stem, norm=norm, device=device)
    model.reset_parameters(generator)
    with torch.no_grad():
        model(torch.ones((1, image_size, image_size, 3), device=device),
              train=False)
    return model


def cross_entropy_loss(logits, labels):
    """Mean negative log-likelihood of ``labels`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def make_loss_fn(model):
    """``loss_fn(params, batch)`` for ``parallel.make_train_step``: the
    training-mode cross entropy of ``model`` on ``batch["images"]``
    ``[N, H, W, 3]`` and ``batch["labels"]`` ``[N]``, the reference's
    ``value_and_grad(has_aux=True)`` step (``bench.py``'s resnet50
    config) in PyTorch's terms. ``params`` is
    ``dict(model.named_parameters())``: the function closes over the
    module, whose params those are, and builds the optimizer over
    ``parallel.tree_leaves(params)``; ``torch.optim.SGD(lr=0.1,
    momentum=0.9)`` is the reference's ``optax.sgd(0.1, momentum=0.9)``.

    The running statistics are updated in place, as a side effect of
    each forward, where the reference returns them as the aux output.
    So with ``accum_steps=N`` they update N times a step, once per
    microbatch; and under a group of more than one rank each rank's stay
    its own (nothing reduces them), as the reference's BatchNorm, given
    no ``axis_name``, takes its statistics over its own shard inside
    ``shard_map``."""
    def loss_fn(params, batch):
        return cross_entropy_loss(model(batch["images"], train=True),
                                  batch["labels"])
    return loss_fn
