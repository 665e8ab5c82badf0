"""Data-parallel training step: the port of
``horovod_tpu/parallel/data_parallel.py``.

The reference compiles the whole step (forward, backward, gradient
mean, update) into one XLA program over a Mesh. Here the step runs
eagerly: autograd computes the gradients, each gradient bucket is
reduced over ``torch.distributed`` process groups
(``ops/torch_ops.py``), and a PyTorch optimizer applies the update in
place. ``group`` is a :class:`~.mesh.Mesh`, whose ``data_axis`` groups
the step reduces over in turn, or any c10d process group object (NCCL
on the card, gloo on the CPU), whose methods the step calls directly,
so a group need not be registered as the default one. ``group=None``
means one rank.

Params are a nested dict/list of leaf tensors. Their order is
``jax.tree.flatten``'s (dict keys sorted, lists in order), which is the
order the reference's bucket plan is built over.
"""

import math
import os

import torch

from .. import compression as _compression
from ..ops import torch_ops
from ..ops.torch_ops import bucket_plan  # noqa: F401  (re-exported)
from ..tree import (  # noqa: F401  (re-exported)
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten)
from .mesh import Mesh, cut_axes, leaf_spec


def _axes(data_axis):
    return (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)


def _groups(group, data_axis):
    """The process groups a step reduces over, in turn."""
    if group is None:
        return []
    if isinstance(group, Mesh):
        return [group.group(a) for a in _axes(data_axis)]
    return [group]


def _reduced_over(leaves, group, data_axis):
    """For each leaf, the indices into ``_groups(group, data_axis)`` of
    the groups it is reduced and broadcast over: every one but those of
    the axes it is cut along (``mesh.leaf_spec``, as ``shard_params``
    marks it; the experts under ``expert_axis="data"`` hold other values
    on each rank of ``data``). A plain process group names no axis, so a
    cut leaf raises there."""
    if isinstance(group, Mesh):
        axes = _axes(data_axis)
        return [tuple(j for j, a in enumerate(axes) if a not in leaf_spec(x))
                for x in leaves]
    if group is None:
        return [()] * len(leaves)
    for x in leaves:
        if cut_axes(x):
            raise ValueError(
                f"a leaf cut over mesh axes {cut_axes(x)} holds other "
                f"values on other ranks: reduce it over its Mesh, not a "
                f"plain process group")
    return [(0,)] * len(leaves)


def make_train_step(loss_fn, optimizer, group=None, *, data_axis="data",
                    extra_reduce=None, accum_steps=1, grad_reduce="mean",
                    bucket_bytes=None, compression=None):
    """Build ``step(params, batch) -> loss``.

    - ``loss_fn(params, batch) -> scalar loss`` written for this rank's
      shard of the batch (``shard_batch``), like a per-rank Horovod step.
    - ``optimizer`` is a PyTorch optimizer over ``tree_leaves(params)``
      (leaf tensors with ``requires_grad``); the step sets each leaf's
      ``.grad`` to the averaged gradient, steps it, and clears the grads.
    - ``group``: a ``torch.distributed`` process group over which
      gradients and the loss are averaged (sum, then divide by its size),
      or a :class:`~.mesh.Mesh`, averaged over each axis of
      ``data_axis`` (a name or a tuple of names) in turn; ``None`` for
      one rank. Params must start equal on every rank (``replicate``).
      A leaf cut over a ``data_axis`` axis (``shard_params`` marks it;
      the experts under ``expert_axis="data"``) holds other values on
      each rank of it, and its gradient already sums every rank's loss
      over it (the backward of the all-gather that used it): it is not
      reduced over that axis, only divided by its size. The leaves of
      each set of axes are reduced together, in buckets as below. A cut
      leaf under a plain process group raises.
    - ``extra_reduce(grads) -> grads`` runs on the reduced gradients (a
      tree shaped as ``params``) before the optimizer.
    - ``accum_steps=N`` splits the batch's dim0 into N microbatches and
      sums their losses and gradients, scaled by 1/N, before one
      reduction and one update. A dim0 that does not divide by N raises.
    - ``bucket_bytes`` groups the gradients, in reversed flatten order,
      into buckets of at most that many bytes that never mix dtypes
      (``bucket_plan``); each bucket is concatenated and all-reduced
      once, a bucket of one leaf alone. ``None`` reads ``HVD_BUCKET`` /
      ``HVD_BUCKET_BYTES`` as the reference does; 0 reduces leaf by leaf.
    - ``compression``: ``Compression.fp16`` / ``bf16`` cast each float
      bucket to the wire dtype for the all-reduce and back after. The
      decision is counted once, here (``compression.stats()``): engaged
      for those two with buckets on; a fallback for them without buckets
      and for any compressor with no cast equivalent (a subclass).
    - ``grad_reduce="adasum"`` reduces each gradient leaf with Adasum
      (``ops/torch_ops.py`` ``adasum``; power-of-two group sizes) in
      place of the mean, with buckets off; the loss is averaged either
      way.
    """
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_reduce not in ("mean", "adasum"):
        raise ValueError(f"grad_reduce must be 'mean' or 'adasum', "
                         f"got {grad_reduce!r}")
    if bucket_bytes is None:
        bucket_bytes = int(os.environ.get("HVD_BUCKET_BYTES", str(32 << 20))) \
            if os.environ.get("HVD_BUCKET") == "1" else 0
    bucket_bytes = int(bucket_bytes) if grad_reduce == "mean" else 0
    op = torch_ops.Average if grad_reduce == "mean" else torch_ops.Adasum

    # Wire-cast routing, decided once when the step is built and counted
    # either way, as in the reference.
    wire_dtype = None
    if compression is not None:
        wd = _compression.wire_cast_dtype(compression)
        if wd in ("float16", "bfloat16") and bucket_bytes > 0:
            wire_dtype = getattr(torch, wd)
            _compression.record_wire_cast(True)
        elif wd is not None:
            _compression.record_wire_cast(False)

    groups = _groups(group, data_axis)
    sizes = ([group.shape[a] for a in _axes(data_axis)]
             if isinstance(group, Mesh) else [1] * len(groups))

    def _reduce(leaves, grads):
        sets = {}                # the groups each leaf is reduced over
        for i, over in enumerate(_reduced_over(leaves, group, data_axis)):
            sets.setdefault(over, []).append(i)
        out = [None] * len(grads)
        for over, idx in sets.items():   # one order on every rank
            red = torch_ops.grouped_allreduce_(
                [grads[i] for i in idx], [groups[j] for j in over], op,
                bucket_bytes, wire_dtype)
            n = math.prod(s for j, s in enumerate(sizes) if j not in over)
            for i, g in zip(idx, red):
                out[i] = g / n if n > 1 else g
        return out

    def _mean(x):
        # A gradient may come out of autograd with permuted strides
        # (an einsum's backward); NCCL takes contiguous tensors only.
        x = x.contiguous()
        for g in groups:
            torch_ops.allreduce_(x, g)
        return x

    def _micro(x, m):
        if x.shape[0] % accum_steps != 0:
            raise ValueError(
                f"per-rank batch dim0 ({x.shape[0]}) must be divisible by "
                f"accum_steps ({accum_steps})")
        n = x.shape[0] // accum_steps
        return x[m * n:(m + 1) * n]

    def _value_and_grad(params, leaves, batch):
        loss = loss_fn(params, batch)
        # Zeros for a leaf the loss does not reach, as jax.grad gives.
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def _shard_grad(params, leaves, batch):
        if accum_steps == 1:
            loss, grads = _value_and_grad(params, leaves, batch)
            return loss, list(grads)
        loss_sum, grad_sum = 0.0, None
        for m in range(accum_steps):
            loss, grads = _value_and_grad(
                params, leaves, tree_map(lambda x: _micro(x, m), batch))
            loss_sum = loss_sum + loss
            grad_sum = list(grads) if grad_sum is None else [
                a.add_(g) for a, g in zip(grad_sum, grads)]
        scale = 1.0 / accum_steps
        return loss_sum * scale, [g.mul_(scale) for g in grad_sum]

    def step(params, batch):
        leaves = tree_leaves(params)
        loss, grads = _shard_grad(params, leaves, batch)
        grads = _reduce(leaves, grads)
        if extra_reduce is not None:
            grads = tree_leaves(extra_reduce(tree_unflatten(params, grads)))
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        return _mean(loss.reshape(1).clone())[0]

    return step


def shard_batch(batch, group=None, data_axis="data"):
    """This rank's rows of dim0 of every leaf of ``batch``: rank r of n
    takes rows [r*b/n, (r+1)*b/n). Over a Mesh, n is the product of the
    ``data_axis`` sizes and r the rank's row-major index over them, as
    the reference's ``P(data_axis)`` splits dim0. ``group=None`` keeps
    the batch whole."""
    if group is None:
        return batch
    if isinstance(group, Mesh):
        axes = _axes(data_axis)
        coords = dict(zip(group.axis_names, group.coords()))
        n, r = 1, 0
        for a in axes:
            n, r = n * group.shape[a], r * group.shape[a] + coords[a]
    else:
        n, r = group.size(), group.rank()

    def take(x):
        if x.shape[0] % n != 0:
            raise ValueError(f"batch dim0 ({x.shape[0]}) must be divisible "
                             f"by the group size ({n})")
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return tree_map(take, batch)


def replicate(tree, group=None, data_axis="data"):
    """Give every rank the values of its group's rank 0 (over a Mesh: of
    each ``data_axis`` group in turn), in place (the reference's
    ``broadcast_parameters`` at the start of training); returns
    ``tree``. A leaf cut over an axis (``shard_params`` marks it) is left
    as it is over that axis, and raises under a plain process group."""
    leaves = tree_leaves(tree)
    over = _reduced_over(leaves, group, data_axis)
    for j, g in enumerate(_groups(group, data_axis)):
        for leaf, o in zip(leaves, over):
            if j in o:
                t = leaf.detach()
                t.copy_(torch_ops.broadcast(t, g, 0))
    return tree
