"""Data-parallel training step: the port of
``horovod_tpu/parallel/data_parallel.py``.

The reference compiles the whole step (forward, backward, gradient
mean, update) into one XLA program over a Mesh. Here the step runs
eagerly: autograd computes the gradients, each gradient bucket is
all-reduced over a ``torch.distributed`` process group and divided by
its size, and a PyTorch optimizer applies the update in place. The
group is any c10d process group object (NCCL on the card, gloo on the
CPU): the step calls its ``allreduce``/``broadcast`` methods directly,
so a group need not be registered as the default one. ``group=None``
means one rank.

Params are a nested dict/list of leaf tensors. Their order is
``jax.tree.flatten``'s (dict keys sorted, lists in order), which is the
order the reference's bucket plan is built over.
"""

import os

import torch
import torch.distributed as dist

from .. import compression as _compression


def tree_flatten_with_path(tree, prefix=""):
    """``[(path, leaf)]`` in ``jax.tree.flatten`` order: dict keys sorted,
    lists and tuples in order. ``path`` is written as
    ``jax.tree_util.keystr`` writes it (``['layers'][0]['wo']``)."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in
                tree_flatten_with_path(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree) for item in
                tree_flatten_with_path(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree):
    """The leaves of ``tree`` in ``jax.tree.flatten`` order; build the
    optimizer over these."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def bucket_plan(leaves, bucket_bytes):
    """Lists of leaf indices, one list per all-reduce, as the reference's
    ``_bucketed_grad_reduce`` builds them: leaves in reversed flatten
    order (about the order their gradients complete in the backward); a
    bucket closes when the next leaf would overflow ``bucket_bytes`` or
    has another dtype (a concatenation would promote)."""
    buckets, cur, cur_bytes = [], [], 0
    for i in reversed(range(len(leaves))):
        nbytes = leaves[i].numel() * leaves[i].element_size()
        if cur and (cur_bytes + nbytes > bucket_bytes
                    or leaves[cur[-1]].dtype != leaves[i].dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def make_train_step(loss_fn, optimizer, group=None, *, accum_steps=1,
                    grad_reduce="mean", bucket_bytes=None,
                    compression=None):
    """Build ``step(params, batch) -> loss``.

    - ``loss_fn(params, batch) -> scalar loss`` written for this rank's
      shard of the batch (``shard_batch``), like a per-rank Horovod step.
    - ``optimizer`` is a PyTorch optimizer over ``tree_leaves(params)``
      (leaf tensors with ``requires_grad``); the step sets each leaf's
      ``.grad`` to the averaged gradient, steps it, and clears the grads.
    - ``group``: a ``torch.distributed`` process group over which
      gradients and the loss are averaged (sum, then divide by its size);
      ``None`` for one rank. Params must start equal on every rank
      (``replicate``).
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
    - ``grad_reduce``: only ``"mean"``. ``"adasum"`` raises: the port's
      device-plane Adasum comes with the Horovod API for CUDA tensors
      (ROADMAP Queue A item 5).
    """
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_reduce == "adasum":
        raise NotImplementedError(
            "grad_reduce='adasum' is not ported yet: it comes with the "
            "device-plane collectives (ROADMAP Queue A item 5)")
    if grad_reduce != "mean":
        raise ValueError(f"grad_reduce must be 'mean' or 'adasum', "
                         f"got {grad_reduce!r}")
    if bucket_bytes is None:
        bucket_bytes = int(os.environ.get("HVD_BUCKET_BYTES", str(32 << 20))) \
            if os.environ.get("HVD_BUCKET") == "1" else 0
    bucket_bytes = int(bucket_bytes)

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

    world = 1 if group is None else group.size()

    def _mean(x):
        if group is not None:
            # A gradient may come out of autograd with permuted strides
            # (an einsum's backward); NCCL takes contiguous tensors only.
            x = x.contiguous()
            group.allreduce([x]).wait()
        return x.div_(world)

    def _reduce_cast(x):
        # Float buckets only; a bucket never mixes dtypes.
        if wire_dtype is not None and x.dtype in (torch.float32,
                                                  torch.float64):
            return _mean(x.to(wire_dtype)).to(x.dtype)
        return _mean(x)

    def _reduce(grads):
        if bucket_bytes <= 0:
            return [_mean(g) for g in grads]
        out = [None] * len(grads)
        for b in bucket_plan(grads, bucket_bytes):
            if len(b) == 1:
                out[b[0]] = _reduce_cast(grads[b[0]])
                continue
            red = _reduce_cast(torch.cat([grads[i].reshape(-1) for i in b]))
            off = 0
            for i in b:
                n = grads[i].numel()
                out[i] = red[off:off + n].view_as(grads[i])
                off += n
        return out

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
                params, leaves, _tree_map(lambda x: _micro(x, m), batch))
            loss_sum = loss_sum + loss
            grad_sum = list(grads) if grad_sum is None else [
                a.add_(g) for a, g in zip(grad_sum, grads)]
        scale = 1.0 / accum_steps
        return loss_sum * scale, [g.mul_(scale) for g in grad_sum]

    def step(params, batch):
        leaves = tree_leaves(params)
        loss, grads = _shard_grad(params, leaves, batch)
        for p, g in zip(leaves, _reduce(grads)):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        return _mean(loss.reshape(1).clone())[0]

    return step


def shard_batch(batch, group=None):
    """This rank's rows of dim0 of every leaf of ``batch``: the group's
    rank r of n takes rows [r*b/n, (r+1)*b/n). ``group=None`` keeps the
    batch whole."""
    if group is None:
        return batch
    n, r = group.size(), group.rank()

    def take(x):
        if x.shape[0] % n != 0:
            raise ValueError(f"batch dim0 ({x.shape[0]}) must be divisible "
                             f"by the group size ({n})")
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return _tree_map(take, batch)


def replicate(tree, group=None):
    """Give every rank of ``group`` the values of its rank 0, in place
    (the reference's ``broadcast_parameters`` at the start of training);
    returns ``tree``."""
    if group is not None:
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        for leaf in tree_leaves(tree):
            group.broadcast([leaf.detach()], opts).wait()
    return tree
