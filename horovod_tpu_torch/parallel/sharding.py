"""Collectives that autograd passes through, for tensor and sequence
parallelism over a :class:`~.mesh.Mesh`'s process groups.

The JAX package has no counterpart: under ``jax.jit`` XLA inserts these
where two shardings meet (the psum after a row-parallel matmul, the
all-gather at a sequence boundary, a ``ppermute`` in a ring) and
differentiates them itself. Here each is a ``torch.autograd.Function``
over ``ops/torch_ops.py`` on one group, whose backward is the adjoint of
its forward. ``group=None`` (an axis the mesh does not have) is the
identity.

A collective in a backward runs only where autograd reaches that node,
and every rank of the group must run it. So a function whose outputs a
rank may leave unused (the ring's blocks, under the causal skip) is one
node, whose backward runs as long as one output is used.
"""

import torch

from ..ops import torch_ops


def _allgather(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    out = torch_ops.allgather(x.movedim(dim, 0), group)
    return out.movedim(0, dim)


def _reducescatter(x, group, dim):
    """The sum over ``group`` of ``x``, this rank's block of ``dim``."""
    out = torch_ops.reducescatter(x.movedim(dim, 0), group, torch_ops.Sum)
    return out.movedim(0, dim)


def _own_block(x, group, dim):
    n = x.shape[dim] // group.size()
    return x.narrow(dim, group.rank() * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch_ops.allreduce(g, ctx.group, torch_ops.Sum), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return torch_ops.allreduce(x, group, torch_ops.Sum)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, replicated):
        ctx.args = (group, dim, replicated)
        return _allgather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, replicated = ctx.args
        if replicated:
            return _own_block(g, group, dim).contiguous(), None, None, None
        return _reducescatter(g, group, dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return torch_ops.alltoall(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return torch_ops.alltoall(g, group, concat_dim, split_dim), \
            None, None, None


class _RingBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        p, r = group.size(), group.rank()
        blocks = [x.view_as(x)]
        for _ in range(p - 1):
            blocks.append(torch_ops.sendrecv(blocks[-1], group, (r + 1) % p,
                                             (r - 1) % p))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        p, r = group.size(), group.rank()
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = torch_ops.sendrecv(acc, group, (r - 1) % p, (r + 1) % p) + g
        return acc, None


def copy_to(x, group):
    """Enter a region split over ``group`` (the input of a
    column-parallel matmul): the identity, and in the backward the sum of
    the ranks' gradients."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Leave it (the output of a row-parallel matmul): the sum of the
    ranks' partial ``x``; the backward hands the gradient on, the same on
    every rank."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x, group, dim):
    """The ranks' blocks of ``dim`` concatenated in rank order (the K/V
    all-gather over ``seq``). Each rank uses the whole in its own way, so
    the backward sums the ranks' gradients and gives each its block
    (reduce-scatter)."""
    return x if group is None else _Gather.apply(x, group, dim, False)


def gather_replicated(x, group, dim):
    """As :func:`gather`, for a whole whose every use is the same on every
    rank of ``group`` (the vocab-sharded embedding table when the
    activations are replicated over ``model``): each rank's gradient of
    the whole is then already the full one, so the backward keeps this
    rank's block, where a sum would multiply it by the group's size."""
    return x if group is None else _Gather.apply(x, group, dim, True)


def all_to_all(x, group, split_dim, concat_dim):
    """``split_dim`` cut into one block per rank, block j to rank j, the
    received blocks concatenated on ``concat_dim`` in rank order; the
    backward is the inverse all-to-all."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ragged_all_to_all(x, send_counts, group, capacity):
    """``torch_ops.ragged_alltoall`` that autograd passes through: the
    rows of ``x`` packed into one ``capacity``-row slot per peer
    (``torch_ops.ragged_pack``) and exchanged by :func:`all_to_all`, the
    counts by a plain alltoall (they have no gradient). The backward is
    the adjoint: the slots' gradients go back over the same all-to-all
    and are added into the rows that filled them; padding and dropped
    rows get zero. Returns ``(recv [P, capacity, ...], recv_counts [P]
    int32)``, a count clamped to ``capacity``."""
    buf, counts = torch_ops.ragged_pack(x, send_counts, capacity)
    if group is not None:
        counts = torch_ops.alltoall(counts, group)
    return all_to_all(buf, group, 0, 0), counts.clamp_max(capacity)


def ring_blocks(x, group):
    """``(x of rank r, of rank r-1, ..., of rank r-p+1)`` on rank r of a
    ring of p: block i arrives by the i-th rotation, each rank sending to
    rank r+1 and receiving from rank r-1 (one ``sendrecv`` pair). The
    backward rotates the other way, adding each block's gradient on the
    way back to its owner. All rotations are one node, so a rank that
    leaves blocks unused (the causal skip) still runs every rotation of
    the backward."""
    if group is None or group.size() == 1:
        return (x,)
    return _RingBlocks.apply(x, group)
