"""Collectives on torch tensors: the port of ``horovod_tpu/ops/jax_ops.py``.

The reference has two data planes: XLA collectives inside ``shard_map``
over a mesh axis (``jax_ops.py:46-193``), and the core-bridged ops, which
call into the C++ core's negotiation and TCP ring over a process set
(``:195-474``). Both map onto ``torch.distributed`` process groups here:
NCCL for CUDA tensors, gloo for CPU ones. A CUDA tensor is reduced on
the card, with no staging through the host, and every op returns its
result on the input's device.

- The in-mesh half takes a process group, ``Mesh.group(axis)``.
- The Horovod half (``hvd_*``, the object ops, ``barrier``) takes a
  :class:`~..process_sets.ProcessSet`; ``root_rank`` is a rank of the
  world, as in the core. ``name`` is accepted for Horovod's signatures;
  with no negotiation it names nothing.

What the C++ core adds beyond the data plane (``join``, async handles
with ``poll``/``synchronize``, the response cache, timeline, autotune
and the stall inspector) is not part of the port (ROADMAP Queue A item
16). The Horovod ops run inside profiler ranges named ``hvd.<op>``
(:mod:`..profiler`; the end of this module).

A collective that fails in flight raises
:class:`~..exceptions.HorovodInternalError`.
"""

import functools
import pickle

import torch
import torch.distributed as dist

from .. import compression as _compression
from .. import profiler as _profiler
from ..exceptions import HorovodInternalError
from ..process_sets import global_process_set
from ..tree import tree_leaves, tree_map, tree_unflatten

# ReduceOp values, as horovod_tpu/ops/collective_ops.py:11-16 has them.
Sum = 0
Average = 1
Min = 2
Max = 3
Product = 4
Adasum = 5


def _run(call, *args):
    """Issue one c10d call and wait for it. NCCL reports a failed
    collective as ``DistBackendError``, when issued or waited on; gloo as
    a ``RuntimeError`` from the wait."""
    try:
        work = call(*args)
    except dist.DistError as e:
        raise HorovodInternalError(f"collective failed: {e}") from e
    try:
        work.wait()
    except RuntimeError as e:
        raise HorovodInternalError(f"collective failed: {e}") from e


def _divide_(x, n):
    if x.is_floating_point() or x.is_complex():
        return x.div_(n)
    return x.div_(n, rounding_mode="trunc")


def _fresh(x):
    """A contiguous copy of ``x``: NCCL takes contiguous tensors only, and
    an op leaves its input as it was."""
    return x.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# In-mesh collectives over a process group (jax_ops.py:46-193).

def allreduce_(x, group, op=Average):
    """Sum, Average (a sum, then a divide by the group's size), Min or Max
    of a contiguous ``x`` over ``group``, in place; returns ``x``."""
    if op in (Sum, Average):
        _run(group.allreduce, [x])
    elif op in (Min, Max):
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN if op == Min else dist.ReduceOp.MAX
        _run(group.allreduce, [x], opts)
    else:
        raise ValueError(f"unsupported in-mesh reduce op: {op}")
    return _divide_(x, group.size()) if op == Average else x


def allreduce(x, group, op=Average):
    """Allreduce over ``group`` (``jax_ops.py:46``). Product gathers and
    multiplies, exact on negatives and zeros; Adasum is :func:`adasum`."""
    if op == Product:
        return allgather(x[None], group).prod(0, dtype=x.dtype)
    if op == Adasum:
        return adasum(x, group)
    return allreduce_(_fresh(x), group, op)


def sendrecv(x, group, dst, src):
    """Send ``x`` to group rank ``dst`` and return the tensor group rank
    ``src`` sends, as one batch (what ``dist.batch_isend_irecv`` does,
    on the group's own backend object, which need not be registered):
    NCCL coalesces the pair into one group call, gloo posts both before
    waiting on either, so no order of the ranks can deadlock. The ring's
    rotation and Adasum's exchange."""
    x = x.contiguous()
    got = torch.empty_like(x)
    coalesce = group.supports_coalescing
    try:
        if coalesce:
            group._start_coalescing()
        works = [group.send([x], dst, 0), group.recv([got], src, 0)]
        if coalesce:
            works = [group._end_coalescing()]
    except dist.DistError as e:
        raise HorovodInternalError(f"collective failed: {e}") from e
    for work in works:
        try:
            work.wait()
        except RuntimeError as e:
            raise HorovodInternalError(f"collective failed: {e}") from e
    return got


def adasum(x, group):
    """Adasum over ``group`` (``jax_ops.py:65``): the vector-halving
    distance-doubling recursion on whole tensors. At level ``d`` each rank
    exchanges with ``rank ^ d`` and combines ``sa*a + sb*b`` with
    ``sa = 1 - a·b/(2 a·a)`` and ``sb = 1 - a·b/(2 b·b)``; both partners
    compute the same combination. The dot products accumulate in f32.
    Requires a power-of-two group size."""
    n = group.size()
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-two axis size, "
                         f"got {n}")
    if n == 1:
        return x.clone()
    v = x.contiguous()
    level = 1
    while level < n:
        peer = group.rank() ^ level
        b = sendrecv(v, group, peer, peer)
        vf, bf = v.float().reshape(-1), b.float().reshape(-1)
        ab, aa, bb = vf.dot(bf), vf.dot(vf), bf.dot(bf)
        one = torch.ones_like(ab)
        sa = torch.where(aa > 0, 1.0 - ab / (2.0 * aa), one)
        sb = torch.where(bb > 0, 1.0 - ab / (2.0 * bb), one)
        v = (sa * v.float() + sb * b.float()).to(x.dtype)
        level <<= 1
    return v


def allgather(x, group):
    """Concatenate every rank's ``x`` along dim0, in rank order
    (``jax_ops.py:109``)."""
    out = x.new_empty((group.size() * x.shape[0],) + tuple(x.shape[1:]))
    _run(group._allgather_base, out, x.contiguous())
    return out


def broadcast(x, group, root_index=0):
    """Every rank receives the ``x`` of the group's rank ``root_index``
    (``jax_ops.py:115``)."""
    out = _fresh(x)
    opts = dist.BroadcastOptions()
    opts.rootRank = int(root_index)
    _run(group.broadcast, [out], opts)
    return out


def alltoall(x, group, split_axis=0, concat_axis=0):
    """Split ``split_axis`` into one block per rank, send block j to rank
    j, and concatenate the received blocks on ``concat_axis`` in rank
    order (``jax_ops.py:122``; even splits only)."""
    n = group.size()
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall needs dim {split_axis} "
                         f"({x.shape[split_axis]}) divisible by the group "
                         f"size ({n})")
    send = torch.stack(torch.tensor_split(x, n, dim=split_axis))
    recv = torch.empty_like(send)
    _run(group.alltoall_base, recv, send, [], [])
    return torch.cat(recv.unbind(0), dim=concat_axis)


def ragged_pack(x, send_counts, capacity):
    """``(slots [P, capacity, ...], counts [P] int32)``: the rows of
    ``x`` (grouped by destination, peer j's ``send_counts[j]`` rows
    first) packed one ``capacity``-row slot a peer, rows past a slot's
    capacity dropped and the rest of a slot zeros (``jax_ops.py:160-168``).
    Indexing and ``where`` only, so autograd takes it: a slot's gradient
    goes back to the row that filled it, and a dropped row's is zero."""
    P, T = send_counts.shape[0], x.shape[0]
    counts = send_counts.to(device=x.device, dtype=torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    slot = torch.arange(capacity, device=x.device, dtype=torch.int32)
    idx = (starts[:, None] + slot[None, :]).clamp(0, max(T - 1, 0))
    valid = slot[None, :] < counts[:, None]
    buf = torch.where(valid.reshape((P, capacity) + (1,) * (x.ndim - 1)),
                      x[idx.long()],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return buf, counts


def ragged_alltoall(x, send_counts, group, capacity):
    """Uneven alltoall in fixed slots (``jax_ops.py:131``).

    ``x`` is ``[T, ...]`` rows grouped by destination, peer j's block
    first; ``send_counts[j]`` rows go to peer j. Each destination's rows
    are packed into a ``capacity``-row slot (rows past it are dropped;
    :func:`ragged_pack`), the slots cross in one alltoall and the counts
    in another. Returns ``(recv [P, capacity, ...], recv_counts [P]
    int32)``: block i holds the first ``recv_counts[i]`` rows peer i
    sent, the rest zeros, and a count is clamped to ``capacity``
    (``:175-178``)."""
    buf, counts = ragged_pack(x, send_counts, capacity)
    recv = torch.empty_like(buf)
    _run(group.alltoall_base, recv, buf.contiguous(), [], [])
    recv_counts = torch.empty_like(counts)
    _run(group.alltoall_base, recv_counts, counts.contiguous(), [], [])
    return recv, recv_counts.clamp_max(capacity)


def reducescatter(x, group, op=Average):
    """Reduce over ``group`` and give rank r the r-th of equal dim0 blocks
    (``jax_ops.py:181``; Sum and Average only)."""
    if op not in (Sum, Average):
        raise ValueError("in-mesh reducescatter supports Sum/Average")
    n = group.size()
    if x.shape[0] % n:
        raise ValueError(f"reducescatter needs dim0 ({x.shape[0]}) "
                         f"divisible by the group size ({n})")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _run(group._reduce_scatter_base, out, x.contiguous())
    return _divide_(out, n) if op == Average else out


# ---------------------------------------------------------------------------
# Grouped reduction: the gradient path of make_train_step and
# DistributedOptimizer.

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


def grouped_allreduce_(tensors, groups, op=Average, bucket_bytes=0,
                       wire_dtype=None):
    """Reduce every tensor over each group of ``groups`` in turn; returns
    the results in order. It may reduce a tensor in place.

    With ``bucket_bytes > 0`` and Sum, Average, Min or Max, the tensors
    are reduced in the buckets of :func:`bucket_plan`, each concatenated
    and reduced once, and a float bucket crosses the wire in
    ``wire_dtype`` when one is given. Otherwise each tensor is reduced
    alone (Adasum always: a concatenation would change its per-tensor
    geometry)."""
    def reduce(x):
        if op in (Product, Adasum):
            for g in groups:
                x = allreduce(x, g, op)
            return x
        x = x.contiguous()
        for g in groups:
            allreduce_(x, g, op)
        return x

    def reduce_cast(x):
        if wire_dtype is not None and x.dtype in (torch.float32,
                                                  torch.float64):
            return reduce(x.to(wire_dtype)).to(x.dtype)
        return reduce(x)

    if bucket_bytes <= 0 or op in (Product, Adasum):
        return [reduce(t) for t in tensors]
    out = [None] * len(tensors)
    for b in bucket_plan(tensors, bucket_bytes):
        if len(b) == 1:
            out[b[0]] = reduce_cast(tensors[b[0]])
            continue
        red = reduce_cast(torch.cat([tensors[i].reshape(-1) for i in b]))
        off = 0
        for i in b:
            n = tensors[i].numel()
            out[i] = red[off:off + n].view_as(tensors[i])
            off += n
    return out


# ---------------------------------------------------------------------------
# Horovod ops over a process set (jax_ops.py:261-474,
# collective_ops.py:344-400).

def _group(process_set):
    if process_set.group is None:
        raise ValueError(f"this rank has no group in {process_set}: not a "
                         f"member, or the set is not registered (call "
                         f"hvd.init() or add_process_set)")
    return process_set.group


def _root_index(process_set, root_rank):
    if root_rank not in process_set.ranks:
        raise ValueError(f"root rank {root_rank} is not in {process_set}")
    return process_set.ranks.index(root_rank)


def hvd_allreduce(x, op=Average, name=None, process_set=global_process_set,
                  prescale_factor=1.0, postscale_factor=1.0):
    """Allreduce over the set: ``x`` times ``prescale_factor``, reduced
    by ``op``, times ``postscale_factor``."""
    group = _group(process_set)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    out = allreduce(x, group, op)
    return out.mul_(postscale_factor) if postscale_factor != 1.0 else out


def _wire_route(compression):
    """The wire dtype of a cast compressor, ``...`` for one with no cast
    equivalent (its own compress/decompress runs), or None; counted in
    ``compression.stats()`` as engaged or a fallback."""
    wd = _compression.wire_cast_dtype(compression)
    if wd is None:
        return None
    _compression.record_wire_cast(wd is not ...)
    return ... if wd is ... else getattr(torch, wd)


def _reduce_leaves(leaves, op, group, compression, wire):
    """One grouped reduction of ``leaves`` over ``group``: dtype-pure
    buckets, cast to ``wire`` for the wire (``_wire_route``)."""
    if wire is ...:
        pairs = [compression.compress(t) for t in leaves]
        outs = grouped_allreduce_([p[0] for p in pairs], [group], op,
                                  float("inf"))
        return [compression.decompress(o, p[1]) for o, p in zip(outs, pairs)]
    return grouped_allreduce_(leaves, [group], op, float("inf"), wire)


def hvd_allreduce_pytree(tree, op=Average, name=None,
                         process_set=global_process_set, compression=None):
    """Allreduce every leaf of ``tree`` in one grouped reduction."""
    group = _group(process_set)
    wire = _wire_route(compression)
    leaves = [_fresh(t) for t in tree_leaves(tree)]
    return tree_unflatten(tree, _reduce_leaves(leaves, op, group,
                                               compression, wire))


def _allgather_rows(x, group):
    """(every rank's ``x`` concatenated on dim0, each rank's dim0): the
    sizes cross first, then every ``x`` padded to the largest."""
    sizes = allgather(torch.tensor([x.shape[0]], device=x.device),
                      group).tolist()
    m = max(sizes)
    if m != x.shape[0]:
        pad = x.new_zeros((m,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        x = pad
    out = allgather(x, group)
    if len(set(sizes)) > 1:
        out = torch.cat([out[i * m:i * m + s] for i, s in enumerate(sizes)])
    return out, sizes


def hvd_allgather(x, name=None, process_set=global_process_set):
    """Concatenate every member's ``x`` on dim0, in rank order; dim0 may
    differ between members."""
    return _allgather_rows(x, _group(process_set))[0]


def hvd_alltoall(x, splits=None, name=None, process_set=global_process_set):
    """Send ``splits[j]`` rows of ``x`` (in order) to member j and
    concatenate what arrives in rank order. Without ``splits`` dim0 is
    split evenly and the result returned; with them, ``(result,
    received_splits)``."""
    group = _group(process_set)
    n = group.size()
    if splits is None:
        if x.shape[0] % n != 0:
            raise ValueError(
                f"alltoall without splits requires dim0 ({x.shape[0]}) "
                f"divisible by process set size ({n})")
        return alltoall(x, group)
    splits = torch.as_tensor(splits, dtype=torch.int64).to(x.device)
    if splits.numel() != n or int(splits.sum()) != x.shape[0]:
        raise ValueError(f"splits {splits.tolist()} must have {n} entries "
                         f"summing to dim0 ({x.shape[0]})")
    recv_splits = torch.empty_like(splits)
    _run(group.alltoall_base, recv_splits, splits, [], [])
    out = x.new_empty((int(recv_splits.sum()),) + tuple(x.shape[1:]))
    _run(group.alltoall_base, out, x.contiguous(), recv_splits.tolist(),
         splits.tolist())
    return out, recv_splits


def hvd_reducescatter(x, op=Average, name=None,
                      process_set=global_process_set, prescale_factor=1.0,
                      postscale_factor=1.0):
    """Reduce over the set (Sum or Average) and give each member its rows
    of dim0: an even split, the remainder rows to the first members, as
    the core splits."""
    group = _group(process_set)
    n, r, d = group.size(), group.rank(), x.shape[0]
    base, rem = divmod(d, n)
    rows = [base + (i < rem) for i in range(n)]
    m = base + (rem > 0)
    buf = x.new_zeros((n * m,) + tuple(x.shape[1:]))
    starts = [sum(rows[:i]) for i in range(n)]
    for i in range(n):
        buf[i * m:i * m + rows[i]] = x[starts[i]:starts[i] + rows[i]]
    if prescale_factor != 1.0:
        buf.mul_(prescale_factor)
    out = reducescatter(buf, group, op)[:rows[r]]
    return out.mul_(postscale_factor) if postscale_factor != 1.0 else out


def hvd_broadcast(x, root_rank=0, name=None, process_set=global_process_set):
    """Every member receives world rank ``root_rank``'s ``x``."""
    return broadcast(x, _group(process_set),
                     _root_index(process_set, root_rank))


def hvd_broadcast_pytree(tree, root_rank=0, name=None,
                         process_set=global_process_set):
    """Broadcast every leaf of ``tree``; returns a new tree."""
    group = _group(process_set)
    root = _root_index(process_set, root_rank)
    return tree_map(lambda t: broadcast(t, group, root), tree)


def _bytes_of(obj, device):
    data = bytearray(pickle.dumps(obj))
    return torch.frombuffer(data, dtype=torch.uint8).to(device)


def allgather_object(obj, name=None, process_set=global_process_set):
    """Every member's picklable ``obj``, as a list in rank order. The
    pickles ride a uint8 tensor on the set's device."""
    group = _group(process_set)
    flat, sizes = _allgather_rows(
        _bytes_of(obj, process_set.world.device), group)
    flat, out, off = flat.cpu().numpy().tobytes(), [], 0
    for s in sizes:
        out.append(pickle.loads(flat[off:off + s]))
        off += s
    return out


def broadcast_object(obj, root_rank=0, name=None,
                     process_set=global_process_set):
    """World rank ``root_rank``'s picklable ``obj`` on every member."""
    group = _group(process_set)
    root = _root_index(process_set, root_rank)
    device = process_set.world.device
    if group.rank() == root:
        payload = _bytes_of(obj, device)
        length = torch.tensor([payload.numel()], device=device)
    else:
        length = torch.zeros(1, dtype=torch.int64, device=device)
    length = broadcast(length, group, root)
    if group.rank() != root:
        payload = torch.empty(int(length), dtype=torch.uint8, device=device)
    payload = broadcast(payload, group, root)
    return pickle.loads(payload.cpu().numpy().tobytes())


def barrier(process_set=global_process_set):
    """Return once every member has reached it."""
    group = _group(process_set)
    allreduce_(torch.zeros(1, device=process_set.world.device), group, Sum)


def metric_average(value, name=None, process_set=global_process_set):
    """The members' mean of a scalar metric, as a float."""
    group = _group(process_set)
    x = torch.tensor([float(value)], dtype=torch.float64,
                     device=process_set.world.device)
    return float(allreduce_(x, group, Average)[0])


# ---------------------------------------------------------------------------
# Profiler ranges around the user-facing ops (collective_ops.py:517-600,
# the profiler half of ``_instrumented``): each call runs inside a range
# named ``hvd.<op>`` (profiler.py), an NVTX range too when its tensors
# are on the card. Applied by rebinding, so the Horovod API (hvd.py)
# and the ops' own callers go through it. With profiling off a call costs
# one flag check. The other half of the reference's wrapper, metrics
# recording and the stall inspector, waits for ROADMAP Queue A item 1
# (rest).

def _on_cuda(args, kwargs):
    """Whether a call's tensors (the first tensor leaf of its first
    argument), or else its process set's device, are on the card."""
    if args:
        for leaf in tree_leaves(args[0]):
            if torch.is_tensor(leaf):
                return leaf.is_cuda
    for v in list(args) + list(kwargs.values()):
        world = getattr(v, "world", None)
        if world is not None:
            return world.device.type == "cuda"
    world = global_process_set.world
    return world is not None and world.device.type == "cuda"


def _instrumented(fn, op):
    range_name = "hvd." + op

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _profiler.enabled():
            return fn(*args, **kwargs)
        with _profiler.op_range(range_name, _on_cuda(args, kwargs)):
            return fn(*args, **kwargs)
    return wrapper


for _fn, _op in (("hvd_allreduce", "allreduce"),
                 ("hvd_allreduce_pytree", "grouped_allreduce"),
                 ("hvd_allgather", "allgather"),
                 ("hvd_alltoall", "alltoall"),
                 ("hvd_reducescatter", "reducescatter"),
                 ("hvd_broadcast", "broadcast"),
                 ("hvd_broadcast_pytree", "grouped_broadcast"),
                 ("allgather_object", "allgather_object"),
                 ("broadcast_object", "broadcast_object"),
                 ("barrier", "barrier")):
    globals()[_fn] = _instrumented(globals()[_fn], _op)
del _fn, _op
