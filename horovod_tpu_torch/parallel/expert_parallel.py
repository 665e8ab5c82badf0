"""Expert parallelism, MoE alltoall dispatch and combine: the port of
``horovod_tpu/parallel/expert_parallel.py``.

Experts are split over the ranks of one process group (a mesh axis's
``Mesh.group(axis)``). Each rank passes its own tokens ``x [T, D]`` and
router logits ``[T, E]``, as the body of the reference's ``shard_map``
sees them and as a per-rank Horovod caller holds them. Tokens are routed
top-1, packed into fixed-capacity per-expert buffers (one-hot einsums),
exchanged with one all-to-all each way, run through ``expert_fn`` on
the rank's own experts, and combined back weighted by the router
probability. Tokens past a queue's capacity are dropped (Switch
routing): their output is zero.

- ``expert_fn`` maps ``[E_loc, N, D] -> [E_loc, N, D]`` with this
  rank's ``E_loc = E / P`` experts.
- The exchanges are ``parallel/sharding.py``'s, so autograd passes
  through them: the gradients of x and of the expert weights are the
  reference's ``jax.grad``. ``group=None`` is one rank.
"""

import os

import torch
import torch.nn.functional as F

from .sharding import all_to_all, ragged_all_to_all, reduce_from


def env_capacity_factor(default=1.25):
    """Router capacity factor from HVD_EP_CAPACITY_FACTOR (default 1.25,
    the standard Switch setting): per-expert queue slots = T * factor / E.
    A value that is not a number gives ``default``."""
    try:
        return float(os.environ.get("HVD_EP_CAPACITY_FACTOR", default))
    except (TypeError, ValueError):
        return default


def report_dispatch(dropped_fraction, tokens, dropped_tokens=None):
    """Publish one dispatch's capacity-clamp outcome to ``hvd.ep_report``
    (read back by ``hvd.ep_stats``). Returns False, and publishes
    nothing, when ``hvd.init()`` has not run."""
    from .. import hvd

    tokens = int(tokens)
    frac = float(dropped_fraction)
    if dropped_tokens is None:
        dropped_tokens = int(round(frac * tokens))
    dropped_tokens = max(0, min(int(dropped_tokens), tokens))
    try:
        hvd.ep_report(frac, tokens, dropped_tokens)
        return True
    except ValueError:
        return False


def _size(group):
    return 1 if group is None else group.size()


def _route(logits):
    """(router probabilities [T, E] float32, top-1 expert [T], its gate
    [T])."""
    probs = torch.softmax(logits.float(), -1)
    expert_idx = probs.argmax(-1)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    return probs, expert_idx, gate


def _queue(one_hot, capacity):
    """(keep [N, E], slot one-hot [N, E, C]) of each row's place in its
    expert's queue: the rows in order, a row past ``capacity`` dropped
    (the cumsum queue positions of the reference)."""
    pos = (torch.cumsum(one_hot, 0) - 1.0) * one_hot
    keep = (pos < capacity).float() * one_hot
    # F.one_hot refuses an index past its classes, jax.nn.one_hot gives a
    # zero row: clamp, and let ``keep`` zero the row.
    pos_oh = F.one_hot(pos.long().clamp_max(capacity - 1), capacity).float()
    return keep, pos_oh * keep[..., None]


def _group_sums(group, *parts):
    """Each of ``parts`` summed over ``group``, in one all-reduce that
    autograd passes through (the reference's ``psum``s and ``pmean``s
    without their division)."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    flat = reduce_from(flat, group)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def _check_experts(E, P):
    if E % P != 0:
        raise ValueError(f"{E} experts not divisible by axis size {P}")


def moe_dispatch_combine(x, logits, expert_fn, group, capacity_factor=1.25,
                         capacity=None):
    """Top-1 routed expert layer over ``group``: per-expert queues of
    ``capacity`` slots (default ``max(1, int(T * capacity_factor /
    E))``), a one-hot ``[T, E, C]`` dispatch, ``[E, C, D] -> [E_loc, P*C,
    D]`` over one all-to-all and back over another. Returns (out [T, D]
    in x's dtype, aux): ``load_balance_loss`` and ``dropped_fraction``
    from means over the group's tokens, and ``capacity``."""
    P = _size(group)
    T, D = x.shape
    E = logits.shape[-1]
    _check_experts(E, P)
    if capacity is None:
        capacity = max(1, int(T * capacity_factor / E))
    C = capacity

    probs, expert_idx, gate = _route(logits)
    mask = F.one_hot(expert_idx, E).float()                    # [T, E]
    keep, dispatch = _queue(mask, C)                           # [T, E, C]
    combine = dispatch * gate[:, None, None]

    expert_in = torch.einsum("td,tec->ecd", x.float(), dispatch).to(x.dtype)
    recv = all_to_all(expert_in, group, 0, 1)                  # [E_loc,P*C,D]
    out = expert_fn(recv)
    if out.shape != recv.shape:
        raise ValueError(f"expert_fn changed shape {tuple(recv.shape)}->"
                         f"{tuple(out.shape)}")
    back = all_to_all(out, group, 1, 0)                        # [E, C, D]
    y = torch.einsum("ecd,tec->td", back.float(), combine)

    frac_routed, mean_prob, kept = (s / P for s in _group_sums(
        group, mask.mean(0), probs.mean(0), keep.sum() / T))
    aux = {
        "load_balance_loss": E * torch.sum(frac_routed * mean_prob),
        "dropped_fraction": 1.0 - kept,
        "capacity": C,
    }
    return y.to(x.dtype), aux


def moe_dispatch_combine_ragged(x, logits, expert_fn, group,
                                capacity_factor=1.25, peer_capacity=None,
                                expert_capacity=None):
    """Top-1 MoE layer whose dispatch is ragged on the wire: each rank
    sorts its tokens by destination rank and sends each peer only the
    rows routed there, in a ``peer_capacity``-row slot (default
    ``max(1, int(T * capacity_factor / P))``;
    ``sharding.ragged_all_to_all``, with the local expert ids beside
    them). The received rows are packed into per-expert queues of
    ``expert_capacity`` (default ``max(1, int(P * peer_capacity *
    capacity_factor / E_loc))``) locally, run through ``expert_fn``, and
    routed back by one all-to-all over the same slots. A token past
    either capacity is dropped. Returns (out [T, D], aux) as
    :func:`moe_dispatch_combine`, whose ``dropped_fraction`` counts the
    tokens that cleared both gates, with ``peer_capacity`` and
    ``expert_capacity`` in place of ``capacity``."""
    P = _size(group)
    T, D = x.shape
    E = logits.shape[-1]
    _check_experts(E, P)
    E_loc = E // P
    cap = peer_capacity or max(1, int(T * capacity_factor / P))
    C2 = expert_capacity or max(1, int(P * cap * capacity_factor / E_loc))

    probs, expert_idx, gate = _route(logits)
    dest = expert_idx // E_loc                                  # [T] rank
    local_e = expert_idx % E_loc

    # Sort by destination rank: contiguous per-peer blocks.
    order = torch.argsort(dest, stable=True)
    inv = torch.argsort(order)
    dest_s = dest[order]
    send_counts = torch.bincount(dest, minlength=P)
    starts = torch.cumsum(send_counts, 0) - send_counts
    pos_in_block = torch.arange(T, device=x.device) - starts[dest_s]
    sent = pos_in_block < cap                                   # [T] sorted

    recv_x, recv_counts = ragged_all_to_all(x[order], send_counts, group, cap)
    recv_le, _ = ragged_all_to_all(local_e[order], send_counts, group, cap)

    # Per-expert queues of the received rows, on this rank alone.
    N = P * cap
    rows = recv_x.reshape(N, D).float()
    slot = torch.arange(cap, device=x.device)
    rvalid = (slot[None, :] < recv_counts[:, None]).reshape(N)
    le_oh = F.one_hot(recv_le.reshape(N), E_loc).float() * rvalid[:, None]
    keep, pos_oh = _queue(le_oh, C2)                        # [N, E_loc, C2]
    expert_in = torch.einsum("nd,nec->ecd", rows, pos_oh).to(x.dtype)
    out = expert_fn(expert_in)                                  # [E_loc,C2,D]
    if out.shape != expert_in.shape:
        raise ValueError(f"expert_fn changed shape {tuple(expert_in.shape)}"
                         f"->{tuple(out.shape)}")
    rows_out = torch.einsum("ecd,nec->nd", out.float(), pos_oh)

    # The slots are grouped by source: one all-to-all sends each back.
    back = all_to_all(rows_out.reshape(P, cap, D).to(x.dtype), group, 0, 0)
    flat = back.reshape(N, D)
    y_s = flat[dest_s * cap + pos_in_block.clamp(0, cap - 1)]
    y_s = y_s * sent[:, None].to(x.dtype)
    y = y_s[inv] * gate[:, None].to(x.dtype)

    mask = F.one_hot(expert_idx, E).float()
    # Survivors cleared both gates: sent within the peer slot and queued
    # within the local expert's C2 (``keep`` counts them where they
    # landed, so the sum over the group counts every rank's survivors).
    routed, prob, survived, total = _group_sums(
        group, mask.mean(0), probs.mean(0), keep.sum(),
        torch.tensor(float(T), device=x.device))
    aux = {
        "load_balance_loss": E * torch.sum((routed / P) * (prob / P)),
        "dropped_fraction": 1.0 - survived / total,
        "peer_capacity": cap,
        "expert_capacity": C2,
    }
    return y.to(x.dtype), aux


def make_moe_layer(mesh, axis, w_in, w_out, capacity_factor=None,
                   ragged=False, report=True):
    """``fn(x [T, D], logits [T, E]) -> [T, D]``, an MoE FFN over
    ``mesh.group(axis)``, called by every rank of the group on its own
    tokens.

    ``w_in [E_loc, D, F]`` and ``w_out [E_loc, F, D]`` are this rank's
    experts, the block at its coordinate of the reference's weights
    sharded on dim 0 over ``axis``; gradients reach them through ``fn``.
    Each expert is ``gelu(x @ w_in) @ w_out`` in float32 (tanh gelu,
    ``jax.nn.gelu``'s default). ``ragged=True`` dispatches through
    :func:`moe_dispatch_combine_ragged` instead of the dense fixed-slot
    exchange. ``capacity_factor=None`` reads HVD_EP_CAPACITY_FACTOR
    (default 1.25); ``report=True`` publishes each dispatch's dropped
    fraction (of the group's tokens, ``T * P``) through
    :func:`report_dispatch`."""
    if axis not in mesh.axis_names:
        raise ValueError(f"{axis!r} is not an axis of {mesh}")
    group = mesh.group(axis)
    if capacity_factor is None:
        capacity_factor = env_capacity_factor()
    dispatch = moe_dispatch_combine_ragged if ragged \
        else moe_dispatch_combine

    def expert_fn(buf):  # [E_loc, N, D]
        h = torch.einsum("end,edf->enf", buf.float(), w_in.float())
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("enf,efd->end", h,
                            w_out.float()).to(buf.dtype)

    def fn(x, logits):
        out, aux = dispatch(x, logits, expert_fn, group,
                            capacity_factor=capacity_factor)
        if report:
            report_dispatch(float(aux["dropped_fraction"]),
                            x.shape[0] * group.size())
        return out

    return fn
