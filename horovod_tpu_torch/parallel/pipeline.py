"""Pipeline parallelism over a mesh axis: the port of
``horovod_tpu/parallel/pipeline.py``, with the same names and schedules.

The reference is one program: a ``lax.scan`` over ticks inside
``shard_map``, activations hopping between devices by ``lax.ppermute``.
Here every rank of the ``axis`` group is a process (or, in the tests, a
thread) that holds its stage's slice of the params and runs the tick
loop in Python from the host-side tables of :mod:`.schedules`, the same
tables on every rank. Activations and cotangents hop between
neighbouring ranks as point-to-point batches (``torch_ops.p2p``); a
rank with no neighbour on a side receives zeros there, as from
``ppermute``. A group of one rank makes no hop (``sharding.solo``).

* ``gpipe`` (default): all forwards, then autograd's mirrored backward;
  bubble (S-1)/(M+S-1); O(M) activations kept.
* ``1f1b``: the train step fuses forward and backward into single ticks
  (PipeDream-flush order), with a (2S-1)-slot ring of stage inputs and a
  recompute for each backward: O(S) activations, bubble (S-1)/(M+2S-2).
  Forward-only :func:`pipeline_apply` runs the gpipe order.
* ``interleaved`` (``interleaved:V``): each rank holds V non-contiguous
  stage slices, and the hop ring wraps around.
* ``zb``: ZB-H1, 1F1B with the backward split into a dL/dx tick and a
  deferred dL/dw tick placed in the stage's idle ticks. Where the split
  tables cannot be made it falls back to 1F1B and counts the reason
  (``metrics.PIPELINE_ZB_FALLBACKS``).

gpipe and interleaved differentiate the forward tick loop with
autograd: each hop is an autograd Function whose backward is the
reverse hop. A backward hop must run on every rank of the group, in the
same order, so all hops of a call are chained by a zero-size token that
every rank threads through them and into the output: each rank's
backward then runs each of them, last tick first, even on ticks where
it ran no stage. 1f1b and zb schedule their backward by hand in the same
loop, because their point is the backward's order.

``stage_fn(params_for_one_stage, h) -> h`` must keep ``h``'s shape and
dtype ([microbatch, ...] -> [microbatch, ...]): the classic homogeneous
stack of blocks. The ``jit`` of the reference's train step has no
eager counterpart here (compiled steps are ROADMAP Queue A item 15).
"""

import time

import torch

from ..observability import metrics as _metrics
from ..observability import spans as _spans
from ..ops import torch_ops
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import schedules as _schedules
from .mesh import leaf_spec, set_leaf_spec
from .sharding import copy_to, reduce_from, solo

# Re-exported for callers that already import the pipeline module.
resolve_schedule = _schedules.resolve_schedule
schedule_info = _schedules.schedule_info

def _stage_rank(mesh, axis):
    return mesh.coords()[mesh.axis_names.index(axis)]


def _is_slice(leaf, axis):
    """A leaf :func:`shard_stage_params` cut over ``axis``: this rank's
    slice, where any other leaf is the whole stage-leading tree."""
    spec = leaf_spec(leaf)
    return bool(spec) and spec[0] == axis


def _check_stage_leading_dim(tree, n_slices, axis, virtual=1, stages=1):
    """Single validation (and single error format) for the stage-leading
    dim, shared by `pipeline_apply` and `shard_stage_params`, on the
    whole tree's leading dim: a rank's slice (``stages`` ranks hold one
    each) stands for ``stages`` times its own."""
    for leaf in tree_leaves(tree):
        shape = tuple(leaf.shape)
        lead = (shape[0] * stages if len(shape) >= 1 and _is_slice(leaf, axis)
                else shape[0] if shape else None)
        if lead != n_slices:
            hint = (f" (= {n_slices // virtual} stages x {virtual} "
                    f"virtual slices)" if virtual > 1 else "")
            raise ValueError(
                f"stage_params leaf shape {shape} must lead with the "
                f"pipeline stage count {n_slices}{hint} "
                f"(mesh axis {axis!r})")


def _rows(s, S, V):
    """The whole tree's rows that rank ``s`` holds, in chunk order: slice
    ``k*S + s`` as its row k (``interleave_permutation``)."""
    return _schedules.interleave_permutation(S, V)[s * V:(s + 1) * V]


def _local(stage_params, mesh, axis, S, V):
    """This rank's slice of each leaf: a :func:`shard_stage_params` leaf
    as it is, the rows of a whole tree's leaf taken (differentiably)."""
    rows = _rows(_stage_rank(mesh, axis), S, V)
    identity = list(rows) == list(range(S * V))

    def take(a):
        if _is_slice(a, axis) or identity:
            return a
        return a.index_select(0, torch.as_tensor(rows, device=a.device))

    return tree_map(take, stage_params)


def _register_autotune_workload(label):
    """The reference records the schedule in the native core's autotune
    CSV when a core is loaded. The port has no core (ROADMAP Queue A
    item 16), so there is none to tell: False, as the reference returns
    with no core loaded."""
    return False


def _record_schedule(info):
    """Schedule metadata, one record per call or built step."""
    _register_autotune_workload(info.label)
    if not _metrics.enabled():
        return
    _metrics.PIPELINE_TRACES.labels(
        stages=str(info.stages), microbatches=str(info.n_microbatches),
        schedule=info.label).inc()
    _metrics.PIPELINE_BUBBLE.set(info.ideal_bubble)
    _metrics.PIPELINE_BUBBLE_MEASURED.set(info.bubble_fraction)
    _metrics.PIPELINE_TICKS.set(info.ticks)


def _resolve_m(n_microbatches, S, B):
    """M (default S — see the pipeline_apply docstring note) plus the
    divisibility check with a copy-pasteable suggestion."""
    M = int(n_microbatches or S)
    if B % M != 0:
        near = _schedules.suggest_n_microbatches(B, M)
        raise ValueError(
            f"batch {B} not divisible into {M} microbatches; nearest "
            f"valid n_microbatches is {near}")
    return M


# ---------------------------------------------------------------------------
# Hops.

def _move(group, x, dst, src):
    """Send ``x`` to group rank ``dst`` and return what rank ``src``
    sends (either may be None: nothing sent; zeros received)."""
    got = torch.empty_like(x) if src is not None else torch.zeros_like(x)
    torch_ops.p2p(group, [] if dst is None else [(x.contiguous(), dst)],
                  [] if src is None else [(got, src)])
    return got


class _Hop(torch.autograd.Function):
    """One tick's hop: send ``y`` to ``dst``, receive from ``src``. The
    backward is the reverse hop: the received value's gradient goes back
    to ``src``, ``y``'s comes from ``dst``. ``token`` in, a new token
    out: the chain that orders the hops' backwards alike on every rank."""

    @staticmethod
    def forward(ctx, token, y, group, dst, src):
        ctx.args = (group, dst, src)
        return token.new_empty(0), _move(group, y, dst, src)

    @staticmethod
    def backward(ctx, g_token, g_got):
        group, dst, src = ctx.args
        return g_token, _move(group, g_got, src, dst), None, None, None


class _Tie(torch.autograd.Function):
    """``x`` as it is, with ``token`` as an input, so that a backward
    from ``x`` runs the token's chain."""

    @staticmethod
    def forward(ctx, token, x):
        ctx.token = (token.dtype, token.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        dtype, device = ctx.token
        return torch.zeros(0, dtype=dtype, device=device), g


def _token(leaves):
    """The first token: an empty tensor that leads to every leaf that
    needs grad, so that a backward asked for any of them runs every hop."""
    token = torch.zeros(0)
    for a in leaves:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            token = token.to(a.device) + a.reshape(-1)[:0].to(token.dtype)
    return token


def _chain(S, s):
    """(the rank stage s sends to, the rank it receives from)."""
    return (s + 1 if s < S - 1 else None), (s - 1 if s > 0 else None)


def _ring(S, s):
    return (s + 1) % S, (s - 1) % S


# ---------------------------------------------------------------------------
# Forward.

def pipeline_apply(stage_fn, stage_params, x, mesh, axis="pipe",
                   n_microbatches=None, batch_axis=None, schedule=None,
                   virtual_stages=None):
    """Run ``x`` through the pipeline stages laid out on ``mesh[axis]``;
    every rank of the ``axis`` group calls it.

    Args:
      stage_fn: ``(params_for_one_stage, h) -> h`` with ``h`` of shape
        ``[microbatch, ...]`` (shape- and dtype-preserving).
      stage_params: this rank's slice, as :func:`shard_stage_params`
        returns it (leading dim V), or the whole tree whose leaves lead
        with S·V slices in *network order* (slice j feeds slice j+1),
        whose rows this rank takes for itself.
      x: ``[batch, ...]`` input, the same on every rank of the group;
        ``batch`` must divide into ``n_microbatches`` equal microbatches.
        Its gradient is summed over the group, so every rank's is whole.
      n_microbatches: number of microbatches M. Defaults to S — the
        minimum that keeps every stage busy in steady state, but also
        the M that MAXIMIZES the bubble fraction. Prefer M >= 4S when
        the batch allows.
      batch_axis: optional second mesh axis composing data parallelism
        with the pipeline (pp x dp): ``x`` is this rank's rows of the
        batch over that axis (``shard_batch``), and each data replica
        runs the schedule on its rows; the hops stay within the pipe
        group.
      schedule: ``"gpipe"`` | ``"1f1b"`` | ``"interleaved[:V]"`` |
        ``"zb"`` (default: the ``HVD_PIPE_SCHEDULE`` env knob, then
        gpipe). The forward is the same for gpipe/1f1b/zb; interleaved
        changes the layout itself.
      virtual_stages: V for the interleaved schedule (overrides the
        ``:V`` suffix; default 2).

    Returns the ``[batch, ...]`` outputs on every rank of the group (this
    rank's rows under ``batch_axis``). The stage params' gradients are
    this rank's stage's.
    """
    name, V = _schedules.resolve_schedule(schedule, virtual_stages)
    S = int(mesh.shape[axis])
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of "
                         f"{mesh}")
    M = _resolve_m(n_microbatches, S, x.shape[0])
    _check_stage_leading_dim(stage_params, S * V, axis, virtual=V, stages=S)
    _record_schedule(_schedules.schedule_info(name, S, M, V))
    local = _local(stage_params, mesh, axis, S, V)
    return _apply(stage_fn, local, x, mesh.group(axis),
                  _stage_rank(mesh, axis), S, M, V)


def _apply(stage_fn, local, x, group, s, S, M, V):
    B = x.shape[0]
    token = None
    if S > 1:
        if x.requires_grad:
            x = copy_to(x, group)
        token = _token(tree_leaves(local) + [x])
    xm = list(x.reshape((M, B // M) + tuple(x.shape[1:])).unbind(0))
    if V == 1:
        out, token = _gpipe_forward(stage_fn, local, xm, group, s, S, M,
                                    token)
    else:
        out, token = _interleaved_forward(stage_fn, local, xm, group, s, S,
                                          M, V, token)
    out = torch.stack(out) if out[0] is not None else torch.zeros(
        (M,) + tuple(xm[0].shape), dtype=x.dtype, device=x.device)
    # Only the last stage holds the outputs: the sum over the group
    # replicates them, and its backward hands each rank's gradient on.
    out = reduce_from(out, group)
    if token is not None:
        out = _Tie.apply(token, out)
    return out.reshape((B,) + tuple(out.shape[2:]))


def _stage(local, k):
    return tree_map(lambda a: a[k], local)


def _gpipe_forward(stage_fn, local, xm, group, s, S, M, token):
    """The classic wavefront: stage s runs microbatch m at tick s+m —
    the forward order every non-interleaved schedule shares. A rank
    skips ``stage_fn`` on its idle ticks and hops zeros there."""
    p_s = _stage(local, 0)
    dst, src = _chain(S, s)
    zero = torch.zeros_like(xm[0])
    out = [None] * M
    cur = xm[0]
    T = M + S - 1
    for t in range(T):
        m = t - s
        y = stage_fn(p_s, cur) if 0 <= m < M else zero
        if s == S - 1 and 0 <= m < M:
            out[m] = y
        if t == T - 1:
            break
        if S > 1:
            token, cur = _Hop.apply(token, y, group, dst, src)
        if s == 0:     # stage 0 ingests the next microbatch
            cur = xm[t + 1] if t + 1 < M else zero
    return out, token


def _interleaved_forward(stage_fn, local, xm, group, s, S, M, V, token):
    """Interleaved virtual stages: rank s holds chunks {s, S+s, ...} as
    its rows 0..V-1; the hop ring wraps (rank S-1 -> rank 0 carries the
    chunk-k -> chunk-k+1 boundary). A chunk-boundary activation can wait
    up to max(S, M) - S ticks for its consumer in this rank's
    microbatch-indexed inbox."""
    tabs = _schedules._forward_tables(S, M, V)
    T = tabs["T"]
    exec_mb, exec_chunk, recv_mb = (tabs["exec_mb"], tabs["exec_chunk"],
                                    tabs["recv_mb"])
    chunks = [_stage(local, k) for k in range(V)]
    dst, src = _ring(S, s)
    zero = torch.zeros_like(xm[0])
    out, inbox, rx = [None] * M, {}, None
    for t in range(T):
        rm = int(recv_mb[t, s])
        if rm >= 0:
            inbox[rm] = rx
        m, k = int(exec_mb[t, s]), int(exec_chunk[t, s])
        y = zero
        if m >= 0:
            x_in = xm[m] if s == 0 and k == 0 else inbox.pop(m)
            y = stage_fn(chunks[k], x_in)
            if s == S - 1 and k == V - 1:   # the final virtual stage
                out[m] = y
        if t == T - 1:
            break
        if S > 1:
            token, rx = _Hop.apply(token, y, group, dst, src)
        else:
            rx = y
    return out, token


def shard_stage_params(stage_params, mesh, axis="pipe", virtual_stages=1):
    """This rank's slice of a stage-leading tree (numpy arrays or
    tensors whose leaves lead with S·V slices in network order), on the
    mesh's device: leading dim 1, or with ``virtual_stages=V`` its V
    chunks in chunk order (row k is slice ``k*S + s``), as a shard of the
    reference's placement holds after its interleaved routing. Each leaf
    is marked as cut over ``axis`` (``mesh.set_leaf_spec``), which the
    pipeline functions read."""
    S = int(mesh.shape[axis])
    V = int(virtual_stages)
    _check_stage_leading_dim(stage_params, S * V, axis, virtual=V)
    rows = torch.as_tensor(_rows(_stage_rank(mesh, axis), S, V))

    def place(a):
        a = torch.as_tensor(a).detach()
        local = a.index_select(0, rows.to(a.device)).to(mesh.device)
        return set_leaf_spec(local, (axis,) + (None,) * (a.dim() - 1))

    return tree_map(place, stage_params)


# ---------------------------------------------------------------------------
# Training: schedule-aware value-and-grad.

def _plan_zb(S, M):
    """ZB-H1 tables, or (None, reason) when the split schedule can't be
    made — the counted fallback path."""
    if S < 2:
        return None, "single_stage"
    try:
        tabs = _schedules._zb_tables(S, M)
        w_mb, Rw = tabs["w_mb"], tabs["w_ring"]
        # Verify the deferred (x, dy) ring never aliases: slot m % Rw is
        # rewritten at Bx(m + Rw), which must come after Bw(m) reads it.
        for s in range(S):
            for t in range(tabs["T"]):
                m = int(w_mb[t, s])
                if m < 0:
                    continue
                next_write = 2 * S - 2 - s + m + Rw  # Bx tick of m + Rw
                if m + Rw < M and next_write <= t:
                    return None, "ring_alias"
        if int((w_mb >= 0).sum()) != S * M:
            return None, "unplaced_bw"
    except Exception:
        return None, "table_error"
    return tabs, None


def _trainable(stage_params, mesh, axis, S, V):
    """(this rank's slice with fresh leaves that need grad, the leaves)."""
    local = _local(stage_params, mesh, axis, S, V)
    leaves = [a.detach().requires_grad_() for a in tree_leaves(local)]
    return tree_unflatten(local, leaves), leaves


def _data_mean(loss, grads, mesh, batch_axis):
    """Average the loss and the gradients over the data group."""
    group = mesh.group(batch_axis) if batch_axis else None
    if solo(group):
        return loss, grads
    grads = [torch_ops.allreduce_(g.contiguous(), group) for g in grads]
    return torch_ops.allreduce_(loss.reshape(1).clone(), group)[0], grads


def make_pipeline_value_and_grad(stage_fn, loss_fn, mesh, axis="pipe",
                                 n_microbatches=None, batch_axis=None,
                                 schedule=None, virtual_stages=None):
    """``vg(stage_params, batch) -> (loss, grads)`` under the chosen
    schedule, called by every rank of the mesh. gpipe/interleaved
    differentiate the forward tick loop (autograd runs the mirrored
    backward); 1f1b/zb schedule the backward by hand in a fused
    forward/backward loop with an O(S) activation ring (a recompute and
    ``torch.autograd.grad`` per backward tick).

    ``batch["x"]`` is the pipeline's input; ``loss_fn(outputs, batch)``
    gives a scalar. ``grads`` is shaped as this rank's slice of
    ``stage_params`` (leading dim V). Under ``batch_axis`` the batch is
    this rank's rows and the loss and gradients are averaged over the
    data group, which needs ``loss_fn`` to be a mean over rows.

    The fused schedules require every ``batch`` leaf to lead with the
    batch dim and ``loss_fn`` to be mean-decomposable over microbatches
    (true for the usual mean MSE / mean cross-entropy): the loss is
    computed per microbatch at the last stage and its cotangent seeded
    in the same tick. Gradients and loss match the autodiff schedules to
    float tolerance: schedules change timing, not math.
    """
    name, V = _schedules.resolve_schedule(schedule, virtual_stages)
    S = int(mesh.shape[axis])

    if name in ("gpipe", "interleaved"):
        def vg(params, batch):
            x = batch["x"]
            M = _resolve_m(n_microbatches, S, x.shape[0])
            _check_stage_leading_dim(params, S * V, axis, virtual=V,
                                     stages=S)
            _record_schedule(_schedules.schedule_info(name, S, M, V))
            local, leaves = _trainable(params, mesh, axis, S, V)
            with torch.enable_grad():
                out = _apply(stage_fn, local, x, mesh.group(axis),
                             _stage_rank(mesh, axis), S, M, V)
                loss = loss_fn(out, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            loss, grads = _data_mean(loss.detach(), list(grads), mesh,
                                     batch_axis)
            return loss, tree_unflatten(local, grads)
        vg.schedule_label = _schedules.schedule_label(name, V)
        return vg

    # Fused 1F1B / ZB-H1. M is fixed here (the tables are built once).
    M = int(n_microbatches or S)
    zb_tabs = None
    if name == "zb":
        zb_tabs, reason = _plan_zb(S, M)
        if zb_tabs is None:
            if _metrics.enabled():
                _metrics.PIPELINE_ZB_FALLBACKS.labels(reason=reason).inc()
            name = "1f1b"
    tabs = zb_tabs if zb_tabs is not None else _schedules._onef1b_tables(S, M)
    info = _schedules.schedule_info(name, S, M, 1)
    vg = _fused_value_and_grad(stage_fn, loss_fn, mesh, axis, S, M,
                               batch_axis, tabs, zb=zb_tabs is not None,
                               info=info)
    vg.schedule_label = info.label
    return vg


def _vjp(stage_fn, local, leaves, x, dy, wrt_params, wrt_x):
    """Recompute stage 0 of ``local`` on ``x`` and pull ``dy`` back: (the
    leaves' gradients or None, x's or None)."""
    if not (wrt_params or wrt_x):
        return None, None
    with torch.enable_grad():
        xs = x.detach().requires_grad_(wrt_x)
        y = stage_fn(_stage(local, 0), xs)
        wrt = (leaves if wrt_params else []) + ([xs] if wrt_x else [])
        got = torch.autograd.grad(y, wrt, dy, allow_unused=True,
                                  materialize_grads=True)
    return (list(got[:len(leaves)]) if wrt_params else None,
            got[-1] if wrt_x else None)


def _fused_value_and_grad(stage_fn, loss_fn, mesh, axis, S, M,
                          batch_axis, tabs, zb, info):
    """The fused 1F1B/ZB loop: per tick, an F half (wavefront forward,
    ring-buffered stage input), a B half (recompute vjp; dx hops the
    reverse chain, the params' gradient accumulates — or, under ZB, is
    deferred), and under ZB a W half replaying a saved (x, dy) pair for
    the weight gradient. Each tick posts the forward and the reverse hop
    as one batch."""
    T = tabs["T"]
    f_mb, b_mb = tabs["f_mb"], tabs["b_mb"]
    w_mb = tabs["w_mb"] if zb else None
    Rw = int(tabs.get("w_ring", 1))
    # Stage-input ring: F(m) writes slot m % R at tick s+m, B(m) reads
    # it at 2S-2-s+m; R = 2S-1 outlives every read (the next writer of
    # the slot, F(m+R), lands strictly after).
    R = max(1, 2 * S - 1)
    group = mesh.group(axis)
    dp_n = int(mesh.shape[batch_axis]) if batch_axis else 1
    dgroup = mesh.group(batch_axis) if batch_axis else None

    def vg(params, batch):
        x = batch["x"]
        B = x.shape[0]
        _resolve_m(M, S, B)  # reuse the divisibility error + suggestion
        _check_stage_leading_dim(params, S, axis, stages=S)
        _record_schedule(info)
        mb = B // M

        def to_microbatches(a):
            if a.shape[0] != B:
                raise ValueError(
                    f"fused pipeline schedules need every batch leaf to "
                    f"lead with the batch dim {B}, got shape "
                    f"{tuple(a.shape)}")
            return a.reshape((M, mb) + tuple(a.shape[1:]))
        bm_tree = tree_map(to_microbatches, batch)
        local, leaves = _trainable(params, mesh, axis, S, 1)
        s = _stage_rank(mesh, axis)
        last = S - 1
        xm = bm_tree["x"]
        zero = torch.zeros_like(xm[0])
        buf, wring = [None] * R, [None] * Rw
        gacc = [torch.zeros_like(a) for a in leaves]
        lacc = torch.zeros((), dtype=torch.float32, device=x.device)
        cur = dyx = zero
        with torch.no_grad():
            p_s = _stage(local, 0)
            for t in range(T):
                # ---- F half: the gpipe wavefront ----
                fm = int(f_mb[t, s])
                y = zero
                if fm >= 0:
                    x_in = xm[fm] if s == 0 else cur
                    y = stage_fn(p_s, x_in)
                    buf[fm % R] = x_in   # the stage INPUT, recomputed at B
                    if s == last:
                        # The cotangent from the per-microbatch loss in
                        # the SAME tick (B(m) and F(m) share it here).
                        with torch.enable_grad():
                            yy = y.detach().requires_grad_()
                            lval = loss_fn(yy, tree_map(lambda a: a[fm],
                                                        bm_tree))
                            dy_seed, = torch.autograd.grad(lval, yy)
                        lacc += lval.detach().float()
                # ---- B half: dx on the critical path ----
                bmx = int(b_mb[t, s])
                dx = zero
                if bmx >= 0:
                    x_saved = buf[bmx % R]
                    dy_in = dy_seed / (M * dp_n) if s == last else dyx
                    grads, got = _vjp(stage_fn, local, leaves, x_saved, dy_in,
                                      wrt_params=not zb, wrt_x=s > 0)
                    if got is not None:
                        dx = got
                    if zb:   # defer dL/dw: park (x, dy) for its W tick
                        wring[bmx % Rw] = (x_saved, dy_in)
                    else:
                        for g, d in zip(gacc, grads):
                            g += d
                # ---- W half (zb): a deferred weight gradient ----
                if zb and int(w_mb[t, s]) >= 0:
                    xw, dyw = wring[int(w_mb[t, s]) % Rw]
                    grads, _ = _vjp(stage_fn, local, leaves, xw, dyw,
                                    wrt_params=True, wrt_x=False)
                    for g, d in zip(gacc, grads):
                        g += d
                # ---- hops: forward and reverse in one batch ----
                if S > 1 and t < T - 1:
                    cur, dyx = _fused_hops(group, s, S, y, dx, zero)
        # The loss is nonzero on stage S-1 only: the sum over the group
        # gives it to every rank.
        loss = torch_ops.allreduce_(lacc.reshape(1) / M, group,
                                    torch_ops.Sum) if S > 1 else lacc / M
        loss = loss.reshape(())
        if not solo(dgroup):
            loss = torch_ops.allreduce_(loss.reshape(1), dgroup,
                                        torch_ops.Sum)[0] / dp_n
            # dy was pre-scaled by 1/(M*dp_n); summing the replicas'
            # gradients completes the full-batch mean.
            gacc = [torch_ops.allreduce_(g, dgroup, torch_ops.Sum)
                    for g in gacc]
        return loss, tree_unflatten(local, gacc)

    return vg


def _fused_hops(group, s, S, y, dx, zero):
    """A fused tick's two hops as one batch: ``y`` to stage s+1 and the
    next input from s-1; ``dx`` to stage s-1 and the next cotangent from
    s+1. Zeros stand in at the ends of the chain."""
    cur, dyx = torch.empty_like(zero), torch.empty_like(zero)
    sends, recvs = [], []
    if s < S - 1:   # forward to s+1, and its cotangents back
        sends.append((y.contiguous(), s + 1))
        recvs.append((dyx, s + 1))
    if s > 0:
        sends.append((dx.contiguous(), s - 1))
        recvs.append((cur, s - 1))
    torch_ops.p2p(group, sends, recvs)
    return (cur if s > 0 else zero), (dyx if s < S - 1 else zero)


def make_pipeline_train_step(stage_fn, loss_fn, optimizer, mesh, axis="pipe",
                             n_microbatches=None, batch_axis=None,
                             jit=True, schedule=None, virtual_stages=None):
    """Standard train step over the pipeline: ``loss_fn(outputs, batch)``
    -> scalar; grads w.r.t. this rank's stage params
    (:func:`make_pipeline_value_and_grad`); ``optimizer``, a PyTorch
    optimizer over ``tree_leaves`` of this rank's slice (as
    :func:`shard_stage_params` returns it), applies them in place, as
    ``make_train_step`` does. ``batch_axis`` composes data parallelism
    (the gradients come out averaged over it); ``schedule`` picks the
    tick order. ``jit`` is accepted for the reference's signature and
    changes nothing: the step runs eagerly. Returns ``step(stage_params,
    batch) -> loss``.

    With metrics enabled at build time (``HVD_METRICS=1``) the step is
    wrapped to count PIPELINE_STEPS and emit PIPELINE_STEP /
    PIPELINE_{WARMUP,STEADY,COOLDOWN} spans (the phase spans are
    tick-proportional estimates of the measured step wall time).
    """
    vg = make_pipeline_value_and_grad(
        stage_fn, loss_fn, mesh, axis, n_microbatches,
        batch_axis=batch_axis, schedule=schedule,
        virtual_stages=virtual_stages)
    name, V = _schedules.resolve_schedule(schedule, virtual_stages)

    def step(stage_params, batch):
        leaves = tree_leaves(stage_params)
        for a in leaves:
            if a.shape[0] != V:
                raise ValueError(
                    f"make_pipeline_train_step updates this rank's slice "
                    f"in place: every leaf must lead with {V} (as "
                    f"shard_stage_params returns it), got {tuple(a.shape)}")
        loss, grads = vg(stage_params, batch)
        for p, g in zip(leaves, tree_leaves(grads)):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        return loss

    if not _metrics.enabled():
        return step

    S = int(mesh.shape[axis])
    info = _schedules.schedule_info(name, S, int(n_microbatches or S), V)

    def timed_step(stage_params, batch):
        t0 = time.perf_counter_ns()
        loss = step(stage_params, batch)
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        dur_us = (time.perf_counter_ns() - t0) // 1000
        _metrics.PIPELINE_STEPS.labels(schedule=info.label).inc()
        end_us = time.time_ns() // 1000
        start_us = end_us - dur_us
        _spans.event("PIPELINE_STEP", start_us, dur_us, cat="pipeline",
                     schedule=info.label, ticks=info.ticks,
                     bubble=round(info.bubble_fraction, 4))
        # Tick-proportional phase estimates of the measured wall time.
        tot = max(1, info.ticks)
        w_us = dur_us * info.warmup_ticks // tot
        c_us = dur_us * info.cooldown_ticks // tot
        s_us = dur_us - w_us - c_us
        _spans.event("PIPELINE_WARMUP", start_us, w_us,
                     cat="pipeline", estimate=True)
        _spans.event("PIPELINE_STEADY", start_us + w_us, s_us,
                     cat="pipeline", estimate=True)
        _spans.event("PIPELINE_COOLDOWN", start_us + w_us + s_us, c_us,
                     cat="pipeline", estimate=True)
        return loss

    return timed_step
