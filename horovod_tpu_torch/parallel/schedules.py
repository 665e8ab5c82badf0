"""Pipeline schedule tables: GPipe, 1F1B, interleaved virtual stages, ZB-H1.

The port's own copy of ``horovod_tpu/parallel/schedules.py`` (numpy
only), with the same names, tables and ``HVD_PIPE_SCHEDULE`` knob.

A schedule here is a set of host-side numpy tables of shape ``[T, S]``
(ticks x pipe-axis ranks) holding a microbatch index (or -1 for idle)
per micro-op kind — forward, backward, and (ZB only) deferred
weight-grad. :mod:`.pipeline` runs its tick loop from these tables on
every rank, so *counting their occupancy is measuring the real
artifact*: the same arrays that route microbatches through the ticks
produce the ``bubble_fraction`` the gauges report.

Bubble accounting (the ``bubble_fraction`` everywhere in this repo):
a device-tick *slot* is occupied when that device has at least one
scheduled micro-op at that tick; ``bubble = 1 - busy_slots / (T * S)``.
Under this accounting the closed forms are

=================  =============================  =======================
schedule           bubble (training)              peak activation residency
=================  =============================  =======================
gpipe              (S-1)/(M+S-1)                  O(M) microbatches/stage
1f1b               (S-1)/(M+2S-2)                 O(S) (fused train loop)
interleaved (V)    (S-1)/(V*M+S-1)  [M >= S]      O(M) + V x more hops
zb (ZB-H1 split)   ~(S-1)/(2*(M+2S-2))            O(S) + deferred-W queue
=================  =============================  =======================

1F1B counts more total ticks than GPipe (M+2S-2 vs. M+S-1 because its
loop fuses forward and backward halves into single ticks) yet is
*strictly* less idle for every M and S>1 — each device sits exactly
``2s`` idle ticks out of M+2S-2 instead of ``S-1`` out of M+S-1 twice.
"""
import dataclasses
import os

import numpy as np

VALID_SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb")
_ENV_KNOB = "HVD_PIPE_SCHEDULE"


def resolve_schedule(schedule=None, virtual_stages=None):
    """Resolve the schedule name and virtual-stage count V.

    Precedence: explicit ``schedule`` argument, then the
    ``HVD_PIPE_SCHEDULE`` env knob (``--pipeline-schedule`` /
    ``params: pipeline-schedule:`` in launch configs), then ``gpipe``.
    ``interleaved`` accepts an inline V as ``interleaved:V`` (default 2);
    ``virtual_stages`` overrides it.
    """
    raw = schedule if schedule is not None else os.environ.get(_ENV_KNOB)
    raw = (raw or "gpipe").strip().lower()
    name, _, vtxt = raw.partition(":")
    if name not in VALID_SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {raw!r}: valid schedules are "
            f"gpipe, 1f1b, interleaved[:V], zb "
            f"({_ENV_KNOB} / --pipeline-schedule)")
    if vtxt and name != "interleaved":
        raise ValueError(
            f"pipeline schedule {raw!r}: only 'interleaved' takes a "
            f":V suffix")
    if virtual_stages is not None:
        v = int(virtual_stages)
    elif vtxt:
        v = int(vtxt)
    else:
        v = 2 if name == "interleaved" else 1
    if name == "interleaved":
        if v < 2:
            raise ValueError(
                f"interleaved schedule needs virtual_stages >= 2, got {v}")
    elif v != 1:
        raise ValueError(
            f"schedule {name!r} does not take virtual stages (got V={v}); "
            f"use schedule='interleaved:{v}'")
    return name, v


def schedule_label(name, virtual):
    """Categorical label recorded in the autotune CSV ``schedule``
    column (comma-free; '-' until a pipeline workload registers)."""
    return f"interleaved{virtual}" if name == "interleaved" else name


def suggest_n_microbatches(batch, m):
    """Nearest divisor of ``batch`` to the requested (invalid) ``m`` —
    used by the divisibility error so the fix is one copy-paste away."""
    divisors = [d for d in range(1, batch + 1) if batch % d == 0]
    return min(divisors, key=lambda d: (abs(d - m), -d))


def interleave_permutation(stages, virtual):
    """Host-side permutation mapping contiguous stage order to the
    interleaved device layout.

    ``stage_params`` arrive with leading dim S*V in *network order*
    (slice j feeds slice j+1). Device s must hold the non-contiguous
    slices {s, S+s, 2S+s, ...} so a P(axis) shard of the permuted array
    is exactly its V chunks: ``perm[s*V + k] = k*S + s``.
    """
    s_, v_ = int(stages), int(virtual)
    return np.array([k * s_ + s for s in range(s_) for k in range(v_)],
                    dtype=np.int64)


# ---------------------------------------------------------------------------
# Table builders. All return int32 numpy arrays of shape [T, S]; -1 = idle.
# ---------------------------------------------------------------------------


def _forward_tables(stages, n_microbatches, virtual):
    """Forward tables for the interleaved (V >= 2) scan.

    Virtual stage j = k*S + s (chunk k on device s) runs microbatch m at
    tick ``m + k*P + s`` with ``P = max(S, M)`` — collision-free on every
    device because two work items on device s would need microbatch
    indices P apart, and M <= P. The chunk-boundary hop (device S-1 ->
    device 0, wraparound ring) is produced at ``m+(k-1)*P+S-1`` but only
    consumed at ``m+k*P``: for P > S the activation waits ``P-S`` ticks
    in the consumer's microbatch-indexed inbox.
    """
    s_, m_, v_ = int(stages), int(n_microbatches), int(virtual)
    p_ = max(s_, m_)
    t_ = m_ + (v_ - 1) * p_ + s_ - 1  # last tick (M-1)+(V-1)P+(S-1), plus 1
    exec_mb = np.full((t_, s_), -1, dtype=np.int32)
    exec_chunk = np.zeros((t_, s_), dtype=np.int32)
    for k in range(v_):
        for m in range(m_):
            for s in range(s_):
                t = m + k * p_ + s
                assert exec_mb[t, s] < 0, "schedule collision"
                exec_mb[t, s] = m
                exec_chunk[t, s] = k
    # recv_mb[t, s]: microbatch whose activation arrives at device s at
    # the start of tick t (sent by ring predecessor at t-1); -1 = none.
    # The final virtual stage's output is recorded, not forwarded.
    recv_mb = np.full((t_, s_), -1, dtype=np.int32)
    for t in range(1, t_):
        for s in range(s_):
            prev = (s - 1) % s_
            pm, pk = exec_mb[t - 1, prev], exec_chunk[t - 1, prev]
            if pm < 0:
                continue
            j_send = pk * s_ + prev
            if j_send < s_ * v_ - 1:
                recv_mb[t, s] = pm
    return {"T": t_, "exec_mb": exec_mb, "exec_chunk": exec_chunk,
            "recv_mb": recv_mb}


def _onef1b_tables(stages, n_microbatches):
    """Fused 1F1B training tables: F(m) on stage s at tick ``s + m``,
    B(m) at tick ``2S-2-s + m`` — the backward wavefront runs the
    mirror-image slope so stage S-1 does F and B of the same microbatch
    in one tick (loss vjp seeds the reverse hop immediately)."""
    s_, m_ = int(stages), int(n_microbatches)
    t_ = m_ + 2 * s_ - 2
    f_mb = np.full((t_, s_), -1, dtype=np.int32)
    b_mb = np.full((t_, s_), -1, dtype=np.int32)
    for m in range(m_):
        for s in range(s_):
            f_mb[m + s, s] = m
            b_mb[2 * s_ - 2 - s + m, s] = m
    return {"T": t_, "f_mb": f_mb, "b_mb": b_mb}


def _zb_tables(stages, n_microbatches):
    """ZB-H1 tables: 1F1B with B split into Bx (dL/dx, stays on the 1F1B
    backward slot — the critical path) and Bw (dL/dw, deferred into the
    stage's idle ticks so weight-grad work fills the cooldown tail).

    Bw(m) goes to the earliest idle tick after its Bx; when a stage runs
    out of idle ticks (steady state has none) the remaining Bw co-locate
    with their own Bx tick, which degenerates to plain 1F1B for those
    microbatches — that is the honest limit of what one shape-stable
    ``lax.scan`` can express of ZB-H1, and exactly the half-bubble the
    paper's H1 variant claims: warmup idle (before any Bx exists) cannot
    be filled, cooldown idle can.
    """
    base = _onef1b_tables(stages, n_microbatches)
    s_, m_ = int(stages), int(n_microbatches)
    t_, f_mb, b_mb = base["T"], base["f_mb"], base["b_mb"]
    w_mb = np.full((t_, s_), -1, dtype=np.int32)
    for s in range(s_):
        idle = [t for t in range(t_)
                if f_mb[t, s] < 0 and b_mb[t, s] < 0]
        for m in range(m_):
            bx_t = 2 * s_ - 2 - s + m
            slot = next((t for t in idle if t > bx_t), None)
            if slot is None:
                w_mb[bx_t, s] = m          # co-located: plain 1F1B for m
            else:
                idle.remove(slot)
                w_mb[slot, s] = m
    # Reuse distance of the deferred (x, dy) ring buffer: slot m % Rw is
    # overwritten at Bx(m + Rw), so Rw must exceed the largest Bx->Bw gap.
    gap = 0
    for s in range(s_):
        for t in range(t_):
            m = w_mb[t, s]
            if m >= 0:
                gap = max(gap, t - (2 * s_ - 2 - s + m))
    return dict(base, w_mb=w_mb, w_ring=gap + 1)


# ---------------------------------------------------------------------------
# Occupancy accounting.
# ---------------------------------------------------------------------------


def _phases(busy):
    """(warmup, steady, cooldown) tick counts from a [T, S] busy mask:
    steady is the span at peak device occupancy."""
    occ = busy.sum(axis=1)
    peak = int(occ.max()) if occ.size else 0
    at_peak = np.flatnonzero(occ == peak)
    warmup = int(at_peak[0])
    cooldown = int(busy.shape[0] - 1 - at_peak[-1])
    return warmup, busy.shape[0] - warmup - cooldown, cooldown


@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """Tick accounting for one (schedule, S, M, V) — the measured side
    of the ideal-vs-measured split: ``bubble_fraction`` is counted from
    the occupancy of the very tables the scan compiles, ``ideal_bubble``
    is the closed form the docs quote."""
    schedule: str
    label: str
    stages: int
    n_microbatches: int
    virtual_stages: int
    ticks: int
    busy_slots: int
    total_slots: int
    bubble_fraction: float
    ideal_bubble: float
    warmup_ticks: int
    steady_ticks: int
    cooldown_ticks: int

    def as_dict(self):
        return dataclasses.asdict(self)


def schedule_info(schedule, stages, n_microbatches, virtual_stages=None):
    """Build :class:`ScheduleInfo` for a schedule by counting occupied
    device-tick slots in its tables (training accounting: forward-only
    schedules mirror their forward table for the autodiff backward)."""
    name, v = resolve_schedule(schedule, virtual_stages)
    s_, m_ = int(stages), int(n_microbatches)
    if name in ("gpipe", "interleaved"):
        if name == "gpipe":
            t1 = m_ + s_ - 1
            fbusy = np.zeros((t1, s_), dtype=bool)
            for m in range(m_):
                for s in range(s_):
                    fbusy[m + s, s] = True
        else:
            tab = _forward_tables(s_, m_, v)
            fbusy = tab["exec_mb"] >= 0
        # Autodiff runs the transposed schedule: same occupancy, mirrored.
        busy = np.concatenate([fbusy, fbusy[::-1]], axis=0)
        ideal = ((s_ - 1) / (v * m_ + s_ - 1) if name == "interleaved"
                 else (s_ - 1) / (m_ + s_ - 1))
    elif name == "1f1b":
        tab = _onef1b_tables(s_, m_)
        busy = (tab["f_mb"] >= 0) | (tab["b_mb"] >= 0)
        ideal = (s_ - 1) / max(1, m_ + 2 * s_ - 2)
    else:  # zb
        tab = _zb_tables(s_, m_)
        busy = (tab["f_mb"] >= 0) | (tab["b_mb"] >= 0) | (tab["w_mb"] >= 0)
        ideal = (s_ - 1) / max(1, 2 * (m_ + 2 * s_ - 2))
    t_ = int(busy.shape[0])
    busy_slots = int(busy.sum())
    total = t_ * s_
    warm, steady, cool = _phases(busy)
    return ScheduleInfo(
        schedule=name, label=schedule_label(name, v), stages=s_,
        n_microbatches=m_, virtual_stages=v, ticks=t_,
        busy_slots=busy_slots, total_slots=total,
        bubble_fraction=1.0 - busy_slots / total, ideal_bubble=ideal,
        warmup_ticks=warm, steady_ticks=steady, cooldown_ticks=cool)
