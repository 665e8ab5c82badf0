"""Queue-depth-driven autoscale policy for the serving plane: the port's
copy of ``horovod_tpu/serving/autoscale.py``, the same in behaviour.

Pure Python (no torch, no sockets): the policy is a fold over load
observations, so tests drive it with synthetic sequences.

Wiring:

- Rank 0 of the serve loop's decision group publishes ``{queue_depth,
  batch_fill, kv_occupancy}`` to the elastic driver's KV store at
  ``/ctl/serve_load/<worker id>`` every ``report_interval`` boundaries
  (``ServeLoop(load_reporter=runner.elastic.worker.report_serve_load)``).
- The elastic driver (``tpurun --serve-autoscale``) consumes those keys
  in its main loop, feeds them here, and when the target changes
  publishes a new epoch whose ACTIVE set is capped at the target.
  Scale-up promotes workers parked as spares (already rendezvoused and
  heartbeating), so "queue too deep" to "more ranks decoding" is one
  incremental epoch, not a cold spawn; scale-down parks the excess
  workers as spares instead of exiting them.

Hysteresis: a scale decision needs ``patience`` CONSECUTIVE
observations on the same side of the band. A Poisson arrival process
crosses any threshold constantly; without the dwell the fleet would
thrash epochs (each epoch is a re-rendezvous the whole job pays for).
"""

DEFAULT_HIGH_DEPTH = 8      # queue deeper than this wants more ranks
DEFAULT_LOW_DEPTH = 1       # queue at/below this with slack wants fewer
DEFAULT_LOW_FILL = 0.5      # ...but only when the batch is half idle
DEFAULT_PATIENCE = 3        # consecutive observations before acting


class AutoscalePolicy:
    """Fold load observations into a target world size.

    ``observe`` returns the NEW target when a resize is warranted, else
    None. Targets move one rank at a time (each resize is an epoch; big
    jumps are better paced than batched) and clamp to [min_np, max_np].
    """

    def __init__(self, min_np, max_np, high_depth=DEFAULT_HIGH_DEPTH,
                 low_depth=DEFAULT_LOW_DEPTH, low_fill=DEFAULT_LOW_FILL,
                 patience=DEFAULT_PATIENCE):
        if max_np < min_np:
            raise ValueError(f"max_np {max_np} < min_np {min_np}")
        if high_depth <= low_depth:
            raise ValueError(f"high_depth {high_depth} must exceed "
                             f"low_depth {low_depth} (hysteresis band)")
        self.min_np = int(min_np)
        self.max_np = int(max_np)
        self.high_depth = int(high_depth)
        self.low_depth = int(low_depth)
        self.low_fill = float(low_fill)
        self.patience = max(1, int(patience))
        self.target = self.min_np
        self._up_streak = 0
        self._down_streak = 0

    def observe(self, queue_depth, batch_fill):
        """One load sample -> new target np, or None (hold)."""
        if queue_depth > self.high_depth:
            self._up_streak += 1
            self._down_streak = 0
        elif queue_depth <= self.low_depth and batch_fill < self.low_fill:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if self._up_streak >= self.patience and self.target < self.max_np:
            self.target += 1
            self._up_streak = 0
            return self.target
        if (self._down_streak >= self.patience
                and self.target > self.min_np):
            self.target -= 1
            self._down_streak = 0
            return self.target
        return None
