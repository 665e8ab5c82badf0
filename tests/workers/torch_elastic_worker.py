"""An elastic worker of the port (horovod_tpu_torch), launched by the
port's launcher (``python -m horovod_tpu_torch.runner.launch --min-np
...``) from tests/test_torch_elastic_job.py, on the CPU over gloo.

``TEST_MODE``:

- ``recover``: ``tiny`` float32 through ``make_train_step`` with AdamW,
  in a ``TorchState`` (params tree, optimizer, iteration) under
  ``elastic.run``; iteration i trains on ``batch(i)``, each rank on its
  rows. The worker in slot 1 ``os._exit(1)``s at iteration
  ``TEST_CRASH_ITER``, once (a marker file guards it: its replacement
  is spawned in the same slot). Each finisher writes its params to
  ``TEST_OUT/rank<r>.npz`` and a ``final`` line to ``TEST_LOG``.
- ``ckpt``: the port of tests/workers/ckpt_chaos_worker.py. Every rank
  saves step 1 at iteration 1; at iteration 3 the set root arms
  ``HVD_CKPT_TEST_CRASH=2`` once, and checkpoint.py SIGKILLs it after
  its shards are durable and before the shards barrier. The survivors
  must leave that barrier when the driver publishes the next epoch
  (their wait goes to ``TEST_LOG`` as a ``left`` line), restore the
  committed step 1 through ``elastic.restore_from_checkpoint`` and
  retry step 2.

Every process appends its pid to ``TEST_PIDS`` first, so the test can
make sure none outlives it. The test imports ``CFG``, ``ADAMW``,
``init_params`` and ``batch`` for its uninterrupted run.
"""

import dataclasses
import os
import time

import numpy as np
import torch

torch.set_num_threads(1)

import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint, elastic  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    make_train_step, shard_batch, tree_flatten_with_path, tree_leaves)

ITERS = int(os.environ.get("TEST_ITERS", "6"))
MARKER = os.environ.get("TEST_MARKER")
LOG = os.environ.get("TEST_LOG")
WID = os.environ.get("HVD_WORKER_ID", "?")
IN_SLOT_1 = WID.startswith("localhost-1-")

CFG = dataclasses.replace(tfm.tiny(), dtype="float32", attn_impl="gather")
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def init_params():
    return tfm.init_params(CFG, torch.Generator().manual_seed(3),
                           device="cpu")


def batch(i):
    """Iteration i's global batch: 4 rows of 17 tokens."""
    rng = np.random.default_rng(100 + i)
    return {"tokens": torch.from_numpy(
        rng.integers(0, CFG.vocab_size, (4, 17)).astype(np.int64))}


def log(line):
    with open(LOG, "a") as f:
        f.write(line + "\n")


def run_recover():
    params = init_params()
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    opt = torch.optim.AdamW(leaves, **ADAMW)
    state = elastic.TorchState(params=params, optimizer=opt, iteration=0)

    @elastic.run
    def train(state):
        group = hvd.global_process_set.group    # this epoch's
        step = make_train_step(lambda p, b: tfm.loss_fn(p, b, CFG), opt,
                               group)
        while state.iteration < ITERS:
            i = state.iteration
            if (i == int(os.environ["TEST_CRASH_ITER"]) and IN_SLOT_1
                    and not os.path.exists(MARKER)):
                with open(MARKER, "w") as f:
                    f.write(WID)
                os._exit(1)
            step(state.params, shard_batch(batch(i), group))
            state.iteration += 1
            state.commit()
        return hvd.rank(), hvd.size()

    rank, size = train(state)
    np.savez(os.path.join(os.environ["TEST_OUT"], f"rank{rank}.npz"),
             **{p: x.detach().numpy()
                for p, x in tree_flatten_with_path(state.params)})
    log(f"final rank={rank} size={size} iter={state.iteration}")


def run_ckpt():
    ckdir = os.environ["CKPT_DIR"]
    save_iter, crash_iter = 1, 3
    last_restored = [None]
    state = elastic.ObjectState(iteration=0)

    def tree(step):
        return {"w": np.full(4, float(step), np.float32),
                "iteration": np.asarray(int(state.iteration), np.int64)}

    @elastic.run
    def train(state):
        like = {"w": np.zeros(4, np.float32),
                "iteration": np.asarray(0, np.int64)}
        out, st = elastic.restore_from_checkpoint(like, directory=ckdir)
        last_restored[0] = st
        if st is not None:
            assert np.array_equal(out["w"],
                                  np.full(4, float(st), np.float32)), st
            # A respawned rank 0 adopts the checkpoint's progress before
            # state.sync() broadcasts its dict.
            state.iteration = max(int(state.iteration),
                                  int(out["iteration"]))
        while state.iteration < ITERS:
            it = int(state.iteration)
            if it == save_iter:
                checkpoint.save(ckdir, 1, tree(1))
            if it == crash_iter:
                if not os.path.exists(MARKER) and hvd.rank() == 0:
                    with open(MARKER, "w") as f:
                        f.write(WID)
                    os.environ["HVD_CKPT_TEST_CRASH"] = "2"
                elif os.path.exists(MARKER):
                    # The torn step-2 attempt left step 1 newest.
                    assert checkpoint.latest_step(ckdir) == 1, \
                        checkpoint.latest_step(ckdir)
                t0 = time.monotonic()
                try:
                    checkpoint.save(ckdir, 2, tree(2))
                except hvd.HorovodInternalError:
                    log(f"left rank={hvd.rank()} "
                        f"after={time.monotonic() - t0:.2f}")
                    raise
            hvd.allreduce(torch.ones(4), op=hvd.Sum)
            state.iteration += 1
            state.commit()
        return hvd.rank(), hvd.size()

    rank, size = train(state)
    check = hvd.allreduce(torch.ones(2), op=hvd.Sum)
    parity = "ok" if torch.allclose(check, torch.full((2,), float(size))) \
        else f"BAD({check[0]})"
    log(f"final rank={rank} size={size} iter={state.iteration} "
        f"ckpt={last_restored[0]} parity={parity}")


if __name__ == "__main__":
    with open(os.environ["TEST_PIDS"], "a") as f:
        f.write(f"{os.getpid()}\n")
    hvd.init(device="cpu")
    {"recover": run_recover, "ckpt": run_ckpt}[os.environ["TEST_MODE"]]()
    hvd.shutdown()
