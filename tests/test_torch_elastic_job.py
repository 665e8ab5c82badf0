"""Elastic jobs of the port through its own launcher (``python -m
horovod_tpu_torch.runner.launch --min-np ...``), gloo on the CPU, with
workers from tests/workers/torch_elastic_worker.py. The only port test
file that spawns processes.

Every job runs through ``graft_entry._run_job``: a subprocess timeout of
its own (at most 90 s), after which the launcher gets SIGTERM (it
terminates its workers, each in a session of its own) and then its
session SIGKILL; and every worker pid (each worker writes its own) must
be gone when the job ends, so no process outlives a test.

- Failure recovery: two ranks of ``tiny`` float32 under
  ``make_train_step`` with AdamW in a ``TorchState``; the worker in slot
  1 ``os._exit(1)``s at iteration 3. The survivor rolls back to its last
  commit, the driver respawns the slot, the new epoch syncs from rank 0,
  and both finishers end at iteration 6 with params equal to each other
  and to an uninterrupted 6-step run over gloo threads in this process
  (the step test_torch_data_parallel.py holds to JAX), within 1e-6: the
  same per-row gradients, reduced in the same order.
- The gloo port of the chaos kill cell (tests/test_chaos.py:100): four
  ranks, ``HVD_CKPT_TEST_CRASH`` on the checkpoint writer; every
  finisher restores the committed step 1 on recovery, the retried step 2
  commits (``latest_step == 2``), and the survivors leave the shards
  barrier when the driver publishes the next epoch, within 10 s, where
  the store's timeout is 120 s.
- Hot-spare promotion: ``graft_entry._spare_promotion_exercise`` (two
  ranks and a parked spare; the driver logs the promotion; parity ok).
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu_torch import checkpoint, graft_entry  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    make_train_step, shard_batch, tree_flatten_with_path, tree_leaves)

from .workers import torch_elastic_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 90


@pytest.fixture(autouse=True)
def _not_elastic(monkeypatch):
    """The jobs' environment comes from the test, not an outer job."""
    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)


def _job(tmp_path, mode, np_, max_np, extra_env=None):
    """Run one elastic job; returns (rc, launcher output, log lines)."""
    log = tmp_path / "log"
    env = dict(os.environ)
    env.update({"PYTHONPATH": ROOT, "TEST_MODE": mode,
                "TEST_LOG": str(log), "TEST_PIDS": str(tmp_path / "pids"),
                "TEST_MARKER": str(tmp_path / "marker")})
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--min-np", "2", "--max-np", str(max_np),
           "--host-discovery-script", f"echo localhost:{np_}",
           "--blacklist-cooldown-range", "2", "5", "--verbose",
           sys.executable, os.path.join(ROOT, "tests", "workers",
                                        "torch_elastic_worker.py")]
    rc, out = graft_entry._run_job(cmd, env, TIMEOUT, str(tmp_path / "pids"))
    lines = log.read_text().splitlines() if log.exists() else []
    return rc, out, lines


def _uninterrupted(n, iters):
    """The same steps with no failure: n gloo thread ranks."""
    def rank(world):
        params = worker.init_params()
        opt = torch.optim.AdamW(
            [x.requires_grad_() for x in tree_leaves(params)],
            **worker.ADAMW)
        step = make_train_step(
            lambda p, b: tfm.loss_fn(p, b, worker.CFG), opt, world.group)
        for i in range(iters):
            step(params, shard_batch(worker.batch(i), world.group))
        return {p: x.detach().numpy().copy()
                for p, x in tree_flatten_with_path(params)}

    return graft_entry._on_ranks(n, rank, timeout=60)


def test_failure_recovery_matches_uninterrupted_run(tmp_path):
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    rc, out, lines = _job(tmp_path, "recover", 2, 2,
                          {"TEST_ITERS": "6", "TEST_CRASH_ITER": "3",
                           "TEST_OUT": str(out_dir)})
    assert rc == 0, out[-3000:]
    assert (tmp_path / "marker").exists(), "the failure was never injected"
    assert "FAILED rc=1" in out and "epoch 1:" in out, out[-3000:]
    finals = sorted(ln for ln in lines if ln.startswith("final"))
    assert finals == ["final rank=0 size=2 iter=6",
                      "final rank=1 size=2 iter=6"], (lines, out[-3000:])
    got = [dict(np.load(out_dir / f"rank{r}.npz")) for r in (0, 1)]
    want = _uninterrupted(2, 6)
    for name, ref in want[0].items():
        np.testing.assert_array_equal(got[0][name], got[1][name], name)
        np.testing.assert_allclose(got[0][name], ref, rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(want[1][name], ref, name)


def test_chaos_kill_writer_mid_save(tmp_path):
    ckdir = tmp_path / "ck"
    rc, out, lines = _job(tmp_path, "ckpt", 4, 4,
                          {"TEST_ITERS": "6", "CKPT_DIR": str(ckdir)})
    assert rc == 0, out[-3000:]
    assert (tmp_path / "marker").exists(), "the writer never crashed"
    assert "FAILED rc=-9" in out, out[-3000:]
    finals = [ln for ln in lines if ln.startswith("final")]
    assert len(finals) == 4, (lines, out[-3000:])
    assert all("iter=6" in ln and "parity=ok" in ln and "ckpt=1" in ln
               for ln in finals), lines
    left = [float(ln.rsplit("after=", 1)[1]) for ln in lines
            if ln.startswith("left")]
    assert len(left) == 3 and max(left) < 10.0, lines
    assert checkpoint.latest_step(ckdir) == 2


def test_spare_promotion_exercise():
    finals = graft_entry._spare_promotion_exercise(timeout=TIMEOUT)
    assert sorted(finals) == ["final rank=0 size=2 parity=ok",
                              "final rank=1 size=2 parity=ok"]
