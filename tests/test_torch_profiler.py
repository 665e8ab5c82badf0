"""The port's profiler ranges (horovod_tpu_torch/profiler.py), the
counterpart of tests/test_core_polish.py's profiler test, in one
process:

- off by default: ``op_range`` is one shared ``nullcontext`` and the
  Horovod ops never enter a range;
- ``HVD_PROFILER=1`` (set, then the module reloaded) turns the ranges on;
- ``start(logdir)`` / ``stop()`` write a Chrome trace into ``logdir``;
- over a 2-rank gloo world in threads (a window over every thread), the
  trace holds one ``hvd.<op>`` range for each call of the Horovod API
  (and of a ``DistributedOptimizer`` step's reduction).
"""

import contextlib
import importlib
import json

import pytest
import torch

torch.set_num_threads(1)

import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch import profiler  # noqa: E402

from .torch_train_parity import run_worlds  # noqa: E402


@pytest.fixture
def fresh(monkeypatch):
    """The profiler module as a process without ``HVD_PROFILER`` sees it,
    and as it was again after the test."""
    monkeypatch.delenv("HVD_PROFILER", raising=False)
    importlib.reload(profiler)
    yield monkeypatch
    monkeypatch.delenv("HVD_PROFILER", raising=False)
    importlib.reload(profiler)


def _ones_allreduce():
    hvd.init(device="cpu")
    try:
        return hvd.allreduce(torch.ones(2))
    finally:
        hvd.shutdown()


def test_disabled_is_one_shared_noop(fresh):
    assert not profiler.enabled()
    a, b = profiler.op_range("hvd.allreduce"), profiler.op_range("x", True)
    assert a is b and isinstance(a, contextlib.nullcontext)

    def entered(*args):
        raise AssertionError("a range was entered with profiling off")

    fresh.setattr(profiler, "_range", entered)
    assert torch.equal(_ones_allreduce(), torch.ones(2))


def test_env_turns_ranges_on(fresh):
    fresh.setenv("HVD_PROFILER", "1")
    importlib.reload(profiler)
    assert profiler.enabled()
    r = profiler.op_range("hvd.allreduce")
    assert not isinstance(r, contextlib.nullcontext)
    with r:
        torch.ones(1).add_(1)


def test_start_stop_write_a_trace(fresh, tmp_path):
    assert profiler.start(tmp_path / "trace") == str(tmp_path / "trace")
    assert profiler.enabled()
    with pytest.raises(RuntimeError, match="already open"):
        profiler.start(tmp_path)
    _ones_allreduce()
    prof = profiler.stop()
    names = [e.get("name") for e in
             json.loads(open(prof.trace_path).read())["traceEvents"]]
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    assert prof.trace_path.endswith(".pt.trace.json")
    assert names.count("hvd.allreduce") == 1
    with pytest.raises(RuntimeError, match="no trace window"):
        profiler.stop()


# hvd.<name>: the calls each rank makes
CALLS = {
    "allreduce": 2,
    "allgather": 1,
    "broadcast": 1,
    "grouped_allreduce": 2,    # allreduce_pytree and the optimizer's step
    "alltoall": 1,
    "reducescatter": 1,
    "barrier": 1,
}


def test_trace_holds_a_range_per_call(fresh, tmp_path):
    def rank(world):
        ps = hvd.ProcessSet.from_world(world)
        x = torch.full((4,), float(world.rank + 1))
        hvd.allreduce(x, process_set=ps)
        hvd.allreduce(x, op=hvd.Sum, process_set=ps)
        hvd.allgather(x[None], process_set=ps)
        hvd.broadcast(x, root_rank=0, process_set=ps)
        hvd.allreduce_pytree({"a": x, "b": [x * 2]}, process_set=ps)
        hvd.alltoall(x, process_set=ps)
        hvd.reducescatter(x, process_set=ps)
        hvd.barrier(process_set=ps)
        w = torch.zeros(3, requires_grad=True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       process_set=ps)
        (w * (world.rank + 1)).sum().backward()
        opt.step()
        return w.detach()

    profiler.start(tmp_path)
    try:
        ws = run_worlds(2, rank)
    finally:
        prof = profiler.stop()
    assert all(torch.allclose(w, torch.full((3,), -0.15)) for w in ws)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    names = [e.get("name") for e in events]
    for op, n in CALLS.items():
        assert names.count(f"hvd.{op}") == 2 * n, op
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["hvd.allreduce"] == 4
