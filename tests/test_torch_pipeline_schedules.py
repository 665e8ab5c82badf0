"""The port's copy of the pipeline schedule tables
(horovod_tpu_torch/parallel/schedules.py) against the JAX package's
(horovod_tpu/parallel/schedules.py), numpy only.

Every table the builders return and every ``schedule_info`` field are
equal over a grid of stage counts S, microbatch counts M and virtual
stages V; the knob parsing, labels, microbatch suggestion and the
interleave permutation agree; the ZB plan (and its fallback reasons) of
the port's pipeline module is the reference's. The reference module is
loaded on its own, without the JAX package's ``parallel/__init__``
(which imports jax), as tests/test_pipeline_schedules.py loads it.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from horovod_tpu_torch.parallel import schedules as tsched  # noqa: E402

from .util import _REPO  # noqa: E402


def _load_reference():
    path = os.path.join(_REPO, "horovod_tpu", "parallel", "schedules.py")
    spec = importlib.util.spec_from_file_location("reference_schedules",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsched = _load_reference()

GRID = [(s, m) for s in (1, 2, 3, 4, 8) for m in (1, 2, 3, 4, 5, 8, 16)]
SCHEDULES = [("gpipe", None), ("1f1b", None), ("zb", None),
             ("interleaved", 2), ("interleaved", 3), ("interleaved", 4)]


def _same_tables(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("name,v", SCHEDULES,
                         ids=[f"{n}{v or ''}" for n, v in SCHEDULES])
def test_schedule_info_equals_reference(name, v):
    for s, m in GRID:
        got = tsched.schedule_info(name, s, m, v).as_dict()
        want = jsched.schedule_info(name, s, m, v).as_dict()
        assert got == want, (name, v, s, m)


@pytest.mark.parametrize("v", [2, 3, 4])
def test_forward_tables_equal_reference(v):
    for s, m in GRID:
        _same_tables(tsched._forward_tables(s, m, v),
                     jsched._forward_tables(s, m, v))


def test_onef1b_and_zb_tables_equal_reference():
    for s, m in GRID:
        _same_tables(tsched._onef1b_tables(s, m), jsched._onef1b_tables(s, m))
        _same_tables(tsched._zb_tables(s, m), jsched._zb_tables(s, m))


def test_phases_and_permutation_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        busy = rng.random((int(rng.integers(1, 12)),
                           int(rng.integers(1, 5)))) < 0.6
        busy[int(rng.integers(0, busy.shape[0]))] = True
        assert tsched._phases(busy) == jsched._phases(busy)
    for s in range(1, 9):
        for v in range(1, 5):
            np.testing.assert_array_equal(
                tsched.interleave_permutation(s, v),
                jsched.interleave_permutation(s, v))


@pytest.mark.parametrize("raw", [None, "gpipe", "1f1b", "zb", "interleaved",
                                 "interleaved:3", " Interleaved:4 ",
                                 "bogus", "gpipe:2", "interleaved:1", "zb:1"])
@pytest.mark.parametrize("virtual", [None, 1, 2])
def test_resolve_schedule_equals_reference(raw, virtual, monkeypatch):
    monkeypatch.setenv("HVD_PIPE_SCHEDULE", "1f1b")   # the knob, for None

    def outcome(mod):
        try:
            return mod.resolve_schedule(raw, virtual)
        except ValueError as e:
            return str(e)

    assert outcome(tsched) == outcome(jsched)


def test_labels_and_suggestion_equal_reference():
    for name in tsched.VALID_SCHEDULES:
        for v in (1, 2, 4):
            assert (tsched.schedule_label(name, v)
                    == jsched.schedule_label(name, v))
    for batch in range(1, 40):
        for m in range(1, 12):
            assert (tsched.suggest_n_microbatches(batch, m)
                    == jsched.suggest_n_microbatches(batch, m))
    assert tsched.VALID_SCHEDULES == jsched.VALID_SCHEDULES


def test_zb_plan_equals_reference_plan():
    """The port's ``_plan_zb`` returns the reference tables where the
    split can be made and ``single_stage`` at one stage, as the
    reference's (horovod_tpu/parallel/pipeline.py ``_plan_zb``, which is
    the same code over these tables)."""
    for s, m in GRID:
        tabs, reason = tpipe._plan_zb(s, m)
        if s < 2:
            assert tabs is None and reason == "single_stage"
            continue
        assert reason is None
        _same_tables(tabs, jsched._zb_tables(s, m))
