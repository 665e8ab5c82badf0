"""Profiler ranges around user-facing op calls: the port of
``horovod_tpu/profiler.py``, the mapping of Horovod's NVTX integration
(``horovod/common/nvtx_op_range.h``: an ``NvtxOpRange`` around every
API-level collective call, so that an nsys trace shows where the
framework's time goes) onto the card it was written for.

- :func:`start` / :func:`stop` open and close a ``torch.profiler`` window
  over the CPU, and over CUDA when a card is present; :func:`stop`
  writes a Chrome trace (``*.pt.trace.json``) that Perfetto and
  TensorBoard read into the window's ``logdir``.
- :func:`op_range` wraps the Horovod API's collectives
  (:mod:`horovod_tpu_torch.ops.torch_ops`) in ranges named
  ``hvd.<op>``: a ``torch.profiler.record_function`` range, plus an NVTX
  range when the call's tensors are on CUDA.

Ranges are OFF unless ``HVD_PROFILER=1`` is set or :func:`start` has
been called: then :func:`op_range` is one flag check that returns a
shared ``contextlib.nullcontext()``, with no clock read and no profiler
import.
"""

import contextlib
import os

_enabled = os.environ.get("HVD_PROFILER", "0") == "1"
_active = None      # (torch.profiler.profile, logdir) of the open window

_NOOP = contextlib.nullcontext()


def enabled():
    return _enabled


def start(logdir):
    """Open a trace window whose trace :func:`stop` writes into ``logdir``
    (created if missing). Enables op ranges for the rest of the process.
    The window records every thread's ops and ranges where this torch
    offers it (``profile_all_threads``), so that ranks run as threads of
    one process all show. Returns ``logdir`` as a string."""
    global _enabled, _active
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _active is not None:
        raise RuntimeError(f"a trace window is already open at "
                           f"{_active[1]}")
    logdir = str(logdir)
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=_all_threads())
    prof.start()
    _enabled = True
    _active = (prof, logdir)
    return logdir


def _all_threads():
    """A config that records every thread, or None where this torch has
    no such option."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def stop():
    """Close the window :func:`start` opened and write its trace into its
    logdir. Returns the ``torch.profiler.profile`` (its
    ``key_averages()``, and ``trace_path``, the file written)."""
    global _active
    if _active is None:
        raise RuntimeError("no trace window is open")
    prof, logdir = _active
    _active = None
    prof.stop()
    n = sum(1 for f in os.listdir(logdir) if f.endswith(".pt.trace.json"))
    prof.trace_path = os.path.join(
        logdir, f"hvd.{os.getpid()}.{n}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)
    return prof


def op_range(name, cuda=False):
    """Context manager marking one user-facing op call (the reference's
    ``NVTX_OP_RANGE``); ``cuda``: the call's tensors are on the card,
    which adds an NVTX range. A shared no-op when profiling is off."""
    if not _enabled:
        return _NOOP
    return _range(name, cuda)


@contextlib.contextmanager
def _range(name, cuda):
    import torch

    with torch.profiler.record_function(name):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
