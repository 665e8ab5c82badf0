"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``csrc/build/lib<name>-<hash>.so`` (the hash is of the
source and of the shared ``csrc/*.cuh`` headers, so an edited kernel
rebuilds), then loaded with ``ctypes``. One library may hold several
kernels (``flash_bwd`` holds dQ and dK/dV). No PyTorch header is
compiled, which keeps a build to seconds.

Builds are serialized across processes by an ``flock`` on
``csrc/build/.lock``, acquired with a bounded wait
(``HVD_BUILD_LOCK_TIMEOUT`` seconds, default 600): a holder that outlives
the wait is wedged, not building, and the caller gets an error instead
of a hang. :func:`build` starts one ``nvcc`` per missing library, all at
once, so several kernels build in parallel.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ on the machine with the card")


def _lib_path(name):
    h = hashlib.sha256()
    for src in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _acquire(fd, timeout):
    deadline = time.monotonic() + timeout
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except OSError:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"gave up after {timeout:.0f}s waiting for "
                    f"{BUILD_DIR}/.lock (held by another, possibly "
                    f"orphaned, build)") from None
            time.sleep(0.2)


def build(names):
    """Compile every ``csrc/<name>.cu`` whose library is missing, all in
    parallel; returns ``{name: seconds}`` for the ones compiled (the
    compiler's ``-Xptxas -v`` report is kept beside each library as
    ``.log``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    timeout = float(os.environ.get("HVD_BUILD_LOCK_TIMEOUT", "600"))
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        _acquire(lock, timeout)
        procs = {}
        t0 = time.monotonic()
        for name in names:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(out[:-3] + ".log", "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, name + ".cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
        took, failed = {}, []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            took[name] = time.monotonic() - t0
            if rc != 0:
                failed.append(f"{name} (nvcc rc={rc}, see {log.name})")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + ", ".join(failed))
        return took


def load(name):
    """ctypes handle on ``lib<name>``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib


def build_log(name):
    """The compiler's report for ``lib<name>`` (registers, shared memory,
    spills), or '' when it was not built in this checkout."""
    path = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
