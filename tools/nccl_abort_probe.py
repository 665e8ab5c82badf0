#!/usr/bin/env python3
"""What an NCCL process group does when it is aborted or shut down, on
one CUDA card: the time ``abort()`` (or ``shutdown()``) takes on a group
that has run an all-reduce, what the next all-reduce on it raises, and
the time a new group's first all-reduce takes. The elastic reset of
``horovod_tpu_torch`` (``distributed.teardown``) relies on the error.

    python3 tools/nccl_abort_probe.py

Each case runs in a process of its own, with a 90 s limit: a store
shared by a ``HashStore``, or a ``TCPStore`` hosted by another object
in the process and joined as a client (the elastic driver's layout).
Prints the card's name and power limit first; exits 2 without a card.
"""

import datetime
import subprocess
import sys
import time


def case(kind):
    import socket

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = datetime.timedelta(seconds=15)
    store, keep = dist.HashStore(), None
    if kind.startswith("tcp"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        keep = dist.TCPStore("127.0.0.1", port, None, True,
                             timeout=opts._timeout, wait_for_workers=False)
        store = dist.TCPStore("127.0.0.1", port, None, False,
                              timeout=opts._timeout)
    pg = dist.ProcessGroupNCCL(dist.PrefixStore("a", store), 0, 1, opts)
    x = torch.ones(4, device="cuda")
    pg.allreduce([x]).wait()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    getattr(pg, "abort" if kind.endswith("abort") else "shutdown")()
    print(f"{kind}: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    try:
        pg.allreduce([x]).wait()
        torch.cuda.synchronize()
        print("next all-reduce: no error", flush=True)
    except RuntimeError as e:
        print(f"next all-reduce raised {type(e).__name__}: "
              f"{str(e).strip()[:200]}", flush=True)
    t0 = time.perf_counter()
    pg2 = dist.ProcessGroupNCCL(dist.PrefixStore("b", store), 0, 1, opts)
    pg2.allreduce([torch.ones(4, device="cuda")]).wait()
    torch.cuda.synchronize()
    print(f"a new group's first all-reduce: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    pg2.abort()
    del keep


def main():
    import torch

    if not torch.cuda.is_available():
        print("nccl_abort_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    rc = 0
    for kind in ("hash-abort", "hash-shutdown", "tcp-abort"):
        try:
            p = subprocess.run([sys.executable, __file__, kind],
                               capture_output=True, text=True, timeout=90)
            print(f"== {kind} (rc {p.returncode})\n{p.stdout.strip()}",
                  flush=True)
            rc |= p.returncode
        except subprocess.TimeoutExpired:
            print(f"== {kind}: did not end in 90 s", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        case(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
