"""`tpurun` — the launcher CLI (reference: `horovodrun`,
`horovod/runner/launch.py` `run_commandline`/`parse_args`/`_run`): the
port's copy of ``horovod_tpu/runner/launch.py``, on this host only.

Static launch: parse hosts → assign ranks → export slot env (HVD_RANK...,
HVD_JAX_COORD_ADDR at the store rank 0 hosts) → spawn one process per
slot, kill all on any failure. Elastic launch (min-np/max-np + discovery)
lives in `horovod_tpu_torch.runner.elastic` and is selected the same way
the reference does it: presence of --min-np/--max-np/--host-discovery-
script; ``--serve-autoscale`` resizes an elastic job's active set from
the serve loop's load. The reference's flags for the tunables of its C++
core (fusion, wire, shm, timeline, autotune, ...), which nothing in the
port reads, and for remote spawn (ssh, LSF) are refused: a remote host
is ROADMAP Queue A item 16c.

Usage:
    python -m horovod_tpu_torch.runner.launch -np 4 python train.py
    python -m horovod_tpu_torch.runner.launch --min-np 1 --max-np 2 \
        --host-discovery-script "echo localhost:2" python train.py
"""

import argparse
import os
import signal
import sys

from . import config_parser, hosts as hosts_mod
from .local import find_free_port, slot_env
from .util import safe_exec, terminate


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch a horovod_tpu_torch job: one process per "
                    "slot/card, on this host.")
    p.add_argument("-np", "--num-proc", dest="np", type=int,
                   help="total number of processes (default: all slots)")
    p.add_argument("-H", "--hosts", dest="hosts",
                   help='host list, e.g. "localhost:4" (default '
                        'localhost with -np slots; only this host)')
    p.add_argument("--hostfile", dest="hostfile",
                   help="file with one 'host slots=N' per line")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", dest="config_file")
    # tunables (config_parser maps these to HVD_* env)
    p.add_argument("--bucket", dest="bucket", type=int, choices=[0, 1],
                   default=None,
                   help="backprop-ordered gradient bucketing (HVD_BUCKET): "
                        "1 turns it on, 0 off")
    p.add_argument("--bucket-bytes", dest="bucket_bytes", type=int,
                   default=None,
                   help="gradient bucket size bound in bytes "
                        "(HVD_BUCKET_BYTES, default 32 MiB): allreduces "
                        "are grouped into buckets of at most this many "
                        "payload bytes in backward-completion order")
    p.add_argument("--ep-capacity-factor", dest="ep_capacity_factor",
                   type=float, default=None,
                   help="expert-parallel router capacity factor "
                        "(HVD_EP_CAPACITY_FACTOR, default 1.25): "
                        "per-expert buffer slots = factor * tokens / "
                        "experts for moe_dispatch_combine when no "
                        "explicit capacity is passed; overflow tokens "
                        "are dropped and counted in hvd.ep_stats()")
    p.add_argument("--pipeline-schedule", dest="pipeline_schedule",
                   default=None,
                   help="pipeline-parallel microbatch schedule "
                        "(HVD_PIPE_SCHEDULE): gpipe (the default), 1f1b, "
                        "interleaved[:V] (V virtual stage slices per "
                        "rank), or zb")
    p.add_argument("--no-stall-check", dest="no_stall_check",
                   action="store_true",
                   help="turn the stall inspector's warning and shutdown "
                        "off (both thresholds 0)")
    p.add_argument("--stall-check-warning-time-seconds",
                   dest="stall_check_warning_time_seconds", type=int,
                   default=None,
                   help="stall inspector: warn about an op that made no "
                        "progress for this long (HVD_STALL_CHECK_TIME_"
                        "SECONDS, default 60; needs --metrics)")
    p.add_argument("--stall-check-shutdown-time-seconds",
                   dest="stall_check_shutdown_time_seconds", type=int,
                   default=None,
                   help="stall inspector: the next Horovod op raises "
                        "StallError once an op stalled this long "
                        "(HVD_STALL_SHUTDOWN_TIME_SECONDS, default off)")
    p.add_argument("--metrics", dest="metrics", action="store_true",
                   default=None,
                   help="enable the observability metrics registry, spans "
                        "and the stall inspector (HVD_METRICS)")
    p.add_argument("--metrics-port", dest="metrics_port", type=int,
                   default=None,
                   help="serve per-worker Prometheus /metrics on this port "
                        "(HVD_METRICS_PORT; offset by the local rank, 0 "
                        "for a free port each)")
    # elastic
    p.add_argument("--min-np", dest="min_np", type=int, default=None)
    p.add_argument("--max-np", dest="max_np", type=int, default=None)
    p.add_argument("--host-discovery-script",
                   dest="host_discovery_script", default=None)
    p.add_argument("--blacklist-cooldown-range", nargs=2, type=float,
                   default=None, help="elastic host blacklist cooldown "
                   "min/max seconds")
    p.add_argument("--hot-spares", dest="hot_spares", type=int,
                   default=None,
                   help="elastic: keep N pre-warmed rankless workers "
                        "parked so an eviction is repaired by promotion "
                        "instead of a cold spawn")
    p.add_argument("--peer-timeout-ms", dest="peer_timeout_ms", type=int,
                   default=None,
                   help="elastic: liveness heartbeat deadline in ms "
                        "(HVD_PEER_TIMEOUT_MS); a worker whose heartbeat "
                        "stops for ten of them (at least 5 s) is killed; "
                        "0 disables the heartbeat")
    # serving plane
    p.add_argument("--serve-page-size", dest="serve_page_size", type=int,
                   default=None,
                   help="serving: KV-cache page size in token slots "
                        "(HVD_SERVE_PAGE_SIZE)")
    p.add_argument("--serve-kv-pages", dest="serve_kv_pages", type=int,
                   default=None,
                   help="serving: total KV-cache pages per replica, page 0 "
                        "reserved (HVD_SERVE_KV_PAGES)")
    p.add_argument("--serve-max-batch", dest="serve_max_batch", type=int,
                   default=None,
                   help="serving: decode-batch slots per replica "
                        "(HVD_SERVE_MAX_BATCH)")
    p.add_argument("--serve-mode", dest="serve_mode", default=None,
                   choices=["continuous", "static"],
                   help="serving: continuous batching, or the static "
                        "baseline that drains the whole batch before "
                        "admitting (HVD_SERVE_MODE)")
    p.add_argument("--serve-autoscale", dest="serve_autoscale",
                   action="store_true", default=None,
                   help="serving: let the elastic driver resize the "
                        "active set from /ctl/serve_load queue-depth "
                        "reports (HVD_SERVE_AUTOSCALE; scale-up promotes "
                        "parked spares, scale-down parks them)")
    p.add_argument("--serve-autoscale-high", dest="serve_autoscale_high",
                   type=int, default=None,
                   help="serving: queue depth above which the autoscaler "
                        "wants another rank (HVD_SERVE_AUTOSCALE_HIGH; "
                        "hysteresis band bottom is fixed at depth<=1)")
    p.add_argument("--serve-prefix-cache", dest="serve_prefix_cache",
                   type=int, choices=[0, 1], default=None,
                   help="serving: radix-tree shared-prefix KV reuse — "
                        "identical page-aligned prompt prefixes share "
                        "physical pages and skip their prefill "
                        "(HVD_SERVE_PREFIX_CACHE; default 1, 0 restores "
                        "the uncached path)")
    p.add_argument("--serve-spec-tokens", dest="serve_spec_tokens",
                   type=int, default=None,
                   help="serving: speculative-decoding draft length k — "
                        "each step drafts k tokens and scores them in one "
                        "batched target pass, emitting 1..k+1 tokens "
                        "bit-identical to greedy (HVD_SERVE_SPEC_TOKENS; "
                        "default 0 = off)")
    # state plane
    p.add_argument("--ckpt-dir", dest="ckpt_dir", default=None,
                   help="checkpoint: default directory for "
                        "hvd.checkpoint.save/restore when the call "
                        "passes none (HVD_CKPT_DIR)")
    p.add_argument("--ckpt-async", dest="ckpt_async",
                   action="store_true", default=None,
                   help="checkpoint: commit saves on the background "
                        "writer thread — the step only pays the "
                        "device-to-host snapshot stall (HVD_CKPT_ASYNC; "
                        "must agree across ranks)")
    p.add_argument("--check-build", action="store_true",
                   help="print framework/native-layer availability and "
                        "exit (reference: horovodrun --check-build)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    args = p.parse_args(argv)
    if args.config_file:
        config_parser.apply_config_file(args, args.config_file)
    if args.no_stall_check:
        args.stall_check_warning_time_seconds = 0
        args.stall_check_shutdown_time_seconds = 0
    if not args.command and not args.check_build:
        p.error("no training command given")
    return args


def check_build():
    """`tpurun --check-build` (reference: horovodrun --check-build): the
    port's framework, whether a CUDA card and nvcc are there, and which
    data planes it uses."""
    import shutil

    import torch

    mark = lambda b: "[X]" if b else "[ ]"  # noqa: E731
    nvcc = shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
    print("horovod_tpu_torch build:")
    print("  Frameworks:")
    print(f"    [X] PyTorch {torch.__version__}")
    print("  Native layers:")
    print(f"    {mark(torch.cuda.is_available())} CUDA card")
    print(f"    {mark(nvcc)} nvcc (the sm_90a kernels build at first use)")
    print("  Data planes:")
    print(f"    {mark(torch.distributed.is_nccl_available())} NCCL "
          f"(CUDA tensors)")
    print(f"    {mark(torch.distributed.is_gloo_available())} Gloo "
          f"(CPU tensors)")
    return 0


def _resolve_hosts(args):
    if args.hosts and args.hostfile:
        raise ValueError("use either -H or --hostfile, not both")
    if args.hostfile:
        hs = hosts_mod.parse_hostfile(args.hostfile)
    elif args.hosts:
        hs = hosts_mod.parse_hosts(args.hosts)
    else:
        hs = [hosts_mod.HostInfo("localhost", args.np or 1)]
    hosts_mod.refuse_remote(h.hostname for h in hs)
    return hs


def _run_static(args):
    hs = _resolve_hosts(args)
    np_ = args.np or sum(h.slots for h in hs)
    slots = hosts_mod.get_host_assignments(hs, np_)
    extra = config_parser.args_to_env(args)
    # The launcher is every rank's host: a port probed here is free for
    # rank 0's store.
    store = f"127.0.0.1:{find_free_port()}"
    procs = []
    try:
        for s in slots:
            env = slot_env(s.rank, s.size, s.local_rank, s.local_size,
                           s.cross_rank, s.cross_size,
                           jax_coord_addr=store, extra_env=extra)
            procs.append(safe_exec(list(args.command), env=env))
        return _wait_all(procs, verbose=args.verbose)
    finally:
        for p in procs:
            terminate(p)


def _wait_all(procs, verbose=False):
    import time
    codes = [None] * len(procs)
    while any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None:
                codes[i] = p.poll()
                if codes[i] not in (None, 0):
                    if verbose:
                        print(f"rank process {i} exited with {codes[i]}; "
                              f"terminating job", file=sys.stderr)
                    for q in procs:
                        terminate(q)
        time.sleep(0.05)
    bad = [c for c in codes if c != 0]
    return 0 if not bad else (bad[0] if bad[0] > 0 else 1)


def run_commandline(argv=None):
    args = parse_args(argv)
    if args.check_build:
        return check_build()
    if args.min_np is not None or args.max_np is not None \
            or args.host_discovery_script:
        from .elastic.driver import run_elastic
        return run_elastic(args)
    return _run_static(args)


def run(fn=None, np=1, hosts=None, command=None, **kwargs):
    """Programmatic API (reference: horovod.run()). Either a shell
    `command` list, or via tpurun CLI args."""
    argv = ["-np", str(np)]
    if hosts:
        argv += ["-H", hosts]
    for k, v in kwargs.items():
        argv.append("--" + k.replace("_", "-"))
        if v is not True:
            argv.append(str(v))
    argv += list(command)
    return run_commandline(argv)


def main():
    # A SIGTERM (a job scheduler's or a test's timeout) unwinds through
    # the launchers' `finally`, which terminates every worker's process
    # group: the workers run in sessions of their own (util.safe_exec), so
    # a signal to the launcher's group alone would leave them running.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
