#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (horovod_tpu_torch) on one CUDA card and
hold every phase to its reference. Run from the repo root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. the card's name and power limit; build the CUDA kernels from
   horovod_tpu_torch/csrc (one nvcc per source, all started together);
1. kernel: the flash forward (csrc/flash_fwd.cu, B1) and backward
   (csrc/flash_bwd.cu: dQ, B2; dK/dV, B3) against their plain PyTorch
   versions on the card, at the main path's shapes plus ragged S and
   head dim 128, in bf16 and f32, modes none/diag/strict, with a random
   dO and a nonzero LSE cotangent through autograd, and the fully
   masked row under strict; times of the kernels, the plain versions and
   torch's scaled_dot_product_attention forward and backward (a
   yardstick only; the port never calls it) beside the card's bound;
2. forward: bert-large ``forward`` with attn_impl="flash" against
   "gather" (B=8, S=512, bf16 and f32), the kernel's launch count per
   forward, and the long-context eval loss (S=4096, loss_chunk=2048)
   through flash against gather;
3. serve: ``ServeLoop`` at bert-large width over the paged KV cache; in
   float32 every served token's logits are held to
   ``forward(attn_impl="flash")`` over the prompt plus the tokens served
   so far; in bf16 it reports tok/s and TTFT p50;
4. train: ``make_train_step`` over an NCCL group of size 1 with AdamW,
   bert-large B=8 S=512 bf16 flash: step 0's loss and gradients through
   flash against gather (f32 and bf16), launches per step (also with
   remat), a falling loss, tokens/s and a profile; then the long-context
   train step, whose step-0 loss must equal phase 2's eval loss;
5. resnet: ResNet-50 (s2d stem, B=128, 224x224, bf16, SGD(0.1, 0.9)),
   the bench's resnet50 config, through ``make_train_step`` over the
   same group: step 0 with norm="pallas" (the B4 kernel BN) against
   norm="flax" (torch ops) from the same weights, in float32 at B=16
   and in bf16 at B=128 (loss, every gradient leaf, every running mean
   and var); B4's launches (106) and layout copies per step; a falling
   loss over 5 steps; images/s for each of the three norms and a
   profile; the eval ``entry()``'s logits;
6. one JSON line of kernels, then the result line.

The kernel phase 1 also holds B4 (csrc/paired_reduce.cu) against its
plain version at every (R, C) a ResNet-50 step gives it, at ragged
shapes and on an unaligned pointer, bf16 and f32, as (x, x) and (dy, x),
checks that two launches give the same bits, and times the kernel, the
plain version and torch's own batch-norm reductions (yardsticks only).

Phases 2-3 (serving), 4 (training) and 5 (ResNet training) are the main
paths: each starts with every kernel's launch count at 0 and must launch
the kernels it runs. Exits with code 2, printing no result, when no CUDA
device is present.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

KERNELS = [{
    "name": "flash_fwd",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:83",
}, {
    "name": "flash_bwd_dq",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:130",
}, {
    "name": "flash_bwd_dkv",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:166",
}, {
    "name": "paired_reduce",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/paired_reduce.cu",
    "replaces": "horovod_tpu/ops/pallas_norm.py:62",
}]
# The shape the kernels line reports B4 at: the backward's (dy, x) over
# ResNet-50's largest bf16 layers at B=128 (stage 1's bn3 and proj_bn).
B4_LINE_SHAPE = (401408, 256)

# Published dense peaks per card, as nvidia-smi names it: (device memory
# bytes/s, bf16 tensor-core FLOP/s, float32 CUDA-core FLOP/s).
SPECS = {
    "H100 80GB HBM3": ("H100 SXM", 3.35e12, 989e12, 67e12),
    "H100 PCIe": ("H100 PCIe", 2.0e12, 756e12, 51e12),
    "H100 NVL": ("H100 NVL", 3.9e12, 835e12, 60e12),
}

# Kernel against plain version on the card, same inputs, elementwise
# |O - plain| <= atol + rtol * |plain|. float32: the key tiles are summed
# in another order (5e-5 absolute). bf16: the kernel rounds P to bf16 for
# its tensor-core P.V product (2^-9 relative per term; the plain version
# keeps P in f32), and the output is then rounded to bf16, whose step is
# 2^-8 |O|, so one step of the output is allowed wherever it lands: 1e-2
# absolute plus 1e-2 |O| (2.5 steps). LSE stays float32 in both (1e-4).
TOL_O = {"float32": (5e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
TOL_LSE = 1e-4
# bert-large logits, flash against gather, |logit| up to ~4: float32 only
# differs by summation order (1e-3 over 24 layers); bf16 rounds P to bf16
# in gather and not in flash, compounded over 24 layers (max 0.125 = 8
# bf16 steps at |x| in [2, 4); mean 0.02).
TOL_FWD_F32 = 1e-3
TOL_FWD_BF16_MAX, TOL_FWD_BF16_MEAN = 0.125, 0.02
# Long-context eval loss (~10.3 nats), flash against gather in bf16; the
# long-context train step's step-0 loss against that eval loss.
TOL_LOSS_BF16 = 2e-2
# Backward kernels against the plain backward, |d - plain| <= atol + rtol *
# |plain| per element. float32: the tiles' products are summed in another
# order, over up to S = 4096 rows (1e-5 + 1e-5 |plain|). bf16: the kernels
# round P and dS to bf16 (2^-9 relative per term) for three of the
# products, whose sums run over up to S rows, and round the result to
# bf16, whose step is 2^-8 relative: 2e-2 + 2e-2 |plain|.
TOL_BWD = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
# bert-large step 0 through flash against gather. float32: summation
# order only; the loss within 1e-4 and every gradient leaf within 1e-4 in
# relative norm (|g_flash - g_gather| / |g_gather|). bf16: the paths
# round at other places (gather rounds the probabilities and each
# einsum's output to bf16, flash rounds P and dS inside its kernels) and
# the error compounds over the 24-layer backward: the loss within 2e-2
# and every leaf within 0.1 in relative norm.
TOL_TRAIN_F32 = 1e-4
TOL_TRAIN_BF16_LOSS, TOL_TRAIN_BF16_GRAD = 2e-2, 0.1
# Served float32 logits against forward(flash) in float32.
TOL_SERVE_F32 = 1e-3
# B4 against its plain version, per channel: |s - plain| <= 1e-5 * sum_r|a|
# and |p - plain| <= 1e-5 * sum_r|a*b|. Both sum in float32, in another
# order, over up to 1.6 M rows: the rounding of such a sum stays far
# below 1e-5 of the sum of the magnitudes (the kernel's partial sums run
# over at most a few thousand rows each).
TOL_B4 = 1e-5
# ResNet-50 step 0, norm="pallas" (B4 and the reference's affine) against
# norm="flax" (float32 normalization), same weights and batch. The two
# compute the same function with other rounding: the kernel BN's y = x*a
# + b with b = beta - gamma*inv*mean against flax's (x - mean)*mul +
# bias. float32 at B=16: the loss agrees to float32 rounding (1e-4), and
# so do the activations, but a last-bit difference flips a ReLU or
# max-pool choice here and there among 10^8 units, which moves the
# gradient of the leaves that sum over the residual stream (the bn3 and
# proj_bn biases; on the CPU at B=16, 224x224, flax's own float32
# gradient is 5.8e-4 from float64 there, the kernel BN's 1.7e-3, and a
# float64 backward does not change the latter): every leaf within 1e-2
# in relative norm and all leaves as one vector within 1e-3; running
# statistics within 1e-4 + 1e-4|flax|. bf16 at B=128: the kernel BN
# rounds a and b to bf16 (2^-9 relative) and computes y in bf16, flax
# rounds once, so every BN output differs by up to a bf16 step, over 53
# layers: loss within 2e-2; all leaves as one vector within 0.1, and the
# residual-stream bias leaves, the most sensitive, within 0.5 each;
# running statistics within 2e-2 + 2e-2|flax|. (Both set from the first
# run on the card, H100 80GB HBM3: f32 worst leaf 3.5e-3, whole 3.5e-4;
# bf16 worst leaf 0.235, whole 0.051.)
TOL_RESNET_F32 = dict(loss=1e-4, grad=1e-2, whole=1e-3, stats=(1e-4, 1e-4))
TOL_RESNET_BF16 = dict(loss=2e-2, grad=0.5, whole=0.1, stats=(2e-2, 2e-2))


class PhaseError(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise PhaseError(what)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card_spec(name):
    for key, spec in SPECS.items():
        if key in name:
            return spec
    print(f"spec: {name!r} is not in the table; using H100 SXM's")
    return SPECS["H100 80GB HBM3"]


def ptxas_summary(log):
    """'kernel<DP> N regs, S B spilled' per kernel, from the compiler's
    -Xptxas -v report."""
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*?\d"   # length prefix
                      r"((?:flash|paired)_\w+?_kernel)(?:I(\w+?)E)?E?v",
                      ln)
        if m:
            args = m[2] or ""
            args = re.fullmatch(r"Li(\d+)", args)[1] \
                if re.fullmatch(r"Li(\d+)", args) else args
            name = f"{m[1]}<{args}>" if args else m[1]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m[1]} regs, {spill} B spilled")
            name, spill = None, "?"
    return "; ".join(out)


def time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph and replayed, timed with CUDA events, so the host's cost of a
    call (Python, ctypes, allocation) drops out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def profile_line(torch, label, fn):
    """Device busy share over one call of ``fn`` and the kernels that took
    most device time, from torch.profiler (CUPTI); then the host side:
    self CPU time of the ops launched and the ops that took most. Wall
    time includes the profiler's own cost, so the busy share is a lower
    bound and the host times are upper bounds. Returns (the kernels'
    events, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kern = sorted((e for e in events                  # kernels only, not
                   if e.device_type == cuda           # the ops above them
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.device_time_total)
    if not kern:
        print(f"profile {label}: no device time recorded (not measured)")
        return [], wall_ms
    busy = sum(e.device_time_total for e in kern) / 1e3
    top = "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.2f} ms"
                    f" x{e.count}" for e in kern[:6])
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall_ms:.1%}); top: {top}")
    host = sorted((e for e in events if e.device_type != cuda),
                  key=lambda e: -e.self_cpu_time_total)
    top = "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms"
                    f" x{e.count}" for e in host[:6])
    print(f"profile {label} host: self CPU "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms over "
          f"{sum(e.count for e in host)} op calls; top: {top}")
    return kern, wall_ms


def flash_bound_ms(shape, dtype_name, mode, spec):
    """max(bytes / memory rate, operations / peak rate): Q, K, V read and
    O written once in their dtype, LSE written once in f32; 4*D flops per
    live (q, k) pair (QK^T and PV)."""
    B, S, H, D = shape
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * S * H * D * item + B * H * S * 4
    pairs = {"none": S * S, "diag": S * (S + 1) // 2,
             "strict": S * (S - 1) // 2}[mode]
    flops = 4 * B * H * D * pairs
    _, bw, bf16, f32 = spec
    t_bytes = nbytes / bw
    t_ops = flops / (bf16 if dtype_name == "bfloat16" else f32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def bwd_bound_ms(shape, dtype_name, mode, kernel, spec):
    """The backward kernels' bound, as flash_bound_ms: Q, K, V and dO read
    once in their dtype, LSE and delta read once in f32, and dQ (B2) or
    dK and dV (B3) written once; 2*D flops per live (q, k) pair for each
    product: 3 in B2 (QK^T, dO V^T, dS K), 4 in B3 (QK^T, dO V^T, P^T dO,
    dS^T Q)."""
    B, S, H, D = shape
    item = 2 if dtype_name == "bfloat16" else 4
    n_out, n_prod = (1, 3) if kernel == "flash_bwd_dq" else (2, 4)
    nbytes = (4 + n_out) * B * S * H * D * item + 2 * B * H * S * 4
    pairs = {"none": S * S, "diag": S * (S + 1) // 2,
             "strict": S * (S - 1) // 2}[mode]
    flops = n_prod * 2 * B * H * D * pairs
    _, bw, bf16, f32 = spec
    t_bytes = nbytes / bw
    t_ops = flops / (bf16 if dtype_name == "bfloat16" else f32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _delta(o, do, dlse):
    """Delta = rowsum(dO * O) - dLSE, [B, H, S] float32, as _FlashFn."""
    return ((do.float() * o.float()).sum(-1).transpose(1, 2)
            - dlse).contiguous()


def phase_kernel_bwd(torch, fa, spec):
    """B2 and B3 through autograd (flash_attention_lse's _FlashFn, a random
    dO and a nonzero dLSE) against _flash_bwd_plain on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = [(s, d, m) for s in [(8, 512, 16, 64), (1, 4096, 16, 64),
                                 (3, 1000, 16, 64), (2, 333, 4, 128)]
             for d in dts for m in fa.MODES]
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape, dname, mode in cases:
        B, S, H, D = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dts[dname]) for _ in range(4))
        dlse = torch.randn((B, H, S), generator=gen, device="cuda")
        with torch.enable_grad():
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o, lse = fa.flash_attention_lse(qg, kg, vg, mode=mode, block=512)
            got = torch.autograd.grad((o, lse), (qg, kg, vg), (do, dlse))
        torch.cuda.synchronize()
        plain = fa._flash_bwd_plain(q, k, v, o.detach(), lse.detach(), do,
                                    _delta(o.detach(), do, dlse), mode,
                                    D ** -0.5, fa._validate(q, k, v, 512))
        atol, rtol = TOL_BWD[dname]
        parts = []
        for name, a, b in zip(("dq", "dk", "dv"), got, plain):
            diff = (a.float() - b.float()).abs()
            err = diff.max().item()
            within = bool((diff <= atol + rtol * b.float().abs()).all())
            parts.append((name, err, within))
            if shape == (8, 512, 16, 64) and dname == "bfloat16":
                kern = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                worst[kern] = max(worst[kern], err)
        line = (f"kernel flash_bwd {list(shape)} {dname} {mode}: " + ", ".join(
            f"max|{n}-plain| {e:.3g} ({'ok' if w else 'FAIL'})"
            for n, e, w in parts) + f" (tol {atol} + {rtol}|plain|)")
        check(all(w for _, _, w in parts)
              and all(bool(torch.isfinite(t).all()) for t in got), line)
        if mode == "strict":   # row 0 sees no key
            check(bool((got[0][:, 0] == 0).all()),
                  f"{line}: masked row 0 has dQ != 0")
            line += "; masked row 0: dQ=0"
        print(line)

    timings = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in [(8, 512, 16, 64), (1, 4096, 16, 64)]:
        B, S, H, D = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_fwd_cuda(q, k, v, "diag", D ** -0.5)
        delta = _delta(o, do, torch.zeros_like(lse))
        args = (q, k, v, do, lse, delta, "diag", D ** -0.5)
        block = fa._validate(q, k, v, 512)
        with torch.enable_grad():
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = sdpa(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        reps = 20 if S == 512 else 10
        plain_ms = time_ms(torch, lambda: fa._flash_bwd_plain(
            q, k, v, o, lse, do, delta, "diag", D ** -0.5, block), reps)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps)
        for kern, fn in (("flash_bwd_dq", fa.flash_bwd_dq_cuda),
                         ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda)):
            t = {"ms": time_ms(torch, lambda fn=fn: fn(*args), reps),
                 "plain_ms": plain_ms, "library_ms": library_ms}
            t["bound_ms"], t["bound_by"] = bwd_bound_ms(
                shape, "bfloat16", "diag", kern, spec)
            timings[kern, shape] = t
            print(f"time {kern} {list(shape)} bf16 diag: kernel "
                  f"{t['ms']:.4f} ms, plain (dq, dk, dv together) "
                  f"{plain_ms:.4f} ms, sdpa backward (dq, dk, dv together) "
                  f"{library_ms:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}, {spec[0]} peaks)")
        del out
    return worst, timings


def phase_kernel(torch, fa, spec):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = [(s, d, m) for s in [(8, 512, 16, 64), (1, 4096, 16, 64),
                                 (3, 1000, 16, 64), (2, 333, 4, 128)]
             for d in dts for m in fa.MODES]
    worst = 0.0
    for shape, dname, mode in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dts[dname]) for _ in range(3))
        scale = shape[-1] ** -0.5
        o, lse = fa.flash_attention_lse(q, k, v, mode=mode, block=512)
        torch.cuda.synchronize()
        po, plse = fa._flash_plain(q, k, v, mode, scale,
                                   fa._validate(q, k, v, 512))
        atol, rtol = TOL_O[dname]
        diff = (o.float() - po.float()).abs()
        err_o = diff.max().item()
        within = bool((diff <= atol + rtol * po.float().abs()).all())
        err_l = (lse - plse).abs().max().item()
        line = (f"kernel flash_fwd {list(shape)} {dname} {mode}: "
                f"max|O-plain| {err_o:.3g} (tol {atol} + {rtol}|O|: "
                f"{'ok' if within else 'FAIL'}) max|LSE-plain| {err_l:.3g} "
                f"(tol {TOL_LSE})")
        check(within and err_l <= TOL_LSE, line)
        if mode == "strict":   # row 0 sees no key
            check(bool((o[:, 0] == 0).all())
                  and bool((lse[:, :, 0] == fa.NEG_INF).all()),
                  f"{line}: masked row 0 is not O=0, LSE=-1e30")
            line += "; masked row 0: O=0, LSE=-1e30"
        print(line)
        if shape == (8, 512, 16, 64) and dname == "bfloat16":
            worst = max(worst, err_o)

    timings = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in [(8, 512, 16, 64), (1, 4096, 16, 64)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        block = fa._validate(q, k, v, 512)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = 50 if shape[1] == 512 else 20
        t = {
            "ms": time_ms(torch, lambda: fa.flash_attention_lse(
                q, k, v, mode="diag"), reps),
            "plain_ms": time_ms(torch, lambda: fa._flash_plain(
                q, k, v, "diag", 0.125, block), reps),
            "library_ms": time_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True), reps),
        }
        t["bound_ms"], t["bound_by"] = flash_bound_ms(shape, "bfloat16",
                                                      "diag", spec)
        timings[shape] = t
        print(f"time flash_fwd {list(shape)} bf16 diag: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {spec[0]} peaks)")
    return worst, timings


def phase_forward(torch, tfm, fa, params, cfg):
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                         device="cuda")
    flash = dataclasses.replace(cfg, attn_impl="flash")
    gather = dataclasses.replace(cfg, attn_impl="gather")
    for dt in ("bfloat16", "float32"):
        n0 = fa.flash_fwd_cuda.launches
        lf = tfm.forward(params, toks, dataclasses.replace(flash, dtype=dt))
        n1 = fa.flash_fwd_cuda.launches
        lg = tfm.forward(params, toks, dataclasses.replace(gather, dtype=dt))
        torch.cuda.synchronize()
        check(fa.flash_fwd_cuda.launches == n1, "gather launched the kernel")
        check(n1 - n0 == cfg.n_layers,
              f"flash forward launched flash_fwd {n1 - n0} times, "
              f"expected n_layers={cfg.n_layers}")
        check(lf.shape == (8, 512, cfg.vocab_size)
              and bool(torch.isfinite(lf).all()), "flash logits not finite")
        d = (lf.float() - lg.float()).abs()
        line = (f"forward bert-large B=8 S=512 {dt}: flash launches "
                f"+{n1 - n0} (n_layers {cfg.n_layers}), max|flash-gather| "
                f"{d.max().item():.4g}, mean {d.mean().item():.3g}, "
                f"max|logit| {lg.float().abs().max().item():.3g}")
        if dt == "float32":
            check(d.max().item() <= TOL_FWD_F32, line)
            line += f" (tol {TOL_FWD_F32})"
        else:
            check(d.max().item() <= TOL_FWD_BF16_MAX
                  and d.mean().item() <= TOL_FWD_BF16_MEAN, line)
            line += f" (tol max {TOL_FWD_BF16_MAX}, mean {TOL_FWD_BF16_MEAN})"
        print(line)
        del lf, lg
        if dt == "bfloat16":   # in turns: flash, gather, gather, flash
            fwd = {"flash": [], "gather": []}
            for impl in ("flash", "gather", "gather", "flash"):
                c = flash if impl == "flash" else gather
                fwd[impl].append(time_ms(torch, lambda c=c: tfm.forward(
                    params, toks, c), 5))
            print(f"time forward bert-large B=8 S=512 bf16 (two turns each):"
                  f" flash {fwd['flash'][0]:.2f} / {fwd['flash'][1]:.2f} ms,"
                  f" gather {fwd['gather'][0]:.2f} / {fwd['gather'][1]:.2f}"
                  f" ms")
            profile_line(torch, "forward bert-large B=8 S=512 bf16 flash",
                         lambda: tfm.forward(params, toks, flash))

    # longctx: the same width at max_seq_len=4096, B=1, eval loss.
    lcfg = dataclasses.replace(cfg, max_seq_len=4096, loss_chunk=2048)
    lparams = dict(params, pos_embed=torch.randn(
        (4096, cfg.d_model), generator=gen, device="cuda") * 0.02)
    ltoks = torch.randint(0, cfg.vocab_size, (1, 4097), generator=gen,
                          device="cuda")
    n0 = fa.flash_fwd_cuda.launches
    loss_f = tfm.loss_fn(lparams, {"tokens": ltoks},
                         dataclasses.replace(lcfg, attn_impl="flash"))
    n1 = fa.flash_fwd_cuda.launches
    loss_g = tfm.loss_fn(lparams, {"tokens": ltoks},
                         dataclasses.replace(lcfg, attn_impl="gather"))
    lf, lg = loss_f.item(), loss_g.item()
    line = (f"longctx eval loss S=4096 loss_chunk=2048 bf16: flash {lf:.5f} "
            f"gather {lg:.5f} |diff| {abs(lf - lg):.3g} (tol "
            f"{TOL_LOSS_BF16}), flash launches +{n1 - n0}")
    check(np.isfinite(lf) and abs(lf - lg) <= TOL_LOSS_BF16
          and n1 - n0 == cfg.n_layers, line)
    print(line)
    return lparams, ltoks, lf


def _record(sl, log):
    """Wrap the loop's engine steps so every served row's logits are kept
    as (rid, context length, logits) for the reference check."""
    def ctx_of(req):
        return list(req.prompt) + list(req.generated)

    def by_tokens(toks, n):
        """The running request whose context these tokens are (None for
        the warmup's trash-page calls)."""
        want = [int(x) for x in toks[:n]]
        return next((r for r in sl.batcher.running.values()
                     if ctx_of(r) == want), None)

    prefill, bprefill, decode = sl.prefill_fn, sl.bprefill_fn, sl.decode_fn

    def rec_prefill(params, cache, toks, length, bt):
        cache, logits = prefill(params, cache, toks, length, bt)
        req = by_tokens(toks, int(length))
        if req is not None:
            log.append((req.rid, int(length), logits.cpu()))
        return cache, logits

    def rec_bprefill(params, cache, toks, lengths, tables, active):
        cache, logits = bprefill(params, cache, toks, lengths, tables,
                                 active)
        for row in np.flatnonzero(active):
            req = by_tokens(toks[row], int(lengths[row]))
            log.append((req.rid, int(lengths[row]), logits[row].cpu()))
        return cache, logits

    def rec_decode(params, cache, toks, positions, tables, active):
        cache, logits = decode(params, cache, toks, positions, tables,
                               active)
        for slot in np.flatnonzero(active):
            req = sl.batcher.running[int(slot)]
            log.append((req.rid, int(positions[slot]) + 1,
                        logits[slot].cpu()))
        return cache, logits

    sl.prefill_fn, sl.decode_fn = rec_prefill, rec_decode
    if bprefill is not None:
        sl.bprefill_fn = rec_bprefill


def phase_serve(torch, tfm, loop, kv_cache, params, cfg):
    geo = kv_cache.geometry(n_pages=256, page_size=16, max_context=512)
    flash32 = dataclasses.replace(cfg, dtype="float32", attn_impl="flash")

    # float32: served logits against forward(flash).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sl = loop.ServeLoop(params, cfg32, geo=geo, max_batch=8, device="cuda")
    log = []
    _record(sl, log)
    sl.warmup()
    reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(2),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg.vocab_size)
    summary, finished = sl.run(reqs)
    check(len(finished) == 8 and all(r.finish_reason for r in finished),
          f"serve f32: {len(finished)} of 8 requests finished")
    check(sl.chunk_fn is None or summary["chunk_fills"] == 0,
          "chunked prefill ran; its logits are not recorded")
    worst, ties, checked = 0.0, [], 0
    by_rid = {r.rid: r for r in finished}
    for rid, req in by_rid.items():
        seq = list(req.prompt) + list(req.generated)
        ref = tfm.forward(params, torch.tensor([seq[:-1]], device="cuda"),
                          flash32)[0].float().cpu()
        for i, tok in enumerate(req.generated):
            row = ref[len(req.prompt) - 1 + i]
            if tok != int(row.argmax()):
                top2 = row.topk(2).values
                gap = (top2[0] - top2[1]).item()
                check(gap <= 2 * TOL_SERVE_F32,
                      f"serve f32 rid {rid} token {i}: served {tok}, "
                      f"forward argmax {int(row.argmax())}, gap {gap:.3g}")
                ties.append((rid, i, gap))
        for lrid, ctx_len, logits in (e for e in log if e[0] == rid):
            worst = max(worst, (logits - ref[ctx_len - 1]).abs().max().item())
            checked += 1
    n_tokens = sum(len(r.generated) for r in finished)
    line = (f"serve bert-large f32: {len(finished)} requests, {n_tokens} "
            f"tokens, {checked} served logit rows, max|served-forward(flash)|"
            f" {worst:.3g} (tol {TOL_SERVE_F32}), near-ties {ties}")
    check(checked == n_tokens and worst <= TOL_SERVE_F32, line)
    print(line)
    del sl

    # bf16: throughput and latency.
    sl = loop.ServeLoop(params, cfg, geo=geo, max_batch=8, device="cuda")
    sl.warmup()
    torch.cuda.synchronize()
    reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(3),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg.vocab_size)
    summary, finished = sl.run(reqs)
    check(len(finished) == 8 and all(r.finish_reason for r in finished),
          f"serve bf16: {len(finished)} of 8 requests finished")
    print(f"serve bert-large bf16: {summary['requests']} requests, "
          f"{summary['tokens']} tokens, {summary['tok_s']} tok/s, TTFT p50 "
          f"{summary['ttft_p50_ms']} ms, ITL p50 {summary['itl_p50_ms']} ms, "
          f"batch fill {summary['batch_fill_mean']}")
    reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(4),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg.vocab_size)
    profile_line(torch, "serve bert-large bf16 (8 more requests)",
                 lambda: sl.run(reqs))


def _launches(fa):
    return (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches)


def _trainable(torch, params):
    """A copy of ``params`` whose leaves need grad: the train steps update
    params in place, and the serving phases' params stay as they were."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.detach().clone().requires_grad_()
    return conv(params)


def _adamw(torch, dp, params):
    """optax.adamw(1e-4), the bench's optimizer, in PyTorch's terms (torch's
    default weight_decay is 1e-2, optax's 1e-4)."""
    return torch.optim.AdamW(dp.tree_leaves(params), lr=1e-4,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _timed_steps(torch, step, params, batch, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(params, batch) for _ in range(n)]
    torch.cuda.synchronize()
    return [x.item() for x in losses], (time.perf_counter() - t0) / n


def phase_train(torch, tfm, fa, dp, params, cfg, group, longctx):
    """bert-large training through make_train_step over ``group``."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                     generator=gen, device="cuda")}
    B, S = 8, 512
    flash = dataclasses.replace(cfg, attn_impl="flash")
    gather = dataclasses.replace(cfg, attn_impl="gather")
    tparams = _trainable(torch, params)
    items = dp.tree_flatten_with_path(tparams)
    leaves = [leaf for _, leaf in items]

    # Step 0's loss and gradients, flash against gather.
    for dt in ("float32", "bfloat16"):
        res = {}
        for impl, c in (("flash", flash), ("gather", gather)):
            c = dataclasses.replace(c, dtype=dt)
            with torch.enable_grad():
                loss = tfm.loss_fn(tparams, batch, c)
                res[impl] = (loss.item(),
                             torch.autograd.grad(loss, leaves))
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(res["flash"][1], res["gather"][1])]
        worst = max(range(len(rel)), key=rel.__getitem__)
        dl = abs(res["flash"][0] - res["gather"][0])
        tol_l, tol_g = ((TOL_TRAIN_F32, TOL_TRAIN_F32) if dt == "float32"
                        else (TOL_TRAIN_BF16_LOSS, TOL_TRAIN_BF16_GRAD))
        line = (f"train grads bert-large B=8 S=512 {dt} step 0: loss flash "
                f"{res['flash'][0]:.6f} gather {res['gather'][0]:.6f} "
                f"|diff| {dl:.3g} (tol {tol_l}); {len(rel)} leaves, worst "
                f"|g_flash-g_gather|/|g_gather| {rel[worst]:.3g} at "
                f"{items[worst][0]}, mean {sum(rel) / len(rel):.3g} (tol "
                f"{tol_g})")
        check(np.isfinite(res["flash"][0]) and dl <= tol_l
              and rel[worst] <= tol_g, line)
        print(line)
        del res

    # The step: launches per step, a falling loss, tokens/s.
    opt = _adamw(torch, dp, tparams)
    with torch.enable_grad():
        step = dp.make_train_step(lambda p, b: tfm.loss_fn(p, b, flash), opt,
                                  group)
        per_step = []
        losses = []
        for _ in range(2):
            n0 = _launches(fa)
            losses += _timed_steps(torch, step, tparams, batch, 1)[0]
            per_step.append(tuple(b - a for a, b in zip(n0, _launches(fa))))
        more, sec = _timed_steps(torch, step, tparams, batch, 3)
        losses += more
        L = cfg.n_layers
        line = (f"train bert-large B=8 S=512 bf16 flash, make_train_step "
                f"over NCCL world size {group.size()}, AdamW: losses "
                f"{[round(x, 5) for x in losses]}, launches per step "
                f"(flash_fwd, flash_bwd_dq, flash_bwd_dkv) {per_step}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0]
              and all(n == (L, L, L) for n in per_step), line)
        print(line)
        print(f"time train bert-large B=8 S=512 bf16 flash: "
              f"{sec * 1e3:.2f} ms/step, {B * S / sec:.1f} tokens/s "
              f"(3 steps)")
        profile_line(torch, "train bert-large B=8 S=512 bf16 flash step",
                     lambda: step(tparams, batch))

        remat = dataclasses.replace(flash, remat=True)
        rstep = dp.make_train_step(lambda p, b: tfm.loss_fn(p, b, remat),
                                   opt, group)
        n0 = _launches(fa)
        loss_r, sec_r = _timed_steps(torch, rstep, tparams, batch, 1)
        n = tuple(b - a for a, b in zip(n0, _launches(fa)))
        line = (f"train bert-large remat=True: loss {loss_r[0]:.5f}, "
                f"launches {n} (expected {(2 * L, L, L)}), "
                f"{sec_r * 1e3:.2f} ms/step")
        check(np.isfinite(loss_r[0]) and n == (2 * L, L, L), line)
        print(line)
    del opt, step, rstep, tparams, leaves, items

    # longctx: the eval phase's params and tokens, trained.
    lparams, ltoks, eval_loss = longctx
    lcfg = dataclasses.replace(flash, max_seq_len=4096, loss_chunk=2048)
    lp = _trainable(torch, lparams)
    lopt = _adamw(torch, dp, lp)
    with torch.enable_grad():
        lstep = dp.make_train_step(lambda p, b: tfm.loss_fn(p, b, lcfg),
                                   lopt, group)
        l0, _ = _timed_steps(torch, lstep, lp, {"tokens": ltoks}, 1)
        l1, sec = _timed_steps(torch, lstep, lp, {"tokens": ltoks}, 1)
    line = (f"train longctx S=4096 B=1 loss_chunk=2048 bf16 flash: step-0 "
            f"loss {l0[0]:.5f} against eval loss {eval_loss:.5f} |diff| "
            f"{abs(l0[0] - eval_loss):.3g} (tol {TOL_LOSS_BF16}), step-1 "
            f"loss {l1[0]:.5f}")
    check(np.isfinite(l1[0]) and abs(l0[0] - eval_loss) <= TOL_LOSS_BF16,
          line)
    print(line)
    print(f"time train longctx S=4096 B=1 bf16 flash: {sec * 1e3:.2f} "
          f"ms/step, {4096 / sec:.1f} tokens/s (1 step)")


def b4_bound_ms(R, C, dtype_name, same, spec):
    """B4's least time: each distinct input read once (``same``: a and b
    are one tensor) and s, p written once in float32, over the memory
    rate; 3 float32 operations an element (an add for s, a multiply and
    an add for p) over the CUDA cores' float32 rate."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (1 if same else 2) * R * C * item + 2 * C * 4
    _, bw, _, f32 = spec
    t_bytes, t_ops = nbytes / bw, 3 * R * C / f32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def resnet_layout(torch, resnet, batch, image):
    """What one ResNet-50 (s2d) training forward at ``batch`` x ``image``
    gives its BatchNorms and convolutions, from a forward on the meta
    device (no memory, no kernel): ``{(R, C): layers}`` of the BN inputs
    and the multiply-adds of the convolutions and the head."""
    model = resnet.ResNet50(stem="s2d", norm="flax", device="meta")
    shapes, macs = {}, [0]

    def on_norm(m, args):
        x = args[0]
        key = (x.numel() // x.shape[-1], x.shape[-1])
        shapes[key] = shapes.get(key, 0) + 1

    def on_conv(m, args, out):
        _, i, kh, kw = m.kernel.shape
        macs[0] += out.numel() * i * kh * kw

    for m in model.modules():
        if isinstance(m, tuple(resnet.NORMS.values())):
            m.register_forward_pre_hook(on_norm)
        elif isinstance(m, resnet.Conv):
            m.register_forward_hook(on_conv)
    model(torch.empty((batch, image, image, 3), device="meta"), train=True)
    macs[0] += batch * model.head.kernel.numel()
    return shapes, macs[0]


def phase_kernel_b4(torch, bn, spec, shapes):
    """B4 (paired_reduce_cuda) against paired_reduce_plain on the card at
    every (R, C) of ``shapes`` (ResNet-50's BN inputs at B=128), at
    ragged shapes (R prime, C in {1, 12, 1000}) and on a pointer one
    element off alignment (the scalar path), bf16 and f32, as (x, x) and
    (dy, x); two launches must give the same bits. Then times at every
    ResNet-50 shape in bf16, and their sum over one step."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    ragged = [(1000003, 1), (1000003, 12), (10007, 1000)]
    worst = 0.0
    cases = [(R, C, 0) for R, C in sorted(shapes) + ragged] + [(10007, 64, 1)]
    for R, C, off in cases:
        for dname, dt in dts.items():
            for same in (True, False):
                x, dy = (torch.randn(R * C + off, generator=gen,
                                     device="cuda").to(dt)[off:].view(R, C)
                         for _ in range(2))
                a, b = (x, x) if same else (dy, x)
                s, p = bn.paired_reduce(a, b)
                s2, p2 = bn.paired_reduce(a, b)
                torch.cuda.synchronize()
                ps, pp = bn.paired_reduce_plain(a, b)
                af, bf = a.float(), b.float()
                es, ep = (s - ps).abs(), (p - pp).abs()
                rel_s = (es / af.abs().sum(0).clamp_min(1e-30)).max().item()
                rel_p = (ep / (af * bf).abs().sum(0).clamp_min(1e-30)) \
                    .max().item()
                bits = torch.equal(s, s2) and torch.equal(p, p2)
                where = " one element off alignment" if off else ""
                line = (f"kernel paired_reduce [{R}, {C}]{where} {dname} "
                        f"{'(x, x)' if same else '(dy, x)'}: "
                        f"max|s-plain|/sum|a| {rel_s:.3g}, max|p-plain|/"
                        f"sum|ab| {rel_p:.3g} (tol {TOL_B4}), two launches "
                        f"{'bit-equal' if bits else 'DIFFER'}")
                check(rel_s <= TOL_B4 and rel_p <= TOL_B4 and bits
                      and bool(torch.isfinite(s).all())
                      and bool(torch.isfinite(p).all()), line)
                print(line)
                if (R, C) == B4_LINE_SHAPE and dname == "bfloat16" \
                        and not same:
                    worst = max(es.max().item(), ep.max().item())
                del x, dy, a, b, af, bf

    timings = {}
    step = dict.fromkeys(("ms", "call_ms", "plain_ms", "library_ms",
                          "bound_ms"), 0.0)
    for (R, C), layers in sorted(shapes.items()):
        x, dy = (torch.randn((R, C), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        # torch's own reductions take NCHW-logical channels-last tensors
        x4, dy4 = (t.view(R, 1, 1, C).permute(0, 3, 1, 2) for t in (x, dy))
        mean, invstd = torch.batch_norm_stats(x4, 1e-5)
        reps = 20
        for same, (a, b) in ((True, (x, x)), (False, (dy, x))):
            lib = (lambda: torch.batch_norm_stats(x4, 1e-5)) if same else (
                lambda: torch.batch_norm_backward_reduce(
                    dy4, x4, mean, invstd, None, True, False, False))
            t = {"ms": graph_ms(torch, lambda: bn.paired_reduce_cuda(a, b),
                                reps),
                 "call_ms": time_ms(torch, lambda: bn.paired_reduce_cuda(
                     a, b), reps),
                 "plain_ms": graph_ms(torch, lambda: bn.paired_reduce_plain(
                     a, b), reps),
                 "library_ms": graph_ms(torch, lib, reps)}
            t["bound_ms"], t["bound_by"] = b4_bound_ms(R, C, "bfloat16",
                                                       same, spec)
            timings[(R, C), same] = t
            for k in step:
                step[k] += layers * t[k]
            lib = "batch_norm_stats" if same \
                else "batch_norm_backward_reduce"
            print(f"time paired_reduce [{R}, {C}] bf16 "
                  f"{'(x, x)' if same else '(dy, x)'} x{layers} layers: "
                  f"kernel {t['ms']:.4f} ms (a call from Python "
                  f"{t['call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
                  f"{lib} {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}, {spec[0]} peaks), kernel at "
                  f"{t['bound_ms'] / t['ms']:.1%} of bound")
        del x, dy, x4, dy4
    n = 2 * sum(shapes.values())
    print(f"time paired_reduce over one ResNet-50 B=128 step ({n} "
          f"launches): kernel {step['ms']:.3f} ms of device time (calls "
          f"from Python back to back {step['call_ms']:.3f} ms), bound "
          f"{step['bound_ms']:.3f} ms ({step['bound_ms'] / step['ms']:.1%}), "
          f"plain {step['plain_ms']:.3f} ms, torch's batch-norm reductions "
          f"{step['library_ms']:.3f} ms (device times from CUDA graph "
          f"replays)")
    return worst, timings[B4_LINE_SHAPE, False]


def _resnet_model(torch, resnet, state, norm, dtype):
    """ResNet-50 (s2d) on the card with ``norm`` and ``dtype``, loaded with
    ``state`` (every norm has the same params and buffers)."""
    model = resnet.ResNet50(stem="s2d", norm=norm, dtype=dtype,
                            device="cuda")
    model.load_state_dict(state)
    return model


def _resnet_step0(torch, resnet, model, batch):
    """Loss, {name: grad} and {name: running stat} of one training forward
    and backward (no update)."""
    params = dict(model.named_parameters())
    names = sorted(params)
    with torch.enable_grad():
        loss = resnet.make_loss_fn(model)(params, batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    return (loss.item(), dict(zip(names, grads)),
            {n: b.clone() for n, b in model.named_buffers()})


def phase_resnet(torch, resnet, bn, dp, graft_entry, group, macs_per_image):
    """ResNet-50 training through make_train_step over ``group``."""
    B, image = 128, 224
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((B, image, image, 3),
                                         dtype=np.float32), device="cuda")
    batch = {"images": x.to(torch.bfloat16),      # as bench.py's batch
             "labels": torch.tensor(rng.integers(0, 1000, B), device="cuda")}
    del x
    state = resnet.create_train_state(
        torch.Generator(device="cuda").manual_seed(0), image_size=image,
        stem="s2d", norm="pallas", device="cuda").state_dict()

    # Step 0, norm="pallas" (B4) against norm="flax", same weights.
    for dt, bsz, tol in (("float32", 16, TOL_RESNET_F32),
                         ("bfloat16", B, TOL_RESNET_BF16)):
        sub = {k: v[:bsz] for k, v in batch.items()}
        res = {}
        for norm in ("pallas", "flax"):
            model = _resnet_model(torch, resnet, state, norm,
                                  getattr(torch, dt))
            n0 = bn.paired_reduce_cuda.launches
            res[norm] = _resnet_step0(torch, resnet, model, sub)
            res[norm + "_launches"] = bn.paired_reduce_cuda.launches - n0
            del model
        (lp, gp, sp), (lf, gf, sf) = res["pallas"], res["flax"]
        rel = {n: ((gp[n].float() - gf[n].float()).norm()
                   / gf[n].float().norm().clamp_min(1e-30)).item()
               for n in gf}
        worst = max(rel, key=rel.get)
        whole = (torch.cat([(gp[n].float() - gf[n].float()).flatten()
                            for n in gf]).norm()
                 / torch.cat([gf[n].float().flatten() for n in gf]).norm()
                 ).item()
        atol, rtol = tol["stats"]
        stat_err = {n: ((sp[n] - sf[n]).abs()
                        / (atol + rtol * sf[n].abs())).max().item()
                    for n in sf}
        worst_s = max(stat_err, key=stat_err.get)
        line = (f"resnet50 s2d B={bsz} {dt} step 0, pallas (B4) against "
                f"flax: loss {lp:.6f} / {lf:.6f} |diff| {abs(lp - lf):.3g} "
                f"(tol {tol['loss']}); {len(rel)} leaves, worst "
                f"|g_pallas-g_flax|/|g_flax| {rel[worst]:.3g} at {worst}, "
                f"mean {sum(rel.values()) / len(rel):.3g} (tol "
                f"{tol['grad']}), all leaves as one vector {whole:.3g} (tol "
                f"{tol['whole']}); running stats worst {worst_s} at "
                f"{stat_err[worst_s]:.3g} of tol {atol} + {rtol}|flax|; "
                f"B4 launches {res['pallas_launches']}, flax "
                f"{res['flax_launches']}")
        check(np.isfinite(lp) and abs(lp - lf) <= tol["loss"]
              and rel[worst] <= tol["grad"] and whole <= tol["whole"]
              and stat_err[worst_s] <= 1.0
              and res["pallas_launches"] == 106
              and res["flax_launches"] == 0, line)
        print(line)
        del res, gp, gf, sp, sf

    # The step: launches and copies per step, a falling loss, images/s.
    ips = {}
    for norm in ("pallas", "flax", "bf16stats"):
        model = _resnet_model(torch, resnet, state, norm, torch.bfloat16)
        params = dict(model.named_parameters())
        opt = torch.optim.SGD(dp.tree_leaves(params), lr=0.1, momentum=0.9)
        with torch.enable_grad():
            step = dp.make_train_step(resnet.make_loss_fn(model), opt, group)
            per_step, losses = [], []
            for _ in range(2):
                n0 = (bn.paired_reduce_cuda.launches,
                      bn.paired_reduce_cuda.copies)
                losses += _timed_steps(torch, step, params, batch, 1)[0]
                per_step.append((bn.paired_reduce_cuda.launches - n0[0],
                                 bn.paired_reduce_cuda.copies - n0[1]))
            more, sec = _timed_steps(torch, step, params, batch, 3)
            losses += more
            ips[norm] = B / sec
            line = (f"train resnet50 s2d B={B} bf16 norm={norm}, "
                    f"make_train_step over NCCL world size {group.size()}, "
                    f"SGD(0.1, 0.9): losses {[round(v, 5) for v in losses]}"
                    f", B4 (launches, copies) per step {per_step}")
            want = 106 if norm == "pallas" else 0
            check(all(np.isfinite(losses)) and losses[-1] < losses[0]
                  and all(n == want for n, _ in per_step), line)
            print(line)
            flops = 3 * 2 * macs_per_image * B / sec
            print(f"time train resnet50 s2d B={B} bf16 norm={norm}: "
                  f"{sec * 1e3:.2f} ms/step, {ips[norm]:.1f} images/s, "
                  f"{flops / 1e12:.1f} model TFLOP/s (3 x 2 flops per "
                  f"multiply-add of the forward's {macs_per_image / 1e9:.3f}"
                  f" G per image) (3 steps)")
            if norm == "pallas":
                kern, wall = profile_line(
                    torch, f"train resnet50 B={B} bf16 pallas step",
                    lambda: step(params, batch))
                b4 = sum(e.device_time_total for e in kern
                         if "paired_" in e.key) / 1e3
                busy = sum(e.device_time_total for e in kern) / 1e3
                print(f"profile train resnet50 pallas: B4 (partial + "
                      f"finalize kernels) {b4:.3f} ms of {busy:.1f} ms "
                      f"device time ({b4 / max(busy, 1e-9):.1%})")
        del model, params, opt, step
        torch.cuda.empty_cache()

    fn, args = graft_entry.entry()
    logits = fn(*args)
    torch.cuda.synchronize()
    line = (f"entry(): ResNet-50 eval forward on 8x128x128x3 ones: logits "
            f"{list(logits.shape)} {logits.dtype}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    check(logits.shape == (8, 1000) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), line)
    print(line)
    return ips


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from horovod_tpu_torch import _build, graft_entry
    from horovod_tpu_torch import parallel as dp
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import kv_cache, loop

    counters = {"flash_fwd": fa.flash_fwd_cuda,
                "flash_bwd_dq": fa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": fa.flash_bwd_dkv_cuda,
                "paired_reduce": bn.paired_reduce_cuda}
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    card = card_line()
    print(card)
    spec = card_spec(card)
    libs = sorted({os.path.basename(k["source"])[:-3] for k in KERNELS})
    t0 = time.perf_counter()
    built = _build.build(libs)
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(f"ptxas {lib}: " + ptxas_summary(_build.build_log(lib)))

    worst_fwd, timings = phase_kernel(torch, fa, spec)
    worst_bwd, timings_bwd = phase_kernel_bwd(torch, fa, spec)
    worst = dict(worst_bwd, flash_fwd=worst_fwd)
    timings = {**timings_bwd, **{("flash_fwd", s): t
                                 for s, t in timings.items()}}
    bn_shapes, macs = resnet_layout(torch, resnet, 128, 224)
    worst["paired_reduce"], timings["paired_reduce"] = phase_kernel_b4(
        torch, bn, spec, bn_shapes)

    cfg = tfm.bert_large()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def run_path(name, fn, needs):
        """``fn()`` with every launch count set to 0 just before; checks
        that it launched each kernel of ``needs``; returns the counts."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        ran = {k: c.launches for k, c in counters.items()}
        print(f"launches on the {name} path: {ran}")
        for k in needs:
            check(ran[k] > 0, f"the {name} path never launched {k}")
        return ran, out

    def serving():
        longctx = phase_forward(torch, tfm, fa, params, cfg)
        phase_serve(torch, tfm, loop, kv_cache, params, cfg)
        return longctx

    served, longctx = run_path("serving", serving, ["flash_fwd"])
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        trained, _ = run_path("training", lambda: phase_train(
            torch, tfm, fa, dp, params, cfg, dist.group.WORLD, longctx),
            ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        del params, longctx               # bert-large leaves the card
        torch.cuda.empty_cache()
        resnet_ran, _ = run_path("ResNet training", lambda: phase_resnet(
            torch, resnet, bn, dp, graft_entry, dist.group.WORLD,
            macs // 128), ["paired_reduce"])
    finally:
        dist.destroy_process_group()
    launches = {k: served[k] + trained[k] + resnet_ran[k] for k in counters}

    kernels = []
    for k in KERNELS:
        t = timings.get(k["name"]) or timings[k["name"], (8, 512, 16, 64)]
        kernels.append(dict(k, launches=launches[k["name"]],
                            max_abs_err=worst[k["name"]], ms=t["ms"],
                            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"],
                            library_ms=t["library_ms"]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
