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
5. one JSON line of kernels, then the result line.

Phases 2-3 (serving) and 4 (training) are the main paths: each starts
with every kernel's launch count at 0 and must launch the kernels it
runs. Exits with code 2, printing no result, when no CUDA device is present.
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
}]

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
                      r"(flash_\w+?_kernel)ILi(\d+)E", ln)
        if m:
            name = f"{m[1]}<{m[2]}>"
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


def profile_line(torch, label, fn):
    """Device busy share over one call of ``fn`` and the kernels that took
    most device time, from torch.profiler (CUPTI); then the host side:
    self CPU time of the ops launched and the ops that took most. Wall
    time includes the profiler's own cost, so the busy share is a lower
    bound and the host times are upper bounds."""
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
        return
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from horovod_tpu_torch import _build
    from horovod_tpu_torch import parallel as dp
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import kv_cache, loop

    counters = {"flash_fwd": fa.flash_fwd_cuda,
                "flash_bwd_dq": fa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": fa.flash_bwd_dkv_cuda}
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

    cfg = tfm.bert_large()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    launches = dict.fromkeys(counters, 0)

    for fn in counters.values():        # the serving path starts here
        fn.launches = 0
    longctx = phase_forward(torch, tfm, fa, params, cfg)
    phase_serve(torch, tfm, loop, kv_cache, params, cfg)
    served = {k: fn.launches for k, fn in counters.items()}   # ... ends
    print(f"launches on the serving path: {served}")
    check(served["flash_fwd"] > 0, "the serving path never launched "
          "flash_fwd")

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for fn in counters.values():    # the training path starts here
            fn.launches = 0
        phase_train(torch, tfm, fa, dp, params, cfg, dist.group.WORLD,
                    longctx)
        trained = {k: fn.launches for k, fn in counters.items()}  # ... ends
    finally:
        dist.destroy_process_group()
    print(f"launches on the training path: {trained}")
    for k in counters:
        check(trained[k] > 0, f"the training path never launched {k}")
        launches[k] = served[k] + trained[k]

    kernels = []
    for k in KERNELS:
        t = timings[k["name"], (8, 512, 16, 64)]
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
