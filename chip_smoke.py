#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (horovod_tpu_torch) on one CUDA card and
hold every phase to its reference. Run from the repo root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. the card's name and power limit; build the CUDA kernels from
   horovod_tpu_torch/csrc (one nvcc per source, all started together);
1. kernel: the flash forward (csrc/flash_fwd.cu) against its plain
   PyTorch version on the card, at the main path's shapes, in bf16 and
   f32, modes none/diag/strict, plus ragged S, head dim 128 and the
   fully masked row under strict; times of the kernel, the plain version
   and torch's scaled_dot_product_attention (a yardstick only; the port
   never calls it) beside the card's bound;
2. forward: bert-large ``forward`` with attn_impl="flash" against
   "gather" (B=8, S=512, bf16 and f32), the kernel's launch count per
   forward, and the long-context eval loss (S=4096, loss_chunk=2048)
   through flash against gather;
3. serve: ``ServeLoop`` at bert-large width over the paged KV cache; in
   float32 every served token's logits are held to
   ``forward(attn_impl="flash")`` over the prompt plus the tokens served
   so far; in bf16 it reports tok/s and TTFT p50;
4. one JSON line of kernels, then the result line.

Exits with code 2, printing no result, when no CUDA device is present.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

KERNELS = [{
    "name": "flash_fwd",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:83",
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
# Long-context eval loss (~10.3 nats), flash against gather in bf16.
TOL_LOSS_BF16 = 2e-2
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
    most device time, from torch.profiler (CUPTI). Wall time includes the
    profiler's own cost, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted((e for e in prof.key_averages()     # kernels only, not
                   if e.device_type == cuda),         # the ops above them
                  key=lambda e: -e.device_time_total)
    if not kern:
        print(f"profile {label}: no device time recorded (not measured)")
        return
    busy = sum(e.device_time_total for e in kern) / 1e3
    top = "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.2f} ms"
                    f" x{e.count}" for e in kern[:6])
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall_ms:.1%}); top: {top}")


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import kv_cache, loop

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    card = card_line()
    print(card)
    spec = card_spec(card)
    t0 = time.perf_counter()
    built = _build.build([k["name"] for k in KERNELS])
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        regs = [ln.strip() for ln in _build.build_log(k["name"]).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {k['name']}: " + " | ".join(regs))

    worst, timings = phase_kernel(torch, fa, spec)

    cfg = tfm.bert_large()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    fa.flash_fwd_cuda.launches = 0          # the main path starts here
    phase_forward(torch, tfm, fa, params, cfg)
    phase_serve(torch, tfm, loop, kv_cache, params, cfg)
    launches = fa.flash_fwd_cuda.launches   # ... and ends here
    check(launches > 0, "the main path never launched flash_fwd")

    t = timings[(8, 512, 16, 64)]
    kernels = [dict(KERNELS[0], launches=launches, max_abs_err=worst,
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
