#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (horovod_tpu_torch) on one CUDA card and
hold every phase to its reference. Run from the repo root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. the card's name and power limit; build the CUDA kernels from
   horovod_tpu_torch/csrc (one nvcc per source, all started together);
   each kernel's registers and spills from ptxas, and its local-memory
   loads and stores (LDL/STL) from cuobjdump -sass: no TMA backward
   kernel may have any;
1. kernel: the flash forward (csrc/flash_fwd.cu, B1) and backward
   (csrc/flash_bwd.cu: dQ, B2; dK/dV, B3), each through every variant
   that takes a case (the TMA/wgmma kernel and the mma.sync one in bf16,
   the FMA one in f32), against their plain PyTorch versions on the
   card, at the main path's shapes plus ragged S and head dim 128 (the
   backward also at head dims 32 and 96), in bf16 and f32, modes none/diag/strict; the backward also through
   autograd with a random dO and a nonzero LSE cotangent, and the TMA
   backward kernels twice for the same bits; the fully masked row under
   strict; device times (CUDA graph replays) of the kernels, both bf16
   variants of each in turns, of torch's scaled_dot_product_attention
   forward and backward (a yardstick only; the port never calls it) and
   of the torch ops that make the backward's delta, beside a call's time
   from Python, the plain versions' and the card's bound;
2. forward: bert-large ``forward`` with attn_impl="flash" against
   "gather" (B=8, S=512, bf16 and f32), the kernel's launch count per
   forward, and the long-context eval loss (S=4096, loss_chunk=2048)
   through flash against gather;
3. serve: ``ServeLoop`` at bert-large width over the paged KV cache,
   mesh-free and tensor-parallel through ``create_mesh({"model": 1})``
   over ``hvd.init()``'s NCCL world of size 1 (the params through
   ``shard_params``, the cache's heads over the mesh's model group,
   whose collectives move nothing on one rank, ``sharding.solo``, so no
   NCCL call is made); in float32 every served token's logits are
   held to ``forward(attn_impl="flash")`` over the prompt plus the
   tokens served so far, in each run, and the mesh's rows to the
   mesh-free rows; in bf16 it reports tok/s, TTFT p50 and ITL p50 of
   both side by side, and a profile of each;
4. train: ``make_train_step`` over the same NCCL world with AdamW,
   bert-large B=8 S=512 bf16 flash: step 0's loss and gradients
   through flash against gather (f32 and bf16), launches per step
   (also with remat), a falling loss, tokens/s and a profile; then
   the long-context train step, whose step-0 loss must equal phase 2's
   eval loss;
5. hvd: the Horovod API (horovod_tpu_torch/hvd.py) on the card. (a)
   every collective of ops/torch_ops.py, in-mesh and Horovod, on CUDA
   tensors in f32 and bf16 over the NCCL world of size 1, each output a
   CUDA tensor equal to what size 1 means (the identity; ragged_alltoall
   clamps an overflowing count to its capacity); (b) bert-large B=8
   S=512 bf16 flash through ``hvd.broadcast_parameters`` and
   ``hvd.DistributedOptimizer(AdamW)`` from phase 4's parameters: step
   0's loss, every gradient leaf and every leaf's update against
   ``make_train_step``'s step 0 on the same batch, a falling loss over 4
   steps, tokens/s of both, and one more step in a trace window of
   horovod_tpu_torch/profiler.py, whose ``hvd.<op>`` ranges (count and
   host time) must be there; (c) ``make_train_step`` over
   ``create_mesh({"data": 1})`` with ``data_axis=("data",)`` and
   ``grad_reduce="adasum"``, step 0 against the same reference;
6. mesh: (a) bert-large B=8 S=512 bf16 through ``loss_fn(mesh=...)``
   under ``make_train_step`` over ``create_mesh({"data": 1, "seq": 1,
   "model": 1})`` (NCCL; the params through ``shard_params``), with
   ``attn_impl="flash"`` and ``"ring"``: step 0's loss, every gradient
   leaf and (flash) every update against the mesh-free step from the
   same parameters (flash against flash, bit-equal expected; ring
   against gather), a falling loss, 3 timed steps of each beside the
   mesh-free step's, and a profile (host op calls a step); (b) the
   ring's per-pair update (parallel/ring_attention.py ``accumulate``) at
   p = 4 in one process, q, k, v [1, 4096, 16, 64] bf16 in four
   1024-row blocks, both layouts, causal and not: every (my, src) pair
   in ring order as rank my runs it, the output and the gradients of q,
   k and v for a random dO held to ``flash_attention`` over the whole
   sequence, the flash step also to the same ring through the kernels'
   plain versions, and the einsum step to the whole sequence; B1's,
   B2's and B3's launches by mask mode;
7. moe: (a) ``make_moe_layer`` (parallel/expert_parallel.py) at
   bench.py's card shape T=4096, D=1024, F=4096, E=8, bf16, over a
   one-rank ``{"expert": 1}`` mesh, dense and ragged, against a plain
   dense routing at a generous capacity, at capacity 1.25 and under
   skewed routing with the dropped tokens' rows zero and the same tokens
   dropped by both, ``hvd.ep_stats()``, tokens/s; (b) bert-large widths
   with 8 experts in each of MOE_LAYERS layers through ``loss_fn(mesh=
   ...)`` over ``{"data": 1, "expert": 1}``, step 0 (loss, every
   gradient and update) held to the mesh-free MoE step, a falling loss,
   tokens/s beside the mesh-free step, peak device memory, a profile;
   (c) the same widths with ``expert_axis="data"`` over ``{"data": 1}``
   at MOE_DP_EP_LAYERS layers, the experts gathered over data and the
   leaves cut over it left out of its all-reduce, step 0 held to the
   mesh-free step;
8. pipeline: bert-large B=8 S=512 flash through parallel/pipeline.py
   over ``create_mesh({"pipe": 1})`` on the same NCCL world, the
   embedding outside the pipeline, the 24 blocks as stage slices, the
   final layernorm, tied head and NLL per microbatch, M=4 microbatches,
   under gpipe, 1f1b, zb (which falls back to 1f1b at one stage, the
   ``single_stage`` fallback counted) and interleaved:2: step 0 in
   float32 and bf16 held to the mesh-free ``tfm.loss_fn`` autograd step
   (loss and every block leaf, TOL_PIPE) and to gpipe's
   (TOL_PIPE_SCHED), B1-B3's launches a step against what the tables
   imply (PIPE_LAUNCHES), every bf16 one on its TMA kernel, the peak
   device memory of each (1f1b's below gpipe's), a falling loss and 3
   timed AdamW steps of each beside the mesh-free ``make_train_step``,
   and a profile of gpipe and 1f1b;
9. checkpoint: bert-large's train state (f32 params and AdamW moments,
   ~4 GB) through horovod_tpu_torch/checkpoint.py, with B=8 S=512 bf16
   flash steps through ``make_train_step`` over the same NCCL world:
   step 0, a sync save of ``{params, opt: optimizer_state_tree}`` into a
   fresh temporary directory, step 1; a restore into fresh params and a
   fresh AdamW (every leaf bit-equal to the snapshot) and step 1 again,
   bit-equal to the uninterrupted step 1 or within TOL_HVD (the line
   says which held); an async save followed at once by a step that
   updates the saved tensors in place, ``wait`` and a restore, bit-equal
   to the snapshot; a save and restore of ``shard_params``-marked params
   over ``{"model": 1}``; the bytes written, the sync save's wall time
   against the async save's blocking time, ``write_ms``, restore ms and
   GB/s, and the free disk space first; B1-B3's launches over the four
   steps. Each step directory is deleted once checked;
10. elastic: (a) the same train state in an ``elastic.TorchState`` under
   ``elastic.run_fn``: step 1 and a commit; step 2 aborts the NCCL world
   group after its forward, so its gradient reduction raises
   ``HorovodInternalError``; restore, the reset (``distributed.teardown``
   then ``hvd.init()`` and a first collective: a new world) and sync,
   then step 2 again, every leaf held to an uninterrupted step 2
   (bit-equal expected, else TOL_HVD); commit_ms, restore_ms, abort_ms,
   reset_ms, sync_ms and the NCCL groups live before and after; (b) the
   port's launcher with ``--min-np 1 --max-np 1`` over this file's
   ``--elastic-worker`` mode at bert-large widths cut to
   ELASTIC_B_LAYERS layers: a checkpoint at step 2 (reported to the
   driver), a SIGKILL at step 3, the driver's respawn restoring the
   published step and running to step 4, its params held to an
   uninterrupted 4-step run in this process; rc 0, no worker left, this
   process's HVD_* variables unchanged; the kill-to-first-step time.
   The world after it is the reset's new one;
11. observability: (a) OBS_STEPS bert-large B=8 S=512 bf16 flash steps
   through ``hvd.DistributedOptimizer(AdamW)`` with metrics off, then on
   (``HVD_METRICS``; horovod_tpu_torch/observability), from the same
   weights: losses and every leaf bit-equal, ``metrics.snapshot()``
   counting exactly the steps' Horovod ops and bytes (one ``allreduce``
   per leaf, as the reference counts a grouped op, and one for the loss),
   the stall inspector empty and silent; the step time off and on; (b) a
   forced stall (``configure`` of the process-wide inspector to 0.5 s /
   1 s, one ``report_start`` that never ends): one warning, and the next
   ``hvd.allreduce`` raises ``StallError`` naming the op; (c) one more
   step in a profiler window inside a Python span: ``spans.dump`` and
   ``merge_traces`` write one JSON file holding the ``hvd.*`` ranges and
   the span, sorted by ``ts``; (d) the serve phase's 8 bf16 requests
   through ``ServeLoop`` with a ``load_reporter`` feeding an
   ``AutoscalePolicy``, every observation and decision printed, the
   tokens equal to a run without the reporter on the same tick clock;
   (e) the port's launcher with ``--serve-autoscale --min-np 1 --max-np 1
   --metrics --metrics-port 0`` over this file's ``--serve-worker`` mode:
   the worker's ``hvd.init()`` starts its ``/metrics`` endpoint, it serves
   the 8 requests with ``worker.report_serve_load`` as its reporter and
   scrapes and parses its own ``/metrics``; the driver consumed every
   report, ``target_np`` 1, no autoscale event; rc 0, no worker left;
12. resnet: ResNet-50 (s2d stem, B=128, 224x224, bf16, SGD(0.1, 0.9)),
   the bench's resnet50 config, through ``make_train_step`` over the
   same group: step 0 with norm="pallas" (the B4 kernel BN) against
   norm="flax" (torch ops) from the same weights, in float32 at B=16
   and in bf16 at B=128 (loss, every gradient leaf, every running mean
   and var); B4's launches (106) and layout copies per step; a falling
   loss over 5 steps; images/s for each of the three norms and a
   profile; the eval ``entry()``'s logits;
13. one JSON line of kernels, then the result line.

Every profile line opens its window through horovod_tpu_torch/profiler.py
(``start``/``stop``; the trace goes to a temporary directory).

The kernel phase 1 also holds B4 (csrc/paired_reduce.cu) against its
plain version at every (R, C) a ResNet-50 step gives it, at ragged
shapes and on an unaligned pointer, bf16 and f32, as (x, x) and (dy, x),
checks that two launches give the same bits, and times the kernel, the
plain version and torch's own batch-norm reductions (yardsticks only).

Phases 2-3 (serving), 4 (training), 5 (the Horovod API), 6 (the mesh),
7 (MoE), 8 (the pipeline), 9 (the checkpoint), 10 (elastic; B1-B3
launches of this process only), 11 (observability; this process only)
and 12 (ResNet training) are the main paths:
each starts with every kernel's launch count at 0 and must launch the
kernels it runs, every bf16 launch of B1, B2 and B3 on its TMA/wgmma
kernel. The card has one
device and NCCL takes one rank per device, so every NCCL group here has
one rank; more ranks are checked over gloo on the CPU
(tests/test_torch_*.py). Exits with code 2, printing no result, when no
CUDA device is present.
"""

import contextlib
import dataclasses
import faulthandler
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# B1, B2 and B3 each have two bf16 kernels (ops/flash_attention.py
# _FWD_VARIANTS, _BWD_VARIANTS), picked per call by a wrapper: the
# TMA/wgmma one ("tma") takes every bf16 call of the main paths and is
# named after its wrapper (its launches are all of the wrapper's, by
# variant beside them); the mma.sync one ("mma", "<wrapper>_mma") takes
# the other bf16 calls.
KERNELS = [{
    "name": "flash_fwd",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:83",
    "wrapper": "flash_fwd",
    "variant": "tma",
}, {
    "name": "flash_fwd_mma",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:83",
    "wrapper": "flash_fwd",
    "variant": "mma",
}, {
    "name": "flash_bwd_dq",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:130",
    "wrapper": "flash_bwd_dq",
    "variant": "tma",
}, {
    "name": "flash_bwd_dq_mma",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:130",
    "wrapper": "flash_bwd_dq",
    "variant": "mma",
}, {
    "name": "flash_bwd_dkv",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:166",
    "wrapper": "flash_bwd_dkv",
    "variant": "tma",
}, {
    "name": "flash_bwd_dkv_mma",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
    "replaces": "horovod_tpu/ops/pallas_attention.py:166",
    "wrapper": "flash_bwd_dkv",
    "variant": "mma",
}, {
    "name": "paired_reduce",
    "route": "cuda",
    "source": "horovod_tpu_torch/csrc/paired_reduce.cu",
    "replaces": "horovod_tpu/ops/pallas_norm.py:62",
    "wrapper": "paired_reduce",
}]
# The wrappers whose kernels come in variants, and their launch counters'
# names in ops/flash_attention.py.
VARIANT_WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def variant_names(wrapper):
    """{variant: kernel name} of a wrapper's bf16 kernels in KERNELS."""
    return {k["variant"]: k["name"] for k in KERNELS
            if k["wrapper"] == wrapper and "variant" in k}


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
# The hvd phase's bert-large step 0 (DistributedOptimizer; make_train_step
# over a Mesh with adasum) against make_train_step's mean step 0 from the
# same parameters and batch. At world size 1 every reduction is the
# identity, so the two run the same kernels on the same inputs: the loss
# within 1e-5 (a reordered f32 sum of ~4096 NLLs of ~10 would move it
# ~1e-6), every gradient leaf within 1e-4 in relative norm (room for an
# accumulation in another order), and every leaf's update (after - before)
# within 1e-2 in relative norm: AdamW's first update is ~lr * sign(g), so
# an element whose gradient is at float32 noise may flip, but a wrong
# gradient moves the update by ~1.
TOL_HVD = dict(loss=1e-5, grad=1e-4, update=1e-2)
# The mesh phase's bert-large step 0 through loss_fn(mesh=...) over a mesh
# of one rank against the mesh-free step. flash against flash: every
# group has one rank, so each collective of parallel/sharding.py returns
# its input (``sharding.solo``) and both steps run the same kernels on
# the same inputs; the hvd phase's
# gates (TOL_HVD), and the line counts the bit-equal leaves. ring against
# gather: the ring's einsum step keeps the logits, the probabilities and
# P.V in float32 where gather rounds each to bf16, the same kind of
# difference as flash against gather in the train phase, with its gates
# (and none on AdamW's first update, ~lr * sign(g), whose signs flip
# where two such gradients differ).
TOL_MESH_FLASH = TOL_HVD
TOL_MESH_RING = dict(loss=TOL_TRAIN_BF16_LOSS, grad=TOL_TRAIN_BF16_GRAD)
# The ring of 4 in one process at [1, 4096, 16, 64] bf16: the output
# within 2e-2 of the reference per element, relative to 1 + |ref| (each
# block pair's output is rounded to bf16 before the float32 merge, up to
# four of them a row, plus the final rounding: 2^-9 relative each, and
# the kernels' P in bf16 as in TOL_O); every gradient within 2e-2 in
# relative norm (a block's dq, dk and dv are sums of up to four pairs'
# bf16 gradients, added in bf16 by autograd, against one kernel's f32
# accumulation over the whole sequence).
TOL_RING = dict(out=2e-2, grad=2e-2)
# B1's, B2's and B3's launches by mode over the four rings (contiguous
# causal: the diagonal 4 and the earlier blocks 6, the later ones
# skipped; striped causal: 10 diag and 6 strict; not causal, each layout:
# 16 none).
RING_MODES = {"none": 6 + 16 + 16, "diag": 4 + 10, "strict": 6}
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


def _kernel_name(mangled):
    """'flash_bwd_dq_tma_kernel<64>' from a mangled kernel name, or None."""
    m = re.search(r"\d((?:flash|paired)_\w+?_kernel)(?:I(\w+?)E)?E?v",
                  mangled)
    if not m:
        return None
    arg = re.fullmatch(r"Li(\d+)E?", m[2] or "")
    arg = arg[1] if arg else m[2]
    return f"{m[1]}<{arg}>" if arg else m[1]


def ptxas_summary(log):
    """[(kernel, registers, bytes spilled)] from the compiler's -Xptxas -v
    report, in its order."""
    out, name, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = _kernel_name(m[1])
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m[1])
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m[1]), spill))
            name, spill = None, None
    return out


def sass_local(path):
    """{kernel: (local-memory loads and stores (LDL, STL), highest
    register named)} in the machine code of the library at ``path``
    (cuobjdump -sass): a spill compiles to LDL/STL, also where
    setmaxnreg's budget was not applied, and the highest register shows
    what a warpgroup's budget holds."""
    from horovod_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = _kernel_name(m[1])
            if name:
                out[name] = [0, 0]
        elif name:
            if re.search(r"\b(?:LDL|STL)\b", ln):
                out[name][0] += 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
            out[name][1] = max([out[name][1]] + regs)
    return {k: tuple(v) for k, v in out.items()}


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


def graph_ms(torch, fn, reps, stream=None):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph and replayed, timed with CUDA events, so the host's cost of a
    call (Python, ctypes, allocation) drops out. ``stream`` is the one to
    capture on (a new one by default); a backward through autograd is
    captured on the stream its forward ran on."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def profiled(torch, fn):
    """(the profile of one call of ``fn``, wall ms): a trace window of
    horovod_tpu_torch/profiler.py (torch.profiler over the CPU and CUDA,
    CUPTI on the card), its trace written into a temporary directory
    that is removed after."""
    from horovod_tpu_torch import profiler

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        profiler.start(logdir)
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            prof = profiler.stop()
    return prof, wall_ms


def profile_line(torch, label, fn):
    """Device busy share over one call of ``fn`` and the kernels that took
    most device time, from its profile (:func:`profiled`); then the host
    side: self CPU time of the ops launched and the ops that took most.
    Wall time includes the profiler's own cost, so the busy share is a
    lower bound and the host times are upper bounds. Returns (the
    kernels' events, wall ms)."""
    prof, wall_ms = profiled(torch, fn)
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


def _bwd_check(torch, fa, label, got, plain, dname, mode):
    """One backward result (dq, dk, dv) against the plain backward's,
    within TOL_BWD; under strict, row 0 (which sees no key) must get
    dQ = 0. Returns the line and each output's max error."""
    atol, rtol = TOL_BWD[dname]
    parts = []
    for name, a, b in zip(("dq", "dk", "dv"), got, plain):
        diff = (a.float() - b.float()).abs()
        within = bool((diff <= atol + rtol * b.float().abs()).all())
        parts.append((name, diff.max().item(), within))
    line = (f"{label}: " + ", ".join(
        f"max|{n}-plain| {e:.3g} ({'ok' if w else 'FAIL'})"
        for n, e, w in parts) + f" (tol {atol} + {rtol}|plain|)")
    check(all(w for _, _, w in parts)
          and all(bool(torch.isfinite(t).all()) for t in got), line)
    if mode == "strict":   # row 0 sees no key
        check(bool((got[0][:, 0] == 0).all()),
              f"{line}: masked row 0 has dQ != 0")
        line += "; masked row 0: dQ=0"
    return line, {n: e for n, e, _ in parts}


def phase_kernel_bwd(torch, fa, spec):
    """B2 and B3 against _flash_bwd_plain on the same inputs: through
    autograd (flash_attention_lse's _FlashFn, a random dO and a nonzero
    dLSE), where the default pick (_bwd_variant) must be "tma" for every
    bf16 case the TMA kernels take; then through every variant that takes
    each case, called directly, the tma kernels twice for the same bits.
    Then both bf16 variants timed in turns beside SDPA's backward and the
    torch ops that make delta in _FlashFn.backward. Returns the worst
    error at the main path's shape per kernel, and the timings."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    # D=32 leaves half of TMA's 64-column atom zero; D=96 fills a second
    # atom in part, where the epilogue cuts columns past D.
    cases = [(s, d, m) for s in [(8, 512, 16, 64), (1, 4096, 16, 64),
                                 (3, 1000, 16, 64), (2, 333, 4, 128),
                                 (2, 333, 4, 32), (2, 333, 4, 96)]
             for d in dts for m in fa.MODES]
    fns = {"flash_bwd_dq": fa.flash_bwd_dq_cuda,
           "flash_bwd_dkv": fa.flash_bwd_dkv_cuda}
    worst = {n: 0.0 for w in fns for n in variant_names(w).values()}
    for shape, dname, mode in cases:
        B, S, H, D = shape
        scale = D ** -0.5
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dts[dname]) for _ in range(4))
        dlse = torch.randn((B, H, S), generator=gen, device="cuda")
        with torch.enable_grad():
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o, lse = fa.flash_attention_lse(qg, kg, vg, mode=mode, block=512)
            got = torch.autograd.grad((o, lse), (qg, kg, vg), (do, dlse))
        torch.cuda.synchronize()
        o, lse = o.detach(), lse.detach()
        delta = _delta(o, do, dlse)
        plain = fa._flash_bwd_plain(q, k, v, o, lse, do, delta, mode, scale,
                                    fa._validate(q, k, v, 512))
        pick = fa._bwd_variant(q, k, v, do)
        want = "fma" if dname == "float32" else "tma"
        check(pick == want, f"flash_bwd {list(shape)} {dname} would take "
                            f"{pick!r}, not {want!r}")
        line, _ = _bwd_check(torch, fa, f"kernel flash_bwd[autograd: {pick}]"
                             f" {list(shape)} {dname} {mode}", got, plain,
                             dname, mode)
        print(line)
        args = (q, k, v, do, lse, delta, mode, scale)
        for var in (x for x in fa._BWD_VARIANTS
                    if fa._bwd_takes(x, q, k, v, do)):
            res = (fns["flash_bwd_dq"](*args, variant=var),
                   *fns["flash_bwd_dkv"](*args, variant=var))
            torch.cuda.synchronize()
            line, err = _bwd_check(torch, fa, f"kernel flash_bwd[{var}] "
                                   f"{list(shape)} {dname} {mode}", res,
                                   plain, dname, mode)
            if var == "tma":   # the same inputs give the same bits
                again = (fns["flash_bwd_dq"](*args, variant=var),
                         *fns["flash_bwd_dkv"](*args, variant=var))
                same = all(torch.equal(a, b) for a, b in zip(res, again))
                line += f"; two launches {'bit-equal' if same else 'DIFFER'}"
                check(same, line)
            print(line)
            if shape == (8, 512, 16, 64) and dname == "bfloat16":
                for w in fns:
                    name = variant_names(w).get(var)
                    e = err["dq"] if w == "flash_bwd_dq" \
                        else max(err["dk"], err["dv"])
                    if name:
                        worst[name] = max(worst[name], e)
        del q, k, v, do, o, lse, delta, got, plain

    timings = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in [(8, 512, 16, 64), (1, 4096, 16, 64)]:
        B, S, H, D = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_fwd_cuda(q, k, v, "diag", D ** -0.5)
        dlse = torch.zeros_like(lse)
        delta = _delta(o, do, dlse)
        args = (q, k, v, do, lse, delta, "diag", D ** -0.5)
        block = fa._validate(q, k, v, 512)
        # SDPA's forward runs on the stream its backward is captured on.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.enable_grad():
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = sdpa(qt, kt, vt, is_causal=True)
        torch.cuda.current_stream().wait_stream(side)
        dot = do.transpose(1, 2)
        reps = 20 if S == 512 else 10
        plain_ms = time_ms(torch, lambda: fa._flash_bwd_plain(
            q, k, v, o, lse, do, delta, "diag", D ** -0.5, block), reps)
        library_ms = graph_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps, stream=side)
        delta_ms = graph_ms(torch, lambda: _delta(o, do, dlse), reps)
        runs = {}
        for var in ("tma", "mma", "mma", "tma"):   # in turns
            for w, fn in fns.items():
                runs.setdefault((w, var), []).append(graph_ms(
                    torch, lambda fn=fn, var=var: fn(*args, variant=var),
                    reps))
        pair = {}
        for w, fn in fns.items():
            for var, name in variant_names(w).items():
                t = {"ms": sum(runs[w, var]) / len(runs[w, var]),
                     "call_ms": time_ms(torch, lambda fn=fn, var=var: fn(
                         *args, variant=var), reps),
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "delta_ms": delta_ms}
                t["bound_ms"], t["bound_by"] = bwd_bound_ms(
                    shape, "bfloat16", "diag", w, spec)
                timings[name, shape] = t
                pair[var] = pair.get(var, 0.0) + t["ms"]
                print(f"time {w}[{var}] {list(shape)} bf16 diag: kernel "
                      f"{t['ms']:.4f} ms (turns {runs[w, var][0]:.4f} / "
                      f"{runs[w, var][1]:.4f}; a call from Python "
                      f"{t['call_ms']:.4f} ms), plain (dq, dk, dv together) "
                      f"{plain_ms:.4f} ms, sdpa backward (dq, dk, dv "
                      f"together) {library_ms:.4f} ms, bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {spec[0]} "
                      f"peaks), kernel at {t['bound_ms'] / t['ms']:.1%} of "
                      f"bound")
        bound = sum(bwd_bound_ms(shape, "bfloat16", "diag", w, spec)[0]
                    for w in fns)
        for var, ms in pair.items():
            print(f"time flash_bwd pair[{var}] {list(shape)} bf16 diag: B2 + "
                  f"B3 {ms:.4f} ms, with delta's torch ops ({delta_ms:.4f} "
                  f"ms) {ms + delta_ms:.4f} ms, against sdpa backward "
                  f"{library_ms:.4f} ms: {(ms + delta_ms) / library_ms:.2f}x"
                  f" with delta, {ms / library_ms:.2f}x without; bound "
                  f"{bound:.4f} ms, pair at {bound / ms:.1%} of it")
        del out
    return worst, timings


def phase_kernel(torch, fa, spec):
    """B1 against _flash_plain through every variant that takes each case
    (the default pick, _fwd_variant, must be "tma" for every bf16 case
    here); then both bf16 variants timed in turns. Returns the worst
    |O - plain| at the main path's shape per kernel, and the timings."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = [(s, d, m) for s in [(8, 512, 16, 64), (1, 4096, 16, 64),
                                 (3, 1000, 16, 64), (2, 333, 4, 128)]
             for d in dts for m in fa.MODES]
    names = variant_names("flash_fwd")
    worst = dict.fromkeys(names.values(), 0.0)
    for shape, dname, mode in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dts[dname]) for _ in range(3))
        scale = shape[-1] ** -0.5
        po, plse = fa._flash_plain(q, k, v, mode, scale,
                                   fa._validate(q, k, v, 512))
        pick = fa._fwd_variant(q, k, v)
        check(pick == ("tma" if dname == "bfloat16" else "fma"),
              f"flash_fwd {list(shape)} {dname} would take {pick!r}")
        atol, rtol = TOL_O[dname]
        for var in (x for x in fa._FWD_VARIANTS
                    if fa._fwd_takes(x, q, k, v)):
            o, lse = fa.flash_fwd_cuda(q, k, v, mode, scale, variant=var)
            torch.cuda.synchronize()
            diff = (o.float() - po.float()).abs()
            err_o = diff.max().item()
            within = bool((diff <= atol + rtol * po.float().abs()).all())
            err_l = (lse - plse).abs().max().item()
            line = (f"kernel flash_fwd[{var}] {list(shape)} {dname} {mode}:"
                    f" max|O-plain| {err_o:.3g} (tol {atol} + {rtol}|O|: "
                    f"{'ok' if within else 'FAIL'}) max|LSE-plain| "
                    f"{err_l:.3g} (tol {TOL_LSE})")
            check(within and err_l <= TOL_LSE, line)
            if mode == "strict":   # row 0 sees no key
                check(bool((o[:, 0] == 0).all())
                      and bool((lse[:, :, 0] == fa.NEG_INF).all()),
                      f"{line}: masked row 0 is not O=0, LSE=-1e30")
                line += "; masked row 0: O=0, LSE=-1e30"
            print(line)
            if shape == (8, 512, 16, 64) and var in names:
                worst[names[var]] = max(worst[names[var]], err_o)
        del q, k, v, po, plse

    # K/V expanded over B or H: stride 0, which no TMA map takes; the
    # rule must send them to mma, which reads them as they lie.
    q = torch.randn((2, 24, 3, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    base = torch.randn((2, 24, 3, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    atol, rtol = TOL_O["bfloat16"]
    for over, kv in (("B", base[:1].expand(2, 24, 3, 64)),
                     ("H", base[:, :, :1].contiguous().expand(2, 24, 3, 64))):
        pick = fa._fwd_variant(q, kv, kv)
        check(pick == "mma", f"flash_fwd with K/V expanded over {over} "
              f"(strides {kv.stride()}) would take {pick!r}")
        for mode in fa.MODES:
            po, plse = fa._flash_plain(q, kv, kv, mode, 0.125,
                                       fa._validate(q, kv, kv, 512))
            o, lse = fa.flash_fwd_cuda(q, kv, kv, mode, 0.125)
            torch.cuda.synchronize()
            diff = (o.float() - po.float()).abs()
            err_l = (lse - plse).abs().max().item()
            line = (f"kernel flash_fwd[{pick}] [2, 24, 3, 64] bf16 {mode} "
                    f"K/V expanded over {over} (strides {kv.stride()}): "
                    f"max|O-plain| {diff.max().item():.3g} (tol {atol} + "
                    f"{rtol}|O|), max|LSE-plain| {err_l:.3g} (tol "
                    f"{TOL_LSE})")
            check(bool((diff <= atol + rtol * po.float().abs()).all())
                  and err_l <= TOL_LSE, line)
            print(line)
    del q, base

    timings = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in [(8, 512, 16, 64), (1, 4096, 16, 64)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        block = fa._validate(q, k, v, 512)
        scale = shape[-1] ** -0.5
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = 50 if shape[1] == 512 else 20
        plain_ms = time_ms(torch, lambda: fa._flash_plain(
            q, k, v, "diag", scale, block), reps)
        library_ms = graph_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True),
                              reps)
        bound = flash_bound_ms(shape, "bfloat16", "diag", spec)
        runs = {var: [] for var in names}
        for var in ("tma", "mma", "mma", "tma"):   # in turns
            runs[var].append(graph_ms(torch, lambda var=var: fa.flash_fwd_cuda(
                q, k, v, "diag", scale, variant=var), reps))
        for var, name in names.items():
            t = {"ms": sum(runs[var]) / len(runs[var]),
                 "call_ms": time_ms(torch, lambda var=var: fa.flash_fwd_cuda(
                     q, k, v, "diag", scale, variant=var), reps),
                 "plain_ms": plain_ms, "library_ms": library_ms}
            t["bound_ms"], t["bound_by"] = bound
            timings[name, shape] = t
            print(f"time flash_fwd[{var}] {list(shape)} bf16 diag: kernel "
                  f"{t['ms']:.4f} ms (turns {runs[var][0]:.4f} / "
                  f"{runs[var][1]:.4f}; a call from Python "
                  f"{t['call_ms']:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
                  f"{library_ms:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}, {spec[0]} peaks), kernel at "
                  f"{t['bound_ms'] / t['ms']:.1%} of bound")
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


def _serve_f32(torch, tfm, loop, params, cfg32, geo, label, **kw):
    """Serve 8 requests in float32 and hold every served row's logits to
    ``forward(attn_impl="flash")`` over the prompt plus the tokens served
    so far, near-ties counted; returns ({rid: tokens served}, {(rid,
    context length): logits}).
    ``params`` may be a one-rank mesh's shard: that is the whole tree, so
    the mesh-free ``forward`` takes it as it is."""
    flash32 = dataclasses.replace(cfg32, attn_impl="flash")
    sl = loop.ServeLoop(params, cfg32, geo=geo, max_batch=8, **kw)
    log = []
    _record(sl, log)
    sl.warmup()
    reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(2),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg32.vocab_size)
    summary, finished = sl.run(reqs)
    check(len(finished) == 8 and all(r.finish_reason for r in finished),
          f"serve f32 {label}: {len(finished)} of 8 requests finished")
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
                      f"serve f32 {label} rid {rid} token {i}: served {tok}, "
                      f"forward argmax {int(row.argmax())}, gap {gap:.3g}")
                ties.append((rid, i, gap))
        for lrid, ctx_len, logits in (e for e in log if e[0] == rid):
            worst = max(worst, (logits - ref[ctx_len - 1]).abs().max().item())
            checked += 1
    n_tokens = sum(len(r.generated) for r in finished)
    line = (f"serve bert-large f32 {label}: {len(finished)} requests, "
            f"{n_tokens} tokens, {checked} served logit rows, "
            f"max|served-forward(flash)| {worst:.3g} (tol {TOL_SERVE_F32}), "
            f"near-ties {ties}")
    check(checked == n_tokens and worst <= TOL_SERVE_F32, line)
    print(line)
    return ({r.rid: list(r.generated) for r in finished},
            {(rid, ctx_len): logits for rid, ctx_len, logits in log})


def _serve_bf16(torch, loop, params, cfg, geo, **kw):
    """(summary of 8 bf16 requests after a warmup, the loop, {rid: tokens
    served})."""
    sl = loop.ServeLoop(params, cfg, geo=geo, max_batch=8, **kw)
    sl.warmup()
    torch.cuda.synchronize()
    reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(3),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg.vocab_size)
    summary, finished = sl.run(reqs)
    check(len(finished) == 8 and all(r.finish_reason for r in finished),
          f"serve bf16 {kw}: {len(finished)} of 8 requests finished")
    return summary, sl, {r.rid: list(r.generated) for r in finished}


def phase_serve(torch, tfm, loop, kv_cache, convert, hvd, params, cfg,
                card):
    """ServeLoop at bert-large width, mesh-free and tensor-parallel over
    a one-rank ``{"model": 1}`` NCCL mesh (params through
    ``shard_params``): float32 rows against forward(flash), then bf16
    tok/s and latencies of both, side by side, and a profile of each."""
    geo = kv_cache.geometry(n_pages=256, page_size=16, max_context=512)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mesh = hvd.global_mesh({"model": 1})
    sharded = convert.shard_params(params, cfg, mesh)

    free = _serve_f32(torch, tfm, loop, params, cfg32, geo, "mesh-free",
                      device="cuda")
    meshed = _serve_f32(torch, tfm, loop, sharded, cfg32, geo,
                        f"through {mesh}", mesh=mesh)
    # Each run is held to forward above; where a request's chain is the
    # same in both (a near-tie may flip one), its rows are compared.
    same = [rid for rid, toks in free[0].items() if meshed[0][rid] == toks]
    both = [k for k in free[1] if k[0] in same]
    diff = max((meshed[1][k] - free[1][k]).abs().max().item() for k in both)
    line = (f"serve bert-large f32 {mesh} against mesh-free: {len(same)} "
            f"of {len(free[0])} requests served the same tokens, their "
            f"{len(both)} rows max|mesh - mesh-free| {diff:.3g} (tol "
            f"{TOL_SERVE_F32})")
    check(both and all(k in meshed[1] for k in both)
          and diff <= TOL_SERVE_F32, line)
    print(line)

    # bf16: throughput and latency, mesh-free beside the mesh.
    runs = {"mesh-free": _serve_bf16(torch, loop, params, cfg, geo,
                                     device="cuda"),
            str(mesh): _serve_bf16(torch, loop, sharded, cfg, geo,
                                   mesh=mesh)}
    for name, (summary, _, _) in runs.items():
        print(f"serve bert-large bf16 {name} ({card}): "
              f"{summary['requests']} requests, {summary['tokens']} tokens, "
              f"{summary['tok_s']} tok/s, TTFT p50 "
              f"{summary['ttft_p50_ms']} ms, ITL p50 {summary['itl_p50_ms']} "
              f"ms, batch fill {summary['batch_fill_mean']}")
    for name, (_, sl, _) in runs.items():
        reqs = loop.poisson_requests(8, 40.0, np.random.default_rng(4),
                                     prompt_len=(16, 128), max_new=(16, 32),
                                     vocab=cfg.vocab_size)
        profile_line(torch, f"serve bert-large bf16 {name} (8 more "
                     f"requests)", lambda: sl.run(reqs))
    return runs["mesh-free"][2]


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


# optax.adamw(1e-4), the bench's optimizer, in PyTorch's terms (torch's
# default weight_decay is 1e-2, optax's 1e-4).
ADAMW = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _adamw(torch, dp, params):
    return torch.optim.AdamW(dp.tree_leaves(params), **ADAMW)


def _recording_adamw(torch, dp, params):
    """_adamw that keeps the gradients its first step is given, in leaf
    order, in ``.grads``."""
    class FirstGrads(torch.optim.AdamW):
        grads = None

        def step(self, closure=None):
            if self.grads is None:
                self.grads = [p.grad.detach().clone()
                              for g in self.param_groups for p in g["params"]]
            return super().step(closure)

    return FirstGrads(dp.tree_leaves(params), **ADAMW)


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


def _hvd_collectives(torch, hvd, ops):
    """Every collective on CUDA tensors over hvd's world; returns the
    number of checks."""
    ps = hvd.global_process_set
    g = ps.group
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(64, 33, generator=gen, device="cuda").to(dt)
        recv, counts = ops.ragged_alltoall(
            x[:5], torch.tensor([5], device="cuda"), g, 3)
        split_out, split_in = hvd.alltoall(x, splits=[64])
        tree = hvd.allreduce_pytree({"a": x, "b": [x]})
        btree = hvd.broadcast_pytree({"a": x, "b": [x]}, root_rank=0)
        cases = [(f"allreduce {name}", ops.allreduce(x, g, op), x)
                 for name, op in (("Sum", ops.Sum), ("Average", ops.Average),
                                  ("Min", ops.Min), ("Max", ops.Max),
                                  ("Product", ops.Product),
                                  ("Adasum", ops.Adasum))] + [
            ("adasum", ops.adasum(x, g), x),
            # NCCL coalesces the pair (the ring's rotation), to itself here
            ("sendrecv", ops.sendrecv(x, g, 0, 0), x),
            ("allgather", ops.allgather(x, g), x),
            ("broadcast", ops.broadcast(x, g, 0), x),
            ("alltoall 0 0", ops.alltoall(x, g, 0, 0), x),
            ("alltoall 1 0", ops.alltoall(x, g, 1, 0), x),
            ("reducescatter Sum", ops.reducescatter(x, g, ops.Sum), x),
            ("reducescatter Average", ops.reducescatter(x, g, ops.Average),
             x),
            ("ragged_alltoall rows", recv, x[:3][None]),
            ("ragged_alltoall counts (5 clamped to capacity 3)", counts,
             torch.tensor([3], dtype=torch.int32, device="cuda")),
            ("hvd.allreduce", hvd.allreduce(x), x),
            ("hvd.allreduce Sum x2 /2", hvd.allreduce(
                x, hvd.Sum, prescale_factor=2.0, postscale_factor=0.5), x),
            ("hvd.allreduce Adasum", hvd.allreduce(x, hvd.Adasum), x),
            ("hvd.allreduce_pytree", tree["b"][0], x),
            ("hvd.allgather", hvd.allgather(x), x),
            ("hvd.alltoall", hvd.alltoall(x), x),
            ("hvd.alltoall splits", split_out, x),
            ("hvd.alltoall received splits", split_in,
             torch.tensor([64], device="cuda")),
            ("hvd.reducescatter", hvd.reducescatter(x), x),
            ("hvd.broadcast", hvd.broadcast(x, root_rank=0), x),
            ("hvd.broadcast_pytree", btree["b"][0], x)]
        for name, got, want in cases:
            check(got.is_cuda and got.dtype == want.dtype
                  and torch.equal(got, want),
                  f"hvd {name} {dt} at world size 1: {got.device} "
                  f"{got.dtype} {tuple(got.shape)}, not the identity")
        n += len(cases)
    obj = {"rank": hvd.rank(), "w": [1.5, "x"]}
    check(hvd.allgather_object(obj) == [obj]
          and hvd.broadcast_object(obj, root_rank=0) == obj
          and hvd.metric_average(2.5) == 2.5,
          "hvd object ops at world size 1")
    hvd.barrier()
    return n + 4


def _step0_against(torch, label, ref, before, loss, grads, after, names,
                   ref_name="make_train_step's", tol=TOL_HVD):
    """Print and check one step 0 against a reference step 0 (``ref``:
    loss, gradients, updates) from the same parameters ``before``: the
    loss, and the worst gradient and update leaves in relative norm with
    their names and how many are bit-equal. A ``tol`` without "update"
    gates no update."""
    ref_loss, ref_grads, ref_upd = ref
    # the reference may wait on the host: one leaf at a time on the card
    g_rel = [((a.float() - b.to(a.device).float()).norm()
              / b.float().norm()).item() for a, b in zip(grads, ref_grads)]
    u_rel = [((a - b0 - u.to(a.device)).norm() / u.norm()).item()
             for a, b0, u in zip(after, before, ref_upd)]
    g, u = (max(range(len(r)), key=r.__getitem__) for r in (g_rel, u_rel))
    dl = abs(loss - ref_loss)
    line = (f"{label} step 0 against {ref_name}: loss {loss:.6f} vs "
            f"{ref_loss:.6f} |diff| {dl:.3g} (tol {tol['loss']}); "
            f"{len(g_rel)} leaves, worst gradient rel {g_rel[g]:.3g} at "
            f"{names[g]} (tol {tol['grad']}), "
            f"{sum(r == 0 for r in g_rel)} bit-equal; worst update rel "
            f"{u_rel[u]:.3g} at {names[u]} (tol {tol.get('update', 'none')}),"
            f" {sum(r == 0 for r in u_rel)} bit-equal")
    check(np.isfinite(loss) and dl <= tol["loss"] and g_rel[g] <= tol["grad"]
          and u_rel[u] <= tol.get("update", np.inf), line)
    print(line)


def phase_hvd(torch, tfm, dp, hvd, ops, params, cfg, card):
    """The Horovod API on the card: (a) the collectives; (b) bert-large
    through DistributedOptimizer; (c) make_train_step over a Mesh with
    adasum. (b) and (c) are held to make_train_step's step 0."""
    group = hvd.global_process_set.group
    n = _hvd_collectives(torch, hvd, ops)
    print(f"hvd collectives over world size {hvd.size()} (backend "
          f"{group.name()}, device {hvd.global_process_set.world.device}): "
          f"{n} checks on CUDA tensors in float32 and bfloat16, each the "
          f"identity that size 1 means")

    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                     generator=gen, device="cuda")}
    B, S = 8, 512
    flash = dataclasses.replace(cfg, attn_impl="flash")
    before = dp.tree_leaves(params)
    names = [n for n, _ in dp.tree_flatten_with_path(params)]

    def loss_fn(p, b):
        return tfm.loss_fn(p, b, flash)

    # The reference: make_train_step's mean step 0, then 3 timed steps.
    tp = _trainable(torch, params)
    opt = _recording_adamw(torch, dp, tp)
    with torch.enable_grad():
        step = dp.make_train_step(loss_fn, opt, group)
        ref_loss = step(tp, batch).item()
        ref = (ref_loss, opt.grads, [a.detach() - b for a, b in
                                     zip(dp.tree_leaves(tp), before)])
        _, ref_sec = _timed_steps(torch, step, tp, batch, 3)
    del tp, opt, step

    # (b) DistributedOptimizer, as a Horovod user writes the step.
    hp = _trainable(torch, params)
    hvd.broadcast_parameters(hp, root_rank=0)
    hopt = hvd.DistributedOptimizer(_recording_adamw(torch, dp, hp))

    def hstep(p, b):
        loss = loss_fn(p, b)
        loss.backward()
        hopt.step()
        hopt.zero_grad(set_to_none=True)
        return hvd.allreduce(loss.detach().reshape(1))[0]

    with torch.enable_grad():
        loss0 = hstep(hp, batch).item()
        _step0_against(torch, "hvd DistributedOptimizer(AdamW) bert-large "
                       "B=8 S=512 bf16 flash", ref, before, loss0,
                       hopt.optimizer.grads, dp.tree_leaves(hp), names)
        more, sec = _timed_steps(torch, hstep, hp, batch, 3)
        # One more step in a trace window: the Horovod API's profiler
        # ranges (hvd.<op>, horovod_tpu_torch/profiler.py) must be in it.
        prof, wall_ms = profiled(torch, lambda: hstep(hp, batch))
    # A range is a host event, and a CUDA one beside it (no host time).
    ranges = [e for e in prof.key_averages() if e.key.startswith("hvd.")
              and e.device_type != torch.autograd.DeviceType.CUDA]
    line = (f"profile hvd DistributedOptimizer step ({card}): wall "
            f"{wall_ms:.1f} ms; hvd ranges: " + "; ".join(
                f"{e.key} x{e.count} {e.cpu_time_total / 1e3:.3f} ms host"
                for e in ranges))
    check(ranges, line)
    print(line)
    losses = [loss0] + more
    line = (f"hvd bert-large DistributedOptimizer over {group.name()} world "
            f"size {hvd.size()}: losses {[round(x, 5) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], line)
    print(line)
    print(f"time hvd bert-large B=8 S=512 bf16 flash ({card}): "
          f"DistributedOptimizer {sec * 1e3:.2f} ms/step, "
          f"{B * S / sec:.1f} tokens/s; make_train_step "
          f"{ref_sec * 1e3:.2f} ms/step, {B * S / ref_sec:.1f} tokens/s "
          f"(3 steps each, after step 0)")
    del hp, hopt

    # (c) make_train_step over a Mesh, data_axis a tuple, adasum.
    mesh = hvd.global_mesh({"data": 1})
    mp = _trainable(torch, params)
    mopt = _recording_adamw(torch, dp, mp)
    with torch.enable_grad():
        mstep = dp.make_train_step(loss_fn, mopt, mesh, data_axis=("data",),
                                   grad_reduce="adasum")
        mloss = mstep(mp, batch).item()
    _step0_against(torch, f"make_train_step over {mesh} data_axis=('data',) "
                   f"grad_reduce='adasum'", ref, before, mloss, mopt.grads,
                   dp.tree_leaves(mp), names)


def phase_mesh(torch, tfm, convert, dp, hvd, params, cfg, card):
    """(a) of the mesh phase: bert-large through ``loss_fn(mesh=...)``
    under ``make_train_step`` over ``create_mesh({"data": 1, "seq": 1,
    "model": 1})`` (NCCL), flash and ring, each step 0 held to the
    mesh-free step from the same parameters and batch; 3 timed steps and
    a profile of each."""
    group = hvd.global_process_set.group
    mesh = hvd.global_mesh({"data": 1, "seq": 1, "model": 1})
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (8, 513), generator=gen,
                           device="cuda")
    B, S = 8, 512
    names = [n for n, _ in dp.tree_flatten_with_path(params)]
    before = dp.tree_leaves(params)
    for impl, ref_impl, tol in (("flash", "flash", TOL_MESH_FLASH),
                                ("ring", "gather", TOL_MESH_RING)):
        c_mesh = dataclasses.replace(cfg, attn_impl=impl)
        c_ref = dataclasses.replace(cfg, attn_impl=ref_impl)
        rp = _trainable(torch, params)
        ropt = _recording_adamw(torch, dp, rp)
        with torch.enable_grad():
            rstep = dp.make_train_step(
                lambda p, b, c=c_ref: tfm.loss_fn(p, b, c), ropt, group)
            ref_loss = rstep(rp, {"tokens": tokens}).item()
            ref_upd = [a.detach() - b for a, b in
                       zip(dp.tree_leaves(rp), before)]
            _, ref_sec = _timed_steps(torch, rstep, rp, {"tokens": tokens}, 3)
        ref_grads = ropt.grads
        del rp, ropt, rstep

        mp = convert.shard_params(params, cfg, mesh)
        for leaf in dp.tree_leaves(mp):
            leaf.requires_grad_()
        mopt = _recording_adamw(torch, dp, mp)
        batch = dp.shard_batch({"tokens": tokens}, mesh, "data")
        with torch.enable_grad():
            mstep = dp.make_train_step(
                lambda p, b, c=c_mesh: tfm.loss_fn(p, b, c, mesh=mesh), mopt,
                mesh, data_axis=("data", "seq"))
            loss0 = mstep(mp, batch).item()
            _step0_against(
                torch, f"mesh bert-large B=8 S=512 bf16 {impl} over {mesh} "
                f"({group.name()}), data_axis=('data', 'seq'),",
                (ref_loss, ref_grads, ref_upd), before, loss0, mopt.grads,
                dp.tree_leaves(mp), names,
                ref_name=f"the mesh-free {ref_impl} step's", tol=tol)
            more, sec = _timed_steps(torch, mstep, mp, batch, 3)
            losses = [loss0] + more
            line = (f"mesh bert-large {impl}: losses "
                    f"{[round(x, 5) for x in losses]}")
            check(all(np.isfinite(losses)) and losses[-1] < losses[0], line)
            print(line)
            print(f"time mesh bert-large B=8 S=512 bf16 {impl} ({card}): "
                  f"{sec * 1e3:.2f} ms/step, {B * S / sec:.1f} tokens/s over "
                  f"the mesh; mesh-free {ref_impl} {ref_sec * 1e3:.2f} "
                  f"ms/step, {B * S / ref_sec:.1f} tokens/s (3 steps each, "
                  f"after step 0)")
            profile_line(torch, f"mesh bert-large B=8 S=512 bf16 {impl} step",
                         lambda: mstep(mp, batch))
        del mp, mopt, mstep, ref_grads, ref_upd
        torch.cuda.empty_cache()


# (b) of the mesh phase: the ring's flash step at p = 4 in one process,
# longctx width, cut into four 1024-row blocks.
RING_SHAPE, RING_P = (1, 4096, 16, 64), 4


def ring_reference(torch, fa):
    """q, k, v and dO ``RING_SHAPE`` bf16 from a seed, and {causal:
    (out, (dq, dk, dv))} of the port's flash_attention over the whole
    sequence. Run outside any counted path: these launches compare."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    qkvd = [torch.randn(RING_SHAPE, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]
    q, k, v, do = qkvd
    ref = {}
    for causal in (True, False):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o = fa.flash_attention(*leaves, causal=causal)
            grads = torch.autograd.grad(o, leaves, do)
        ref[causal] = (o.detach(), grads)
    return qkvd, ref


def _ring_in_process(torch, ra, qkvd, layout, causal, inner):
    """Every rank ``my`` of a ring of RING_P as it would run: the
    module-level per-pair update for each src in ring order, on the
    blocks of the whole q, k, v (striped first for that layout). Returns
    the whole output and (dq, dk, dv) for dO."""
    q, k, v, do = qkvd
    p, n = RING_P, RING_SHAPE[1] // RING_P
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        qq, kk, vv = (ra.stripe_sequence(t, p) if layout == "striped" else t
                      for t in leaves)
        outs = []
        for my in range(p):
            acc = ra.init_acc(qq[:, my * n:(my + 1) * n], inner)
            for i in range(p):
                src = (my - i) % p
                acc = ra.accumulate(
                    acc, qq[:, my * n:(my + 1) * n],
                    kk[:, src * n:(src + 1) * n],
                    vv[:, src * n:(src + 1) * n], my, src, p, causal=causal,
                    layout=layout, inner=inner,
                    scale=1.0 / np.sqrt(RING_SHAPE[-1]))
            outs.append(ra.finish(acc, inner, q.dtype))
        out = torch.cat(outs, 1)
        if layout == "striped":
            out = ra.unstripe_sequence(out, p)
        grads = torch.autograd.grad(out, leaves, do)
    return out.detach(), grads


@contextlib.contextmanager
def _plain_ring_flash(ra, fa):
    """For the duration of a ``with``: the ring's flash step through the
    kernels' plain versions on the card's tensors (``_FlashFn`` with impl
    "plain") in place of the kernels."""
    def lse(q, k, v, *, mode, sm_scale, block):
        return fa._FlashFn.apply(q, k, v, "plain", mode, float(sm_scale),
                                 fa._validate(q, k, v, block))

    kernel = ra.flash_attention_lse
    ra.flash_attention_lse = lse
    try:
        yield
    finally:
        ra.flash_attention_lse = kernel


def _ring_errors(torch, got, want):
    """(max |out - want| / (1 + |want|), the worst of dq, dk, dv's
    |g - want| / |want|)."""
    (o, grads), (wo, wgrads) = got, want
    o_err = ((o.float() - wo.float()).abs()
             / (1.0 + wo.float().abs())).max().item()
    g_err = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(grads, wgrads))
    return o_err, g_err


def phase_ring(torch, fa, ra, qkvd, ref):
    """(b) of the mesh phase: for both layouts and causal true and false,
    the ring's flash step (B1 in mode none/diag/strict, B2 and B3 with a
    nonzero dLSE from the LSE merge) and its einsum step, every (my, src)
    pair of a ring of 4, held to flash over the whole sequence, and the
    flash step to the same ring through the kernels' plain versions."""
    counted = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    for w in counted:
        for mode in w.mode_launches:
            w.mode_launches[mode] = 0
    t0 = time.perf_counter()
    for layout in ("contiguous", "striped"):
        for causal in (True, False):
            want = ref[causal]
            kern = _ring_in_process(torch, ra, qkvd, layout, causal, "flash")
            with _plain_ring_flash(ra, fa):
                plain = _ring_in_process(torch, ra, qkvd, layout, causal,
                                         "flash")
            einsum = _ring_in_process(torch, ra, qkvd, layout, causal,
                                      "einsum")
            errs = {"flash vs whole": _ring_errors(torch, kern, want),
                    "flash vs plain": _ring_errors(torch, kern, plain),
                    "einsum vs whole": _ring_errors(torch, einsum, want)}
            line = (f"ring p={RING_P} in one process {list(RING_SHAPE)} bf16 "
                    f"{layout} causal={causal}: " + "; ".join(
                        f"{k}: out {o:.3g}, grads {g:.3g}"
                        for k, (o, g) in errs.items())
                    + f" (tol out {TOL_RING['out']}, grads "
                    f"{TOL_RING['grad']})")
            check(all(o <= TOL_RING["out"] and g <= TOL_RING["grad"]
                      for o, g in errs.values()), line)
            print(line)
    torch.cuda.synchronize()
    modes = [dict(w.mode_launches) for w in counted]
    line = (f"ring p={RING_P} launches by mode: flash_fwd {modes[0]}, "
            f"flash_bwd_dq {modes[1]}, flash_bwd_dkv {modes[2]} (expected "
            f"{RING_MODES}); {time.perf_counter() - t0:.1f} s")
    check(all(m == RING_MODES for m in modes), line)
    print(line)


# The moe phase. (a): make_moe_layer at bench.py::_bench_moe's card shape
# (T tokens of width D, E experts of hidden F, bf16 tokens and weights at
# scale 0.02, float32 logits) over a one-rank NCCL {"expert": 1} mesh.
MOE_SHAPE = dict(T=4096, D=1024, F=4096, E=8)
# The layer against a plain dense routing (every token through its
# argmax expert in float32, gate-weighted, no rounding on the way) on
# the rows it keeps: the layer rounds each expert's output and its own
# output to bf16 (2^-9 relative each) and sums in float32 in another
# order: |out - ref| <= 1e-3 + 1e-2 |ref|. A dropped row must be 0.
TOL_MOE = (1e-3, 1e-2)
# (b): bert-large widths with the bench's E experts in every layer,
# through loss_fn(mesh=) over {"data": 1, "expert": 1}, held to the
# mesh-free step with the mesh phase's flash gates (TOL_MESH_FLASH). All
# 24 layers: the two steps run one after the other, each with its copy of
# the 1.74 G parameters, AdamW's two moments, the gradients and the dense
# MoE's [B, S, E, F] bf16 activations (~0.8 GB a layer), 46.8 GiB at the
# peak as measured on an H100 80GB HBM3; the reference's gradients and
# updates wait on the host.
MOE_LAYERS = 24
# (c): the dp=ep layout (expert_axis="data", __graft_entry__'s reuse) at
# the same widths over {"data": 1}: each rank all-gathers the experts over
# data, and make_train_step leaves the leaves that shard_params marks as
# cut over data out of data's all-reduce. Step 0 only, a few layers.
MOE_DP_EP_LAYERS = 2


def _moe_expert_fn(torch, w_in, w_out):
    """make_moe_layer's expert: gelu(x @ w_in) @ w_out in float32."""
    def expert_fn(buf):
        h = torch.einsum("end,edf->enf", buf.float(), w_in.float())
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return torch.einsum("enf,efd->end", h, w_out.float()).to(buf.dtype)
    return expert_fn


def _moe_reference(torch, x, logits, w_in, w_out):
    """(every token through its argmax expert, gate-weighted, in float32;
    the experts' indices)."""
    probs = torch.softmax(logits.float(), -1)
    eidx = probs.argmax(-1)
    gate = probs.gather(1, eidx[:, None])
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w_in.shape[0]):
        rows = eidx == e
        h = torch.nn.functional.gelu(x[rows].float() @ w_in[e].float(),
                                     approximate="tanh")
        out[rows] = (h @ w_out[e].float()) * gate[rows]
    return out, eidx


def _moe_kept(torch, eidx, E, capacity):
    """The tokens a queue of ``capacity`` slots an expert keeps, in token
    order (plain)."""
    pos = torch.nn.functional.one_hot(eidx, E).cumsum(0) - 1
    return pos.gather(1, eidx[:, None])[:, 0] < capacity


def _moe_check(torch, label, out, ref, kept):
    """``out`` against ``ref`` on the kept rows, zero on the others."""
    atol, rtol = TOL_MOE
    got = out.float()
    zero = ~(got != 0).any(-1)
    diff = (got - ref).abs()[kept]
    line = (f"moe {label}: {int(kept.sum())} of {kept.numel()} tokens kept,"
            f" {int(zero.sum())} rows zero; kept rows max|out-ref| "
            f"{diff.max().item():.3g} (tol {atol} + {rtol}|ref|)")
    check(bool(torch.isfinite(got).all()) and torch.equal(zero, ~kept)
          and bool((diff <= atol + rtol * ref.abs()[kept]).all()), line)
    print(line)
    return zero


def phase_moe_layer(torch, dp, hvd, card):
    """(a) of the moe phase: make_moe_layer, dense and ragged, at the
    bench's card shape over a one-rank NCCL {"expert": 1} mesh."""
    T, D, F_, E = (MOE_SHAPE[k] for k in "TDFE")
    mesh = hvd.global_mesh({"expert": 1})
    group = mesh.group("expert")
    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    w_in, w_out = randn(E, D, F_, scale=0.02), randn(E, F_, D, scale=0.02)
    x, logits = randn(T, D), randn(T, E, dtype=torch.float32)
    expert_fn = _moe_expert_fn(torch, w_in, w_out)

    def layer(cf, ragged):
        return dp.make_moe_layer(mesh, "expert", w_in, w_out,
                                 capacity_factor=cf, ragged=ragged)

    # A generous capacity: nothing dropped, the dense routing. Ragged at
    # capacity_factor=E would hold a [T*E, E, T*E] one-hot (8.6 G
    # elements); its lossless capacities are T and T.
    ref, eidx = _moe_reference(torch, x, logits, w_in, w_out)
    every = torch.ones(T, dtype=torch.bool, device="cuda")
    _moe_check(torch, f"dense make_moe_layer capacity_factor={E}",
               layer(float(E), False)(x, logits), ref, every)
    _moe_check(torch, "ragged dispatch peer_capacity=expert_capacity=T",
               dp.moe_dispatch_combine_ragged(
                   x, logits, expert_fn, group, peer_capacity=T,
                   expert_capacity=T)[0], ref, every)

    # The bench's capacity factor, 1.25: dense queues of C = T*1.25/E,
    # ragged queues of C2 = (T*1.25)*1.25/E behind a peer slot of T*1.25.
    C, C2 = int(T * 1.25 / E), int(int(T * 1.25) * 1.25 / E)
    dense, ragged = layer(1.25, False), layer(1.25, True)
    z_dense = _moe_check(torch, f"dense make_moe_layer capacity_factor=1.25"
                         f" (C={C})", dense(x, logits), ref,
                         _moe_kept(torch, eidx, E, C))
    z_ragged = _moe_check(torch, f"ragged make_moe_layer capacity_factor="
                          f"1.25 (C2={C2})", ragged(x, logits), ref,
                          _moe_kept(torch, eidx, E, C2))
    check(bool((z_ragged <= z_dense).all()),
          "ragged dropped a token that dense kept")
    # Skewed routing (__graft_entry__'s logits[:, 0] += 1.5): expert 0
    # overflows; dense and a ragged dispatch with the dense queue's
    # capacity must drop the same tokens.
    skew = logits.clone()
    skew[:, 0] += 1.5
    sref, seidx = _moe_reference(torch, x, skew, w_in, w_out)
    kept = _moe_kept(torch, seidx, E, C)
    z1 = _moe_check(torch, f"skewed dense make_moe_layer capacity_factor="
                    f"1.25 (C={C})", dense(x, skew), sref, kept)
    z2 = _moe_check(torch, f"skewed ragged dispatch expert_capacity={C}",
                    dp.moe_dispatch_combine_ragged(
                        x, skew, expert_fn, group, capacity_factor=1.25,
                        expert_capacity=C)[0], sref, kept)
    check(torch.equal(z1, z2) and int(z1.sum()) > 0,
          "skewed dense and ragged dropped other tokens")
    reports = hvd.ep_stats()
    check(reports[0] == 4, f"hvd.ep_stats() after four layer calls: "
          f"{reports}")
    print(f"moe hvd.ep_stats() (reports, tokens, dropped, last fraction): "
          f"{reports}")

    times = {name: time_ms(torch, lambda f=f: f(x, logits), 10)
             for name, f in (("dense", dense), ("ragged", ragged))}
    print(f"time moe make_moe_layer T={T} D={D} F={F_} E={E} bf16 "
          f"capacity_factor=1.25 over {mesh} ({group.name()}; {card}): "
          + ", ".join(f"{k} {ms:.3f} ms, {T / ms * 1e3:.1f} tokens/s"
                      for k, ms in times.items()))


def phase_moe_mesh(torch, tfm, convert, dp, hvd, card):
    """(b) of the moe phase: the MoE transformer at bert-large widths
    through loss_fn(mesh=...) over {"data": 1, "expert": 1}, step 0 held
    to the mesh-free MoE step from the same parameters and batch."""
    cfg = dataclasses.replace(tfm.bert_large(), n_experts=MOE_SHAPE["E"],
                              n_layers=MOE_LAYERS, attn_impl="flash")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(19), device="cuda")
    group = hvd.global_process_set.group
    mesh = hvd.global_mesh({"data": 1, "expert": 1})
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                     generator=gen, device="cuda")}
    B, S = 8, 512
    names = [n for n, _ in dp.tree_flatten_with_path(params)]
    before = dp.tree_leaves(params)
    n_params = sum(x.numel() for x in before)
    torch.cuda.reset_peak_memory_stats()

    # The mesh-free step; its gradients and updates wait on the host.
    rp = _trainable(torch, params)
    ropt = _recording_adamw(torch, dp, rp)
    with torch.enable_grad():
        rstep = dp.make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), ropt,
                                   group)
        ref_loss = rstep(rp, batch).item()
        ref_upd = [(a.detach() - b).cpu() for a, b in
                   zip(dp.tree_leaves(rp), before)]
        ref_grads = [g.cpu() for g in ropt.grads]
        ropt.grads = []
        _, ref_sec = _timed_steps(torch, rstep, rp, batch, 3)
    del rp, ropt, rstep
    torch.cuda.empty_cache()

    mp = convert.shard_params(params, cfg, mesh)
    for leaf in dp.tree_leaves(mp):
        leaf.requires_grad_()
    mopt = _recording_adamw(torch, dp, mp)
    mbatch = dp.shard_batch(batch, mesh, "data")
    with torch.enable_grad():
        mstep = dp.make_train_step(
            lambda p, b: tfm.loss_fn(p, b, cfg, mesh=mesh), mopt, mesh,
            data_axis=("data",))
        loss0 = mstep(mp, mbatch).item()
        _step0_against(
            torch, f"moe bert-large E={cfg.n_experts} L={cfg.n_layers} B=8 "
            f"S=512 bf16 flash over {mesh} ({group.name()}),",
            (ref_loss, ref_grads, ref_upd), before, loss0, mopt.grads,
            dp.tree_leaves(mp), names, ref_name="the mesh-free MoE step's",
            tol=TOL_MESH_FLASH)
        mopt.grads = []
        del ref_grads, ref_upd
        more, sec = _timed_steps(torch, mstep, mp, mbatch, 3)
        losses = [loss0] + more
        line = f"moe bert-large: losses {[round(x, 5) for x in losses]}"
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], line)
        print(line)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"time moe bert-large E={cfg.n_experts} L={cfg.n_layers} "
              f"({n_params / 1e9:.3f} G params) B=8 S=512 bf16 flash "
              f"({card}): {sec * 1e3:.2f} ms/step, {B * S / sec:.1f} "
              f"tokens/s over the mesh; mesh-free {ref_sec * 1e3:.2f} "
              f"ms/step, {B * S / ref_sec:.1f} tokens/s (3 steps each, after "
              f"step 0); peak device memory {peak:.1f} GiB")
        profile_line(torch, "moe bert-large B=8 S=512 bf16 flash mesh step",
                     lambda: mstep(mp, mbatch))
    del mp, mopt, mstep, params, before
    torch.cuda.empty_cache()


def phase_moe_dp_ep(torch, tfm, convert, dp, hvd, card):
    """(c) of the moe phase: the MoE transformer with ``expert_axis="data"``
    over {"data": 1}, MOE_DP_EP_LAYERS deep: the experts gathered over
    ``data`` and the leaves cut over it kept out of its all-reduce; step 0
    held to the mesh-free step from the same parameters and batch."""
    cfg = dataclasses.replace(tfm.bert_large(), n_experts=MOE_SHAPE["E"],
                              n_layers=MOE_DP_EP_LAYERS, attn_impl="flash",
                              expert_axis="data")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(23), device="cuda")
    group = hvd.global_process_set.group
    mesh = hvd.global_mesh({"data": 1})
    check(tfm._expert_plan(cfg, mesh)[0] is not None,
          f"expert_axis='data' over {mesh}: no gather group for the experts")
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                     generator=gen, device="cuda")}
    names = [n for n, _ in dp.tree_flatten_with_path(params)]
    before = dp.tree_leaves(params)

    rp = _trainable(torch, params)
    ropt = _recording_adamw(torch, dp, rp)
    with torch.enable_grad():
        rstep = dp.make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), ropt,
                                   group)
        ref_loss = rstep(rp, batch).item()
    ref = (ref_loss, ropt.grads,
           [a.detach() - b for a, b in zip(dp.tree_leaves(rp), before)])
    del rp, ropt, rstep

    mp = convert.shard_params(params, cfg, mesh)
    cut = [n for n, x in dp.tree_flatten_with_path(mp)
           if "data" in dp.mesh.leaf_spec(x)]
    check(len(cut) == 2 * cfg.n_layers
          and all(n.endswith(("['w_in']", "['w_out']")) for n in cut),
          f"leaves shard_params marks as cut over data: {cut}")
    for leaf in dp.tree_leaves(mp):
        leaf.requires_grad_()
    mopt = _recording_adamw(torch, dp, mp)
    with torch.enable_grad():
        mstep = dp.make_train_step(
            lambda p, b: tfm.loss_fn(p, b, cfg, mesh=mesh), mopt, mesh,
            data_axis=("data",))
        loss0 = mstep(mp, dp.shard_batch(batch, mesh, "data")).item()
    _step0_against(
        torch, f"moe dp=ep bert-large E={cfg.n_experts} L={cfg.n_layers} "
        f"B=8 S=512 bf16 flash over {mesh} ({group.name()}; {len(cut)} "
        f"expert leaves cut over data),", ref, before, loss0, mopt.grads,
        dp.tree_leaves(mp), names, ref_name="the mesh-free MoE step's",
        tol=TOL_MESH_FLASH)
    del mp, mopt, mstep, params, before, ref
    torch.cuda.empty_cache()


# The pipeline phase: bert-large's 24 blocks through
# parallel/pipeline.py over a {pipe: 1} mesh, M microbatches.
PIPE_M = 4
PIPE_SCHEDULES = (("gpipe", None), ("1f1b", None), ("zb", None),
                  ("interleaved", 2))
# B1's launches a step per block and microbatch, and B2's and B3's
# (each), by schedule: gpipe and interleaved run each block's forward
# once and autograd's backward once; 1f1b and zb (zb falls back to 1f1b
# at one stage) run the forward without grad and again in the recompute.
PIPE_LAUNCHES = {"gpipe": (1, 1), "interleaved": (1, 1), "1f1b": (2, 1),
                 "zb": (2, 1)}
# Step 0 through make_pipeline_value_and_grad against the mesh-free
# tfm.loss_fn autograd step from the same parameters and tokens, flash
# both: the loss, and every block leaf's gradient in relative norm.
# float32: the same kernels on microbatches of 2 rows where the
# reference runs 8 (cuBLAS may pick other GEMM algorithms), and the
# weight gradients sum four microbatches' products in another order:
# TOL_TRAIN_F32 for both. bf16: the same differences, rounded to bf16
# at every activation and compounded over 24 layers, the kind of
# difference of flash against gather: the train phase's bf16 gates.
TOL_PIPE = {"float32": dict(loss=TOL_TRAIN_F32, grad=TOL_TRAIN_F32),
            "bfloat16": dict(loss=TOL_TRAIN_BF16_LOSS,
                             grad=TOL_TRAIN_BF16_GRAD)}
# The schedules against gpipe from the same parameters: the same kernels
# on the same microbatches; the gradients add the microbatches in
# another order, and 1f1b/zb take the loss per microbatch where gpipe
# takes it over the whole batch (the head's GEMM at 2 rows against 8, as
# above). float32: 1e-5 on the loss and 1e-4 on every leaf in relative
# norm; bf16: 2e-3 and 3e-2, the head's bf16 logits rounded in other
# places and compounded back through 24 layers.
TOL_PIPE_SCHED = {"float32": dict(loss=1e-5, grad=1e-4),
                  "bfloat16": dict(loss=2e-3, grad=3e-2)}


def _pipe_stack(torch, params, n_slices):
    """bert-large's blocks as ``n_slices`` stage slices in network order:
    slice k holds blocks [k*L/n, (k+1)*L/n), each leaf stacked on a
    leading dim of n_slices, one entry of "layers" per block of a
    slice."""
    layers = params["layers"]
    per = len(layers) // n_slices

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack([x.detach() for x in xs])

    return {"layers": [stack(*(layers[k * per + j] for k in range(n_slices)))
                       for j in range(per)]}


def _pipe_block_grads(dp, grads, per, V):
    """{block leaf name: gradient} from a {pipe: 1} rank's gradients
    (its rows are the V slices in order)."""
    out = {}
    for path, g in dp.tree_flatten_with_path(grads):
        j = int(path.split("]")[1].lstrip("["))      # "['layers'][j]..."
        rest = path.split("]", 2)[2]
        for k in range(V):
            out[f"['layers'][{k * per + j}]{rest}"] = g[k]
    return out


def _pipe_compare(torch, label, got, want, tol, ref_name):
    """Print and check a (loss, {name: grad}) against another: the loss
    and the worst leaf in relative norm, with how many are bit-equal."""
    loss, grads = got
    ref_loss, ref_grads = want
    check(grads.keys() == ref_grads.keys(), f"{label}: other leaves")
    rel = {n: ((g.float() - ref_grads[n].to(g.device).float()).norm()
               / ref_grads[n].float().norm()).item()
           for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    dl = abs(loss - ref_loss)
    line = (f"{label} step 0 against {ref_name}: loss {loss:.6f} vs "
            f"{ref_loss:.6f} |diff| {dl:.3g} (tol {tol['loss']}); "
            f"{len(rel)} block leaves, worst gradient rel {rel[worst]:.3g} "
            f"at {worst} (tol {tol['grad']}), "
            f"{sum(r == 0 for r in rel.values())} bit-equal")
    check(np.isfinite(loss) and dl <= tol["loss"]
          and rel[worst] <= tol["grad"], line)
    print(line)


def phase_pipeline(torch, tfm, dp, fa, hvd, params, cfg, card):
    """bert-large (B=8, S=512, flash) through parallel/pipeline.py over
    ``create_mesh({"pipe": 1})`` on ``hvd.init()``'s NCCL world: the
    embedding outside the pipeline, the 24 blocks as stage slices, the
    final layernorm, the tied head and the NLL in ``loss_fn`` per
    microbatch, M = PIPE_M. For each schedule of PIPE_SCHEDULES, in
    float32 and bf16: step 0 held to the mesh-free autograd step and to
    gpipe's, B1-B3's launches against PIPE_LAUNCHES, the peak device
    memory (1f1b's below gpipe's); zb's fallback at one stage counted
    (``single_stage``); then 3 timed AdamW steps of each schedule beside
    the mesh-free ``make_train_step`` step, and a profile of gpipe and
    1f1b."""
    from horovod_tpu_torch.observability import metrics

    mesh = hvd.global_mesh({"pipe": 1})
    group = hvd.global_process_set.group
    B, S, L = 8, 512, cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device="cuda")
    n_blocks = sum(x.numel() for x in dp.tree_leaves(params["layers"]))
    was_on = metrics.enabled()
    metrics.enable()       # the zb fallback is counted with metrics on
    fallbacks = metrics.PIPELINE_ZB_FALLBACKS.labels(reason="single_stage")

    def embed(c):
        """The pipeline's input: the mesh-free loss's embedding."""
        dt = c.compute_dtype
        x = params["embed"].to(dt)[tokens[:, :-1]]
        return x + params["pos_embed"].to(dt)[:S][None]

    def stage_fn_for(c):
        def stage_fn(p, h):
            for layer in p["layers"]:
                h = tfm.apply_block(layer, h, c, impl="flash")
            return h
        return stage_fn

    def loss_fn(out, b):
        h = tfm._layer_norm(out, params["final_ln"])
        return tfm._nll(h, b["targets"], params["embed"]).mean()

    peaks = {}
    try:
        for dname in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dname, attn_impl="flash")
            # the mesh-free step 0: its block gradients wait on the host
            rp = _trainable(torch, params)
            leaves = dp.tree_leaves(rp["layers"])
            names = [f"['layers']{n}" for n, _ in
                     dp.tree_flatten_with_path(rp["layers"])]
            with torch.enable_grad():
                loss = tfm.loss_fn(rp, {"tokens": tokens}, c)
                grads = torch.autograd.grad(loss, leaves)
            ref = (loss.item(), {n: g.cpu() for n, g in zip(names, grads)})
            del rp, leaves, grads, loss
            torch.cuda.empty_cache()
            batch = {"x": embed(c), "targets": tokens[:, 1:]}
            first = None
            for name, V in PIPE_SCHEDULES:
                sp = dp.shard_stage_params(
                    _pipe_stack(torch, params, V or 1), mesh,
                    virtual_stages=V or 1)
                n0 = fallbacks.value
                vg = dp.make_pipeline_value_and_grad(
                    stage_fn_for(c), loss_fn, mesh, n_microbatches=PIPE_M,
                    schedule=name, virtual_stages=V)
                if name == "zb":
                    line = (f"pipeline zb over {mesh}: ran as "
                            f"{vg.schedule_label}, single_stage fallbacks "
                            f"+{fallbacks.value - n0:g}")
                    check(vg.schedule_label == "1f1b"
                          and fallbacks.value - n0 == 1, line)
                    print(line)
                before = _launches(fa)
                by = [dict(w.variant_launches) for w in
                      (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                       fa.flash_bwd_dkv_cuda)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                loss, g = vg(sp, batch)
                loss = loss.item()
                peak = torch.cuda.max_memory_allocated() / 2**30
                ran = [a - b for a, b in zip(_launches(fa), before)]
                tma = [w.variant_launches["tma"] - b["tma"] for w, b in
                       zip((fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                            fa.flash_bwd_dkv_cuda), by)]
                f, b_ = PIPE_LAUNCHES[name]
                want = [f * L * PIPE_M, b_ * L * PIPE_M, b_ * L * PIPE_M]
                label = (f"pipeline bert-large B={B} S={S} {dname} flash "
                         f"{name} (label {vg.schedule_label}) over {mesh} "
                         f"({group.name()}), M={PIPE_M}")
                line = (f"{label}: B1/B2/B3 launches {ran} (tables: {want}),"
                        f" on tma {tma}; peak device memory {peak:.2f} GiB")
                check(ran == want and (dname == "float32" or tma == want),
                      line)
                print(line)
                got = (loss, {n: x.detach() for n, x in _pipe_block_grads(
                    dp, g, L // (V or 1), V or 1).items()})
                _pipe_compare(torch, label, got, ref, TOL_PIPE[dname],
                              "the mesh-free step's")
                if first is None:
                    first = (loss, {n: x.cpu() for n, x in got[1].items()})
                else:
                    _pipe_compare(torch, label, got, first,
                                  TOL_PIPE_SCHED[dname], "gpipe's")
                peaks[dname, name] = peak
                del sp, vg, g, got
                torch.cuda.empty_cache()
            line = (f"pipeline peak device memory {dname}: "
                    + ", ".join(f"{n} {peaks[dname, n]:.2f} GiB"
                                for n, _ in PIPE_SCHEDULES))
            check(peaks[dname, "1f1b"] < peaks[dname, "gpipe"], line)
            print(line)
            del ref, first, batch

        # Timing: bf16 AdamW steps over the blocks (the embedding looked
        # up in each step, its table and the head not updated) beside the
        # mesh-free make_train_step (every leaf updated).
        rp = _trainable(torch, params)
        with torch.enable_grad():
            rstep = dp.make_train_step(
                lambda p, b: tfm.loss_fn(p, b, dataclasses.replace(
                    cfg, attn_impl="flash")), _adamw(torch, dp, rp), group)
            rstep(rp, {"tokens": tokens})
            _, ref_sec = _timed_steps(torch, rstep, rp, {"tokens": tokens}, 3)
        del rp, rstep
        torch.cuda.empty_cache()
        c = dataclasses.replace(cfg, attn_impl="flash")
        for name, V in PIPE_SCHEDULES:
            sp = dp.shard_stage_params(_pipe_stack(torch, params, V or 1),
                                       mesh, virtual_stages=V or 1)
            for x in dp.tree_leaves(sp):
                x.requires_grad_()
            step = dp.make_pipeline_train_step(
                stage_fn_for(c), loss_fn,
                torch.optim.AdamW(dp.tree_leaves(sp), **ADAMW), mesh,
                n_microbatches=PIPE_M, schedule=name, virtual_stages=V)

            def one():
                return step(sp, {"x": embed(c), "targets": tokens[:, 1:]})

            losses = [one().item()]
            more, sec = _timed_steps(torch, lambda p, b: one(), None, None, 3)
            losses += more
            line = (f"pipeline {name} bf16: losses "
                    f"{[round(x, 5) for x in losses]}")
            check(all(np.isfinite(losses)) and losses[-1] < losses[0], line)
            print(line)
            print(f"time pipeline bert-large B={B} S={S} bf16 flash {name} "
                  f"over {mesh} M={PIPE_M} ({card}): {sec * 1e3:.2f} ms/step, "
                  f"{B * S / sec:.1f} tokens/s ({n_blocks / 1e6:.1f} M block "
                  f"params updated); mesh-free make_train_step "
                  f"{ref_sec * 1e3:.2f} ms/step, {B * S / ref_sec:.1f} "
                  f"tokens/s (3 steps each, after the first)")
            if name in ("gpipe", "1f1b"):
                profile_line(torch, f"pipeline bert-large B={B} S={S} bf16 "
                             f"{name} step", one)
            del sp, step
            torch.cuda.empty_cache()
    finally:
        if not was_on:
            metrics.disable()


def _bit_equal(torch, dp, got, want):
    """(leaves of ``got`` bit-equal to ``want``'s, all leaves, the first
    names that differ)."""
    pairs = list(zip(dp.tree_flatten_with_path(got),
                     dp.tree_flatten_with_path(want)))
    bad = [n for (n, a), (_, b) in pairs
           if not (a.dtype == b.dtype and a.shape == b.shape
                   and torch.equal(a.detach().to(b.device), b))]
    return len(pairs) - len(bad), len(pairs), bad[:3]


def _wall_ms(torch, fn):
    """``fn()`` and its wall time in ms, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _host_rates(torch, root, nbytes=1 << 30):
    """GB/s of what a save and a restore do to each byte on this host,
    over ``nbytes``: zlib.crc32, np.save into memory (and the copy out),
    a write with fsync to ``root``'s disk, a read of it back (warm: just
    written), and a copy from pageable host memory to the card."""
    import io
    import zlib

    buf = np.full(nbytes, 7, np.uint8)
    path = os.path.join(root, "rates.bin")
    rates = {}

    def rate(name, fn):
        t0 = time.perf_counter()
        out = fn()
        rates[name] = nbytes / (time.perf_counter() - t0) / 1e9
        return out

    def write():
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def to_card():
        torch.from_numpy(buf).to("cuda")
        torch.cuda.synchronize()

    rate("crc32", lambda: zlib.crc32(buf))
    b = io.BytesIO()
    data = rate("np.save", lambda: (np.save(b, buf), b.getvalue())[1])
    rate("write+fsync", write)
    with open(path, "rb") as f:
        rate("read (warm)", f.read)
    os.remove(path)
    rate("host-to-card (pageable)", to_card)
    return rates


def phase_checkpoint(torch, tfm, dp, fa, ckpt, convert, hvd, params, cfg,
                     card):
    """bert-large's train state (f32 params and AdamW moments, B=8 S=512
    bf16 flash through make_train_step over ``hvd.init()``'s NCCL world)
    through horovod_tpu_torch/checkpoint.py in a fresh temporary
    directory: step 0, a sync save of ``{params, opt:
    optimizer_state_tree}``, step 1; a restore into fresh params and a
    fresh AdamW, every leaf bit-equal to the snapshot, and step 1 again,
    bit-equal to the uninterrupted step 1 or within TOL_HVD (the line
    says which held); then an async save, a step that updates the same
    tensors in place at once, ``wait`` and a restore, bit-equal to the
    snapshot; and one save and restore of ``shard_params``-marked params
    over ``{"model": 1}``. Prints the bytes, the sync save's wall time
    against the async save's blocking time (``snapshot_stall_ms``),
    ``write_ms``, restore ms and GB/s, the free disk space before, and
    the host's rates for each thing a save or a restore does to a byte
    (``_host_rates``)."""
    from horovod_tpu_torch.parallel.mesh import leaf_spec, set_leaf_spec
    from horovod_tpu_torch.tree import tree_map

    group = hvd.global_process_set.group
    flash = dataclasses.replace(cfg, attn_impl="flash")
    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(13)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                        generator=gen, device="cuda")}
               for _ in range(3)]

    def trainer(p):
        opt = _adamw(torch, dp, p)
        return opt, dp.make_train_step(lambda q, b: tfm.loss_fn(q, b, flash),
                                       opt, group)

    def like(p):
        """A fresh AdamW's like: the params stand in for the moments."""
        return {"params": p, "opt": {"exp_avg": p, "exp_avg_sq": p,
                                     "step": tree_map(lambda x: torch.zeros(
                                         ()), p)}}

    def snapshot(state):
        return tree_map(lambda x: x.detach().clone(), state)

    root = tempfile.mkdtemp(prefix="hvd-ckpt-")
    n0 = _launches(fa)
    try:
        print(f"checkpoint: {shutil.disk_usage(root).free / 1e9:.1f} GB free "
              f"at {root} before the phase")
        with torch.enable_grad():
            tp = _trainable(torch, params)
            opt, step = trainer(tp)
            step(tp, batches[0])
            state = {"params": tp, "opt": ckpt.optimizer_state_tree(opt, tp)}
            n_leaves = len(dp.tree_leaves(state))
            size = sum(x.numel() * x.element_size()
                       for x in dp.tree_leaves(state))
            ref = snapshot(state)
            s0 = ckpt.checkpoint_stats()
            _, save_ms = _wall_ms(torch, lambda: ckpt.save(root, 1, state,
                                                           async_=False))
            s1 = ckpt.checkpoint_stats()
            written = s1["bytes"] - s0["bytes"]
            check(s1["commits"] - s0["commits"] == 1
                  and ckpt.latest_step(root) == 1, "sync save did not commit")
            print(f"checkpoint bert-large train state ({n_leaves} leaves, "
                  f"{size / 1e9:.3f} GB: f32 params and AdamW moments) "
                  f"({card}): sync save {save_ms:.1f} ms wall, "
                  f"{written} bytes written ({written / save_ms / 1e6:.3f} "
                  f"GB/s), snapshot_stall_ms {s1['snapshot_stall_ms']:.1f}, "
                  f"write_ms {s1['write_ms']:.1f}")
            loss1 = step(tp, batches[1]).item()        # uninterrupted step 1
            after1 = [x.detach().clone() for x in dp.tree_leaves(tp)]

            (out, at), restore_ms = _wall_ms(torch, lambda: ckpt.restore(
                root, like(_trainable(torch, params))))
            s2 = ckpt.checkpoint_stats()
            read = s2["bytes_read"] - s1["bytes_read"]
            eq, n, bad = _bit_equal(torch, dp, out, ref)
            line = (f"checkpoint restore of step {at} ({card}): "
                    f"{restore_ms:.1f} ms, {read} bytes read "
                    f"({read / restore_ms / 1e6:.3f} GB/s), {eq}/{n} leaves "
                    f"bit-equal to the snapshot (first unequal: {bad})")
            check(at == 1 and eq == n, line)
            print(line)
            print(f"checkpoint host rates, GB/s over 1 GiB ({card}): "
                  + ", ".join(f"{k} {v:.3f}"
                              for k, v in _host_rates(torch, root).items()))
            rp = out["params"]
            ropt, rstep = trainer(rp)
            ckpt.load_optimizer_state_tree(ropt, rp, out["opt"])
            rloss1 = rstep(rp, batches[1]).item()
            leaves = dp.tree_leaves(rp)
            same = sum(torch.equal(a, b) for a, b in zip(leaves, after1))
            before = dp.tree_leaves(ref["params"])
            u_rel = max(((a - b0) - (b - b0)).norm().item()
                        / max((b - b0).norm().item(), 1e-30)
                        for a, b, b0 in zip(leaves, after1, before))
            bit = rloss1 == loss1 and same == len(leaves)
            line = (f"checkpoint resumed step 1 against the uninterrupted "
                    f"step 1: loss {rloss1:.6f} vs {loss1:.6f}, {same}/"
                    f"{len(leaves)} leaves bit-equal, worst update rel "
                    f"{u_rel:.3g}: " + ("bit-equal held" if bit else
                                        f"within TOL_HVD {TOL_HVD} held"))
            check(bit or (abs(rloss1 - loss1) <= TOL_HVD["loss"]
                          and u_rel <= TOL_HVD["update"]), line)
            print(line)
            del out, rp, ropt, rstep, leaves, after1, before, ref
            shutil.rmtree(os.path.join(root, "1"))
            torch.cuda.empty_cache()

            # async: the step after save() updates the same tensors
            state = {"params": tp, "opt": ckpt.optimizer_state_tree(opt, tp)}
            ref = snapshot(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(root, 2, state, async_=True)
            block_ms = (time.perf_counter() - t0) * 1e3
            stall = ckpt.checkpoint_stats()["snapshot_stall_ms"]
            step(tp, batches[2])
            _, wait_ms = _wall_ms(torch, ckpt.wait)
            s3 = ckpt.checkpoint_stats()
            moved = sum(not torch.equal(a, b) for a, b in zip(
                dp.tree_leaves(tp), dp.tree_leaves(ref["params"])))
            (out, at), restore2_ms = _wall_ms(torch, lambda: ckpt.restore(
                root, like(_trainable(torch, params))))
            eq, n, bad = _bit_equal(torch, dp, out, ref)
            line = (f"checkpoint async save ({card}): save() returned after "
                    f"{block_ms:.1f} ms (snapshot_stall_ms {stall:.1f}) "
                    f"against the sync save's {save_ms:.1f} ms wall; a step "
                    f"then updated {moved} param leaves in place; wait "
                    f"{wait_ms:.1f} ms, write_ms {s3['write_ms']:.1f}; "
                    f"restore {restore2_ms:.1f} ms; {eq}/{n} leaves "
                    f"bit-equal to the snapshot (first unequal: {bad})")
            check(at == 2 and eq == n and moved > 0
                  and s3["commits"] - s1["commits"] == 1, line)
            print(line)
            del out, ref, state, tp, opt, step
            shutil.rmtree(os.path.join(root, "2"))
            torch.cuda.empty_cache()

        # shard_params-marked params over a one-rank model mesh
        mesh = hvd.global_mesh({"model": 1})
        sp = convert.shard_params(params, cfg, mesh)
        _, ms = _wall_ms(torch, lambda: ckpt.save(root, 3, sp, mesh=mesh))
        zeros = tree_map(lambda x: set_leaf_spec(torch.zeros_like(x),
                                                 leaf_spec(x)), sp)
        (out, at), rms = _wall_ms(torch, lambda: ckpt.restore(root, zeros,
                                                              mesh=mesh))
        eq, n, bad = _bit_equal(torch, dp, out, sp)
        specs = sum(leaf_spec(a) == leaf_spec(b) for a, b in zip(
            dp.tree_leaves(out), dp.tree_leaves(sp)))
        line = (f"checkpoint shard_params over {mesh} ({card}): save "
                f"{ms:.1f} ms, restore {rms:.1f} ms; {eq}/{n} leaves "
                f"bit-equal, {specs}/{n} with their spec (first unequal: "
                f"{bad})")
        check(at == 3 and eq == n and specs == n, line)
        print(line)
        shutil.rmtree(os.path.join(root, "3"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = tuple(b - a for a, b in zip(n0, _launches(fa)))
    line = (f"checkpoint launches (flash_fwd, flash_bwd_dq, flash_bwd_dkv) "
            f"over 4 steps: {n} (expected {(4 * L,) * 3})")
    check(n == (4 * L,) * 3, line)
    print(line)


# The elastic phase's part (b): bert-large widths, depth cut to this many
# layers for the phase's time (two worker processes and the smoke's own
# uninterrupted run each build the model and take its steps).
ELASTIC_B_LAYERS = 4
ELASTIC_B_STEPS = 4


class _TimedState:
    """Mixed into elastic.TorchState: records each save, restore and sync
    in ``times`` (ms; the restore and the save synchronise the card)."""

    def _timed(self, name, fn):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def commit(self):
        return self._timed("commit", super().commit)

    def restore(self):
        return self._timed("restore", super().restore)

    def sync(self):
        return self._timed("sync", super().sync)


def phase_elastic_inproc(torch, tfm, dp, fa, ckpt, hvd, params, cfg, card):
    """(a) bert-large's train state (f32 params and AdamW moments, B=8
    S=512 bf16 flash through make_train_step over ``hvd.init()``'s NCCL
    world) in an ``elastic.TorchState`` under ``elastic.run_fn``: step 1
    and a commit; then every tensor of the working state (params, AdamW's
    moments and step counts) gets an in-place ``add_(1)``, so that the
    restore has every leaf to undo; step 2 aborts the world's NCCL group
    after its forward, so its gradient reduction raises
    ``HorovodInternalError`` through torch_ops; the state is restored
    (every leaf held bit-equal to a copy on the card taken at the
    commit, before the reset runs), the reset tears the world down
    (``distributed.teardown``) and builds a new one (``hvd.init()`` and a
    first collective), the state syncs, and step 2 runs again. Every leaf
    after it is held to an uninterrupted step 2 from the same start:
    bit-equal expected, else within TOL_HVD (the line says which held).
    Prints commit_ms (card to pinned host), restore_ms, abort_ms,
    reset_ms, sync_ms and the NCCL groups live before and after."""
    from horovod_tpu_torch import distributed, elastic

    flash = dataclasses.replace(cfg, attn_impl="flash")
    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(19)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                        generator=gen, device="cuda")}
               for _ in range(2)]
    n0 = _launches(fa)
    with torch.enable_grad():
        ref = _trainable(torch, params)
        step = dp.make_train_step(lambda q, b: tfm.loss_fn(q, b, flash),
                                  _adamw(torch, dp, ref),
                                  hvd.global_process_set.group)
        for b in batches:
            step(ref, b)
        start = dp.tree_leaves(_trainable(torch, params))
        want = [x.detach().clone() for x in dp.tree_leaves(ref)]
        del ref, step
        torch.cuda.empty_cache()

        tp = _trainable(torch, params)
        opt = _adamw(torch, dp, tp)
        state = type("TimedTorchState", (_TimedState, elastic.TorchState),
                     {"times": {}})(params=tp, step=0)
        ev = {"faults": 0}

        def loss(q, b):
            out = tfm.loss_fn(q, b, flash)
            if state.step == 1 and not ev["faults"]:
                # the fault: the world's communicator dies mid-step
                ev["faults"] += 1
                ev["live_before"] = distributed.world().live_nccl_groups
                t0 = time.perf_counter()
                distributed.world().abort()
                ev["abort_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def leaves():
            return dp.tree_leaves(tp) + dp.tree_leaves(state.opt)

        def reset():
            # run_fn restored the state just before: it must be the
            # commit of step 1 again, in every leaf
            committed = ev.pop("committed", None)
            if committed is not None:
                ev["restored"] = sum(torch.equal(a, b) for a, b in
                                     zip(leaves(), committed))
                del committed
            t0 = time.perf_counter()
            distributed.teardown()
            hvd.init()
            hvd.barrier()                  # the first collective
            torch.cuda.synchronize()
            ev["reset_ms"] = (time.perf_counter() - t0) * 1e3
            ev["live_after"] = (old_world.live_nccl_groups,
                                distributed.world().live_nccl_groups)
            ev.setdefault("resets", 0)
            ev["resets"] += 1

        def train(state):
            step = dp.make_train_step(loss, opt,
                                      hvd.global_process_set.group)
            while state.step < 2:
                try:
                    step(tp, batches[state.step])
                except hvd.HorovodInternalError as e:
                    ev["error"] = str(e).splitlines()[0][:120]
                    raise
                if state.step == 0:     # AdamW's moments exist now
                    state.opt = ckpt.optimizer_state_tree(opt, tp)
                state.step += 1
                state.commit()
                if state.step == 1 and not ev["faults"]:
                    # the working state moves away from the commit, as a
                    # half-applied step would move it
                    ev["committed"] = [x.clone() for x in leaves()]
                    with torch.no_grad():
                        for x in leaves():
                            x.add_(1)
                    ev["dirty"] = sum(not torch.equal(a, b) for a, b in
                                      zip(leaves(), ev["committed"]))
            return state.step

        old_world = distributed.world()
        steps = elastic.run_fn(train, reset)(state)
        check(steps == 2 and ev.get("resets") == 1
              and distributed.world() is not old_world,
              f"elastic: steps {steps}, resets {ev.get('resets')}, the "
              f"world {'was' if distributed.world() is not old_world else 'was not'} "
              f"rebuilt")
        got = dp.tree_leaves(tp)
        same = sum(torch.equal(a, b) for a, b in zip(got, want))
        worst = max((a - b).abs().max().item() for a, b in zip(got, want))
        u_rel = max(((a - b).norm() / max((b - s).norm().item(), 1e-30))
                    .item() for a, b, s in zip(got, want, start))
        t = state.times
        print(f"elastic (a) bert-large train state in a TorchState "
              f"({sum(x.numel() * x.element_size() for x in state._host) / 1e9:.3f} GB "
              f"committed, {len(state._host)} tensors) ({card}): "
              f"commit_ms after step 1 {t['commit'][0]:.1f} (new pinned "
              f"buffers for the moments), after the redone step 2 "
              f"{t['commit'][-1]:.1f} (buffers reused); restore_ms "
              f"{t['restore'][0]:.1f}; abort_ms {ev['abort_ms']:.1f}; "
              f"reset_ms {ev['reset_ms']:.1f} (teardown, hvd.init(), first "
              f"collective); sync_ms {t['sync'][-1]:.1f} (its own save "
              f"included; the first sync, before step 1, "
              f"{t['sync'][0]:.1f}); NCCL groups live: the world's "
              f"{ev['live_before']} before the abort; after the reset the "
              f"old world's {ev['live_after'][0]}, the new world's "
              f"{ev['live_after'][1]}; the "
              f"failed reduction raised HorovodInternalError: "
              f"{ev['error']!r}")
        n_state = len(leaves())
        line = (f"elastic (a) restore: {ev['dirty']}/{n_state} working "
                f"leaves moved off the step-1 commit before the fault, "
                f"{ev['restored']}/{n_state} bit-equal to it after "
                f"restore()")
        check(ev["dirty"] == n_state and ev["restored"] == n_state, line)
        print(line)
        bit = same == len(want)
        line = (f"elastic (a) redone step 2 against the uninterrupted step "
                f"2 ({card}): {same}/{len(want)} leaves bit-equal, max "
                f"|diff| {worst:.3g}, worst update rel {u_rel:.3g}: "
                + ("bit-equal held" if bit
                   else f"within TOL_HVD {TOL_HVD} held"))
        check(bit or u_rel <= TOL_HVD["update"], line)
        check(ev["live_before"] >= 1 and ev["live_after"][0] == 0
              and ev["live_after"][1] == 1 and "aborted" in ev["error"],
              line)
        print(line)
        del state, tp, opt, want, start, got
        torch.cuda.empty_cache()
    n = tuple(b - a for a, b in zip(n0, _launches(fa)))
    line = (f"elastic (a) launches (flash_fwd, flash_bwd_dq, flash_bwd_dkv) "
            f"over 5 steps (2 uninterrupted, step 1, the failed step 2, "
            f"the redone step 2): {n} (expected {(5 * L,) * 3})")
    check(n == (5 * L,) * 3, line)
    print(line)


def _elastic_b_model(torch, tfm, dp):
    """(cfg, trainable params, batches) of part (b), the same in every
    process: bert-large widths at ELASTIC_B_LAYERS layers, flash, params
    and batches from seeds."""
    cfg = dataclasses.replace(tfm.bert_large(), n_layers=ELASTIC_B_LAYERS,
                              attn_impl="flash")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                        generator=gen, device="cuda")}
               for _ in range(ELASTIC_B_STEPS)]
    return cfg, _trainable(torch, params), batches


def elastic_worker(root):
    """A worker of part (b), launched by the port's launcher as
    ``chip_smoke.py --elastic-worker <root>``: steps 1..4 of the cut
    model, a checkpoint of the train state after step 2, a SIGKILL of
    itself before step 3 (once: a marker file), and, respawned, a restore
    of the step the driver published (``elastic.restore_from_checkpoint``)
    and steps 3 and 4; the params after step 4 go to ``<root>/final.pt``."""
    t_start = time.time()
    import signal

    import torch

    import horovod_tpu_torch.hvd as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch import parallel as dp
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.tree import tree_map

    with open(os.path.join(root, "pids"), "a") as f:
        f.write(f"{os.getpid()}\n")

    def log(line):
        with open(os.path.join(root, "log"), "a") as f:
            f.write(line + "\n")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    cfg, tp, batches = _elastic_b_model(torch, tfm, dp)
    opt = _adamw(torch, dp, tp)
    step = dp.make_train_step(lambda q, b: tfm.loss_fn(q, b, cfg), opt,
                              hvd.global_process_set.group)
    like = {"params": tp, "opt": {"exp_avg": tp, "exp_avg_sq": tp,
                                  "step": tree_map(lambda x: torch.zeros(()),
                                                   tp)}}
    t0 = time.perf_counter()
    out, at = elastic.restore_from_checkpoint(like,
                                              os.path.join(root, "ckpt"))
    first = 0
    if at is not None:
        for a, b in zip(dp.tree_leaves(tp), dp.tree_leaves(out["params"])):
            a.detach().copy_(b)
        ckpt.load_optimizer_state_tree(opt, tp, out["opt"])
        torch.cuda.synchronize()
        first = int(at)
        how = ("assignment" if os.environ.get("HVD_CKPT_STEP")
               else "driver stats")
        log(f"restored step={at} from={how} "
            f"restore_ms={(time.perf_counter() - t0) * 1e3:.1f}")
        del out
    marker = os.path.join(root, "marker")
    with torch.enable_grad():
        for i in range(first, ELASTIC_B_STEPS):
            if i == 2 and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write(f"{time.time()}")
                os.kill(os.getpid(), signal.SIGKILL)
            step(tp, batches[i])
            if i == first:
                torch.cuda.synchronize()
                log(f"first step={i + 1} at={time.time()} "
                    f"since_start={time.time() - t_start:.3f}")
            if i == 1:
                ckpt.save(os.path.join(root, "ckpt"), 2,
                          {"params": tp,
                           "opt": ckpt.optimizer_state_tree(opt, tp)})
    torch.save([x.detach().cpu() for x in dp.tree_leaves(tp)],
               os.path.join(root, "final.pt"))
    log(f"final steps={ELASTIC_B_STEPS}")
    hvd.shutdown()


def phase_elastic_launcher(torch, tfm, dp, fa, hvd, card):
    """(b) the port's launcher, ``python -m horovod_tpu_torch.runner.launch
    --min-np 1 --max-np 1 --host-discovery-script "echo localhost:1"``,
    over ``elastic_worker`` (bert-large widths, ELASTIC_B_LAYERS layers:
    a cut for the phase's time): the worker saves at step 2 (the commit
    reaches the driver), SIGKILLs itself at step 3; the driver respawns
    it; the new process restores the driver-published step and runs to
    step 4. Its params are held to an uninterrupted 4-step run in this
    process (bit-equal expected, else within TOL_HVD). The job's rc must
    be 0, no worker may outlive it, and this process's HVD_* variables
    must be as they were. Prints the respawn-to-first-step time."""
    from horovod_tpu_torch import graft_entry

    hvd_env = {k: v for k, v in os.environ.items() if k.startswith("HVD_")}
    root = tempfile.mkdtemp(prefix="hvd-elastic-")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--min-np", "1", "--max-np", "1",
           "--host-discovery-script", "echo localhost:1", "--verbose",
           sys.executable, os.path.abspath(__file__), "--elastic-worker",
           root]
    try:
        t0 = time.perf_counter()
        rc, out = graft_entry._run_job(cmd, env, 300,
                                       os.path.join(root, "pids"))
        job_s = time.perf_counter() - t0
        with open(os.path.join(root, "log")) as f:
            lines = f.read().splitlines()
        driver = [ln for ln in out.splitlines() if "elastic-driver" in ln]
        check(rc == 0, f"elastic (b): the job exited {rc}:\n{out[-3000:]}")
        restored = [ln for ln in lines if ln.startswith("restored")]
        firsts = [ln for ln in lines if ln.startswith("first")]
        check(len(restored) == 1 and "step=2 " in restored[0]
              and len(firsts) == 2 and "FAILED rc=-9" in out
              and lines[-1] == f"final steps={ELASTIC_B_STEPS}",
              f"elastic (b): {lines}\n{out[-3000:]}")
        with open(os.path.join(root, "marker")) as f:
            killed_at = float(f.read())
        respawned_first = float(firsts[1].split("at=")[1].split()[0])
        got = torch.load(os.path.join(root, "final.pt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check({k: v for k, v in os.environ.items() if k.startswith("HVD_")}
          == hvd_env, "elastic (b) left HVD_* variables changed")
    n0 = _launches(fa)
    cfg, tp, batches = _elastic_b_model(torch, tfm, dp)
    start = [x.detach().clone() for x in dp.tree_leaves(tp)]
    step = dp.make_train_step(lambda q, b: tfm.loss_fn(q, b, cfg),
                              _adamw(torch, dp, tp),
                              hvd.global_process_set.group)
    with torch.enable_grad():
        for b in batches:
            step(tp, b)
    want = [x.detach().cpu() for x in dp.tree_leaves(tp)]
    n = tuple(b - a for a, b in zip(n0, _launches(fa)))
    same = sum(torch.equal(a, b) for a, b in zip(got, want))
    worst = max((a - b).abs().max().item() for a, b in zip(got, want))
    u_rel = max(((a - b).norm() / max((b - s.cpu()).norm().item(), 1e-30))
                .item() for a, b, s in zip(got, want, start))
    bit = same == len(want)
    print(f"elastic (b) launcher job ({card}): rc {rc} in {job_s:.1f} s; "
          f"driver: {' | '.join(d.split('] ', 1)[-1] for d in driver)}; "
          f"worker: {' | '.join(lines)}")
    line = (f"elastic (b) respawned worker against an uninterrupted "
            f"{ELASTIC_B_STEPS}-step run (bert-large widths, "
            f"{ELASTIC_B_LAYERS} layers) ({card}): kill to the respawned "
            f"worker's first step {respawned_first - killed_at:.2f} s "
            f"(its own start to first step "
            f"{firsts[1].split('since_start=')[1]} s); {same}/{len(want)} "
            f"leaves bit-equal, max |diff| {worst:.3g}, worst update rel "
            f"{u_rel:.3g}: " + ("bit-equal held" if bit
                                else f"within TOL_HVD {TOL_HVD} held"))
    check(bit or u_rel <= TOL_HVD["update"], line)
    check(n == (ELASTIC_B_STEPS * ELASTIC_B_LAYERS,) * 3,
          f"elastic (b) launches in this process {n}")
    print(line)


# The observability phase (11): the training steps' count, the serving
# loop's load reports, the launcher's serving worker.
OBS_STEPS = 4
OBS_REPORT_INTERVAL = 4
OBS_STALL = dict(warning_sec=0.5, shutdown_sec=1.0, check_interval=0.05)


class _TickClock:
    """A serve loop's clock that moves 2 ms at every read: admission then
    follows the loop's own calls, not the host's speed, so two runs of the
    same requests batch alike (and give the same bf16 tokens)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.002
        return self.t


def _obs_requests(loop, cfg):
    """The serve phase's bf16 requests (_serve_bf16), made anew."""
    return loop.poisson_requests(8, 40.0, np.random.default_rng(3),
                                 prompt_len=(16, 128), max_new=(16, 32),
                                 vocab=cfg.vocab_size)


def _obs_steps(torch, tfm, dp, hvd, params, cfg, batches, on, trace_dir):
    """OBS_STEPS bert-large steps through DistributedOptimizer(AdamW) from
    ``params``, metrics on or off; with ``trace_dir``, then one more step
    in a profiler window inside a Python span. Returns (losses, leaves
    after the timed steps, seconds per step, the metrics snapshot, the
    expected (calls, bytes), the profiler's trace path)."""
    from horovod_tpu_torch import profiler
    from horovod_tpu_torch.observability import metrics, spans

    flash = dataclasses.replace(cfg, attn_impl="flash")
    hp = _trainable(torch, params)
    hvd.broadcast_parameters(hp, root_rank=0)   # before the count starts
    hopt = hvd.DistributedOptimizer(_adamw(torch, dp, hp))
    leaves = dp.tree_leaves(hp)

    def hstep(b):
        loss = tfm.loss_fn(hp, b, flash)
        loss.backward()
        hopt.step()
        hopt.zero_grad(set_to_none=True)
        return hvd.allreduce(loss.detach().reshape(1))[0]

    if on:
        metrics.REGISTRY.clear()
        metrics.enable()
    losses, secs = [], []
    try:
        with torch.enable_grad():
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(hstep(b).item())
                secs.append(time.perf_counter() - t0)
            snap = metrics.snapshot()
            after = [x.detach().clone() for x in leaves]
            trace = None
            if trace_dir is not None:
                profiler.start(trace_dir)
                try:
                    with spans.span("chip_smoke.train_step", cat="python"):
                        hstep(batches[0]).item()
                finally:
                    trace = profiler.stop().trace_path
    finally:
        metrics.disable()
    # a step: one allreduce call per leaf (DistributedOptimizer, the
    # reference's per-tensor count) and one for the loss
    n = len(batches)
    want = (n * (len(leaves) + 1),
            n * (sum(x.nbytes for x in leaves) + 4))
    return losses, after, secs, snap, want, trace


def phase_observability(torch, tfm, dp, loop, kv_cache, hvd, params, cfg,
                        card, served):
    """The observability plane and serving autoscale on the card: (a)
    OBS_STEPS bert-large steps through DistributedOptimizer with metrics
    off, then on, bit-equal, the registry counting exactly the steps' ops
    and bytes, the stall inspector empty and silent; (b) a forced stall:
    one warning, then the next Horovod op raises StallError naming the
    op; (c) one step under a profiler window inside a Python span, the
    span dump merged with the window's trace into one file; (d) the serve
    phase's 8 requests through ServeLoop with a load reporter feeding an
    AutoscalePolicy; (e) the port's launcher with --serve-autoscale over
    one serving worker, which scrapes its own /metrics."""
    from horovod_tpu_torch.observability import metrics, spans, stall
    from horovod_tpu_torch.serving.autoscale import AutoscalePolicy

    t_phase = time.perf_counter()
    print(f"observability: C4 (an uneven vocabulary under a mesh) cannot "
          f"show on one card: an axis of size 1 divides every dim "
          f"(tests/test_torch_serving_mesh.py holds it at {{model: 4}} on "
          f"the CPU)")
    gen = torch.Generator(device="cuda").manual_seed(31)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 513),
                                        generator=gen, device="cuda")}
               for _ in range(OBS_STEPS)]
    # (a) metrics off, then on, from the same weights
    off_losses, off_leaves, off_secs, _, _, _ = _obs_steps(
        torch, tfm, dp, hvd, params, cfg, batches, False, None)
    spans.recorder.clear()
    trace_dir = tempfile.mkdtemp(prefix="hvd-obs-")
    try:
        on_losses, on_leaves, on_secs, snap, want, trace = _obs_steps(
            torch, tfm, dp, hvd, params, cfg, batches, True, trace_dir)
        same = sum(torch.equal(a, b) for a, b in zip(off_leaves, on_leaves))
        del off_leaves, on_leaves
        calls = {(s["labels"]["op"], s["labels"]["process_set"]): s["value"]
                 for s in snap["hvd_op_calls_total"]["samples"]}
        nbytes = {(s["labels"]["op"], s["labels"]["process_set"]):
                  s["value"] for s in snap["hvd_op_bytes_total"]["samples"]}
        lat = snap["hvd_op_latency_seconds"]["samples"]
        line = (f"observability (a) {OBS_STEPS} bert-large B=8 S=512 bf16 "
                f"flash DistributedOptimizer steps, metrics off then on "
                f"({card}): losses bit-equal {off_losses == on_losses}, "
                f"{same}/{len(dp.tree_leaves(params))} leaves "
                f"bit-equal; the registry: calls {calls}, bytes {nbytes} "
                f"(the steps issued {want[0]} calls, {want[1]} bytes), "
                f"latency sum {sum(s['sum'] for s in lat):.4f} s; in flight "
                f"{stall.inspector.stalled()}, stall warnings "
                f"{snap['hvd_stall_warnings_total']['samples']}")
        check(off_losses == on_losses
              and same == len(dp.tree_leaves(params))
              and calls == {("allreduce", "0"): want[0]}
              and nbytes == {("allreduce", "0"): want[1]}
              and sum(s["count"] for s in lat) == want[0]
              and not stall.inspector.stalled()
              and not snap["hvd_stall_warnings_total"]["samples"], line)
        print(line)
        off_ms = np.mean(off_secs[1:]) * 1e3
        on_ms = np.mean(on_secs[1:]) * 1e3
        print(f"time observability bert-large DistributedOptimizer step "
              f"({card}): metrics off {off_ms:.2f} ms, on {on_ms:.2f} ms, "
              f"difference {on_ms - off_ms:+.2f} ms (mean of steps 2-"
              f"{OBS_STEPS}; off {[round(x * 1e3, 2) for x in off_secs]}, "
              f"on {[round(x * 1e3, 2) for x in on_secs]})")

        # (c) the span dump merged with the profiler window's trace
        t0 = time.perf_counter()
        py = spans.dump(os.path.join(trace_dir, "spans.json"))
        merged = spans.merge_traces(os.path.join(trace_dir, "merged.json"),
                                    trace, py)
        merge_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(merged)
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        ts = [e.get("ts", 0) for e in events]
        line = (f"observability (c) span dump + merge_traces ({card}): "
                f"{len(events)} events, {size} bytes (the profiler's trace "
                f"{os.path.getsize(trace)} bytes), in {merge_ms:.1f} ms; "
                f"hvd.grouped_allreduce {'hvd.grouped_allreduce' in names}, "
                f"hvd.allreduce {'hvd.allreduce' in names}, span "
                f"{'chip_smoke.train_step' in names}, sorted by ts "
                f"{ts == sorted(ts)}")
        check({"hvd.grouped_allreduce", "hvd.allreduce",
               "chip_smoke.train_step"} <= names and ts == sorted(ts), line)
        print(line)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
        spans.recorder.clear()

    # (b) a forced stall on the process-wide inspector
    insp = stall.inspector
    saved = (insp.warning_sec, insp.shutdown_sec, insp.check_interval)
    insp.stop()
    insp.configure(**OBS_STALL)
    metrics.REGISTRY.clear()
    metrics.enable()
    raised = None
    try:
        t0 = time.perf_counter()
        insp.report_start("chip_smoke.forced")
        while not insp.shutdown_fired and time.perf_counter() - t0 < 5.0:
            time.sleep(0.01)
        fired_s = time.perf_counter() - t0
        warns = metrics.STALL_WARNINGS.labels(op="chip_smoke.forced").value
        try:
            hvd.allreduce(torch.ones(1, device="cuda"))
        except stall.StallError as e:
            raised = str(e)
    finally:
        metrics.disable()
        insp.reset()
        insp.stop()
        insp.configure(*saved)
    line = (f"observability (b) forced stall, {OBS_STALL} ({card}): shutdown "
            f"verdict after {fired_s:.2f} s, warnings {warns:g}, the next "
            f"hvd.allreduce raised StallError: {raised!r}")
    check(warns == 1 and raised is not None
          and "chip_smoke.forced" in raised, line)
    print(line)

    # (d) the serve phase's requests with a load reporter
    geo = kv_cache.geometry(n_pages=256, page_size=16, max_context=512)
    policy = AutoscalePolicy(1, 4)
    seen = []

    def report(depth, fill, occupancy):
        seen.append((depth, round(fill, 3), round(occupancy, 3),
                     policy.observe(depth, fill)))

    runs = {}
    for name, kw in (("no reporter", {}),
                     ("reporter", dict(load_reporter=report,
                                       report_interval=OBS_REPORT_INTERVAL))):
        sl = loop.ServeLoop(params, cfg, geo=geo, max_batch=8, device="cuda",
                            **kw)
        sl.warmup()
        summary, finished = sl.run(_obs_requests(loop, cfg),
                                   clock=_TickClock())
        runs[name] = {r.rid: list(r.generated) for r in finished}
        del sl
    as_served = sum(runs["reporter"][k] == v for k, v in served.items())
    line = (f"observability (d) ServeLoop bert-large bf16, 8 requests, a "
            f"load reporter every {OBS_REPORT_INTERVAL} boundaries feeding "
            f"AutoscalePolicy(1, 4) ({card}): {len(seen)} reports "
            f"(queue depth, batch fill, KV occupancy, decision): {seen}; "
            f"tokens equal to the same requests with no reporter "
            f"{runs['reporter'] == runs['no reporter']}; {as_served}/8 "
            f"requests served as in the serve phase (wall clock)")
    check(seen and runs["reporter"] == runs["no reporter"]
          and sum(map(len, runs["reporter"].values())) > 0, line)
    print(line)

    # (e) the launcher with --serve-autoscale over one serving worker
    phase_obs_launcher(torch, card)
    print(f"observability phase ({card}): "
          f"{time.perf_counter() - t_phase:.1f} s")


def serve_worker(root):
    """The serving worker of (e), launched by the port's launcher with
    ``--serve-autoscale --metrics --metrics-port 0`` as ``chip_smoke.py
    --serve-worker <root>``: ``hvd.init()`` (which starts the /metrics
    endpoint), the serve phase's 8 requests at bert-large width through a
    ServeLoop whose load reporter is ``worker.report_serve_load``, a
    scrape of its own /metrics over HTTP, and the driver's stats once it
    has consumed every report; each goes to ``<root>/log`` as JSON."""
    import urllib.error
    import urllib.request

    import torch

    import horovod_tpu_torch.hvd as hvd
    from horovod_tpu_torch import observability as obs
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.runner import http_server
    from horovod_tpu_torch.runner.elastic import worker
    from horovod_tpu_torch.serving import kv_cache, loop

    with open(os.path.join(root, "pids"), "a") as f:
        f.write(f"{os.getpid()}\n")
    out = {}
    hvd.init()
    try:
        out["port"] = port = obs.endpoint_port()
        cfg = tfm.bert_large()
        params = tfm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        reports = []

        def report(depth, fill, occupancy):
            reports.append((depth, round(fill, 3)))
            worker.report_serve_load(depth, fill, occupancy)

        sl = loop.ServeLoop(
            params, cfg, geo=kv_cache.geometry(n_pages=256, page_size=16,
                                               max_context=512),
            max_batch=8, device="cuda", load_reporter=report,
            report_interval=OBS_REPORT_INTERVAL)
        sl.warmup()
        summary, _ = sl.run(_obs_requests(loop, cfg))
        out["tokens"], out["reports"] = summary["tokens"], reports
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        out["scrape_ms"] = (time.perf_counter() - t0) * 1e3
        out["scrape_bytes"] = len(body)
        samples = {}
        for ln in body.splitlines():
            if ln and not ln.startswith("#"):
                key, value = ln.rsplit(" ", 1)
                samples[key] = float(value)
        out["samples"] = len(samples)
        out["hvd_serve_tokens"] = samples.get("hvd_serve_tokens")
        out["hvd_serve_queue_depth"] = samples.get("hvd_serve_queue_depth")
        # Wait for the driver to consume the last report (its key gone),
        # then read its stats. One key per worker: a report that the next
        # overwrites before the driver's poll is lost, as in the reference.
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            try:
                http_server.read_kv(
                    worker._rdv_addr(), "ctl",
                    f"serve_load/{worker._worker_id()}",
                    secret_key=worker._rdv_secret())
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    break
                raise
            time.sleep(0.05)
        time.sleep(0.3)                         # the stats follow the key
        worker._driver_stats_ts = 0.0           # past the stats' cache
        stats = worker.fetch_driver_stats()
        out["driver"] = {k: stats.get(k) for k in (
            "serve_loads", "target_np", "autoscale_events")}
    finally:
        with open(os.path.join(root, "log"), "w") as f:
            json.dump(out, f)
        hvd.shutdown()


def phase_obs_launcher(torch, card):
    """(e): ``python -m horovod_tpu_torch.runner.launch --serve-autoscale
    --min-np 1 --max-np 1 --metrics --metrics-port 0`` over
    ``serve_worker``. The job's rc must be 0 and no worker may outlive it;
    the worker's scrape must parse and count its served tokens; the
    driver must have consumed every load report, with target_np 1 and no
    autoscale event (one card: two NCCL ranks cannot share it, so scaling
    runs over gloo on the CPU only, tests/test_torch_autoscale.py); this
    process's HVD_* variables must be as they were."""
    from horovod_tpu_torch import graft_entry

    hvd_env = {k: v for k, v in os.environ.items() if k.startswith("HVD_")}
    root = tempfile.mkdtemp(prefix="hvd-obs-job-")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--serve-autoscale", "--min-np", "1", "--max-np", "1",
           "--metrics", "--metrics-port", "0", "--verbose",
           sys.executable, os.path.abspath(__file__), "--serve-worker", root]
    try:
        t0 = time.perf_counter()
        rc, out = graft_entry._run_job(cmd, env, 300,
                                       os.path.join(root, "pids"))
        job_s = time.perf_counter() - t0
        check(rc == 0, f"observability (e): the job exited {rc}:\n"
                       f"{out[-3000:]}")
        with open(os.path.join(root, "log")) as f:
            got = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check({k: v for k, v in os.environ.items() if k.startswith("HVD_")}
          == hvd_env, "observability (e) left HVD_* variables changed")
    drv = got.get("driver", {})
    line = (f"observability (e) tpurun --serve-autoscale --min-np 1 "
            f"--max-np 1 --metrics --metrics-port 0, one serving worker "
            f"({card}): rc {rc} in {job_s:.1f} s; the worker's /metrics on "
            f"port {got.get('port')}: scrape {got.get('scrape_ms', 0):.2f} "
            f"ms, {got.get('scrape_bytes')} bytes, {got.get('samples')} "
            f"samples parsed, hvd_serve_tokens {got.get('hvd_serve_tokens')}"
            f" (served {got.get('tokens')}); {len(got.get('reports', []))} "
            f"load reports {got.get('reports')}; the driver's stats {drv} "
            f"(a report the next overwrites before the driver's poll is "
            f"lost, as in the reference)")
    check(got.get("port") and got.get("samples")
          and got.get("hvd_serve_tokens") == got.get("tokens") > 0
          and got.get("reports")
          and 1 <= (drv.get("serve_loads") or 0) <= len(got["reports"])
          and drv.get("target_np") == 1 and drv.get("autoscale_events") == 0,
          line)
    print(line)


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
    # A kernel that never ends must not outlive the run's limit: dump the
    # stacks and end the process (and with it the CUDA context).
    faulthandler.dump_traceback_later(1100, exit=True)
    import horovod_tpu_torch.hvd as hvd
    from horovod_tpu_torch import _build, graft_entry
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import parallel as dp
    from horovod_tpu_torch.models import convert, resnet
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import torch_ops
    # the module, which parallel/__init__ shadows with its function
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
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
        regs = ptxas_summary(_build.build_log(lib))
        local = sass_local(_build._lib_path(lib))
        print(f"ptxas {lib}: " + "; ".join(
            f"{n} {r} regs at launch, {sp} B spilled, SASS: "
            f"{local.get(n, ('?', '?'))[0]} LDL/STL, registers up to "
            f"R{local.get(n, ('?', '?'))[1]}" for n, r, sp in regs))
        for ln in _build.build_log(lib).splitlines():   # e.g. a wgmma
            if "warning" in ln.lower():                  # serialized
                print(f"ptxas {lib}: {ln.strip()}")
        if lib == "flash_bwd":
            tma = [(n, sp, local.get(n, (None,))[0]) for n, _, sp in regs
                   if "_tma_" in n]
            check(tma and all(sp == 0 and ls == 0 for _, sp, ls in tma),
                  f"a tma backward kernel spills: {tma}")

    worst, timings = phase_kernel(torch, fa, spec)
    worst_bwd, timings_bwd = phase_kernel_bwd(torch, fa, spec)
    worst.update(worst_bwd)
    timings.update(timings_bwd)
    bn_shapes, macs = resnet_layout(torch, resnet, 128, 224)
    worst["paired_reduce"], timings["paired_reduce"] = phase_kernel_b4(
        torch, bn, spec, bn_shapes)

    cfg = tfm.bert_large()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def run_path(name, fn, needs):
        """``fn()`` with every launch count set to 0 just before; checks
        that it launched each kernel of ``needs``, and every bf16 launch
        of B1, B2 and B3 on its TMA/wgmma kernel; returns the counts."""
        for c in counters.values():
            c.launches = 0
        for w in VARIANT_WRAPPERS:
            by = counters[w].variant_launches
            for var in by:
                by[var] = 0
        out = fn()
        ran = {k: c.launches for k, c in counters.items()}
        for w in VARIANT_WRAPPERS:
            ran[f"{w} by variant"] = dict(counters[w].variant_launches)
        print(f"launches on the {name} path: {ran}")
        for k in needs:
            check(ran[k] > 0, f"the {name} path never launched {k}")
            if k in VARIANT_WRAPPERS:
                by = ran[f"{k} by variant"]
                check(by["tma"] > 0 and by["mma"] == 0,
                      f"the {name} path sent bf16 {k} launches past the "
                      f"TMA/wgmma kernel: {by}")
        return ran, out

    def serving():
        longctx = phase_forward(torch, tfm, fa, params, cfg)
        return longctx, phase_serve(torch, tfm, loop, kv_cache, convert, hvd,
                                    params, cfg, card)

    hvd.init()                            # NCCL, world size 1
    try:
        group = hvd.global_process_set.group
        served, (longctx, served_bf16) = run_path("serving", serving,
                                                  ["flash_fwd"])
        trained, _ = run_path("training", lambda: phase_train(
            torch, tfm, fa, dp, params, cfg, group, longctx),
            ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        del longctx
        hvd_ran, _ = run_path("hvd", lambda: phase_hvd(
            torch, tfm, dp, hvd, torch_ops, params, cfg, card),
            ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        ring_ref = ring_reference(torch, fa)

        def mesh_phase():
            phase_mesh(torch, tfm, convert, dp, hvd, params, cfg, card)
            phase_ring(torch, fa, ra, *ring_ref)

        mesh_ran, _ = run_path("mesh", mesh_phase,
                               ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        del ring_ref

        def moe_phase():
            phase_moe_layer(torch, dp, hvd, card)
            phase_moe_mesh(torch, tfm, convert, dp, hvd, card)
            phase_moe_dp_ep(torch, tfm, convert, dp, hvd, card)

        moe_ran, _ = run_path("moe", moe_phase,
                              ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        pipe_ran, _ = run_path("pipeline", lambda: phase_pipeline(
            torch, tfm, dp, fa, hvd, params, cfg, card),
            ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        ckpt_ran, _ = run_path("checkpoint", lambda: phase_checkpoint(
            torch, tfm, dp, fa, ckpt, convert, hvd, params, cfg, card),
            ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])

        def elastic_phase():
            phase_elastic_inproc(torch, tfm, dp, fa, ckpt, hvd, params, cfg,
                                 card)
            phase_elastic_launcher(torch, tfm, dp, fa, hvd, card)

        elastic_ran, _ = run_path("elastic", elastic_phase,
                                  ["flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"])
        group = hvd.global_process_set.group   # the reset's new world
        obs_ran, _ = run_path("observability", lambda: phase_observability(
            torch, tfm, dp, loop, kv_cache, hvd, params, cfg, card,
            served_bf16), ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
        del params                        # bert-large leaves the card
        torch.cuda.empty_cache()
        resnet_ran, _ = run_path("ResNet training", lambda: phase_resnet(
            torch, resnet, bn, dp, graft_entry, group, macs // 128),
            ["paired_reduce"])
    finally:
        hvd.shutdown()
    paths = (served, trained, hvd_ran, mesh_ran, moe_ran, pipe_ran,
             ckpt_ran, elastic_ran, obs_ran, resnet_ran)
    by_variant = {w: {var: sum(r[f"{w} by variant"][var] for r in paths)
                      for var in counters[w].variant_launches}
                  for w in VARIANT_WRAPPERS}

    kernels = []
    for k in KERNELS:
        t = timings.get(k["name"]) or timings[k["name"], (8, 512, 16, 64)]
        extra = {}
        if k.get("variant") == "tma":   # all of the wrapper's launches
            launches = sum(r[k["wrapper"]] for r in paths)
            extra["launches_by_variant"] = by_variant[k["wrapper"]]
        elif "variant" in k:
            launches = by_variant[k["wrapper"]][k["variant"]]
        else:
            launches = sum(r[k["wrapper"]] for r in paths)
        if "delta_ms" in t:
            extra["delta_ms"] = t["delta_ms"]
        kernels.append(dict(
            {f: k[f] for f in ("name", "route", "source", "replaces")},
            launches=launches, max_abs_err=worst[k["name"]],
            ms=t["ms"], call_ms=t["call_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], **extra))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:
        elastic_worker(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--serve-worker"]:
        serve_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
