"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

- :func:`entry` — the ResNet-50 eval forward (the headline model) with
  example arguments, on the card unless ``device="cpu"``.
- :func:`dryrun_multichip` — the dp×sp×tp×ep MoE-transformer train step
  and the ragged expert dispatch over ``n`` ranks, the pipeline
  exercises (gpipe forward, every schedule's gradients, pp×dp×tp×ep on
  16 ranks), and the prefix-cached serve loop, as far as the port
  reaches (ROADMAP Queue A items 10 and 13).
"""

import dataclasses
import datetime
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .device import resolve_device
from .models import resnet
from .models import transformer as tfm
from .models.convert import shard_params
from .ops import torch_ops
from .parallel import (copy_to, create_mesh, make_pipeline_value_and_grad,
                       make_train_step, moe_dispatch_combine,
                       moe_dispatch_combine_ragged, pipeline_apply,
                       reduce_from, schedule_info, shard_batch,
                       shard_stage_params, tree_leaves)
from .parallel.mesh import World
from .parallel.schedules import interleave_permutation
from .serving import kv_cache
from .serving.loop import ServeLoop
from .serving.scheduler import Request


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(model, images)`` is the
    ResNet-50 eval forward (1000 classes, random weights from seed 0)
    and ``images`` are ``8×128×128×3`` float32 ones; ``fn(*args)`` gives
    float32 logits ``[8, 1000]``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = resnet.create_train_state(gen, image_size=128, num_classes=1000,
                                      device=device)
    images = torch.ones((8, 128, 128, 3), device=device)

    def fwd(model, images):
        with torch.no_grad():
            return model(images, train=False)

    return fwd, (model, images)


def _mesh_shape(n):
    """Factor n ranks into (data, seq, model) axis sizes."""
    model = 2 if n % 2 == 0 else 1
    seq = 2 if n % 4 == 0 else 1
    data = n // (model * seq)
    return data, seq, model


def _sharded_train_step(mesh, data, seq, model, params=None):
    """One dp×sp×tp(+ep) MoE-transformer SGD(1e-3) step over ``mesh``
    (axes ``data``, ``seq``, ``model``), called by every rank of it;
    returns the step's loss, the same on every rank.

    ep: the experts ride the data axis (the reference's dp=ep reuse);
    tp: heads and the FFN's hidden dim over ``model``; sp: the sequence
    over ``seq``, with ring attention when it is larger than 1; dp: the
    batch over ``data``. ``params``: the whole tree (as
    ``convert.params_from_jax`` makes it) to start from, by default a
    random init from seed 0; each rank takes its shard."""
    cfg = dataclasses.replace(tfm.tiny(n_experts=max(2, data)),
                              expert_axis="data",
                              attn_impl="ring" if seq > 1 else "gather")
    if params is None:
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=mesh.device)
    params = shard_params(params, cfg, mesh)
    opt = torch.optim.SGD([x.requires_grad_() for x in tree_leaves(params)],
                          lr=1e-3)
    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg, mesh=mesh),
                           opt, mesh, data_axis=("data", "seq"))
    B, S = 2 * data, 32   # S divides by any seq-axis size here
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    batch = shard_batch({"tokens": torch.tensor(tokens, device=mesh.device)},
                        mesh, "data")
    with torch.enable_grad():
        loss = step(params, batch).item()
    assert np.isfinite(loss), f"non-finite loss {loss}"
    return loss


def _ragged_moe_exercise(mesh, data):
    """Ragged expert dispatch over the data axis under skewed routing:
    each peer gets only the rows routed to it. Returns this rank's rows
    of the output (its block of the data axis)."""
    E, D, T = 2 * data, 8, 16 * data
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, D)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += 1.5   # skewed routing
    rows = T // data
    i = mesh.coords()[mesh.axis_names.index("data")]

    def local(a):
        return torch.tensor(a[i * rows:(i + 1) * rows], device=mesh.device)

    out, aux = moe_dispatch_combine_ragged(
        local(x), local(logits), lambda buf: buf * 2.0, mesh.group("data"),
        peer_capacity=T // data)
    out = out + 0.0 * aux["load_balance_loss"]
    assert bool(torch.isfinite(out).all()) and float(out.abs().sum()) > 0.0
    return out


def _pipeline_exercise(n):
    """GPipe over a 'pipe' axis of min(4, n) thread ranks: forward
    parity against the sequential composition. Returns the outputs."""
    S, D = min(4, n), 8   # stage count tracks the gate's n
    rng = np.random.default_rng(5)
    W = (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(8, D)).astype(np.float32)

    def rank(world):
        mesh = create_mesh({"pipe": S}, world)
        with torch.no_grad():
            return pipeline_apply(
                lambda p, h: torch.tanh(h @ p["w"]),
                shard_stage_params({"w": W}, mesh), torch.tensor(x), mesh,
                n_microbatches=4).numpy()

    outs = _on_ranks(S, rank)
    ref = x
    for s in range(S):
        ref = np.tanh(ref @ W[s])
    for out in outs:
        assert np.allclose(out, ref, atol=1e-5)
    return outs[0]


def _stage_grads(results, S, V):
    """The whole network-order gradient from each rank's (s, slice)."""
    perm = interleave_permutation(S, V)
    g = np.zeros((S * V,) + results[0][1].shape[1:], np.float32)
    for s, part in results:
        g[perm[s * V:(s + 1) * V]] = part
    return g


def _pipeline_schedule_exercise(n):
    """Every pipeline schedule: gpipe / 1f1b / interleaved:2 / zb each
    run a value-and-grad step over the same stage slices (gpipe/1f1b/zb:
    S ranks; interleaved: S/2 ranks, V=2 — identical math), with loss
    and gradient parity against gpipe; then the bubble orderings from
    ``schedule_info`` (1f1b < gpipe and zb <= 1f1b at M = S, 2S, 4S;
    interleaved < 1f1b at M = S). Returns {schedule: (loss, grad)}."""
    SV = 8 if n >= 8 else 4  # total stage slices
    D, B = 8, 16
    rng = np.random.default_rng(11)
    W = (rng.normal(size=(SV, D, D)) / np.sqrt(D)).astype(np.float32)
    batch = {"x": torch.tensor(rng.normal(size=(B, D)), dtype=torch.float32),
             "y": torch.tensor(rng.normal(size=(B, D)), dtype=torch.float32)}

    def run(name, S, V):
        def rank(world):
            mesh = create_mesh({"pipe": S}, world)
            vg = make_pipeline_value_and_grad(
                lambda p, h: torch.tanh(h @ p["w"]),
                lambda o, b: ((o - b["y"]) ** 2).mean(), mesh,
                n_microbatches=SV, schedule=name, virtual_stages=V)
            loss, g = vg(shard_stage_params({"w": W}, mesh,
                                            virtual_stages=V or 1), batch)
            return loss.item(), (mesh.rank, g["w"].numpy())
        got = _on_ranks(S, rank)
        assert len({loss for loss, _ in got}) == 1, got
        return got[0][0], _stage_grads([r for _, r in got], S, V or 1)

    out = {}
    for name, S, V in (("gpipe", SV, None), ("1f1b", SV, None),
                       ("interleaved", SV // 2, 2), ("zb", SV, None)):
        out[name] = loss, g = run(name, S, V)
        ref = out["gpipe"]
        assert abs(loss - ref[0]) < 1e-5, (name, loss, ref[0])
        assert np.abs(g - ref[1]).max() < 1e-4, name
    for m in (SV, 2 * SV, 4 * SV):
        bub = {name: schedule_info(name, SV, m, v).bubble_fraction
               for name, v in (("gpipe", None), ("1f1b", None), ("zb", None),
                               ("interleaved", 2))}
        assert bub["1f1b"] < bub["gpipe"] and bub["zb"] <= bub["1f1b"], bub
        if m == SV:   # interleaved divides the bubble at M = S
            assert bub["interleaved"] < bub["1f1b"], bub
    return out


def _composed_params():
    """The composed exercise's stage params (S = 2 stages leading), batch
    and sizes, from the reference's seed."""
    S, D, F_, E, B, M = 2, 8, 16, 4, 16, 2
    rng = np.random.default_rng(19)
    W = {"proj": rng.normal(size=(S, D, D)) / np.sqrt(D),
         "router": rng.normal(size=(S, D, E)),
         "w_in": rng.normal(size=(S, E, D, F_)) / np.sqrt(D),
         "w_out": rng.normal(size=(S, E, F_, D)) / np.sqrt(F_)}
    W = {k: v.astype(np.float32) for k, v in W.items()}
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = rng.normal(size=(B, D)).astype(np.float32)
    return W, x, y, M


def _composed_stage(mesh):
    """The composed stage: a tensor-parallel projection (its input dim
    split over 'model', the partial products summed back, Megatron
    row-parallel) and a residual MoE FFN whose experts are split over
    'expert' and dispatched with one all-to-all each way."""
    model, expert = mesh.group("model"), mesh.group("expert")
    k = mesh.coords()[mesh.axis_names.index("model")]
    ke = mesh.coords()[mesh.axis_names.index("expert")]

    def stage_fn(p, h):
        # Each model rank uses its block of h's columns and of proj's
        # rows: copy_to sums their gradients over 'model' in the backward.
        dh = h.shape[1] // model.size()
        h_loc = copy_to(h, model)[:, k * dh:(k + 1) * dh]
        w_loc = copy_to(p["proj"], model)[k * dh:(k + 1) * dh]
        h2 = torch.tanh(reduce_from(h_loc @ w_loc, model))
        e_loc = p["w_in"].shape[0] // expert.size()
        wi = p["w_in"][ke * e_loc:(ke + 1) * e_loc]
        wo = p["w_out"][ke * e_loc:(ke + 1) * e_loc]

        def expert_fn(buf):
            hh = torch.einsum("end,edf->enf", buf.float(), wi.float())
            return torch.einsum("enf,efd->end",
                                F.gelu(hh, approximate="tanh"),
                                wo.float()).to(buf.dtype)

        # capacity covers every token: parity with the dense reference
        moe, _ = moe_dispatch_combine(h2, h2 @ p["router"], expert_fn,
                                      expert, capacity=h2.shape[0])
        return h2 + moe

    return stage_fn


def _composed_reference(W, x, y):
    """The single-device composition of the same math: (loss, grads)."""
    p = {k: torch.tensor(v, requires_grad=True) for k, v in W.items()}
    h = torch.tensor(x)
    with torch.enable_grad():
        for s in range(W["proj"].shape[0]):
            h2 = torch.tanh(h @ p["proj"][s])
            probs = torch.softmax(h2 @ p["router"][s], -1)
            e = probs.argmax(-1)
            gate = probs.gather(1, e[:, None])[:, 0]
            hh = F.gelu(torch.einsum("td,tdf->tf", h2, p["w_in"][s][e]),
                        approximate="tanh")
            moe = torch.einsum("tf,tfd->td", hh, p["w_out"][s][e])
            h = h2 + gate[:, None] * moe
        loss = ((h - torch.tensor(y)) ** 2).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(p, grads)}


def _composed_16dev_exercise():
    """pp x dp x tp x ep composed on ONE 16-rank mesh, 2x2x2x2 (pipe,
    data, model, expert), ranks as threads: a 2-stage gpipe pipeline
    whose stage runs :func:`_composed_stage`, microbatch rows over
    'data'. Loss and gradient parity against the single-device
    composition. Returns (loss, {leaf: gradient of the whole tree})."""
    W, x, y, M = _composed_params()

    def rank(world):
        mesh = create_mesh({"pipe": 2, "data": 2, "model": 2, "expert": 2},
                           world)
        vg = make_pipeline_value_and_grad(
            _composed_stage(mesh), lambda o, b: ((o - b["y"]) ** 2).mean(),
            mesh, n_microbatches=M, batch_axis="data")
        batch = shard_batch({"x": torch.tensor(x), "y": torch.tensor(y)},
                            mesh, "data")
        loss, g = vg(shard_stage_params(W, mesh), batch)
        # Each expert rank owns its experts, whose gradients came from
        # both expert ranks' (equal) copies of the tokens: the mean over
        # 'expert' fills every expert's rows once.
        for leaf in ("w_in", "w_out"):
            torch_ops.allreduce_(g[leaf], mesh.group("expert"),
                                 torch_ops.Average)
        return loss.item(), mesh.coords()[0], {k: v.numpy()
                                               for k, v in g.items()}

    got = _on_ranks(16, rank)
    loss, grads = got[0][0], {k: np.zeros_like(v) for k, v in W.items()}
    for rank_loss, s, g in got:
        assert rank_loss == loss, (rank_loss, loss)
        for k in grads:
            grads[k][s] = g[k][0]
    ref, ref_grads = _composed_reference(W, x, y)
    assert abs(loss - ref) < 1e-5, (loss, ref)
    for k in W:
        d = np.abs(grads[k] - ref_grads[k]).max()
        assert d < 1e-4, (k, d)
    return loss, grads


def _serve_prefix_exercise(device):
    """The prefix cache: a cold request warms the radix prefix cache; a
    second one with the same 24-token prefix admits with those tokens'
    pages shared, chunk-fills only its tail, and emits the cache-off
    greedy chain. One process on ``device``, as the reference runs it.
    Returns the warm hit ratio."""
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_seq_len=64,
                                dtype="float32")
    geo = kv_cache.geometry(n_pages=32, page_size=8, max_context=64)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    prefix = [int(x) for x in
              np.random.default_rng(16).integers(0, 64, size=24)]

    def req(rid, tail):
        return Request(rid=rid, prompt=prefix + tail, max_new_tokens=6,
                       arrival_t=1e-9)

    ref = ServeLoop(params, cfg, geo=geo, max_batch=2, prefix_cache=False,
                    device=device)
    _, ref_fin = ref.run([req(1, [7, 8])])
    sl = ServeLoop(params, cfg, geo=geo, max_batch=2, prefix_cache=True,
                   device=device)
    _, cold = sl.run([req(0, [5, 6])])
    assert cold[0].cached_tokens == 0, "cold request cannot hit"
    _, warm = sl.run([req(1, [7, 8])])
    assert warm[0].cached_tokens == 24, (
        f"warm request missed the prefix cache: "
        f"cached_tokens={warm[0].cached_tokens}")
    assert warm[0].generated == ref_fin[0].generated, \
        "prefix-hit chain diverged from the cache-off chain"
    assert sl.loop_stats["chunk_fills"] >= 1
    return sl.batcher.prefix_hit_ratio()


# Seconds the threads are joined past their groups' timeout: a rank's
# wait raises at that timeout, counted from when the wait began.
_JOIN_GRACE = 5.0


def _on_ranks(n, fn, timeout=120.0):
    """``fn(world)`` on n threads, each a rank of one gloo world on the
    CPU over a shared store; the results in rank order. Each rank runs
    with one intra-op thread. The store and every group of the world
    wait ``timeout`` seconds at most, so a rank whose peer failed raises
    too; the threads are joined until all have ended (that timeout and
    a few seconds' grace), and the error re-raised is the first one a
    rank met, the cause rather than its peers' timeouts."""
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=timeout))
    out, errs = [None] * n, []

    def target(rank):
        try:
            out[rank] = fn(World(store, rank, n, "cpu", timeout=timeout))
        except BaseException as e:   # re-raised in the caller's thread
            errs.append(e)           # in the order the ranks failed

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(n)]
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    deadline = time.monotonic() + timeout + _JOIN_GRACE
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
    finally:
        torch.set_num_threads(prev)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a rank did not finish in {timeout} s")
    return out


def dryrun_multichip(n_devices):
    """Build an n-rank mesh with data, seq and model axes (experts on
    data), run one sharded MoE-transformer train step and the ragged
    expert dispatch on it, then the pipeline exercises (a gpipe forward
    over min(4, n) ranks, the four schedules' gradients against each
    other and their bubble orderings, and the composed pp×dp×tp×ep step
    on 16 ranks), then the prefix-cached serve loop, and print one line
    naming what ran. The ranks are threads of this process, each with a
    gloo ``World`` on the CPU, which the reference's dry run forces too
    (``force_cpu_platform``).

    The reference's other exercises wait for the modules they drive
    (ROADMAP Queue A): core bridge, hierarchical, autotune, bucket,
    zerocopy, cache and join (item 16); elastic and spare promotion
    (item 12); the TF-XLA step has no counterpart."""
    n = int(n_devices)
    data, seq, model = _mesh_shape(n)

    def rank(world):
        mesh = create_mesh({"data": data, "seq": seq, "model": model}, world)
        loss = _sharded_train_step(mesh, data, seq, model)
        _ragged_moe_exercise(mesh, data)
        return loss

    losses = _on_ranks(n, rank)
    assert len(set(losses)) == 1, f"the ranks' losses differ: {losses}"
    loss = losses[0]
    _pipeline_exercise(n)
    _pipeline_schedule_exercise(n)
    _composed_16dev_exercise()
    hit_ratio = _serve_prefix_exercise("cpu")
    print(f"dryrun_multichip({n}): mesh=({data},{seq},{model}) "
          f"loss={loss:.4f} ragged-moe ok, pipeline ok, "
          f"pipeline-schedules ok (gpipe/1f1b/interleaved/zb grad-parity, "
          f"bubble orderings hold), "
          f"composed-16dev ok (pp x dp x tp x ep grad parity), "
          f"serve-prefix ok (warm hit ratio {hit_ratio:.2f}) — OK",
          flush=True)
