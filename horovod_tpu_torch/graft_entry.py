"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

- :func:`entry` — the ResNet-50 eval forward (the headline model) with
  example arguments, on the card unless ``device="cpu"``.
- :func:`dryrun_multichip` — the dp×sp×tp×ep MoE-transformer train step
  and the ragged expert dispatch over ``n`` ranks, and the prefix-cached
  serve loop, as far as the port reaches (ROADMAP Queue A item 13).
"""

import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .models import resnet
from .models import transformer as tfm
from .models.convert import shard_params
from .parallel import (create_mesh, make_train_step,
                       moe_dispatch_combine_ragged, shard_batch, tree_leaves)
from .parallel.mesh import World
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


def _on_ranks(n, fn, timeout=120.0):
    """``fn(world)`` on n threads, each a rank of one gloo world on the
    CPU over a shared store; the results in rank order. Each rank runs
    with one intra-op thread."""
    store = dist.HashStore()
    out, errs = [None] * n, [None] * n

    def target(rank):
        try:
            out[rank] = fn(World(store, rank, n, "cpu"))
        except BaseException as e:   # re-raised in the caller's thread
            errs[rank] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(n)]
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        torch.set_num_threads(prev)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a rank did not finish in {timeout} s")
    for e in errs:
        if e is not None:
            raise e
    return out


def dryrun_multichip(n_devices):
    """Build an n-rank mesh with data, seq and model axes (experts on
    data), run one sharded MoE-transformer train step and the ragged
    expert dispatch on it, then the prefix-cached serve loop, and print
    one line naming what ran. The ranks are threads of this process,
    each with a gloo ``World`` on the CPU, which the reference's dry run
    forces too (``force_cpu_platform``).

    The reference's other exercises wait for the modules they drive
    (ROADMAP Queue A): pipeline, pipeline schedules and the composed
    16-device step (item 10); core bridge, hierarchical, autotune,
    bucket, zerocopy, cache and join (item 16); elastic and spare
    promotion (item 12); the TF-XLA step has no counterpart."""
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
    hit_ratio = _serve_prefix_exercise("cpu")
    print(f"dryrun_multichip({n}): mesh=({data},{seq},{model}) "
          f"loss={loss:.4f} ragged-moe ok, serve-prefix ok (warm hit "
          f"ratio {hit_ratio:.2f}) — OK", flush=True)
