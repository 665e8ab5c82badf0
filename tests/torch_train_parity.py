"""Shared by the port's training parity tests.

- test_torch_train.py and test_torch_train_moe.py: the port's
  ``loss_fn`` loss and every gradient leaf against
  ``jax.value_and_grad(horovod_tpu.models.transformer.loss_fn)`` on
  ``tiny()``, with params converted from one JAX init (:class:`JaxRefs`).
- test_torch_data_parallel.py and test_torch_resnet_train.py: ranks as
  threads (:func:`run_ranks`); the mesh, collective and Horovod API
  tests give each thread a ``World`` over a shared store
  (:func:`run_worlds`).
- the ResNet tests: a narrow, shallow flax ResNet and its port with the
  same variables, made with numpy from a seed (:func:`random_variables`). The variables are drawn at random
  rather than from flax's init (which the port's own initializers
  mirror): bn3's zero scale and the running statistics' 0/1 start would
  leave much of the function untested. Their names and shapes come from
  ``jax.eval_shape`` of the flax init, which compiles nothing.
"""

import dataclasses
import datetime
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.distributed as dist

from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch.graft_entry import _JOIN_GRACE, _on_ranks
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.models.convert import params_from_jax, resnet_from_flax
from horovod_tpu_torch.parallel import (
    make_train_step, shard_batch, tree_flatten_with_path, tree_leaves)

# [B, S+1]: S = 48, so loss_chunk=16 runs three chunks.
TOKENS_SHAPE = (2, 49)


class JaxRefs:
    """One JAX init and token batch per expert count, and the reference
    (loss, {leaf path: grad}) per (dtype, attn_impl), every one computed
    on first use in one jitted program (one compile, where one a case
    would be four). The reference runs with remat off and loss_chunk 0:
    neither changes the function, and every port variant is held to
    it."""

    DTYPES, IMPLS = ("float32", "bfloat16"), ("gather", "flash")

    def __init__(self, n_experts):
        self.n_experts = n_experts
        self.params = jax.jit(jtfm.init_params, static_argnums=1)(
            jax.random.PRNGKey(n_experts), jtfm.tiny(n_experts))
        self.tokens = np.random.default_rng(20 + n_experts).integers(
            0, 256, TOKENS_SHAPE, dtype=np.int32)
        self._refs = {}

    def get(self, dtype, impl):
        if not self._refs:
            cfgs = {(d, i): dataclasses.replace(
                jtfm.tiny(self.n_experts), dtype=d, attn_impl=i)
                for d in self.DTYPES for i in self.IMPLS}
            out = jax.jit(lambda params, batch: {
                key: jax.value_and_grad(jtfm.loss_fn)(params, batch, cfg)
                for key, cfg in cfgs.items()})(
                self.params, {"tokens": self.tokens})
            self._refs = {key: (float(loss), {
                jax.tree_util.keystr(p): np.asarray(g, np.float32)
                for p, g in jax.tree_util.tree_leaves_with_path(grads)})
                for key, (loss, grads) in out.items()}
        return self._refs[dtype, impl]

    def port(self, dtype, impl, remat, loss_chunk):
        """The port's (loss, {leaf path: grad}) on the same params and
        tokens. attn_block=16 makes the plain flash versions loop over
        three blocks (the function does not depend on it)."""
        cfg = dataclasses.replace(ttfm.tiny(self.n_experts), dtype=dtype,
                                  attn_impl=impl, remat=remat,
                                  loss_chunk=loss_chunk, attn_block=16)
        params = params_from_jax(jax.tree.map(np.asarray, self.params),
                                 device="cpu")
        items = tree_flatten_with_path(params)
        leaves = [leaf.requires_grad_() for _, leaf in items]
        loss = ttfm.loss_fn(
            params, {"tokens": torch.tensor(self.tokens).long()}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), {p: g.float().numpy()
                             for (p, _), g in zip(items, grads)}


def rel_errors(got, want):
    """{leaf path: |got - want| / |want|} (Frobenius norms)."""
    assert got.keys() == want.keys()
    return {p: float(np.linalg.norm(got[p] - want[p])
                     / np.linalg.norm(want[p])) for p in want}


# ResNet: a narrow, shallow net (one block a stage, 8 filters, 10 classes).
RESNET_STAGES, RESNET_FILTERS, RESNET_CLASSES = (1, 1, 1, 1), 8, 10


def flax_model(stem, norm, dtype):
    return jresnet.ResNet(stage_sizes=RESNET_STAGES,
                          num_filters=RESNET_FILTERS,
                          num_classes=RESNET_CLASSES,
                          dtype=getattr(jnp, dtype), stem=stem, norm=norm)


def port_model(stem, norm, dtype):
    return tresnet.ResNet(RESNET_STAGES, num_classes=RESNET_CLASSES,
                          num_filters=RESNET_FILTERS,
                          dtype=getattr(torch, dtype),
                          stem=stem, norm=norm, device="cpu")


def random_variables(stem, seed, image=40):
    """flax-shaped ``{"params", "batch_stats"}`` of numpy float32 arrays:
    kernels with variance 1/fan_in, BN scale 1 ± 0.2, biases and running
    means ~0.1, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(
        lambda: flax_model(stem, "flax", "float32").init(
            jax.random.PRNGKey(0), jnp.ones((1, image, image, 3)),
            train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape) / np.sqrt(fan_in)
        if name.endswith("['scale']"):
            return 1.0 + 0.2 * rng.standard_normal(s.shape)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: draw(p, s).astype(np.float32), shapes)


def images(seed, batch=2, image=40):
    return np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32)


def port_with(variables, stem, norm, dtype):
    return resnet_from_flax(port_model(stem, norm, dtype),
                            jax.tree.map(np.asarray, variables))


def flat(tree):
    """``{"a.b.c": numpy array}`` of a flax tree, named as the port's
    modules name their params and buffers and in their layout (conv
    kernels HWIO -> OIHW, the head's kernel [in, out] -> [out, in])."""
    layout = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
    return {".".join(k.key for k in path):
            np.asarray(x, np.float32).transpose(layout[np.ndim(x)])
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def strict_jit(fn, *args):
    """``fn`` compiled for ``args`` with XLA's excess precision off, then
    called on them. XLA may otherwise drop a bf16 rounding the source
    writes (a bf16 conv output read back as float32 keeps its float32
    value), which the port, running op by op, always performs: with the
    flag off both round where the reference's source says."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ResNet train steps, the port's and the reference's, on one batch.
TRAIN_STEM, TRAIN_IMAGE, TRAIN_BATCH = "s2d", 40, 4

_TRAIN_VARIABLES = []


def train_variables():
    if not _TRAIN_VARIABLES:
        _TRAIN_VARIABLES.append(random_variables(TRAIN_STEM, seed=21,
                                                 image=TRAIN_IMAGE))
    return _TRAIN_VARIABLES[0]


def train_batch():
    """``[4, 40, 40, 3]`` images and int32 labels."""
    labels = np.random.default_rng(23).integers(0, 10, TRAIN_BATCH)
    return (images(22, batch=TRAIN_BATCH, image=TRAIN_IMAGE),
            labels.astype(np.int32))


class _Recording(torch.optim.SGD):
    """SGD that keeps the gradients each step was given."""

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]
        return super().step(closure)


def port_steps(norm, dtype, x, labels, group=None, steps=2):
    """[(loss, {name: grad}, {name: param}, {name: running stat})] after
    each step of the port's step on ``group``'s shard of the batch."""
    model = port_with(train_variables(), TRAIN_STEM, norm, dtype)
    params = dict(model.named_parameters())
    names = sorted(params)           # tree_leaves' order of a flat dict
    opt = _Recording(tree_leaves(params), lr=0.1, momentum=0.9)
    step = make_train_step(tresnet.make_loss_fn(model), opt, group)
    batch = shard_batch({"images": torch.tensor(x),
                         "labels": torch.tensor(labels).long()}, group)
    out = []
    for _ in range(steps):
        loss = step(params, batch).item()
        out.append((loss,
                    {n: g.numpy() for n, g in zip(names, opt.grads)},
                    {n: p.detach().numpy().copy() for n, p in params.items()},
                    {n: b.numpy().copy() for n, b in model.named_buffers()}))
    return out


def flax_steps(norm, dtype, x, labels, steps=2):
    """The same from the reference's bench-style step
    (``value_and_grad(has_aux=True)``, ``optax.sgd(0.1, momentum=0.9)``),
    compiled once with excess precision off."""
    model = flax_model(TRAIN_STEM, norm, dtype)
    tx = optax.sgd(0.1, momentum=0.9)
    variables = train_variables()
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    def loss_fn(params, stats, x, labels):
        logits, upd = model.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
        return jresnet.cross_entropy_loss(logits, labels), upd["batch_stats"]

    def train_step(params, stats, opt_state, x, labels):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, x, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, \
            loss, grads

    step = jax.jit(train_step).lower(params, stats, opt_state, x, labels) \
        .compile(compiler_options={"xla_allow_excess_precision": False})
    out = []
    for _ in range(steps):
        params, stats, opt_state, loss, grads = step(params, stats,
                                                     opt_state, x, labels)
        out.append((float(loss), flat(grads), flat(params), flat(stats)))
    return out


def close_all(got, want, tol, step):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=tol[0],
                                   rtol=tol[1], err_msg=f"step {step} {name}")


def grad_vector(grads):
    """All gradient leaves as one vector, in name order."""
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def _on_threads(n, fn, timeout):
    """fn(rank) on n threads; the results in rank order. The threads are
    joined until ``timeout`` plus a grace of a few seconds: a thread
    still alive then fails the test. The error re-raised is the first
    one a rank met."""
    out, errs = [None] * n, []

    def target(rank):
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # re-raised in the test's thread
            errs.append(e)

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(n)]
    deadline = time.monotonic() + timeout + _JOIN_GRACE
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    return out


def run_ranks(n, fn, timeout=60.0):
    """fn(group, rank) on n threads, one ProcessGroupGloo each over a
    shared HashStore; returns the results in rank order. No process is
    spawned. The store and the groups wait ``timeout`` seconds at most,
    so a rank whose peer failed raises instead of blocking."""
    store = dist.HashStore()
    wait = datetime.timedelta(seconds=timeout)
    store.set_timeout(wait)
    return _on_threads(
        n, lambda r: fn(dist.ProcessGroupGloo(store, r, n, wait), r),
        timeout)


def run_worlds(n, fn, timeout=60.0):
    """fn(world) on n threads, each with its own gloo ``World`` of n ranks
    over a shared HashStore; returns the results in rank order (the
    package's own helper, which ``dryrun_multichip`` runs on)."""
    return _on_ranks(n, fn, timeout)
