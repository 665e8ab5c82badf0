"""Shared by test_torch_train.py and test_torch_train_moe.py: the port's
``loss_fn`` loss and every gradient leaf against
``jax.value_and_grad(horovod_tpu.models.transformer.loss_fn)`` on
``tiny()``, with params converted from one JAX init."""

import dataclasses

import jax
import numpy as np
import torch

from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.models.convert import params_from_jax
from horovod_tpu_torch.parallel import tree_flatten_with_path

# [B, S+1]: S = 48, so loss_chunk=16 runs three chunks.
TOKENS_SHAPE = (2, 49)


class JaxRefs:
    """One JAX init and token batch per expert count, and the reference
    (loss, {leaf path: grad}) per (dtype, attn_impl), computed on first
    use. The reference runs with remat off and loss_chunk 0: neither
    changes the function, and every port variant is held to it."""

    def __init__(self, n_experts):
        self.n_experts = n_experts
        self.params = jax.jit(jtfm.init_params, static_argnums=1)(
            jax.random.PRNGKey(n_experts), jtfm.tiny(n_experts))
        self.tokens = np.random.default_rng(20 + n_experts).integers(
            0, 256, TOKENS_SHAPE, dtype=np.int32)
        self._refs = {}

    def get(self, dtype, impl):
        if (dtype, impl) not in self._refs:
            cfg = dataclasses.replace(jtfm.tiny(self.n_experts), dtype=dtype,
                                      attn_impl=impl)
            loss, grads = jax.jit(jax.value_and_grad(jtfm.loss_fn),
                                  static_argnums=2)(
                self.params, {"tokens": self.tokens}, cfg)
            self._refs[dtype, impl] = (float(loss), {
                jax.tree_util.keystr(p): np.asarray(g, np.float32)
                for p, g in jax.tree_util.tree_leaves_with_path(grads)})
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
