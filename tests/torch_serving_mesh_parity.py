"""Shared by test_torch_serving_mesh.py (the engine's steps and the
cache under a mesh) and test_torch_serving_mesh_loop.py (``ServeLoop``
under a mesh): ``tiny`` in float32, dense and with ``n_experts=2``, one
set of params per config, drawn by the port's ``init_params`` from a
seed and handed to JAX as numpy, and JAX's ``{"model": m}`` meshes on
its 8-device CPU mesh. The two halves are a file each, so that each
file stays well inside its time on the CPU.
"""

import dataclasses

import jax
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch.models import transformer as ttfm


def cfgs(n_experts):
    """(JAX config, port config) of ``tiny(n_experts)`` in float32."""
    return (dataclasses.replace(jtfm.tiny(n_experts), dtype="float32"),
            dataclasses.replace(ttfm.tiny(n_experts), dtype="float32"))


_PARAMS = {}


def params(n_experts):
    """(port params, the same as numpy for JAX), drawn once per config."""
    if n_experts not in _PARAMS:
        _, tcfg = cfgs(n_experts)
        tp = ttfm.init_params(tcfg, torch.Generator().manual_seed(
            30 + n_experts), device="cpu")
        _PARAMS[n_experts] = (tp, _to_numpy(tp))
    return _PARAMS[n_experts]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def jax_mesh(m):
    return Mesh(np.asarray(jax.devices()[:m]), ("model",))


def place(numpy_params, cfg, mesh):
    """JAX params placed by ``param_specs`` over ``mesh``."""
    specs = jtfm.filter_specs(jtfm.param_specs(cfg), mesh)
    return jax.device_put(numpy_params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
