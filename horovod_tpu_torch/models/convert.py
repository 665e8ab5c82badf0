"""Params from the JAX package into the port.

:func:`params_from_jax` takes the JAX params as nested numpy arrays (what
``jax.tree.map(np.asarray, params)`` yields) and returns the port's
nested dict of tensors with the same names and shapes.
:func:`resnet_from_flax` loads a flax ResNet's ``params`` and
``batch_stats`` into the port's ResNet module. Both packages then
compute the same function, which is how the tests hold one against the
other.
"""

import numpy as np
import torch

from ..device import resolve_device


def params_from_jax(tree, device=None):
    """Nested dicts / lists of numpy arrays -> the same structure of
    tensors on ``device``."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.tensor(np.asarray(x), device=device)

    return conv(tree)


def _flat(tree, prefix=""):
    """``{"a.b.c": leaf}`` of a nested dict, as ``named_parameters`` names
    a module's leaves."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def resnet_from_flax(model, variables):
    """Load flax ResNet variables ``{"params", "batch_stats"}`` (nested
    dicts of numpy arrays) into the port's ``models.resnet.ResNet``, in
    place; returns ``model``. Conv kernels go HWIO -> OIHW, the head's
    kernel ``[in, out]`` -> ``[out, in]``, ``batch_stats`` into the
    running-statistics buffers. Raises on a name missing on either side
    or a shape that does not match."""
    want = {"params": dict(model.named_parameters()),
            "batch_stats": dict(model.named_buffers())}
    for coll, targets in want.items():
        given = _flat(variables[coll])
        if given.keys() != targets.keys():
            raise ValueError(
                f"{coll}: names differ; only in flax: "
                f"{sorted(given.keys() - targets.keys())}, only in the "
                f"module: {sorted(targets.keys() - given.keys())}")
        for name, raw in given.items():
            x = raw
            if x.ndim == 4:
                x = x.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif x.ndim == 2:
                x = x.T                          # [in, out] -> [out, in]
            t = targets[name]
            if tuple(x.shape) != tuple(t.shape):
                raise ValueError(f"{coll} {name}: flax shape {raw.shape} "
                                 f"maps to {tuple(x.shape)}, the module "
                                 f"holds {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return model
