"""Params from the JAX package into the port.

:func:`params_from_jax` takes the JAX params as nested numpy arrays (what
``jax.tree.map(np.asarray, params)`` yields) and returns the port's
nested dict of tensors with the same names and shapes. Both packages
then compute the same function, which is how the tests hold one against
the other.
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
