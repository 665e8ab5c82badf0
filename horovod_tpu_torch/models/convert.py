"""Params from the JAX package into the port.

:func:`params_from_jax` takes the JAX params as nested numpy arrays (what
``jax.tree.map(np.asarray, params)`` yields) and returns the port's
nested dict of tensors with the same names and shapes;
:func:`shard_params` cuts this rank's shard out of such a tree for a
mesh, and :func:`gather_params` puts the shards back together.
:func:`resnet_from_flax` loads a flax ResNet's ``params`` and
``batch_stats`` into the port's ResNet module. Both packages then
compute the same function, which is how the tests hold one against the
other.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops import torch_ops
from ..parallel.mesh import PaddedAxis, leaf_spec, set_leaf_spec
from .transformer import filter_specs, param_specs


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


def _map_specs(fn, params, specs):
    """``fn(leaf, spec)`` over a params tree and its spec tree (spec
    leaves are tuples, so the two are walked together)."""
    if isinstance(params, dict):
        return {k: _map_specs(fn, params[k], specs[k]) for k in params}
    if isinstance(params, (list, tuple)):
        return [_map_specs(fn, p, s) for p, s in zip(params, specs)]
    return fn(params, specs)


def shard_params(params, cfg, mesh):
    """This rank's shard of the whole transformer ``params`` (as
    :func:`params_from_jax` makes them) under ``mesh``: every dim that
    ``filter_specs(param_specs(cfg), mesh)`` names an axis for is cut into
    that axis's size of equal blocks, and the rank keeps the block at its
    coordinate: ``wqkv`` by heads, ``wo`` by its head rows, ``w_in`` by
    columns, ``w_out`` by rows and ``embed`` by vocabulary rows over
    ``model``, and the experts over ``expert_axis``. Returns new tensors,
    none a view of ``params``, each marked with its spec
    (``parallel/mesh.py::set_leaf_spec``): ``make_train_step`` and
    ``replicate`` then neither reduce nor broadcast a leaf over an axis it
    is cut along.

    A vocabulary the axis does not divide (bert-large's 30522 rows over
    ``{"model": 4}``) is padded with zero rows to the next multiple, as
    GSPMD pads the reference's split, and its spec entry records the true
    size (``mesh.PaddedAxis``): the engine's logits, the model's gathered
    table, the checkpoint and :func:`gather_params` drop the pad rows,
    and the train step gives them no gradient. Any other dim that does
    not divide raises."""
    coords = dict(zip(mesh.axis_names, mesh.coords()))

    def take(x, spec, pad_rows=False):
        spec = list(spec)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n, d = mesh.shape[axis], x.shape[dim]
            if d % n != 0:
                if not (pad_rows and dim == 0):
                    raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf "
                                     f"does not divide by the '{axis}' axis "
                                     f"size {n}")
                x = torch.cat([x, x.new_zeros((-d % n,) + x.shape[1:])])
                spec[dim] = PaddedAxis(axis, d)
            size = x.shape[dim] // n
            x = x.narrow(dim, coords[axis] * size, size)
        return set_leaf_spec(x.clone(memory_format=torch.contiguous_format),
                             spec)

    specs = filter_specs(param_specs(cfg), mesh)
    return {k: (take(v, specs[k], pad_rows=True) if k == "embed"
                else _map_specs(take, v, specs[k]))
            for k, v in params.items()}


def gather_params(params, cfg, mesh):
    """The inverse of :func:`shard_params`: the whole tree, on every rank,
    from each rank's shard (all-gathers over the mesh's axis groups; a
    collective), a padded vocabulary cut back to its true rows. Not
    differentiable."""
    def put(x, spec):
        spec = leaf_spec(x) or spec     # a padded dim's true size
        x = x.detach()
        for dim, axis in enumerate(spec):
            if axis is not None:
                x = torch_ops.allgather(x.movedim(dim, 0),
                                        mesh.group(axis)).movedim(0, dim)
                x = x.narrow(dim, 0, getattr(axis, "size", x.shape[dim]))
        return x.contiguous()

    return _map_specs(put, params, filter_specs(param_specs(cfg), mesh))


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
