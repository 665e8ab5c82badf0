"""The port's meshes (horovod_tpu_torch/parallel/mesh.py) against the JAX
package's ``create_mesh`` on the 8-device CPU mesh.

For 1, 2, 4 and 8 ranks, at every ``__graft_entry__._mesh_shape(n)``
layout and at one with an inferred (-1) axis: each rank's coordinates
and each of its groups' members (one axis, and the first two axes
together) are those of the JAX Mesh's device grid, and a Sum over each
group equals ``jax_ops.allreduce(..., op=Sum)`` inside ``shard_map``
over that axis, on float32 inputs made with numpy from a seed and int32
inputs. float32: the same values summed in another order, so each
element within 1e-6 of the sum of the magnitudes it adds; int32: exact. The ValueErrors are the reference's.

Ranks are threads, each with its own gloo ``World`` over one shared
``HashStore``; no process is spawned.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

torch.set_num_threads(1)

from __graft_entry__ import _mesh_shape  # noqa: E402
from horovod_tpu.ops import jax_ops  # noqa: E402
from horovod_tpu.parallel import mesh as jmesh  # noqa: E402
from horovod_tpu_torch.ops import torch_ops  # noqa: E402
from horovod_tpu_torch.parallel import create_mesh, mesh_axis_size  # noqa: E402

from .torch_train_parity import run_worlds  # noqa: E402


def _layouts():
    out = []
    for n in (1, 2, 4, 8):
        d, s, m = _mesh_shape(n)
        out.append((n, {"data": d, "seq": s, "model": m}))
        out.append((n, {"data": -1, "model": 2 if n > 1 else 1}))
    return out


def _jax_sum(mesh, axes, x):
    """jax_ops.allreduce(op=Sum) over ``axes`` inside shard_map, row r of
    ``x`` on device r."""
    spec = P(tuple(mesh.axis_names))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    def run(v):
        return jax_ops.allreduce(v, axes, op=jax_ops.Sum)

    return np.asarray(run(x))


@pytest.mark.parametrize("n,shape", _layouts(),
                         ids=[f"{n}-{s}" for n, s in _layouts()])
def test_mesh_matches_the_reference_grid_and_sums(n, shape):
    jm = jmesh.create_mesh(dict(shape), devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    names = tuple(jm.axis_names)
    axes_list = [(a,) for a in names] + [names[:2]]
    rng = np.random.default_rng(n)
    xf = rng.standard_normal((n, 3, 5)).astype(np.float32)
    xi = rng.integers(-1000, 1000, (n, 4)).astype(np.int32)

    def body(world):
        mesh = create_mesh(dict(shape), world)
        r = world.rank
        got = {"shape": mesh.shape, "coords": mesh.coords(),
               "members": {}, "f32": {}, "i32": {}}
        for axes in axes_list:
            group = mesh.groups(axes)
            got["members"][axes] = (mesh.members(axes), group.rank(),
                                    group.size())
            got["f32"][axes] = torch_ops.allreduce(
                torch.tensor(xf[r]), group, torch_ops.Sum).numpy()
            got["i32"][axes] = torch_ops.allreduce(
                torch.tensor(xi[r]), group, torch_ops.Sum).numpy()
        return got

    ranks = run_worlds(n, body)
    for r, got in enumerate(ranks):
        assert got["shape"] == dict(jm.shape)
        assert list(got["shape"]) == list(names)
        coords = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert got["coords"] == coords
        for axes in axes_list:
            # The JAX group: the devices that differ from r only in `axes`
            # (in mesh order here), row-major over them.
            sel = tuple(slice(None) if a in axes else coords[i]
                        for i, a in enumerate(names))
            want = [int(v) for v in ids[sel].ravel()]
            members, grank, gsize = got["members"][axes]
            assert members == want, (r, axes)
            assert (grank, gsize) == (want.index(r), len(want))
    for axes in axes_list:
        jaxes = axes if len(axes) > 1 else axes[0]
        want_f = _jax_sum(jm, jaxes, xf)
        want_i = _jax_sum(jm, jaxes, xi)
        bound = 1e-6 * _jax_sum(jm, jaxes, np.abs(xf))
        for r, got in enumerate(ranks):
            assert np.all(np.abs(got["f32"][axes] - want_f[r]) <= bound[r])
            np.testing.assert_array_equal(got["i32"][axes], want_i[r])


@pytest.mark.parametrize("shape", [{"a": -1, "b": -1}, {"a": -1, "b": 3},
                                   {"a": 3}, {"a": 2, "b": 3}])
def test_mesh_errors_match_the_reference(shape):
    """The checks run before any group is built, so a stand-in world of
    four ranks serves."""
    with pytest.raises(ValueError) as want:
        jmesh.create_mesh(dict(shape), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as got:
        create_mesh(dict(shape), types.SimpleNamespace(size=4))
    assert str(got.value) == str(want.value)


def test_default_mesh_and_axis_size():
    """No sizes: one 'data' axis over every rank, as the reference."""
    ranks = run_worlds(2, lambda w: create_mesh(None, w))
    for r, mesh in enumerate(ranks):
        assert mesh.shape == {"data": 2}
        assert mesh_axis_size(mesh, "data") == 2
        assert mesh.coords() == (r,)
        assert mesh.group("data").size() == 2
