"""Paged KV cache: the port of ``horovod_tpu/serving/kv_cache.py``.

Two tensors per cache, ``[n_layers, n_pages, page_size, n_heads,
head_dim]`` for K and V in the model's compute dtype. Requests own pages
through the numpy-side :class:`~.scheduler.PageAllocator` and reach them
through per-request block tables. Page 0 is the trash page: the
allocator never hands it out, and the engine routes every masked write
(inactive batch slots, padding positions) there.

Under a :class:`~..parallel.mesh.Mesh` the heads are split over the
``model`` axis (:func:`spec`), and each rank allocates its own
``n_heads / model`` of them: the heads of its ``wqkv`` shard
(``models/transformer.py`` ``param_specs``), so a step's cache reads and
writes are local to the rank and no K/V crosses between ranks.
"""

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Static shape of the cache. max_kv (= max_blocks * page_size) is
    the KV width every decode step gathers; live length is masked."""
    n_pages: int
    page_size: int
    max_blocks: int      # block-table width = max context pages/request

    @property
    def max_kv(self):
        return self.max_blocks * self.page_size


def geometry(n_pages, page_size, max_context):
    """Cache geometry for a max per-request context length (rounded up
    to whole pages)."""
    max_blocks = -(-int(max_context) // int(page_size))
    return CacheGeometry(n_pages=int(n_pages), page_size=int(page_size),
                         max_blocks=max_blocks)


def spec(cfg):
    """The mesh axis of each dim of the K/V tensors: heads on the model
    axis, as ``wqkv``'s column-parallel head shard."""
    return (None, None, None, cfg.model_axis, None)


def placement(cfg, device=None, mesh=None):
    """(device, heads this rank holds) of the cache and the engine's
    steps. Under ``mesh`` the device is the mesh's (a ``device`` of
    another kind raises) and the heads are ``n_heads`` over the model
    axis, which must divide them."""
    if mesh is None:
        return resolve_device(device), cfg.n_heads
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device!r} is not the mesh's device "
                         f"{mesh.device}")
    axis = spec(cfg)[3]
    model = mesh.shape.get(axis, 1)
    if cfg.n_heads % model != 0:
        raise ValueError(
            f"the cache's heads are sharded over the '{axis}' "
            f"axis, which implies that the global size of its dimension 3 "
            f"should be divisible by {model}, but it is equal to "
            f"{cfg.n_heads}")
    return mesh.device, cfg.n_heads // model


def make_cache(cfg, geo, device=None, mesh=None):
    """Zeroed {"k": ..., "v": ...}, each [n_layers, n_pages, page_size,
    heads, head_dim] in the compute dtype on ``device``: all n_heads, or
    under ``mesh`` this rank's n_heads / model (:func:`placement`)."""
    device, heads = placement(cfg, device, mesh)
    shape = (cfg.n_layers, geo.n_pages, geo.page_size, heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def cache_bytes(cfg, geo):
    """Total cache footprint in bytes (both K and V), over all heads
    (under a mesh, the sum of every model rank's share)."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    per = (cfg.n_layers * geo.n_pages * geo.page_size * cfg.n_heads *
           cfg.head_dim * itemsize)
    return 2 * per
