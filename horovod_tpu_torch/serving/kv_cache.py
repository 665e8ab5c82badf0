"""Paged KV cache: the port of ``horovod_tpu/serving/kv_cache.py``.

Two tensors per cache, ``[n_layers, n_pages, page_size, n_heads,
head_dim]`` for K and V in the model's compute dtype. Requests own pages
through the numpy-side :class:`~.scheduler.PageAllocator` and reach them
through per-request block tables. Page 0 is the trash page: the
allocator never hands it out, and the engine routes every masked write
(inactive batch slots, padding positions) there.
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


def make_cache(cfg, geo, device=None):
    """Zeroed {"k": ..., "v": ...}, each [n_layers, n_pages, page_size,
    n_heads, head_dim] in the compute dtype on ``device``."""
    shape = (cfg.n_layers, geo.n_pages, geo.page_size, cfg.n_heads,
             cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def cache_bytes(cfg, geo):
    """Total cache footprint in bytes (both K and V)."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    per = (cfg.n_layers * geo.n_pages * geo.page_size * cfg.n_heads *
           cfg.head_dim * itemsize)
    return 2 * per
