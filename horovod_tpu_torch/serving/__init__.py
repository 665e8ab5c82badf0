"""Serving plane of the port: the counterpart of ``horovod_tpu/serving``.

- :mod:`.scheduler`, :mod:`.prefix_cache`, :mod:`.speculate` — the port's
  own copies of the JAX package's numpy-only modules
- :mod:`.kv_cache` — paged K/V tensors (page 0 is the trash page)
- :mod:`.engine` — prefill / decode / chunk steps over block tables
- :mod:`.loop` — the continuous-batching serve loop
- :mod:`.autoscale` — the queue-depth policy the elastic driver folds
  the loop's load reports through (``tpurun --serve-autoscale``)
"""
