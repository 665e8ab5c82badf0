"""The per-slot pieces of a local launch: the port's copy of
``find_free_port`` and ``slot_env`` from ``horovod_tpu/runner/local.py``
(reference analog: the per-slot env of ``horovod/runner/gloo_run.py``
``launch_gloo``). The launcher (``launch.py``) and the elastic driver
spawn the processes themselves.

The reference's ``maybe_bind_tpu_chip`` (``TPU_VISIBLE_CHIPS=<slot>``,
set before libtpu initializes) has no CUDA counterpart and is left out:
a worker of the port takes card ``cuda:HVD_LOCAL_RANK`` in
``distributed.init``, after its rank is known, so nothing is pinned at
spawn time.
"""

import os
import socket


def find_free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def slot_env(rank, size, local_rank=None, local_size=None, cross_rank=None,
             cross_size=None, jax_coord_addr=None, extra_env=None):
    """Environment for one rank (reference: the HOROVOD_RANK/... slot env).

    ``jax_coord_addr`` (``HVD_JAX_COORD_ADDR``, the reference's name) is
    the ``host:port`` of the ``TCPStore`` rank 0 hosts, where every rank
    meets to build its process groups (``distributed.init``).
    """
    env = dict(os.environ)
    env["HVD_RANK"] = str(rank)
    env["HVD_SIZE"] = str(size)
    env["HVD_LOCAL_RANK"] = str(local_rank if local_rank is not None else rank)
    env["HVD_LOCAL_SIZE"] = str(local_size if local_size is not None else size)
    env["HVD_CROSS_RANK"] = str(cross_rank if cross_rank is not None else 0)
    env["HVD_CROSS_SIZE"] = str(cross_size if cross_size is not None else 1)
    if jax_coord_addr:
        env["HVD_JAX_COORD_ADDR"] = jax_coord_addr
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    return env
