"""Observability: metrics registry, stall inspector, span timeline (the
port of ``horovod_tpu/observability``).

- :mod:`.metrics`: the process-local Counter/Gauge/Histogram registry
  and its Prometheus text, filled by the Horovod ops
  (``ops/torch_ops.py``), the elastic plane, the pipeline, the serve
  loop and the checkpoint.
- :mod:`.stall`: the stall inspector around every Horovod op.
- :mod:`.spans`: the Chrome-trace span recorder, and
  :func:`merge_traces` to fold the spans and a profiler window's trace
  into one file.

All of it is off unless ``HVD_METRICS=1`` (or :func:`metrics.enable`).
``/metrics`` is served by the elastic driver's KV server and, in a
worker, by :class:`~..runner.http_server.MetricsServer`, which
``hvd.init()`` starts when ``HVD_METRICS_PORT`` is set
(:func:`maybe_start_endpoint`). Nothing here imports torch.
"""

import logging
import os

from . import metrics, spans, stall  # noqa: F401
from .metrics import enabled  # noqa: F401
from .spans import merge_traces  # noqa: F401

_endpoint = None


def start_endpoint(port=0, addr="0.0.0.0"):
    """Serve this process's registry at ``http://addr:port/metrics``;
    port 0 takes a free one. Returns the bound port (the running
    endpoint's, when one is up)."""
    global _endpoint
    from ..runner.http_server import MetricsServer

    if _endpoint is None:
        server = MetricsServer(addr=addr)
        bound = server.start(port)     # a busy port raises: none is kept
        _endpoint = server
        return bound
    return _endpoint.port


def stop_endpoint():
    global _endpoint
    if _endpoint is not None:
        _endpoint.stop()
        _endpoint = None


def endpoint_port():
    """The port :func:`start_endpoint` bound, or None."""
    return None if _endpoint is None else _endpoint.port


def maybe_start_endpoint():
    """``hvd.init()``'s hook: start the scrape endpoint when metrics are on
    and ``HVD_METRICS_PORT`` names a port. Ranks that share a host offset
    it by ``HVD_LOCAL_RANK``, so each binds its own (0: a free port for
    each). Never raises: a busy port logs a warning and must not kill
    training. Returns the port, or None."""
    if not metrics.enabled():
        return None
    raw = os.environ.get("HVD_METRICS_PORT")
    if raw is None:
        return None
    try:
        base = int(raw)
        port = base
        if base != 0:
            port = base + int(os.environ.get("HVD_LOCAL_RANK", "0"))
        return start_endpoint(port)
    except Exception as e:  # noqa: BLE001 — observability is best-effort
        logging.getLogger("horovod_tpu_torch.metrics").warning(
            "metrics endpoint failed to start on port %s: %s", raw, e)
        return None
