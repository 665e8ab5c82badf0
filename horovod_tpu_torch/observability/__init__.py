"""The slice of ``horovod_tpu/observability`` the serve loop, the
pipeline, the checkpoint and the elastic plane touch: in-process metrics
(:mod:`.metrics`, the ``SERVE_*``, ``PIPELINE_*``, ``CKPT_*`` and
``ELASTIC_*`` objects, and their Prometheus text, which the launcher's
KV store serves at ``/metrics``) and spans (:mod:`.spans`). Off unless
``HVD_METRICS=1``; no per-worker exposition server in this port yet."""

from . import metrics, spans  # noqa: F401
