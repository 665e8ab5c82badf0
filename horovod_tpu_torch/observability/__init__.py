"""The slice of ``horovod_tpu/observability`` the serve loop, the
pipeline and the checkpoint touch: in-process metrics (:mod:`.metrics`,
the ``SERVE_*``, ``PIPELINE_*`` and ``CKPT_*`` objects) and spans (:mod:`.spans`). Off unless
``HVD_METRICS=1``; no exposition server in this port yet."""

from . import metrics, spans  # noqa: F401
