"""Config plumbing: YAML file ↔ CLI args ↔ HVD_* env. The port's copy of
``horovod_tpu/runner/config_parser.py``, cut to the flags whose variables
the port reads. The reference's tunables of its C++ core (fusion, cycle
time, cache, wire, shm, compression, alltoall, NUMA, timeline, stall
check, autotune, log level) have no reader in the port: the launcher
refuses their flags, and a file's keys for them are not read (ROADMAP
Queue A item 16).

Reference parity: `horovod/runner/common/util/config_parser.py` — one
namespace, three layers. Env is the ground truth workers see; CLI overrides
file; file overrides nothing already set on the command line.

YAML schema (any subset):

    params:
      bucket: 1
      bucket-bytes: 33554432
      ep-capacity-factor: 1.25
      pipeline-schedule: 1f1b
      peer-timeout-ms: 2000
    metrics:
      enable: true
    serve:
      page-size: 16
      kv-pages: 256
      max-batch: 8
      mode: continuous
      prefix-cache: 1
      spec-tokens: 0
    checkpoint:
      dir: /ckpt/run1
      async: true
"""

# arg attribute name → (env var, transform-to-env)
ARG_TO_ENV = {
    "bucket": ("HVD_BUCKET", lambda v: str(int(v))),
    "bucket_bytes": ("HVD_BUCKET_BYTES", lambda v: str(int(v))),
    "ep_capacity_factor": ("HVD_EP_CAPACITY_FACTOR",
                           lambda v: str(float(v))),
    "pipeline_schedule": ("HVD_PIPE_SCHEDULE", str),
    "peer_timeout_ms": ("HVD_PEER_TIMEOUT_MS", lambda v: str(int(v))),
    # Observability (horovod_tpu_torch/observability/): the metrics
    # registry and span recorder gate on HVD_METRICS.
    "metrics": ("HVD_METRICS", lambda v: "1" if v else "0"),
    # Serving plane (horovod_tpu_torch/serving/): KV-cache geometry and
    # batcher mode for the serve loop (scheduler.serve_knobs).
    "serve_page_size": ("HVD_SERVE_PAGE_SIZE", lambda v: str(int(v))),
    "serve_kv_pages": ("HVD_SERVE_KV_PAGES", lambda v: str(int(v))),
    "serve_max_batch": ("HVD_SERVE_MAX_BATCH", lambda v: str(int(v))),
    "serve_mode": ("HVD_SERVE_MODE", str),
    "serve_prefix_cache": ("HVD_SERVE_PREFIX_CACHE",
                           lambda v: str(int(v))),
    "serve_spec_tokens": ("HVD_SERVE_SPEC_TOKENS", lambda v: str(int(v))),
    # State plane (horovod_tpu_torch/checkpoint.py): default checkpoint
    # directory and whether save() commits on the background writer
    # thread.
    "ckpt_dir": ("HVD_CKPT_DIR", str),
    "ckpt_async": ("HVD_CKPT_ASYNC", lambda v: "1" if v else "0"),
}

_FILE_SECTIONS = {
    "params": {"bucket": "bucket",
               "bucket-bytes": "bucket_bytes",
               "ep-capacity-factor": "ep_capacity_factor",
               "pipeline-schedule": "pipeline_schedule",
               "peer-timeout-ms": "peer_timeout_ms"},
    "metrics": {"enable": "metrics"},
    "serve": {"page-size": "serve_page_size",
              "kv-pages": "serve_kv_pages",
              "max-batch": "serve_max_batch",
              "mode": "serve_mode",
              # read so that the launcher can refuse it (ROADMAP item 1)
              "autoscale": "serve_autoscale",
              "prefix-cache": "serve_prefix_cache",
              "spec-tokens": "serve_spec_tokens"},
    "checkpoint": {"dir": "ckpt_dir",
                   "async": "ckpt_async"},
}


def apply_config_file(args, path):
    """Fill unset attributes on `args` from a YAML config file."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    for section, mapping in _FILE_SECTIONS.items():
        for key, attr in mapping.items():
            if section in data and key in data[section]:
                # `is None` (not falsy): an explicit CLI 0 must beat the file
                if getattr(args, attr, None) is None:
                    setattr(args, attr, data[section][key])
    return args


def args_to_env(args):
    """Collect the HVD_* env this argparse namespace implies."""
    env = {}
    for attr, (var, conv) in ARG_TO_ENV.items():
        v = getattr(args, attr, None)
        if v is not None and v is not False:
            env[var] = conv(v)
    return env
