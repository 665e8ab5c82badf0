"""Rules of the port that no parity test sees.

- No module of horovod_tpu_torch, and not chip_smoke.py, imports jax,
  flax, optax or the JAX package (an AST scan of every import).
- Entry points called without ``device`` go to the CUDA card: on a box
  without one they raise instead of running on the CPU; with
  ``device="cpu"`` they run there (``hvd.init``: a gloo world of one
  rank, shut down after).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch.device import resolve_device  # noqa: E402
from horovod_tpu_torch.graft_entry import entry  # noqa: E402
from horovod_tpu_torch.models import resnet  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.models.convert import params_from_jax  # noqa: E402
from horovod_tpu_torch.serving import kv_cache  # noqa: E402
from horovod_tpu_torch.serving.loop import ServeLoop  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}
SOURCES = sorted((ROOT / "horovod_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def _tiny():
    return tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                 n_layers=1, d_ff=32, max_seq_len=16,
                                 dtype="float32")


def _entry_points(device):
    cfg = _tiny()
    geo = kv_cache.geometry(4, 4, 16)
    gen = torch.Generator().manual_seed(0)
    cpu_params = tfm.init_params(cfg, gen, device="cpu")
    numpy_params = {"embed": np.zeros((32, 16), np.float32),
                    "layers": [{"wo": np.ones((2, 8, 16), np.float32)}]}
    kw = {} if device is None else {"device": device}
    return {
        "init_params": lambda: tfm.init_params(cfg, gen, **kw),
        "params_from_jax": lambda: params_from_jax(numpy_params, **kw),
        "make_cache": lambda: kv_cache.make_cache(cfg, geo, **kw),
        "ServeLoop": lambda: ServeLoop(cpu_params, cfg, geo=geo,
                                       max_batch=2, **kw),
        "create_train_state": lambda: resnet.create_train_state(
            gen, image_size=32, num_classes=10,
            model=resnet.ResNet((1, 1, 1, 1), num_classes=10, num_filters=8,
                                device=device or "cpu"), **kw),
        "entry": lambda: entry(**kw),
        "hvd.init": lambda: hvd.init(**kw),
    }


ENTRY_POINTS = ["init_params", "params_from_jax", "make_cache", "ServeLoop",
                "create_train_state", "entry", "hvd.init"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_cuda(name):
    call = _entry_points(None)[name]
    try:
        if torch.cuda.is_available():
            assert resolve_device() == torch.device("cuda")
            call()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_cpu_when_asked(name):
    try:
        out = _entry_points("cpu")[name]()
        if name == "hvd.init":
            assert hvd.size() == 1
            assert hvd.global_process_set.group.name() == "gloo"
            assert hvd.allreduce(torch.ones(2)).device.type == "cpu"
    finally:
        hvd.shutdown()
    if isinstance(out, ServeLoop):
        assert out.cache["k"].device.type == "cpu"
        summary, finished = out.run([])
        assert summary["requests"] == 0 and finished == []
    elif isinstance(out, torch.nn.Module):
        assert all(t.device.type == "cpu"
                   for t in list(out.parameters()) + list(out.buffers()))
    elif name == "entry":
        fn, args = out
        logits = fn(*args)
        assert logits.shape == (8, 1000) and logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
    elif name != "hvd.init":
        assert all(t.device.type == "cpu" for t in _leaves(out))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
