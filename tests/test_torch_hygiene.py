"""Rules of the port that no parity test sees.

- No module of horovod_tpu_torch, and not chip_smoke.py, imports jax,
  flax, optax or the JAX package (an AST scan of every import).
- Entry points called without ``device`` go to the CUDA card: on a box
  without one they raise instead of running on the CPU; with
  ``device="cpu"`` they run there (``hvd.init``: a gloo world of one
  rank, shut down after). Under a mesh (``make_cache(mesh=)``,
  ``ServeLoop(mesh=)``) the device is the mesh's: a one-rank
  ``{"model": 1}`` mesh over ``hvd.init()``'s world, which goes to the
  card in the same way. The elastic plane: a ``TorchState``'s sync over
  that world, and an elastic reset (``teardown``, then a new world on
  the device ``init`` was given); an elastic worker (``HVD_ELASTIC=1``)
  without a card raises before it meets the driver.
- One entry point runs only on the CPU, by design: ``dryrun_multichip(n)``
  simulates n ranks as threads over gloo, as the reference's dry run
  forces the CPU, and measures nothing. It never touches CUDA, on a box
  with a card or without.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import horovod_tpu_torch.hvd as hvd  # noqa: E402
from horovod_tpu_torch import distributed  # noqa: E402
from horovod_tpu_torch.device import resolve_device  # noqa: E402
from horovod_tpu_torch.graft_entry import (  # noqa: E402
    dryrun_multichip, entry)
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

    def mesh():
        hvd.init(**kw)
        return hvd.global_mesh({"model": 1})

    return {
        "init_params": lambda: tfm.init_params(cfg, gen, **kw),
        "params_from_jax": lambda: params_from_jax(numpy_params, **kw),
        "make_cache": lambda: kv_cache.make_cache(cfg, geo, **kw),
        "ServeLoop": lambda: ServeLoop(cpu_params, cfg, geo=geo,
                                       max_batch=2, **kw),
        "make_cache(mesh=)": lambda: kv_cache.make_cache(cfg, geo,
                                                         mesh=mesh()),
        "ServeLoop(mesh=)": lambda: ServeLoop(cpu_params, cfg, geo=geo,
                                              max_batch=2, mesh=mesh()),
        "create_train_state": lambda: resnet.create_train_state(
            gen, image_size=32, num_classes=10,
            model=resnet.ResNet((1, 1, 1, 1), num_classes=10, num_filters=8,
                                device=device or "cpu"), **kw),
        "entry": lambda: entry(**kw),
        "hvd.init": lambda: hvd.init(**kw),
        "TorchState.sync": lambda: _torch_state_sync(kw),
        "elastic reset": lambda: _elastic_reset(kw),
    }


def _torch_state_sync(kw):
    hvd.init(**kw)
    state = hvd.elastic.TorchState(
        w=torch.ones(2, device=distributed.world().device))
    state.sync()
    return {"w": state.w}


def _elastic_reset(kw):
    hvd.init(**kw)
    distributed.teardown()
    distributed.init_world()
    return {"ones": hvd.allreduce(torch.ones(2))}


ENTRY_POINTS = ["init_params", "params_from_jax", "make_cache", "ServeLoop",
                "make_cache(mesh=)", "ServeLoop(mesh=)",
                "create_train_state", "entry", "hvd.init",
                "TorchState.sync", "elastic reset"]


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


def test_elastic_worker_without_a_card_raises_before_rendezvous(
        monkeypatch):
    """``hvd.init()`` in an elastic worker goes to the card: without one
    it raises at once, before it waits for the driver's epoch (the
    rendezvous address here leads nowhere)."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    monkeypatch.setenv("HVD_ELASTIC", "1")
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("HVD_WORKER_ID", "localhost-0-hygiene")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


def test_dryrun_multichip_never_touches_cuda(monkeypatch, capsys):
    """The one CPU-only entry point: any CUDA initialisation in it (a
    tensor or generator on the card, a device query that starts CUDA)
    raises, and CUDA is no more initialised after it than before."""
    def no_cuda(*a, **k):
        raise AssertionError("dryrun_multichip touched CUDA")

    was = torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    dryrun_multichip(2)
    assert torch.cuda.is_initialized() == was
    assert capsys.readouterr().out.startswith("dryrun_multichip(2): ")
