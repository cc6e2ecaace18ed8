"""Import rules of the port: no JAX, flax or riders_tpu anywhere in
riders_tpu_torch/ or chip_smoke.py; the package imports on a host with
no CUDA, no nvcc and no triton; and without a card its entry points
raise instead of running on the CPU."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "riders_tpu")


def _port_sources():
    return sorted((REPO / "riders_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_reference_package():
    sources = _port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    bad = [(str(p.relative_to(REPO)), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_package_imports_without_cuda_nvcc_or_triton(tmp_path):
    """Every module (the CLI, the densifiers, the native loader, PFM,
    preprocessing and the normalization tables among them) imports in a
    fresh interpreter whose PATH has no nvcc, g++ or triton and whose
    CUDA is hidden; nothing is built or loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import riders_tpu_torch\n"
        "for m in pkgutil.walk_packages(riders_tpu_torch.__path__,\n"
        "                               'riders_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from riders_tpu_torch.ops.kernels import build\n"
        "assert not build._LIBS, build._LIBS\n"
        "from riders_tpu_torch.io import native\n"
        "assert native._lib is None\n"
        "need = ['cli', 'ops.interp', 'io.native', 'io.pfm',\n"
        "        'io.preprocess.project', 'io.preprocess.projection',\n"
        "        'core.normalization', 'pipelines.drivers', 'models.dpt',\n"
        "        'models.factory', 'models.convert']\n"
        "assert all('riders_tpu_torch.' + m in sys.modules for m in need)\n"
        "bad = [m for m in ('jax', 'flax', 'triton', 'riders_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('imported', len([m for m in sys.modules\n"
        "      if m.startswith('riders_tpu_torch')]))\n")
    env = {"PATH": str(tmp_path), "HOME": str(tmp_path),
           "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_refuse_the_cpu_without_a_request(monkeypatch):
    """With no card, the default device is an error, never the CPU."""
    from riders_tpu_torch.core.config import RCNetConfig, zju_config
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = zju_config()
    small = RCNetConfig(n_filters_encoder_image=(8, 8, 8, 8, 8),
                        n_neurons_encoder_depth=(8, 8, 8, 8, 8),
                        n_filters_decoder=(8, 8, 8, 8, 4),
                        attention_layers=1, attention_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        RCNet(small)
    with pytest.raises(RuntimeError, match="CUDA"):
        RCNet(small, device="cuda")
    rcnet = RCNet(small, device="cpu")
    sml = ScaleMapLearner(cfg.sml, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fused_fn(cfg, rcnet, sml)
    assert callable(make_fused_fn(cfg.replace(rcnet=small), rcnet, sml,
                                  device="cpu"))


def _entry_points(tmp_path):
    """The staged, serving and driver entry points, each called with no
    device (so on the card by default)."""
    from riders_tpu_torch.core.config import zju_config
    from riders_tpu_torch.io.input_pipeline import BatchLoader
    from riders_tpu_torch.models.factory import build_sml_model
    from riders_tpu_torch.pipelines import drivers
    from riders_tpu_torch.pipelines.rcnet_inference import \
        make_rcnet_infer_fn
    from riders_tpu_torch.pipelines.serving import FusedServer
    from riders_tpu_torch.pipelines.sml_inference import make_infer_fn

    cfg = zju_config(root=str(tmp_path))
    model = torch.nn.Linear(1, 1)
    return {
        "make_rcnet_infer_fn": lambda: make_rcnet_infer_fn(cfg, model),
        "make_infer_fn": lambda: make_infer_fn(cfg, model),
        "FusedServer": lambda: FusedServer(lambda b: b),
        "BatchLoader": lambda: BatchLoader([], 1),
        "run_rcnet": lambda: drivers.run_rcnet(cfg, str(tmp_path),
                                               str(tmp_path)),
        "validate_rcnet": lambda: drivers.validate_rcnet(cfg,
                                                         str(tmp_path)),
        "validate_sml": lambda: drivers.validate_sml(cfg, str(tmp_path)),
        "evaluate_results_dir": lambda: drivers.evaluate_results_dir(
            cfg, str(tmp_path)),
        "train_sml": lambda: drivers.train_sml(cfg, str(tmp_path)),
        "train_rcnet": lambda: drivers.train_rcnet(cfg, str(tmp_path)),
        "build_sml_model": lambda: build_sml_model(cfg.replace(
            sml=dataclasses.replace(cfg.sml, model_type="dpt-beit-large"))),
    }


@pytest.mark.parametrize("name", [
    "make_rcnet_infer_fn", "make_infer_fn", "FusedServer", "BatchLoader",
    "run_rcnet", "validate_rcnet", "validate_sml", "evaluate_results_dir",
    "train_sml", "train_rcnet", "build_sml_model"])
def test_staged_and_driver_entry_points_refuse_the_cpu(monkeypatch,
                                                       tmp_path, name):
    """Without a card, each new entry point raises before it reads a
    file or a model; with device='cpu' the staged ones build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points(tmp_path)[name]()
