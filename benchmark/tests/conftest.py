"""Fixtures of the benchmark's tests: a throwaway checkout of the
benchmark with a tiny cell added as new files only, and the card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = "tiny_rig"
# the tiny cell's limits: in float32 the port reads 0 and 0
# against the reference; in bfloat16 the port reads at most 1.30 and
# 1.36 on three seeds, the float8 control at least 12.6 and 17.3
TINY_LIMITS = {"float32": {"responses_err_ratio": 1e-4,
                           "depth_err_ratio": 1e-4},
               "bfloat16": {"responses_err_ratio": 3.0,
                            "depth_err_ratio": 4.0}}


def add_tiny_cell(root: Path, dtype: str = "float32") -> dict:
    """Add, as new files and new entries only, a configuration at CPU
    size (the NTU file with narrow RC-Net widths, a 48x64 frame, a 66x34
    patch and a 64x64 SML input), a closed- and an open-loop mix and one
    per-layer metric with its reader; return the cells' names."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "ntu_lite3.json").read_text())
    cfg.update(name=TINY, dtype=dtype, real_points=6)
    cfg["dataset"].update(image_shape=[48, 64], max_points=8)
    cfg["rcnet"].update(
        patch_size=[66, 34], n_filters_encoder_image=[8, 16, 16, 16, 16],
        n_neurons_encoder_depth=[8, 16, 16, 16, 16],
        n_filters_decoder=[16, 16, 8, 8, 4], attention_layers=1,
        attention_heads=2)
    cfg["sml"].update(net_shape=[64, 64])
    cfg["limits"] = TINY_LIMITS[dtype]
    (bench / "configs" / f"{TINY}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_closed.json").write_text(json.dumps(
        {"kind": "closed_loop", "batch": 2, "pool_batches": 3,
         "server_depth": 2}))
    (bench / "traffic" / "tiny_open.json").write_text(json.dumps(
        {"kind": "open_loop", "batch": 2, "pool_batches": 3,
         "server_depth": 1, "ticks_per_s": 5.0}))
    (bench / "metrics" / "tiny.calls.py").write_text(
        "def read(session):\n    return float(len(session.calls))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": TINY, "source": "https://example.org",
                            "file": f"benchmark/configs/{TINY}.json",
                            "reduced": [], "why": "tests"})
    cells = {"closed": f"{TINY}.closed", "open": f"{TINY}.open"}
    spec["workloads"] += [
        {"name": cells["closed"], "config": TINY, "traffic": "tiny_closed",
         "chips": 1, "why": "tests"},
        {"name": cells["open"], "config": TINY, "traffic": "tiny_open",
         "chips": 1, "why": "tests"}]
    for m in spec["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append(cells["closed"])
    spec["end_to_end"].append(
        {"name": "latency_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": [cells["open"]]})
    spec["per_layer"].append(
        {"name": "tiny.calls", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "entry", "moves": "setup_s",
         "workloads": [cells["closed"], cells["open"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cells


DEPTH_REFERENCE = '''"""midas-small-depth: the layers of nets.SML with the port's direct
depth regression, pred = relu(1 + out), clamped."""

import torch.nn.functional as F

from benchmark.reference import nets


class SML(nets.SML):
    def __init__(self, sml):
        super().__init__(dict(sml, model_type="midas-small",
                              regress_mode="scale"))

    def forward(self, x, d):
        out = self.output_conv.conv3(self.head_input(x)).permute(0, 2, 3, 1)
        pred = F.relu(1.0 + out)
        if self.min_pred > 0:
            pred = pred.clamp(max=1.0 / self.min_pred)
        return pred.clamp(min=1.0 / self.max_pred)
'''


def add_family_cell(root: Path) -> str:
    """Add the tiny cells, then, as new files and new entries only, a
    configuration whose SML is a second family that the port's factory
    builds (midas-small-depth) with its reference file under
    `reference/sml/`, and a closed-loop cell of it; return its name."""
    add_tiny_cell(root)
    bench = root / "benchmark"
    name = "tiny_depth"
    cfg = json.loads((bench / "configs" / f"{TINY}.json").read_text())
    cfg["name"] = name
    cfg["sml"]["model_type"] = "midas-small-depth"
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "reference" / "sml").mkdir(exist_ok=True)
    (bench / "reference" / "sml" / "midas-small-depth.py").write_text(
        DEPTH_REFERENCE)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "https://example.org",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "tests"})
    cell = f"{name}.closed"
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "tiny_closed", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{TINY}.closed" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


def copy_checkout(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's files, copied under `dest`."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def tiny(tmp_path):
    """(checkout root, cell names) with the tiny cells added."""
    root = copy_checkout(tmp_path / "checkout")
    return root, add_tiny_cell(root)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
