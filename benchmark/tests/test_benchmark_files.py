"""BENCHMARK.json against the benchmark's contract, every file it names,
and the imports of everything the benchmark runs."""

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")
BENCH = ROOT / "benchmark"


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert ONE_LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2, w["name"]
        layers = [m for m in SPEC["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers, w["name"]
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_named_file_parses():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == {"responses_err_ratio", "depth_err_ratio"}
        assert all(v > 0 for v in cfg["limits"].values())
        port = harness.port_config(cfg)       # every field exists
        assert list(port.dataset.image_shape) == \
            cfg["dataset"]["image_shape"]
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").exists()
        harness.load_file_module(BENCH / "drivers"
                                 / f"{traffic['kind']}.py", "d")
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(ROOT, m["name"]).read)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_import_in_any_source():
    sources = sorted(BENCH.rglob("*.py"))
    assert sources
    for path in sources:
        tops = set(_imports(path))
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.relative_to(BENCH).parts:
            assert tops <= {"torch", "numpy", "benchmark", "__future__",
                            "contextlib", "typing"}, (path, tops)
            assert "riders_tpu_torch" not in tops


def test_nothing_the_harness_loads_is_forbidden():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, control, counts, frames, trace, "
        "weights\n"
        "from benchmark.reference import chain\n"
        "import riders_tpu_torch.pipelines.fused, "
        "riders_tpu_torch.pipelines.serving, riders_tpu_torch.models.rcnet,"
        " riders_tpu_torch.models.sml, riders_tpu_torch.models.factory\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "riders_tpu_torch_x", sys)
    assert "riders_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib.xla" in harness.forbidden_modules()


@pytest.mark.parametrize("where", ["checkout", "bare"])
def test_run_without_a_card_prints_no_result(tmp_path, where):
    """No card here: exit 2 and no result line; in a directory that holds
    only the benchmark's files it fails as well."""
    from benchmark.tests.conftest import copy_checkout
    root = ROOT if where == "checkout" else copy_checkout(tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
        text=True, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
