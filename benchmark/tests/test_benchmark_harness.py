"""The harness at a tiny size on the CPU: a cell added as files only runs
through it, its result line has the contract's keys, a wrong answer is
caught, and the yardstick's arithmetic holds."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from benchmark import counts, harness, trace
from benchmark.tests.conftest import ROOT, add_tiny_cell, copy_checkout

SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["closed", "open"])
@pytest.mark.parametrize("traced", [False, True])
def test_added_cell_runs_and_its_line_has_the_contract_keys(tiny, kind,
                                                            traced):
    root, cells = tiny
    r = harness.run_cell(root, cells[kind], SEED, 1.5, traced,
                         device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if traced else []) + ["checks"]
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"responses_err_ratio", "depth_err_ratio"}
    assert all(c["value"] <= 1e-5 for c in r["checks"].values())
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if not traced:
        e2e = "fps" if kind == "closed" else "latency_p95_ms"
        assert set(r["metrics"]) == {e2e, "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["metrics"]["tiny.calls"]["value"] > 0


@pytest.mark.parametrize("fault", ["depth", "responses"])
def test_a_wrong_answer_makes_the_run_incorrect(tiny, monkeypatch, fault):
    """The timed path broken underneath, the answer altered by 10% where
    it is produced: every depth map the fused function returns, or every
    response RC-Net makes (the depth then follows from them)."""
    from riders_tpu_torch.models import rcnet as rcnet_mod
    from riders_tpu_torch.pipelines import fused as fused_mod
    if fault == "depth":
        real = fused_mod.make_fused_fn

        def broken(*args, **kw):
            fn = real(*args, **kw)
            return lambda batch: fn(batch) * 1.1
        monkeypatch.setattr(fused_mod, "make_fused_fn", broken)
    else:
        real = rcnet_mod.RCNet.forward

        def broken(self, *args, **kw):
            return real(self, *args, **kw) * 0.9
        monkeypatch.setattr(rcnet_mod.RCNet, "forward", broken)
    root, cells = tiny
    r = harness.run_cell(root, cells["closed"], SEED, 1.0, False,
                         device="cpu")
    assert r["correct"] is False
    name = "depth_err_ratio" if fault == "depth" else "responses_err_ratio"
    assert r["checks"][name]["value"] > 5


def test_the_reference_agrees_with_the_port_in_f32(tmp_path):
    """The reference against `make_fused_fn`'s f32 CPU path on the same
    weights and frames, at the tiny configuration (bf16 off); the
    control, the networks stored in fp8, is far from it."""
    from benchmark.control import readings
    root = copy_checkout(tmp_path / "checkout")
    cells = add_tiny_cell(root)
    port = readings(root, cells["closed"], SEED, "port", 1.0, device="cpu")
    assert port["correct"] is True
    assert all(c["value"] <= 1e-5 for c in port["checks"].values())
    ctl = readings(root, cells["closed"], SEED, "control", 1.0,
                   device="cpu")
    assert ctl["correct"] is False
    assert all(c["value"] > 1e-3 for c in ctl["checks"].values())


def _control_fails_the_limit(root, cells, device):
    port = readings_of(root, cells, "port", device)
    ctl = readings_of(root, cells, "control", device)
    assert port["correct"] is True and ctl["correct"] is False
    for name, c in ctl["checks"].items():
        assert c["value"] > c["limit"] > port["checks"][name]["value"]


def readings_of(root, cells, program, device):
    from benchmark.control import readings
    return readings(root, cells["closed"], SEED, program, 1.0,
                    device=device)


def test_the_control_fails_the_limit_at_bf16(tmp_path):
    """At bf16, on the tiny cell, the port reads under the limits and the
    fp8 control over both: a run of it comes out not correct."""
    root = copy_checkout(tmp_path / "checkout")
    cells = add_tiny_cell(root, dtype="bfloat16")
    _control_fails_the_limit(root, cells, "cpu")


def test_percentile_is_over_all_frames():
    # 4 frames a tick share one latency; 20 ticks
    lat = [t for t in range(1, 21) for _ in range(4)]
    assert harness.percentile(lat, 95) == pytest.approx(
        np.percentile(np.array(lat, float), 95))
    assert harness.percentile(list(range(101)), 95) == 95.0


def test_busy_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert trace.busy_time(iv, (0.0, 10.0)) == pytest.approx(4.0)
    assert trace.idle_gaps(iv, (0.0, 10.0)) == [(2.0, 3.0), (4.0, 9.0)]
    t = trace.Trace([("a", s, e) for s, e in iv], {},
                    {"entry.call": [(3.9, 5.0)]}, (0.0, 10.0), (0.0, 1.0))
    assert t.gaps() == [("entry.call", 5.0), ("other", 1.0)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_byte_counts_match_chip_smoke():
    """The frozen counts against `chip_smoke.py`'s at NTU B=16: the same
    RoI and compose counts on the same inputs, and its recorded stem
    bound (0.0568 ms, bytes)."""
    cs = _chip_smoke()
    from riders_tpu_torch.pipelines.rcnet_inference import \
        shift_points_and_boxes
    B, (ph, pw), frame = 16, (150, 50), (512, 640)
    g = torch.Generator().manual_seed(3)
    batch = cs.make_batch(7, B, 48, 40, frame, "cpu")
    points, boxes = shift_points_and_boxes(batch["radar_points"], (ph, pw))
    shapes = counts.pyramid_shapes(frame, (ph, pw))
    maps = [torch.zeros((B, h, w, c), dtype=torch.bfloat16)
            for h, w, c in shapes]
    assert counts.roi_read_bytes(shapes, boxes, (ph, pw)) == \
        cs.roi_read_bytes(maps, boxes, (ph, pw))
    mask = batch["point_mask"]
    assert counts.compose_read_elems(points, mask, frame, (ph, pw)) == \
        cs.compose_read_elems(points, mask, frame, (ph, pw))
    host = {"radar_points": batch["radar_points"].numpy(),
            "point_mask": mask.numpy()}
    least = counts.kernel_least_s({"dataset": {"image_shape": frame},
                                   "rcnet": {"patch_size": (ph, pw)}}, host)
    assert least["stem"] * 1e3 == pytest.approx(0.0568, abs=5e-5)
    del g


def test_the_control_fails_the_limit_on_the_card(tmp_path, card):
    """The same on the card, at the tiny bf16 cell."""
    root = copy_checkout(tmp_path / "checkout")
    cells = add_tiny_cell(root, dtype="bfloat16")
    _control_fails_the_limit(root, cells, card.type)
