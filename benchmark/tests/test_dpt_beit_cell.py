"""The DPT BEiT-L/16-512 cell: its files found by name, the readers of
the SML's attention spans and counter on a synthetic trace and counter,
`None` where the program has neither, and a model type that still has no
reference."""

import json
from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from benchmark.reference import chain
from benchmark.tests.conftest import ROOT

CELL = "ntu_dpt_beitl512.offline_b16"
NEW = ("dpt.attn.device_ms.offline", "dpt.attn_roofline",
       "dpt.bias_tables.offline")


def read(name, session):
    return harness.metric_reader(ROOT, name).read(session)


def test_the_cell_and_its_files_are_found_by_name():
    spec, cell, config, traffic = harness.find_cell(ROOT, CELL)
    assert cell["chips"] == 1 and cell["config"] == "ntu_dpt_beitl512"
    assert traffic == {**traffic, "kind": "closed_loop", "batch": 16,
                       "pool_batches": 8, "server_depth": 2}
    assert config["sml"]["model_type"] == "dpt-beit-large"
    assert config["sml"]["net_shape"] == [512, 640] and \
        config["reduced"] == []
    cfg = harness.port_config(config)
    assert cfg.sml.net_shape == (512, 640)
    assert chain.sml_class("dpt-beit-large").HEAD == "head_conv3"
    metrics = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in ("fps", "entry.device_ms.offline", "sml.device_ms.offline",
                 "mfu.offline"):
        assert metrics[name]["workloads"][-1] == CELL
    for name in NEW:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "fps"


def test_a_model_type_without_a_reference_names_the_file():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "ntu_dpt_beitl512.json").read_text())
    cfg["sml"]["model_type"] = "dpt-swin2-large"
    with pytest.raises(ValueError,
                       match=r"reference/sml/dpt-swin2-large\.py"):
        chain.build_models(cfg, "cpu", meta=True)


def synthetic(with_spans=True):
    """Two SML forwards in a 0-20 window (seconds, the profiler's clock),
    two attention ranges each, and a third forward that ends after the
    window.  A kernel counts whole in the range it starts in."""
    device = [("k", 1.0, 2.0), ("k", 2.0, 2.5), ("k", 2.5, 3.5),
              ("k", 3.0, 4.0), ("k", 4.2, 4.4), ("k", 8.0, 9.0),
              ("k", 12.0, 12.5), ("k", 14.0, 14.25), ("k", 19.5, 19.6)]
    ranges = {"sml.forward": [(1.0, 9.0), (11.0, 15.0), (19.0, 22.0)]}
    if with_spans:
        ranges["dpt.attn"] = [(2.0, 3.0), (4.0, 5.0), (12.0, 13.0),
                              (14.0, 14.5), (19.5, 19.7)]
    return trace.Trace(device, ranges, {}, (0.0, 20.0), (100.0, 120.0))


def session(t, model_type="dpt-beit-large"):
    return SimpleNamespace(trace=t, batch_size=16, config={"sml": {
        "model_type": model_type, "net_shape": [512, 640]}})


def test_attention_device_ms_sums_the_ranges_of_each_forward():
    got = read("dpt.attn.device_ms.offline", session(synthetic()))
    assert got == pytest.approx(1e3 * ((0.5 + 1.0 + 0.2) + (0.5 + 0.25))
                                / 2)


def test_attention_roofline_counts_each_range_once():
    reader = harness.metric_reader(ROOT, "dpt.attn_roofline")
    least = reader.attention_least_s("dpt-beit-large", 16, [512, 640])
    # 4 B H N^2 d at 989 TFLOP/s: 108.7 us a block, 2.6 ms a call
    n = 32 * 40 + 1
    assert least == pytest.approx(4.0 * 16 * 16 * n * n * 64 / 989e12)
    assert 24 * least == pytest.approx(2.61e-3, rel=1e-2)
    got = read("dpt.attn_roofline", session(synthetic()))
    assert got == pytest.approx(100.0 * 4 * least / (1.7 + 0.75))
    assert read("dpt.attn_roofline",
                session(synthetic(), "dpt-swin2-large")) is None


def test_the_device_readers_without_the_programs_spans():
    for name in NEW[:2]:
        assert read(name, session(synthetic(with_spans=False))) is None
        assert read(name, session(None)) is None


def test_bias_tables_per_forward(monkeypatch):
    from riders_tpu_torch.models import dpt
    monkeypatch.setattr(dpt, "COUNTS", Counter(forwards=3, bias_tables=72))
    assert read("dpt.bias_tables.offline", session(None)) == 24.0
    monkeypatch.setattr(dpt, "COUNTS", Counter())
    assert read("dpt.bias_tables.offline", session(None)) is None
    # a program without the counter, as before it was added
    monkeypatch.delattr(dpt, "COUNTS")
    assert read("dpt.bias_tables.offline", session(None)) is None
