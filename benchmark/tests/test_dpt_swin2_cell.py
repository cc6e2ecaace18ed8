"""The DPT Swin2-L/24-384 cell: its files found by name, the readers of
the SML's window attention spans (`dpt.attn`, as BEiT's) and counter on
a synthetic trace and counter, `None` where the program has neither, and
the attention's least time at the published widths."""

from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from benchmark.reference import chain
from benchmark.tests.conftest import ROOT

CELL = "ntu_dpt_swin2l384.offline_b16"
NEW = ("swin2.attn_roofline", "swin2.cpb_tables.offline")
# accepted metrics whose readers read this cell too
SHARED = ("fps", "entry.device_ms.offline", "sml.device_ms.offline",
          "mfu.offline", "rcnet.device_ms.offline", "stage1.device_ms.offline",
          "compose.device_ms.offline", "entry.dispatch_ms.offline",
          "entry.idle_ms.offline", "serve.idle_ms.offline",
          "serve.upload_ms.offline", "hand_kernels_roofline",
          "dpt.attn.device_ms.offline")


def read(name, session):
    return harness.metric_reader(ROOT, name).read(session)


def test_the_cell_and_its_files_are_found_by_name():
    spec, cell, config, traffic = harness.find_cell(ROOT, CELL)
    assert cell["chips"] == 1 and cell["config"] == "ntu_dpt_swin2l384"
    assert traffic == {**traffic, "kind": "closed_loop", "batch": 16,
                       "pool_batches": 8, "server_depth": 2}
    assert config["sml"]["model_type"] == "dpt-swin2-large"
    assert config["sml"]["net_shape"] == [384, 384] and \
        config["reduced"] == []
    entry = {c["name"]: c for c in spec["configs"]}["ntu_dpt_swin2l384"]
    assert entry["reduced"] == [] and entry["source"] == config["source"]
    cfg = harness.port_config(config)
    assert cfg.sml.net_shape == (384, 384)
    assert chain.sml_class("dpt-swin2-large").HEAD == "head_conv3"
    metrics = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in SHARED:
        assert metrics[name]["workloads"][-1] == CELL, name
    for name in NEW:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "fps"
        assert metrics[name]["layer"] == "SML"


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


def session(t, model_type="dpt-swin2-large"):
    return SimpleNamespace(trace=t, batch_size=16, config={"sml": {
        "model_type": model_type, "net_shape": [384, 384]}})


def test_attention_device_ms_sums_the_ranges_of_each_forward():
    got = read("dpt.attn.device_ms.offline", session(synthetic()))
    assert got == pytest.approx(1e3 * ((0.5 + 1.0 + 0.2) + (0.5 + 0.25))
                                / 2)


def test_the_least_time_at_the_published_widths():
    """67.6 / 33.8 / 17.0 / 8.5 us a block by stage at B=16 (every stage
    bound by its bytes), 0.525 ms over the 24 blocks of a forward."""
    reader = harness.metric_reader(ROOT, "swin2.attn_roofline")
    least = reader.forward_least_s("dpt-swin2-large", 16, [384, 384])
    stages = [  # (blocks, tokens, width, window, heads)
        (2, 96 * 96, 192, 24, 6), (2, 48 * 48, 384, 24, 12),
        (18, 24 * 24, 768, 24, 24), (2, 12 * 12, 1536, 12, 48)]
    blocks = [(8 * 16 * L * C + 4 * (2 * w - 1) ** 2 * H) / 3.35e12
              for _, L, C, w, H in stages]
    assert [round(b * 1e6, 1) for b in blocks] == [67.6, 33.8, 17.0, 8.5]
    for (_, L, C, w, _), b in zip(stages, blocks):
        assert 4.0 * 16 * L * w * w * C / 989e12 < b
    assert least == pytest.approx(sum(n * b for (n, *_), b
                                      in zip(stages, blocks)))
    assert least == pytest.approx(0.525e-3, rel=1e-3)
    assert reader.forward_least_s("dpt-beit-large", 16, [384, 384]) is None


def test_attention_roofline_counts_each_forward_once():
    reader = harness.metric_reader(ROOT, "swin2.attn_roofline")
    least = reader.forward_least_s("dpt-swin2-large", 16, [384, 384])
    got = read("swin2.attn_roofline", session(synthetic()))
    assert got == pytest.approx(100.0 * 2 * least / (1.7 + 0.75))
    assert read("swin2.attn_roofline",
                session(synthetic(), "dpt-beit-large")) is None


def test_the_device_readers_without_the_programs_spans():
    for name in ("dpt.attn.device_ms.offline", "swin2.attn_roofline"):
        assert read(name, session(synthetic(with_spans=False))) is None
        assert read(name, session(None)) is None


def test_cpb_tables_per_forward(monkeypatch):
    from riders_tpu_torch.models import dpt, swin2
    monkeypatch.setattr(dpt, "COUNTS", Counter(forwards=3))
    monkeypatch.setattr(swin2, "COUNTS", Counter(cpb_tables=72))
    assert read("swin2.cpb_tables.offline", session(None)) == 24.0
    monkeypatch.setattr(dpt, "COUNTS", Counter())
    assert read("swin2.cpb_tables.offline", session(None)) is None
    # a program without the counter, as before it was added
    monkeypatch.setattr(dpt, "COUNTS", Counter(forwards=3))
    monkeypatch.delattr(swin2, "COUNTS")
    assert read("swin2.cpb_tables.offline", session(None)) is None
