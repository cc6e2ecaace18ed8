"""The readers of the program's own spans on a synthetic trace and span
ring: the stage device times, the device's idle split by the fused
call's stage ranges, the uploads' host time within the traced stretch,
and `None` wherever the program recorded nothing to read."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from benchmark.tests.conftest import ROOT
from riders_tpu_torch.core.tracing import Span

CELLS = ("ntu_lite3.offline_b64", "zju_lite3.offline_b64")
NEW = ("compose.device_ms.offline", "stage1.device_ms.offline",
       "entry.idle_ms.offline", "serve.idle_ms.offline",
       "serve.upload_ms.offline")


def read(name, session):
    return harness.metric_reader(ROOT, name).read(session)


def synthetic(with_spans=True):
    """Two calls in a 0-20 window (seconds, the profiler's clock).  Each
    call's host stages run back to back; the device idles 0-1 (before
    the first call: serving), 2.5-3 (inside `fused.rcnet`), 5-5.5
    (inside the call, between stages: neither), 9-11 (serving) and
    13-13.25 (inside `fused.compose`)."""
    device = [("k", 1.0, 2.5), ("k", 3.0, 5.0), ("k", 5.5, 6.0),
              ("k", 6.0, 9.0), ("copy", 4.0, 4.5), ("k", 11.0, 13.0),
              ("k", 13.25, 14.0), ("k", 14.0, 20.0)]
    host = {}
    if with_spans:
        host = {"fused.call": [(1.0, 7.0), (11.0, 17.0), (21.0, 22.0)],
                "fused.inputs": [(1.0, 2.0), (11.0, 12.0)],
                "fused.rcnet": [(2.0, 5.0), (12.0, 13.0)],
                "fused.compose": [(5.25, 6.0), (13.0, 14.0)],
                "fused.stage1": [(6.0, 6.5), (14.0, 15.0)],
                "fused.sml": [(6.5, 6.75), (15.0, 16.0)],
                "fused.upsample": [(6.75, 7.0), (16.0, 17.0)]}
    device_ranges = {"fused.compose": [(5.5, 6.0), (13.25, 14.0)],
                     "fused.stage1": [(6.0, 9.0), (14.0, 15.0)]} \
        if with_spans else {}
    return trace.Trace(device, device_ranges, host, (0.0, 20.0),
                       (100.0, 120.0))


def test_new_entries_read_the_offline_cells():
    spec = {m["name"]: m for m in harness.load_json(
        ROOT / "BENCHMARK.json")["per_layer"]}
    for name in NEW:
        m = spec[name]
        assert m["workloads"] == list(CELLS) and m["moves"] == "fps"
        assert m["better"] == "lower" and m["unit"] == "ms"


def test_stage_device_times():
    s = SimpleNamespace(trace=synthetic())
    assert read("compose.device_ms.offline", s) == pytest.approx(
        1e3 * (0.5 + 0.75) / 2)
    # a kernel counts whole in the range it starts in: 14-20 in 14-15
    assert read("stage1.device_ms.offline", s) == pytest.approx(
        1e3 * (3.0 + 6.0) / 2)


def test_idle_split_by_the_stage_ranges():
    t = synthetic()
    s = SimpleNamespace(trace=t)
    idle = t.window_s - t.busy_s()
    assert idle == pytest.approx(1.0 + 0.5 + 0.5 + 2.0 + 0.25)
    # two calls start in the window (the third at 21 does not)
    entry = read("entry.idle_ms.offline", s)
    serve = read("serve.idle_ms.offline", s)
    assert entry == pytest.approx(1e3 * (0.5 + 0.25) / 2)
    assert serve == pytest.approx(1e3 * (1.0 + 2.0) / 2)
    # the gap opening between two stages of a call is in neither
    assert (entry + serve) * 2 / 1e3 == pytest.approx(idle - 0.5)


def test_idle_readers_without_the_programs_ranges():
    bare = SimpleNamespace(trace=synthetic(with_spans=False))
    for name in NEW[:4]:
        assert read(name, bare) is None, name
        assert read(name, SimpleNamespace(trace=None)) is None, name


def _span(name, start_s, end_s):
    return Span(name, 0, None, 1, int(start_s * 1e9), int(end_s * 1e9))


RING = [("server.upload", 99.5, 100.5),          # straddles the start
        ("server.upload", 101.0, 101.002),
        ("server.upload", 102.0, 102.004),
        ("server.upload", 103.0, 103.010),
        ("server.wait_upload", 104.0, 105.0),
        ("server.upload", 119.99, 120.5)]         # straddles the end
RING = [_span(*s) for s in RING]


def test_upload_ms_reads_the_ring_within_the_host_window(monkeypatch):
    from riders_tpu_torch.core import tracing
    monkeypatch.setattr(tracing, "spans", lambda: list(RING))
    s = SimpleNamespace(trace=synthetic())
    assert read("serve.upload_ms.offline", s) == pytest.approx(4.0)
    monkeypatch.setattr(tracing, "spans", lambda: RING[4:5])
    assert read("serve.upload_ms.offline", s) is None
    assert read("serve.upload_ms.offline",
                SimpleNamespace(trace=None)) is None


def test_upload_ms_without_the_recorder(monkeypatch):
    """A program older than the recorder: the import fails, no value."""
    import riders_tpu_torch.core
    from riders_tpu_torch.core import tracing
    monkeypatch.setattr(tracing, "spans", lambda: list(RING))
    monkeypatch.delattr(riders_tpu_torch.core, "tracing")
    monkeypatch.setitem(sys.modules, "riders_tpu_torch.core.tracing", None)
    assert read("serve.upload_ms.offline",
                SimpleNamespace(trace=synthetic())) is None
