"""The port's span recorder (riders_tpu_torch.core.tracing) on the CPU:
idle it is one shared no-op that never opens a profiler range; enabled
it records name, request, parent and thread into a bounded ring; under
torch.profiler its main-thread spans are the profiler's host ranges on
the same clock, user ranges where mirrored; and a served run records
each batch's `server.*` and `fused.*` spans once, without changing the
served depth."""

import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from riders_tpu_torch.core import tracing
from riders_tpu_torch.core.config import ntu_config
from riders_tpu_torch.models.layers import init_random_
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.pipelines.fused import make_fused_fn
from riders_tpu_torch.pipelines.serving import FusedServer
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS

FRAME, PATCH, K, B = (48, 64), (66, 34), 8, 2
FUSED = ("fused.call", "fused.inputs", "fused.rcnet", "fused.compose",
         "fused.stage1", "fused.sml", "fused.upsample")
SERVER = ("server.upload", "server.wait_upload", "server.download",
          "server.wait_result")


def since(t0):
    """The process recorder's spans that started at or after t0."""
    return [s for s in tracing.spans() if s.start_ns >= t0]


@pytest.fixture
def no_range(monkeypatch):
    """The profiler's ranges replaced by one that fails the test if
    entered."""
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} entered")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_HostRange", refuse)


def test_idle_span_is_the_shared_noop(no_range):
    assert not tracing.RECORDER.enabled and not tracing.profiler_running()
    before = len(tracing.spans())
    s = tracing.span("idle")
    assert s is tracing.NOOP and tracing.span("other", mirror=True) is s
    with s as entered:
        assert entered is tracing.NOOP
    assert len(tracing.spans()) == before


def test_enabled_spans_carry_request_parent_and_thread(no_range):
    rec = tracing.Recorder(capacity=4)
    assert rec.span("off") is tracing.NOOP
    rec.enable()
    rec.request(3)
    with rec.span("outer"):
        with rec.span("inner", mirror=True):
            pass

    def side():
        rec.request(9)
        with rec.span("side"):
            pass

    t = threading.Thread(target=side)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["inner", "outer", "side"]
    me = threading.get_native_id()
    assert got["inner"][:4] == ("inner", 3, "outer", me)
    assert got["outer"][:4] == ("outer", 3, None, me)
    assert got["side"].request == 9 and got["side"].parent is None
    assert got["side"].thread != me
    assert got["outer"].start_ns <= got["inner"].start_ns
    assert got["inner"].end_ns <= got["outer"].end_ns
    for i in range(6):                      # the ring keeps the newest 4
        rec.request(10 + i)
        with rec.span(f"n{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["n2", "n3", "n4", "n5"]
    rec.disable()
    assert rec.span("off") is tracing.NOOP


def test_spans_under_the_profiler_are_its_host_ranges():
    """Live with the recorder off, because a profiler runs; each span is
    a host range of its name, a user range (the kind the profiler
    mirrors on the device) only where mirrored, and its interval moved
    by `offset_ns` onto the profiler's clock lies within that range
    widened by 2 ms."""
    assert not tracing.RECORDER.enabled
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.profiler_running()
        with tracing.span("prof.outer"):
            with tracing.span("prof.inner", mirror=True):
                torch.ones(64).mul_(2)
    assert not tracing.profiler_running()
    assert tracing.span("after") is tracing.NOOP
    offset = tracing.offset_ns()
    ranges, user = {}, {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
        user[e.name()] = e.is_user_annotation()
    assert user["prof.inner"] and not user["prof.outer"]
    spans = since(t0)
    assert [s.name for s in spans] == ["prof.inner", "prof.outer"]
    for s in spans:            # the span is stamped inside its range
        (start, end), = ranges[s.name]
        assert start - 2e6 <= s.start_ns + offset, (s, start, offset)
        assert s.end_ns + offset <= end + 2e6, (s, end, offset)


@pytest.fixture(scope="module")
def fused_fn():
    cfg = ntu_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=FRAME,
                                    max_points=K),
        sml=dataclasses.replace(cfg.sml, net_shape=(64, 96), features=8),
        rcnet=dataclasses.replace(cfg.rcnet, patch_size=PATCH,
                                  **NARROW_RCNET))
    rcnet = init_random_(RCNet(cfg.rcnet, device="cpu"), 0)
    sml = init_random_(ScaleMapLearner(
        cfg.sml, "cpu", backbone_stages=TINY_STAGES,
        backbone_taps=TINY_TAPS, backbone_stem=8), 1)
    return make_fused_fn(cfg, rcnet, sml, device="cpu")


def _batches(n):
    """n compact batches (uint8 frames, uint16 priors) with 3-8 points."""
    rng = np.random.default_rng(17)
    H, W = FRAME
    out = []
    for _ in range(n):
        mask = np.zeros((B, K), np.float32)
        for b in range(B):
            mask[b, :rng.integers(3, K + 1)] = 1
        points = np.stack([rng.uniform(0, W, (B, K)),
                           rng.uniform(0, H, (B, K)),
                           rng.uniform(2, 40, (B, K))], -1)
        out.append({
            "image": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "mono_pred": rng.integers(256, 8000, (B, H, W),
                                      dtype=np.uint16),
            "radar_points": points.astype(np.float32),
            "point_mask": mask})
    return out


def test_served_run_records_each_batch_once(fused_fn):
    batches = _batches(4)
    plain = list(FusedServer(fused_fn, depth=2, device="cpu").run(
        iter(batches)))
    t0 = time.perf_counter_ns()
    tracing.enable()
    try:
        server = FusedServer(fused_fn, depth=2, device="cpu")
        traced = list(server.run(iter(batches)))
        server.uploader.join(timeout=10)
        assert not server.uploader.is_alive()
    finally:
        tracing.disable()
    spans = since(t0)
    assert len(traced) == len(plain) == 4
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)
    main = threading.get_native_id()
    per_request = {}
    for s in spans:
        per_request.setdefault(s.request, []).append(s)
    # the wait that found the end of the stream carries the next number
    assert set(per_request) == {0, 1, 2, 3, 4}
    assert [s.name for s in per_request.pop(4)] == ["server.wait_upload"]
    for seq, mine in per_request.items():
        assert Counter(s.name for s in mine) == Counter(FUSED + SERVER), seq
        for s in mine:
            assert (s.thread != main) == (s.name == "server.upload"), s
            assert s.end_ns >= s.start_ns
        by_name = {s.name: s for s in mine}
        assert by_name["fused.call"].parent is None
        for name in FUSED[1:]:
            assert by_name[name].parent == "fused.call", name
            call = by_name["fused.call"]
            assert call.start_ns <= by_name[name].start_ns
            assert by_name[name].end_ns <= call.end_ns
        stages = [by_name[n] for n in FUSED[1:]]
        assert all(a.end_ns <= b.start_ns
                   for a, b in zip(stages, stages[1:]))


def test_only_the_stages_between_the_networks_are_mirrored(fused_fn):
    """Under a profiler, a served batch's spans are host ranges of their
    names; `fused.compose` and `fused.stage1` alone are user ranges, so
    that a caller's user range around the call keeps the call's first
    and last kernels."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(FusedServer(fused_fn, depth=1, device="cpu").run(
            iter(_batches(1))))
    user = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in FUSED + SERVER:
            user.setdefault(e.name(), set()).add(e.is_user_annotation())
    assert set(user) >= set(FUSED + SERVER) - {"server.upload"}
    assert {n for n, kinds in user.items() if kinds == {True}} == {
        "fused.compose", "fused.stage1"}
    assert all(len(kinds) == 1 for kinds in user.values())
