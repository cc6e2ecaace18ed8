"""The traced part of a `--trace 1` run: torch.profiler over a short
sub-window of the measured window, read back as device intervals, device
ranges of the benchmark's annotations, and host ranges.

`CATEGORIES`, `category` and `busy_time` are frozen copies of the port's
`tools/profile_bench.py`, so that the yardstick does not move with the
program.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

_WORD = r"(?<![A-Za-z0-9_]){}(?![A-Za-z0-9_])"
# (category, pattern) in order: the first match names a device operation;
# the port's kernels first, by their __global__ names
CATEGORIES: List[Tuple[str, "re.Pattern"]] = [
    (cat, re.compile(pat)) for cat, pat in [
        ("stem", _WORD.format("stem_conv_pool_kernel")),
        ("stem_general", _WORD.format("stem_general_kernel")),
        ("roi_pool", _WORD.format("roi_pool_pyramid_kernel") + "|"
         + _WORD.format("roi_max_pool_bwd_kernel")),
        ("compose", _WORD.format("compose_kernel")),
        ("lane_decoder", _WORD.format("(up)?conv(_res)?_kernel")),
        ("BatchNorm", r"(?i)batch_?norm|bn_fw|bn_bw|bn_inf"),
        ("copies", r"(?i)copy|memcpy|memset|nchwtonhwc|nhwctonchw|"
                   r"transpose|cat_?array|_pad_"),
        ("resizes", r"(?i)upsample|interpolat|resize"),
        ("convolution", r"(?i)conv(?!ert)|fprop|dgrad|wgrad|winograd|"
                        r"implicit_gemm|implicit_convolve"),
        ("GEMM", r"(?i)gemm|gemv|cutlass|matmul|xmma|cublas|nvjet"),
        ("indexing", r"(?i)index|gather|scatter"),
        ("reduction", r"(?i)reduce|sum_kernel|norm_kernel|softmax|sort|"
                      r"radix|scan"),
        ("elementwise", r"(?i)elementwise|vectorized|unrolled|where|"
                        r"pointwise|fill"),
    ]]
WINDOW = "bench.trace_window"
# host ranges that name an idle gap of the device, innermost first
GAP_NAMES = ("entry.call", "serve.pull", "serve.result_wait")


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


def busy_time(intervals: Iterable[Tuple[float, float]],
              window: Tuple[float, float]) -> float:
    """Length of the union of the (start, end) intervals, clipped to the
    window."""
    lo, hi = window
    busy, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            busy += end - start
            reach = end
    return busy


def idle_gaps(intervals: Iterable[Tuple[float, float]],
              window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The (start, end) stretches of the window that no interval covers."""
    lo, hi = window
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and reach < hi:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


class Trace:
    """Device events (name, start s, end s), device ranges and host
    ranges by name, and the traced window, all on the profiler's clock;
    `host_window` is the same window on `time.perf_counter`."""

    def __init__(self, device, device_ranges, host_ranges, window,
                 host_window):
        self.device: List[Tuple[str, float, float]] = device
        self.device_ranges: Dict[str, List[Tuple[float, float]]] = \
            device_ranges
        self.host_ranges: Dict[str, List[Tuple[float, float]]] = host_ranges
        self.window: Tuple[float, float] = window
        self.host_window: Tuple[float, float] = host_window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> List[Tuple[str, float, float]]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        return busy_time([(s, e) for _, s, e in self.device], self.window)

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.in_window():
            out[category(name)] = out.get(category(name), 0.0) + (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def gaps(self) -> List[Tuple[str, float]]:
        """Each idle gap of the window, longest first, named by the
        innermost of the `GAP_NAMES` host ranges open at its start."""
        out = []
        for lo, hi in idle_gaps([(s, e) for _, s, e in self.device],
                                self.window):
            name = "other"
            for cand in GAP_NAMES:
                if any(s <= lo < e for s, e in self.host_ranges.get(cand,
                                                                    ())):
                    name = cand
                    break
            out.append((name, hi - lo))
        return sorted(out, key=lambda g: -g[1])


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def prime_profiler(work) -> None:
    """Run `work()` once under the profiler and drop what it recorded:
    the first start of the device tracing in a process loads and sets it
    up, which stalls the host for seconds."""
    with _profile():
        work()


class Tracer:
    """Profiles `length` seconds from the first `tick()` at or after
    `start` (time.perf_counter) plus `settle`: the profiler is started at
    that first tick and runs `settle` seconds before the traced stretch
    opens, so that its start does not fall into the stretch."""

    def __init__(self, start: float, length: float, settle: float = 0.0):
        self.start, self.length, self.settle = start, length, settle
        self.prof = None
        self.marker = None
        self.requested: Optional[float] = None
        self.host_window: Optional[Tuple[float, float]] = None
        self.wall_start = 0.0
        self.trace: Optional[Trace] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self.requested is None:
            if now >= self.start:
                self.requested = now
                self.prof = _profile()
                self.prof.start()
        elif (self.host_window is None and self.prof is not None
              and now >= self.requested + self.settle):
            from torch.profiler import record_function
            self.marker = record_function(WINDOW)
            self.marker.__enter__()
            self.host_window = (time.perf_counter(), None)
            self.wall_start = time.time()
        elif (self.marker is not None
              and now >= self.host_window[0] + self.length):
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        import torch
        if self.marker is None:         # the window closed while settling
            self.prof.stop()
            self.prof = None
            return
        self.host_window = (self.host_window[0], time.perf_counter())
        wall = (self.wall_start, time.time())
        self.marker.__exit__(None, None, None)
        self.marker = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.trace = read(self.prof, self.host_window, wall)
        self.prof = None


def read(prof, host_window, wall) -> Trace:
    """The profiler's raw events as a `Trace`.  The traced window starts
    where the profiler stamped the window's host range and lasts as long
    as `wall`, the time.time() readings at its ends (the range's own end
    can be stamped early)."""
    from torch.autograd import DeviceType
    device, dev_ranges, host_ranges = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        span = (start, start + e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                dev_ranges.setdefault(e.name(), []).append(span)
            else:
                device.append((e.name(), *span))
        else:
            host_ranges.setdefault(e.name(), []).append(span)
    marks = host_ranges.get(WINDOW)
    start = marks[0][0] if marks else wall[0]
    return Trace(device, dev_ranges, host_ranges,
                 (start, start + wall[1] - wall[0]), host_window)


def range_ms_per_call(trace: Optional[Trace], name: str) -> Optional[float]:
    """Device milliseconds per call of the kernels that start inside the
    device ranges `name` (the profiler's mirror of a host range onto the
    device's timeline) within the traced window; None where it mirrored
    none."""
    if trace is None:
        return None
    lo, hi = trace.window
    per_call = [sum(e - s for _, s, e in trace.device if rs <= s < re_)
                for rs, re_ in trace.device_ranges.get(name, ())
                if lo <= rs and re_ <= hi]
    if not per_call or sum(per_call) <= 0:
        return None
    return 1e3 * sum(per_call) / len(per_call)
