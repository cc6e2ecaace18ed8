"""Device time by operation of the benchmark's fused call, the
counterpart of the JAX package's `tools/profile_bench.py` (with
`tools/parse_hlo_stats.py`'s tables).

Builds `riders_tpu_torch.bench`'s inputs and runs 8 chained calls under
`torch.profiler`: replays of the call captured as a CUDA graph
(`bench.Chain(graph=True)`), or with --eager the calls dispatched one
by one.  Prints the top device operations by self CUDA time, a rollup by
category (convolution, GEMM, BatchNorm, elementwise, reduction,
indexing, copies and pads, resizes, the port's five CUDA kernels by
name, other),
the device's busy share of the profiled window (the union of its
kernels, copies and fills over the window from the first call's start
to the last call's end), and one JSON line; the Chrome trace goes to
`<out_dir>/trace_<preset>_<graph|eager>.json.gz`.

Usage: python -m riders_tpu_torch.tools.profile_bench [out_dir] [--zju]
           [--eager]
"""

from __future__ import annotations

import gzip
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CALLS = 8
TOP = 40                                 # rows of the op table
WINDOW = "riders_bench_window"
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "riders_trace"

# (category, pattern) in order: the first match names a kernel.  The
# port's kernels come first, by their __global__ names in csrc/.
_WORD = r"(?<![A-Za-z0-9_]){}(?![A-Za-z0-9_])"
CATEGORIES: List[Tuple[str, "re.Pattern"]] = [
    (cat, re.compile(pat)) for cat, pat in [
        ("stem (csrc/stem.cu)", _WORD.format("stem_conv_pool_kernel")),
        ("stem_general (csrc/stem_general.cu)",
         _WORD.format("stem_general_kernel")),
        ("roi_pool (csrc/roi_pool.cu)",
         _WORD.format("roi_pool_pyramid_kernel") + "|"
         + _WORD.format("roi_max_pool_bwd_kernel")),
        ("compose (csrc/compose.cu)", _WORD.format("compose_kernel")),
        ("lane_decoder (csrc/lane_decoder.cu)",
         _WORD.format("(up)?conv(_res)?_kernel")),
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


def category(name: str) -> str:
    """The category of a device operation's name (`CATEGORIES`' first
    match, else 'other')."""
    for cat, pattern in CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


def rollup(ops: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Self device time summed by category, largest first: ops are
    (name, self time) pairs."""
    totals: Dict[str, float] = {}
    for name, t in ops:
        cat = category(name)
        totals[cat] = totals.get(cat, 0.0) + t
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


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


def _device_events(prof):
    """(name, start us, end us) of every device event of the trace (the
    kernels, copies and fills; not the annotations the profiler mirrors
    onto the device's timeline)."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != WINDOW
            and not getattr(e, "is_user_annotation", False)]


def profile(preset: str = "ntu", eager: bool = False, out_dir=None
            ) -> Dict:
    """Profile CALLS chained calls of the benchmark's fused call; print
    the tables and return the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from riders_tpu_torch import bench

    fused, batch, _ = bench.build(preset)
    out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    chain = bench.Chain(fused, batch, graph=not eager)
    chain.run(2)                                # warm up
    mode = "eager" if eager else "graph"
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            chain.run(CALLS)
            torch.cuda.synchronize()
    trace = out_dir / f"trace_{preset}_{mode}.json.gz"
    raw = trace.with_suffix("")
    prof.export_chrome_trace(str(raw))
    trace.write_bytes(gzip.compress(raw.read_bytes()))
    raw.unlink()

    device = _device_events(prof)
    self_us: Dict[str, float] = {}
    for name, start, end in device:          # device events do not nest
        self_us[name] = self_us.get(name, 0.0) + end - start
    ops = sorted(self_us.items(), key=lambda o: -o[1])
    total = sum(self_us.values())
    print(f"total self device time: {total:.0f} us over {CALLS} calls "
          f"({preset}, {mode})")
    print(f"{'self us':>12}  {'%':>5}  {'category':<36} name")
    for name, t in ops[:TOP]:
        print(f"{t:12.0f}  {100 * t / max(total, 1e-9):5.1f}  "
              f"{category(name):<36} {name[:110]}")
    by_cat = rollup(ops)
    print("\nby category:")
    for cat, t in by_cat.items():
        print(f"{t:12.0f}  {100 * t / max(total, 1e-9):5.1f}  {cat}")

    windows = [(e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.name == WINDOW and e.device_type == DeviceType.CPU]
    window = (windows[0][0], max([windows[0][1]]
                                 + [end for _, _, end in device]))
    busy = busy_time([(s, e) for _, s, e in device], window)
    span = window[1] - window[0]
    summary = dict(
        preset=preset, mode=mode, calls=CALLS, batch=batch["image"].shape[0],
        window_ms=span / 1e3, busy_ms=busy / 1e3,
        busy_share=busy / span if span > 0 else 0.0,
        ms_per_call=span / 1e3 / CALLS,
        device_ms_per_call=total / 1e3 / CALLS,
        device_events=len(device),
        by_category_ms={k: v / 1e3 for k, v in by_cat.items()},
        top=[dict(name=n, self_ms=t / 1e3, category=category(n))
             for n, t in ops[:10]],
        trace=str(trace))
    print(f"\ndevice busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
          f"window ({100 * summary['busy_share']:.1f}%)")
    print(json.dumps({"profile": summary}), flush=True)
    return summary


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    paths = [a for a in args if not a.startswith("--")]
    profile("zju" if "--zju" in args else "ntu", "--eager" in args,
            paths[0] if paths else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
