"""The program's own spans in a traced run.

The port records its served path as spans (`riders_tpu_torch.core.
tracing`): while the profiler runs, each span on the thread that started
it is a host range of the trace, on the profiler's clock (`fused.call`
and its stages, `server.wait_upload`, `server.download`,
`server.wait_result`), and every span, of any thread, is in the
program's ring on `time.perf_counter`.  A program without them, such as
one older than the recorder, leaves every reader here with `None`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from benchmark.trace import idle_gaps

CALL = "fused.call"
STAGES = ("fused.inputs", "fused.rcnet", "fused.compose", "fused.stage1",
          "fused.sml", "fused.upsample")


def opens_in(t: float, ranges: List[Tuple[float, float]]) -> bool:
    return any(s <= t < e for s, e in ranges)


def idle_ms_per_call(trace, counted: Callable[[float], bool]
                     ) -> Optional[float]:
    """Device idle milliseconds per fused call in the traced window: the
    gaps whose start `counted` accepts (profiler clock), over the
    `fused.call` host ranges that start in the window; None where none
    does."""
    if trace is None:
        return None
    lo, hi = trace.window
    calls = [s for s, _ in trace.host_ranges.get(CALL, ()) if lo <= s < hi]
    if not calls:
        return None
    gaps = idle_gaps([(s, e) for _, s, e in trace.device], trace.window)
    return 1e3 * sum(e - s for s, e in gaps if counted(s)) / len(calls)


def program_spans(name: str, host_window) -> Optional[List[float]]:
    """Host milliseconds of the program's spans `name` that lie within
    `host_window` (time.perf_counter); None where the program has no
    recorder."""
    try:
        from riders_tpu_torch.core import tracing
    except ImportError:
        return None
    lo, hi = host_window
    return [1e-6 * (s.end_ns - s.start_ns) for s in tracing.spans()
            if s.name == name and lo <= 1e-9 * s.start_ns
            and 1e-9 * s.end_ns <= hi]
