"""compose.device_ms.<cells>: device milliseconds per call of the kernels
launched inside the fused call's threshold, composition and raw-radar
scatter (`pipelines/fused.py:_Stages.depth`, the program's span
`fused.compose`), read from the profiler's mirror of that host range on
the device's timeline."""

from benchmark.trace import range_ms_per_call


def read(session):
    return range_ms_per_call(session.trace, "fused.compose")
