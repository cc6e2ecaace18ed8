"""entry.device_ms.<cells>: device milliseconds per call of the kernels
launched inside one call of the fused function
(`pipelines.fused.make_fused_fn`), read from the profiler's mirror of the
benchmark's `entry.call` range on the device's timeline.  Kernel
durations do not change with how fast the host launches them, so the
profiler's own cost on the host does not move this reading."""

from benchmark.trace import range_ms_per_call


def read(session):
    return range_ms_per_call(session.trace, "entry.call")
