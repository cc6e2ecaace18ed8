"""entry.idle_ms.<cells>: device idle milliseconds per fused call in the
traced stretch, counting the idle gaps that open while the host is
inside one of the fused call's stage spans (`fused.inputs` ...
`fused.upsample`, host ranges on the profiler's clock): the device
waiting on the call's own host work."""

from benchmark.program_spans import STAGES, idle_ms_per_call, opens_in


def read(session):
    trace = session.trace
    if trace is None:
        return None
    stages = [r for name in STAGES for r in trace.host_ranges.get(name, ())]
    return idle_ms_per_call(trace, lambda t: opens_in(t, stages))
