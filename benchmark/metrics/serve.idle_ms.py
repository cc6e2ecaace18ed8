"""serve.idle_ms.<cells>: device idle milliseconds per served batch in
the traced stretch, counting the idle gaps that open while the host is
outside the fused call (`fused.call`'s host ranges): in the server's
waits for an upload and for a result, and in the consumer; the device
waiting between calls."""

from benchmark.program_spans import CALL, idle_ms_per_call, opens_in


def read(session):
    trace = session.trace
    if trace is None:
        return None
    calls = trace.host_ranges.get(CALL, [])
    return idle_ms_per_call(trace, lambda t: not opens_in(t, calls))
