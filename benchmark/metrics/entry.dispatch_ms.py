"""entry.dispatch_ms.<cells>: the median host milliseconds of one call of
the fused function (`pipelines.fused.make_fused_fn`) as the server makes
it, timed by the benchmark's wrapper around the function it hands to
`FusedServer`, over every call of the window that started before the
profiler did."""

import statistics


def read(session):
    calls = [e - s for s, e in session.calls if session.before_trace(s)]
    if not calls:
        return None
    return 1e3 * statistics.median(calls)
