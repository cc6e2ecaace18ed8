"""serve.upload_ms.<cells>: the median host milliseconds of one batch's
upload on the server's uploader thread, its pinning and the enqueue of
its copy to the card (`FusedServer._upload`, the program's span
`server.upload`), over the spans within the traced stretch: the running
profiler makes them live, and the uploader thread's ranges do not reach
the profiler's trace, so they are read from the program's ring, whose
clock is the harness's `time.perf_counter`."""

import statistics

from benchmark.program_spans import program_spans


def read(session):
    trace = session.trace
    if trace is None:
        return None
    ms = program_spans("server.upload", trace.host_window)
    return statistics.median(ms) if ms else None
