"""mfu.<cells>: the whole call's share, in percent, of the card's dense
bf16 peak (989 TFLOP/s): the model's operations per frame, counted once
by torch's FlopCounterMode over the benchmark's reference chain on one
frame, times the frames whose depth came back over the part of the
window before the profiler started, over that part (host clock), so that
the profiler's cost on the host does not lower it."""

from benchmark.counts import BF16_FLOP_PER_S, model_flops_per_frame
from benchmark.frames import take


def read(session):
    tracer = session.tracer
    if tracer is None or tracer.requested is None:
        return None
    lo, hi = session.window_start, tracer.requested
    done = sum(1 for t in session.results if lo <= t < hi)
    if done == 0 or hi <= lo:
        return None
    if session.flops_per_frame is None:
        session.flops_per_frame = model_flops_per_frame(
            session.reference, take(session.pool, [(0, 0)]))
    fps = done * session.batch_size / (hi - lo)
    return 100.0 * session.flops_per_frame * fps / BF16_FLOP_PER_S
