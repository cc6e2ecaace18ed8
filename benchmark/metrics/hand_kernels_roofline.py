"""hand_kernels_roofline: the share, in percent, of their roofline that
the port's three hand kernels on the fused path (`csrc/stem.cu`,
`csrc/roi_pool.cu`, `csrc/compose.cu` via `ops/kernels/`) reach in the
traced stretch: the sum over their launches of each launch's least time
(the larger of its bytes at 3.35 TB/s and its operations at 989 TFLOP/s,
`benchmark.counts.kernel_least_s`, averaged over the batches whose calls
started in the stretch) over their traced device time."""

from benchmark.counts import kernel_least_s
from benchmark.trace import category

KERNELS = ("stem", "roi_pool", "compose")


def read(session):
    trace = session.trace
    calls = session.calls_in_trace()
    if trace is None or not calls:
        return None
    launches = {k: 0 for k in KERNELS}
    device_s = 0.0
    lo, hi = trace.window
    for name, s, e in trace.device:
        cat = category(name)
        if not lo <= s < hi:
            continue
        if cat in launches:
            launches[cat] += 1
            device_s += e - s
    if device_s <= 0:
        return None
    bounds = {}
    for i in calls:
        batch = session.pool[session.sent[i]]
        for k, v in kernel_least_s(session.config, batch).items():
            bounds[k] = bounds.get(k, 0.0) + v / len(calls)
    least = sum(launches[k] * bounds[k] for k in KERNELS)
    return 100.0 * least / device_s
