"""Open loop: synchronised cameras, one batch of `batch` frames due every
1 / `ticks_per_s` seconds through the window, offered on that schedule
whatever the server's backlog.

Each frame's latency runs from when its batch was due to when its depth
is a host array; `latency_p95_ms` is the 95th percentile over all frames
due in the window, each waited for after the window closes.  The lag of
each pull (when the server's uploader took the batch, less its due
time) is kept in `session.pulls`.  Traffic keys: `batch`,
`pool_batches`, `server_depth`, `ticks_per_s`.
"""

import time

from benchmark.harness import percentile


def run(session) -> dict:
    s = session
    rate = float(s.traffic["ticks_per_s"])
    s.open_window(lead=0.2)
    n = int(s.seconds * rate)
    due = [s.window_start + i / rate for i in range(n)]

    def batches():
        for i in range(n):
            with s.span("serve.pull"):
                wait = due[i] - s.clock()
                if wait > 0:
                    time.sleep(wait)
                now = s.clock()
                s.pulls.append((now, now - due[i]))
                index = s.order[i % len(s.order)]
                s.sent.append(index)
            yield s.pool[index]

    latency = []
    for j, depth in s.serve(batches()):
        latency.extend([s.results[-1] - due[j]] * depth.shape[0])
    B = s.batch_size
    p95 = (1e3 * percentile(latency, 95) if latency else None)
    return {"attempted": n * B, "failed": n * B - len(latency),
            "metrics": {"latency_p95_ms": p95}}

