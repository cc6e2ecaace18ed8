"""Closed loop: the server is kept fed, a new batch offered as soon as
its uploader asks, until the window closes.

fps is every frame whose depth came back to the host inside the window,
over the window.  Traffic keys: `batch`, `pool_batches`,
`server_depth`.
"""


def run(session) -> dict:
    s = session
    B = s.batch_size

    def batches():
        i = 0
        while True:
            with s.span("serve.pull"):
                if s.clock() >= s.window_end:
                    return
                index = s.order[i % len(s.order)]
                s.sent.append(index)
            i += 1
            yield s.pool[index]

    s.open_window()
    done = 0
    for _, depth in s.serve(batches()):
        if s.results[-1] <= s.window_end:
            done += depth.shape[0]
    returned = len(s.results) * B
    return {"attempted": len(s.sent) * B,
            "failed": len(s.sent) * B - returned,
            "metrics": {"fps": done / s.seconds}}
