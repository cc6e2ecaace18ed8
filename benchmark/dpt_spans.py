"""The DPT SML's attention spans in a traced run.

The port opens the mirrored span `dpt.attn` (`riders_tpu_torch.models.
dpt.BEiTAttention`) around each BEiT block's attention from after its
qkv projection up to its output projection: q k^T, the relative
position bias, the float32 logit chain, the softmax and attn v.  The
SML's first and last kernels lie outside them, so the device range that
the benchmark's `sml.forward` hooks mirror still spans the whole
forward.  A program without the span leaves every reader of it with
`None`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

ATTN = "dpt.attn"
FORWARD = "sml.forward"


def attention_per_forward(trace) -> Optional[List[Tuple[float, int]]]:
    """(device seconds, ranges) of each SML forward whose device range
    lies in the traced window: the kernels that start inside the
    `dpt.attn` device ranges within it, and how many ranges it holds;
    None where no forward holds one."""
    if trace is None:
        return None
    lo, hi = trace.window
    attn = trace.device_ranges.get(ATTN, ())
    out = []
    for fs, fe in trace.device_ranges.get(FORWARD, ()):
        if not (lo <= fs and fe <= hi):
            continue
        inside = [(s, e) for s, e in attn if fs <= s and e <= fe]
        if not inside:
            continue
        busy = sum(ke - ks for _, ks, ke in trace.device
                   if any(s <= ks < e for s, e in inside))
        out.append((busy, len(inside)))
    return out or None
