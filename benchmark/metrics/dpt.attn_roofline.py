"""dpt.attn_roofline: the share, in percent, of its roofline that the
DPT SML's attention reaches in the traced stretch: each `dpt.attn` range's
least time (`least_s`) times the ranges, over the device time of the
kernels inside them (`benchmark.dpt_spans`).

The least time of one block's attention on a batch is the larger of
- its operations, 4 B H N^2 d (q k^T and attn v, two per multiply-add),
  at 989 TFLOP/s;
- its bytes, the bf16 q, k, v read and the output written (4 B N C * 2)
  and the float32 relative position table read once, at 3.35 TB/s;
for B frames of N = gh gw + 1 tokens, H heads of d, width C = H d."""

from benchmark.counts import least_s
from benchmark.dpt_spans import attention_per_forward

MODEL_TYPE = "dpt-beit-large"
C, H, PATCH, GRID = 1024, 16, 16, 32    # width, heads, patch, pretrained grid


def attention_least_s(model_type: str, batch: int, net_shape):
    """Least seconds of one block's attention on `batch` frames at
    `net_shape`; None for another model type."""
    if model_type != MODEL_TYPE:
        return None
    n = (net_shape[0] // PATCH) * (net_shape[1] // PATCH) + 1
    flops = 4.0 * batch * H * n * n * (C // H)
    nbytes = 2 * 4 * batch * n * C + 4 * ((2 * GRID - 1) ** 2 + 3) * H
    return least_s(nbytes, flops)


def read(session):
    forwards = attention_per_forward(session.trace)
    sml = session.config["sml"]
    least = attention_least_s(sml["model_type"], session.batch_size,
                              sml["net_shape"])
    if forwards is None or least is None:
        return None
    device_s = sum(s for s, _ in forwards)
    if device_s <= 0:
        return None
    return 100.0 * least * sum(n for _, n in forwards) / device_s
