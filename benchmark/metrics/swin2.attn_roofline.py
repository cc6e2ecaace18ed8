"""swin2.attn_roofline: the share, in percent, of its roofline that the
Swin V2 SML's window attention reaches in the traced stretch: the least
time of one forward's blocks (`forward_least_s`) times the forwards,
over the device time of the kernels inside their `dpt.attn` ranges
(`benchmark.dpt_spans`).

The least time of one block's attention on a batch is the larger of
- its operations, 4 B L N C (q k^T and attn v over every window, two
  per multiply-add), at 989 TFLOP/s;
- its bytes, the bf16 q, k, v read and the output written (8 B L C) and
  the float32 position-bias table read once ((2w - 1)^2 H 4), at
  3.35 TB/s;
for B frames of a stage of L tokens and width C = embed 2^stage under
windows of w x w = N tokens (the window clamped to the stage's grid) and
H heads.  The widths are the reference's (`SML.WIDTHS` of
`reference/sml/dpt-swin2-large.py`); the least time depends on the model
type and `net_shape` alone, whatever runs the attention."""

from benchmark.counts import least_s
from benchmark.dpt_spans import attention_per_forward
from benchmark.reference.chain import sml_class

MODEL_TYPE = "dpt-swin2-large"


def forward_least_s(model_type: str, batch: int, net_shape):
    """Least seconds of one forward's block attentions on `batch` frames
    at `net_shape`; None for another model type."""
    if model_type != MODEL_TYPE:
        return None
    widths = sml_class(MODEL_TYPE).WIDTHS
    patch, window = widths["patch"], widths["window"]
    gh, gw = net_shape[0] // patch, net_shape[1] // patch
    total = 0.0
    for stage, (depth, heads) in enumerate(zip(widths["depths"],
                                               widths["heads"])):
        c = widths["embed"] * 2 ** stage
        w = min(window, gh, gw)
        tokens = gh * gw
        flops = 4.0 * batch * tokens * w * w * c
        nbytes = 8.0 * batch * tokens * c + 4.0 * (2 * w - 1) ** 2 * heads
        total += depth * least_s(nbytes, flops)
        gh, gw = gh // 2, gw // 2
    return total


def read(session):
    forwards = attention_per_forward(session.trace)
    sml = session.config["sml"]
    least = forward_least_s(sml["model_type"], session.batch_size,
                            sml["net_shape"])
    if forwards is None or least is None:
        return None
    device_s = sum(s for s, _ in forwards)
    if device_s <= 0:
        return None
    return 100.0 * least * len(forwards) / device_s
