"""dpt.attn.device_ms.<cells>: device milliseconds per call of the
kernels launched inside the DPT SML's attention spans (`dpt.attn`, one
per BEiT block, `benchmark.dpt_spans`), summed over the blocks of each
SML forward in the traced stretch and averaged over those forwards."""

from benchmark.dpt_spans import attention_per_forward


def read(session):
    forwards = attention_per_forward(session.trace)
    if forwards is None:
        return None
    return 1e3 * sum(s for s, _ in forwards) / len(forwards)
