"""dpt.bias_tables.<cells>: relative position bias tables the DPT SML
builds (gather and resize) per forward, from the program's counter
`riders_tpu_torch.models.dpt.COUNTS` ("bias_tables" over "forwards",
over the whole run); None where the program has no such counter or ran
no forward."""


def read(session):
    try:
        from riders_tpu_torch.models.dpt import COUNTS
    except ImportError:
        return None
    forwards = COUNTS.get("forwards", 0)
    return COUNTS.get("bias_tables", 0) / forwards if forwards else None
