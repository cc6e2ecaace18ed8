"""swin2.cpb_tables.<cells>: continuous position-bias tables the Swin V2
SML computes (its MLP over the coordinate table) per forward, from the
program's counters `riders_tpu_torch.models.swin2.COUNTS`
("cpb_tables") over `riders_tpu_torch.models.dpt.COUNTS` ("forwards"),
over the whole run; None where the program has no such counter or ran
no forward."""


def read(session):
    try:
        from riders_tpu_torch.models.dpt import COUNTS as forwards
        from riders_tpu_torch.models.swin2 import COUNTS
    except ImportError:
        return None
    n = forwards.get("forwards", 0)
    return COUNTS.get("cpb_tables", 0) / n if n else None
