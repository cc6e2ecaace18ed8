"""sml.device_ms.<cells>: device milliseconds per call of the kernels
launched inside the SML's forward (`models/sml.py`), read as
`rcnet.device_ms` is."""

from benchmark.trace import range_ms_per_call


def read(session):
    return range_ms_per_call(session.trace, "sml.forward")
