"""rcnet.device_ms.<cells>: device milliseconds per call of the kernels
launched inside RC-Net's forward (`models/rcnet.py`), whose host range
the benchmark opens and closes by forward hooks; read from the
profiler's mirror of that range on the device's timeline."""

from benchmark.trace import range_ms_per_call


def read(session):
    return range_ms_per_call(session.trace, "rcnet.forward")
