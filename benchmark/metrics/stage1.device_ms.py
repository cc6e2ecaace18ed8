"""stage1.device_ms.<cells>: device milliseconds per call of the kernels
launched inside stage 1 of the fused call, the scale alignment of the
prior and the scale map's synthesis with the SML input's cast
(`pipelines/sml_inference.prepare_sml_inputs`, the program's span
`fused.stage1`), read as `compose.device_ms` is."""

from benchmark.trace import range_ms_per_call


def read(session):
    return range_ms_per_call(session.trace, "fused.stage1")
