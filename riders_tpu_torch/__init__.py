"""riders_tpu_torch: the RIDERS fused inference path in PyTorch for an
NVIDIA H100.

A second package beside the JAX reference `riders_tpu`, with the same
module layout (core, ops, ops/kernels, models, pipelines).  The three
TPU kernels of the fused path (the fused stem, the RoI pool and the
patch composition) are hand-written CUDA C++ for sm_90a under `csrc/`,
built with nvcc at first use and bound with ctypes; every other step is
plain PyTorch.

Every entry point runs on `cuda` unless the caller passes
``device="cpu"``; without a GPU and without that request it raises.
"""

__version__ = "0.1.0"
