"""Tools of the port, the counterparts of the JAX package's `tools/`:
`bench_train` (training step time), `bench_serving` (host-fed serving
from disk), `profile_bench` (device time by operation of the
benchmark's fused call), each on the card, and `compare_goldens` (a
run's outputs scored against goldens; on the card unless `--device
cpu`): `python -m riders_tpu_torch.tools.<name>`."""
