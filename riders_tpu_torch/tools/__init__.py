"""Measuring tools of the port, the counterparts of the JAX package's
`tools/`: `bench_train` (training step time), `bench_serving` (host-fed
serving from disk) and `profile_bench` (device time by operation of the
benchmark's fused call).  Each runs on the card:
`python -m riders_tpu_torch.tools.<name>`."""
