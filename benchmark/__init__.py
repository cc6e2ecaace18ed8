"""The benchmark of riders_tpu_torch, the PyTorch / CUDA port of RIDERS:
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (see benchmark/README.md)."""
