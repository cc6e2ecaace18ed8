"""The readings a cell's correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds <s>] [--program port|control ...]

For each seed and program it runs the cell once through
`harness.run_cell` at the cell's own batch and load, for a short window,
and prints one JSON line with every number the run compares
(`harness.check_outputs`) and whether the run came out correct:

- `port`: the system under test, the lower readings;
- `control`: the reference put in the program's place with the weights
  and activations of every conv and linear layer of both networks
  stored in float8 e4m3 (`reference.chain.emulate_`), the precision step
  below the configuration's bfloat16: the upper readings, and a run
  that has to come out not correct.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(root: Path, cell_name: str, seed: int, program: str,
             seconds: float = 3.0, device: str = "cuda") -> dict:
    from benchmark import harness
    r = harness.run_cell(root, cell_name, seed, seconds, False,
                         device=device, program=program)
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    return {"cell": cell_name, "seed": seed, "program": program,
            "correct": r["correct"], "attempted": r["attempted"],
            "checks": r["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", nargs="+", default=["port", "control"],
                   choices=["port", "control"])
    args = p.parse_args(argv)
    for seed in args.seeds:
        for program in args.program:
            print(json.dumps(readings(ROOT, args.workload, seed, program,
                                      args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
