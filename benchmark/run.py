"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds `riders_tpu_torch` beside
`BENCHMARK.json`.  It measures the port on the card and only that: it
exits with 2, printing no result, without CUDA or with fewer cards than
the cell asks for, and with 3 if JAX, flax, optax or the JAX package
(`riders_tpu`, compared as a whole top-level name) is loaded once the
window has closed.  The last lines of standard error, and the `checks`
key that ends the result line, give each number compared with the
reference beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for PyTorch's CPU work: the fused call's dispatch and
# the server's uploader are single threads, and idle pool threads that
# spin after a parallel copy take cores from them, which spreads runs
os.environ["OMP_NUM_THREADS"] = "1"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")

    from benchmark import harness
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(harness.describe_checks(result["checks"])),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
