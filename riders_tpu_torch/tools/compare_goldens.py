"""Score a run's outputs against reference goldens, the counterpart of
the JAX package's `tools/compare_goldens.py`.

Usage: python -m riders_tpu_torch.tools.compare_goldens <goldens_dir>
           <riders_out_dir> [--root <dataset_root>] [--min-depth 0]
           [--max-depth 50] [--device cpu]

Scenes are the sub-directories of <goldens_dir>, frames the names in
each scene's sml_depth/.  Per scene it reports the mean absolute
deviation of the stage-1 int_depth / int_scales maps (.npy, over the
frames that both trees have) and of the final sml_depth PNGs, averaged
over the frames (None where the scene has none).  With --root, both
trees are scored by `evaluate_results_dir` against the dataset's sparse
lidar GT (the ZJU preset, those scenes as its validation scenes), and
each metric's relative deviation is held against the 1% parity budget on
mae, rmse and delta1 (BASELINE.md, PARITY.md).  --min-depth and
--max-depth set the metrics' depth window; at their defaults, the ZJU
preset's own, the results are the JAX tool's, which parses the two flags
and keeps the preset's window.  The metrics run on --device: the card
unless 'cpu'.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from riders_tpu_torch.core.config import zju_config
from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.io.depthio import load_depth
from riders_tpu_torch.pipelines.drivers import evaluate_results_dir

BUDGET = 0.01
BUDGET_KEYS = ("mae", "rmse", "delta1")


def scene_deviations(goldens: str, riders_out: str
                     ) -> Dict[str, Dict[str, Optional[float]]]:
    """{scene: {'int_depth', 'int_scales', 'depth': mean abs deviation
    or None}}, each printed as `<scene> {...}` as it is computed."""
    scenes = sorted(d for d in os.listdir(goldens)
                    if os.path.isdir(os.path.join(goldens, d)))
    report = {}
    for scene in scenes:
        gdir = os.path.join(goldens, scene)
        rdir = os.path.join(riders_out, scene)
        devs = {"int_depth": [], "int_scales": [], "depth": []}
        for name in sorted(os.listdir(os.path.join(gdir, "sml_depth"))):
            fid = os.path.splitext(name)[0]
            for key in ("int_depth", "int_scales"):
                gp = os.path.join(gdir, key, fid + ".npy")
                rp = os.path.join(rdir, key, fid + ".npy")
                if os.path.exists(gp) and os.path.exists(rp):
                    devs[key].append(float(np.abs(np.load(gp)
                                                  - np.load(rp)).mean()))
            gp = os.path.join(gdir, "sml_depth", name)
            rp = os.path.join(rdir, "sml_depth", name)
            if os.path.exists(gp) and os.path.exists(rp):
                devs["depth"].append(float(np.abs(load_depth(gp)
                                                  - load_depth(rp)).mean()))
        report[scene] = {k: (float(np.mean(v)) if v else None)
                         for k, v in devs.items()}
        print(scene, report[scene])
    return report


def compare_goldens(goldens: str, riders_out: str,
                    root: Optional[str] = None, min_depth: float = 0.0,
                    max_depth: float = 50.0, device=None) -> Dict:
    """The per-scene report and, with `root`, both trees' metrics, the
    relative deviation of each and the budget's verdict; the JAX tool's
    lines are printed on the way.  Keys: 'report', and with `root`
    'golden_metrics', 'riders_metrics', 'relative_deviation' and
    'within_budget'."""
    device = resolve_device(device)
    report = scene_deviations(goldens, riders_out)
    out = {"report": report}
    if not root:
        return out
    cfg = zju_config(root=root)
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, val_scenes=tuple(report)),
        eval=dataclasses.replace(cfg.eval, min_depth_val=min_depth,
                                 max_depth_val=max_depth))
    print("— golden metrics —")
    gm = evaluate_results_dir(cfg, goldens, device=device)
    print("— riders metrics —")
    rm = evaluate_results_dir(cfg, riders_out, device=device)
    rel = {k: abs(rm[k] - gm[k]) / max(abs(gm[k]), 1e-9) for k in gm}
    print("relative deviation:", json.dumps(rel, indent=2))
    budget = all(rel[k] <= BUDGET for k in BUDGET_KEYS)
    print("within 1% parity budget:", budget)
    out.update(golden_metrics=gm, riders_metrics=rm,
               relative_deviation=rel, within_budget=budget)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("goldens")
    ap.add_argument("riders_out")
    ap.add_argument("--root", default=None,
                    help="dataset root (for GT-based metric comparison)")
    ap.add_argument("--min-depth", type=float, default=0.0)
    ap.add_argument("--max-depth", type=float, default=50.0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to score on the host; the card by default")
    args = ap.parse_args(argv)
    compare_goldens(args.goldens, args.riders_out, args.root,
                    args.min_depth, args.max_depth, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
