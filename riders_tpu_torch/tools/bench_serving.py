"""Host-fed serving benchmark of the fused RC-Net + SML pipeline, the
counterpart of the JAX package's `tools/bench_serving.py`.

`riders_tpu_torch.bench` measures the device's time on card-resident
batches.  This tool measures the production path: frames on disk (PNG
RGB + PNG16 mono prior + radar .npy, the reference's interchange
formats), decoded and stacked by BatchLoader's worker threads, uploaded
and run by FusedServer's pipelined executor on the card, the fused
function called eagerly.

Staging is compact by default (uint8 image + uint16 PNG16 codes, 3.2x
fewer host-to-device bytes, decoded on the card); --f32 stages float32.

Reports JSON lines:
  * H2D MB/s            - pageable host-to-device copies of one batch's
    image before and after the fused function has run
  * host loader fps     - PNG decode + stack + copy to the card
  * host-fed serving fps- sustained end to end, pipelined (FusedServer,
    two batches in flight)
  * blocking batch latency p50/p99 - one batch at a time (no overlap)

The frames are written once under build/ at the root of the checkout
and reused.

Usage: python -m riders_tpu_torch.tools.bench_serving [--zju] [--f32]
           [--frames N] [--epochs N] [--decode-scaling]
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from riders_tpu_torch.core.device import resolve_device, to_device

FRAMES = 128
EPOCHS = 2
DATA_DIR = Path(__file__).resolve().parents[2] / "build"


def synthesize_tree(root: str, n_frames: int, H: int, W: int, n_pts: int,
                    seed: int = 0) -> List[str]:
    """Write a synthetic on-disk scene in the interchange formats (a
    frame whose radar file exists is kept)."""
    from PIL import Image
    from riders_tpu_torch.io import depthio
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_frames):
        name = f"frame_{i:04d}"
        base = os.path.join(root, name)
        if not os.path.exists(base + "_radar.npy"):
            img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(base + "_image.png")
            depth = (5.0 + 50.0 * rng.random((H, W))).astype(np.float32)
            depthio.save_depth((1.0 / depth) / 0.05, base + "_mono.png")
            u = rng.integers(0, W, n_pts)
            v = rng.integers(0, H, n_pts)
            pts = np.stack([u, v, depth[v, u]], axis=1).astype(np.float32)
            np.save(base + "_radar.npy", pts)
        names.append(name)
    return names


def _h2d_mbps(arr: np.ndarray, device: torch.device, n: int = 3) -> float:
    """MB/s of n pageable copies of `arr` to the card."""
    host = torch.from_numpy(arr)
    host.to(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        host.to(device)
    torch.cuda.synchronize(device)
    return arr.nbytes * n / (time.perf_counter() - t0) / 1e6


def _emit(record: Dict) -> Dict:
    print(json.dumps(record), flush=True)
    return record


def decode_scaling(preset: str, compact: bool, n_frames: int, epochs: int
                   ) -> Dict[str, float]:
    """Decode-only fps (no device) on threads and on process pools of
    increasing size (BatchLoader num_workers); PNG inflate holds the
    interpreter lock, so threads top out near one core's rate."""
    from riders_tpu_torch.io.input_pipeline import BatchLoader
    from riders_tpu_torch.pipelines.serving import FusedInferenceDataset
    H, W = (512, 640)
    B = 16
    root = str(DATA_DIR / f"riders_serving_{preset}_{H}x{W}")
    names = synthesize_tree(root, n_frames, H, W,
                            40 if preset == "ntu" else 30)
    ds = FusedInferenceDataset(names, root=root, max_points=48,
                               compact=compact)
    results = {}
    for mode, n_w in [("threads", 8), ("procs", 2), ("procs", 4),
                      ("procs", 8), ("procs", 12), ("procs", 16)]:
        kw = ({"num_threads": n_w} if mode == "threads"
              else {"num_workers": n_w})
        ld = BatchLoader(ds, batch_size=B, shuffle=False, prefetch=3,
                         drop_last=True, device_put=False, **kw)
        try:
            for _ in ld.epoch():          # warm the page cache / pool
                pass
            t0 = time.perf_counter()
            n = 0
            for _ in range(epochs):
                for _ in ld.epoch():
                    n += B
            results[f"{mode}{n_w}"] = n / (time.perf_counter() - t0)
        finally:
            ld.close()
        _emit({"metric": f"decode-only fps ({preset}, "
                         f"{'compact' if compact else 'f32'}, "
                         f"{mode} x{n_w})",
               "value": round(results[f"{mode}{n_w}"], 1), "unit": "fps"})
    _emit({"metric": "decode-only scaling summary",
           **{k: round(v, 1) for k, v in results.items()}})
    return results


def main(argv=None) -> Dict:
    """Run the benchmark; returns its records by name."""
    args = sys.argv[1:] if argv is None else list(argv)
    preset = "zju" if "--zju" in args else "ntu"
    compact = "--f32" not in args
    n_frames, epochs = FRAMES, EPOCHS
    for i, a in enumerate(args):
        if a == "--frames":
            n_frames = int(args[i + 1])
        if a == "--epochs":
            epochs = int(args[i + 1])
    if "--decode-scaling" in args:
        return {"decode_scaling": decode_scaling(preset, compact, n_frames,
                                                 epochs)}

    from riders_tpu_torch import bench
    from riders_tpu_torch.io.input_pipeline import BatchLoader
    from riders_tpu_torch.pipelines.serving import (FusedInferenceDataset,
                                                    FusedServer)
    kind = "compact" if compact else "f32"
    device = resolve_device(None)
    fused, dev_batch, _ = bench.build(preset, device=device)
    B, H, W = dev_batch["image"].shape[:3]
    K = dev_batch["radar_points"].shape[1]
    n_real = bench.POINTS[preset][0]
    if n_frames < B:
        raise ValueError(f"--frames {n_frames}: fewer than one batch of {B}")

    probe = np.random.random((B, H, W, 3)).astype(np.float32)
    pre_mbps = _h2d_mbps(probe, device)

    root = str(DATA_DIR / f"riders_serving_{preset}_{H}x{W}")
    names = synthesize_tree(root, n_frames, H, W, n_real)
    ds = FusedInferenceDataset(names, root=root, max_points=K,
                               compact=compact)

    def host_batches(n_epochs):
        hl = BatchLoader(ds, batch_size=B, shuffle=False, num_threads=8,
                         prefetch=3, drop_last=True, device_put=False)
        for _ in range(n_epochs):
            yield from hl.epoch()

    server = FusedServer(fused, depth=2, device=device)
    for _ in server.run(host_batches(1)):      # warm cuDNN and the pools
        pass
    out = {"h2d": _emit({
        "metric": "H2D MB/s (pre/post fused load)",
        "pre": round(pre_mbps), "post": round(_h2d_mbps(probe, device)),
        "unit": "MB/s"})}

    # --- loader alone: host decode + stack + copy to the card ----------
    ld = BatchLoader(ds, batch_size=B, shuffle=False, num_threads=8,
                     prefetch=3, drop_last=True, device=device)
    t0 = time.perf_counter()
    n = 0
    for _ in range(epochs):
        for _ in ld.epoch():
            torch.cuda.synchronize(device)
            n += B
    out["loader"] = _emit({
        "metric": f"host loader fps ({preset}, {kind})",
        "value": round(n / (time.perf_counter() - t0), 1), "unit": "fps"})

    # --- pipelined serving: BatchLoader -> FusedServer -----------------
    t0 = time.perf_counter()
    n = 0
    for depth in server.run(host_batches(epochs)):
        n += depth.shape[0]
    out["serving"] = _emit({
        "metric": f"host-fed serving fps ({preset}, {kind})",
        "value": round(n / (time.perf_counter() - t0), 1), "unit": "fps"})

    # --- blocking single-batch latency (no overlap) --------------------
    lat = []
    for batch in host_batches(1):
        t0 = time.perf_counter()
        staged = {k: to_device(v, device) for k, v in batch.items()}
        fused(staged).cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[1:] if len(lat) > 1 else lat)   # drop the first
    out["latency"] = _emit({
        "metric": f"blocking batch-{B} latency ({preset}, {kind})",
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "unit": "ms", "batches": int(lat.size), "frames": n_frames,
        "epochs": epochs})
    return out


if __name__ == "__main__":
    main()
