"""Benchmark of the port: fused RC-Net + SML inference fps per card at
640x512, the counterpart of the JAX package's `bench.py`.

    python -m riders_tpu_torch.bench           # NTU and ZJU
    python -m riders_tpu_torch.bench --ntu     # one geometry
    riders-torch bench [--ntu | --zju]

The inputs are `bench.py`'s: the same numpy batch, byte for byte, and
the same configuration (640x512 frames, the NTU or ZJU patch geometry,
a 48 / 32-point bucket holding 40 / 30 real points); the models are the
port's RC-Net and midas-small SML in bf16 on seeded random weights.
`RIDERS_BENCH_BATCH` sets the batch (16 by default), as for `bench.py`.

Method, `bench.py`'s on the card: one chained step is the fused call on
static input buffers, then `bench.py`'s carry, image[0, 0, 0, 0] +=
1e-12 * depth.sum(), which keeps every output element live and makes
each call depend on the last.  The step is warmed up on a side stream,
captured once into a CUDA graph (`Chain(graph=True)`) and replayed; a
run of n replays ends with a fetch of the carried scalar, and the
seconds per call are the median over three repeats of (t(22) - t(2)) /
20 on the host clock.  Graph replay is the device's time per call: no
host dispatch sits between the calls.  The eager chain (`graph=False`)
times the same steps dispatched one by one, which is what a caller of
`make_fused_fn` sees.  Only the eager chain runs on the CPU.

The last line keeps `bench.py`'s form (`metric`, `value` = NTU fps by
graph replay, `unit`, `zju_fps`); the line before it carries graph and
eager ms and fps per preset, the kernel launches counted while the call
was captured, peak memory, the card, the versions and the TF32 / cuDNN
settings in force (the entry point leaves PyTorch's defaults).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from riders_tpu_torch.core.config import RidersConfig, ntu_config, zju_config
from riders_tpu_torch.core.device import resolve_device

BATCH = int(os.environ.get("RIDERS_BENCH_BATCH", "16"))
FRAME = (512, 640)                       # the benchmark frame (H, W)
# preset -> (real points per frame, bucket): the reference's per-rig
# point budgets, the bucket the next multiple of 16
POINTS = {"ntu": (40, 48), "zju": (30, 32)}
N_SMALL, N_BIG, REPEATS = 2, 22, 3
WARMUP = 3                  # steps before capture: builds, cuDNN plans,
                            # cached packed weights


def bench_config(preset: str) -> RidersConfig:
    """The preset at the benchmark frame with its point bucket."""
    cfg = ntu_config() if preset == "ntu" else zju_config()
    return cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=FRAME, max_points=POINTS[preset][1]))


def make_batch(cfg: RidersConfig, n_real: int, batch: int
               ) -> Dict[str, np.ndarray]:
    """`bench.py`'s batch: `default_rng(0)` draws the depth, then each
    frame's points, then the image."""
    H, W = cfg.dataset.image_shape
    K = cfg.dataset.max_points
    rng = np.random.default_rng(0)
    depth = (5.0 + 50.0 * rng.random((batch, H, W))).astype(np.float32)
    pts = np.zeros((batch, K, 3), np.float32)
    mask = np.zeros((batch, K), np.float32)
    for b in range(batch):
        u = rng.integers(0, W, n_real)
        v = rng.integers(0, H, n_real)
        pts[b, :n_real] = np.stack([u, v, depth[b, v, u]], axis=1)
        mask[b, :n_real] = 1.0
    return {"image": rng.random((batch, H, W, 3)).astype(np.float32),
            "mono_pred": ((1.0 / depth) / 0.05).astype(np.float32),
            "radar_points": pts, "point_mask": mask}


def build(preset: str = "ntu", batch: Optional[int] = None, device=None
          ) -> Tuple[Callable, Dict[str, torch.Tensor], RidersConfig]:
    """(fused fn, the batch on `device`, the config): the port's RC-Net
    (seed 0) and SML (seed 1) in bf16 on the card unless device='cpu'.
    The SML head's last conv is scaled down so that the random network
    regresses scales near 1 and depth stays metric."""
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    device = resolve_device(device)
    cfg = bench_config(preset)
    rcnet = init_random_(RCNet(cfg.rcnet, device, torch.bfloat16), 0)
    sml = init_random_(ScaleMapLearner(cfg.sml, device, torch.bfloat16), 1)
    with torch.no_grad():
        sml.output_conv.conv3.weight.mul_(1e-3)
    host = make_batch(cfg, POINTS[preset][0],
                      BATCH if batch is None else batch)
    on_device = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return make_fused_fn(cfg, rcnet, sml, device), on_device, cfg


def carry_(image: torch.Tensor, depth: torch.Tensor) -> None:
    """`bench.py`'s carry, in place: image[0, 0, 0, 0] += 1e-12 *
    depth.sum()."""
    image.view(-1)[:1].add_(1e-12 * depth.sum())


class Chain:
    """`bench.py`'s chained fused call on static copies of `batch`.

    A step is fn(batch) and then `carry_` into the batch's image.  With
    `graph`, the step is warmed up WARMUP times on a side stream and
    captured into one CUDA graph; each call replays it, and `launches`
    holds the kernel launches the capture counted.  A graph needs the
    batch on the card."""

    def __init__(self, fn: Callable, batch: Dict[str, torch.Tensor],
                 graph: bool = False):
        self.fn = fn
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        if not graph:
            return
        device = self.batch["image"].device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the batch on the card, "
                             f"not on {device}")
        from riders_tpu_torch.ops.kernels import LAUNCHES
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.step()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        before = Counter(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.step()
        self.launches = dict(LAUNCHES - before)

    def step(self) -> torch.Tensor:
        with torch.inference_mode():
            depth = self.fn(self.batch)
            carry_(self.batch["image"], depth)
        return depth

    def __call__(self) -> torch.Tensor:
        """One chained call; returns its depth (for a graph, the static
        output, overwritten by the next replay)."""
        if self.graph is None:
            return self.step()
        self.graph.replay()
        return self.out

    def run(self, n: int) -> float:
        """n chained calls, then a fetch of the carried scalar (which
        waits for the last call)."""
        for _ in range(n):
            self()
        return float(self.batch["image"].view(-1)[0])


def device_time_per_call(chain: Chain, n_small: int = N_SMALL,
                         n_big: int = N_BIG, repeats: int = REPEATS
                         ) -> Tuple[float, List[float]]:
    """(median seconds per call, the samples): `bench.py`'s method, the
    host clock around n_big and n_small chained calls, each ended by a
    scalar fetch, (t_big - t_small) / (n_big - n_small) per repeat."""
    chain.run(n_small)
    chain.run(n_big)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain.run(n_big)
        t1 = time.perf_counter()
        chain.run(n_small)
        t2 = time.perf_counter()
        samples.append(((t1 - t0) - (t2 - t1)) / (n_big - n_small))
    return statistics.median(samples), samples


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]


def settings() -> Dict:
    """The TF32 and cuDNN settings in force."""
    return dict(
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        cudnn_enabled=torch.backends.cudnn.enabled,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        cudnn_version=torch.backends.cudnn.version())


def measure(preset: str) -> Dict:
    """Graph-replay and eager ms per call and fps of one preset on the
    card, the launches counted during capture, the replayed call's depth
    against an eager call's on the same input, output checks and peak
    memory."""
    device = resolve_device(None)
    torch.cuda.reset_peak_memory_stats(device)
    fused, data, cfg = build(preset, device=device)
    B = data["image"].shape[0]
    t0 = time.perf_counter()
    graph = Chain(fused, data, graph=True)
    capture_s = time.perf_counter() - t0
    # the replayed call against an eager call on the same input
    image = graph.batch["image"].clone()
    replayed = graph().clone()
    eager_depth = fused(dict(graph.batch, image=image))
    diff = (replayed - eager_depth).abs()
    graph_s, graph_samples = device_time_per_call(graph)
    eager_s, eager_samples = device_time_per_call(Chain(fused, data))
    torch.cuda.synchronize(device)
    rec = dict(
        preset=preset, batch=B, frame=list(cfg.dataset.image_shape),
        bucket=cfg.dataset.max_points, real_points=POINTS[preset][0],
        graph_ms=graph_s * 1e3, eager_ms=eager_s * 1e3,
        graph_fps=B / graph_s, eager_fps=B / eager_s,
        graph_samples_ms=[s * 1e3 for s in graph_samples],
        eager_samples_ms=[s * 1e3 for s in eager_samples],
        capture_launches=graph.launches, capture_s=capture_s,
        replay_equals_eager=bool(torch.equal(replayed, eager_depth)),
        replay_vs_eager_max_abs=float(diff.max()),
        replay_vs_eager_median_rel=float(
            (diff / eager_depth.abs().clamp(min=1e-3)).median()),
        depth_shape=list(replayed.shape),
        finite=bool(torch.isfinite(replayed).all()),
        positive_share=float((replayed > 0).float().mean()),
        depth_median=float(replayed.median()),
        peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    del graph, replayed, eager_depth, diff
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    only = "zju" if "--zju" in args else ("ntu" if "--ntu" in args
                                          else None)
    presets = [only] if only else ["ntu", "zju"]
    records = {p: measure(p) for p in presets}
    print(json.dumps({"bench": dict(
        card=card(), device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        settings=settings(), presets=records)}), flush=True)
    metric = "fused RC-Net+SML inference fps/card @640x512"
    if only is not None:
        tag = "" if only == "ntu" else " (zju patch geometry)"
        line = {"metric": metric + tag,
                "value": round(records[only]["graph_fps"], 1),
                "unit": "fps"}
    else:
        line = {"metric": metric + " (ntu patch geometry; zju_fps = zju "
                "patch geometry; CUDA graph replay)",
                "value": round(records["ntu"]["graph_fps"], 1),
                "unit": "fps",
                "zju_fps": round(records["zju"]["graph_fps"], 1)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
