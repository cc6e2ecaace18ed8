"""RC-Net / SML training step time on the card, the counterpart of the
JAX package's `tools/bench_train.py`.

Steps run back to back (each updates the state in place, so each
depends on the last) and the host waits once, on the last step's loss;
a short run is subtracted to remove the start-up and the final wait.
The inputs are the JAX tool's, byte for byte, at the ZJU presets; the
weights are flax's default initialisers drawn from seed 0
(`models.layers.init_training_`).  The RC-Net step runs the f32 RoI pool
forward (B2) and its backward (B5) as CUDA kernels.

Usage: python -m riders_tpu_torch.tools.bench_train [rcnet|sml]
           [--steps N]
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import Counter
from typing import Callable, Dict

import numpy as np
import torch

from riders_tpu_torch.core.config import RidersConfig, zju_config
from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.ops.kernels import LAUNCHES


def _rcnet_inputs(cfg: RidersConfig, rng: np.random.Generator, B: int,
                  K: int) -> Dict[str, np.ndarray]:
    H, W = cfg.dataset.image_shape
    ph, pw = cfg.rcnet.patch_size
    Hp, Wp = H + ph, W + pw
    pts = np.stack([
        rng.integers(pw // 2, Wp - pw // 2, (B, K)),
        rng.integers(ph // 2, Hp - ph // 2, (B, K)),
        rng.random((B, K)) * 40 + 2], axis=-1).astype(np.float32)
    boxes = np.stack([
        pts[..., 0] - pw // 2, pts[..., 1] - ph // 2,
        pts[..., 0] + pw // 2, pts[..., 1] + ph // 2],
        axis=-1).astype(np.float32)
    return {
        "image": rng.random((B, Hp, Wp, 3)).astype(np.float32),
        "points": pts,
        "boxes": boxes,
        "gt_crops": (rng.random((B, K, ph, pw, 1)) * 40).astype(np.float32),
        "point_mask": np.ones((B, K), np.float32),
    }


def _sml_inputs(cfg: RidersConfig, rng: np.random.Generator, B: int
                ) -> Dict[str, np.ndarray]:
    H, W = cfg.dataset.image_shape
    depth = (5.0 + 40.0 * rng.random((B, H, W))).astype(np.float32)
    radar = np.where(rng.random((B, H, W)) > 0.995, depth, 0.0
                     ).astype(np.float32)
    return {
        "image": rng.random((B, H, W, 3)).astype(np.float32),
        "mono_pred": ((1.0 / depth) / 0.05).astype(np.float32),
        "radar": radar,
        "rcnet": radar,
        "gt_interp": depth,
        "gt_sparse": radar,
    }


def _step_ms(step: Callable, state, batch: Dict[str, torch.Tensor],
             steps: int) -> float:
    """ms per step: t(3 + steps) - t(3) over `steps`, after two steps of
    warm-up, each run ended by a fetch of its last loss."""
    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            _, info = step(state, batch)
        float(info["loss"])
        return time.perf_counter() - t0

    run(2)
    t_small, t_big = run(3), run(3 + steps)
    return (t_big - t_small) / steps * 1e3


def bench_rcnet(steps: int, device=None) -> Dict:
    """The RC-Net step at the ZJU preset; prints the JAX tool's line and
    returns ms, frames/s and the kernel launches of all its 8 + steps
    steps."""
    from riders_tpu_torch.models.layers import init_training_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines.rcnet_training import (
        init_rcnet_train_state, make_rcnet_train_step)

    device = resolve_device(device)
    cfg = zju_config()
    B = cfg.rcnet_train.batch_size            # 4
    K = cfg.rcnet_train.points_per_frame      # 30
    rng = np.random.default_rng(0)
    model = init_training_(RCNet(cfg.rcnet, device, torch.float32), 0)
    state = init_rcnet_train_state(cfg, model, steps_per_epoch=1000)
    step = make_rcnet_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _rcnet_inputs(cfg, rng, B, K).items()}
    before = Counter(LAUNCHES)
    ms = _step_ms(step, state, batch, steps)
    print(f"rcnet train step: {ms:.1f} ms  (batch {B}, K={K}, "
          f"patch {cfg.rcnet.patch_size}) -> {B / ms * 1e3:.1f} frames/s",
          flush=True)
    return dict(ms=ms, frames_per_s=B / ms * 1e3, batch=B, points=K,
                patch=list(cfg.rcnet.patch_size), steps_run=8 + steps,
                launches=dict(LAUNCHES - before))


def bench_sml(steps: int, device=None) -> Dict:
    """The SML step at the ZJU preset; prints the JAX tool's line and
    returns ms and samples/s."""
    from riders_tpu_torch.models.layers import init_training_
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.sml_training import (init_train_state,
                                                          make_train_step)

    device = resolve_device(device)
    cfg = zju_config()
    B = cfg.sml_train.batch_size
    rng = np.random.default_rng(0)
    model = init_training_(ScaleMapLearner(cfg.sml, device, torch.float32),
                           0)
    state = init_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _sml_inputs(cfg, rng, B).items()}
    ms = _step_ms(step, state, batch, steps)
    print(f"sml train step: {ms:.2f} ms  (batch {B}, {cfg.sml.net_shape})"
          f" -> {B / ms * 1e3:.1f} samples/s", flush=True)
    return dict(ms=ms, samples_per_s=B / ms * 1e3, batch=B,
                net_shape=list(cfg.sml.net_shape))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("which", nargs="?", default="rcnet",
                   choices=["rcnet", "sml"])
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    device = resolve_device(None)
    print(torch.cuda.get_device_name(device), file=sys.stderr)
    if args.which == "rcnet":
        bench_rcnet(args.steps, device)
    else:
        bench_sml(args.steps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
