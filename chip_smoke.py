#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's fused inference path, its RC-Net and
SML training steps, its staged inference, serving and drivers, its
command line (training, inference and preprocessing) and its DPT Scale
Map Learner on one GPU.

    python3 chip_smoke.py                 # all phases, report lines
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns
                                          # of a fused call and a step
    python3 chip_smoke.py --kernel-times  # phase 1, then only the checks
                                          # and times of B1, B2, B4, B6
                                          # and B8 (copied into another
                                          # tree's root, it times that
                                          # tree's)
    python3 chip_smoke.py --dpt           # phase 1, then phase 10 alone
                                          # on a dataset of its own

Kernel times: `ms` is the median of synchronised calls (host dispatch
counts in); `graph_ms` replays 20 calls captured in one CUDA graph
between two events, over 20: the device's time alone (B1, B2, B4, B6,
B8); `device_ms` times 20 calls queued back to back (B5, B7, B8).

Phases, each fatal on failure:
  1. set-up: the card, the versions, the nvcc build of csrc/*.cu;
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the fused path's shapes (B=16, bf16) for the NTU and ZJU
     geometries, with CUDA-event times of both and of a library yardstick;
     the stem also at slopes 0 (relu) and 1 (linear) at NTU; the RoI
     pyramid in one launch; compose also with every real point of a frame
     clustered around one spot;
  3. the full-width NTU fused path at 640x512, B=16, K=48 (40 real
     points), bf16, on seeded random weights: three batches with the
     launch counters reset just before, output checks (one RoI pool
     launch per call), fps; then the ZJU geometry at B=4 the same way;
  4. agreement of the card's bf16 path with the port's f32 CPU path on a
     small input with the same weights, within the CPU's own bf16 spread;
  4b. the lane-major decoder and the 4D RoI pyramid: (a) the lane conv
     (B7) and upconv (B8) kernels against their plain versions at every
     call shape of one decode_full, NTU (N = 768) and ZJU (N = 512), with
     CUDA-event times of both and of cuDNN (the median of synchronised
     calls, and back to back), a line per call; (b) the decoder's inputs
     captured from a fused B=16 call of each preset, decoded by the
     literal decoder and by lane_mode "full" and "tail" copies (within 5%
     of the literal's max, launch counters reset just before each); (c)
     the 4D pyramid (B6) on that call's encoder maps, skip1 as a NEG-
     padded canvas, bitwise equal to the B2 pyramid and the plain one;
  5. training kernels at the NTU (B=24, K=40) and ZJU (B=4, K=30)
     training shapes, f32: the RoI pool's forward (bitwise) and its
     backward (within 1e-6 relative of the plain version, two launches
     bitwise equal), with CUDA-event times (the backward's also back to
     back), their bound and the share of the backward's tiles that no box
     meets;
  6. training at full published widths on seeded random weights: three
     RC-Net steps at the NTU preset (B=24, 40 points, 150x50 patches,
     512x640 frames) and three SML steps (288x352, B=12), each with the
     launch counters reset just before, finite loss, every parameter
     moved, ms per step, frames/s and peak memory; then a checkpoint
     save / restore round trip;
  7. one RC-Net training step on the card in f32 against the port's f32
     CPU step: loss to rtol 1e-4, each gradient within 1e-3 of its max
     or within 3x the CPU's own spread under a one-ulp input nudge;
  8. staged inference and serving, each path with the launch counters
     reset just before it: (a) staged RC-Net (make_rcnet_infer_fn) at the
     NTU preset, 640x512, B=16, K=48 with 40 real points, bf16, its
     threshold between the frames' maximum responses so that some frames
     retry and some do not: stem >= 1, one RoI pool and 1 + rounds
     compose launches per call, outputs bitwise equal to the retry loop
     over the plain composition of the same card responses; (b) staged
     SML (make_infer_fn, 288x352 net, B=16) on (a)'s depth with a sparse
     GT: its metrics within rtol 1e-5 of the CPU's on the same depth;
     (c) FusedServer(depth=2) over six compact NTU B=16 batches, bitwise
     equal to direct fused calls, the uploader joined after the run and
     after an early close, served, sequential and card-resident
     frames/s; (d) the on-disk drivers on an 8-frame NTU mini-dataset
     written under build/: run_rcnet, evaluate_results_dir on its tree,
     validate_sml over two checkpoints;
  9. the training drivers and the CLI (`riders_tpu_torch.cli.main`) at
     the NTU preset's full widths, each command with the launch counters
     reset just before it, on a dataset of 24 training and 4 validation
     NTU frames (512x640) written under build/, the preset's cadence cut
     to a summary every step and a checkpoint every 3: (a) train-rcnet,
     B=24, K=40, 3 steps: finite loss at each step, the checkpoint and
     summaries/step3.png at step 3, 15 RoI backward and 15 + 1 (the
     summary's forward) f32 pyramid launches, the host interval between
     step starts, and the trainer's loader alone (ms per batch); (b)
     run-rcnet at thresholds 0.5 and 0.4 (one stem and one RoI pool
     launch and 1 + rounds compose launches a frame); (c) train-sml,
     B=12, 3 steps, with the IDW scale map ('interp') and with the
     preset's rcnet_0.4 knots, step intervals and peak memory, and the
     loader alone; (d) val-rcnet, val-sml --depth-predictor midas_small
     and eval-dir, seconds each; (e) preprocess of a raw 4-frame NTU
     scene (16-bit thermal PNGs, binary lidar .pcd of 40000 points and
     radar .pcd of 200), ms per frame, each frame's lidar densified by
     the native Delaunay and by scipy, their ms and the share of pixels
     where they differ, each such pixel inside one of scipy's triangles
     that has an exactly cocircular neighbour (a tie); (f) idw_scale_map
     at 512x640 on the card against the CPU, 300, 40 and 0 knots: equal
     knot indices and rtol 1e-5.
  10. the DPT SML at full width (none of the hand-written kernels lies on
     its path; the counters, reset just before, stay empty), after the
     earlier phases' memory is freed: (a) `make_infer_fn` at the NTU
     preset (640x512 frames, SML net 288x352, B=16, bf16) with
     DPT-BEiT-L/16-512 on seeded flax-default weights: finite depth and
     metrics, ms per call over 10 calls with their spread, peak memory,
     parameters and the call's operations over the bf16 peak; one short
     timing each of dpt-large (ViT-L/16) and dpt-hybrid; (b)
     `make_train_step` with BEiT-L, B=12, f32: three steps (every
     parameter moved), ms per step and peak memory, and one B=2 step at
     net 64x96 on the card against the host CPU by phase 7's rule; (c)
     `train_sml` with BEiT-L, 3 steps, on phase 9's mini-dataset (the
     'interp' source), then `validate_sml` of its checkpoint in bf16 on
     the card and in f32 on the host CPU: the seven metrics within 1%.
Report lines: the card's name and power limit, one {"kernels": [...]}
line, one fused line, one lane_decoder line, one training line, one
staged line, one training_cli line, one dpt line; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""

import copy
import inspect
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor rate
STEM_TOL = (2.0 ** -7, 1e-4)   # (rtol, atol): one bf16 rounding step
LANE_TOL = (2.0 ** -7, 1e-3)   # (rtol, atol relative to max|p|): ditto
LANE_DECODE_BAR = 0.05         # max|lane - literal| / max|literal|
CANVAS_PAD = (96, 48)          # rows, columns of NEG past skip1's extent
GEOMETRIES = {"ntu": dict(patch=(150, 50), bucket=48, real=40),
              "zju": dict(patch=(240, 100), bucket=32, real=30)}
FRAME = (512, 640)             # the benchmark resolution (H, W)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, n=20, warmup=3):
    """Median CUDA-event time of `fn` over n calls after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20, warmup=3):
    """CUDA-event time of n back-to-back calls of `fn`, over n: the
    device's time per call where it is slower than the host's dispatch,
    which `time_ms` (a synchronised call each) counts in."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=20, replays=5):
    """The device's time per call of `fn`, apart from the host: n calls
    captured in one CUDA graph, replayed between two events, over n (the
    median of `replays` replays)."""
    import torch
    fn()                                        # builds, cuDNN plans
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def bound_ms(nbytes, flops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def roi_read_bytes(maps, boxes, patch):
    """Bytes of the pyramid maps that the RoI pool must read for these
    boxes: per frame and map, the union of the boxes' clamped windows
    (the union of a box's bins is its clamped window)."""
    import torch
    from riders_tpu_torch.ops import patches
    ph, pw = patch
    n = 0
    for i, m in enumerate(maps):
        B, H, W, C = m.shape
        lo_h, hi_h, lo_w, hi_w = patches._roi_bounds(
            boxes, 1.0 / 2 ** (i + 1), H, W, (ph >> (i + 1), pw >> (i + 1)))
        r = torch.arange(H, device=m.device)
        c = torch.arange(W, device=m.device)
        rows = (r >= lo_h[..., :1]) & (r < hi_h[..., -1:])      # (B, K, H)
        cols = (c >= lo_w[..., :1]) & (c < hi_w[..., -1:])      # (B, K, W)
        cover = torch.bmm(rows.transpose(1, 2).float(), cols.float()) > 0
        n += m.element_size() * C * int(cover.sum())
    return n


def compose_read_elems(points, mask, frame, patch):
    """Response elements that compose must read: those of the real
    points' patches that land inside the frame (a masked point adds 0)."""
    from riders_tpu_torch.ops import patches
    (H, W), (ph, pw) = frame, patch
    y0, x0 = patches._patch_origins(points, frame, patch)
    rows = ((y0 + ph).clamp(max=H + ph // 2) - y0.clamp(min=ph // 2))
    cols = ((x0 + pw).clamp(max=W + pw // 2) - x0.clamp(min=pw // 2))
    return int((rows.clamp(min=0) * cols.clamp(min=0) * (mask > 0)).sum())


def pyramid_inputs(geometry, B, g):
    """The fused path's RoI pyramid inputs at the preset's geometry: five
    random bf16 NHWC maps at the RC-Net encoder's strides and widths (the
    edge-padded frame's /2 ... /32), and a make_batch frame's boxes,
    shifted points and point mask."""
    import torch
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)
    geo = GEOMETRIES[geometry]
    ph, pw = geo["patch"]
    h, w = FRAME[0] + 2 * (ph // 2), FRAME[1] + 2 * (pw // 2)
    maps = []
    for c in (32, 64, 128, 128, 128):
        h, w = -(-h // 2), -(-w // 2)
        maps.append(torch.randn((B, h, w, c), generator=g,
                                device=g.device).to(torch.bfloat16))
    batch = make_batch(7, B, geo["bucket"], geo["real"], FRAME, g.device)
    points, boxes = shift_points_and_boxes(batch["radar_points"], (ph, pw))
    return maps, boxes.contiguous(), points, batch["point_mask"]


def check_kernels(geometry, B=16):
    """Each kernel against its plain version at the fused path's shapes;
    returns {kernel name: record}."""
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.ops import patches
    from riders_tpu_torch.ops.kernels import LAUNCHES, compose, roi_pool, stem

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    geo = GEOMETRIES[geometry]
    ph, pw = geo["patch"]
    K = geo["bucket"]
    H, W = FRAME
    Hp, Wp = H + 2 * (ph // 2), W + 2 * (pw // 2)
    out = {}

    # ---- stem: 7x7/s2 conv + folded BN + max(y, slope y) + MaxPool2d(3,2,1)
    x = torch.rand((B, Hp, Wp, 3), generator=g, device=dev).to(
        torch.bfloat16)
    w = torch.randn((32, 3, 7, 7), generator=g, device=dev) * (2 / 147) ** .5
    scale = 0.5 + torch.rand(32, generator=g, device=dev)
    bias = 0.1 * torch.randn(32, generator=g, device=dev)

    def stem_err(**slope):
        """The kernel's max abs error against the plain version (both
        outputs), raising beyond one bf16 step; and the kernel's maps."""
        k_maps = stem.stem_conv_pool(x, w, scale, bias, **slope)
        p_maps = stem.stem_conv_pool_plain(x, w, scale, bias, **slope)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(k_maps, p_maps):
            if a.shape != b.shape:
                raise AssertionError(f"stem shape {a.shape} vs {b.shape}")
            a, b = a.float(), b.float()
            diff = (a - b).abs()
            err = max(err, float(diff.max()))
            limit = (STEM_TOL[0] * torch.maximum(a.abs(), b.abs())
                     + STEM_TOL[1])
            if not bool((diff <= limit).all()):
                raise AssertionError(f"stem {geometry} {slope}: max err "
                                     f"{err} beyond one bf16 step")
        return err, k_maps

    err, (k_out, k_pool) = stem_err()
    # relu and linear, where the tree's stem takes a slope (a parent tree
    # timed with this script may not)
    slope_errs = ({s: stem_err(slope=s)[0] for s in (0.0, 1.0)}
                  if geometry == "ntu" and "slope" in inspect.signature(
                      stem.stem_conv_pool).parameters else {})
    wf = (w * scale[:, None, None, None]).to(torch.bfloat16).to(
        memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)
    bb = bias.to(torch.bfloat16)

    def library_stem():
        y = F.leaky_relu(F.conv2d(xc, wf, bb, stride=2, padding=3), 0.2)
        return y, F.max_pool2d(y, 3, 2, 1)

    nbytes = 2 * (x.numel() + k_out.numel() + k_pool.numel()) + 4 * w.numel()
    flops = 2.0 * k_out.numel() * 147
    bnd, by = bound_ms(nbytes, flops)
    run = lambda: stem.stem_conv_pool(x, w, scale, bias)
    # the kernel alone, on weights packed once (the wrapper packs per call)
    launch = getattr(stem, "_launch", None)
    wk, bk = ((stem.pack_weights(w, scale), bias.float().contiguous())
              if launch else (None, None))
    out["stem"] = dict(
        max_abs_err=err, tolerance="|k-p| <= 2^-7 |p| + 1e-4",
        ms=time_ms(run), graph_ms=graph_ms(run),
        kernel_graph_ms=graph_ms(lambda: launch(x, wk, bk)) if launch
        else None,
        plain_ms=time_ms(
            lambda: stem.stem_conv_pool_plain(x, w, scale, bias)),
        library_ms=time_ms(library_stem),
        library_graph_ms=graph_ms(library_stem), bound_ms=bnd, bound_by=by,
        bytes=nbytes, flops=flops, slope_max_abs_errs=slope_errs,
        shapes=dict(x=list(x.shape), out=list(k_out.shape),
                    pooled=list(k_pool.shape)))

    # ---- RoI pool pyramid: skips /2 /4 /8 /16 and the latent /32
    maps, boxes, points, mask = pyramid_inputs(geometry, B, g)
    k_lat, k_sk = roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                            (ph, pw))
    p_lat, p_sk = patches.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                           (ph, pw))
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip([k_lat] + k_sk, [p_lat] + p_sk):
        if a.shape != b.shape:
            raise AssertionError(f"roi shape {a.shape} vs {b.shape}")
        err = max(err, float((a.float() - b.float()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"roi_pool {geometry}: not bitwise equal "
                                 f"(max err {err})")
    nbytes = (roi_read_bytes(maps, boxes, (ph, pw)) + 4 * boxes.numel()
              + sum(2 * o.numel() for o in [k_lat] + k_sk))
    bnd, by = bound_ms(nbytes)
    run = lambda: roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                            (ph, pw))
    before = LAUNCHES["roi_pool"]
    run()
    launches = LAUNCHES["roi_pool"] - before
    out["roi_pool"] = dict(
        max_abs_err=err, tolerance="bitwise",
        ms=time_ms(run), graph_ms=graph_ms(run),
        plain_ms=time_ms(lambda: patches.roi_pool_pyramid(
            maps[-1], maps[:-1], boxes, (ph, pw))),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        launches_per_call=launches,
        shapes=dict(maps=[list(m.shape) for m in maps],
                    out=[list(o.shape) for o in [k_lat] + k_sk]))

    # ---- compose: per-frame thresholds, one negative; masked points; then
    # every real point of a frame within 3 pixels of one spot (the
    # longest culled lists)
    resp = torch.rand((B, K, ph, pw), generator=g, device=dev) \
        * mask[:, :, None, None]
    thr = torch.linspace(-0.3, 0.5, B, device=dev)
    points = points.contiguous()
    spot = torch.rand((B, 1, 2), generator=g, device=dev) * torch.tensor(
        [Wp, Hp], device=dev)
    near = spot + 3 * (2 * torch.rand((B, K, 2), generator=g, device=dev)
                       - 1)
    clustered = torch.cat([near, points[..., 2:]], -1) * mask[..., None]

    def compose_err(pts):
        k_d, k_r = compose.compose_patches(resp, pts, mask, FRAME, (ph, pw),
                                           thr)
        p_d, p_r = patches.compose_patches(resp, pts, mask, FRAME, (ph, pw),
                                           thr)
        torch.cuda.synchronize()
        err = max(float((k_d - p_d).abs().max()),
                  float((k_r - p_r).abs().max()))
        if not (torch.equal(k_d, p_d) and torch.equal(k_r, p_r)):
            raise AssertionError(f"compose {geometry}: not bitwise equal "
                                 f"(max err {err})")
        return err

    def compose_bytes(pts):
        """The responses that land in the frame, the points, masks and
        thresholds read once, the two maps written once."""
        return 4 * (compose_read_elems(pts, mask, FRAME, (ph, pw))
                    + pts.numel() + mask.numel() + B + 2 * B * H * W)

    err, err_clustered = compose_err(points), compose_err(clustered)
    nbytes = compose_bytes(points)
    bnd, by = bound_ms(nbytes)
    run = lambda: compose.compose_patches(resp, points, mask, FRAME,
                                          (ph, pw), thr)
    out["compose"] = dict(
        max_abs_err=max(err, err_clustered), tolerance="bitwise",
        ms=time_ms(run), graph_ms=graph_ms(run),
        plain_ms=time_ms(lambda: patches.compose_patches(
            resp, points, mask, FRAME, (ph, pw), thr)),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        clustered_graph_ms=graph_ms(lambda: compose.compose_patches(
            resp, clustered, mask, FRAME, (ph, pw), thr)),
        clustered_bound_ms=bound_ms(compose_bytes(clustered))[0],
        shapes=dict(responses=list(resp.shape), out=[B, H, W]))
    return out


def build_models(cfg, seed, device, dtype):
    """Full-width RC-Net and SML on seeded random weights.  The SML head's
    last conv is scaled down so the random network regresses scales near
    1, as a trained one does, and depth stays in the metric range."""
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet

    rcnet = init_random_(RCNet(cfg.rcnet, device, dtype), seed)
    return rcnet, build_sml(cfg, seed + 1, device, dtype)


def build_sml(cfg, seed, device, dtype):
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.sml import ScaleMapLearner

    sml = init_random_(ScaleMapLearner(cfg.sml, device, dtype), seed)
    with torch.no_grad():
        sml.output_conv.conv3.weight.mul_(1e-3)
    return sml


def make_batch(seed, B, K, n_real, frame, device):
    """Random frames, a depth field, its inverse-depth mono prior and
    n_real radar returns per frame at distinct pixels."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    H, W = frame
    depth = 5.0 + 50.0 * torch.rand((B, H, W), generator=g, device=device)
    flat = torch.rand((B, H * W), generator=g, device=device).argsort(1)
    flat = flat[:, :K]
    v, u = flat // W, flat % W
    z = depth.reshape(B, -1).gather(1, flat)
    mask = torch.zeros((B, K), device=device)
    mask[:, :n_real] = 1.0
    pts = torch.stack([u.float(), v.float(), z], -1) * mask[..., None]
    return {"image": torch.rand((B, H, W, 3), generator=g, device=device),
            "mono_pred": (1.0 / depth) / 0.05,
            "radar_points": pts, "point_mask": mask}


def drive(preset, B, seed=0):
    """The fused path at full width: three batches with the launch
    counters reset just before, output checks, then timing."""
    import dataclasses
    import torch
    from riders_tpu_torch.core.config import ntu_config, zju_config
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    geo = GEOMETRIES[preset]
    cfg = (ntu_config if preset == "ntu" else zju_config)()
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=FRAME, max_points=geo["bucket"]))
    rcnet, sml = build_models(cfg, seed, None, torch.bfloat16)
    fn = make_fused_fn(cfg, rcnet, sml)
    batches = [make_batch(seed + 10 + i, B, geo["bucket"], geo["real"],
                          FRAME, "cuda") for i in range(3)]
    fn(batches[0])                              # first call: cuDNN set-up
    torch.cuda.synchronize()

    LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = [fn(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for name in ("stem", "roi_pool", "compose"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{preset}: kernel {name} was not launched "
                                 f"on the fused path ({launches})")
    if launches["roi_pool"] != len(batches):
        raise AssertionError(f"{preset}: {launches['roi_pool']} RoI pool "
                             f"launches in {len(batches)} calls, not one "
                             f"pyramid launch per call")
    for d in outs:
        if tuple(d.shape) != (B,) + FRAME:
            raise AssertionError(f"{preset}: depth shape {tuple(d.shape)}")
        if not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{preset}: non-finite depth")
        pos = float((d > 0).float().mean())
        if pos <= 0.95:
            raise AssertionError(f"{preset}: only {pos:.3f} of pixels > 0")
    first = outs[0]
    ms = time_ms(lambda: fn(batches[1]))
    torch.cuda.reset_peak_memory_stats()
    fn(batches[2])
    torch.cuda.synchronize()
    record = dict(
        preset=preset, batch=B, bucket=geo["bucket"],
        real_points=geo["real"], frame=list(FRAME), launches=launches,
        wall_s_3_batches=wall, ms_per_call=ms, fps=B / (ms / 1e3),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        depth_min=float(first.min()), depth_max=float(first.max()),
        depth_median=float(first.median()),
        positive_share=float((first > 0).float().mean()))
    return record, fn, batches[1], rcnet


def reference_agreement(seed=3):
    """The card's bf16 path against the port's f32 CPU path, same seeded
    weights, a small frame at full NTU widths.  bf16 alone moves depth
    by a few percent on these random weights (their SML activations grow
    to ~100), so the bar is the CPU's own bf16-vs-f32 spread: the card's
    median relative error must stay within 1.5x of it plus 0.5%."""
    import dataclasses
    import torch
    from riders_tpu_torch.core.config import ntu_config
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    frame, B, K, n_real = (128, 160), 2, 8, 6
    cfg = ntu_config()
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=frame, max_points=K),
        sml=dataclasses.replace(cfg.sml, net_shape=(96, 128)))
    batch = make_batch(seed, B, K, n_real, frame, "cpu")

    def run(device, dtype):
        models = build_models(cfg, seed, device, dtype)
        return make_fused_fn(cfg, *models, device=device)(batch).cpu()

    ref = run("cpu", torch.float32)

    def median_rel(x):
        return float(((x - ref).abs() / ref.abs().clamp(min=1e-3)).median())

    card = run(None, torch.bfloat16)
    res = dict(frame=list(frame), batch=B,
               card_bf16_vs_cpu_f32=median_rel(card),
               cpu_bf16_vs_cpu_f32=median_rel(run("cpu", torch.bfloat16)))
    if not (res["card_bf16_vs_cpu_f32"]
            <= 1.5 * res["cpu_bf16_vs_cpu_f32"] + 0.005):
        raise AssertionError(f"bf16 card path vs f32 CPU path: {res}")
    return res


def lane_call_shapes(cfg, n):
    """Every B7 / B8 call of one decode_full at the preset's widths and a
    patch batch n, in order: (kernel, (n, h, w) of its input, input
    widths, output width, BN + leaky or linear)."""
    rc = cfg.rcnet
    ph, pw = rc.patch_size
    enc, filters = rc.n_filters_encoder_image, rc.n_filters_decoder
    skips = [(ph >> (i + 1), pw >> (i + 1), enc[i])
             for i in range(len(enc) - 1)]
    (h, w), c = rc.latent_shape, enc[-1] + rc.n_neurons_encoder_depth[-1]
    calls = []
    for i, f in enumerate(filters[:-1]):
        sh, sw, sc = skips[len(skips) - 1 - i]
        if (sh, sw) == (2 * h, 2 * w):
            calls.append(("lane_upconv2x", (n, h, w), (c,), f, True))
        else:
            calls.append(("lane_conv3x3", (n, sh, sw), (c,), f, True))
        calls.append(("lane_conv3x3", (n, sh, sw), (f, sc), f, True))
        h, w, c = sh, sw, f
    f0 = 4 * filters[-1]
    return calls + [("lane_conv3x3", (n, h, w), (c,), f0, True),
                    ("lane_conv3x3", (n, h, w), (f0,), f0, True),
                    ("lane_conv3x3", (n, h, w), (f0,), 4, False)]


def check_lane_kernels(preset, B=16, kinds=("lane_conv3x3",
                                            "lane_upconv2x")):
    """B7 and B8 (those of `kinds`) against their plain versions at every
    call shape of one decode_full of the preset at batch B, with CUDA-
    event times of the kernel, the plain version and cuDNN (bf16 conv of
    the concatenated inputs, or of the nearest x2 map, then BN and leaky);
    B8's also by CUDA-graph replay.  Returns {kernel name: record} summed
    over one decode's calls, per-call records in `calls`."""
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.ops.kernels import lane_decoder as LD

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    cfg = train_config(preset)
    calls = []
    for kind, (n, h, w), cis, co, act in lane_call_shapes(
            cfg, B * GEOMETRIES[preset]["bucket"]):
        if kind not in kinds:
            continue
        xs = [torch.randn((n, h, w, c), generator=g, device=dev).to(
            torch.bfloat16) for c in cis]
        k = torch.randn((3, 3, sum(cis), co), generator=g, device=dev) * (
            2.0 / (9 * sum(cis))) ** 0.5
        scale, bias = ((0.5 + torch.rand(co, generator=g, device=dev),
                        0.1 * torch.randn(co, generator=g, device=dev))
                       if act else (None, None))
        slope = 0.2 if act else None
        kc = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        xc = [x.permute(0, 3, 1, 2) for x in xs]
        sb = (None if scale is None else
              (scale.to(torch.bfloat16)[:, None, None],
               bias.to(torch.bfloat16)[:, None, None]))
        if kind == "lane_upconv2x":
            wts = LD.pack_upconv(k)
            run = lambda: LD.lane_upconv2x(xs[0], wts, scale, bias, slope)
            plain = lambda: LD.lane_upconv2x_plain(xs[0], wts, scale, bias,
                                                   slope)
            lib_in = lambda: F.interpolate(xc[0], scale_factor=2,
                                           mode="nearest")
            # four phases, each 2x2 nonzero coarse taps
            flops = 2.0 * n * h * w * 4 * co * 4 * cis[0]
            out_elems = n * 4 * h * w * co
        else:
            wts = [LD.pack_conv(k[:, :, sum(cis[:i]):sum(cis[:i + 1])])
                   for i in range(len(cis))]
            run = lambda: LD.lane_conv3x3(xs, wts, scale, bias, slope)
            plain = lambda: LD.lane_conv3x3_plain(xs, wts, scale, bias,
                                                  slope)
            lib_in = lambda: xc[0] if len(xc) == 1 else torch.cat(xc, 1)
            flops = 2.0 * n * h * w * co * 9 * sum(cis)
            out_elems = n * h * w * co

        def library():
            y = F.conv2d(lib_in(), kc, padding=1)
            if sb is not None:
                y = F.leaky_relu(y * sb[0] + sb[1], 0.2)
            return y

        got, want = run(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{kind} {preset}: shape {got.shape} vs "
                                 f"{want.shape}")
        a, p = got.float(), want.float()
        diff = (a - p).abs()
        if not bool((diff <= LANE_TOL[0] * p.abs()
                     + LANE_TOL[1] * p.abs().max()).all()):
            raise AssertionError(f"{kind} {preset} {(n, h, w)} {cis}->{co}: "
                                 f"max err {float(diff.max())} beyond one "
                                 f"bf16 step")
        nbytes = 2 * (sum(x.numel() for x in xs) + out_elems + k.numel()) \
            + (8 * co if act else 0)
        bnd, by = bound_ms(nbytes, flops)
        ms, lib_ms = time_ms(run, n=10, warmup=2), time_ms(library, n=10,
                                                            warmup=2)
        dev_ms, lib_dev_ms = device_ms(run), device_ms(library)
        graphs = (dict(graph_ms=graph_ms(run),
                       library_graph_ms=graph_ms(library))
                  if kind == "lane_upconv2x" else {})
        calls.append(dict(**graphs,
            kernel=kind, input=[n, h, w], widths=list(cis), out=co,
            max_abs_err=float(diff.max()), ms=ms,
            plain_ms=time_ms(plain, n=3, warmup=1),
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, bound_ms=bnd,
            bound_by=by, bytes=nbytes, flops=flops,
            tflop_per_s=flops / ms / 1e9,
            t_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            t_ops_ms=flops / BF16_FLOP_PER_S * 1e3))
        widths = "+".join(map(str, cis))
        log(f"lane call [{preset}] {kind} {n}x{h}x{w} {widths}->{co}: "
            f"kernel {ms:.4f} ms cuDNN {lib_ms:.4f} ms "
            f"({lib_ms / ms:.2f}x) bound {bnd:.4f} ms ({by}) "
            f"{flops / ms / 1e9:.1f} TFLOP/s; back to back: kernel "
            f"{dev_ms:.4f} ms cuDNN {lib_dev_ms:.4f} ms "
            f"({lib_dev_ms / dev_ms:.2f}x)"
            + (f"; graph: kernel {graphs['graph_ms']:.4f} ms cuDNN "
               f"{graphs['library_graph_ms']:.4f} ms" if graphs else ""))
        del xs, xc, got, want, a, p, diff
    out = {}
    for kind in kinds:
        mine = [c for c in calls if c["kernel"] == kind]
        total = lambda key: sum(c[key] for c in mine)
        graphs = (dict(graph_ms=total("graph_ms"),
                       library_graph_ms=total("library_graph_ms"))
                  if kind == "lane_upconv2x" else {})
        out[kind] = dict(**graphs,
            max_abs_err=max(c["max_abs_err"] for c in mine),
            tolerance="|k-p| <= 2^-7 |p| + 1e-3 max|p|",
            ms=total("ms"), plain_ms=total("plain_ms"),
            library_ms=total("library_ms"), device_ms=total("device_ms"),
            library_device_ms=total("library_device_ms"),
            bound_ms=total("bound_ms"),
            bound_by=("operations" if total("t_ops_ms") >= total("t_bytes_ms")
                      else "bytes"),
            calls_per_decode=len(mine), calls=mine)
    return out


def capture_path_inputs(fn, rcnet, batch):
    """One fused call with hooks: the decoder's inputs (x, skips), and the
    encoder's maps as NHWC (skips shallow to deep, then the latent)."""
    got = {}

    def decoder_inputs(module, args):
        got["decoder"] = (args[0].clone(), [s.clone() for s in args[1]])

    def encoder_maps(module, args, out):
        latent, skips = out
        got["maps"] = [t.permute(0, 2, 3, 1).contiguous()
                       for t in list(skips) + [latent]]

    hooks = [rcnet.decoder.register_forward_pre_hook(decoder_inputs),
             rcnet.encoder_image.register_forward_hook(encoder_maps)]
    try:
        fn(batch)
    finally:
        for h in hooks:
            h.remove()
    return got


def drive_lane_decoder(preset, x, skips, literal):
    """The captured decoder inputs through the literal decoder and its
    lane_mode "full" and "tail" copies (same weights): each lane output
    within LANE_DECODE_BAR of the literal's max, the path's kernels
    launched (counters reset just before each decode), ms per decode."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES

    need = {"full": ("lane_conv3x3", "lane_upconv2x"),
            "tail": ("lane_conv3x3",)}
    rec = dict(preset=preset, patches=int(x.shape[0]))
    lanes = {mode: copy.deepcopy(literal) for mode in need}
    with torch.inference_mode():
        want = literal(x, skips).float()
        rec["literal_ms"] = time_ms(lambda: literal(x, skips), n=10,
                                    warmup=2)
        for mode, dec in lanes.items():
            dec.lane_mode = mode
            dec(x, skips)                                  # packs weights
            torch.cuda.synchronize()
            LAUNCHES.clear()
            out = dec(x, skips)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            for k in need[mode]:
                if launches.get(k, 0) <= 0:
                    raise AssertionError(f"{preset} {mode}: kernel {k} was "
                                         f"not launched ({launches})")
            if out.shape != want.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{preset} {mode}: output {out.shape} "
                                     f"vs {want.shape}, or not finite")
            rel = float((out.float() - want).abs().max()
                        / want.abs().max())
            if rel > LANE_DECODE_BAR:
                raise AssertionError(f"{preset} {mode}: max |lane - literal|"
                                     f" / max|literal| = {rel}")
            rec[mode] = dict(launches=launches, rel_err=rel, ms=time_ms(
                lambda: dec(x, skips), n=10, warmup=2))
    return rec


def check_roi_4d(preset, maps, boxes, patch):
    """B6: the 4D pyramid on the fused call's encoder maps, skip1 as a
    NEG-padded canvas read over its true extent, bitwise equal to the B2
    pyramid and to the plain one; launches counted on one pyramid."""
    import torch
    from riders_tpu_torch.ops import patches
    from riders_tpu_torch.ops.kernels import LAUNCHES, roi_pool

    s1 = maps[0]
    B, H, W, C = s1.shape
    lat, sks = maps[-1], maps[:-1]
    with torch.inference_mode():
        canvas = torch.full((B, H + CANVAS_PAD[0], W + CANVAS_PAD[1], C),
                            roi_pool.NEG, dtype=s1.dtype, device=s1.device)
        canvas[:, :H, :W] = s1
        run = lambda: roi_pool.roi_pool_pyramid_4d(
            lat, [canvas] + sks[1:], boxes, patch, (H, W))
        plain = lambda: patches.roi_pool_pyramid(
            lat, [canvas[:, :H, :W]] + sks[1:], boxes, patch)
        b2 = lambda: roi_pool.roi_pool_pyramid(lat, sks, boxes, patch)
        LAUNCHES.clear()
        k_lat, k_sk = run()
        torch.cuda.synchronize()
        launches = LAUNCHES.get("roi_pool_4d", 0)
        if launches <= 0:
            raise AssertionError(f"roi_pool_4d {preset}: not launched")
        on_map = roi_pool.roi_pool_pyramid_4d(lat, sks, boxes, patch)
        err = 0.0
        for want in (plain(), b2(), on_map):
            for a, b in zip([k_lat] + k_sk, [want[0]] + want[1]):
                err = max(err, float((a.float() - b.float()).abs().max()))
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"roi_pool_4d {preset}: not bitwise"
                                         f" equal (max err {err})")
        nbytes = (roi_read_bytes(maps, boxes, patch) + 4 * boxes.numel()
                  + sum(2 * o.numel() for o in [k_lat] + k_sk))
        bnd, by = bound_ms(nbytes)
        return dict(max_abs_err=err, tolerance="bitwise", ms=time_ms(run),
                    graph_ms=graph_ms(run),
                    plain_ms=time_ms(plain, n=5, warmup=1), library_ms=None,
                    b2_ms=time_ms(b2), b2_graph_ms=graph_ms(b2),
                    bound_ms=bnd, bound_by=by,
                    bytes=nbytes, launches_per_call=launches,
                    canvas=list(canvas.shape),
                    maps=[list(m.shape) for m in maps])


def lane_phase(runs):
    """Phase 4b for each preset's (fused fn, rcnet): the kernels at the
    decode's shapes, then the decoders and B6 on a captured B=16 call."""
    import torch
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)

    kernels, decoders = {}, {}
    for preset, (fn, rcnet) in runs.items():
        geo = GEOMETRIES[preset]
        kernels[preset] = check_lane_kernels(preset)
        batch = make_batch(40, 16, geo["bucket"], geo["real"], FRAME, "cuda")
        cap = capture_path_inputs(fn, rcnet, batch)
        decoders[preset] = drive_lane_decoder(preset, *cap["decoder"],
                                              rcnet.decoder)
        full = decoders[preset]["full"]["launches"]
        for kind, rec in kernels[preset].items():
            if full.get(kind, 0) != rec["calls_per_decode"]:
                raise AssertionError(f"{preset}: decode_full launched {kind} "
                                     f"{full.get(kind, 0)} times, the shape "
                                     f"list has {rec['calls_per_decode']}")
        _, boxes = shift_points_and_boxes(batch["radar_points"], geo["patch"])
        kernels[preset]["roi_pool_4d"] = check_roi_4d(
            preset, cap["maps"], boxes.contiguous(), geo["patch"])
        n = kernels[preset]["roi_pool_4d"]["launches_per_call"]
        if n != 1:
            raise AssertionError(f"{preset}: the 4D pyramid took {n} "
                                 f"launches, not one")
        del cap
        torch.cuda.empty_cache()
    return kernels, decoders


def train_config(preset, **overrides):
    from riders_tpu_torch.core.config import ntu_config, zju_config
    return (ntu_config if preset == "ntu" else zju_config)(**overrides)


def smooth_depth(g, B, frame, device):
    """A depth field in [5, 55] m, smooth over ~32 pixels, so a patch
    holds pixels near its point's depth (positives) and far from it."""
    import torch
    import torch.nn.functional as F
    H, W = frame
    coarse = torch.rand((B, 1, -(-H // 32) + 1, -(-W // 32) + 1),
                        generator=g, device=device)
    return 5.0 + 50.0 * F.interpolate(coarse, size=(H, W), mode="bilinear",
                                      align_corners=False)[:, 0]


def make_rcnet_train_batch(cfg, seed, device, B=None):
    """A training batch as RCNetTrainDataset builds it: the frame edge-
    padded by half a patch, points_per_frame radar points per frame at
    integer pixels with their depth (+-0.3 m), shifted to padded
    coordinates, their boxes, and zero-padded crops of a GT depth field
    with half its pixels missing.  Every slot is real (mask 1)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    H, W = cfg.dataset.image_shape
    B = B or cfg.rcnet_train.batch_size
    K = cfg.rcnet_train.points_per_frame
    ph, pw = cfg.rcnet.patch_size
    py, px = ph // 2, pw // 2
    image = torch.rand((B, 3, H, W), generator=g, device=device)
    image = F.pad(image, (px, px, py, py), mode="replicate")
    depth = smooth_depth(g, B, (H, W), device)
    gt = depth * (torch.rand((B, H, W), generator=g, device=device) > 0.5)
    u = torch.randint(0, W, (B, K), generator=g, device=device)
    v = torch.randint(0, H, (B, K), generator=g, device=device)
    bi = torch.arange(B, device=device)[:, None]
    z = depth[bi, v, u] + 0.3 * torch.randn((B, K), generator=g,
                                            device=device)
    gt_pad = F.pad(gt, (px, px, py, py))
    rows = (v[..., None] + torch.arange(ph, device=device))[..., :, None]
    cols = (u[..., None] + torch.arange(pw, device=device))[..., None, :]
    crops = gt_pad[bi[..., None, None], rows, cols][..., None]
    u, v = u.float(), v.float()
    return {"image": image.permute(0, 2, 3, 1).contiguous(),
            "points": torch.stack([u + px, v + py, z], -1),
            "boxes": torch.stack([u, v, u + 2 * px, v + 2 * py], -1),
            "gt_crops": crops.contiguous(),
            "point_mask": torch.ones((B, K), device=device)}


def make_sml_train_batch(cfg, seed, device, B=None, n_radar=40):
    """An SML training batch of full frames: image in [0, 1], the mono
    inverse-depth prior with 10% noise, n_radar radar returns, sparse
    lidar GT on 5% of the pixels, interpolated GT with 30% holes and the
    quasi-dense RC-Net depth on 30% of the pixels."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    H, W = cfg.dataset.image_shape
    B = B or cfg.sml_train.batch_size
    depth = smooth_depth(g, B, (H, W), device)

    def rand():
        return torch.rand((B, H, W), generator=g, device=device)

    radar = torch.zeros((B, H * W), device=device)
    idx = torch.rand((B, H * W), generator=g, device=device).argsort(1)
    idx = idx[:, :n_radar]
    radar.scatter_(1, idx, depth.reshape(B, -1).gather(1, idx))
    return {"image": torch.rand((B, H, W, 3), generator=g, device=device),
            "mono_pred": (1.0 / depth) / 0.05 * (0.9 + 0.2 * rand()),
            "radar": radar.reshape(B, H, W),
            "gt_sparse": depth * (rand() < 0.05),
            "gt_interp": depth * (rand() > 0.3),
            "rcnet": depth * (rand() < 0.3)}


def check_training_kernels(preset):
    """The RoI pool's f32 forward (bitwise) and its backward kernel (B5,
    within 1e-6 relative of the plain version summed in f64; two
    launches bitwise equal) at the preset's training shape: its frame,
    patch, batch and points per frame, f32 maps at the RC-Net widths.
    Returns {kernel name: record}, times over the five scales of one
    training step."""
    import torch
    from riders_tpu_torch.ops import patches
    from riders_tpu_torch.ops.kernels import roi_pool

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    cfg = train_config(preset)
    ph, pw = cfg.rcnet.patch_size
    H, W = cfg.dataset.image_shape
    batch = make_rcnet_train_batch(cfg, 8, dev)
    boxes = batch["boxes"].contiguous()
    maps, h, w_ = [], H + 2 * (ph // 2), W + 2 * (pw // 2)
    for c in cfg.rcnet.n_filters_encoder_image:
        h, w_ = -(-h // 2), -(-w_ // 2)
        maps.append(torch.randn((boxes.shape[0], h, w_, c), generator=g,
                                device=dev))
    scales = [1.0 / 2 ** (i + 1) for i in range(len(maps))]
    sizes = [(ph >> (i + 1), pw >> (i + 1)) for i in range(len(maps))]
    out = {}

    # ---- f32 forward: the five scales of the training pyramid
    with torch.no_grad():
        k_lat, k_sk = roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                                (ph, pw))
    p_lat, p_sk = patches.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                           (ph, pw))
    torch.cuda.synchronize()
    pooled = k_sk + [k_lat]                      # in the order of `maps`
    err = 0.0
    for a, b in zip(pooled, p_sk + [p_lat]):
        err = max(err, float((a - b).abs().max()))
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"roi_pool f32 {preset}: not bitwise "
                                 f"equal (max err {err})")
    read = roi_read_bytes(maps, boxes, (ph, pw))
    pooled_bytes = sum(4 * o.numel() for o in pooled)
    nbytes = read + 4 * boxes.numel() + pooled_bytes
    bnd, by = bound_ms(nbytes)

    def kernel_forward():
        with torch.no_grad():
            return roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                             (ph, pw))

    out["roi_pool_f32"] = dict(
        max_abs_err=err, tolerance="bitwise", ms=time_ms(kernel_forward),
        graph_ms=graph_ms(kernel_forward),
        plain_ms=time_ms(lambda: patches.roi_pool_pyramid(
            maps[-1], maps[:-1], boxes, (ph, pw))),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        launches_per_step=len(maps),
        shapes=dict(maps=[list(m.shape) for m in maps],
                    out=[list(o.shape) for o in pooled]))

    # ---- backward (B5): d(feature) of every scale from random cotangents
    grads = [torch.randn(o.shape, generator=g, device=dev) for o in pooled]
    err, rel = 0.0, 0.0
    for m, b_out, gr, s in zip(maps, pooled, grads, scales):
        got = roi_pool.roi_max_pool_backward(m, boxes, b_out, gr, s)
        again = roi_pool.roi_max_pool_backward(m, boxes, b_out, gr, s)
        want = patches.roi_max_pool_backward(m, boxes, b_out, gr.double(), s)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"roi_pool_bwd {preset}: two launches "
                                 f"differ")
        diff = (got.double() - want).abs()
        err = max(err, float(diff.max()))
        rel = max(rel, float((diff / (want.abs() + 1.0)).max()))
        if not bool((diff <= 1e-6 * want.abs() + 1e-6).all()):
            raise AssertionError(f"roi_pool_bwd {preset} scale {s}: max err "
                                 f"{float(diff.max())} beyond 1e-6 |p| + 1e-6")
        del got, again, want, diff
    nbytes = (read + 4 * boxes.numel() + 2 * pooled_bytes
              + sum(4 * m.numel() for m in maps))
    bnd, by = bound_ms(nbytes)

    def backward(fn):
        return [fn(m, boxes, b_out, gr, s)
                for m, b_out, gr, s in zip(maps, pooled, grads, scales)]

    out["roi_pool_bwd"] = dict(
        empty_tile_share=bwd_empty_tiles(maps, boxes, scales),
        max_abs_err=err, max_err_over_1_plus_abs=rel,
        tolerance="|k-p| <= 1e-6 |p| + 1e-6, p the plain version summed "
                  "in f64; two launches bitwise equal",
        ms=time_ms(lambda: backward(roi_pool.roi_max_pool_backward)),
        device_ms=device_ms(
            lambda: backward(roi_pool.roi_max_pool_backward)),
        plain_ms=time_ms(lambda: backward(patches.roi_max_pool_backward),
                         n=5, warmup=1),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        launches_per_step=len(maps),
        shapes=dict(maps=[list(m.shape) for m in maps],
                    grads=[list(o.shape) for o in grads]))
    return out


def bwd_empty_tiles(maps, boxes, scales):
    """Per map, the share of the backward kernel's (frame, tile) blocks
    that no box meets (they only write zeros)."""
    import torch
    from riders_tpu_torch.ops.kernels import roi_pool
    shares = []
    for m, s in zip(maps, scales):
        B, H, W, C = m.shape
        th, tw, _ = roi_pool.bwd_tiles(W, C)
        empty = torch.zeros((), dtype=torch.long, device=m.device)
        n = 0
        for r in range(0, H, th):
            for c in range(0, W, tw):
                hit = roi_pool.bwd_tile_boxes(
                    boxes, s, H, W, (r, min(r + th, H)),
                    (c, min(c + tw, W))).any(1)
                empty += (~hit).sum()
                n += B
        shares.append(int(empty) / n)
    return shares


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _train_phase(name, state, step, batches, need, B, check_grads=True):
    """Three steps with the launch counters reset just before: finite
    loss and aux, every kernel in `need` launched, every parameter
    moved and (with `check_grads`) at most a tenth of them without a
    gradient in the last step; then the median CUDA-event time of a step
    and its peak memory."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    step(state, batches[0])                     # first call: cuDNN set-up
    torch.cuda.synchronize()
    before = _params(state.model)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    auxes = [step(state, b)[1] for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for k in need:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched on "
                                 f"the training path ({launches})")
    aux = [{k: float(v) for k, v in a.items()} for a in auxes]
    for a in aux:
        bad = [k for k, v in a.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"{name}: non-finite {bad}: {a}")
    after = _params(state.model)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    no_grad = [k for k, g in grads.items() if g is None or not bool(g.any())]
    still = [k for k in before if k not in no_grad
             and torch.equal(before[k], after[k])]
    if still or (check_grads and len(no_grad) * 10 > len(before)):
        raise AssertionError(f"{name}: {len(still)} of {len(before)} "
                             f"parameters did not move: {still[:8]}; "
                             f"{len(no_grad)} have no gradient: "
                             f"{no_grad[:8]}")
    ms = time_ms(lambda: step(state, batches[1]), n=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[2])
    torch.cuda.synchronize()
    return dict(batch=B, launches=launches, wall_s_3_steps=wall, aux=aux,
                ms_per_step=ms, frames_per_s=B / (ms / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                step=state.step, n_params=len(before),
                no_gradient=no_grad)


def drive_training(seed=0, profile_dir=None):
    """Both training steps at full published widths on seeded random
    weights: RC-Net at the NTU preset (512x640 frames, 150x50 patches,
    batch 24, 40 points), then SML at the NTU net shape 288x352 and
    batch 12; then a checkpoint round trip of the SML state.  With
    `profile_dir`, one more step of each under torch.profiler."""
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines import rcnet_training, sml_training

    cfg = train_config("ntu")
    model = init_random_(RCNet(cfg.rcnet, None, torch.float32), seed)
    state = rcnet_training.init_rcnet_train_state(cfg, model, 1000)
    batches = [make_rcnet_train_batch(cfg, seed + 20 + i, "cuda")
               for i in range(3)]
    step = rcnet_training.make_rcnet_train_step(cfg)
    rcnet = _train_phase("rcnet", state, step, batches,
                         ("roi_pool_f32", "roi_pool_bwd"),
                         cfg.rcnet_train.batch_size)
    if profile_dir is not None:
        log(profile(lambda b: step(state, b), batches[1],
                    profile_dir / "profile_rcnet_train.txt"))
    rcnet.update(patch=list(cfg.rcnet.patch_size),
                 frame=list(cfg.dataset.image_shape),
                 points=cfg.rcnet_train.points_per_frame)
    del state, model, batches
    torch.cuda.empty_cache()

    def sml_state(s):
        return sml_training.init_train_state(
            cfg, build_sml(cfg, s, None, torch.float32), 1000)

    state = sml_state(seed)
    batches = [make_sml_train_batch(cfg, seed + 30 + i, "cuda")
               for i in range(3)]
    step = sml_training.make_train_step(cfg)
    sml = _train_phase("sml", state, step, batches, (),
                       cfg.sml_train.batch_size)
    if profile_dir is not None:
        log(profile(lambda b: step(state, b), batches[1],
                    profile_dir / "profile_sml_train.txt"))
    sml.update(net_shape=list(cfg.sml.net_shape),
               frame=list(cfg.dataset.image_shape))
    return dict(rcnet=rcnet, sml=sml,
                checkpoint=checkpoint_round_trip(state, sml_state(seed + 5)))


def checkpoint_round_trip(state, template):
    """save_train_state -> restore_train_state into a template state with
    other weights; every model and optimizer tensor and the step must
    come back equal."""
    import shutil
    import torch
    from riders_tpu_torch.core import checkpoint

    root = HERE / "chiprun_out" / "checkpoint_smoke"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = checkpoint.save_train_state(root, state)
        save_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in path.iterdir())
        t0 = time.perf_counter()
        restored = checkpoint.restore_train_state(root, template)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if restored.step != state.step:
        raise AssertionError(f"checkpoint step {restored.step} != "
                             f"{state.step}")
    want, got = state.model.state_dict(), restored.model.state_dict()
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    o_want = state.optimizer.state_dict()["state"]
    o_got = restored.optimizer.state_dict()["state"]
    bad += [f"optimizer {i}.{k}" for i in o_want for k in o_want[i]
            if not torch.equal(torch.as_tensor(o_want[i][k]).cpu(),
                               torch.as_tensor(o_got[i][k]).cpu())
            or torch.as_tensor(o_want[i][k]).device
            != torch.as_tensor(o_got[i][k]).device]
    if bad or len(o_got) != len(o_want):
        raise AssertionError(f"checkpoint round trip differs: {bad[:8]}")
    return dict(step=restored.step, bytes=size, save_s=save_s,
                restore_s=restore_s, tensors=len(want) + len(o_want))


def training_agreement(seed=5):
    """One RC-Net training step on the card in f32 against the port's f32
    CPU step: the same seeded weights at full NTU widths, a small frame,
    B=2 with 4 points.  The loss to rtol 1e-4.  Each gradient's max abs
    error, relative to its max abs, within 1e-3, or within 3x the CPU's
    own spread for that tensor: the largest change of the CPU's gradient
    when a random half of the input pixels moves by one f32 ulp (two
    draws).  At random initialisation the train-mode network is that
    sensitive: such a nudge moves some of the CPU's own gradients by
    several percent.  The padded frame is random everywhere, not edge-
    padded: edge padding makes exactly tied maxima in the border, where
    the RoI backward sends each tied element the full cotangent, so any
    rounding that breaks a tie moves a gradient by whole cotangents."""
    import dataclasses
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines import rcnet_training

    cfg = train_config("ntu")
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=(96, 128)),
        rcnet_train=dataclasses.replace(cfg.rcnet_train, points_per_frame=4))
    batch = make_rcnet_train_batch(cfg, seed, "cpu", B=2)
    image = torch.rand(batch["image"].shape,
                       generator=torch.Generator().manual_seed(seed))
    step = rcnet_training.make_rcnet_train_step(cfg)

    def run(device, img):
        model = init_random_(RCNet(cfg.rcnet, device, torch.float32), seed)
        state = rcnet_training.init_rcnet_train_state(cfg, model, 1000)
        _, aux = step(state, dict(batch, image=img))
        return float(aux["loss"]), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def nudged(s):
        pick = torch.rand(image.shape,
                          generator=torch.Generator().manual_seed(s)) < 0.5
        return torch.where(pick, torch.nextafter(
            image, torch.full_like(image, 2.0)), image)

    def rel_errs(g, ref):
        return {k: float((g[k] - r).abs().max())
                / max(float(r.abs().max()), 1e-30) for k, r in ref.items()}

    loss_cpu, g_cpu = run("cpu", image)
    loss_card, g_card = run(None, image)
    card = rel_errs(g_card, g_cpu)
    spread = {k: 0.0 for k in g_cpu}
    for s in (1, 2):
        for k, e in rel_errs(run("cpu", nudged(s))[1], g_cpu).items():
            spread[k] = max(spread[k], e)
    bad = [k for k in card if card[k] > max(1e-3, 3 * spread[k])]
    worst = max(card, key=card.get)
    res = dict(loss_cpu=loss_cpu, loss_card=loss_card,
               loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
               worst_grad_rel_err=card[worst], worst_grad=worst,
               cpu_spread_there=spread[worst],
               worst_cpu_spread=max(spread.values()),
               grads_over_1e3=sum(e > 1e-3 for e in card.values()),
               cpu_spreads_over_1e3=sum(e > 1e-3 for e in spread.values()),
               median_grad_rel_err=sorted(card.values())[len(card) // 2],
               n_grads=len(g_cpu), failing=bad)
    if res["loss_rel_err"] > 1e-4 or bad:
        raise AssertionError(f"card vs CPU training step: {res}")
    return res


def ntu_staged_config():
    """The NTU preset at the benchmark frame with the fused path's
    48-point bucket."""
    import dataclasses
    from riders_tpu_torch.core.config import ntu_config
    cfg = ntu_config()
    return cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=FRAME,
        max_points=GEOMETRIES["ntu"]["bucket"]))


def staged_rcnet(B=16, seed=0):
    """Phase 8a: staged RC-Net (make_rcnet_infer_fn) at the NTU preset,
    bf16, its threshold set between the frames' maximum responses so
    that about half the frames retry and the others do not; launch
    counts of one
    call, its outputs bitwise against the port's retry loop fed the same
    card responses through the plain composition."""
    import dataclasses
    import torch
    from riders_tpu_torch.ops import patches
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.ops.resize import edge_pad2d
    from riders_tpu_torch.pipelines.rcnet_inference import (
        make_rcnet_infer_fn, shift_points_and_boxes)

    geo = GEOMETRIES["ntu"]
    cfg = ntu_staged_config()
    rcnet, _ = build_models(cfg, seed, None, torch.bfloat16)
    raw = make_batch(seed + 20, B, geo["bucket"], geo["real"], FRAME,
                     "cuda")
    ph, pw = cfg.rcnet.patch_size
    batch = {"image": edge_pad2d(raw["image"], ph // 2, pw // 2),
             "points": raw["radar_points"], "point_mask": raw["point_mask"]}

    def with_threshold(thr):
        return cfg.replace(rcnet=dataclasses.replace(
            cfg.rcnet, response_threshold=thr))

    # Random weights saturate the sigmoid (every frame's maximum response
    # is 1); the last conv, linear and without bias, is scaled so that
    # the largest logit of a real point is 3, as a trained head's are.
    points, boxes = shift_points_and_boxes(batch["points"], (ph, pw))
    with torch.inference_mode():
        logits = rcnet(batch["image"], points, boxes, batch["point_mask"])
    top_logit = float(logits[batch["point_mask"] > 0].float().abs().max())
    with torch.no_grad():
        rcnet.decoder.output0.conv.weight.mul_(3.0 / top_logit)
    # the frames' maximum responses, from a call at threshold 0; the
    # threshold splits them at the gap nearest their median
    probe = make_rcnet_infer_fn(with_threshold(0.0), rcnet)(batch)
    tops = probe["response"].reshape(B, -1).amax(1).sort().values
    gaps = [i for i in range(B - 1) if tops[i + 1] > tops[i]]
    split = min(gaps, key=lambda i: abs(i + 1 - B // 2)) if gaps else 0
    thr0 = float(0.5 * (tops[split] + tops[split + 1]))
    if not float(tops[split + 1]) > thr0 > float(tops[split]):
        raise AssertionError(f"staged rcnet: no threshold splits the "
                             f"frames' maximum responses {tops.tolist()}")
    cfg = with_threshold(thr0)
    fn = make_rcnet_infer_fn(cfg, rcnet)

    captured = []
    hook = rcnet.register_forward_hook(lambda m, i, o: captured.append(o))
    LAUNCHES.clear()
    out = fn(batch)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    hook.remove()
    retries = out["retries"].tolist()
    rounds = max(retries)
    if not (launches.get("stem", 0) >= 1 and launches.get("roi_pool") == 1
            and launches.get("compose") == 1 + rounds):
        raise AssertionError(f"staged rcnet: launches {launches} for "
                             f"{rounds} retry rounds")
    if not (min(retries) == 0 < rounds):
        raise AssertionError(f"staged rcnet: retries {retries}: not some "
                             f"frames retrying and some not")
    resp = captured[0][..., 0].float().contiguous()
    rc = cfg.rcnet
    plain = patches.adaptive_compose(
        resp, points.contiguous(), batch["point_mask"].contiguous(), FRAME,
        rc.patch_size, rc.response_threshold, rc.threshold_decay,
        rc.max_threshold_retries, compose=patches.compose_patches)
    for name, want in zip(("depth", "response", "threshold", "retries"),
                          plain):
        if not torch.equal(out[name], want):
            diff = float((out[name].float() - want.float()).abs().max())
            raise AssertionError(f"staged rcnet: {name} differs from the "
                                 f"plain composition's by {diff}")
    depth = out["depth"]
    if not bool(torch.isfinite(depth).all()) or float(depth.max()) <= 0:
        raise AssertionError("staged rcnet: depth not finite or all zero")
    ms = time_ms(lambda: fn(batch), n=10)
    hist = {str(k): retries.count(k) for k in sorted(set(retries))}
    record = dict(batch=B, bucket=geo["bucket"], real_points=geo["real"],
                  head_scale=3.0 / top_logit, threshold0=thr0,
                  frame_max_responses=tops.tolist(),
                  retries=retries, retry_histogram=hist, launches=launches,
                  final_thresholds=out["threshold"].tolist(),
                  positive_share=float((depth > 0).float().mean()),
                  bitwise_vs_plain=True, ms_per_call=ms,
                  frames_per_s=B / (ms / 1e3))
    return record, raw, depth


def staged_sml(raw, rcnet_depth, seed=0):
    """Phase 8b: staged SML (make_infer_fn) at the NTU preset (288x352
    net), bf16, B frames, on phase 8a's frames and quasi-dense depth and
    a synthetic sparse GT; its metrics against the port's metrics of the
    same depth on the CPU."""
    import torch
    from riders_tpu_torch.core.metrics import compute_depth_metrics
    from riders_tpu_torch.pipelines.fused import _scatter_points
    from riders_tpu_torch.pipelines.sml_inference import make_infer_fn

    cfg = ntu_staged_config()
    B = raw["image"].shape[0]
    sml = build_sml(cfg, seed + 1, None, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    depth_field = 1.0 / (raw["mono_pred"] * 0.05)
    gt = torch.where(torch.rand(depth_field.shape, generator=g,
                                device="cuda") < 0.01, depth_field,
                     torch.zeros_like(depth_field))
    batch = {"image": raw["image"], "mono_pred": raw["mono_pred"],
             "radar": _scatter_points(raw["radar_points"],
                                      raw["point_mask"], FRAME),
             "rcnet": rcnet_depth, "gt_sparse": gt}
    fn = make_infer_fn(cfg, sml)
    out = fn(batch)
    ev = cfg.eval
    ref = compute_depth_metrics(out["depth"].cpu(), gt.cpu(),
                                ev.min_depth_val, ev.max_depth_val,
                                ev.delta_threshold)
    worst = 0.0
    for k, v in ref.items():
        got = out["metrics"][k].cpu()
        if not torch.allclose(got, v, rtol=1e-5, atol=0):
            raise AssertionError(f"staged sml: metric {k} on the card "
                                 f"{got.tolist()} vs the CPU {v.tolist()}")
        worst = max(worst, float(((got - v).abs() / v.abs().clamp(
            min=1e-12)).max()))
    d = out["depth"]
    if tuple(d.shape) != (B,) + FRAME or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"staged sml: depth {tuple(d.shape)} or "
                             f"non-finite")
    ms = time_ms(lambda: fn(batch), n=10)
    means = {k: float(v.mean()) for k, v in out["metrics"].items()}
    return dict(batch=B, net=list(cfg.sml.net_shape), ms_per_call=ms,
                frames_per_s=B / (ms / 1e3), metric_max_rel_err=worst,
                metrics=means)


def served(ntu_fn, n_batches=6, B=16, seed=0):
    """Phase 8c: FusedServer(depth=2) over compact NTU batches (uint8
    image, uint16 mono) against direct calls of the same fused function,
    bitwise; the uploader joined after a full run and after an early
    close; served, sequential and device-resident frames/s."""
    import numpy as np
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.serving import FusedServer

    geo = GEOMETRIES["ntu"]
    batches = []
    for i in range(n_batches):
        b = make_batch(seed + 40 + i, B, geo["bucket"], geo["real"], FRAME,
                       "cpu")
        batches.append({
            "image": (b["image"] * 255).round().to(torch.uint8).numpy(),
            "mono_pred": (b["mono_pred"] * 256).numpy().astype(np.uint16),
            "radar_points": b["radar_points"].numpy(),
            "point_mask": b["point_mask"].numpy()})
    direct = [ntu_fn(b).cpu().numpy() for b in batches]
    server = FusedServer(ntu_fn, depth=2)
    list(server.run(iter(batches[:2])))                 # warm
    LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = list(server.run(iter(batches)))
    served_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if server.uploader.is_alive():
        raise AssertionError("served: the uploader outlived its run")
    if not (launches.get("roi_pool") == n_batches
            and launches.get("compose") == n_batches
            and launches.get("stem", 0) >= n_batches):
        raise AssertionError(f"served: launches {launches} for "
                             f"{n_batches} batches")
    diffs = [float(np.abs(a - b).max()) for a, b in zip(outs, direct)]
    if len(outs) != n_batches or max(diffs) != 0.0:
        raise AssertionError(f"served: {len(outs)} outputs, max abs "
                             f"difference to direct calls {diffs}")
    # Host-clock seconds of the served run, the sequential loop, and the
    # calls on batches already on the card (a yardstick of the call
    # alone), three each in turns: the call is host-bound and its time
    # spreads by +-15% from run to run.
    resident = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
                for b in batches]
    loops = {
        "served": lambda: list(server.run(iter(batches))),
        "sequential": lambda: [ntu_fn(b).cpu().numpy() for b in batches],
        "resident": lambda: [ntu_fn(b).cpu().numpy() for b in resident]}
    seconds = {name: [served_s] if name == "served" else []
               for name in loops}
    for name in ("sequential", "resident", "resident", "sequential",
                 "served", "served", "sequential", "resident"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[name]()
        seconds[name].append(time.perf_counter() - t0)
    pin_ms = []                         # the uploader's host time a batch
    for b in batches:
        t1 = time.perf_counter()
        [torch.from_numpy(v).pin_memory() for v in b.values()]
        pin_ms.append((time.perf_counter() - t1) * 1e3)
    run = server.run(iter(batches))
    next(run)
    run.close()
    if server.uploader.is_alive():
        raise AssertionError("served: the uploader outlived an early close")
    frames = n_batches * B
    fps = {f"{name}_frames_per_s": frames / statistics.median(t)
           for name, t in seconds.items()}
    return dict(batches=n_batches, batch=B, launches=launches,
                max_abs_diff_vs_direct=max(diffs), **fps,
                seconds=seconds, pin_ms_per_batch=statistics.median(pin_ms))


def write_ntu_scene(root, scene, n_frames, seed):
    """A mini-dataset scene of NTU frames (512x640): thermal PNGs, the
    x256 PNG16 mono prior and lidar GT, sparse radar PNGs of 40 returns,
    from a smooth seeded depth field."""
    import numpy as np
    from PIL import Image
    from riders_tpu_torch.io import depthio
    rng = np.random.default_rng(seed)
    H, W = FRAME
    dirs = {d: depthio.ensure_dir(str(root / scene / d)) for d in (
        "thermal_undistort", "any", "radar_png", "lidar_png",
        "lidar_png_int")}
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for f in range(n_frames):
        name = f"{f:06d}.png"
        depth = (5.0 + 30.0 * yy / H + 10.0 * xx / W
                 + rng.random((H, W))).astype(np.float32)
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                        ).save(str(Path(dirs["thermal_undistort"]) / name))
        depthio.save_depth((1.0 / depth) / 0.05,
                           str(Path(dirs["any"]) / name))
        for d, n in (("radar_png", 40), ("lidar_png", 3000)):
            sparse = np.zeros((H, W), np.float32)
            idx = rng.choice(H * W, n, replace=False)
            sparse.reshape(-1)[idx] = depth.reshape(-1)[idx]
            depthio.save_depth(sparse, str(Path(dirs[d]) / name))
        depthio.save_depth(depth, str(Path(dirs["lidar_png_int"]) / name))


def disk_drivers(seed=0, n_frames=8):
    """Phase 8d: the on-disk drivers on an 8-frame NTU mini-dataset:
    run_rcnet from an RC-Net checkpoint (its depth PNGs become stage 3's
    knots), evaluate_results_dir on that tree, validate_sml over two SML
    checkpoints, each timed, with the kernels' launches of run_rcnet."""
    import dataclasses
    import shutil
    import torch
    from riders_tpu_torch.core import checkpoint
    from riders_tpu_torch.core.config import ntu_config
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines import drivers
    from riders_tpu_torch.pipelines.rcnet_training import \
        init_rcnet_train_state
    from riders_tpu_torch.pipelines.sml_training import init_train_state

    root = HERE / "build" / "phase8_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        scene = "scene-ntu"
        write_ntu_scene(root, scene, n_frames, seed)
        cfg = ntu_config(root=str(root))
        cfg = cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=FRAME,
                                        train_scenes=(scene,),
                                        val_scenes=(scene,)),
            sml_train=dataclasses.replace(cfg.sml_train,
                                          rcnet_interp_val=None))
        rc_dir, sml_dir = root / "ckpt_rcnet", root / "ckpt_sml"
        rcnet, _ = build_models(cfg, seed, None, torch.float32)
        state = init_rcnet_train_state(cfg, rcnet, 1)
        state.step = 1
        checkpoint.save_train_state(rc_dir, state)
        for step in (1, 2):
            state = init_train_state(cfg, build_sml(cfg, seed + step, None,
                                                    torch.float32), 1)
            state.step = step
            checkpoint.save_train_state(sml_dir, state)
        del rcnet, state
        times = {}
        LAUNCHES.clear()
        t0 = time.perf_counter()
        drivers.run_rcnet(cfg, str(rc_dir), str(root / "output"),
                          scenes=(scene,))
        times["run_rcnet_s"] = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        if launches.get("roi_pool") != n_frames or launches.get(
                "compose", 0) < n_frames or launches.get("stem", 0) < 1:
            raise AssertionError(f"run_rcnet: launches {launches} for "
                                 f"{n_frames} frames")
        tree = root / "output" / f"rcnet_{cfg.rcnet.response_threshold}"
        written = sorted(p.name for p in (tree / scene /
                                          "depth_predicted").iterdir())
        if len(written) != n_frames or len(list(
                (tree / scene / "depth_predicted_colors").iterdir())) \
                != n_frames:
            raise AssertionError(f"run_rcnet wrote {written}")
        t0 = time.perf_counter()
        scored = drivers.evaluate_results_dir(cfg, str(tree),
                                              "depth_predicted")
        times["evaluate_results_dir_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        best = drivers.validate_sml(cfg, str(sml_dir),
                                    output_path=str(root / "val"),
                                    save_output=True)
        times["validate_sml_s"] = time.perf_counter() - t0
        if best["step"] not in (1, 2) or not all(
                math.isfinite(best[k]) for k in ("mae", "rmse", "delta1")):
            raise AssertionError(f"validate_sml: best {best}")
        mosaics = sorted(p.name for p in (root / "val" / "SML").glob(
            "mosaic-step*.png"))
        if mosaics != ["mosaic-step1.png", "mosaic-step2.png"]:
            raise AssertionError(f"validate_sml mosaics {mosaics}")
        if not math.isfinite(scored["mae"]):
            raise AssertionError(f"evaluate_results_dir: {scored}")
        return dict(frames=n_frames, run_rcnet_launches=launches,
                    rcnet_tree_scores=scored, sml_best=best, **times)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def staged_phase(ntu_fn):
    """Phase 8: 8a-8d in order."""
    import torch
    rc, raw, depth = staged_rcnet()
    sml = staged_sml(raw, depth)
    del raw, depth
    serve = served(ntu_fn)
    torch.cuda.empty_cache()
    disk = disk_drivers()
    return dict(rcnet=rc, sml=sml, served=serve, drivers=disk)


def write_raw_ntu_scene(root, scene, n_frames, seed, n_lidar=40000,
                        n_radar=200):
    """A raw NTU scene in the layout `preprocess` reads: 16-bit 640x512
    thermal PNGs (thermal_sync/), binary lidar (lidar/) and radar
    (radar_sync/) .pcd files of points seen through the NTU rig's
    calibration (a few behind the camera or past the distance window)."""
    import cv2
    import numpy as np
    from riders_tpu_torch.io.preprocess.project import ntu_calibration
    calib = ntu_calibration()
    rng = np.random.default_rng(seed)
    H, W = calib.image_size
    P = calib.projection_matrix
    for d in ("thermal_sync", "lidar", "radar_sync"):
        (root / scene / d).mkdir(parents=True, exist_ok=True)
    for f in range(n_frames):
        fid = f"{f:06d}"
        cv2.imwrite(str(root / scene / "thermal_sync" / f"{fid}.png"),
                    rng.integers(20000, 30000, (H, W), dtype=np.uint16))
        for d, n, t in (("lidar", n_lidar, calib.t_camera_lidar),
                        ("radar_sync", n_radar, calib.t_camera_radar)):
            z = 0.5 + 119.5 * rng.random(n) ** 2
            z[: n // 20] *= -1.0
            u = rng.uniform(-20, W + 20, n)
            v = rng.uniform(-20, H + 20, n)
            cam = np.column_stack([(u - P[0, 2]) * z / P[0, 0],
                                   (v - P[1, 2]) * z / P[1, 1], z,
                                   np.ones(n)])
            xyz = (cam @ np.linalg.inv(t).T)[:, :3].astype(np.float32)
            with open(root / scene / d / f"{fid}.pcd", "wb") as fh:
                fh.write((f"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n"
                          f"TYPE F F F\nCOUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
                          f"POINTS {n}\nDATA binary\n").encode("ascii"))
                fh.write(xyz.tobytes())


class _StepClock:
    """Within its block, the training steps that `module.name` builds
    note the host clock when they start, without synchronising (the
    driver's summary writes read the loss on the host at every step
    here, so a step's interval holds its device time)."""

    def __init__(self, module, name):
        self.module, self.name, self.starts = module, name, []
        self.factory = getattr(module, name)

    def __enter__(self):
        def factory(*args, **kw):
            step = self.factory(*args, **kw)

            def timed(state, batch):
                self.starts.append(time.perf_counter())
                return step(state, batch)
            return timed
        setattr(self.module, self.name, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.factory)

    def intervals_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.starts, self.starts[1:])]


def _cli(args, root):
    """One `riders-torch` command at the NTU preset on the card, with
    the launch counters reset just before it: its seconds (synchronised)
    and the kernels' launches."""
    import torch
    from riders_tpu_torch import cli
    from riders_tpu_torch.ops.kernels import LAUNCHES
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    rc = cli.main([args[0], "--dataset", "ntu", "--root", str(root),
                   "--train-scenes", "train", "--val-scenes", "val",
                   *args[1:]])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"riders-torch {args}: exit {rc}")
    return time.perf_counter() - t0, dict(LAUNCHES)


def _trained(ckpt, steps):
    """The losses a trainer wrote, checked finite at every step, and its
    one checkpoint at `steps`."""
    from riders_tpu_torch.core import checkpoint
    with open(ckpt / "scalars-train.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = {r["step"]: r["loss"] for r in recs if "loss" in r}
    if (sorted(losses) != list(range(1, steps + 1))
            or not all(math.isfinite(v) for v in losses.values())
            or checkpoint.all_steps(ckpt) != [steps]):
        raise AssertionError(f"{ckpt.name}: losses {losses}, checkpoints "
                             f"{checkpoint.all_steps(ckpt)}")
    return losses


def loader_ms(cfg, kind, n_batches=3):
    """Host ms per batch of the trainer's loader alone (decode,
    augmentation, stacking and the pinned copy to the card, four decode
    threads, as the driver runs it) over the training scenes: the
    yardstick of a driver step that the loader bounds."""
    import torch
    from riders_tpu_torch.io import input_pipeline as ip
    from riders_tpu_torch.io.manifest import build_manifest
    if kind == "rcnet":
        data = ip.RCNetTrainDataset(cfg, build_manifest(
            cfg.dataset, cfg.dataset.train_scenes))
        B = cfg.rcnet_train.batch_size
    else:
        t = cfg.sml_train
        data = ip.SMLFrameDataset(cfg, build_manifest(
            cfg.dataset, cfg.dataset.train_scenes,
            rcnet_interp=t.rcnet_interp), train=True)
        B = t.batch_size
    loader = ip.BatchLoader(data, B, shuffle=True, device="cuda")
    times = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        for batch in loader.epoch():
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
    return times


def training_cli_phase(root, n_train=24, n_val=4, steps=3, seed=0):
    """Phase 9: the training drivers and the CLI at the NTU preset's full
    widths, through `riders_tpu_torch.cli.main` on the card, on an NTU
    dataset of 24 training and 4 validation frames (512x640) written
    under `root` (left there for phase 10).  The preset's summary and
    checkpoint cadence is cut to every step and every 3 steps, so that a
    3-step run writes its summaries.  Then preprocessing of a raw scene
    (9e), and IDW on the card against the CPU (9f)."""
    import contextlib
    import dataclasses
    import torch
    from unittest import mock
    from riders_tpu_torch.core import config
    from riders_tpu_torch.pipelines import rcnet_training, sml_training

    preset = config.ntu_config

    def cadence(root="", **kw):
        cfg = preset(root, **kw)
        return cfg.replace(**{k: dataclasses.replace(
            getattr(cfg, k), n_step_per_summary=1,
            n_step_per_checkpoint=steps)
            for k in ("rcnet_train", "sml_train")})

    out = {}
    ckpt = {k: root / f"ckpt_{k}" for k in ("rcnet", "sml_interp", "sml")}
    write_ntu_scene(root, "train", n_train, seed)
    write_ntu_scene(root, "val", n_val, seed + 1)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(config, "ntu_config",
                                              cadence))
        # 9a: train-rcnet at B=24, K=40
        with _StepClock(rcnet_training, "make_rcnet_train_step") as clk:
            s, launches = _cli(["train-rcnet", "--ckpt",
                                str(ckpt["rcnet"]), "--max-steps",
                                str(steps)], root)
        losses = _trained(ckpt["rcnet"], steps)
        pngs = sorted(p.name for p in (ckpt["rcnet"] / "summaries"
                                       ).glob("step*.png"))
        # five pyramid launches and five backward launches a step;
        # the summary's eval-mode forward pools once more
        if (launches.get("roi_pool_bwd") != 5 * steps
                or launches.get("roi_pool_f32") != 5 * steps + 1
                or pngs != [f"step{steps}.png"]):
            raise AssertionError(f"train-rcnet: launches {launches}, "
                                 f"summaries {pngs}")
        cfg = config.ntu_config(str(root))
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, train_scenes=("train",), val_scenes=("val",)))
        out["train_rcnet"] = dict(
            seconds=s, launches=launches, losses=losses, batch=24,
            points=40, step_intervals_ms=clk.intervals_ms(),
            summaries=pngs, loader_ms_per_batch=loader_ms(cfg, "rcnet"))
        # 9b: the stage-2 maps of the SML sources (rcnet_0.4 trains,
        # rcnet_0.5 validates); the second run is the one reported
        n = n_train + n_val
        for thr in ("0.5", "0.4"):
            s, launches = _cli(["run-rcnet", "--ckpt",
                                str(ckpt["rcnet"]), "--output",
                                str(root / "output"), "--threshold",
                                thr], root)
        if (launches.get("roi_pool") != n
                or launches.get("stem", 0) < n
                or launches.get("compose", 0) < n):
            raise AssertionError(f"run-rcnet: launches {launches} for "
                                 f"{n} frames")
        out["run_rcnet"] = dict(seconds=s, frames=n, launches=launches)
        # 9c: train-sml at B=12, with the IDW scale map and with the
        # preset's rcnet_0.4 knots
        for name, extra in (("sml_interp", ["--rcnet-interp",
                                            "interp"]), ("sml", [])):
            torch.cuda.reset_peak_memory_stats()
            with _StepClock(sml_training, "make_train_step") as clk:
                s, _ = _cli(["train-sml", "--ckpt", str(ckpt[name]),
                             "--max-steps", str(steps), *extra], root)
            out[f"train_{name}"] = dict(
                seconds=s, losses=_trained(ckpt[name], steps),
                batch=12, step_intervals_ms=clk.intervals_ms(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out["train_sml"]["loader_ms_per_batch"] = loader_ms(cfg, "sml")
        # 9d: the inference subcommands on those checkpoints
        s, launches = _cli(["val-rcnet", "--ckpt", str(ckpt["rcnet"])],
                           root)
        if launches.get("roi_pool") != n_val:
            raise AssertionError(f"val-rcnet: launches {launches}")
        out["val_rcnet"] = dict(seconds=s, launches=launches)
        s, launches = _cli(["val-sml", "--ckpt", str(ckpt["sml"]),
                            "--depth-predictor", "midas_small"], root)
        out["val_sml"] = dict(seconds=s, launches=launches)
        s, _ = _cli(["eval-dir", "--results",
                     str(root / "output" / "rcnet_0.4"), "--subdir",
                     "depth_predicted"], root)
        out["eval_dir"] = dict(seconds=s)
    out["preprocess"] = preprocess_phase(root, seed)
    out["idw"] = idw_on_card(seed)
    return out


def cocircular_simplices(points):
    """scipy's Delaunay triangulation of integer (row, col) knots, and
    for each of its triangles whether a neighbour's far vertex lies
    exactly on its circumcircle (an in-circle determinant of 0, exact in
    f64 for pixel coordinates): there another triangulation is also a
    Delaunay one."""
    import numpy as np
    from scipy.spatial import Delaunay
    tri = Delaunay(points)
    S = tri.simplices
    ambiguous = np.zeros(len(S), bool)
    for j in range(3):
        nb = tri.neighbors[:, j]
        has = np.flatnonzero(nb >= 0)
        own, theirs = S[has], S[nb[has]]
        far = theirs[~(theirs[:, :, None] == own[:, None, :]).any(-1)]
        m = points[own] - points[far][:, None, :]           # (M, 3, 2)
        sq = (m ** 2).sum(-1)
        det = (m[:, 0, 0] * (m[:, 1, 1] * sq[:, 2] - sq[:, 1] * m[:, 2, 1])
               - m[:, 0, 1] * (m[:, 1, 0] * sq[:, 2] - sq[:, 1] * m[:, 2, 0])
               + sq[:, 0] * (m[:, 1, 0] * m[:, 2, 1]
                             - m[:, 1, 1] * m[:, 2, 0]))
        ambiguous[has[det == 0]] = True
    return tri, ambiguous


def preprocess_phase(root, seed, n_frames=4):
    """Phase 9e: `preprocess` of a raw 4-frame NTU scene through the CLI
    (the native Delaunay densifies each lidar frame), then each frame's
    sparse lidar map densified again by the native library and by scipy:
    their ms per frame, and the pixels where they differ by more than
    1e-3, each of which must lie in one of scipy's triangles that has an
    exactly cocircular neighbour (a tie that either triangulation may
    break)."""
    import numpy as np
    from riders_tpu_torch import cli
    from riders_tpu_torch.io import depthio
    from riders_tpu_torch.io.native import build
    from riders_tpu_torch.ops.interp import delaunay_interpolate

    raw, processed = root / "raw", root / "processed"
    write_raw_ntu_scene(raw, "scene", n_frames, seed)
    t0 = time.perf_counter()
    build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli.main(["preprocess", "--dataset", "ntu", "--root", str(raw),
                 "--output", str(processed)]) != 0:
        raise AssertionError("preprocess failed")
    total = time.perf_counter() - t0
    scene = processed / "scene"
    times = {"native": [], "scipy": []}
    differ, n_pts = [], []
    for f in range(n_frames):
        name = f"{f:06d}.png"
        for d in ("thermal_undistort", "radar_png", "lidar_png",
                  "lidar_png_int"):
            if not (scene / d / name).exists():
                raise AssertionError(f"preprocess wrote no {d}/{name}")
        sparse = depthio.load_depth(str(scene / "lidar_png" / name))
        dense = {}
        for kind, native in (("native", True), ("scipy", False)):
            t0 = time.perf_counter()
            dense[kind] = delaunay_interpolate(sparse, use_native=native)
            times[kind].append(1e3 * (time.perf_counter() - t0))
        knots = np.argwhere(sparse > 0).astype(np.float64)
        n_pts.append(len(knots))
        diff = np.abs(dense["native"] - dense["scipy"]) > 1e-3
        either = (dense["native"] > 0) | (dense["scipy"] > 0)
        differ.append(float(diff[either].mean()))
        tri, ambiguous = cocircular_simplices(knots)
        at = tri.find_simplex(np.argwhere(diff).astype(np.float64))
        unexplained = int(((at < 0) | ~ambiguous[np.maximum(at, 0)]).sum())
        if unexplained:
            raise AssertionError(
                f"preprocess frame {f}: {unexplained} of {int(diff.sum())} "
                f"pixels where native and scipy differ lie outside every "
                f"cocircular triangle")
    radar = np.load(scene / "radar_npy" / f"{0:06d}.npy")
    return dict(frames=n_frames, ms_per_frame=1e3 * total / n_frames,
                native_build_s=build_s, lidar_points_in_view=n_pts,
                radar_points_in_view=len(radar),
                delaunay_native_ms=times["native"],
                delaunay_scipy_ms=times["scipy"],
                native_vs_scipy_differing_share=differ,
                differing_outside_cocircular=0)


def idw_on_card(seed, knots=(300, 40, 0)):
    """Phase 9f: idw_scale_map at 512x640 on the card against its CPU
    run: the same knot indices (the first 128 valid pixels in row-major
    order) and the map within rtol 1e-5."""
    import torch
    from riders_tpu_torch.ops import interp
    g = torch.Generator().manual_seed(seed + 90)
    B, (H, W) = len(knots), FRAME
    prior = 0.05 + torch.rand((B, H, W), generator=g)
    valid = torch.zeros((B, H * W))
    for b, n in enumerate(knots):
        valid[b, torch.randperm(H * W, generator=g)[:n]] = 1.0
    valid = valid.reshape(B, H, W)
    sparse = valid * (0.02 + 0.3 * torch.rand((B, H, W), generator=g))
    cpu = interp.idw_scale_map(prior, sparse, valid)
    args = [t.cuda() for t in (prior, sparse, valid)]
    card = interp.idw_scale_map(*args)
    same_knots = torch.equal(interp.knot_indices(args[2]).cpu(),
                             interp.knot_indices(valid))
    rel = float(((card.cpu() - cpu).abs() / cpu.abs()).max())
    if not same_knots or rel > 1e-5:
        raise AssertionError(f"idw on the card: knots equal {same_knots}, "
                             f"max rel err {rel}")
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: interp.idw_scale_map(*args), n=5, warmup=1)
    return dict(frames=B, knots=list(knots), same_knots=same_knots,
                max_rel_err=rel, ms=ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


DPT_MAIN = "dpt-beit-large"                 # BEiT-L/16-512
DPT_OTHERS = ("dpt-large", "dpt-hybrid")    # ViT-L/16, ResNet50 + ViT-B
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def dpt_config(model_type, **sml):
    """The NTU preset (512x640 frames, SML net 288x352) with a DPT SML."""
    import dataclasses
    cfg = train_config("ntu")
    return cfg.replace(sml=dataclasses.replace(cfg.sml,
                                               model_type=model_type, **sml))


def dpt_weights(cfg, seed):
    """Seeded f32 weights of cfg's DPT on the host, with flax's default
    initialisers (`init_training_`), then its head's last conv set so
    that on the network inputs of one seeded NTU frame (stage 1 of a
    `make_sml_train_batch` frame) its output has mean 0.1 and standard
    deviation 0.02: the scales vary by some 2% around 1.1, as a trained
    SML's small corrections do, and the final relu passes the pixels
    within 5 deviations.  At flax's own initial weights the head's
    pre-activation is negative almost everywhere (87% of a 64x96 frame's
    pixels on the host; every pixel of phase 10b's NTU frames, where no
    parameter then got a gradient), and its scale is not known before a
    forward; calibrated on an N(0, 1) frame instead, it was again
    negative on every pixel of phase 10b's frames."""
    import torch
    from riders_tpu_torch.models.factory import build_sml_model
    from riders_tpu_torch.models.layers import init_training_
    from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs
    model = init_training_(build_sml_model(cfg, "cpu", torch.float32), seed)
    head = model.head_conv3
    b = make_sml_train_batch(cfg, seed + 60, "cpu", B=1)
    seen = []
    hook = head.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        x, d = prepare_sml_inputs(cfg, b["image"], b["mono_pred"],
                                  b["radar"], b["rcnet"])
        head.bias.zero_()
        model(x, d)
        hook.remove()
        mean, std = float(seen[0].mean()), float(seen[0].std())
        head.weight.mul_(0.02 / std)
        head.bias.fill_(0.1 - 0.02 * mean / std)
    return model.state_dict()


def build_dpt(cfg, weights, device, dtype):
    from riders_tpu_torch.models.factory import build_sml_model
    model = build_sml_model(cfg, device, dtype)
    model.load_state_dict(weights)
    return model


def flop_count(fn):
    """The matmul, convolution and attention operations of one call of
    `fn` (torch's FlopCounterMode: 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def times_ms(fn, n, warmup=2):
    """CUDA-event times of n synchronised calls of `fn` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def dpt_inference(model_type, weights, B=16, seed=0, n=10,
                  profile_dir=None):
    """Phase 10a: make_infer_fn with a DPT SML at the NTU preset, bf16,
    B frames: finite depth of the frame's shape and finite metrics, ms
    per call (CUDA events, after warm-up) with its spread, peak memory,
    parameters, and the call's operations over the bf16 peak (its
    bound)."""
    import torch
    from riders_tpu_torch.pipelines.sml_inference import make_infer_fn
    cfg = dpt_config(model_type)
    model = build_dpt(cfg, weights, None, torch.bfloat16)
    batch = make_sml_train_batch(cfg, seed + 40, "cuda", B=B)
    fn = make_infer_fn(cfg, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn(batch)
    d = out["depth"]
    if (tuple(d.shape) != (B,) + tuple(cfg.dataset.image_shape)
            or not bool(torch.isfinite(d).all())
            or not all(bool(torch.isfinite(v).all())
                       for v in out["metrics"].values())):
        raise AssertionError(f"{model_type}: depth {tuple(d.shape)} or "
                             f"non-finite outputs")
    ms = times_ms(lambda: fn(batch), n)
    flops = flop_count(lambda: fn(batch))
    if profile_dir is not None:
        log(profile(fn, batch, profile_dir / "profile_dpt_infer.txt"))
    return dict(model_type=model_type, batch=B,
                net=list(cfg.sml.net_shape), dtype="bfloat16",
                params=sum(p.numel() for p in model.parameters()),
                ms_per_call=statistics.median(ms), ms_min=min(ms),
                ms_max=max(ms), n_calls=n,
                frames_per_s=B / (statistics.median(ms) / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                flops_per_call=flops,
                bound_ms=flops / BF16_FLOP_PER_S * 1e3)


def dpt_training(weights, seed=0, profile_dir=None):
    """Phase 10b: make_train_step with BEiT-L at the NTU SML preset (B=12,
    f32, TF32 off): a gradient in every parameter in the first step from
    `weights`; then three steps with every parameter moved and finite
    losses (`_train_phase`), ms per step, peak memory, and a step's
    operations over the f32 peak; then ms per step with cuDNN's TF32
    convolutions (PyTorch's default, which this script turns off; the
    matmuls stay f32).  The first Adam update at the preset's
    rate (5e-5 on each of 0.34 B random parameters) drives the head's
    pre-activation below 0 at every pixel, so the later steps' gradients
    are 0 (the step's work is the same)."""
    import torch
    from riders_tpu_torch.pipelines import sml_training
    cfg = dpt_config(DPT_MAIN)
    model = build_dpt(cfg, weights, None, torch.float32)
    state = sml_training.init_train_state(cfg, model, 1000)
    batches = [make_sml_train_batch(cfg, seed + 50 + i, "cuda")
               for i in range(3)]
    step = sml_training.make_train_step(cfg)
    _, aux = step(state, batches[0])
    dead = [k for k, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.any())]
    if dead or not math.isfinite(float(aux["loss"])):
        raise AssertionError(f"dpt: first step loss {float(aux['loss'])}, "
                             f"{len(dead)} parameters without a gradient: "
                             f"{dead[:8]}")
    first_loss = float(aux["loss"])
    rec = _train_phase("dpt", state, step, batches, (),
                       cfg.sml_train.batch_size, check_grads=False)
    rec["first_step_loss"] = first_loss
    torch.backends.cudnn.allow_tf32 = True
    try:
        rec["ms_per_step_cudnn_tf32"] = time_ms(
            lambda: step(state, batches[1]), n=3, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    flops = flop_count(lambda: step(state, batches[0]))
    if profile_dir is not None:
        log(profile(lambda b: step(state, b), batches[1],
                    profile_dir / "profile_dpt_train.txt"))
    rec.update(net_shape=list(cfg.sml.net_shape), flops_per_step=flops,
               bound_ms=flops / FP32_FLOP_PER_S * 1e3)
    return rec


def dpt_step_agreement(weights, seed=5):
    """Phase 10b: one BEiT-L SML training step (f32, B=2, net 64x96, 96x128
    frames) on the card against the same step on the host CPU, by phase
    7's rule: the loss to rtol 1e-4; each gradient's max abs error,
    relative to its max abs, within 1e-3 or within 3x the CPU's own
    spread under a one-ulp nudge of the inputs (two draws).  The nudge
    moves a random half of the pixels of the image and of the mono prior:
    the image reaches the network only as its gray channel, and a nudge
    of it alone moved no gradient of the CPU's beyond 6.4e-6 (an NVIDIA
    H100's host), while the prior becomes the network's first channel
    and the aligned depth."""
    import dataclasses
    import torch
    from riders_tpu_torch.pipelines import sml_training
    cfg = dpt_config(DPT_MAIN, net_shape=(64, 96))
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                  image_shape=(96, 128)))
    batch = make_sml_train_batch(cfg, seed, "cpu", B=2)
    step = sml_training.make_train_step(cfg)

    def run(device, b):
        model = build_dpt(cfg, weights, device, torch.float32)
        state = sml_training.init_train_state(cfg, model, 1000)
        _, aux = step(state, b)
        return float(aux["loss"]), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def nudged(s):
        g = torch.Generator().manual_seed(s)
        out = dict(batch)
        for k in ("image", "mono_pred"):
            x = batch[k]
            out[k] = torch.where(torch.rand(x.shape, generator=g) < 0.5,
                                 torch.nextafter(x, torch.full_like(
                                     x, float("inf"))), x)
        return out

    def rel_errs(g, ref):
        return {k: float((g[k] - r).abs().max())
                / max(float(r.abs().max()), 1e-30) for k, r in ref.items()}

    loss_cpu, g_cpu = run("cpu", batch)
    loss_card, g_card = run(None, batch)
    card = rel_errs(g_card, g_cpu)
    spread = {k: 0.0 for k in g_cpu}
    losses = []
    for s in (1, 2):
        loss, g = run("cpu", nudged(s))
        losses.append(loss)
        for k, e in rel_errs(g, g_cpu).items():
            spread[k] = max(spread[k], e)
    bad = [k for k in card if card[k] > max(1e-3, 3 * spread[k])]
    worst = max(card, key=card.get)
    zero = [k for k, g in g_cpu.items() if not bool(g.any())]
    res = dict(loss_cpu=loss_cpu, loss_card=loss_card,
               loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
               cpu_loss_spread=max(abs(v - loss_cpu) for v in losses)
               / abs(loss_cpu),
               worst_grad_rel_err=card[worst], worst_grad=worst,
               cpu_spread_there=spread[worst],
               worst_cpu_spread=max(spread.values()),
               grads_over_1e3=sum(e > 1e-3 for e in card.values()),
               median_grad_rel_err=sorted(card.values())[len(card) // 2],
               n_grads=len(g_cpu), zero_grads=zero, failing=bad)
    if res["loss_rel_err"] > 1e-4 or bad or len(zero) * 10 > len(g_cpu):
        raise AssertionError(f"DPT card vs CPU training step: {res}")
    return res


def dpt_drivers(root, weights, steps=3):
    """Phase 10c: train_sml with BEiT-L for `steps` steps (B=12, the
    'interp' scale-map source, a checkpoint at the last step) on the NTU
    mini-dataset under `root`, resumed from a step-0 checkpoint of
    `weights` (flax's initial weights leave the head's relu dead), then
    validate_sml over both checkpoints in bf16 on the card and in f32 on
    the host CPU: each step's seven metrics within 1% (PARITY.md's
    protocol), the same best step."""
    import dataclasses
    import torch
    from unittest import mock
    from riders_tpu_torch.core import checkpoint, metrics
    from riders_tpu_torch.io.manifest import build_manifest
    from riders_tpu_torch.pipelines import drivers, sml_training
    cfg = dpt_config(DPT_MAIN)
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, root=str(root),
                                    train_scenes=("train",),
                                    val_scenes=("val",)),
        sml_train=dataclasses.replace(
            cfg.sml_train, rcnet_interp="interp", rcnet_interp_val=None,
            n_step_per_summary=1, n_step_per_checkpoint=steps))
    ckpt = root / "ckpt_dpt"
    n_train = len(build_manifest(cfg.dataset, cfg.dataset.train_scenes))
    checkpoint.save_train_state(ckpt, sml_training.init_train_state(
        cfg, build_dpt(cfg, weights, "cpu", torch.float32),
        n_train // cfg.sml_train.batch_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StepClock(sml_training, "make_train_step") as clk:
        drivers.train_sml(cfg, str(ckpt), resume=True, max_steps=steps)
    torch.cuda.synchronize()
    with open(ckpt / "scalars-train.jsonl") as f:
        losses = {r["step"]: r["loss"] for r in map(json.loads, f)
                  if "loss" in r}
    if (sorted(losses) != list(range(1, steps + 1))
            or not all(math.isfinite(v) for v in losses.values())
            or checkpoint.all_steps(ckpt) != [0, steps]):
        raise AssertionError(f"train_sml: losses {losses}, checkpoints "
                             f"{checkpoint.all_steps(ckpt)}")
    out = dict(train_sml_s=time.perf_counter() - t0,
               step_intervals_ms=clk.intervals_ms(), losses=losses,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    best, bundles = {}, {}
    for name, dtype, device in (("card_bf16", "bfloat16", None),
                                ("cpu_f32", "float32", "cpu")):
        seen = bundles[name] = []

        def vote(results, best_so_far, _vote=metrics.improves_best):
            seen.append(dict(results))
            return _vote(results, best_so_far)

        t0 = time.perf_counter()
        with mock.patch.object(metrics, "improves_best", vote):
            best[name] = drivers.validate_sml(
                cfg.replace(compute_dtype=dtype), str(ckpt), device=device)
        out[f"validate_sml_{name}_s"] = time.perf_counter() - t0
    # the steps newest first: `steps`, then 0
    dev = {f"step{s}": {k: abs(a[k] - b[k]) / abs(b[k])
                        for k in metrics.METRIC_KEYS}
           for s, a, b in zip((steps, 0), bundles["card_bf16"],
                              bundles["cpu_f32"])}
    out.update(metrics=bundles, best_step={k: v["step"]
                                           for k, v in best.items()},
               metric_rel_dev=dev)
    worst = max(v for d in dev.values() for v in d.values())
    if (len(dev) != 2 or best["card_bf16"]["step"] != best["cpu_f32"]["step"]
            or not all(math.isfinite(b[k]) for b in bundles["cpu_f32"]
                       for k in metrics.METRIC_KEYS) or worst > 0.01):
        raise AssertionError(f"validate_sml bf16 card vs f32 CPU: {out}")
    return out


def dpt_phase(root, seed=0, profile_dir=None):
    """Phase 10: the DPT SML at full width on the card (10a inference,
    10b training and its agreement with the CPU, 10c the drivers on the
    NTU mini-dataset under `root`), the launch counters reset just
    before; the DPT path reaches none of the hand-written kernels.  With
    `profile_dir`, torch.profiler tables of a BEiT-L inference call and
    training step."""
    import gc
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    gc.collect()
    torch.cuda.empty_cache()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    weights = {DPT_MAIN: dpt_weights(dpt_config(DPT_MAIN), seed)}
    out = {"inference": {DPT_MAIN: dpt_inference(
        DPT_MAIN, weights[DPT_MAIN], profile_dir=profile_dir)}}
    for model_type in DPT_OTHERS:
        w = dpt_weights(dpt_config(model_type), seed)
        out["inference"][model_type] = dpt_inference(model_type, w, n=3)
        del w
        torch.cuda.empty_cache()
    out["training"] = dpt_training(weights[DPT_MAIN], seed, profile_dir)
    torch.cuda.empty_cache()
    out["step_agreement"] = dpt_step_agreement(weights[DPT_MAIN])
    torch.cuda.empty_cache()
    out["drivers"] = dpt_drivers(root, weights[DPT_MAIN])
    out["launches"] = dict(LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    return out


def dpt_line(smi, dpt):
    """The one-line summary of phase 10."""
    inf, tr = dpt["inference"], dpt["training"]
    main = inf[DPT_MAIN]
    drv, agree = dpt["drivers"], dpt["step_agreement"]
    return {"dpt": dict(
        card=smi, model=DPT_MAIN, params=main["params"],
        infer_ntu_b16_bf16_ms=main["ms_per_call"],
        infer_ms_min_max=[main["ms_min"], main["ms_max"]],
        infer_bound_ms=main["bound_ms"],
        infer_peak_mem_gb=main["peak_mem_gb"],
        **{f"infer_{k.replace('-', '_')}_ms": inf[k]["ms_per_call"]
           for k in DPT_OTHERS},
        train_ntu_b12_f32_ms_per_step=tr["ms_per_step"],
        train_ms_per_step_cudnn_tf32=tr["ms_per_step_cudnn_tf32"],
        train_bound_ms=tr["bound_ms"], train_peak_mem_gb=tr["peak_mem_gb"],
        step_loss_rel_err=agree["loss_rel_err"],
        step_worst_grad_rel_err=agree["worst_grad_rel_err"],
        step_cpu_spread_there=agree["cpu_spread_there"],
        train_sml_s=drv["train_sml_s"],
        train_sml_step_intervals_ms=drv["step_intervals_ms"],
        validate_sml_card_bf16_s=drv["validate_sml_card_bf16_s"],
        validate_sml_cpu_f32_s=drv["validate_sml_cpu_f32_s"],
        metric_rel_dev=drv["metric_rel_dev"],
        launches=dpt["launches"], seconds=dpt["seconds"])}


def log_dpt(dpt):
    for name, rec in dpt["inference"].items():
        log(f"dpt inference {name}: {json.dumps(rec)}")
    for name in ("training", "step_agreement", "drivers"):
        log(f"dpt {name}: {json.dumps(dpt[name])}")


def dpt_only(smi, profile_dir):
    """`--dpt`: phase 1, then phase 10 alone on an NTU mini-dataset of
    its own (24 training and 4 validation frames under build/)."""
    root = HERE / "build" / "phase10_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_ntu_scene(root, "train", 24, 0)
        write_ntu_scene(root, "val", 4, 1)
        dpt = dpt_phase(root, profile_dir=profile_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log_dpt(dpt)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_dpt.json").write_text(json.dumps(dpt, indent=1))
    log(json.dumps(dpt_line(smi, dpt)))
    return 0


def profile(fn, batch, path):
    """Device time by kernel for one call of `fn` (torch.profiler), and
    the same by operator and input shapes (written to `path` only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    path.parent.mkdir(exist_ok=True)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        fn(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    shapes = prof.key_averages(group_by_input_shape=True).table(
        sort_by="cuda_time_total", row_limit=30, max_shapes_column_width=140)
    path.write_text(table + "\n" + shapes)
    return table


def kernel_times(smi):
    """`--kernel-times`: phase 2's, phase 5's RoI forward and phase 4b's
    B6 and B8 checks and times alone, B6 on random maps at the fused
    path's shapes, B8 at each call shape of one decode_full; one
    {"kernel_times": ...} line.  Run from a copy of another tree, it
    times that tree's kernels with these same inputs."""
    import torch
    keep = ("ms", "graph_ms", "kernel_graph_ms", "device_ms", "library_ms",
            "library_graph_ms", "library_device_ms",
            "plain_ms", "bound_ms", "bound_by", "launches_per_call",
            "b2_graph_ms", "clustered_graph_ms", "clustered_bound_ms",
            "slope_max_abs_errs", "max_abs_err")
    rows = {}
    for geometry in GEOMETRIES:
        recs = check_kernels(geometry)
        maps, boxes, _, _ = pyramid_inputs(
            geometry, 16, torch.Generator(device="cuda").manual_seed(40))
        recs["roi_pool_4d"] = check_roi_4d(geometry, maps, boxes,
                                           GEOMETRIES[geometry]["patch"])
        recs["roi_pool_f32"] = check_training_kernels(geometry)[
            "roi_pool_f32"]
        up = check_lane_kernels(geometry, kinds=("lane_upconv2x",))
        for c in up["lane_upconv2x"]["calls"]:
            n, h, w = c["input"]
            recs[f"lane_upconv2x {n}x{h}x{w} {c['widths'][0]}->{c['out']}"] \
                = c
        for name, r in recs.items():
            rows[f"{name} [{geometry}]"] = {k: r[k] for k in keep if k in r}
        del maps, boxes
        torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"kernel time {name}: {json.dumps(r)}")
    log(json.dumps({"kernel_times": dict(card=smi, tree=str(HERE),
                                         rows=rows)}))
    log(smi)
    return 0


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import riders_tpu_torch
    if Path(riders_tpu_torch.__file__).resolve().parents[1] != HERE:
        print("chip_smoke: riders_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 1
    from riders_tpu_torch.ops.kernels import LAUNCHES, build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for name in build.KERNELS:
        report = build._library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if "--kernel-times" in argv:
        return kernel_times(smi)
    profile_dir = HERE / "chiprun_out" if "--profile" in argv else None
    if "--dpt" in argv:
        return dpt_only(smi, profile_dir)

    kernels = {g: check_kernels(g) for g in GEOMETRIES}
    for g, recs in kernels.items():
        if recs["roi_pool"]["launches_per_call"] != 1:
            raise AssertionError(f"roi_pool [{g}]: the pyramid took "
                                 f"{recs['roi_pool']['launches_per_call']} "
                                 f"launches, not one")
        for name, r in recs.items():
            log(f"kernel {name} [{g}]: max_abs_err {r['max_abs_err']} "
                f"({r['tolerance']}) kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) graph: wrapper "
                f"{r['graph_ms']:.4f} ms kernel {r.get('kernel_graph_ms')} "
                f"library {r.get('library_graph_ms')}")
    LAUNCHES.clear()

    ntu, ntu_fn, ntu_batch, ntu_rcnet = drive("ntu", 16)
    log(f"fused ntu: {json.dumps(ntu)}")
    zju, zju_fn, _, zju_rcnet = drive("zju", 4)
    log(f"fused zju: {json.dumps(zju)}")
    agree = reference_agreement()
    log(f"reference agreement: {json.dumps(agree)}")

    lane_kernels, lane = lane_phase({"ntu": (ntu_fn, ntu_rcnet),
                                     "zju": (zju_fn, zju_rcnet)})
    for g, recs in lane_kernels.items():
        for name, r in recs.items():
            log(f"kernel {name} [{g}]: max_abs_err {r['max_abs_err']} "
                f"({r['tolerance']}) kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                + (f" back to back: kernel {r['device_ms']:.4f} ms library "
                   f"{r['library_device_ms']:.4f} ms"
                   if "library_device_ms" in r else "")
                + (f" graph: kernel {r['graph_ms']:.4f} ms"
                   if "graph_ms" in r else ""))
        log(f"lane decoder [{g}]: {json.dumps(lane[g])}")
    del zju_fn, zju_rcnet

    train_kernels = {p: check_training_kernels(p) for p in GEOMETRIES}
    for p, recs in train_kernels.items():
        for name, r in recs.items():
            log(f"kernel {name} [{p} training]: max_abs_err "
                f"{r['max_abs_err']} ({r['tolerance']}) kernel "
                f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                + (f" back to back {r['device_ms']:.4f} ms empty tiles "
                   f"{r['empty_tile_share']}"
                   if "empty_tile_share" in r else "")
                + (f" graph {r['graph_ms']:.4f} ms" if "graph_ms" in r
                   else ""))
    training = drive_training(
        profile_dir=HERE / "chiprun_out" if "--profile" in argv else None)
    for name in ("rcnet", "sml"):
        log(f"training {name}: {json.dumps(training[name])}")
    log(f"checkpoint: {json.dumps(training['checkpoint'])}")
    train_agree = training_agreement()
    log(f"training agreement: {json.dumps(train_agree)}")
    staged = staged_phase(ntu_fn)
    for name, rec in staged.items():
        log(f"staged {name}: {json.dumps(rec)}")
    if "--profile" in argv:
        out_dir = HERE / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        log(profile(ntu_fn, ntu_batch, out_dir / "profile_ntu.txt"))
    del ntu_fn, ntu_batch, ntu_rcnet
    torch.cuda.empty_cache()
    root = HERE / "build" / "phase9_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        cli_runs = training_cli_phase(root)
        for name, rec in cli_runs.items():
            log(f"cli {name}: {json.dumps(rec)}")
        dpt = dpt_phase(root, profile_dir=profile_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log_dpt(dpt)

    sources = {"stem": "riders_tpu_torch/csrc/stem.cu",
               "roi_pool": "riders_tpu_torch/csrc/roi_pool.cu",
               "compose": "riders_tpu_torch/csrc/compose.cu",
               "roi_pool_f32": "riders_tpu_torch/csrc/roi_pool.cu",
               "roi_pool_bwd": "riders_tpu_torch/csrc/roi_pool.cu",
               "lane_conv3x3": "riders_tpu_torch/csrc/lane_decoder.cu",
               "lane_upconv2x": "riders_tpu_torch/csrc/lane_decoder.cu",
               "roi_pool_4d": "riders_tpu_torch/csrc/roi_pool.cu"}
    replaces = {"stem": "riders_tpu/ops/pallas/stem.py:95",
                "roi_pool": "riders_tpu/ops/pallas/roi_pool.py:138",
                "compose": "riders_tpu/ops/pallas/compose.py:35",
                "roi_pool_f32": "riders_tpu/ops/pallas/roi_pool.py:138",
                "roi_pool_bwd": "riders_tpu/ops/pallas/roi_pool.py:742",
                "lane_conv3x3": "riders_tpu/ops/pallas/lane_decoder.py:312",
                "lane_upconv2x": "riders_tpu/ops/pallas/lane_decoder.py:461",
                "roi_pool_4d": "riders_tpu/ops/pallas/roi_pool.py:547"}
    # inference kernels: launches of the fused NTU run; training kernels:
    # launches of the three RC-Net training steps; lane kernels: launches
    # of the NTU decode_full run; B6: launches of one NTU 4D pyramid
    lane_launches = dict(lane["ntu"]["full"]["launches"], roi_pool_4d=
                         lane_kernels["ntu"]["roi_pool_4d"][
                             "launches_per_call"])
    lines = []
    for recs, launches in ((kernels, ntu["launches"]),
                           (train_kernels, training["rcnet"]["launches"]),
                           (lane_kernels, lane_launches)):
        for name in recs["ntu"]:
            r = recs["ntu"][name]
            lines.append(dict(
                name=name, route="cuda", source=sources[name],
                replaces=replaces[name], launches=launches.get(name, 0),
                max_abs_err=max(recs[g][name]["max_abs_err"]
                                for g in GEOMETRIES),
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                graph_ms=r.get("graph_ms"), device_ms=r.get("device_ms"),
                kernel_graph_ms=r.get("kernel_graph_ms"),
                zju=dict((k, recs["zju"][name].get(k)) for k in
                         ("ms", "graph_ms", "device_ms", "plain_ms",
                          "library_ms",
                          "bound_ms"))))
    details = dict(card=smi, torch=torch.__version__,
                   cuda=torch.version.cuda,
                   build_seconds=build_s, kernels=kernels,
                   fused=dict(ntu=ntu, zju=zju), reference=agree,
                   lane_kernels=lane_kernels, lane_decoder=lane,
                   training_kernels=train_kernels, training=training,
                   training_agreement=train_agree, staged=staged,
                   cli=cli_runs, dpt=dpt)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    log(json.dumps({"kernels": lines}))
    log(json.dumps({"fused": dict(card=smi, ntu_fps=ntu["fps"],
                                  ntu_ms=ntu["ms_per_call"],
                                  zju_fps_b4=zju["fps"],
                                  ref_median_rel_err=agree[
                                      "card_bf16_vs_cpu_f32"])}))
    log(json.dumps({"lane_decoder": dict(card=smi, **{
        g: dict(patches=r["patches"], literal_ms=r["literal_ms"],
                full_ms=r["full"]["ms"], tail_ms=r["tail"]["ms"],
                full_rel_err=r["full"]["rel_err"],
                tail_rel_err=r["tail"]["rel_err"])
        for g, r in lane.items()})}))
    log(json.dumps({"training": dict(
        card=smi, rcnet_ntu_b24_ms_per_step=training["rcnet"]["ms_per_step"],
        rcnet_frames_per_s=training["rcnet"]["frames_per_s"],
        sml_ntu_b12_ms_per_step=training["sml"]["ms_per_step"],
        sml_frames_per_s=training["sml"]["frames_per_s"],
        grad_rel_err_vs_cpu=train_agree["worst_grad_rel_err"])}))
    log(json.dumps({"staged": dict(
        card=smi,
        rcnet_ntu_b16_ms_per_call=staged["rcnet"]["ms_per_call"],
        rcnet_retry_histogram=staged["rcnet"]["retry_histogram"],
        rcnet_launches=staged["rcnet"]["launches"],
        sml_ntu_b16_ms_per_call=staged["sml"]["ms_per_call"],
        served_frames_per_s=staged["served"]["served_frames_per_s"],
        sequential_frames_per_s=staged["served"][
            "sequential_frames_per_s"],
        resident_frames_per_s=staged["served"]["resident_frames_per_s"],
        drivers_s={k: v for k, v in staged["drivers"].items()
                   if k.endswith("_s")})}))
    pre = cli_runs["preprocess"]
    log(json.dumps({"training_cli": dict(
        card=smi,
        train_rcnet_step_intervals_ms=cli_runs["train_rcnet"][
            "step_intervals_ms"],
        rcnet_step_ms_phase6=training["rcnet"]["ms_per_step"],
        train_rcnet_launches={k: cli_runs["train_rcnet"]["launches"].get(k)
                              for k in ("roi_pool_f32", "roi_pool_bwd")},
        **{f"{k}_loader_ms_per_batch": cli_runs[f"train_{k}"][
            "loader_ms_per_batch"] for k in ("rcnet", "sml")},
        **{f"train_{k}_step_intervals_ms": cli_runs[f"train_{k}"][
            "step_intervals_ms"] for k in ("sml_interp", "sml")},
        **{f"train_{k}_peak_mem_gb": cli_runs[f"train_{k}"]["peak_mem_gb"]
           for k in ("sml_interp", "sml")},
        sml_step_ms_phase6=training["sml"]["ms_per_step"],
        run_rcnet_launches={k: cli_runs["run_rcnet"]["launches"].get(k)
                            for k in ("stem", "roi_pool", "compose")},
        seconds={k: r["seconds"] for k, r in cli_runs.items()
                 if "seconds" in r},
        preprocess_ms_per_frame=pre["ms_per_frame"],
        delaunay_native_ms=pre["delaunay_native_ms"],
        delaunay_scipy_ms=pre["delaunay_scipy_ms"],
        native_vs_scipy_differing_share=pre[
            "native_vs_scipy_differing_share"],
        idw_max_rel_err=cli_runs["idw"]["max_rel_err"],
        idw_same_knots=cli_runs["idw"]["same_knots"])}))
    log(json.dumps(dpt_line(smi, dpt)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
