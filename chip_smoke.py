#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's fused inference path on one GPU.

    python3 chip_smoke.py             # all phases, report lines
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown

Phases, each fatal on failure:
  1. set-up: the card, the versions, the nvcc build of csrc/*.cu;
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the fused path's shapes (B=16, bf16) for the NTU and ZJU
     geometries, with CUDA-event times of both and of a library yardstick;
  3. the full-width NTU fused path at 640x512, B=16, K=48 (40 real
     points), bf16, on seeded random weights: three batches with the
     launch counters reset just before, output checks, fps; then the ZJU
     geometry at B=4 the same way;
  4. agreement of the card's bf16 path with the port's f32 CPU path on a
     small input with the same weights, within the CPU's own bf16 spread.
Report lines: the card's name and power limit, one {"kernels": [...]}
line, one end-to-end line; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor rate
STEM_TOL = (2.0 ** -7, 1e-4)   # (rtol, atol): one bf16 rounding step
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


def check_kernels(geometry, B=16):
    """Each kernel against its plain version at the fused path's shapes;
    returns {kernel name: record}."""
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.ops import patches
    from riders_tpu_torch.ops.kernels import compose, roi_pool, stem
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    geo = GEOMETRIES[geometry]
    ph, pw = geo["patch"]
    K, n_real = geo["bucket"], geo["real"]
    H, W = FRAME
    Hp, Wp = H + 2 * (ph // 2), W + 2 * (pw // 2)
    out = {}

    # ---- stem: 7x7/s2 conv + folded BN + leaky-relu + MaxPool2d(3,2,1)
    x = torch.rand((B, Hp, Wp, 3), generator=g, device=dev).to(
        torch.bfloat16)
    w = torch.randn((32, 3, 7, 7), generator=g, device=dev) * (2 / 147) ** .5
    scale = 0.5 + torch.rand(32, generator=g, device=dev)
    bias = 0.1 * torch.randn(32, generator=g, device=dev)
    k_out, k_pool = stem.stem_conv_pool(x, w, scale, bias)
    p_out, p_pool = stem.stem_conv_pool_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ((k_out, p_out), (k_pool, p_pool)):
        if a.shape != b.shape:
            raise AssertionError(f"stem shape {a.shape} vs {b.shape}")
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, float(diff.max()))
        limit = STEM_TOL[0] * torch.maximum(a.abs(), b.abs()) + STEM_TOL[1]
        if not bool((diff <= limit).all()):
            raise AssertionError(f"stem {geometry}: max err {err} beyond "
                                 f"one bf16 step")
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
    out["stem"] = dict(
        max_abs_err=err, tolerance="|k-p| <= 2^-7 |p| + 1e-4",
        ms=time_ms(lambda: stem.stem_conv_pool(x, w, scale, bias)),
        plain_ms=time_ms(
            lambda: stem.stem_conv_pool_plain(x, w, scale, bias)),
        library_ms=time_ms(library_stem), bound_ms=bnd, bound_by=by,
        bytes=nbytes, flops=flops,
        shapes=dict(x=list(x.shape), out=list(k_out.shape),
                    pooled=list(k_pool.shape)))

    # ---- RoI pool pyramid: skips /2 /4 /8 /16 and the latent /32
    widths = (32, 64, 128, 128, 128)
    maps, h, w_ = [], Hp, Wp
    for c in widths:
        h, w_ = -(-h // 2), -(-w_ // 2)
        maps.append(torch.randn((B, h, w_, c), generator=g, device=dev).to(
            torch.bfloat16))
    batch = make_batch(7, B, K, n_real, FRAME, dev)
    mask = batch["point_mask"]
    points, boxes = shift_points_and_boxes(batch["radar_points"], (ph, pw))
    boxes = boxes.contiguous()
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
    out["roi_pool"] = dict(
        max_abs_err=err, tolerance="bitwise",
        ms=time_ms(lambda: roi_pool.roi_pool_pyramid(
            maps[-1], maps[:-1], boxes, (ph, pw))),
        plain_ms=time_ms(lambda: patches.roi_pool_pyramid(
            maps[-1], maps[:-1], boxes, (ph, pw))),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        launches_per_call=5,
        shapes=dict(maps=[list(m.shape) for m in maps],
                    out=[list(o.shape) for o in [k_lat] + k_sk]))

    # ---- compose: per-frame thresholds, one negative; masked points
    resp = torch.rand((B, K, ph, pw), generator=g, device=dev) \
        * mask[:, :, None, None]
    thr = torch.linspace(-0.3, 0.5, B, device=dev)
    points = points.contiguous()
    k_d, k_r = compose.compose_patches(resp, points, mask, FRAME, (ph, pw),
                                       thr)
    p_d, p_r = patches.compose_patches(resp, points, mask, FRAME, (ph, pw),
                                       thr)
    torch.cuda.synchronize()
    err = max(float((k_d - p_d).abs().max()), float((k_r - p_r).abs().max()))
    if not (torch.equal(k_d, p_d) and torch.equal(k_r, p_r)):
        raise AssertionError(f"compose {geometry}: not bitwise equal "
                             f"(max err {err})")
    nbytes = 4 * (compose_read_elems(points, mask, FRAME, (ph, pw))
                  + points.numel() + mask.numel() + B
                  + k_d.numel() + k_r.numel())
    bnd, by = bound_ms(nbytes)
    out["compose"] = dict(
        max_abs_err=err, tolerance="bitwise",
        ms=time_ms(lambda: compose.compose_patches(
            resp, points, mask, FRAME, (ph, pw), thr)),
        plain_ms=time_ms(lambda: patches.compose_patches(
            resp, points, mask, FRAME, (ph, pw), thr)),
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nbytes,
        shapes=dict(responses=list(resp.shape), out=list(k_d.shape)))
    return out


def build_models(cfg, seed, device, dtype):
    """Full-width RC-Net and SML on seeded random weights.  The SML head's
    last conv is scaled down so the random network regresses scales near
    1, as a trained one does, and depth stays in the metric range."""
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner

    rcnet = init_random_(RCNet(cfg.rcnet, device, dtype), seed)
    sml = init_random_(ScaleMapLearner(cfg.sml, device, dtype), seed + 1)
    with torch.no_grad():
        sml.output_conv.conv3.weight.mul_(1e-3)
    return rcnet, sml


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
    return record, fn, batches[1]


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


def profile(fn, batch, path):
    """Device time by kernel for one fused call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    path.write_text(table)
    return table


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

    kernels = {g: check_kernels(g) for g in GEOMETRIES}
    for g, recs in kernels.items():
        for name, r in recs.items():
            log(f"kernel {name} [{g}]: max_abs_err {r['max_abs_err']} "
                f"({r['tolerance']}) kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    LAUNCHES.clear()

    ntu, ntu_fn, ntu_batch = drive("ntu", 16)
    log(f"fused ntu: {json.dumps(ntu)}")
    zju, _, _ = drive("zju", 4)
    log(f"fused zju: {json.dumps(zju)}")
    agree = reference_agreement()
    log(f"reference agreement: {json.dumps(agree)}")

    sources = {"stem": "riders_tpu_torch/csrc/stem.cu",
               "roi_pool": "riders_tpu_torch/csrc/roi_pool.cu",
               "compose": "riders_tpu_torch/csrc/compose.cu"}
    replaces = {"stem": "riders_tpu/ops/pallas/stem.py:95",
                "roi_pool": "riders_tpu/ops/pallas/roi_pool.py:138",
                "compose": "riders_tpu/ops/pallas/compose.py:35"}
    lines = []
    for name in ("stem", "roi_pool", "compose"):
        r = kernels["ntu"][name]
        lines.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces=replaces[name], launches=ntu["launches"][name],
            max_abs_err=max(kernels[g][name]["max_abs_err"]
                            for g in GEOMETRIES),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            zju=dict((k, kernels["zju"][name][k]) for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms"))))
    if "--profile" in argv:
        out_dir = HERE / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        log(profile(ntu_fn, ntu_batch, out_dir / "profile_ntu.txt"))

    details = dict(card=smi, torch=torch.__version__,
                   cuda=torch.version.cuda,
                   build_seconds=build_s, kernels=kernels,
                   fused=dict(ntu=ntu, zju=zju), reference=agree)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    log(json.dumps({"kernels": lines}))
    log(json.dumps({"fused": dict(card=smi, ntu_fps=ntu["fps"],
                                  ntu_ms=ntu["ms_per_call"],
                                  zju_fps_b4=zju["fps"],
                                  ref_median_rel_err=agree[
                                      "card_bf16_vs_cpu_f32"])}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
