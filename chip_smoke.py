#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's fused inference path, its RC-Net and
SML training steps, its staged inference, serving and drivers, its
command line (training, inference and preprocessing), its DPT Scale
Map Learner, RC-Net's other forms, its parallel layer, its opt-in fast
paths and its measuring entry points on one GPU, and score the staged
pipeline on the card against the CPU's goldens.

    python3 chip_smoke.py                 # all phases, report lines
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns
                                          # of a fused call and a step
    python3 chip_smoke.py --kernel-times  # phase 1, then only the checks
                                          # and times of B1, B2, B4, B6
                                          # and B8 (copied into another
                                          # tree's root, it times that
                                          # tree's)
    python3 chip_smoke.py --dpt           # phase 1, then phases 10 and
                                          # 11 alone on a dataset of
                                          # their own
    python3 chip_smoke.py --attention     # phase 1, then phase 10d alone
    python3 chip_smoke.py --swin2-attention  # phase 1, then phase 10e
                                          # alone
    python3 chip_smoke.py --variants      # phase 1, then phase 12 alone
    python3 chip_smoke.py --stem-plans    # phase 1, then every plan of
                                          # B1's general kernel timed at
                                          # the shapes of STEM_PLAN_SHAPES
    python3 chip_smoke.py --parallel      # phases 1 and 4, then phases
                                          # 13 and 14 alone on a dataset
                                          # of their own
    python3 chip_smoke.py --multichip     # four cards: phase 13a and
                                          # 13b across them, one NCCL
                                          # rank a card
    python3 chip_smoke.py --bench         # phase 1, then phase 15 alone
    python3 chip_smoke.py --goldens       # phase 1, then phase 16 alone
    python3 chip_smoke.py --golden-section  # phase 1, then phase 17
                                          # alone
    python3 chip_smoke.py --determinism   # phase 1, then 13d alone: the
                                          # f64 SML step's run-to-run
                                          # spread in five determinism
                                          # modes (one a diagnostic), and
                                          # the ops without a
                                          # deterministic implementation

Kernel times: `ms` is the median of synchronised calls (host dispatch
counts in); `graph_ms` replays 20 calls (10 in phase 12) captured in one
CUDA graph between two events, over that count: the device's time alone
(B1, B2, B4, B6, B8); `device_ms` times 20 calls queued back to back
(B5, B7, B8).

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
     launch and decode counters reset just before, output checks (one
     RoI pool launch and one lane decode, B7 and B8 launched, per call),
     fps; then the ZJU geometry at B=4 the same way;
  4. agreement of the card's bf16 path with the port's f32 CPU path on a
     small input with the same weights, within the CPU's own bf16 spread;
  4b. the lane-major decoder and the 4D RoI pyramid: (a) the lane conv
     (B7) and upconv (B8) kernels against their plain versions at every
     call shape of one decode_full, NTU (N = 768) and ZJU (N = 512), with
     CUDA-event times of both and of cuDNN (the median of synchronised
     calls, and back to back), a line per call; (b) the decoder's inputs
     captured from a fused B=16 call of each preset, decoded by the
     literal decoder (`MultiScaleDecoder.literal`, its phase forms off),
     by `decode_full` and by the default forward (within 5% of the
     literal's max, the default bitwise `decode_full`'s and counted
     "full"; launch and decode counters reset just before each); (c)
     the 4D pyramid (B6) on that call's encoder maps, skip1 as a
     NEG-padded canvas, bitwise equal to the B2 pyramid and the plain
     one; (d) (a) and (b) again at the benchmark cells' patch batch, NTU
     N = 6144 and ZJU N = 4096 (the B=16 call's decoder inputs tiled);
     `--lane` runs phases 1, 3 and 4b alone;
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
  10. the DPT SML at full width (of the hand-written kernels only the
     BEiT attention lies on its path, in bf16 inference; the counters
     reset just before), after the earlier phases' memory is freed: (d)
     first, the BEiT attention kernel (csrc/beit_attention.cu) against
     its plain version within one bf16 step of the output's largest
     value at the BEiT cell's shape (B=16, window 32x40, 16 heads of 64)
     and at BEiT-L/16-384's and BEiT-B/16-384's (24x24; 16 and 12
     heads), with its device ms, bound, the plain version's and SDPA's
     (a yardstick), then a BEiT-L/16-512 SML forward at 512x640, B=16,
     bf16: 24 launches and 24 "attn_kernel" counts, its ms beside the
     plain attention's (`--attention` runs phases 1 and 10d alone);
     (a) `make_infer_fn` at the NTU
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
  11. the Swin2 / Swin-V1, LeViT and Next-ViT DPT SMLs at full width, on
     phase 9's dataset, weights drawn on the host with flax's default
     initialisers and their head calibrated by a forward on the card, the
     counters reset just before (no hand-written kernel lies on these
     paths; a launch fails the phase): (a) `make_infer_fn` with
     DPT-Swin2-L (swinv2_large_window12to24_192to384) at its 384x384 net,
     NTU 640x512 frames, B=16, bf16, 10 calls: ms, spread, peak memory,
     parameters and operations over the bf16 peak; (b) its f32
     `make_train_step`, TF32 off, at B=12 (or the largest of 8, 6, 4 that
     fits): a gradient in every parameter in the first step, then ms per
     step and peak memory; (c) dpt-swin2-base and dpt-swin-large at
     384x384, dpt-swin2-tiny at 256x256, dpt-levit-224 at 224x224 and
     dpt-next-vit-large at 384x384, 3 calls each: finite depth of the
     frame's shape; (d) one B=2 step on the card against the host CPU
     by phase 7's rule, Swin2-T at 128x128, LeViT at 64x64, Next-ViT at
     64x96; (e) `validate_sml` of a step-0 checkpoint of Swin2-L, bf16 on
     the card against f32 on the host CPU: the seven metrics within 1%.
  12. RC-Net in its other forms and B1's general kernel: (a) the general
     stem kernel (csrc/stem_general.cu) against its plain version on the
     NTU bench frame (B=16, 662x690 bf16) at (Cin, Cout, k) = (3, 64,
     7), (1, 32, 7), (3, 8, 7), (3, 16, 3), (3, 32, 11) and slopes 0.2,
     0, 1, the conv map alone (pool=False) at (3, 64, 7) and relu6 with
     lead=0 (TF-SAME) at (3, 16, 3) (one bf16 step; each call one
     `stem_general` launch, and (3, 32, 7) with the pool one `stem`
     launch), with synchronised and graph times of the wrapper, the
     kernel alone on weights packed once, the plain version and cuDNN's
     conv + leaky (or clamp) + pool, and the bound; at (3, 32, 7) the
     general kernel beside the tuned one on the same inputs; (b) the
     variants at full width on seeded random weights, the counters
     reset just before each, beside the preset's plain call:
     V1 `use_batch_norm=False` (NTU B=16, `make_fused_fn`), V2
     `n_resolution=3` (ZJU B=4: NTU's 150x50 patch pools to a pyramid
     that does not double, where both packages fail) through
     `make_fused_fn` and through `RCNet(return_all_scales=True)`, V3
     stem width 64 (NTU B=16, `make_fused_fn`), V4 one input channel
     (NTU B=16, RC-Net's forward on a one-channel frame): each call one
     launch of its stem kernel, one RoI pool launch (and compose); (c)
     each variant's bf16 card output against the port's f32 CPU output
     by phase 4's rule (V4's masked logits); (d) one f32 training step
     of the BN-free n_resolution 3 RC-Net (ZJU) on the card against the
     CPU's by phase 7's rule.
  13. the parallel layer on the card, in an NCCL world of one joined by
     `initialize_multihost` on 127.0.0.1 (the machine has one card and
     NCCL takes one rank per device; more ranks are held on the CPU by
     tests/test_torch_sharding.py), mesh (1, 1): (a)
     `make_sharded_fused_fn` at phase 3's NTU shapes (640x512, B=16,
     K=48 with 40 real points, bf16, full width): one stem, one RoI pool
     and one compose launch and one gather over each mesh axis per call
     (counters reset just before), its output against `make_fused_fn`'s
     on the same batches (bitwise expected), ms per call of both; (b) the
     f32 RC-Net step (NTU, B=24) and SML step (288x352, B=12) through
     `with_data_sharding`, so through the cross-rank BatchNorm and the
     loss collectives, against the plain step by phase 7's rule, ms per
     step of both; (c) three `train-sml` steps through `riders-torch
     --multihost --num-processes 1 --process-id 0` on phase 9's dataset
     (the IDW scale map), the process group gone after; (d) opt-in,
     `--determinism` only: the plain f64 SML step of (b) twice in each
     of four modes (PyTorch's defaults, cuDNN's deterministic flag,
     `use_deterministic_algorithms`, both; CUBLAS_WORKSPACE_CONFIG=
     :4096:8), and under the defaults with the SML's bilinear resizes
     in f64 (a diagnostic), the spread of each pair and the ops that
     warn that they have no deterministic implementation;
  14. the opt-in fast paths at full width (NTU, B=16, bf16), each alone
     and then all together, the counters reset just before each:
     RIDERS_SML_FOLD=1 (set and unset inside the phase), the literal
     decoder's (`MultiScaleDecoder.literal`) `phase_tail=True` and every
     `UpConvBlock(fast_2x=True)`: one stem, RoI pool and compose launch a
     call, the output against the literal call's by phase 4's rule, ms
     per call beside the literal call's, and fps.
  15. the measuring entry points, under PyTorch's default TF32 and cuDNN
     settings: (a) `riders_tpu_torch.bench.measure` at NTU and ZJU
     (640x512, B=16, bf16, full width): the fused call captured as a CUDA
     graph holds one stem, one RoI pool and one compose launch (and one
     decode's B7 / B8 launches), its
     replayed depth equals an eager call's on the same input (bitwise,
     else phase 4's rule, the difference logged), finite and positive on
     more than 95% of pixels; graph-replay and eager ms per call; (b)
     `tools.bench_train` rcnet and sml (ZJU presets), 5 timed steps each,
     the RC-Net step launching B2's f32 forward and B5; (c)
     `tools.bench_serving` cut to 32 frames and 1 epoch (of 128 and 2);
     (d) `tools.profile_bench` at NTU by graph replay and eagerly: the
     three kernels among the traced device events, the busy share.
  16. golden parity of the staged pipeline from disk: a ZJU-layout
     dataset of 2 validation scenes x 3 frames at the preset's 480x640
     written under build/ from a seed, RC-Net and the midas-small SML at
     the ZJU preset's full widths on seeded weights saved as checkpoints;
     `run_rcnet` then `validate_sml(save_output=True)` on the card in
     bf16 (one stem and one RoI pool launch and 1 + rounds compose
     launches a frame, counted) and on the host CPU in f32 (no launch);
     `tools.compare_goldens` on (CPU tree, card tree) with --root: within
     its 1% budget on mae, rmse and delta1, its per-scene deviations equal
     to a numpy recomputation from the two trees; seconds of each staged
     run and the stage-2 maps' card-vs-CPU deviation; beside it, reported
     and not judged, the fused phases' He-normal SML through the same
     tool and the bf16 drift of both SMLs at the backbone's four taps.
  17. stage 1's golden-section search (csrc/golden_section.cu): (a) the
     kernel at the cells' rows, (64, 512) and (16, 512) with 96 and 64
     returns a frame, against the plain loop on the card (the float64
     objective at the kernel's scale within 1e-6 relative of the one at
     the loop's), an all-zero-mask batch bitwise the loop's, one launch
     a call; graph-replay (the device alone), back-to-back and
     synchronised us of the kernel beside the loop's synchronised and
     back-to-back ms; (b) the fused call at the
     lite cells' shapes (NTU and ZJU, B=64, 96 and 64 returns a frame,
     bf16, full width): one launch a call and no plain loop on the card,
     then host ms (call to return) and synchronised ms a call with the
     kernel and with the plain loop patched in, in alternating pairs.
Report lines: the card's name and power limit, one {"kernels": [...]}
line, one fused line, one lane_decoder line, one training line, one
staged line, one training_cli line, one dpt line, one dpt_families line,
one rcnet_variants line, one parallel line, one bench line, one
goldens line, one golden_section line; the last line is {"ok": true,
"device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""

import contextlib
import copy
import inspect
import json
import math
import os
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
# the patch batch of the benchmark's offline cells: B=64 frames of 96
# (NTU) and 64 (ZJU) points
CELL_PATCHES = {"ntu": 6144, "zju": 4096}
FRAME = (512, 640)             # the benchmark resolution (H, W)
ZJU_FRAME = (480, 640)         # the ZJU preset's frame (H, W)


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


def paired_ms(fa, fb, n=20, warmup=3):
    """Median CUDA-event times of `fa` and `fb` over n pairs of calls,
    the order alternating from pair to pair, so that drift in the host's
    load falls on both."""
    import torch
    for _ in range(warmup):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(n):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fa, fb)[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


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


def stem_max_err(k_maps, p_maps, what):
    """The stem kernel's max abs error against the plain version over
    both outputs, raising on a shape mismatch or beyond one bf16 step."""
    import torch
    err = 0.0
    for a, b in zip(k_maps, p_maps):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, float(diff.max()))
        limit = STEM_TOL[0] * torch.maximum(a.abs(), b.abs()) + STEM_TOL[1]
        if not bool((diff <= limit).all()):
            raise AssertionError(f"{what}: max err {err} beyond one bf16 "
                                 f"step")
    return err


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
        return stem_max_err(k_maps, p_maps, f"stem {geometry} {slope}"), \
            k_maps

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
    # the kernel alone, on weights packed once as FusedStemConv keeps them
    # (the wrapper packs per call); a parent tree without `stem_apply`
    # through its private launcher
    if hasattr(stem, "stem_apply"):
        sw = stem.stem_weights(w, scale, bias)
        launch = lambda: stem.stem_apply(x, sw)
    elif hasattr(stem, "_launch"):
        wk, bk = stem.pack_weights(w, scale), bias.float().contiguous()
        launch = lambda: stem._launch(x, wk, bk)
    else:
        launch = None
    out["stem"] = dict(
        max_abs_err=err, tolerance="|k-p| <= 2^-7 |p| + 1e-4",
        ms=time_ms(run), graph_ms=graph_ms(run),
        kernel_ms=time_ms(launch) if launch else None,
        kernel_graph_ms=graph_ms(launch) if launch else None,
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
    """The fused path at full width: three batches with the launch and
    decode counters reset just before, output checks, then timing."""
    import dataclasses
    import torch
    from riders_tpu_torch.core.config import ntu_config, zju_config
    from riders_tpu_torch.models.lane_decode import DECODES
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
    DECODES.clear()
    t0 = time.perf_counter()
    outs = [fn(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for name in ("stem", "roi_pool", "compose", "lane_conv3x3",
                 "lane_upconv2x"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{preset}: kernel {name} was not launched "
                                 f"on the fused path ({launches})")
    if dict(DECODES) != {"full": len(batches)}:
        raise AssertionError(f"{preset}: decoder paths {dict(DECODES)} in "
                             f"{len(batches)} calls, not one lane decode "
                             f"(decode_full) per call")
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


def variant_config(preset, frame, K, **rcnet):
    """The preset at `frame` with a K-point bucket and its RC-Net config
    changed by `rcnet`."""
    import dataclasses
    cfg = train_config(preset)
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=frame,
                                    max_points=K),
        rcnet=dataclasses.replace(cfg.rcnet, **rcnet))


def rcnet_call(cfg, rcnet, batch, return_logits=False, **kw):
    """RC-Net's forward on a make_batch batch as the fused path calls it
    (edge-padded frame, shifted points and boxes), its frame cut to the
    model's input channels; masked responses (or logits)."""
    import torch
    from riders_tpu_torch.ops.resize import edge_pad2d
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)
    ph, pw = cfg.rcnet.patch_size
    dtype = next(rcnet.parameters()).dtype
    dev = next(rcnet.parameters()).device
    image = batch["image"][..., :cfg.rcnet.input_channels_image]
    padded = edge_pad2d(image.to(dev, dtype), ph // 2, pw // 2)
    points, boxes = shift_points_and_boxes(batch["radar_points"].to(dev),
                                           (ph, pw))
    with torch.inference_mode():
        return rcnet(padded, points, boxes, batch["point_mask"].to(dev),
                     return_logits=return_logits, **kw)


def reference_agreement(seed=3, preset="ntu", rcnet=None, path="fused"):
    """The card's bf16 path against the port's f32 CPU path, same seeded
    weights, a small frame at the preset's full widths (`rcnet` changes
    its RC-Net config; `path` "rcnet" compares RC-Net's masked logits
    alone, not fused depth: its random-weight responses saturate at 0
    and 1).  bf16 alone moves depth by a few percent on these
    random weights (their SML activations grow to ~100), so the bar is
    the CPU's own bf16-vs-f32 spread: the card's median relative error
    must stay within 1.5x of it plus 0.5%."""
    import dataclasses
    import torch
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    frame, B, K, n_real = (128, 160), 2, 8, 6
    cfg = variant_config(preset, frame, K, **(rcnet or {}))
    cfg = cfg.replace(sml=dataclasses.replace(cfg.sml, net_shape=(96, 128)))
    batch = make_batch(seed, B, K, n_real, frame, "cpu")

    def run(device, dtype):
        models = build_models(cfg, seed, device, dtype)
        if path == "rcnet":
            return rcnet_call(cfg, models[0], batch,
                              return_logits=True).float().cpu()
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
    """The captured decoder inputs through the literal decoder
    (`MultiScaleDecoder.literal`, its phase forms off), and through
    `decode_full` and the default forward of a copy (same weights): each
    within LANE_DECODE_BAR of the literal's max, the default bitwise
    `decode_full`'s, B7 and B8 launched, the default forward counted
    "full" in DECODES (counters reset just before each decode), ms per
    decode synchronised and back to back (`device_ms`)."""
    import torch
    from riders_tpu_torch.models import lane_decode
    from riders_tpu_torch.models.layers import UpConvBlock
    from riders_tpu_torch.ops.kernels import LAUNCHES

    rec = dict(preset=preset, patches=int(x.shape[0]))
    dec = copy.deepcopy(literal)
    literal = copy.deepcopy(literal)
    literal.phase_tail = False          # the literal decoder
    for m in literal.modules():
        if isinstance(m, UpConvBlock):
            m.fast_2x = False
    paths = {"full": (lambda: lane_decode.decode_full(dec, x, skips), {}),
             "default": (lambda: dec(x, skips), {"full": 1})}
    with torch.inference_mode():
        want = literal.literal(x, skips).float()
        rec["literal_ms"] = time_ms(lambda: literal.literal(x, skips), n=10,
                                    warmup=2)
        rec["literal_device_ms"] = device_ms(
            lambda: literal.literal(x, skips), n=10, warmup=1)
        outs = {}
        for name, (run, decodes) in paths.items():
            run()                                          # packs weights
            torch.cuda.synchronize()
            LAUNCHES.clear()
            lane_decode.DECODES.clear()
            out = outs[name] = run()
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            for k in ("lane_conv3x3", "lane_upconv2x"):
                if launches.get(k, 0) <= 0:
                    raise AssertionError(f"{preset} {name}: kernel {k} was "
                                         f"not launched ({launches})")
            if dict(lane_decode.DECODES) != decodes:
                raise AssertionError(f"{preset} {name}: decodes "
                                     f"{dict(lane_decode.DECODES)}")
            if out.shape != want.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{preset} {name}: output {out.shape} "
                                     f"vs {want.shape}, or not finite")
            rel = float((out.float() - want).abs().max()
                        / want.abs().max())
            if rel > LANE_DECODE_BAR:
                raise AssertionError(f"{preset} {name}: max |lane - literal|"
                                     f" / max|literal| = {rel}")
            rec[name] = dict(
                launches=launches, rel_err=rel,
                ms=time_ms(run, n=10, warmup=2),
                device_ms=device_ms(run, n=10, warmup=1))
        if not torch.equal(outs["default"], outs["full"]):
            raise AssertionError(f"{preset}: the default decoder is not "
                                 f"decode_full bit for bit")
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
    decode's shapes, then the decoders and B6 on a captured B=16 call;
    then the kernels and the decoders again at the benchmark cells'
    patch batch (CELL_PATCHES; the B=16 call's decoder inputs tiled)."""
    import torch
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)

    kernels, decoders, cells = {}, {}, {}
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
        x, skips = cap["decoder"]
        del cap
        reps = CELL_PATCHES[preset] // x.shape[0]
        # NCHW views of NHWC memory, as the fused path hands them over
        tile = lambda t: t.permute(0, 2, 3, 1).repeat(
            reps, 1, 1, 1).permute(0, 3, 1, 2)
        x, skips = tile(x), [tile(t) for t in skips]
        torch.cuda.empty_cache()
        cells[preset] = dict(
            kernels=check_lane_kernels(
                preset, B=CELL_PATCHES[preset] // geo["bucket"]),
            decoder=drive_lane_decoder(preset, x, skips, rcnet.decoder))
        del x, skips
        torch.cuda.empty_cache()
    return kernels, decoders, cells


def log_lane(kernels, decoders, cells):
    """Phase 4b's log lines: each kernel record, each decoder record, and
    the cells' B7 / B8 calls and decoders."""
    for g, recs in kernels.items():
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
        log(f"lane decoder [{g}]: {json.dumps(decoders[g])}")
    for g, rec in cells.items():
        for name, r in rec["kernels"].items():
            log(f"kernel {name} [{g}, cells' N]: max_abs_err "
                f"{r['max_abs_err']} calls {r['calls_per_decode']} back to "
                f"back: kernel {r['device_ms']:.4f} ms library "
                f"{r['library_device_ms']:.4f} ms bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']})")
        log(f"lane decoder [{g}, cells' N]: {json.dumps(rec['decoder'])}")


def lane_line(smi, decoders, cells):
    """The {"lane_decoder": ..} line: per preset at B=16 and at the
    cells' patch batch, each path's synchronised and back-to-back ms per
    decode and its max error against the literal decoder, and the B7 /
    B8 back-to-back ms of one decode at the cells' batch."""
    def paths(r):
        out = dict(patches=r["patches"], literal_ms=r["literal_ms"],
                   literal_device_ms=r["literal_device_ms"])
        for mode in ("full", "default"):
            out.update({f"{mode}_ms": r[mode]["ms"],
                        f"{mode}_device_ms": r[mode]["device_ms"],
                        f"{mode}_rel_err": r[mode]["rel_err"]})
        return out
    line = {g: paths(r) for g, r in decoders.items()}
    for g, rec in cells.items():
        line[f"{g}_cells"] = dict(paths(rec["decoder"]), **{
            f"{k}_device_ms": r["device_ms"]
            for k, r in rec["kernels"].items()})
    return {"lane_decoder": dict(card=smi, **line)}


def lane_only(smi):
    """`--lane`: phase 1, the fused NTU B=16 and ZJU B=4 calls of phase 3
    (the weights phase 4b decodes with), and phase 4b; one
    {"lane_decoder": ..} line."""
    import torch
    _, ntu_fn, _, ntu_rcnet = drive("ntu", 16)
    _, zju_fn, _, zju_rcnet = drive("zju", 4)
    kernels, decoders, cells = lane_phase({"ntu": (ntu_fn, ntu_rcnet),
                                           "zju": (zju_fn, zju_rcnet)})
    log_lane(kernels, decoders, cells)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_lane.json").write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, lane_kernels=kernels,
        lane_decoder=decoders, lane_cells=cells), indent=1))
    log(json.dumps(lane_line(smi, decoders, cells)))
    log(smi)
    return 0


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


def training_agreement(seed=5, preset="ntu", rcnet=None):
    """One RC-Net training step on the card in f32 against the port's f32
    CPU step: the same seeded weights at the preset's full widths (NTU
    unless `preset` says otherwise; `rcnet` changes its RC-Net config), a
    small frame, B=2 with 4 points.  The loss to rtol 1e-4.  Each
    gradient's max abs error, relative to its max abs, within 1e-3, or
    within 3x the CPU's own spread for that tensor: the largest change
    of the CPU's gradient when a random half of the input pixels moves
    by one f32 ulp (two draws).  At random initialisation the train-mode
    network is that sensitive: such a nudge moves some of the CPU's own
    gradients by several percent.  The padded frame is random everywhere, not edge-
    padded: edge padding makes exactly tied maxima in the border, where
    the RoI backward sends each tied element the full cotangent, so any
    rounding that breaks a tie moves a gradient by whole cotangents."""
    import dataclasses
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines import rcnet_training

    cfg = train_config(preset)
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=(96, 128)),
        rcnet=dataclasses.replace(cfg.rcnet, **(rcnet or {})),
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


def write_scene(root, scene, n_frames, seed, frame=FRAME):
    """A mini-dataset scene of `frame`-sized frames (NTU's 512x640 by
    default): thermal PNGs, the x256 PNG16 mono prior and lidar GT,
    sparse radar PNGs of 40 returns, from a smooth seeded depth field."""
    import numpy as np
    from PIL import Image
    from riders_tpu_torch.io import depthio
    rng = np.random.default_rng(seed)
    H, W = frame
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
        write_scene(root, scene, n_frames, seed)
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

    out = {}
    ckpt = {k: root / f"ckpt_{k}" for k in ("rcnet", "sml_interp", "sml")}
    write_scene(root, "train", n_train, seed)
    write_scene(root, "val", n_val, seed + 1)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            config, "ntu_config", _cadence(config.ntu_config, steps)))
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
# phase 11: the hierarchical families at the reference's nets (its swin
# tables fix 384x384 / 256x256, LeViT's bias tables 224x224), and the
# nets of their card-vs-CPU steps
FAMILY_MAIN = "dpt-swin2-large"     # swinv2_large_window12to24_192to384
FAMILY_NETS = {"dpt-swin2-large": (384, 384), "dpt-swin2-base": (384, 384),
               "dpt-swin-large": (384, 384), "dpt-swin2-tiny": (256, 256),
               "dpt-levit-224": (224, 224),
               "dpt-next-vit-large": (384, 384)}
FAMILY_STEP_NETS = {"dpt-swin2-tiny": (128, 128), "dpt-levit-224": (64, 64),
                    "dpt-next-vit-large": (64, 96)}
# parameters no output reaches: levit_384's blocks after its last hook (21)
UNREACHED = {"dpt-levit-224": tuple(f"pretrained.blocks_{i}."
                                    for i in range(22, 28))}
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def dpt_config(model_type, **sml):
    """The NTU preset (512x640 frames, SML net 288x352) with a DPT SML."""
    import dataclasses
    cfg = train_config("ntu")
    return cfg.replace(sml=dataclasses.replace(cfg.sml,
                                               model_type=model_type, **sml))


def sml_weights(cfg, seed, device="cpu", head="head_conv3"):
    """Seeded f32 weights of cfg's SML (a DPT, or midas-small with
    head="output_conv.conv3"), with flax's default initialisers
    (`init_training_`, drawn on the host whatever `device` the model and
    the calibrating forward run on), then its head's last conv set so
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
    model = init_training_(build_sml_model(cfg, device, torch.float32),
                           seed)
    head = model.get_submodule(head)
    b = make_sml_train_batch(cfg, seed + 60, device, B=1)
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
                  profile_dir=None, net=None,
                  profile_file="profile_dpt_infer.txt"):
    """Phase 10a: make_infer_fn with a DPT SML at the NTU preset (its SML
    net, or `net`), bf16, B frames: finite depth of the frame's shape and
    finite metrics, ms per call (CUDA events, after warm-up) with its
    spread, peak memory, parameters, and the call's operations over the
    bf16 peak (its bound)."""
    import torch
    from riders_tpu_torch.models import dpt as tdpt
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.sml_inference import make_infer_fn
    cfg = dpt_config(model_type, **({"net_shape": net} if net else {}))
    model = build_dpt(cfg, weights, None, torch.bfloat16)
    batch = make_sml_train_batch(cfg, seed + 40, "cuda", B=B)
    fn = make_infer_fn(cfg, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tdpt.COUNTS.clear()
    n0 = LAUNCHES["beit_attention"]
    out = fn(batch)
    attention = dict(launches=LAUNCHES["beit_attention"] - n0,
                     **{k: tdpt.COUNTS[k] for k in (
                         "forwards", "attn_kernel", "attn_plain")})
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
        log(profile(fn, batch, profile_dir / profile_file))
    return dict(model_type=model_type, batch=B,
                net=list(cfg.sml.net_shape), dtype="bfloat16",
                params=sum(p.numel() for p in model.parameters()),
                ms_per_call=statistics.median(ms), ms_min=min(ms),
                ms_max=max(ms), n_calls=n,
                frames_per_s=B / (statistics.median(ms) / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                flops_per_call=flops,
                bound_ms=flops / BF16_FLOP_PER_S * 1e3, attention=attention)


def dpt_training(weights, seed=0, profile_dir=None, model_type=DPT_MAIN,
                 net=None, B=None, profile_file="profile_dpt_train.txt"):
    """Phase 10b: make_train_step with BEiT-L at the NTU SML preset (B=12,
    f32, TF32 off): a gradient in every parameter in the first step from
    `weights`; then three steps with every parameter moved and finite
    losses (`_train_phase`), ms per step, peak memory, and a step's
    operations over the f32 peak; then ms per step with cuDNN's TF32
    convolutions (PyTorch's default, which this script turns off; the
    matmuls stay f32).  The first Adam update at the preset's
    rate (5e-5 on each of 0.34 B random parameters) drives the head's
    pre-activation below 0 at every pixel, so the later steps' gradients
    are 0 (the step's work is the same).  `model_type`, `net` and `B`
    select another DPT, SML net and batch (phase 11b)."""
    import torch
    from riders_tpu_torch.pipelines import sml_training
    cfg = dpt_config(model_type, **({"net_shape": net} if net else {}))
    model = build_dpt(cfg, weights, None, torch.float32)
    state = sml_training.init_train_state(cfg, model, 1000)
    B = B or cfg.sml_train.batch_size
    batches = [make_sml_train_batch(cfg, seed + 50 + i, "cuda", B=B)
               for i in range(3)]
    step = sml_training.make_train_step(cfg)
    _, aux = step(state, batches[0])
    dead = [k for k, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.any())]
    if dead or not math.isfinite(float(aux["loss"])):
        raise AssertionError(f"{model_type}: first step loss "
                             f"{float(aux['loss'])}, "
                             f"{len(dead)} parameters without a gradient: "
                             f"{dead[:8]}")
    first_loss = float(aux["loss"])
    rec = _train_phase(model_type, state, step, batches, (), B,
                       check_grads=False)
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
                    profile_dir / profile_file))
    rec.update(net_shape=list(cfg.sml.net_shape), flops_per_step=flops,
               bound_ms=flops / FP32_FLOP_PER_S * 1e3)
    return rec


def dpt_step_agreement(weights, seed=5, model_type=DPT_MAIN, net=(64, 96)):
    """Phase 10b: one BEiT-L SML training step (f32, B=2, net 64x96, 96x128
    frames; phase 11d: `model_type` at `net`) on the card against the
    same step on the host CPU, by phase
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
    cfg = dpt_config(model_type, net_shape=net)
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset,
                                                  image_shape=(96, 128)))
    batch = make_sml_train_batch(cfg, seed, "cpu", B=2)
    step = sml_training.make_train_step(cfg)

    def run(device, b):
        model = build_dpt(cfg, weights, device, torch.float32)
        state = sml_training.init_train_state(cfg, model, 1000)
        _, aux = step(state, b)
        # a parameter the forward does not reach (LeViT's blocks after
        # its last hook) has no gradient: 0, as JAX gives it
        return float(aux["loss"]), {
            k: (p.grad.detach().cpu() if p.grad is not None
                else torch.zeros_like(p, device="cpu"))
            for k, p in model.named_parameters()}

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
    unreached = [k for k in g_cpu
                 if k.startswith(UNREACHED.get(model_type, ()))]
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
    zero = [k for k, g in g_cpu.items()
            if k not in unreached and not bool(g.any())]
    res = dict(loss_cpu=loss_cpu, loss_card=loss_card,
               loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
               cpu_loss_spread=max(abs(v - loss_cpu) for v in losses)
               / abs(loss_cpu),
               worst_grad_rel_err=card[worst], worst_grad=worst,
               cpu_spread_there=spread[worst],
               worst_cpu_spread=max(spread.values()),
               grads_over_1e3=sum(e > 1e-3 for e in card.values()),
               median_grad_rel_err=sorted(card.values())[len(card) // 2],
               n_grads=len(g_cpu), zero_grads=zero, failing=bad,
               unreached=len(unreached))
    if (res["loss_rel_err"] > 1e-4 or bad or len(zero) * 10 > len(g_cpu)
            or any(bool(g_cpu[k].any()) for k in unreached)):
        raise AssertionError(f"{model_type} card vs CPU training step: "
                             f"{res}")
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


# phase 10d: the BEiT attention kernel (csrc/beit_attention.cu) at the
# BEiT cell's shape (BEiT-L/16-512 at 512x640) and at BEiT-L/16-384's and
# BEiT-B/16-384's (384x384): name: (B, window, heads)
BEIT_ATTENTION_SHAPES = {
    "beitl16_512_512x640": (16, (32, 40), 16),
    "beitl16_384_384x384": (16, (24, 24), 16),
    "beitb16_384_384x384": (16, (24, 24), 12),
}


def bf16_step(x):
    """One bf16 step (2^-7 of the binade) at the largest |x|."""
    return 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


def check_beit_attention(seed=0):
    """Phase 10d (a): the BEiT attention kernel on seeded N(0, 1) qkv rows
    (bf16) and tables (f32) at each of BEIT_ATTENTION_SHAPES, against
    float32 attention on the same bf16 inputs within one bf16 step of the
    output's largest value (the kernel rounds its f32 output once), and
    against `beit_attention_plain` within that step beyond the plain
    version's own distance from the float32 attention (the plain version
    rounds q k^T to bf16 before its f32 softmax, which puts it up to two
    steps from it at the BEiT cell's shape).  Device ms back to back of
    the kernel, the plain version and, as a yardstick the port never
    calls, SDPA with the gathered bias cast to bf16 (`library_ms`), beside
    the bound (4 B H N^2 d operations at the bf16 rate)."""
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.ops.kernels.attention import (
        HEAD_DIM, _rel_index, beit_attention, beit_attention_plain,
        table_rows)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (B, grid, H) in BEIT_ATTENTION_SHAPES.items():
        gh, gw = grid
        N, C = gh * gw + 1, H * HEAD_DIM
        qkv = torch.randn((B, N, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
        table = torch.randn((H, table_rows(grid)), generator=g,
                            device="cuda")
        n0 = LAUNCHES["beit_attention"]
        got = beit_attention(qkv, table, grid, H)
        torch.cuda.synchronize()
        launches = LAUNCHES["beit_attention"] - n0
        plain = beit_attention_plain(qkv, table, grid, H)
        bias = table[:, _rel_index(grid, table.device)].reshape(H, N, N)
        q, k, v = (t.contiguous() for t in qkv.reshape(
            B, N, 3, H, HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0))
        logits = (q.float() @ k.float().transpose(-2, -1)) / math.sqrt(
            HEAD_DIM) + bias[None]
        ref = (logits.softmax(-1) @ v.float()).transpose(1, 2).reshape(
            B, N, C)
        del logits
        err = float((got.float() - plain.float()).abs().max())
        tol = bf16_step(ref)
        rec = dict(
            batch=B, window=list(grid), tokens=N, heads=H,
            launches=launches, max_abs_err=err, tolerance=tol,
            finite=bool(torch.isfinite(got).all()),
            kernel_vs_f32_max_abs=float((got.float() - ref).abs().max()),
            plain_vs_f32_max_abs=float((plain.float() - ref).abs().max()),
            kernel_vs_f32_rel_l1=float((got.float() - ref).abs().sum()
                                       / ref.abs().sum()),
            plain_vs_f32_rel_l1=float((plain.float() - ref).abs().sum()
                                      / ref.abs().sum()))
        del ref, plain, got
        mask = bias.to(torch.bfloat16)[None]
        rec.update(
            ms=device_ms(lambda: beit_attention(qkv, table, grid, H)),
            plain_ms=device_ms(lambda: beit_attention_plain(qkv, table, grid,
                                                            H), n=5),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), n=10),
            bound_ms=4.0 * B * H * N * N * HEAD_DIM / BF16_FLOP_PER_S * 1e3)
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        log(f"beit attention {name}: {json.dumps(rec)}")
        out[name] = rec
        del qkv, table, bias, q, k, v, mask
        torch.cuda.empty_cache()
        if (launches != 1 or not rec["finite"]
                or rec["kernel_vs_f32_max_abs"] > tol
                or err > rec["plain_vs_f32_max_abs"] + tol):
            raise AssertionError(f"beit attention {name}: {rec}")
    return out


def beit_sml_forward(B=16, net=(512, 640), seed=0, profile_dir=None):
    """Phase 10d (b): a BEiT-L/16-512 SML (built on the card, bf16, its
    initial weights) at the BEiT cell's net, grad off: one forward must
    launch the attention kernel 24 times and count 24 "attn_kernel" and
    no "attn_plain" in `models.dpt.COUNTS`; the forward's device ms back
    to back, beside the same forward with every block's attention on the
    plain version, and the relative L1 distance of the two forwards'
    last encoder taps (24 blocks of bf16 residual stream; the head's
    initial weights leave the scale map at 1, so the depth is equal).
    With `profile_dir`, a torch.profiler table of one forward."""
    import torch
    from unittest import mock
    from riders_tpu_torch.models import dpt as tdpt
    from riders_tpu_torch.models.factory import build_sml_model
    from riders_tpu_torch.ops.kernels import LAUNCHES
    cfg = dpt_config(DPT_MAIN, net_shape=net)
    model = build_sml_model(cfg, "cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, *net, 3), generator=g, device="cuda")
    d = torch.rand((B, *net, 1), generator=g, device="cuda") + 0.5
    taps = []
    model.pretrained.register_forward_hook(
        lambda m, i, o: taps.append(o[0][-1].float()))
    with torch.inference_mode():
        tdpt.COUNTS.clear()
        n0 = LAUNCHES["beit_attention"]
        pred = model(x, d)[0]
        torch.cuda.synchronize()
        counts = dict(tdpt.COUNTS)
        launches = LAUNCHES["beit_attention"] - n0
        with mock.patch.object(tdpt, "attention_path",
                               lambda *a: "plain"):
            model(x, d)
        kernel_tap, plain_tap = taps[:2]
        taps.clear()
        ms = device_ms(lambda: model(x, d), n=5, warmup=1)
        with mock.patch.object(tdpt, "attention_path",
                               lambda *a: "plain"):
            plain_ms = device_ms(lambda: model(x, d), n=3, warmup=1)
        taps.clear()
        if profile_dir is not None:
            log(profile(lambda _: model(x, d), None,
                        profile_dir / "profile_beit_sml.txt"))
    rec = dict(batch=B, net=list(net), launches=launches, counts=counts,
               ms=ms, plain_ms=plain_ms,
               finite=bool(torch.isfinite(pred).all()),
               last_tap_rel_l1=float((kernel_tap - plain_tap).abs().sum()
                                     / plain_tap.abs().sum()))
    log(f"beit sml forward: {json.dumps(rec)}")
    depth = model.config.depth
    if (launches != depth or counts.get("attn_kernel") != depth
            or counts.get("attn_plain", 0) != 0
            or counts.get("forwards") != 1 or not rec["finite"]):
        raise AssertionError(f"beit sml forward: {rec}")
    return rec


def attention_phase(profile_dir=None):
    """Phase 10d: the kernel's checks and times, then the SML forward."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = dict(kernel=check_beit_attention(),
               sml_forward=beit_sml_forward(profile_dir=profile_dir))
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def attention_only(smi, profile_dir):
    """`--attention`: phase 1, then phase 10d alone."""
    out = attention_phase(profile_dir)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_attention.json").write_text(json.dumps(out,
                                                                  indent=1))
    log(json.dumps({"beit_attention": dict(card=smi, **out)}))
    log(smi)
    return 0


# phase 10e: the Swin V2 window attention kernel (csrc/swin2_attention.cu)
# at the Swin2 cell's shapes (Swin2-L at 384x384, B=16: each stage's
# windows, shifted where its blocks shift) and Swin2-T's w = 16 and 8:
# name: (frames, grid, window, shift, heads, blocks a forward)
SWIN2_ATTENTION_SHAPES = {
    "L0_96x96_w24": (16, (96, 96), 24, 0, 6, 1),
    "L0_96x96_w24_shifted": (16, (96, 96), 24, 12, 6, 1),
    "L1_48x48_w24": (16, (48, 48), 24, 0, 12, 1),
    "L1_48x48_w24_shifted": (16, (48, 48), 24, 12, 12, 1),
    "L2_24x24_w24": (16, (24, 24), 24, 0, 24, 18),
    "L3_12x12_w12": (16, (12, 12), 12, 0, 48, 2),
    "T0_64x64_w16_shifted": (16, (64, 64), 16, 8, 3, 0),
    "T3_8x8_w8": (16, (8, 8), 8, 0, 24, 0),
}


def check_swin2_attention(seed=0):
    """Phase 10e (a): the Swin V2 attention kernel on seeded N(0, 1) qkv
    rows (bf16), an N(0, 4) position-bias MLP output and logit scales
    from 3 to 900 (the last heads clamped at 100), at each of
    SWIN2_ATTENTION_SHAPES, against float32 attention on the same bf16
    inputs (q and k normalised and rounded as both versions do) within
    two bf16 steps of the output's largest value (one for the output's
    and P's rounding, one for a q^ or k^ element that rounds to the next
    bf16 value where the two norms' sums of squares differ in their last
    bit, which a logit scale of 100 turns into ~1 step of a near one-hot
    row's output), with a mean error no larger than the plain version's,
    and against `swin2_attention_plain` within those steps beyond the
    plain version's own distance from the float32 attention (it rounds
    q^ k^^T to bf16, which the logit scale multiplies).  Device ms back
    to back of the kernel, the plain version and, as a yardstick the port
    never calls, SDPA on q^ scaled per head, k^, v and the bias plus mask
    as one bf16 (Bw, H, N, N) tensor (`library_ms`), beside the bound
    (4 Bw H N^2 d operations at the bf16 rate); and a Swin2-L forward's
    attention ms (the shapes' ms times their blocks a forward)."""
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.ops.kernels import swin2_attention as sw
    g = torch.Generator(device="cuda").manual_seed(seed)
    out, forward_ms = {}, 0.0
    for name, (B, grid, w, shift, H, blocks) in \
            SWIN2_ATTENTION_SHAPES.items():
        Bw = B * (grid[0] // w) * (grid[1] // w)
        N, C = w * w, H * sw.HEAD_DIM
        qkv = torch.randn((Bw, N, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
        table = 2 * torch.randn((H, (2 * w - 1) ** 2), generator=g,
                                device="cuda")
        scale = torch.clamp(torch.logspace(math.log10(3.0),
                                           math.log10(900.0), H,
                                           device="cuda"), max=100.0)
        args = (qkv, table, scale, w, shift, grid, H)
        n0 = LAUNCHES["swin2_attention"]
        got = sw.swin2_attention(*args)
        torch.cuda.synchronize()
        launches = LAUNCHES["swin2_attention"] - n0
        plain = sw.swin2_attention_plain(*args)
        q, k, v = (sw.split_heads(t, H) for t in qkv.chunk(3, dim=-1))
        qn, kn = sw.l2_normalize(q), sw.l2_normalize(k)
        bias = 16 * torch.sigmoid(table.t()[sw.pair_index(w, "cuda")]
                                  ).reshape(N, N, H).permute(2, 0, 1)
        mask = sw.grid_mask(grid, w, shift, "cuda")
        logits = (qn.float() @ kn.float().transpose(-2, -1)
                  * scale[:, None, None] + bias)
        ref = (sw.masked_softmax(logits, mask) @ v.float()).transpose(
            1, 2).reshape(Bw, N, C)
        del logits
        err = float((got.float() - plain.float()).abs().max())
        tol = 2 * bf16_step(ref)
        rec = dict(
            frames=B, grid=list(grid), window=w, shift=shift, heads=H,
            windows=Bw, tokens=N, blocks_a_swin2l_forward=blocks,
            launches=launches, max_abs_err=err, tolerance=tol,
            finite=bool(torch.isfinite(got).all()),
            kernel_vs_f32_max_abs=float((got.float() - ref).abs().max()),
            plain_vs_f32_max_abs=float((plain.float() - ref).abs().max()),
            kernel_vs_f32_rel_l1=float((got.float() - ref).abs().sum()
                                       / ref.abs().sum()),
            plain_vs_f32_rel_l1=float((plain.float() - ref).abs().sum()
                                      / ref.abs().sum()))
        del ref, plain, got
        qs = (qn.float() * scale[:, None, None]).to(torch.bfloat16)
        full = bias[None] if mask is None else (
            bias[None] + mask[:, None]).repeat(B, 1, 1, 1)
        full = full.to(torch.bfloat16)
        rec.update(
            ms=device_ms(lambda: sw.swin2_attention(*args)),
            plain_ms=device_ms(lambda: sw.swin2_attention_plain(*args),
                               n=3, warmup=1),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qs, kn, v, attn_mask=full, scale=1.0), n=10),
            bound_ms=4.0 * Bw * H * N * N * sw.HEAD_DIM
            / BF16_FLOP_PER_S * 1e3)
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        forward_ms += blocks * rec["ms"]
        log(f"swin2 attention {name}: {json.dumps(rec)}")
        out[name] = rec
        del qkv, table, scale, bias, q, k, v, qn, kn, qs, full, mask
        torch.cuda.empty_cache()
        if (launches != 1 or not rec["finite"]
                or rec["kernel_vs_f32_max_abs"] > tol
                or rec["kernel_vs_f32_rel_l1"] > rec["plain_vs_f32_rel_l1"]
                or err > rec["plain_vs_f32_max_abs"] + tol):
            raise AssertionError(f"swin2 attention {name}: {rec}")
    out["swin2l_forward_attention_ms"] = forward_ms
    log(f"swin2 attention, a Swin2-L forward's 24 blocks: {forward_ms} ms")
    return out


def swin2_sml_forward(B=16, net=(384, 384), seed=0, profile_dir=None):
    """Phase 10e (b): a Swin2-L SML (built on the card, bf16, its initial
    weights) at the Swin2 cell's net, grad off: one forward must launch
    the attention kernel 24 times and count 24 "attn_kernel", no
    "attn_plain" and 24 "cpb_tables" in `models.swin2.COUNTS`; the
    forward's device ms back to back and its peak memory, beside the same
    forward with every block's attention on the plain version, and the
    relative L1 distance of the two forwards' last encoder taps.  With
    `profile_dir`, a torch.profiler table of one forward."""
    import torch
    from unittest import mock
    from riders_tpu_torch.models import swin2
    from riders_tpu_torch.models.factory import build_sml_model
    from riders_tpu_torch.ops.kernels import LAUNCHES
    cfg = dpt_config(FAMILY_MAIN, net_shape=net)
    model = build_sml_model(cfg, "cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, *net, 3), generator=g, device="cuda")
    d = torch.rand((B, *net, 1), generator=g, device="cuda") + 0.5
    taps = []
    model.pretrained.register_forward_hook(
        lambda m, i, o: taps.append(o[-1].float()))
    plain = mock.patch.object(swin2, "swin2_attention_path",
                              lambda *a: "plain")
    with torch.inference_mode():
        swin2.COUNTS.clear()
        n0 = LAUNCHES["swin2_attention"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred = model(x, d)[0]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = dict(swin2.COUNTS)
        launches = LAUNCHES["swin2_attention"] - n0
        with plain:
            torch.cuda.reset_peak_memory_stats()
            model(x, d)
            torch.cuda.synchronize()
            plain_peak = torch.cuda.max_memory_allocated() / 1e9
        kernel_tap, plain_tap = taps[:2]
        taps.clear()
        ms = device_ms(lambda: model(x, d), n=5, warmup=1)
        with plain:
            plain_ms = device_ms(lambda: model(x, d), n=3, warmup=1)
        taps.clear()
        if profile_dir is not None:
            log(profile(lambda _: model(x, d), None,
                        profile_dir / "profile_swin2_sml.txt"))
    rec = dict(batch=B, net=list(net), launches=launches, counts=counts,
               ms=ms, plain_ms=plain_ms, peak_mem_gb=peak,
               plain_peak_mem_gb=plain_peak,
               finite=bool(torch.isfinite(pred).all()),
               last_tap_rel_l1=float((kernel_tap - plain_tap).abs().sum()
                                     / plain_tap.abs().sum()))
    log(f"swin2 sml forward: {json.dumps(rec)}")
    if (launches != 24 or counts.get("attn_kernel") != 24
            or counts.get("attn_plain", 0) != 0
            or counts.get("cpb_tables") != 24 or not rec["finite"]):
        raise AssertionError(f"swin2 sml forward: {rec}")
    return rec


def swin2_attention_phase(profile_dir=None):
    """Phase 10e: the kernel's checks and times, then the SML forward."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = dict(kernel=check_swin2_attention(),
               sml_forward=swin2_sml_forward(profile_dir=profile_dir))
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def swin2_attention_only(smi, profile_dir):
    """`--swin2-attention`: phase 1, then phase 10e alone."""
    out = swin2_attention_phase(profile_dir)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_swin2_attention.json").write_text(
        json.dumps(out, indent=1))
    log(json.dumps({"swin2_attention": dict(card=smi, **out)}))
    log(smi)
    return 0


def dpt_phase(root, seed=0, profile_dir=None):
    """Phase 10: the DPT SML at full width on the card (10d the BEiT
    attention kernel and 10e the Swin V2 attention kernel first, then 10a
    inference, 10b training and its agreement with the CPU, 10c the
    drivers on the NTU mini-dataset under `root`), the launch counters
    reset just before; of the hand-written kernels only the BEiT
    attention lies on the DPT paths of these BEiT and ViT rows, in bf16
    inference (10a's BEiT-L call launches it once a block, the ViT rows
    not at all).  With `profile_dir`, torch.profiler tables of a BEiT-L
    inference call and training step."""
    import gc
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    gc.collect()
    torch.cuda.empty_cache()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = {"attention": attention_phase(profile_dir),
           "swin2_attention": swin2_attention_phase(profile_dir)}
    weights = {DPT_MAIN: sml_weights(dpt_config(DPT_MAIN), seed)}
    out["inference"] = {DPT_MAIN: dpt_inference(
        DPT_MAIN, weights[DPT_MAIN], profile_dir=profile_dir)}
    for model_type in DPT_OTHERS:
        w = sml_weights(dpt_config(model_type), seed)
        out["inference"][model_type] = dpt_inference(model_type, w, n=3)
        del w
        torch.cuda.empty_cache()
    want = {DPT_MAIN: 24, **{k: 0 for k in DPT_OTHERS}}
    got = {k: r["attention"]["launches"] for k, r in out["inference"].items()}
    if got != want or out["inference"][DPT_MAIN]["attention"][
            "attn_kernel"] != 24:
        raise AssertionError(f"phase 10a: BEiT attention launches a call "
                             f"{got}, {want} expected; "
                             f"{out['inference'][DPT_MAIN]['attention']}")
    out["training"] = dpt_training(weights[DPT_MAIN], seed, profile_dir)
    torch.cuda.empty_cache()
    out["step_agreement"] = dpt_step_agreement(weights[DPT_MAIN])
    torch.cuda.empty_cache()
    out["drivers"] = dpt_drivers(root, weights[DPT_MAIN])
    out["launches"] = dict(LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    return out


def family_training(seed=0, profile_dir=None, batches=(12, 8, 6, 4)):
    """Phase 11b: Swin2-L's f32 make_train_step (TF32 off) at the largest
    of `batches` that fits on the card, from weights calibrated as
    `sml_weights` says: a gradient in every parameter in the first step,
    then `_train_phase`'s steps, ms per step and peak memory
    (`dpt_training`).  The batches that did not fit are listed."""
    import gc
    import torch
    net = FAMILY_NETS[FAMILY_MAIN]
    weights = sml_weights(dpt_config(FAMILY_MAIN, net_shape=net), seed,
                          "cuda")
    too_big = []
    for B in batches:
        try:
            rec = dpt_training(weights, seed, profile_dir, FAMILY_MAIN, net,
                               B, "profile_swin2_train.txt")
        except torch.cuda.OutOfMemoryError:
            too_big.append(B)
        else:
            # after the first Adam update the head's relu is dead again
            # (phase 10's finding), so the later steps reach no parameter
            rec.update(batches_out_of_memory=too_big,
                       no_gradient=len(rec["no_gradient"]))
            return rec
        gc.collect()                # the failed attempt's tensors
        torch.cuda.empty_cache()
    raise AssertionError(f"{FAMILY_MAIN}: no batch of {batches} fits")


def family_validate(root, seed=0):
    """Phase 11e: validate_sml of a step-0 checkpoint of Swin2-L's
    calibrated weights on the NTU mini-dataset under `root`, bf16 on the
    card and f32 on the host CPU: the seven metrics within 1%
    (PARITY.md's protocol)."""
    import dataclasses
    import torch
    from unittest import mock
    from riders_tpu_torch.core import checkpoint, metrics
    from riders_tpu_torch.pipelines import drivers, sml_training
    cfg = dpt_config(FAMILY_MAIN, net_shape=FAMILY_NETS[FAMILY_MAIN])
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, root=str(root),
                                    train_scenes=("train",),
                                    val_scenes=("val",)),
        sml_train=dataclasses.replace(cfg.sml_train, rcnet_interp="interp",
                                      rcnet_interp_val=None))
    ckpt = root / "ckpt_swin2"
    weights = sml_weights(cfg, seed, "cuda")
    checkpoint.save_train_state(ckpt, sml_training.init_train_state(
        cfg, build_dpt(cfg, weights, "cpu", torch.float32), 1))
    del weights
    out, bundles = {}, {}
    for name, dtype, device in (("card_bf16", "bfloat16", None),
                                ("cpu_f32", "float32", "cpu")):
        seen = bundles[name] = []

        def vote(results, best_so_far, _vote=metrics.improves_best):
            seen.append(dict(results))
            return _vote(results, best_so_far)

        t0 = time.perf_counter()
        with mock.patch.object(metrics, "improves_best", vote):
            drivers.validate_sml(cfg.replace(compute_dtype=dtype),
                                 str(ckpt), device=device)
        out[f"validate_sml_{name}_s"] = time.perf_counter() - t0
    card, cpu = bundles["card_bf16"], bundles["cpu_f32"]
    dev = {k: abs(card[0][k] - cpu[0][k]) / abs(cpu[0][k])
           for k in metrics.METRIC_KEYS} if len(card) == len(cpu) == 1 \
        else {}
    out.update(metrics=bundles, metric_rel_dev=dev)
    if (len(dev) != len(metrics.METRIC_KEYS)
            or not all(math.isfinite(cpu[0][k]) for k in dev)
            or max(dev.values()) > 0.01):
        raise AssertionError(f"{FAMILY_MAIN} validate_sml bf16 card vs f32 "
                             f"CPU: {out}")
    return out


# the hand-written kernels that phase 11's paths launch
OWN_KERNELS = ("swin2_attention", "golden_section")


def family_phase(root, seed=0, profile_dir=None):
    """Phase 11: the Swin2 / Swin-V1, LeViT and Next-ViT DPT SMLs at full
    width on the card, each on weights calibrated by `sml_weights` (drawn
    on the host, the calibrating forward on the card), the launch
    counters reset just before: (a) Swin2-L through make_infer_fn at its
    384x384 net, NTU B=16, bf16, 10 calls; (b) its f32 step; (c) the
    other five rows, 3 calls each at their nets; (d) one B=2 step per
    family on the card against the host CPU (Swin2-T at 128x128, LeViT at
    64x64, Next-ViT at 64x96); (e) validate_sml at step 0 on the NTU
    mini-dataset under `root`, bf16 card vs f32 host CPU.  Of the
    hand-written kernels only the Swin V2 attention (bf16 inference of the
    Swin V2 rows) and stage 1's scale search (`make_infer_fn`,
    `validate_sml`) lie on these paths: a launch of another fails the
    phase.
    With `profile_dir`, torch.profiler tables of Swin2-L's call and
    step."""
    import gc
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    gc.collect()
    torch.cuda.empty_cache()
    LAUNCHES.clear()
    t0, out = time.perf_counter(), {"inference": {}, "seconds": {}}
    progress = HERE / "chiprun_out" / "phase11_progress.json"
    progress.parent.mkdir(exist_ok=True)

    def done(what, rec):
        log(f"dpt family {what}: {json.dumps(rec)}")
        progress.write_text(json.dumps(out, indent=1))
    for model_type, net in FAMILY_NETS.items():
        t = time.perf_counter()
        w = sml_weights(dpt_config(model_type, net_shape=net), seed, "cuda")
        main = model_type == FAMILY_MAIN
        out["inference"][model_type] = rec = dpt_inference(
            model_type, w, n=10 if main else 3, net=net,
            profile_dir=profile_dir if main else None,
            profile_file="profile_swin2_infer.txt")
        done(f"inference {model_type}", rec)
        del w
        torch.cuda.empty_cache()
        out["seconds"][model_type] = time.perf_counter() - t
    t = time.perf_counter()
    out["training"] = family_training(seed, profile_dir)
    done("training", out["training"])
    torch.cuda.empty_cache()
    out["seconds"]["training"] = time.perf_counter() - t
    out["step_agreement"] = {}
    for model_type, net in FAMILY_STEP_NETS.items():
        t = time.perf_counter()
        w = sml_weights(dpt_config(model_type, net_shape=net), seed, "cuda")
        out["step_agreement"][model_type] = rec = dpt_step_agreement(
            w, model_type=model_type, net=net)
        done(f"step agreement {model_type}", rec)
        del w
        torch.cuda.empty_cache()
        out["seconds"][f"step {model_type}"] = time.perf_counter() - t
    t = time.perf_counter()
    out["validate"] = family_validate(root, seed)
    done("validate", out["validate"])
    out["seconds"]["validate"] = time.perf_counter() - t
    out["launches"] = dict(LAUNCHES)
    out["seconds"]["total"] = time.perf_counter() - t0
    if any(v for k, v in out["launches"].items() if k not in OWN_KERNELS):
        raise AssertionError(f"phase 11 launched other hand-written "
                             f"kernels: {out['launches']}")
    return out


def families_line(smi, fam):
    """The one-line summary of phase 11."""
    inf, main = fam["inference"], fam["inference"][FAMILY_MAIN]
    tr = fam["training"]
    return {"dpt_families": dict(
        card=smi, model=FAMILY_MAIN, net=main["net"], params=main["params"],
        infer_ntu_b16_bf16_ms=main["ms_per_call"],
        infer_ms_min_max=[main["ms_min"], main["ms_max"]],
        infer_bound_ms=main["bound_ms"],
        infer_peak_mem_gb=main["peak_mem_gb"],
        train_f32_batch=tr["batch"],
        train_batches_out_of_memory=tr["batches_out_of_memory"],
        train_f32_ms_per_step=tr["ms_per_step"],
        train_ms_per_step_cudnn_tf32=tr["ms_per_step_cudnn_tf32"],
        train_bound_ms=tr["bound_ms"], train_peak_mem_gb=tr["peak_mem_gb"],
        others={k: dict(net=r["net"], params=r["params"],
                        ms_per_call=r["ms_per_call"],
                        ms_min_max=[r["ms_min"], r["ms_max"]],
                        bound_ms=r["bound_ms"],
                        peak_mem_gb=r["peak_mem_gb"])
                for k, r in inf.items() if k != FAMILY_MAIN},
        step_agreement={k: dict(net=list(FAMILY_STEP_NETS[k]),
                                loss_rel_err=r["loss_rel_err"],
                                worst_grad_rel_err=r["worst_grad_rel_err"],
                                cpu_spread_there=r["cpu_spread_there"])
                        for k, r in fam["step_agreement"].items()},
        validate_metric_rel_dev=fam["validate"]["metric_rel_dev"],
        launches=fam["launches"], seconds=fam["seconds"])}


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
        attention={k: {f: r[f] for f in ("ms", "bound_ms", "plain_ms",
                                         "library_ms", "max_abs_err",
                                         "tolerance")}
                   for k, r in dpt["attention"]["kernel"].items()},
        attention_sml_forward_ms=[dpt["attention"]["sml_forward"][k]
                                  for k in ("ms", "plain_ms")],
        launches=dpt["launches"], seconds=dpt["seconds"])}


def log_dpt(dpt):
    for name, rec in dpt["inference"].items():
        log(f"dpt inference {name}: {json.dumps(rec)}")
    for name in ("training", "step_agreement", "drivers"):
        log(f"dpt {name}: {json.dumps(dpt[name])}")


def dpt_only(smi, profile_dir):
    """`--dpt`: phase 1, then phases 10 and 11 alone on an NTU
    mini-dataset of their own (24 training and 4 validation frames under
    build/)."""
    root = HERE / "build" / "phase10_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_scene(root, "train", 24, 0)
        write_scene(root, "val", 4, 1)
        dpt = dpt_phase(root, profile_dir=profile_dir)
        log_dpt(dpt)
        families = family_phase(root, profile_dir=profile_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_dpt.json").write_text(json.dumps(
        dict(dpt=dpt, dpt_families=families), indent=1))
    log(json.dumps(dpt_line(smi, dpt)))
    log(json.dumps(families_line(smi, families)))
    log(smi)
    return 0


# phase 12: B1's general form and the RC-Net variants
# (Cin, Cout, k): stems of one to three channels, then wider inputs, whose K
# streams in Cin slices (all of it in one chunk at (4, 32, 5))
STEM_GENERAL_CASES = ((3, 64, 7), (1, 32, 7), (3, 8, 7), (3, 16, 3),
                      (3, 32, 11), (8, 64, 7), (64, 64, 3), (4, 32, 5))
# B1's other forms on the general kernel: name: (Cin, Cout, k, form,
# slopes); relu6 is slope 0 with a clip at 6, lead=0 TF-SAME
STEM_GENERAL_FORMS = {
    "3_64_7_map": (3, 64, 7, dict(pool=False), (0.2, 0.0, 1.0)),
    "3_16_3_relu6_lead0": (3, 16, 3, dict(pool=False, clip_max=6.0,
                                          lead=0), (0.0,)),
}
VARIANTS = {
    # name: (preset, batch, RC-Net config changes, path, stem kernel)
    "v1_no_bn": ("ntu", 16, dict(use_batch_norm=False), "fused", "stem"),
    "v2_res3": ("zju", 4, dict(n_resolution=3), "fused", "stem"),
    "v2_res3_all_scales": ("zju", 4, dict(n_resolution=3), "all_scales",
                           "stem"),
    "v3_stem64": ("ntu", 16, dict(n_filters_encoder_image=(
        64, 64, 128, 128, 128)), "fused", "stem_general"),
    "v4_cin1": ("ntu", 16, dict(input_channels_image=1), "rcnet",
                "stem_general"),
}


def stem_library(x, w, scale, bias, k, slope=0.2, pool=True, clip_max=None,
                 lead=None):
    """The cuDNN yardstick of a stem form, as a function of no
    arguments: conv with the folded bf16 weights and bias (the input
    padded by `lead` above and to the left where that is not the
    symmetric default), leaky relu or, with a clip, clamp to [0, clip],
    and max pool with the pool."""
    import torch
    import torch.nn.functional as F
    wf = (w * scale[:, None, None, None]).to(torch.bfloat16).to(
        memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)
    bb = bias.to(torch.bfloat16)
    H, W = x.shape[1:3]
    if lead is None or lead == k // 2:
        pads, padding = None, k // 2
    else:
        pads = (lead, max(0, 2 * (-(-W // 2) - 1) + k - lead - W),
                lead, max(0, 2 * (-(-H // 2) - 1) + k - lead - H))
        padding = 0

    def run():
        y = F.conv2d(xc if pads is None else F.pad(xc, pads), wf, bb,
                     stride=2, padding=padding)
        y = (F.leaky_relu(y, slope) if clip_max is None
             else y.clamp(0.0, clip_max))
        return (y, F.max_pool2d(y, 3, 2, 1)) if pool else y
    return run


def check_stem_general(B=16):
    """Phase 12a: B1's general kernel against `stem_conv_pool_plain` on
    the NTU bench frame (B=16, 662x690 bf16) at each of
    STEM_GENERAL_CASES and slopes 0.2, 0 and 1, and at the forms of
    STEM_GENERAL_FORMS (one bf16 step, each call one `stem_general`
    launch and no `stem` launch; (3, 32, 7) with the pool one `stem`
    launch and no `stem_general`).  Times at slope 0.2 (the forms at
    their first slope): the wrapper synchronised (`ms`) and in a graph
    (`graph_ms`, packing the weights each call), the kernel alone on
    weights packed once, synchronised and in a graph (`kernel_ms`,
    `kernel_graph_ms`), the plain version, the cuDNN yardstick
    (`stem_library`) and the bound (no pooled bytes without the pool).
    At (3, 32, 7) the general kernel (on weights packed for it by the
    private `_general_weights`) is checked and timed beside the tuned
    one on the same inputs."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES, stem

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    ph, pw = GEOMETRIES["ntu"]["patch"]
    H, W = FRAME[0] + 2 * (ph // 2), FRAME[1] + 2 * (pw // 2)
    out = {}
    cases = [(f"{cin}_{cout}_{k}", cin, cout, k, {}, (0.2, 0.0, 1.0))
             for cin, cout, k in STEM_GENERAL_CASES + ((3, 32, 7),)]
    cases += [(name,) + v for name, v in STEM_GENERAL_FORMS.items()]
    for name, cin, cout, k, form, slopes in cases:
        tuned = (cin, cout, k) == (3, 32, 7) and not form
        kind = "stem" if tuned else "stem_general"
        x = torch.rand((B, H, W, cin), generator=g, device=dev).to(
            torch.bfloat16)
        w = torch.randn((cout, cin, k, k), generator=g, device=dev) * (
            2.0 / (cin * k * k)) ** 0.5
        scale = 0.5 + torch.rand(cout, generator=g, device=dev)
        bias = 0.1 * torch.randn(cout, generator=g, device=dev)
        if "clip_max" in form:          # the clip binds on part of the map
            w, bias = 4.0 * w, 10.0 * bias
        errs = {}
        for slope in slopes:
            before = dict(LAUNCHES)
            k_maps = stem.stem_conv_pool(x, w, scale, bias, slope, **form)
            torch.cuda.synchronize()
            launched = {n: LAUNCHES[n] - before.get(n, 0)
                        for n in ("stem", "stem_general")}
            if launched != {n: int(n == kind) for n in launched}:
                raise AssertionError(f"stem {name}: launched {launched}, "
                                     f"expected one {kind}")
            p_maps = stem.stem_conv_pool_plain(x, w, scale, bias, slope,
                                               **form)
            if not form.get("pool", True):
                k_maps, p_maps = (k_maps,), (p_maps,)
            errs[slope] = stem_max_err(k_maps, p_maps,
                                       f"stem {name} {slope}")
        k_out = k_maps[0]
        k_pool = k_maps[1] if len(k_maps) > 1 else None
        clipped = (float((k_out == form["clip_max"]).float().mean())
                   if "clip_max" in form else None)
        del k_maps, p_maps
        slope = slopes[0]
        if tuned:
            sw = stem._general_weights(w, scale, bias)
            before = LAUNCHES["stem_general"]
            gen = stem.stem_apply(x, sw, slope)
            torch.cuda.synchronize()
            if LAUNCHES["stem_general"] != before + 1:
                raise AssertionError("stem 3_32_7: the general weights "
                                     "launched no stem_general")
            gen_err = stem_max_err(gen, stem.stem_conv_pool_plain(
                x, w, scale, bias, slope), "stem 3_32_7 general")
            del gen
            tw = stem.stem_weights(w, scale, bias)
            out["routing_3_32_7"] = dict(
                kind=kind, max_abs_err=max(errs.values()),
                general_max_abs_err=gen_err,
                tuned_kernel_graph_ms=graph_ms(
                    lambda: stem.stem_apply(x, tw, slope), n=10,
                    replays=3),
                general_kernel_graph_ms=graph_ms(
                    lambda: stem.stem_apply(x, sw, slope), n=10,
                    replays=3),
                general_plan=list(sw.plan))
            continue
        library = stem_library(x, w, scale, bias, k, slope, **form)
        nbytes = (2 * (x.numel() + k_out.numel()
                       + (k_pool.numel() if k_pool is not None else 0))
                  + 4 * (w.numel() + 2 * cout))
        flops = 2.0 * k_out.numel() * k * k * cin
        bnd, by = bound_ms(nbytes, flops)
        sw = stem.stem_weights(w, scale, bias, **form)
        run = lambda: stem.stem_conv_pool(x, w, scale, bias, slope, **form)
        rec = dict(
            cin=cin, cout=cout, k=k, form=form, plan=list(sw.plan),
            max_abs_err=max(errs.values()),
            slope_max_abs_errs={str(s): e for s, e in errs.items()},
            clipped_share=clipped,
            tolerance="|k-p| <= 2^-7 max(|k|,|p|) + 1e-4",
            ms=time_ms(run, n=10), graph_ms=graph_ms(run, n=10, replays=3),
            kernel_ms=time_ms(lambda: stem.stem_apply(x, sw, slope), n=10),
            kernel_graph_ms=graph_ms(lambda: stem.stem_apply(x, sw, slope),
                                     n=10, replays=3),
            plain_ms=time_ms(lambda: stem.stem_conv_pool_plain(
                x, w, scale, bias, slope, **form), n=5, warmup=1),
            library_ms=time_ms(library, n=10),
            library_graph_ms=graph_ms(library, n=10, replays=3),
            bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
            shapes=dict(x=list(x.shape), out=list(k_out.shape),
                        pooled=None if k_pool is None else list(
                            k_pool.shape)))
        rec["bound_share_of_graph"] = bnd / rec["graph_ms"]
        rec["bound_share_of_kernel_graph"] = bnd / rec["kernel_graph_ms"]
        out[name] = rec
        del x, k_out, k_pool, sw
        torch.cuda.empty_cache()
    return out


# (Cin, Cout, k, pool) of `--stem-plans`: phase 12a's stems, more wide
# inputs and two conv maps alone
STEM_PLAN_SHAPES = tuple((cin, cout, k, True) for cin, cout, k in
                         STEM_GENERAL_CASES) + (
    (16, 64, 5, True), (32, 64, 7, True), (8, 32, 3, True),
    (3, 64, 7, False), (64, 72, 3, False))


def stem_plans(smi, B=16):
    """`--stem-plans`: every plan that `stem.general_plan` weighs (each
    tile and K chunking within 288 threads and 227 KB) at each shape of
    STEM_PLAN_SHAPES on the NTU bench frame, each held against the plain
    version (one bf16 step) and timed alone in a CUDA graph (the median
    of 2 replays of 3 calls); per shape the chosen plan's time beside the
    fastest plan's.  The data that `stem.plan_cost` was fitted to.  One
    {"stem_plans": ...} line; every plan's time in
    chiprun_out/stem_plans.json."""
    import torch
    from riders_tpu_torch.ops.kernels import stem

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    ph, pw = GEOMETRIES["ntu"]["patch"]
    H, W = FRAME[0] + 2 * (ph // 2), FRAME[1] + 2 * (pw // 2)
    detail, summary = {}, {}
    for cin, cout, k, pool in STEM_PLAN_SHAPES:
        x = torch.rand((B, H, W, cin), generator=g, device=dev).to(
            torch.bfloat16)
        w = torch.randn((cout, cin, k, k), generator=g, device=dev) * (
            2.0 / (cin * k * k)) ** 0.5
        scale = 0.5 + torch.rand(cout, generator=g, device=dev)
        bias = 0.1 * torch.randn(cout, generator=g, device=dev)
        want = stem.stem_conv_pool_plain(x, w, scale, bias, pool=pool)
        want = want if pool else (want,)
        chosen = stem.general_plan(cin, cout, k, pool)
        nt = chosen.nt
        rows = []
        for tile in stem.POOL_TILES if pool else stem.MAP_TILES:
            for kyc, cs in stem._chunkings(k, cin):
                geo = stem.general_geometry(k, cin, pool, tile, kyc, cs, nt)
                if (geo.total > stem.GENERAL_SMEM_LIMIT
                        or 32 * geo.warps > stem.GENERAL_MAX_THREADS):
                    continue
                plan = stem.GeneralPlan(tile, kyc, cs, nt, 32 * geo.warps,
                                        geo.total)
                sw = stem._general_weights(w, scale, bias, pool, plan=plan)
                got = stem.stem_apply(x, sw)
                err = stem_max_err(got if pool else (got,), want,
                                   f"stem plan {cin, cout, k, pool} {plan}")
                rows.append(dict(
                    plan=list(plan), warps=geo.warps,
                    two_blocks=geo.total <= stem.GENERAL_TWO_BLOCKS,
                    cost=stem.plan_cost(geo, cin, cs, pool, tile),
                    max_abs_err=err, chosen=plan == chosen,
                    graph_ms=graph_ms(lambda: stem.stem_apply(x, sw), n=3,
                                      replays=2)))
                del sw, got
        name = f"{cin}_{cout}_{k}" + ("" if pool else "_map")
        detail[name] = rows
        best = min(rows, key=lambda r: r["graph_ms"])
        pick = next(r for r in rows if r["chosen"])
        summary[name] = dict(chosen=pick["plan"], chosen_ms=pick["graph_ms"],
                             fastest=best["plan"], fastest_ms=best["graph_ms"],
                             plans=len(rows))
        log(f"stem plans {name}: {json.dumps(summary[name])}")
        del x, want
        torch.cuda.empty_cache()
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "stem_plans.json").write_text(
        json.dumps(dict(card=smi, shapes=detail), indent=1))
    log(json.dumps({"stem_plans": dict(card=smi, shapes=summary)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive_variant(name, seed=0, n=3):
    """Phase 12b: one RC-Net variant of VARIANTS at its preset's full
    widths (640x512 frames, its bucket and real points, bf16, seeded
    random weights), through `make_fused_fn`, RC-Net's forward with
    `return_all_scales=True`, or RC-Net's forward alone: n calls with the
    launch counters reset just before, each call one launch of the
    variant's stem kernel (none of the other), one RoI pool launch and,
    on the fused path, at least one compose launch; finite outputs of
    the expected shapes; ms per call."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    preset, B, rc, path, kind = VARIANTS[name]
    geo = GEOMETRIES[preset]
    cfg = variant_config(preset, FRAME, geo["bucket"], **rc)
    rcnet, sml = build_models(cfg, seed, None, torch.bfloat16)
    batches = [make_batch(seed + 10 + i, B, geo["bucket"], geo["real"],
                          FRAME, "cuda") for i in range(n)]
    ph, pw = cfg.rcnet.patch_size
    if path == "fused":
        fn = make_fused_fn(cfg, rcnet, sml)
    else:
        fn = lambda b: rcnet_call(cfg, rcnet, b, return_all_scales=(
            path == "all_scales"))
    fn(batches[0])                              # first call: cuDNN set-up
    torch.cuda.synchronize()
    LAUNCHES.clear()
    outs = [fn(b) for b in batches]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    other = "stem_general" if kind == "stem" else "stem"
    if (launches.get(kind, 0) != n or launches.get(other, 0)
            or launches.get("roi_pool", 0) != n
            or (path == "fused" and launches.get("compose", 0) < n)):
        raise AssertionError(f"{name}: launches {launches} in {n} calls; "
                             f"expected one {kind} and one roi_pool a call"
                             + (" and compose" if path == "fused" else ""))
    K = geo["bucket"]
    if path == "fused":
        shapes = [(B,) + FRAME]
    elif path == "all_scales":
        shapes = [(B, K, ph >> s, pw >> s, 1) for s in (2, 1, 0)]
    else:
        shapes = [(B, K, ph, pw, 1)]
    for o in outs:
        o = o if isinstance(o, list) else [o]
        got = [tuple(t.shape) for t in o]
        if got != shapes:
            raise AssertionError(f"{name}: output shapes {got}, expected "
                                 f"{shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in o):
            raise AssertionError(f"{name}: non-finite output")
    rec = dict(preset=preset, batch=B, bucket=K, real_points=geo["real"],
               frame=list(FRAME), rcnet=rc, path=path, stem_kernel=kind,
               launches=launches, ms_per_call=time_ms(
                   lambda: fn(batches[1]), n=5, warmup=1))
    if path == "fused":
        rec["positive_share"] = float((outs[0] > 0).float().mean())
        if rec["positive_share"] <= 0.95:
            raise AssertionError(f"{name}: {rec}")
    if path == "all_scales":
        last = rcnet_call(cfg, rcnet, batches[0])
        rec["last_scale_vs_default_max_abs"] = float(
            (last.float() - outs[0][-1].float()).abs().max())
        if rec["last_scale_vs_default_max_abs"] > 2 ** -7:
            raise AssertionError(f"{name}: the last scale is not the "
                                 f"default return: {rec}")
    del fn, rcnet, sml, batches, outs
    torch.cuda.empty_cache()
    return rec


def variants_phase(baseline_ms=None):
    """Phase 12: (a) B1's general kernel against its plain version, (b)
    the RC-Net variants at full width with the counters reset just
    before each, beside the preset's plain call (phase 3's when given,
    else timed here), (c) each variant's bf16 card output against the
    port's f32 CPU output by phase 4's rule, (d) one f32 training step
    of the BN-free n_resolution 3 RC-Net on the card against the CPU's
    by phase 7's rule (ZJU: NTU's 150x50 patch pools to a pyramid that
    does not double from scale to scale, where n_resolution > 1 fails in
    both packages)."""
    t0 = time.perf_counter()
    rec = dict(stem_general=check_stem_general())
    rec["stem_general_s"] = time.perf_counter() - t0
    baseline_ms = dict(baseline_ms or {})
    for preset in ("ntu", "zju"):
        if preset not in baseline_ms:
            B = 16 if preset == "ntu" else 4
            baseline_ms[preset] = drive(preset, B)[0]["ms_per_call"]
    rec["baseline_ms_per_call"] = baseline_ms
    rec["variants"] = {name: drive_variant(name) for name in VARIANTS}
    for name, v in rec["variants"].items():
        v["preset_ms_per_call"] = baseline_ms[v["preset"]]
    rec["agreement"] = {
        "v1_no_bn": reference_agreement(preset="ntu", rcnet=dict(
            use_batch_norm=False)),
        "v2_res3": reference_agreement(preset="zju", rcnet=dict(
            n_resolution=3)),
        "v3_stem64": reference_agreement(preset="ntu", rcnet=dict(
            n_filters_encoder_image=(64, 64, 128, 128, 128))),
        "v4_cin1": reference_agreement(preset="ntu", rcnet=dict(
            input_channels_image=1), path="rcnet")}
    rec["training_agreement"] = training_agreement(
        preset="zju", rcnet=dict(use_batch_norm=False, n_resolution=3))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def log_variants(var):
    for name, r in var["stem_general"].items():
        log(f"stem general {name}: {json.dumps(r)}")
    for name, r in var["variants"].items():
        log(f"variant {name}: {json.dumps(r)}")
    for name, r in var["agreement"].items():
        log(f"variant agreement {name}: {json.dumps(r)}")
    log(f"variant training agreement: "
        f"{json.dumps(var['training_agreement'])}")


def stem_general_line(var, launches):
    """The B1-general entry of the {"kernels": [...]} line: the numbers of
    the (3, 64, 7) case (the 64-wide stem of phase 12b), every case
    beside them, and the launches of phase 12b's runs."""
    cases = {k: v for k, v in var["stem_general"].items() if "cin" in v}
    r = cases["3_64_7"]
    return dict(
        name="stem_general", route="cuda",
        source="riders_tpu_torch/csrc/stem_general.cu",
        replaces="riders_tpu/ops/pallas/stem.py:95", launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        graph_ms=r["graph_ms"], library_graph_ms=r["library_graph_ms"],
        kernel_graph_ms=r["kernel_graph_ms"],
        kernel_ms=r["kernel_ms"],
        cases={k: {f: c[f] for f in ("ms", "graph_ms", "kernel_ms",
                                     "kernel_graph_ms",
                                     "plain_ms", "library_ms",
                                     "library_graph_ms", "bound_ms",
                                     "bound_by", "max_abs_err")}
               for k, c in cases.items()},
        tuned_3_32_7=var["stem_general"]["routing_3_32_7"])


def variants_only(smi):
    """`--variants`: phase 1, then phase 12 alone (the presets' plain
    fused calls timed in it); its kernels line holds B1-general."""
    import torch
    var = variants_phase()
    log_variants(var)
    launches = sum(v["launches"].get("stem_general", 0)
                   for v in var["variants"].values())
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_variants.json").write_text(
        json.dumps(dict(card=smi, variants=var), indent=1))
    log(json.dumps({"kernels": [stem_general_line(var, launches)]}))
    log(json.dumps({"rcnet_variants": variants_line(smi, var)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def variants_line(smi, var):
    """The one-line summary of phase 12."""
    return dict(
        card=smi, seconds=var["seconds"],
        stem_general_graph_ms={k: v["graph_ms"] for k, v in
                               var["stem_general"].items() if "cin" in v},
        stem_general_kernel_graph_ms={
            k: v["kernel_graph_ms"] for k, v in
            var["stem_general"].items() if "cin" in v},
        stem_general_library_graph_ms={
            k: v["library_graph_ms"] for k, v in
            var["stem_general"].items() if "cin" in v},
        variant_ms_per_call={k: v["ms_per_call"] for k, v in
                             var["variants"].items()},
        preset_ms_per_call=var["baseline_ms_per_call"],
        agreement={k: v["card_bf16_vs_cpu_f32"] for k, v in
                   var["agreement"].items()},
        training_grad_rel_err=var["training_agreement"][
            "worst_grad_rel_err"])


# phase 13: the parallel layer on the card, in a world of one (the
# machine has one card, and NCCL takes one rank per device; more ranks
# are held on the CPU by tests/test_torch_sharding.py)
def _free_address():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def ntu_bench_config():
    """The NTU preset at the bench frame with phase 3's point bucket."""
    import dataclasses
    cfg = train_config("ntu")
    return cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=FRAME,
        max_points=GEOMETRIES["ntu"]["bucket"]))


def median_rel(x, ref):
    return float(((x - ref).abs() / ref.abs().clamp(min=1e-3)).median())


def sharded_fused(mesh, seed=0, B=16, n=3, spread=None):
    """13a: `make_sharded_fused_fn` at phase 3's NTU shapes and weights,
    n batches with the launch counters reset just before: one stem, one
    RoI pool and one compose launch and one gather over each mesh axis
    per call; its output against `make_fused_fn`'s on the same batches
    (bitwise expected: on a (1, 1) mesh it runs the same operations;
    with `spread`, a mesh of several cards, whose convolutions see other
    batch sizes, is held by phase 4's rule instead, and this rank's frames
    of it are set against `make_fused_fn` on those frames alone, bitwise
    expected); ms per call of both, timed in alternating pairs."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.fused import (make_fused_fn,
                                                  make_sharded_fused_fn)
    geo = GEOMETRIES["ntu"]
    cfg = ntu_bench_config()
    rcnet, sml = build_models(cfg, seed, None, torch.bfloat16)
    plain = make_fused_fn(cfg, rcnet, sml)
    sharded = make_sharded_fused_fn(cfg, rcnet, sml, mesh)
    batches = [make_batch(seed + 10 + i, B, geo["bucket"], geo["real"],
                          FRAME, "cuda") for i in range(n)]
    sharded(batches[0])                         # first call: cuDNN set-up
    torch.cuda.synchronize()
    before = dict(mesh.calls)
    LAUNCHES.clear()
    outs = [sharded(b) for b in batches]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    calls = {k: v - before.get(k, 0) for k, v in mesh.calls.items()}
    if any(launches.get(k) != n for k in ("stem", "roi_pool", "compose")):
        raise AssertionError(f"13a: launches {launches} in {n} calls")
    if calls != {"all_gather:points": n, "all_gather:data": n}:
        raise AssertionError(f"13a: collectives {calls} in {n} calls")
    refs = [plain(b) for b in batches]
    max_rel = max(float(((o - r).abs() / r.abs().clamp(min=1e-3)).max())
                  for o, r in zip(outs, refs))
    bitwise = all(torch.equal(o, r) for o, r in zip(outs, refs))
    med = max(median_rel(o, r) for o, r in zip(outs, refs))
    if not bitwise and (max_rel > 1e-3 if spread is None
                        else med > 1.5 * spread + 0.005):
        raise AssertionError(f"13a: sharded vs plain max rel {max_rel}, "
                             f"median {med}")
    local_bitwise = None
    if mesh.shape["data"] > 1:
        m = B // mesh.shape["data"]
        rows = slice(mesh.index("data") * m, (mesh.index("data") + 1) * m)
        local_bitwise = all(
            torch.equal(o[rows], plain({k: v[rows] for k, v in b.items()}))
            for o, b in zip(outs, batches))
    plain_ms, ms = paired_ms(lambda: plain(batches[1]),
                             lambda: sharded(batches[1]))
    return dict(batch=B, bucket=geo["bucket"], real_points=geo["real"],
                launches=launches, collectives=calls, bitwise=bitwise,
                local_bitwise=local_bitwise,
                max_rel_err=max_rel, median_rel_err=med, ms_per_call=ms,
                plain_ms_per_call=plain_ms, fps=B / (ms / 1e3))


def _step_setup(kind, seed, device):
    """fresh(dtype) -> (state, step) of `kind` at full width on `device`
    (the seeded f32 weights, held in `dtype`), and its batch: RC-Net at
    the NTU preset (B=24, 40 points, the frame random everywhere: phase 7
    says why), SML at 288x352, B=12."""
    import torch
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines import rcnet_training, sml_training
    cfg = train_config("ntu")
    if kind == "rcnet":
        batch = make_rcnet_train_batch(cfg, seed, device)
        batch["image"] = torch.rand(batch["image"].shape, generator=(
            torch.Generator(device=device).manual_seed(seed)), device=device)

        def fresh(dtype=torch.float32):
            model = init_random_(RCNet(cfg.rcnet, device, torch.float32),
                                 seed)
            wide = RCNet(cfg.rcnet, device, dtype)
            wide.load_state_dict(model.state_dict())
            return (rcnet_training.init_rcnet_train_state(cfg, wide, 1000),
                    rcnet_training.make_rcnet_train_step(cfg))
    else:
        batch = make_sml_train_batch(cfg, seed, device)

        def fresh(dtype=torch.float32):
            model = build_sml(cfg, seed, device, torch.float32)
            wide = ScaleMapLearner(cfg.sml, device, dtype)
            wide.load_state_dict(model.state_dict())
            return (sml_training.init_train_state(cfg, wide, 1000),
                    sml_training.make_train_step(cfg))
    return fresh, batch


def plain_roi_pool():
    """A context in which RC-Net pools its RoIs by the plain version, its
    forward and its backward (`ops.patches`), for an f64 step: the
    kernels take bf16 and f32 only."""
    import torch
    from unittest import mock
    from riders_tpu_torch.models import rcnet
    from riders_tpu_torch.ops import patches

    class Pool(torch.autograd.Function):
        @staticmethod
        def forward(ctx, feature, boxes, scale, out_size):
            pooled = patches.roi_max_pool(feature, boxes, scale, out_size)
            ctx.save_for_backward(feature, boxes, pooled)
            ctx.scale = scale
            return pooled

        @staticmethod
        def backward(ctx, grad):
            feature, boxes, pooled = ctx.saved_tensors
            return (patches.roi_max_pool_backward(
                feature, boxes, pooled, grad, ctx.scale).to(feature.dtype),
                None, None, None)

    def pyramid(latent, skips, boxes, patch_size):
        return patches.roi_pool_pyramid(
            latent, skips, boxes, patch_size,
            pool=lambda f, b, s, o: Pool.apply(f, b, s, tuple(o)))
    return mock.patch.object(rcnet, "roi_pool_pyramid", pyramid)


def grad_errs(g, ref):
    """Each gradient's max abs error over its max abs, floored at 1e-6 of
    the largest."""
    top = max(float(r.abs().max()) for r in ref.values())
    return {k: float((g[k] - r).abs().max())
            / max(float(r.abs().max()), 1e-6 * top)
            for k, r in ref.items()}


def sharded_step_agreement(kind, mesh, seed=5, profile_dir=None):
    """13b: one step of `kind` ('rcnet': NTU B=24; 'sml': 288x352, B=12)
    through `with_data_sharding` on `mesh`, so through the cross-rank
    BatchNorm and the loss collectives, against the plain step on the
    same weights and batch, with an f64 step of each as the witness:
    * f64 (the RoI pool by its plain version): the sharded step computes
      the plain step's function on the card - the loss to 1e-10, every
      parameter's gradient to 1e-5 of its max abs (floored at 1e-6 of
      the largest; the sharded fused path's bar in
      tests/test_torch_sharding.py); the plain f64 step run again is
      reported beside it (the card's run-to-run spread);
    * f32: the loss to rtol 1e-4; the BN running statistics after the
      step to rtol 1e-4 (atol 1e-4 of each tensor's max abs); every
      gradient's error against the f64 plain step within max(1e-3, 3x)
      the plain f32 step's own error there, the largest of three plain
      draws: the batch as it is and two with a random half of the input
      pixels one f32 ulp up (phase 7's rule, the plain step's distance
      from the exact gradient taking the place of its nudge spread); and
      the whole gradient's relative L2 error within 3x the plain
      step's.
    At random initialisation f32 rounding moves single tensors'
    gradients by percents in either step (the SML's by a median 2%);
    f64 shows both steps compute one function, and f32 that the sharded
    step lies no further from it than the plain one.  Each result is
    logged before it is judged.  Then ms per step of both f32 steps,
    timed in alternating pairs, the host time of one all-reduce, and
    with `profile_dir` a torch.profiler table of one step of each."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.parallel.sharding import with_data_sharding

    fresh, batch = _step_setup(kind, seed, "cuda")

    def run(dtype, sharded=False, b=batch):
        state, step = fresh(dtype)
        if sharded:
            step = with_data_sharding(mesh, step)
        _, aux = step(state, b)
        grads = {k: p.grad.detach().double()
                 for k, p in state.model.named_parameters()
                 if p.grad is not None}
        return float(aux["loss"]), grads, state, step

    def whole(g, ref):
        d = sum(float((g[k] - r).square().sum()) for k, r in ref.items())
        return (d / sum(float(r.square().sum()) for r in ref.values())) ** 0.5

    loss_p, g_p, state_p, step_p = run(torch.float32)
    before = dict(mesh.calls)
    LAUNCHES.clear()
    loss_s, g_s, state_s, step_s = run(torch.float32, sharded=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    calls = {k: v - before.get(k, 0) for k, v in mesh.calls.items()}
    need = ("roi_pool_f32", "roi_pool_bwd") if kind == "rcnet" else ()
    if any(launches.get(k, 0) <= 0 for k in need) or not calls:
        raise AssertionError(f"13b {kind}: launches {launches}, "
                             f"collectives {calls}")
    stats_p = state_p.model.state_dict()
    stats_s = state_s.model.state_dict()
    # the worst BN statistic's error over its bar
    stats_err = max(float(((stats_s[k] - w).abs() / (
        1e-4 * (w.abs() + w.abs().max()))).max())
        for k, w in stats_p.items() if "running" in k)
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}
    with plain_roi_pool():
        loss_p64, g_p64 = run(torch.float64, b=wide)[:2]
        torch.cuda.empty_cache()
        loss_s64, g_s64 = run(torch.float64, sharded=True, b=wide)[:2]
        torch.cuda.empty_cache()
        repeat = grad_errs(run(torch.float64, b=wide)[1], g_p64)
    torch.cuda.empty_cache()
    exact = grad_errs(g_s64, g_p64)
    err_s, err_p = grad_errs(g_s, g_p64), grad_errs(g_p, g_p64)
    image = batch["image"]
    for s in (1, 2):
        pick = torch.rand(image.shape, device="cuda", generator=(
            torch.Generator(device="cuda").manual_seed(s))) < 0.5
        draw = grad_errs(run(torch.float32, b=dict(batch, image=torch.where(
            pick, torch.nextafter(image, torch.full_like(image, 2.0)),
            image)))[1], g_p64)
        err_p = {k: max(e, draw[k]) for k, e in err_p.items()}
    over = {k: err_s[k] / max(1e-3, 3 * err_p[k]) for k in err_p}
    worst = max(over, key=over.get)
    res = dict(batch=int(batch["image"].shape[0]), loss=loss_p,
               sharded_loss=loss_s,
               loss_rel_err=abs(loss_s - loss_p) / abs(loss_p),
               bn_stats_err_over_bar=stats_err,
               f64_loss_rel_err=abs(loss_s64 - loss_p64) / abs(loss_p64),
               f64_worst_grad_err=max(exact.values()),
               f64_worst_grad=max(exact, key=exact.get),
               grad_rel_l2_vs_f64=whole(g_s, g_p64),
               plain_grad_rel_l2_vs_f64=whole(g_p, g_p64),
               f64_median_grad_err=sorted(exact.values())[len(exact) // 2],
               f64_plain_repeat_worst_grad_err=max(repeat.values()),
               f64_plain_repeat_median_grad_err=sorted(repeat.values())[
                   len(repeat) // 2],
               worst_tensor=worst, worst_tensor_err=err_s[worst],
               plain_err_there=err_p[worst], worst_over_bar=over[worst],
               median_tensor_err=sorted(err_s.values())[len(err_s) // 2],
               median_plain_err=sorted(err_p.values())[len(err_p) // 2],
               n_grads=len(err_p), launches=launches, collectives=calls)
    log(f"13b {kind}: {json.dumps(res)}")
    if (res["loss_rel_err"] > 1e-4 or stats_err > 1.0
            or res["f64_loss_rel_err"] > 1e-10
            or res["f64_worst_grad_err"] > 1e-5
            or set(g_s) != set(g_p) or set(g_s64) != set(g_p64)
            or res["worst_over_bar"] > 1.0
            or res["grad_rel_l2_vs_f64"]
            > 3 * res["plain_grad_rel_l2_vs_f64"]):
        raise AssertionError(f"13b {kind}: sharded vs plain step: {res}")
    plain_ms, ms = paired_ms(lambda: step_p(state_p, batch),
                             lambda: step_s(state_s, batch), n=5, warmup=1)
    res.update(ms_per_step=ms, plain_ms_per_step=plain_ms)
    axis = mesh.axis("mesh")
    probe = torch.zeros(256, device="cuda")
    for _ in range(10):
        axis.reduce_(probe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        axis.reduce_(probe)
    torch.cuda.synchronize()
    res["all_reduce_us"] = (time.perf_counter() - t0) / 200 * 1e6
    if profile_dir is not None:
        for name, st, sp in (("plain", state_p, step_p),
                             ("sharded", state_s, step_s)):
            log(profile(lambda b, st=st, sp=sp: sp(st, b), batch,
                        profile_dir / f"profile_{kind}_{name}_step.txt"))
    return res


def sml_determinism(seed=5):
    """13d (opt-in, `--determinism`): the plain f64 SML step of phase 13b
    (288x352, B=12, its seeded weights and batch) run twice in each of
    four modes: PyTorch's defaults, `torch.backends.cudnn.deterministic
    = True` alone, `torch.use_deterministic_algorithms(True,
    warn_only=True)` alone, and both.  For each mode the spread between
    its two runs (the loss's relative difference and each gradient's by
    `grad_errs`), and the ops that warn that they have no deterministic
    implementation.  The f64 model keeps f32 legs, as the JAX package's
    does: stage 1, the head's output and the resizes; a fifth pair, a
    diagnostic that departs from JAX, runs the defaults with the SML's
    two bilinear resizes (fusion blocks and head) in f64."""
    import warnings
    from unittest import mock
    import torch
    import torch.nn.functional as F
    from riders_tpu_torch.models import sml
    fresh, batch = _step_setup("sml", seed, "cuda")
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}

    def run():
        state, step = fresh(torch.float64)
        _, aux = step(state, wide)
        grads = {k: p.grad.detach().clone()
                 for k, p in state.model.named_parameters()
                 if p.grad is not None}
        return float(aux["loss"]), grads

    def spread():
        (loss_a, g_a), (loss_b, g_b) = run(), run()
        torch.cuda.synchronize()
        errs = grad_errs(g_b, g_a)
        order = sorted(errs.values())
        return dict(loss=loss_a, loss_rel_diff=abs(loss_b - loss_a)
                    / abs(loss_a), worst_grad_err=order[-1],
                    worst_grad=max(errs, key=errs.get),
                    median_grad_err=order[len(order) // 2],
                    n_grads_differing=sum(e > 0 for e in order),
                    n_grads=len(order))

    def wide_resize(x, out_shape, method="bilinear", align_corners=False):
        return F.interpolate(x, size=tuple(out_shape), mode=method,
                             align_corners=align_corners)

    out = {}
    for mode, (cudnn, algorithms, resize) in {
            "default": (False, False, sml.resize_nchw),
            "cudnn_deterministic": (True, False, sml.resize_nchw),
            "deterministic_algorithms": (False, True, sml.resize_nchw),
            "both": (True, True, sml.resize_nchw),
            "default_f64_resizes": (False, False, wide_resize)}.items():
        torch.backends.cudnn.deterministic = cudnn
        torch.use_deterministic_algorithms(algorithms, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    mock.patch.object(sml, "resize_nchw", resize):
                warnings.simplefilter("always")
                out[mode] = spread()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        warned = {}
        for w in caught:
            text = str(w.message)
            if "determinis" in text.lower():
                key = text.split(" does not have a deterministic")[0][:160]
                warned[key] = warned.get(key, 0) + 1
        out[mode]["warned_ops"] = warned
    out["cublas_workspace_config"] = os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    return out


def determinism_only(smi):
    """`--determinism`: phase 1, then 13d alone."""
    import torch
    rec = dict(card=smi, **sml_determinism())
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_determinism.json").write_text(
        json.dumps(rec, indent=1))
    log(json.dumps({"determinism": rec}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _cadence(preset, steps):
    """`preset` with a summary every step and a checkpoint every `steps`
    steps, so that a `steps`-step run writes its scalars."""
    import dataclasses

    def cfg_of(root="", **kw):
        cfg = preset(root, **kw)
        return cfg.replace(**{k: dataclasses.replace(
            getattr(cfg, k), n_step_per_summary=1,
            n_step_per_checkpoint=steps)
            for k in ("rcnet_train", "sml_train")})
    return cfg_of


def multihost_cli(root, steps=3):
    """13c: `riders-torch train-sml --multihost --num-processes 1
    --process-id 0` (NCCL on the card), B=12, `steps` steps on the NTU
    dataset under `root` with the IDW scale map: finite losses at each
    step, the checkpoint at the last, and the process group gone after."""
    import torch.distributed as dist
    from unittest import mock
    from riders_tpu_torch.core import config
    ckpt = root / "ckpt_sml_multihost"
    with mock.patch.object(config, "ntu_config",
                           _cadence(config.ntu_config, steps)):
        s, launches = _cli(["train-sml", "--ckpt", str(ckpt), "--max-steps",
                            str(steps), "--rcnet-interp", "interp",
                            "--multihost", "--coordinator", _free_address(),
                            "--num-processes", "1", "--process-id", "0"],
                           root)
    if dist.is_initialized():
        raise AssertionError("13c: the CLI left its process group")
    return dict(seconds=s, batch=12, losses=_trained(ckpt, steps))


def parallel_phase(root, profile_dir=None):
    """Phase 13: an NCCL world of one joined by `initialize_multihost`
    on 127.0.0.1, its (1, 1) mesh, (a) the sharded fused path, (b) the
    sharded RC-Net and SML steps; then (c) the CLI's --multihost."""
    import torch.distributed as dist
    from riders_tpu_torch.parallel import sharding as sh
    t0 = time.perf_counter()
    device = sh.initialize_multihost(_free_address(), 1, 0, timeout_s=300)
    try:
        backend = dist.get_backend()
        if backend != "nccl" or device.type != "cuda":
            raise AssertionError(f"13: joined {backend} on {device}")
        mesh = sh.make_mesh(1, 1)
        out = dict(backend=backend, mesh=list(mesh.devices_shape),
                   fused=sharded_fused(mesh),
                   rcnet_step=sharded_step_agreement("rcnet", mesh,
                                                     profile_dir=profile_dir),
                   sml_step=sharded_step_agreement("sml", mesh,
                                                   profile_dir=profile_dir))
    finally:
        dist.destroy_process_group()
    out["cli"] = multihost_cli(root)
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 14: the opt-in fast paths at full width
def fast_paths_phase(spread, seed=0, B=16, profile_dir=None):
    """Phase 14: `make_fused_fn` at phase 3's NTU shapes (B=16, bf16) with
    each opt-in fast form alone and then all together, the launch
    counters reset just before each: one stem, one RoI pool and one
    compose launch a call, the output against the literal call's by
    phase 4's rule (median relative error within 1.5 x `spread`, the
    CPU's own bf16-vs-f32 spread, plus 0.5%), and ms per call of the form
    and of the literal call, timed in alternating pairs (`paired_ms`),
    and fps; with `profile_dir` a torch.profiler table of one call of
    each."""
    import os
    import torch
    from riders_tpu_torch.models import sml_folded
    from riders_tpu_torch.models.layers import UpConvBlock
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines.fused import make_fused_fn
    geo = GEOMETRIES["ntu"]
    cfg = ntu_bench_config()
    rcnet, sml = build_models(cfg, seed, None, torch.bfloat16)
    batch = make_batch(seed + 11, B, geo["bucket"], geo["real"], FRAME,
                       "cuda")
    # the phase forms are the literal decoder's; its default on the card
    # is the lane decode
    rcnet.decoder.forward = rcnet.decoder.literal
    upconvs = [m for m in rcnet.modules() if isinstance(m, UpConvBlock)]
    saved = os.environ.get("RIDERS_SML_FOLD")
    try:
        os.environ["RIDERS_SML_FOLD"] = "1"
        if not sml_folded.supports_folding(sml, cfg.sml.net_shape):
            raise AssertionError("14: the SML does not fold")
        folded = make_fused_fn(cfg, rcnet, sml)
        os.environ["RIDERS_SML_FOLD"] = "0"
        literal = make_fused_fn(cfg, rcnet, sml)
    finally:
        if saved is None:
            os.environ.pop("RIDERS_SML_FOLD", None)
        else:
            os.environ["RIDERS_SML_FOLD"] = saved
    forms = {"sml_fold": dict(fold=True), "phase_tail": dict(tail=True),
             "fast_2x": dict(x2=True),
             "all": dict(fold=True, tail=True, x2=True)}

    def call(fold=False, tail=False, x2=False):
        rcnet.decoder.phase_tail = tail
        for m in upconvs:
            m.fast_2x = x2
        return (folded if fold else literal)(batch)

    out, t0 = {}, time.perf_counter()
    try:
        ref = call()
        for name, kw in forms.items():
            call(**kw)                          # first call: cuDNN set-up
            torch.cuda.synchronize()
            LAUNCHES.clear()
            depth = call(**kw)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            if any(launches.get(k) != 1 for k in ("stem", "roi_pool",
                                                  "compose")):
                raise AssertionError(f"14 {name}: launches {launches}")
            if not bool(torch.isfinite(depth).all()):
                raise AssertionError(f"14 {name}: non-finite depth")
            lit_ms, ms = paired_ms(lambda: call(), lambda k=kw: call(**k))
            rec = dict(ms_per_call=ms, literal_ms_per_call=lit_ms,
                       fps=B / (ms / 1e3),
                launches=launches, median_rel_err=median_rel(depth, ref),
                max_rel_err=float(((depth - ref).abs()
                                   / ref.abs().clamp(min=1e-3)).max()))
            if rec["median_rel_err"] > 1.5 * spread + 0.005:
                raise AssertionError(f"14 {name} vs literal: {rec}")
            out[name] = rec
            if profile_dir is not None:
                for tag, k in (("literal", {}), (name, kw)):
                    log(profile(lambda b, k=k: call(**k), batch,
                                profile_dir / f"profile_fast_{tag}.txt"))
    finally:
        call()
    out["bar"] = 1.5 * spread + 0.005
    out["seconds"] = time.perf_counter() - t0
    return out


# --multichip: the parallel layer across the cards of one host
MULTICHIP_FUSED = ((2, 2), (4, 1), (1, 4))
MULTICHIP_STEPS = (("rcnet", (4, 1)), ("rcnet", (2, 2)), ("sml", (4, 1)))


def _multichip_rank(rank, world, address, spread, out_dir):
    """One rank of `--multichip`: joins the NCCL job on its card and runs
    13a on each mesh of MULTICHIP_FUSED and 13b on each of
    MULTICHIP_STEPS (the plain references on its own card, the sharded
    forms across every card), then writes its results."""
    import torch
    import torch.distributed as dist
    from riders_tpu_torch.parallel import sharding as sh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = sh.initialize_multihost(address, world, rank, timeout_s=600)
    try:
        out = dict(device=str(device), fused={}, steps={})
        for shape in MULTICHIP_FUSED:
            out["fused"][str(shape)] = sharded_fused(sh.make_mesh(*shape),
                                                     spread=spread)
            torch.cuda.empty_cache()
        for kind, shape in MULTICHIP_STEPS:
            out["steps"][f"{kind} {shape}"] = sharded_step_agreement(
                kind, sh.make_mesh(*shape))
            torch.cuda.empty_cache()
        dist.barrier()      # no rank leaves while another still talks
    finally:
        dist.destroy_process_group()
    (out_dir / f"multichip_rank{rank}.json").write_text(json.dumps(out))


def multichip_only(smi):
    """`--multichip` (every card of the host, one rank each, joined by
    NCCL): phases 1 and 4 (the bf16 spread), then 13a on meshes (2, 2),
    (4, 1) and (1, 4) at NTU B=16 and 13b for RC-Net (B=24) on (4, 1)
    and (2, 2) and SML (B=12) on (4, 1), each rank holding the sharded
    form against the plain one on its own card; one {"multichip": ..}
    line from rank 0's results, with every rank's timings."""
    import multiprocessing
    import torch
    world = torch.cuda.device_count()
    if world < 4:
        print(f"chip_smoke: --multichip needs 4 cards, found {world}",
              file=sys.stderr)
        return 1
    world = 4
    agree = reference_agreement()
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    address = _free_address()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_multichip_rank, args=(
        r, world, address, agree["cpu_bf16_vs_cpu_f32"], out_dir))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise AssertionError(f"--multichip: rank exit codes {codes}")
    ranks = [json.loads((out_dir / f"multichip_rank{r}.json").read_text())
             for r in range(world)]
    r0 = ranks[0]
    line = dict(
        card=smi, cards=world, seconds=time.perf_counter() - t0,
        fused={k: dict(bitwise=v["bitwise"],
                       local_bitwise=[r["fused"][k]["local_bitwise"]
                                      for r in ranks],
                       median_rel_err=v["median_rel_err"],
                       launches=v["launches"],
                       ms=[r["fused"][k]["ms_per_call"] for r in ranks],
                       plain_ms=v["plain_ms_per_call"])
               for k, v in r0["fused"].items()},
        steps={k: dict(f64_worst_grad_err=v["f64_worst_grad_err"],
                       worst_over_bar=v["worst_over_bar"],
                       grad_rel_l2_vs_f64=v["grad_rel_l2_vs_f64"],
                       plain_grad_rel_l2_vs_f64=v[
                           "plain_grad_rel_l2_vs_f64"],
                       loss_rel_err=v["loss_rel_err"],
                       ms=[r["steps"][k]["ms_per_step"] for r in ranks],
                       plain_ms=v["plain_ms_per_step"],
                       all_reduce_us=v["all_reduce_us"])
               for k, v in r0["steps"].items()})
    log(json.dumps({"multichip": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def parallel_line(smi, par, fast):
    """The one-line summary of phases 13 and 14."""
    return dict(
        card=smi, backend=par["backend"], seconds=par["seconds"],
        sharded_fused_ms=par["fused"]["ms_per_call"],
        plain_fused_ms=par["fused"]["plain_ms_per_call"],
        sharded_fused_bitwise=par["fused"]["bitwise"],
        sharded_fused_launches=par["fused"]["launches"],
        **{f"{k}_ms": par[f"{k}_step"]["ms_per_step"]
           for k in ("rcnet", "sml")},
        **{f"plain_{k}_ms": par[f"{k}_step"]["plain_ms_per_step"]
           for k in ("rcnet", "sml")},
        **{f"{k}_f64_worst_grad_err": par[f"{k}_step"]["f64_worst_grad_err"]
           for k in ("rcnet", "sml")},
        **{f"{k}_grad_rel_l2_vs_f64": [
            par[f"{k}_step"]["grad_rel_l2_vs_f64"],
            par[f"{k}_step"]["plain_grad_rel_l2_vs_f64"]]
           for k in ("rcnet", "sml")},
        **{f"{k}_worst_over_bar": par[f"{k}_step"]["worst_over_bar"]
           for k in ("rcnet", "sml")},
        all_reduce_us=par["rcnet_step"]["all_reduce_us"],
        cli_multihost_s=par["cli"]["seconds"],
        fast_ms={k: v["ms_per_call"] for k, v in fast.items()
                 if isinstance(v, dict)},
        fast_literal_ms={k: v["literal_ms_per_call"] for k, v in
                         fast.items() if isinstance(v, dict)},
        fast_median_rel_err={k: v["median_rel_err"] for k, v in
                             fast.items() if isinstance(v, dict)},
        fast_all_fps=fast["all"]["fps"], fast_seconds=fast["seconds"])


def parallel_only(smi, profile_dir=None):
    """`--parallel`: phase 1, phase 4 (the bf16 spread phase 14 needs),
    then phases 13 and 14 alone, on an NTU dataset of their own."""
    import torch
    agree = reference_agreement()
    root = HERE / "build" / "phase13_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_scene(root, "train", 12, 0)
        write_scene(root, "val", 4, 1)
        par = parallel_phase(root, profile_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fast = fast_paths_phase(agree["cpu_bf16_vs_cpu_f32"],
                            profile_dir=profile_dir)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_parallel.json").write_text(json.dumps(dict(
        card=smi, reference=agree, parallel=par, fast_paths=fast),
        indent=1))
    log(json.dumps({"parallel": parallel_line(smi, par, fast)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# phase 15: the measuring entry points
SERVING_CUT = dict(frames=32, epochs=1)    # bench_serving: 128 frames, 2


def bench_phase(spread=None):
    """Phase 15, the port's measuring entry points under PyTorch's default
    TF32 / cuDNN settings (as they run alone; chip_smoke's own settings
    come back after): (a) `bench.measure` at NTU and ZJU (640x512, B=16,
    bf16, full width): the captured call's launches (one stem, one RoI
    pool, one compose), its replayed depth against an eager call's on the
    same input (bitwise, else phase 4's rule with the difference logged;
    `spread` is phase 4's CPU bf16 spread, measured here if None), the
    output finite and positive on more than 95% of pixels; (b)
    `bench_train` rcnet and sml, 5 timed steps each (the RC-Net step
    launches B2's f32 forward and B5); (c) `bench_serving` on
    SERVING_CUT; (d) `profile_bench` at NTU by graph replay and eagerly:
    device events traced, the port's three kernels among them, and the
    device's busy share."""
    import torch
    from riders_tpu_torch import bench
    from riders_tpu_torch.tools import (bench_serving, bench_train,
                                        profile_bench)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = dict(settings=bench.settings(), presets={})
        for preset in ("ntu", "zju"):
            t0 = time.perf_counter()
            r = bench.measure(preset)
            r["seconds"] = time.perf_counter() - t0
            out["presets"][preset] = r
            log(f"15a {preset}: {json.dumps(r)}")
            for name in ("stem", "roi_pool", "compose"):
                if r["capture_launches"].get(name) != 1:
                    raise AssertionError(
                        f"bench {preset}: {r['capture_launches']} inside "
                        f"the captured call, not one {name} launch")
            if r["depth_shape"] != [bench.BATCH, *FRAME]:
                raise AssertionError(f"bench {preset}: depth shape "
                                     f"{r['depth_shape']}")
            if not r["finite"] or r["positive_share"] <= 0.95:
                raise AssertionError(f"bench {preset}: finite {r['finite']}"
                                     f", positive {r['positive_share']}")
            if not r["replay_equals_eager"]:
                if spread is None:
                    spread = reference_agreement()["cpu_bf16_vs_cpu_f32"]
                r["phase4_bar"] = 1.5 * spread + 0.005
                log(f"15a {preset}: replay differs from eager: max abs "
                    f"{r['replay_vs_eager_max_abs']}, median rel "
                    f"{r['replay_vs_eager_median_rel']} (bar "
                    f"{r['phase4_bar']})")
                if r["replay_vs_eager_median_rel"] > r["phase4_bar"]:
                    raise AssertionError(f"bench {preset}: replay vs eager "
                                         f"beyond phase 4's rule")
        out["train"] = dict(rcnet=bench_train.bench_rcnet(5),
                            sml=bench_train.bench_sml(5))
        log(f"15b: {json.dumps(out['train'])}")
        for name in ("roi_pool_f32", "roi_pool_bwd"):
            if out["train"]["rcnet"]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"bench_train rcnet: no {name} launch "
                                     f"({out['train']['rcnet']['launches']})")
        data = bench_serving.DATA_DIR
        try:
            out["serving"] = bench_serving.main(
                ["--frames", str(SERVING_CUT["frames"]),
                 "--epochs", str(SERVING_CUT["epochs"])])
        finally:
            shutil.rmtree(data / "riders_serving_ntu_512x640",
                          ignore_errors=True)
        out["serving"]["cut"] = dict(SERVING_CUT, of=dict(
            frames=bench_serving.FRAMES, epochs=bench_serving.EPOCHS))
        log(f"15c: {json.dumps(out['serving'])}")
        out["profile"] = {}
        for mode in ("graph", "eager"):
            prof = profile_bench.profile(
                "ntu", eager=mode == "eager",
                out_dir=HERE / "chiprun_out" / "profile_bench")
            out["profile"][mode] = prof
            cats = prof["by_category_ms"]
            missing = [c for c in ("stem (csrc/stem.cu)",
                                   "roi_pool (csrc/roi_pool.cu)",
                                   "compose (csrc/compose.cu)")
                       if cats.get(c, 0.0) <= 0.0]
            if prof["device_events"] == 0 or missing:
                raise AssertionError(f"profile_bench {mode}: "
                                     f"{prof['device_events']} device "
                                     f"events, missing {missing}")
        log(f"15d: {json.dumps(out['profile'])}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.cuda.empty_cache()
    return out


def bench_line(smi, b):
    """The phase-15 summary line."""
    pre = b["presets"]
    return dict(
        card=smi, settings=b["settings"],
        **{p: dict((k, pre[p][k]) for k in (
            "graph_ms", "eager_ms", "graph_fps", "eager_fps",
            "graph_samples_ms", "eager_samples_ms", "capture_launches",
            "replay_equals_eager", "replay_vs_eager_max_abs",
            "peak_mem_gb")) for p in pre},
        train=dict(rcnet_ms_per_step=b["train"]["rcnet"]["ms"],
                   rcnet_batch=b["train"]["rcnet"]["batch"],
                   sml_ms_per_step=b["train"]["sml"]["ms"],
                   sml_batch=b["train"]["sml"]["batch"],
                   rcnet_launches=b["train"]["rcnet"]["launches"]),
        serving=dict(
            h2d_mb_s_pre=b["serving"]["h2d"]["pre"],
            h2d_mb_s_post=b["serving"]["h2d"]["post"],
            loader_fps=b["serving"]["loader"]["value"],
            serving_fps=b["serving"]["serving"]["value"],
            latency_p50_ms=b["serving"]["latency"]["p50_ms"],
            latency_p99_ms=b["serving"]["latency"]["p99_ms"],
            cut=b["serving"]["cut"]),
        profile={m: dict(busy_share=r["busy_share"], busy_ms=r["busy_ms"],
                         window_ms=r["window_ms"],
                         device_ms_per_call=r["device_ms_per_call"])
                 for m, r in b["profile"].items()})


def bench_only(smi):
    """`--bench`: phase 1, then phase 15 alone."""
    import torch
    b = bench_phase()
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_bench.json").write_text(json.dumps(
        dict(card=smi, bench=b), indent=1))
    log(json.dumps({"bench": bench_line(smi, b)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def read_x256(path):
    """A depth PNG decoded with numpy alone (uint16 / 256)."""
    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(path), dtype=np.float32) / 256.0


def direct_report(goldens, riders):
    """compare_goldens' per-scene report recomputed from the two trees
    with numpy: the mean over a scene's frames of each frame's mean
    absolute deviation of its sml_depth PNGs (and of its .npy maps)."""
    import numpy as np
    report = {}
    for scene in sorted(p.name for p in goldens.iterdir() if p.is_dir()):
        devs = {"int_depth": [], "int_scales": [], "depth": []}
        for png in sorted((goldens / scene / "sml_depth").iterdir()):
            for key in ("int_depth", "int_scales"):
                g, r = (t / scene / key / (png.stem + ".npy")
                        for t in (goldens, riders))
                if g.exists() and r.exists():
                    devs[key].append(float(np.abs(np.load(g)
                                                  - np.load(r)).mean()))
            r = riders / scene / "sml_depth" / png.name
            if r.exists():
                devs["depth"].append(float(np.abs(
                    read_x256(png) - read_x256(r)).mean()))
        report[scene] = {k: (float(np.mean(v)) if v else None)
                         for k, v in devs.items()}
    return report


def goldens_phase(smi, seed=0, n_scenes=2, n_frames=3):
    """Phase 16: the staged RIDERS pipeline from disk on the card (bf16)
    scored against the same pipeline on the host CPU (f32, the plain
    versions of the kernels) by `tools.compare_goldens`, PARITY.md's
    protocol.  A ZJU-layout dataset of `n_scenes` validation scenes x
    `n_frames` frames at the preset's 480x640 (tests/test_drivers.py's
    make_mini_dataset layout, from a seed); RC-Net (`init_random_`, as
    the fused phases) and the midas-small SML (flax's initialisers, its
    head calibrated by `sml_weights`, as phases 10-11 before their 1%
    bar) at the ZJU preset's full widths on seeded weights, saved as port
    checkpoints; on each device `run_rcnet`
    (its stage-2 tree under its own output directory), then
    `validate_sml(save_output=True)` on that tree; the tool on (CPU tree,
    card tree) with --root on the card: within the 1% budget on mae,
    rmse and delta1, and its per-scene numbers equal to `direct_report`.
    The card's run launches B1, B2 and B4 (counted), the CPU's nothing."""
    import dataclasses
    import numpy as np
    import torch
    from riders_tpu_torch.core import checkpoint
    from riders_tpu_torch.core.config import zju_config
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.pipelines import drivers
    from riders_tpu_torch.pipelines.rcnet_training import \
        init_rcnet_train_state
    from riders_tpu_torch.pipelines.sml_training import init_train_state
    from riders_tpu_torch.tools.compare_goldens import compare_goldens

    root = HERE / "build" / "phase16_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        scenes = tuple(f"zju-val-{i}" for i in range(n_scenes))
        for i, scene in enumerate(scenes):
            write_scene(root, scene, n_frames, seed + 20 + i, ZJU_FRAME)
        cfg = zju_config(root=str(root))
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, train_scenes=(), val_scenes=scenes))
        n = n_scenes * n_frames
        rc_dir, sml_dir = root / "ckpt_rcnet", root / "ckpt_sml"
        rcnet = init_random_(RCNet(cfg.rcnet, "cpu", torch.float32), seed)
        sml = ScaleMapLearner(cfg.sml, "cpu", torch.float32)
        sml.load_state_dict(sml_weights(cfg, seed + 1,
                                        head="output_conv.conv3"))
        for directory, state in (
                (rc_dir, init_rcnet_train_state(cfg, rcnet, 1)),
                (sml_dir, init_train_state(cfg, sml, 1))):
            state.step = 1
            checkpoint.save_train_state(directory, state)
        del rcnet, sml, state
        torch.cuda.empty_cache()
        runs, run_cfgs = {}, {}
        for name, device, dtype in (("card", None, "bfloat16"),
                                    ("cpu", "cpu", "float32")):
            run_cfg = cfg.replace(compute_dtype=dtype, dataset=(
                dataclasses.replace(cfg.dataset,
                                    rcnet_output_dir=f"output_{name}")))
            run_cfgs[name] = (run_cfg, device)
            rec = runs[name] = {}
            LAUNCHES.clear()
            t0 = time.perf_counter()
            drivers.run_rcnet(run_cfg, str(rc_dir),
                              str(root / f"output_{name}"), scenes=scenes,
                              save_color=False, device=device)
            torch.cuda.synchronize()
            rec["run_rcnet_s"] = time.perf_counter() - t0
            rec["run_rcnet_launches"] = dict(LAUNCHES)
            LAUNCHES.clear()
            t0 = time.perf_counter()
            rec["best"] = drivers.validate_sml(
                run_cfg, str(sml_dir), output_path=str(root / f"val_{name}"),
                save_output=True, device=device)
            torch.cuda.synchronize()
            rec["validate_sml_s"] = time.perf_counter() - t0
            rec["validate_sml_launches"] = dict(LAUNCHES)
            rec["staged_s"] = rec["run_rcnet_s"] + rec["validate_sml_s"]
            log(f"16 staged run [{name}, {dtype}]: run_rcnet "
                f"{rec['run_rcnet_s']:.2f} s, validate_sml "
                f"{rec['validate_sml_s']:.2f} s for {n} frames "
                f"({smi}); launches {rec['run_rcnet_launches']} / "
                f"{rec['validate_sml_launches']}")
        card = runs["card"]["run_rcnet_launches"]
        if (card.get("roi_pool") != n or card.get("stem", 0) < n
                or card.get("compose", 0) < n):
            raise AssertionError(f"phase 16 run_rcnet on the card: "
                                 f"launches {card} for {n} frames")
        cpu = {k: v for r in ("run_rcnet_launches", "validate_sml_launches")
               for k, v in runs["cpu"][r].items()}
        if cpu:
            raise AssertionError(f"phase 16 on the CPU launched {cpu}")
        stage2 = {}
        for scene in scenes:
            tag = f"rcnet_{cfg.rcnet.response_threshold}"
            for png in sorted((root / "output_cpu" / tag / scene /
                               "depth_predicted").iterdir()):
                g = read_x256(png)
                r = read_x256(root / "output_card" / tag / scene /
                              "depth_predicted" / png.name)
                stage2.setdefault("mean_abs_dev", []).append(
                    float(np.abs(g - r).mean()))
                stage2.setdefault("covered_cpu", []).append(
                    float((g > 0).mean()))
                stage2.setdefault("covered_differently", []).append(
                    float(((g > 0) != (r > 0)).mean()))
        if len(stage2["mean_abs_dev"]) != n:
            raise AssertionError(f"phase 16: {len(stage2['mean_abs_dev'])} "
                                 f"stage-2 maps, not {n}")
        goldens, riders = root / "val_cpu" / "SML", root / "val_card" / "SML"
        for tree in (goldens, riders):
            pngs = sorted(tree.glob("*/sml_depth/*.png"))
            if len(pngs) != n:
                raise AssertionError(f"phase 16: {tree} holds {len(pngs)} "
                                     f"depth maps, not {n}")
        t0 = time.perf_counter()
        tool = compare_goldens(str(goldens), str(riders), root=str(root))
        tool_s = time.perf_counter() - t0
        direct = direct_report(goldens, riders)
        if tool["report"] != direct:
            raise AssertionError(f"phase 16: the tool's report "
                                 f"{tool['report']} vs numpy's {direct}")
        if tool["within_budget"] is not True or not all(
                math.isfinite(v) for m in ("golden_metrics", "riders_metrics")
                for v in tool[m].values()):
            raise AssertionError(f"phase 16: bf16 card vs f32 CPU outside "
                                 f"the 1% budget: {tool}")
        he = he_sml_diagnostic(cfg, run_cfgs, root, seed)
        log(f"16 diagnostic, the He-normal SML: {json.dumps(he)}")
        return dict(scenes=list(scenes), frames=n, frame=list(ZJU_FRAME),
                    runs=runs, tool_s=tool_s, report=tool["report"],
                    golden_metrics=tool["golden_metrics"],
                    riders_metrics=tool["riders_metrics"],
                    relative_deviation=tool["relative_deviation"],
                    within_budget=tool["within_budget"],
                    stage2_card_vs_cpu={k: max(v) for k, v in
                                        stage2.items()},
                    he_normal_sml=he)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def he_sml_diagnostic(cfg, run_cfgs, root, seed, device="cuda"):
    """Why phase 16's SML is `sml_weights`' and not `build_sml`'s (He-
    normal, `init_random_`, the head scaled by 1e-3): (a) `validate_sml`
    of the He-normal SML on each device's stage-2 tree, scored by
    `compare_goldens` (reported, not judged); (b) the bf16 SML's
    relative L2 distance from the f32 one, both on `device`, at the
    backbone's four taps and at the scale map less 1, on the network
    inputs of one seeded ZJU frame, for both weight sets.  A random deep
    network in its chaotic regime grows bf16's rounding from tap to tap,
    one in its ordered regime does not."""
    import torch
    from riders_tpu_torch.core import checkpoint
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines import drivers
    from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs
    from riders_tpu_torch.pipelines.sml_training import init_train_state
    from riders_tpu_torch.tools.compare_goldens import compare_goldens

    states = {"he_normal": build_sml(cfg, seed + 1, "cpu",
                                     torch.float32).state_dict(),
              "calibrated": sml_weights(cfg, seed + 1,
                                        head="output_conv.conv3")}
    model = ScaleMapLearner(cfg.sml, "cpu", torch.float32)
    model.load_state_dict(states["he_normal"])
    state = init_train_state(cfg, model, 1)
    state.step = 1
    checkpoint.save_train_state(root / "ckpt_sml_he", state)
    for name, (run_cfg, device) in run_cfgs.items():
        drivers.validate_sml(run_cfg, str(root / "ckpt_sml_he"),
                             output_path=str(root / f"he_{name}"),
                             save_output=True, device=device)
    tool = compare_goldens(str(root / "he_cpu" / "SML"),
                           str(root / "he_card" / "SML"), root=str(root))
    b = make_sml_train_batch(cfg, seed + 70, device, B=1)
    drift = {}
    with torch.no_grad():
        x, d = prepare_sml_inputs(cfg, b["image"], b["mono_pred"],
                                  b["radar"], b["rcnet"])
        for name, weights in states.items():
            outs = []
            for dtype in (torch.float32, torch.bfloat16):
                model = ScaleMapLearner(cfg.sml, device, dtype)
                model.load_state_dict(weights)
                model.eval()
                seen = []
                hook = model.pretrained.register_forward_hook(
                    lambda m, i, o: seen.extend(t.float() for t in o))
                _, scales = model(x.to(dtype), d)
                hook.remove()
                outs.append(seen + [scales.float() - 1.0])
            drift[name] = [float((b - a).norm() / a.norm())
                           for a, b in zip(*outs)]
    return dict(relative_deviation=tool["relative_deviation"],
                within_budget=tool["within_budget"],
                bf16_rel_l2_taps_and_scale=drift)


def goldens_line(smi, g):
    """The phase-16 summary line."""
    return dict(
        card=smi, frames=g["frames"], frame=g["frame"],
        within_budget=g["within_budget"],
        relative_deviation=g["relative_deviation"], report=g["report"],
        staged_s={k: r["staged_s"] for k, r in g["runs"].items()},
        run_rcnet_s={k: r["run_rcnet_s"] for k, r in g["runs"].items()},
        validate_sml_s={k: r["validate_sml_s"]
                        for k, r in g["runs"].items()},
        card_launches={k: g["runs"]["card"]["run_rcnet_launches"].get(k)
                       for k in ("stem", "roi_pool", "compose")},
        stage2_card_vs_cpu=g["stage2_card_vs_cpu"],
        he_normal_sml=g["he_normal_sml"])


def goldens_only(smi):
    """`--goldens`: phase 1, then phase 16 alone."""
    import torch
    g = goldens_phase(smi)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_goldens.json").write_text(json.dumps(
        dict(card=smi, goldens=g), indent=1))
    log(json.dumps({"goldens": goldens_line(smi, g)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


GOLDEN_ROWS = ((64, 96), (16, 96), (64, 64))   # (frames, returns), N=512
GOLDEN_BOUNDS = (0.01, 0.3)                    # the presets' bounds_inv
GOLDEN_CELLS = {"ntu": (FRAME, 96), "zju": (ZJU_FRAME, 64)}


def golden_rows(g, B, valid, n=512):
    """(p, t, m) rows on the card as the fused call gathers them: `valid`
    returns (the prior (1 / z) / 0.05 with 5% noise against the radar's
    inverse depth with 2%), the rest of the bucket prior values under a
    zero mask."""
    import torch
    z = 5.0 + 50.0 * torch.rand((B, n), generator=g, device="cuda")
    p = (1.0 / z) / 0.05 * (1.0 + 0.05 * torch.randn(
        (B, n), generator=g, device="cuda"))
    m = torch.zeros((B, n), device="cuda")
    m[:, :valid] = 1.0
    t = (1.0 / z) * (1.0 + 0.02 * torch.randn(
        (B, n), generator=g, device="cuda")) * m
    return p, t, m


def check_golden_section(seed=0, iterations=64):
    """Phase 17a: the kernel against the plain loop at GOLDEN_ROWS."""
    import torch
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.ops.kernels.golden_section import (
        golden_section, golden_section_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for B, valid in GOLDEN_ROWS:
        p, t, m = golden_rows(g, B, valid)
        args = (GOLDEN_BOUNDS, iterations)
        n0 = LAUNCHES["golden_section"]
        got = golden_section(p, t, m, *args)
        torch.cuda.synchronize()
        launches = LAUNCHES["golden_section"] - n0
        plain = golden_section_plain(p, t, m, *args)
        f64 = [(m.double() * (s.double()[:, None] * p.double()
                              - t.double()).abs()).sum(1)
               for s in (got, plain)]
        obj_rel = float(((f64[0] - f64[1]).abs() / f64[1]).max())
        zero = torch.zeros_like(m)
        zero_bitwise = torch.equal(golden_section(p, t, zero, *args),
                                   golden_section_plain(p, t, zero, *args))
        rec = dict(
            frames=B, n=p.shape[1], returns=valid, iterations=iterations,
            launches=launches, objective_max_rel=obj_rel,
            scale_max_rel=float(((got - plain).abs() / plain).max()),
            zero_mask_bitwise=zero_bitwise,
            b2b_us=1e3 * device_ms(lambda: golden_section(p, t, m, *args),
                                   n=200),
            sync_us=1e3 * time_ms(lambda: golden_section(p, t, m, *args),
                                  n=50),
            graph_us=1e3 * graph_ms(lambda: golden_section(p, t, m, *args)),
            plain_sync_ms=time_ms(lambda: golden_section_plain(p, t, m,
                                                               *args),
                                  n=10),
            plain_b2b_ms=device_ms(lambda: golden_section_plain(p, t, m,
                                                                *args),
                                   n=10))
        log(f"golden section {B}x{p.shape[1]} ({valid} returns): "
            f"{json.dumps(rec)}")
        out[f"{B}x{p.shape[1]}_{valid}"] = rec
        if launches != 1 or obj_rel > 1e-6 or not zero_bitwise:
            raise AssertionError(f"golden section {B}x{valid}: {rec}")
    return out


def golden_fused(preset, B=64, n=20, seed=0):
    """Phase 17b: the fused call at a lite cell's shapes, the kernel
    against the plain loop patched into `alignment`."""
    import dataclasses
    import torch
    from unittest import mock
    from riders_tpu_torch.core.config import ntu_config, zju_config
    from riders_tpu_torch.ops import alignment
    from riders_tpu_torch.ops.kernels import LAUNCHES
    from riders_tpu_torch.ops.kernels import golden_section as gs
    from riders_tpu_torch.pipelines.fused import make_fused_fn
    frame, bucket = GOLDEN_CELLS[preset]
    cfg = (ntu_config if preset == "ntu" else zju_config)()
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, image_shape=frame, max_points=bucket))
    rcnet, sml = build_models(cfg, seed, None, torch.bfloat16)
    fn = make_fused_fn(cfg, rcnet, sml)
    batch = make_batch(seed + 30, B, bucket, bucket, frame, "cuda")
    plain_calls = []

    def plain(*args):
        plain_calls.append(args[0].device.type)
        return gs.golden_section_plain(*args)

    with torch.inference_mode():
        fn(batch)
        torch.cuda.synchronize()
        n0 = LAUNCHES["golden_section"]
        with mock.patch.object(gs, "golden_section_plain", plain):
            fn(batch)
            torch.cuda.synchronize()
        launches = LAUNCHES["golden_section"] - n0
        if launches != 1 or plain_calls:
            raise AssertionError(f"golden section [{preset}]: {launches} "
                                 f"launches a fused call, plain loop on "
                                 f"{plain_calls}")
        times = {"kernel": ([], []), "plain": ([], [])}
        for i in range(2 * n + 2):
            side = ("kernel", "plain")[(i + i // 2) % 2]
            patch = (mock.patch.object(alignment, "golden_section",
                                       gs.golden_section_plain)
                     if side == "plain" else contextlib.nullcontext())
            with patch:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(batch)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            if i >= 2:
                times[side][0].append(1e3 * (t1 - t0))
                times[side][1].append(1e3 * (t2 - t0))
    rec = dict(preset=preset, batch=B, frame=list(frame), returns=bucket,
               launches_per_call=launches, calls_each=n)
    for side, (host, sync) in times.items():
        rec[f"{side}_host_ms"] = statistics.median(host)
        rec[f"{side}_sync_ms"] = statistics.median(sync)
    rec["host_ms_saved"] = rec["plain_host_ms"] - rec["kernel_host_ms"]
    rec["sync_ms_saved"] = rec["plain_sync_ms"] - rec["kernel_sync_ms"]
    log(f"golden section fused [{preset}]: {json.dumps(rec)}")
    del fn, rcnet, sml, batch
    torch.cuda.empty_cache()
    return rec


def golden_section_phase():
    """Phase 17: 17a, then 17b at NTU and ZJU."""
    t0 = time.perf_counter()
    out = dict(kernel=check_golden_section(),
               fused={p: golden_fused(p) for p in GOLDEN_CELLS})
    out["seconds"] = time.perf_counter() - t0
    return out


def golden_section_line(smi, gsec):
    """The phase-17 summary line."""
    return {"golden_section": dict(
        card=smi, replaces="riders_tpu/ops/alignment.py:_golden_section "
                           "(lax.fori_loop)",
        source="riders_tpu_torch/csrc/golden_section.cu",
        kernel={k: {f: r[f] for f in ("graph_us", "b2b_us", "sync_us",
                                      "plain_sync_ms", "plain_b2b_ms",
                                      "objective_max_rel", "scale_max_rel",
                                      "zero_mask_bitwise")}
                for k, r in gsec["kernel"].items()},
        fused={p: {f: r[f] for f in (
            "launches_per_call", "kernel_host_ms", "plain_host_ms",
            "host_ms_saved", "kernel_sync_ms", "plain_sync_ms",
            "sync_ms_saved")} for p, r in gsec["fused"].items()},
        seconds=gsec["seconds"])}


def golden_section_only(smi):
    """`--golden-section`: phase 1, then phase 17 alone."""
    gsec = golden_section_phase()
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_golden_section.json").write_text(
        json.dumps(gsec, indent=1))
    log(json.dumps(golden_section_line(smi, gsec)))
    log(smi)
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
    keep = ("ms", "graph_ms", "kernel_ms", "kernel_graph_ms", "device_ms",
            "library_ms",
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
    if "--determinism" in argv:
        # before cuBLAS starts, so that deterministic mode can hold it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if "--attention" in argv:
        return attention_only(smi, profile_dir)
    if "--swin2-attention" in argv:
        return swin2_attention_only(smi, profile_dir)
    if "--variants" in argv:
        return variants_only(smi)
    if "--stem-plans" in argv:
        return stem_plans(smi)
    if "--parallel" in argv:
        return parallel_only(smi, profile_dir)
    if "--multichip" in argv:
        return multichip_only(smi)
    if "--bench" in argv:
        return bench_only(smi)
    if "--goldens" in argv:
        return goldens_only(smi)
    if "--determinism" in argv:
        return determinism_only(smi)
    if "--lane" in argv:
        return lane_only(smi)
    if "--golden-section" in argv:
        return golden_section_only(smi)

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

    lane_kernels, lane, lane_cells = lane_phase(
        {"ntu": (ntu_fn, ntu_rcnet), "zju": (zju_fn, zju_rcnet)})
    log_lane(lane_kernels, lane, lane_cells)
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
        log_dpt(dpt)
        families = family_phase(root, profile_dir=profile_dir)
        torch.cuda.empty_cache()
        par = parallel_phase(root, profile_dir)
        log(f"parallel: {json.dumps(par)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    variants = variants_phase({"ntu": ntu["ms_per_call"],
                               "zju": zju["ms_per_call"]})
    log_variants(variants)
    fast = fast_paths_phase(agree["cpu_bf16_vs_cpu_f32"],
                            profile_dir=profile_dir)
    log(f"fast paths: {json.dumps(fast)}")
    bench_rec = bench_phase(agree["cpu_bf16_vs_cpu_f32"])
    torch.cuda.empty_cache()
    golden = goldens_phase(smi)
    gsec = golden_section_phase()

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
    # inference and lane kernels: launches of the fused NTU run; training
    # kernels: launches of the three RC-Net training steps; B6: launches
    # of one NTU 4D pyramid
    lane_launches = dict(ntu["launches"], roi_pool_4d=lane_kernels["ntu"][
        "roi_pool_4d"]["launches_per_call"])
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
                kernel_ms=r.get("kernel_ms"),
                kernel_graph_ms=r.get("kernel_graph_ms"),
                zju=dict((k, recs["zju"][name].get(k)) for k in
                         ("ms", "graph_ms", "device_ms", "plain_ms",
                          "library_ms",
                          "bound_ms"))))
    lines.append(stem_general_line(variants, sum(
        v["launches"].get("stem_general", 0)
        for v in variants["variants"].values())))
    details = dict(card=smi, torch=torch.__version__,
                   cuda=torch.version.cuda,
                   build_seconds=build_s, kernels=kernels,
                   fused=dict(ntu=ntu, zju=zju), reference=agree,
                   lane_kernels=lane_kernels, lane_decoder=lane,
                   lane_cells=lane_cells,
                   training_kernels=train_kernels, training=training,
                   training_agreement=train_agree, staged=staged,
                   cli=cli_runs, dpt=dpt, dpt_families=families,
                   rcnet_variants=variants, parallel=par, fast_paths=fast,
                   bench=bench_rec, goldens=golden, golden_section=gsec)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    log(json.dumps({"kernels": lines}))
    log(json.dumps({"fused": dict(card=smi, ntu_fps=ntu["fps"],
                                  ntu_ms=ntu["ms_per_call"],
                                  zju_fps_b4=zju["fps"],
                                  ref_median_rel_err=agree[
                                      "card_bf16_vs_cpu_f32"])}))
    log(json.dumps(lane_line(smi, lane, lane_cells)))
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
    log(json.dumps(families_line(smi, families)))
    log(json.dumps({"rcnet_variants": variants_line(smi, variants)}))
    log(json.dumps({"parallel": parallel_line(smi, par, fast)}))
    log(json.dumps({"bench": bench_line(smi, bench_rec)}))
    log(json.dumps({"goldens": goldens_line(smi, golden)}))
    log(json.dumps(golden_section_line(smi, gsec)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
