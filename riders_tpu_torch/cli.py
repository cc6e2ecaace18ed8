"""Command-line interface of the port, over the dataset presets:

    riders-torch train-sml   --dataset zju --root /data/ZJU --ckpt /log/sml
    riders-torch train-rcnet --dataset zju --root /data/ZJU --ckpt /log/rcnet
    riders-torch run-rcnet   --dataset zju --root /data/ZJU \\
                             --ckpt /log/rcnet --output /data/ZJU/output
    riders-torch val-sml     --dataset zju --root /data/ZJU --ckpt /log/sml
    riders-torch val-rcnet   --dataset zju --root /data/ZJU --ckpt /log/rcnet
    riders-torch eval-dir    --dataset zju --root /data/ZJU --results /out/SML
    riders-torch preprocess  --dataset zju --root /raw --output /data/ZJU
    riders-torch bench       [--ntu | --zju]

The subcommands and flags are the JAX package's `riders`, plus
`--device` (default `cuda`; `--device cpu` runs on the CPU, and without
a card the default raises).  `bench` runs `riders_tpu_torch.bench` on
the card, as `riders bench` runs `bench.py`.

`--multihost` joins a job of several processes, one rank per device,
before the command runs (`parallel.sharding.initialize_multihost`: NCCL
on the card, gloo with `--device cpu`), with `--coordinator host:port
--num-processes N --process-id I`, or without them from torchrun's
environment:

    torchrun --nproc-per-node 4 -m riders_tpu_torch.cli train-sml \
        --multihost --dataset zju --root /data/ZJU --ckpt /log/sml

The trainers then run data-parallel over the configured mesh; the
other commands run on every rank as they do alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _load_config(args):
    """The preset of `--dataset` at `--root`, with the override flags
    applied: scenes, the scale-map source, the response threshold and
    the batch size (of both trainers)."""
    from riders_tpu_torch.core.config import ntu_config, zju_config
    factory = {"zju": zju_config, "ntu": ntu_config}[args.dataset]
    cfg = factory(root=args.root or "")
    ds = cfg.dataset
    if getattr(args, "train_scenes", None):
        ds = dataclasses.replace(ds, train_scenes=tuple(args.train_scenes))
    if getattr(args, "val_scenes", None):
        ds = dataclasses.replace(ds, val_scenes=tuple(args.val_scenes))
    cfg = cfg.replace(dataset=ds)
    if getattr(args, "rcnet_interp", None):
        cfg = cfg.replace(sml_train=dataclasses.replace(
            cfg.sml_train, rcnet_interp=args.rcnet_interp))
    if getattr(args, "threshold", None) is not None:
        cfg = cfg.replace(rcnet=dataclasses.replace(
            cfg.rcnet, response_threshold=args.threshold))
    if getattr(args, "batch_size", None):
        cfg = cfg.replace(
            sml_train=dataclasses.replace(cfg.sml_train,
                                          batch_size=args.batch_size),
            rcnet_train=dataclasses.replace(cfg.rcnet_train,
                                            batch_size=args.batch_size))
    return cfg


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="riders-torch", description="RIDERS radar + thermal metric "
        "depth, PyTorch / CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, needs_root=True):
        p.add_argument("--dataset", choices=["zju", "ntu"], default="zju")
        if needs_root:
            p.add_argument("--root", required=True,
                           help="dataset root directory")
        p.add_argument("--log", default=None, help="log file path")
        p.add_argument("--train-scenes", nargs="*", default=None,
                       help="override the preset's training scenes")
        p.add_argument("--val-scenes", nargs="*", default=None,
                       help="override the preset's validation scenes")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu'")
        p.add_argument("--multihost", action="store_true",
                       help="join a multi-process job before the command "
                       "(torch.distributed; coordinator from the env or "
                       "--coordinator)")
        p.add_argument("--coordinator", default=None,
                       help="coordinator address for --multihost")
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)

    p = sub.add_parser("train-sml", help="train the Scale Map Learner")
    common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--rcnet-interp", default=None,
                   help="scale-map knot source: rcnet_<thr> (stage-2 "
                   "PNGs), none (raw radar), interp (dense IDW), "
                   "interp-exact (host griddata)")
    p.add_argument("--max-steps", type=int, default=None)

    p = sub.add_parser("train-rcnet", help="train RC-Net")
    common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)

    p = sub.add_parser("run-rcnet",
                       help="generate quasi-dense radar depth PNGs")
    common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=float, default=None)

    p = sub.add_parser("val-sml", help="validate SML checkpoints")
    common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--save-output", action="store_true")
    p.add_argument("--rcnet-interp", default=None)
    p.add_argument("--depth-predictor", default=None,
                   help="apply the per-mono-model test-time transform "
                   "tables (e.g. midas_small, dpt_beit_large_512)")
    p.add_argument("--void-sparsity", type=int, default=150,
                   help="VOID statistics row for --depth-predictor")

    p = sub.add_parser("val-rcnet", help="validate RC-Net checkpoints")
    common(p)
    p.add_argument("--ckpt", required=True)

    p = sub.add_parser("eval-dir",
                       help="score a directory of predicted depth PNGs")
    common(p)
    p.add_argument("--results", required=True)
    p.add_argument("--subdir", default="sml_depth")

    p = sub.add_parser("preprocess",
                       help="project point clouds to depth PNG trees")
    common(p)
    p.add_argument("--output", required=True)

    p = sub.add_parser("bench", help="fused-inference fps on the card "
                       "(CUDA graph replay and eager; riders_tpu_torch."
                       "bench)")
    p.add_argument("--ntu", action="store_true",
                   help="the NTU patch geometry alone")
    p.add_argument("--zju", action="store_true",
                   help="the ZJU patch geometry alone")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "bench":
        from riders_tpu_torch import bench
        return bench.main([f"--{p}" for p in ("ntu", "zju")
                           if getattr(args, p)])
    from riders_tpu_torch.core.device import resolve_device
    device = resolve_device(args.device)
    if not args.multihost:
        return _run(args, device)
    import torch.distributed as dist
    from riders_tpu_torch.parallel.sharding import initialize_multihost
    device = initialize_multihost(args.coordinator, args.num_processes,
                                  args.process_id, device)
    try:
        return _run(args, device)
    finally:
        dist.destroy_process_group()


def _run(args, device) -> int:
    cfg = _load_config(args)

    from riders_tpu_torch.pipelines import drivers
    if args.command == "train-sml":
        drivers.train_sml(cfg, args.ckpt, resume=args.resume,
                          log_path=args.log, max_steps=args.max_steps,
                          device=device)
    elif args.command == "train-rcnet":
        drivers.train_rcnet(cfg, args.ckpt, resume=args.resume,
                            log_path=args.log, max_steps=args.max_steps,
                            device=device)
    elif args.command == "run-rcnet":
        drivers.run_rcnet(cfg, args.ckpt, args.output, log_path=args.log,
                          device=device)
    elif args.command == "val-sml":
        if args.depth_predictor:
            from riders_tpu_torch.core import normalization
            spec = normalization.test_time_transforms(
                args.depth_predictor, "void", args.void_sparsity,
                cfg.dataset.image_shape)
            cfg = normalization.apply_to_config(cfg, spec)
        drivers.validate_sml(cfg, args.ckpt, output_path=args.output,
                             save_output=args.save_output,
                             log_path=args.log, device=device)
    elif args.command == "val-rcnet":
        drivers.validate_rcnet(cfg, args.ckpt, log_path=args.log,
                               device=device)
    elif args.command == "eval-dir":
        drivers.evaluate_results_dir(cfg, args.results,
                                     depth_subdir=args.subdir,
                                     log_path=args.log, device=device)
    elif args.command == "preprocess":
        from riders_tpu_torch.io.preprocess.project import \
            preprocess_dataset
        preprocess_dataset(cfg, args.root, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
