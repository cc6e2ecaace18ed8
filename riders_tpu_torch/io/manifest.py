"""Dataset manifest: scene walking and aligned per-frame path lists, for
the directory layout

    <root>/<scene>/thermal_undistort/*.png     thermal image
    <root>/<scene>/<mono_pred_dir>/*.png       monocular depth prior
    <root>/<scene>/radar_png/*.png|*.npy       sparse radar depth / points
    <root>/<scene>/lidar_png/*.png             sparse lidar GT
    <root>/<scene>/lidar_png_int/*.png         interpolated lidar GT
    <root>/output/rcnet_<thr>/<scene>/depth_predicted/*.png   stage-2 output
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

from riders_tpu_torch.core.config import DatasetConfig


@dataclasses.dataclass
class FrameRecord:
    """Paths for one frame; missing modalities are None."""

    scene: str
    frame_id: str
    image: str
    mono_pred: Optional[str] = None
    radar: Optional[str] = None
    gt_interp: Optional[str] = None
    gt_sparse: Optional[str] = None
    rcnet: Optional[str] = None


def _listdir_sorted(path: str) -> List[str]:
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def build_manifest(cfg: DatasetConfig, scenes: Sequence[str],
                   rcnet_interp: Optional[str] = None,
                   require_all: bool = True) -> List[FrameRecord]:
    """Aligned per-frame records of the given scenes: each modality's
    sorted directory listing, zipped by position.  With `require_all`
    every modality (and the stage-2 maps of `rcnet_interp`) must have as
    many files as there are images."""
    records: List[FrameRecord] = []
    for scene in scenes:
        scene_root = os.path.join(cfg.root, scene)
        dirs = {"image": cfg.image_dir, "mono_pred": cfg.mono_pred_dir,
                "radar": cfg.radar_dir, "gt_interp": cfg.gt_interp_dir,
                "gt_sparse": cfg.gt_sparse_dir}
        paths = {k: [os.path.join(scene_root, d, f) for f in
                     _listdir_sorted(os.path.join(scene_root, d))]
                 for k, d in dirs.items()}
        if rcnet_interp:
            rcnet_dir = os.path.join(cfg.root, cfg.rcnet_output_dir,
                                     rcnet_interp, scene, "depth_predicted")
            paths["rcnet"] = [os.path.join(rcnet_dir, f)
                              for f in _listdir_sorted(rcnet_dir)]
        if require_all:
            counts = {k: len(v) for k, v in paths.items()}
            if len(set(counts.values())) != 1:
                raise ValueError(
                    f"Modality count mismatch in scene {scene}: {counts}")
        images = paths.pop("image")
        if not images:
            raise ValueError(
                f"Scene {scene!r} has no frames under "
                f"{os.path.join(scene_root, cfg.image_dir)!r} - wrong root "
                "or scene name?")
        for i, image in enumerate(images):
            records.append(FrameRecord(
                scene=scene,
                frame_id=os.path.splitext(os.path.basename(image))[0],
                image=image,
                **{k: v[i] if i < len(v) else None
                   for k, v in paths.items()}))
    return records


def swap_rcnet_threshold(record: FrameRecord, threshold: float) -> str:
    """The record's stage-2 path at another response threshold."""
    if record.rcnet is None:
        raise ValueError(f"frame {record.frame_id} has no stage-2 path")
    cur = record.rcnet.split("rcnet_")[-1][:3]
    return record.rcnet.replace(f"rcnet_{cur}", f"rcnet_{threshold}")
