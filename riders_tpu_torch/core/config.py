"""Configuration tree of the inference paths, the drivers and the
training steps.

The port's own copy of the dataclasses and the ZJU / NTU presets of the
JAX package's configuration, field for field and value for value, so
that the trainers log the same parameters.  Four fields are read by
neither package: `sml.backbone`, `eval.save_output` (the drivers take
`save_output` as an argument) and the mesh's axis names (the port's are
fixed, `parallel.sharding.DATA_AXIS` and `POINTS_AXIS`).  All shapes
are static: frame size, patch size, the radar-point bucket and the SML
network input are part of the config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """On-disk dataset layout and frame geometry.  ZJU thermal: 480x640;
    NTU thermal: 512x640."""

    name: str = "zju"
    root: str = ""
    # Directory names inside each scene directory.
    image_dir: str = "thermal_undistort"
    mono_pred_dir: str = "any"          # monocular depth prior
    radar_dir: str = "radar_png"
    gt_interp_dir: str = "lidar_png_int"
    gt_sparse_dir: str = "lidar_png"
    rcnet_output_dir: str = "output"    # root of the stage-2 depth maps
    image_shape: Tuple[int, int] = (480, 640)
    train_scenes: Tuple[str, ...] = ()
    val_scenes: Tuple[str, ...] = ()
    # Fixed radar-point bucket (static shapes).
    max_points: int = 64


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    """Stage-1 global scale alignment of the mono prior.

    ``mode`` 's' is the bounded 1-D scale search, 'st' the closed-form
    scale and shift least squares; bounds depend on whether the prior is
    inverse ('inv') or positive ('pos') depth.
    """

    mode: str = "s"
    mono_type: str = "inv"
    bounds_inv: Tuple[float, float] = (0.01, 0.3)
    bounds_pos: Tuple[float, float] = (0.5, 1.6)
    iterations: int = 64                # golden-section iterations
    # Clamps of the aligned inverse depth: <= 1/min_pred, >= 1/max_pred.
    min_pred: float = 0.1
    max_pred: float = 255.0
    # Input-depth validity window.
    min_depth: float = 0.0
    max_depth: float = 100.0
    # Static bound on valid alignment-target pixels per frame; when it
    # fits the gather bucket the L1 solve runs on the gathered pixels.
    max_valid_pixels: Optional[int] = 512


@dataclasses.dataclass(frozen=True)
class SMLConfig:
    """Scale Map Learner (MiDaS-small topology, efficientnet-lite3)."""

    # 'midas-small' | 'midas-small-depth' | the DPT rows 'dpt-large',
    # 'dpt-vit-base', 'dpt-beit-large', 'dpt-beit-large-384',
    # 'dpt-beit-base', 'dpt-hybrid' (models/factory.py); the swin2, levit
    # and next_vit rows are not ported yet
    model_type: str = "midas-small"
    features: int = 64
    expand: bool = True
    in_channels: int = 3                # (int_depth, int_scales, gray)
    backbone: str = "efficientnet_lite3"
    align_corners: bool = True          # fusion-block upsample convention
    net_shape: Tuple[int, int] = (288, 384)
    regress_mode: str = "scale"         # 'scale' | 'depth'
    min_pred: float = 0.1
    max_pred: float = 255.0
    int_depth_mean: float = 0.729
    int_depth_std: float = 0.210
    int_scales_mean: float = 0.404
    int_scales_std: float = 0.117


@dataclasses.dataclass(frozen=True)
class RCNetConfig:
    """RC-Net radar-pixel correspondence network."""

    patch_size: Tuple[int, int] = (240, 100)        # ZJU; NTU (150, 50)
    input_channels_image: int = 3
    input_channels_depth: int = 3
    n_filters_encoder_image: Tuple[int, ...] = (32, 64, 128, 128, 128)
    n_neurons_encoder_depth: Tuple[int, ...] = (32, 64, 128, 128, 128)
    n_filters_decoder: Tuple[int, ...] = (256, 128, 64, 32, 16)
    n_resolution: int = 1
    attention_layers: int = 4                       # x (self, cross)
    attention_heads: int = 8
    use_batch_norm: bool = True
    activation: str = "leaky_relu"                  # negative_slope 0.2
    response_threshold: float = 0.1                 # NTU: 0.4
    threshold_decay: float = 0.05
    max_threshold_retries: int = 8
    adaptive_composition: bool = True
    normalized_image_range: Tuple[float, float] = (0.0, 1.0)

    @property
    def encoder_downsample(self) -> int:
        """Total encoder stride, 2^n_stages (/32 for 5 stages)."""
        return 2 ** len(self.n_filters_encoder_image)

    @property
    def latent_shape(self) -> Tuple[int, int]:
        d = self.encoder_downsample
        return (self.patch_size[0] // d, self.patch_size[1] // d)


@dataclasses.dataclass(frozen=True)
class RCNetTrainConfig:
    """RC-Net training: batch, optimizer schedule, loss, the augmentation
    of RCNetTrainDataset and the summary / checkpoint cadence."""

    batch_size: int = 4
    learning_rates: Tuple[float, ...] = (2e-4,)
    learning_schedule: Tuple[int, ...] = (100,)     # epoch boundaries
    points_per_frame: int = 30                      # NTU: 40
    w_positive_class: float = 2.5
    max_distance_correspondence: float = 0.5        # metres
    set_invalid_to_negative_class: bool = False
    sample_probability_of_lidar: float = 0.10       # pseudo-radar frames
    augmentation_probability: float = 1.0
    random_brightness: Tuple[float, float] = (0.6, 1.4)
    random_contrast: Tuple[float, float] = (0.6, 1.4)
    random_saturation: Tuple[float, float] = (0.6, 1.4)
    random_flip_type: Tuple[str, ...] = ("horizontal",)
    # Noise on the point coordinates fed to the point encoder: 'none',
    # 'gaussian' or 'uniform' (off in both presets).
    random_noise_type: str = "none"
    random_noise_spread: float = -1.0
    n_step_per_summary: int = 100
    n_step_per_checkpoint: int = 2000


@dataclasses.dataclass(frozen=True)
class SMLTrainConfig:
    """SML training: batch, optimizer schedule, loss, the GT hygiene ops,
    the augmentation of SMLFrameDataset and the summary / checkpoint
    cadence."""

    batch_size: int = 12
    learning_rates: Tuple[float, ...] = (1e-4, 5e-5)
    learning_schedule: Tuple[int, ...] = (20, 200)
    loss_func: str = "l1"
    w_lidar_loss: float = 1.5                       # NTU: 1.0
    w_smoothness: float = 0.2
    w_edge: float = 0.0
    w_unsupervised: float = 0.0
    w_weight_decay: float = 0.0
    sobel_filter_size: int = 7
    gt_outlier_removal_kernel_size: int = 3
    gt_outlier_removal_threshold: float = 1.5
    gt_dilation_kernel_size: int = -1
    # Host augmentations of SMLFrameDataset(train=True).
    random_flip: bool = True
    random_crop_size: Optional[Tuple[int, int]] = None
    random_radar_noise: Optional[Tuple[float, float]] = (-0.01, 0.01)
    random_rcnet_thresholds: Optional[Tuple[float, ...]] = None
    # Scale-map knot source: 'rcnet_<thr>' feeds the quasi-dense stage-2
    # depth; 'none' uses the raw radar knots only; 'interp' densifies the
    # knot scales by IDW on the device, 'interp-exact' by scipy griddata
    # on the host.
    rcnet_interp: str = "rcnet_0.1"
    # Validation-time knot source when it differs from training (NTU
    # trains on rcnet_0.4 and validates on rcnet_0.5); None = the same.
    rcnet_interp_val: Optional[str] = None
    n_step_per_summary: int = 10
    n_step_per_checkpoint: int = 1000


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation protocol: the depth window of the metrics."""

    min_depth_val: float = 0.0
    max_depth_val: float = 50.0                     # NTU: 70.0
    delta_threshold: float = 1.25
    save_output: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, points) mesh of ranks (`parallel.sharding`): `data`
    splits the frame batch, `points` the per-frame radar-point patches of
    RC-Net.  data_parallel -1 takes every rank left."""

    data_axis: str = "data"
    points_axis: str = "points"
    data_parallel: int = -1
    points_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class RidersConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    alignment: AlignmentConfig = dataclasses.field(
        default_factory=AlignmentConfig)
    sml: SMLConfig = dataclasses.field(default_factory=SMLConfig)
    rcnet: RCNetConfig = dataclasses.field(default_factory=RCNetConfig)
    rcnet_train: RCNetTrainConfig = dataclasses.field(
        default_factory=RCNetTrainConfig)
    sml_train: SMLTrainConfig = dataclasses.field(
        default_factory=SMLTrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Compute dtype of the models the drivers build; weights load in it.
    compute_dtype: str = "bfloat16"

    def replace(self, **kw) -> "RidersConfig":
        return dataclasses.replace(self, **kw)


def zju_config(root: str = "", **overrides) -> RidersConfig:
    """ZJU-Multispectrum preset: 480x640 frames, 240x100 patches, eval
    cap 50 m."""
    cfg = RidersConfig(
        dataset=DatasetConfig(
            name="zju",
            root=root,
            image_shape=(480, 640),
            train_scenes=(
                "2023-10-19-19-25-47",
                "2023-10-20-10-05-18", "2023-10-20-10-21-14",
                "2023-10-20-10-35-20", "2023-10-20-13-56-28",
                "2023-10-20-14-23-10", "2023-10-20-14-28-18",
                "2023-10-20-14-38-17", "2023-10-20-14-53-28",
            ),
            val_scenes=(
                "2023-10-20-10-07-22",
                "2023-10-20-10-28-46",
                "2023-10-20-14-35-31",
            ),
        ),
        sml=SMLConfig(net_shape=(288, 384)),
        rcnet=RCNetConfig(patch_size=(240, 100), response_threshold=0.1),
        rcnet_train=RCNetTrainConfig(points_per_frame=30, batch_size=4),
        sml_train=SMLTrainConfig(w_lidar_loss=1.5, rcnet_interp="rcnet_0.1"),
        eval=EvalConfig(max_depth_val=50.0),
    )
    return cfg.replace(**overrides) if overrides else cfg


def ntu_config(root: str = "", **overrides) -> RidersConfig:
    """NTU4DRadLM preset: 512x640 frames, 150x50 patches, threshold 0.4;
    RC-Net trains at batch 24 with 40 points, SML on rcnet_0.4 knots and
    validates on rcnet_0.5; eval cap 70 m."""
    cfg = RidersConfig(
        dataset=DatasetConfig(name="ntu", root=root, image_shape=(512, 640),
                              max_points=96),
        sml=SMLConfig(net_shape=(288, 352)),
        rcnet=RCNetConfig(patch_size=(150, 50), response_threshold=0.4),
        rcnet_train=RCNetTrainConfig(
            points_per_frame=40, batch_size=24, learning_rates=(2e-4,)),
        sml_train=SMLTrainConfig(
            w_lidar_loss=1.0, rcnet_interp="rcnet_0.4",
            rcnet_interp_val="rcnet_0.5",
            learning_rates=(5e-5, 2e-5), learning_schedule=(10, 80)),
        eval=EvalConfig(max_depth_val=70.0),
    )
    return cfg.replace(**overrides) if overrides else cfg
