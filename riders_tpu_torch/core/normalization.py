"""Per-depth-predictor normalization tables and test-time transforms.

The VOID-dataset statistics of the SML intermediate inputs (int_depth,
int_scales) per monocular depth predictor and sparsity, and each
predictor's image mean / std and resize policy; `test_time_transforms`
resolves them for a frame size (with `ops.resize.compute_net_shape`) and
`apply_to_config` puts the SML half into a configuration (the CLI's
`val-sml --depth-predictor`).  The constants are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from riders_tpu_torch.ops.resize import compute_net_shape

# Mean / std of the SML intermediate inputs per (depth predictor, VOID
# sparsity): {"mean" | "std": {"int_depth": .., "int_scales": ..}}.
VOID_INTERMEDIATE: Dict[str, Dict[str, Dict[str, Dict[str, float]]]] = {
    "dpt_beit_large_512": {
        "void_150": {"mean": {"int_depth": 0.730, "int_scales": 0.380},
                     "std": {"int_depth": 0.226, "int_scales": 0.102}},
        "void_500": {"mean": {"int_depth": 0.736, "int_scales": 0.366},
                     "std": {"int_depth": 0.232, "int_scales": 0.099}},
        "void_1500": {"mean": {"int_depth": 0.730, "int_scales": 0.355},
                      "std": {"int_depth": 0.232, "int_scales": 0.096}},
    },
    "dpt_swin2_large_384": {
        "void_150": {"mean": {"int_depth": 0.730, "int_scales": 0.402},
                     "std": {"int_depth": 0.219, "int_scales": 0.107}},
        "void_500": {"mean": {"int_depth": 0.736, "int_scales": 0.389},
                     "std": {"int_depth": 0.224, "int_scales": 0.106}},
        "void_1500": {"mean": {"int_depth": 0.730, "int_scales": 0.377},
                      "std": {"int_depth": 0.226, "int_scales": 0.103}},
    },
    "dpt_large": {
        "void_150": {"mean": {"int_depth": 0.729, "int_scales": 0.403},
                     "std": {"int_depth": 0.213, "int_scales": 0.116}},
        "void_500": {"mean": {"int_depth": 0.735, "int_scales": 0.390},
                     "std": {"int_depth": 0.219, "int_scales": 0.116}},
        "void_1500": {"mean": {"int_depth": 0.730, "int_scales": 0.380},
                      "std": {"int_depth": 0.221, "int_scales": 0.116}},
    },
    "dpt_hybrid": {
        "void_150": {"mean": {"int_depth": 0.729, "int_scales": 0.404},
                     "std": {"int_depth": 0.210, "int_scales": 0.117}},
        "void_500": {"mean": {"int_depth": 0.735, "int_scales": 0.392},
                     "std": {"int_depth": 0.215, "int_scales": 0.118}},
        "void_1500": {"mean": {"int_depth": 0.730, "int_scales": 0.381},
                      "std": {"int_depth": 0.218, "int_scales": 0.117}},
    },
    "dpt_swin2_tiny_256": {
        "void_150": {"mean": {"int_depth": 0.735, "int_scales": 0.419},
                     "std": {"int_depth": 0.207, "int_scales": 0.122}},
        "void_500": {"mean": {"int_depth": 0.741, "int_scales": 0.406},
                     "std": {"int_depth": 0.212, "int_scales": 0.124}},
        "void_1500": {"mean": {"int_depth": 0.733, "int_scales": 0.396},
                      "std": {"int_depth": 0.213, "int_scales": 0.125}},
    },
    "dpt_levit_224": {
        "void_150": {"mean": {"int_depth": 0.734, "int_scales": 0.421},
                     "std": {"int_depth": 0.198, "int_scales": 0.129}},
        "void_500": {"mean": {"int_depth": 0.740, "int_scales": 0.410},
                     "std": {"int_depth": 0.202, "int_scales": 0.134}},
        "void_1500": {"mean": {"int_depth": 0.734, "int_scales": 0.400},
                      "std": {"int_depth": 0.204, "int_scales": 0.137}},
    },
    "midas_small": {
        "void_150": {"mean": {"int_depth": 0.723, "int_scales": 0.402},
                     "std": {"int_depth": 0.190, "int_scales": 0.132}},
        "void_500": {"mean": {"int_depth": 0.731, "int_scales": 0.393},
                     "std": {"int_depth": 0.196, "int_scales": 0.136}},
        "void_1500": {"mean": {"int_depth": 0.728, "int_scales": 0.385},
                      "std": {"int_depth": 0.199, "int_scales": 0.140}},
    },
}

# Per-predictor image statistics and resize policy of the monocular
# depth model's own input.
_IMAGE_MEAN = {
    "dpt_beit_large_512": (0.5, 0.5, 0.5),
    "dpt_swin2_large_384": (0.5, 0.5, 0.5),
    "dpt_large": (0.5, 0.5, 0.5),
    "dpt_hybrid": (0.5, 0.5, 0.5),
    "dpt_swin2_tiny_256": (0.5, 0.5, 0.5),
    "dpt_levit_224": (0.5, 0.5, 0.5),
    "midas_small": (0.485, 0.456, 0.406),
}
_IMAGE_STD = {
    "dpt_beit_large_512": (0.5, 0.5, 0.5),
    "dpt_swin2_large_384": (0.5, 0.5, 0.5),
    "dpt_large": (0.5, 0.5, 0.5),
    "dpt_hybrid": (0.5, 0.5, 0.5),
    "dpt_swin2_tiny_256": (0.5, 0.5, 0.5),
    "dpt_levit_224": (0.5, 0.5, 0.5),
    "midas_small": (0.229, 0.224, 0.225),
}
_RESIZE_METHOD = {
    "dpt_beit_large_512": "minimal",
    "dpt_swin2_large_384": "minimal",
    "dpt_large": "minimal",
    "dpt_hybrid": "minimal",
    "dpt_swin2_tiny_256": "minimal",
    "dpt_levit_224": "minimal",
    "midas_small": "upper_bound",
}
_RESIZE_TARGET = {
    "dpt_beit_large_512": 384,
    "dpt_swin2_large_384": 384,
    "dpt_large": 384,
    "dpt_hybrid": 384,
    "dpt_swin2_tiny_256": 256,
    "dpt_levit_224": 224,
    "midas_small": 384,
}


@dataclasses.dataclass(frozen=True)
class TestTimeTransformSpec:
    """Resolved test-time transform parameters for a (mono model, SML)
    pair.

    `depth_model_*` describe the monocular depth predictor's own input;
    `sml_*` the Scale Map Learner's (always the 384 multiple-of-32
    upper-bound resize, with the VOID intermediate statistics of the
    chosen predictor/sparsity)."""

    depth_model_net_shape: Tuple[int, int]
    depth_model_image_mean: Tuple[float, float, float]
    depth_model_image_std: Tuple[float, float, float]
    sml_net_shape: Tuple[int, int]
    int_depth_mean: float
    int_depth_std: float
    int_scales_mean: float
    int_scales_std: float


def apply_to_config(cfg, spec: "TestTimeTransformSpec"):
    """Return a RidersConfig with the SML net shape and intermediate
    statistics replaced by a resolved test-time spec (the val-sml
    --depth-predictor path)."""
    return cfg.replace(sml=dataclasses.replace(
        cfg.sml,
        net_shape=spec.sml_net_shape,
        int_depth_mean=spec.int_depth_mean,
        int_depth_std=spec.int_depth_std,
        int_scales_mean=spec.int_scales_mean,
        int_scales_std=spec.int_scales_std,
    ))


def test_time_transforms(depth_predictor: str,
                         sparsifier: str,
                         nsamples: int,
                         image_shape: Tuple[int, int]
                         ) -> TestTimeTransformSpec:
    """Resolve the per-mono-model test-time transform tables for a frame
    size.  `sparsifier`/`nsamples` select the VOID statistics row
    (e.g. ('void', 150))."""
    if depth_predictor not in VOID_INTERMEDIATE:
        raise KeyError(f"unknown depth predictor: {depth_predictor}; "
                       f"known: {sorted(VOID_INTERMEDIATE)}")
    stats = VOID_INTERMEDIATE[depth_predictor][f"{sparsifier}_{nsamples}"]
    keep_aspect = not ("swin2" in depth_predictor
                       or "levit" in depth_predictor)
    target = _RESIZE_TARGET[depth_predictor]
    if keep_aspect:
        dm_shape = compute_net_shape(image_shape, target=target,
                                     method=_RESIZE_METHOD[depth_predictor])
    else:
        dm_shape = (target, target)
    sml_shape = compute_net_shape(image_shape, target=384,
                                  method="upper_bound")
    return TestTimeTransformSpec(
        depth_model_net_shape=dm_shape,
        depth_model_image_mean=_IMAGE_MEAN[depth_predictor],
        depth_model_image_std=_IMAGE_STD[depth_predictor],
        sml_net_shape=sml_shape,
        int_depth_mean=stats["mean"]["int_depth"],
        int_depth_std=stats["std"]["int_depth"],
        int_scales_mean=stats["mean"]["int_scales"],
        int_scales_std=stats["std"]["int_scales"],
    )
