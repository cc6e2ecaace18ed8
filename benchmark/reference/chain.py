"""The reference's fused chain: frames in, metric depth out, in float32
with TF32 off, in blocks of frames.

    decode -> edge pad -> RC-Net responses -> adaptive threshold ->
    composition -> radar scatter -> stage-1 alignment and scale map ->
    SML -> bicubic upsample of 1 / pred

`responses(frames)` runs the chain up to RC-Net's responses, and
`depth(frames, responses)` the rest of it from given responses (its
own when none are given).  `Reference(cfg, weights, device, precision)`
with precision 'bf16' or 'fp8' stores the weights, inputs and outputs of
every conv and linear layer of both networks in that precision (fp8:
float8 e4m3 at one scale per tensor, amax to 448) and computes in
float32; 'fp8', the precision step below the configuration's bfloat16,
is the control.  `__call__(batch)` is the whole chain on one batch of
device tensors as the server hands it over, so that the reference can
stand in the program's place.

The SML reference is chosen by the configuration's `sml.model_type`:
`nets.SML` for midas-small, else the class `SML` of
`benchmark/reference/sml/<model_type>.py` (its README gives the
contract).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from benchmark.loader import load_file_module
from benchmark.reference import ops
from benchmark.reference.nets import SML, RCNet

FP8_MAX = 448.0
SML_DIR = __file__.rsplit("/", 1)[0] + "/sml"


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale per tensor (amax -> 448)."""
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDING = {"bf16": round_bf16, "fp8": round_fp8}


def emulate_(model: nn.Module, rounding) -> nn.Module:
    """Round the weights of every conv and linear layer in place, and
    each one's input and output on every call: the network with its
    weights and activations stored in a lower precision, computed in
    float32.  A module with a method `emulate_(rounding)` does the same
    for the weights it holds outside such layers."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(rounding(m.weight))
            m.register_forward_pre_hook(
                lambda mod, args: (rounding(args[0]),) + args[1:])
            m.register_forward_hook(lambda mod, args, out: rounding(out))
        own = getattr(m, "emulate_", None)
        if own is not None:
            own(rounding)
    return model


@contextlib.contextmanager
def f32_exact():
    """TF32 off for matmuls and cuDNN convolutions, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def sml_class(model_type: str) -> type:
    """The SML reference of `model_type`: `nets.SML` for midas-small,
    else the class `SML` of `SML_DIR/<model_type>.py`."""
    if model_type == "midas-small":
        return SML
    path = f"{SML_DIR}/{model_type}.py"
    try:
        module = load_file_module(path, "bench_sml_" + "".join(
            c if c.isalnum() else "_" for c in model_type))
    except FileNotFoundError as e:
        if e.filename != path:
            raise
        raise ValueError(f"no SML reference for model_type {model_type!r}:"
                         f" no file {path}") from None
    return module.SML


def sml_head(sml: nn.Module) -> str:
    """The dotted name of the SML's last head conv, which the weights'
    calibration sets: its class's `HEAD`, else "output_conv.conv3" (as
    for `nets.SML`)."""
    return getattr(type(sml), "HEAD", "output_conv.conv3")


def build_models(cfg: dict, device, meta: bool = False):
    """(RC-Net, SML) of the configuration, f32, eval; on the meta device
    when `meta` (shapes only)."""
    sml = sml_class(cfg["sml"]["model_type"])
    with torch.device("meta" if meta else device):
        return RCNet(cfg["rcnet"]).eval(), sml(cfg["sml"]).eval()


def decode(frames: Dict, device):
    """Compact frames, host arrays or device tensors, as f32 device
    tensors: image uint8 / 255, mono uint16 code / 256, points, mask."""
    def t(a):
        if isinstance(a, np.ndarray):
            if a.dtype == np.uint16:
                a = a.astype(np.int32)
            a = torch.from_numpy(np.ascontiguousarray(a))
        elif a.dtype == torch.uint16:
            a = a.view(torch.int16).int() & 0xFFFF
        return a.to(device)
    image = t(frames["image"]).float() * (1.0 / 255.0)
    mono = t(frames["mono_pred"]).float() * (1.0 / 256.0)
    return (image, mono, t(frames["radar_points"]).float(),
            t(frames["point_mask"]).float())


class Reference:
    """The chain on the configuration `cfg` (its rcnet, sml, alignment
    and dataset sections) with the benchmark's weights, a dict of the
    RC-Net's and one of the SML's f32 tensors."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict], device,
                 precision: str = "f32", block: int = 4):
        self.cfg, self.device, self.block = cfg, device, block
        self.weights = weights
        self.rcnet, self.sml = build_models(cfg, device)
        self.rcnet.load_state_dict(weights["rcnet"])
        self.sml.load_state_dict(weights["sml"])
        if precision != "f32":
            emulate_(self.rcnet, ROUNDING[precision])
            emulate_(self.sml, ROUNDING[precision])

    def rcnet_responses(self, image, points, mask):
        """(B, K, ph, pw) masked responses of decoded frames."""
        patch = tuple(self.cfg["rcnet"]["patch_size"])
        padded = ops.edge_pad(image, patch[0] // 2, patch[1] // 2)
        shifted, boxes = ops.shift_points_and_boxes(points, patch)
        return self.rcnet(padded, shifted, boxes, mask)

    def stage_inputs(self, image, mono, points, mask, resp):
        """Everything between RC-Net and the SML: its (x, d) inputs."""
        rc, ds = self.cfg["rcnet"], self.cfg["dataset"]
        frame, patch = tuple(ds["image_shape"]), tuple(rc["patch_size"])
        shifted, _ = ops.shift_points_and_boxes(points, patch)
        if rc["adaptive_composition"]:
            thr = ops.adaptive_threshold(
                resp, mask, rc["response_threshold"], rc["threshold_decay"],
                rc["max_threshold_retries"])
        else:
            thr = torch.full((mask.shape[0],), rc["response_threshold"],
                             device=mask.device)
        quasi = ops.compose(resp, shifted, mask, frame, patch, thr)
        radar = ops.scatter_points(points, mask, frame)
        return ops.sml_inputs(self.cfg["alignment"], self.cfg["sml"],
                              image, mono, radar, quasi)

    def after_rcnet(self, image, mono, points, mask, resp):
        """(B, H, W) metric depth from decoded frames and responses."""
        frame = tuple(self.cfg["dataset"]["image_shape"])
        x, d = self.stage_inputs(image, mono, points, mask, resp)
        pred = self.sml(x, d)
        return ops.resize_nchw((1.0 / pred).permute(0, 3, 1, 2), frame,
                               "bicubic")[:, 0]

    def _blocks(self, frames: Dict):
        n = len(frames["image"])
        for s in range(0, n, self.block):
            yield s, decode({k: v[s:s + self.block]
                             for k, v in frames.items()}, self.device)

    @torch.no_grad()
    def responses(self, frames: Dict) -> torch.Tensor:
        """(B, K, ph, pw) RC-Net responses of frames, `block` at a time."""
        with f32_exact():
            return torch.cat([self.rcnet_responses(im, pts, m)
                              for _, (im, _, pts, m) in self._blocks(frames)])

    @torch.no_grad()
    def depth(self, frames: Dict, responses=None) -> torch.Tensor:
        """(B, H, W) metric depth of frames, `block` at a time; from the
        given (B, K, ph, pw) `responses` on, where they are given."""
        out = []
        with f32_exact():
            for s, (im, mono, pts, m) in self._blocks(frames):
                resp = (self.rcnet_responses(im, pts, m) if responses is None
                        else responses[s:s + self.block].to(self.device,
                                                            torch.float32))
                out.append(self.after_rcnet(im, mono, pts, m, resp))
        return torch.cat(out)

    def __call__(self, batch: Dict) -> torch.Tensor:
        return self.depth(batch)
