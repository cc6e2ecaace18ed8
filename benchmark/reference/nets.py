"""Plain float32 RC-Net and Scale Map Learner (midas-small,
EfficientNet-Lite3), the benchmark's reference for the served path.

A frozen copy of the mathematics of RIDERS' two networks in eval mode,
written against torch.nn and torch.nn.functional alone: no kernel, no
folded weights, no cached forms.  Module and attribute names follow the
parameter tree of the system under test, so one state dict made by the
benchmark loads into both.  Only the forms the benchmark's
configurations select are written here (single-resolution RC-Net with
BatchNorm and leaky relu, linear attention, the midas-small SML in scale
mode); anything else raises.

RC-Net: a 7x7 stride-2 stem with BatchNorm, leaky relu 0.2 and a 3x3
stride-2 max pool; ResNet-18-style stages (skips at /2 .. /16, latent at
/32); a point MLP lifting each radar (u, v, z) to a token grid; RoI max
pooling of every scale around each point; four LoFTR self / cross
linear-attention layer pairs; concat fusion and a U-Net decoder (nearest
upsampling by integer indices, BatchNorm, leaky relu) to one logit per
patch pixel; sigmoid responses, masked.

SML: 3x3 conv, BatchNorm, relu; the EfficientNet-Lite3 backbone (relu6,
BatchNorm eps 1e-3, TF 'SAME' padding); four fusion blocks (bilinear x2,
align_corners=True); the head (bilinear x2, align_corners=False); scales
relu(1 + out), pred = d * scales, clamped to [1/max_pred, 1/min_pred].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops import roi_pool_pyramid, resize_nchw

LEAKY = 0.2
LN_EPS = 1e-6
EFF_BN_EPS = 1e-3
# EfficientNet-Lite3: (kernel, stride, expand, out_channels, repeats)
LITE3_STAGES = ((3, 1, 1, 24, 1), (3, 2, 6, 32, 3), (5, 2, 6, 48, 3),
                (3, 2, 6, 96, 5), (5, 1, 6, 136, 5), (5, 2, 6, 232, 6),
                (3, 1, 6, 384, 1))
LITE3_TAPS = (1, 2, 4, 6)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY)


class BN(nn.BatchNorm2d):
    """BatchNorm in eval: the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBlock(nn.Module):
    """Bias-free conv (padding k // 2) -> [BN] -> [leaky relu]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 act: bool = True, bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = BN(cout) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return leaky(x) if self.act else x


class Stem(nn.Module):
    """7x7 stride-2 conv, BN, leaky relu; returns (map, 3x3/2 max pool)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 7, 2, 3, bias=False)
        self.bn = BN(cout)

    def forward(self, x: torch.Tensor):
        h = leaky(self.bn(self.conv(x)))
        return h, F.max_pool2d(h, 3, 2, 1)


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = ConvBlock(cin, cout, 3, stride)
        self.conv2 = ConvBlock(cout, cout, 3, 1)
        self.projection = (ConvBlock(cin, cout, 1, stride, act=False,
                                     bn=False)
                           if cin != cout or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.projection is not None:
            x = self.projection(x)
        return leaky(out + x)


class ImageEncoder(nn.Module):
    def __init__(self, filters: Sequence[int], cin: int):
        super().__init__()
        self.n_stages = len(filters)
        self.conv1 = Stem(cin, filters[0])
        self.stage_blocks: List[List[str]] = []
        prev = filters[0]
        for si, feat in enumerate(filters[1:]):
            names = []
            for bi in range(2):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                name = f"blocks{si + 2}_{bi}"
                self.add_module(name, ResNetBlock(prev, feat, stride))
                names.append(name)
                prev = feat
            self.stage_blocks.append(names)

    def forward(self, x: torch.Tensor):
        h, pooled = self.conv1(x)
        skips = [h]
        h = pooled
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                h = getattr(self, name)(h)
            if si < self.n_stages - 2:
                skips.append(h)
        return h, skips


class FC(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky(self.linear(x))


class PointEncoder(nn.Module):
    def __init__(self, neurons: Sequence[int], latent: int, cin: int):
        super().__init__()
        self.n_layers = len(neurons)
        prev = cin
        for i, feat in enumerate(neurons):
            self.add_module(f"fc{i}", FC(prev, feat))
            prev = feat
        self.fc_out = FC(prev, latent)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
        return self.fc_out(x)


def linear_attention(q, k, v, eps: float = 1e-6):
    """elu+1 feature-map attention; q (N, L, H, D), k, v (N, S, H, D)."""
    Q, K = F.elu(q) + 1.0, F.elu(k) + 1.0
    length = v.shape[1]
    v = v / length
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * length


class AttentionLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp1 = nn.Linear(2 * d, 2 * d, bias=False)
        self.mlp2 = nn.Linear(2 * d, d, bias=False)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        s, h = src.shape[1], self.heads
        q = self.q_proj(x).reshape(n, l, h, c // h)
        k = self.k_proj(src).reshape(n, s, h, c // h)
        v = self.v_proj(src).reshape(n, s, h, c // h)
        msg = self.norm1(self.merge(linear_attention(q, k, v)
                                    .reshape(n, l, c)))
        msg = self.mlp2(F.relu(self.mlp1(torch.cat([x, msg], -1))))
        return x + self.norm2(msg)


class Attention(nn.Module):
    """`n` pairs of (self, cross) layers; the second stream's cross layer
    sees the first stream's update."""

    def __init__(self, d: int, heads: int, n: int):
        super().__init__()
        self.n_layers = 2 * n
        for i in range(self.n_layers):
            self.add_module(f"layer{i}", AttentionLayer(d, heads))

    def forward(self, a: torch.Tensor, b: torch.Tensor):
        for i in range(self.n_layers):
            layer = getattr(self, f"layer{i}")
            if i % 2 == 0:
                a, b = layer(a, a), layer(b, b)
            else:
                a = layer(a, b)
                b = layer(b, a)
        return a, b


class UpConv(nn.Module):
    """Nearest resize to `shape` (integer source indices), ConvBlock."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBlock(cin, cout, 3, 1)

    def forward(self, x: torch.Tensor, shape) -> torch.Tensor:
        return self.conv(resize_nchw(x, shape, "nearest"))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.deconv = UpConv(cin, cout)
        self.conv = ConvBlock(cout + skip, cout, 3, 1)

    def forward(self, x, skip=None, shape=None):
        target = tuple(skip.shape[-2:]) if skip is not None else shape
        h = self.deconv(x, target)
        if skip is not None:
            h = torch.cat([h, skip], 1)
        return self.conv(h)


class Decoder(nn.Module):
    """Single-resolution U-Net decoder to (N, 1, ph, pw) logits."""

    def __init__(self, cin: int, skips: Sequence[int],
                 filters: Sequence[int], out_shape: Tuple[int, int]):
        super().__init__()
        self.depth = len(filters)
        self.n_skips = len(skips)
        self.out_shape = tuple(out_shape)
        prev = cin
        for i, feat in enumerate(filters[:-1]):
            d = self.depth - 1 - i
            si = self.n_skips - 1 - i
            self.add_module(f"deconv{d}", DecoderBlock(
                prev, skips[si] if si >= 0 else 0, feat))
            prev = feat
        skip0 = skips[0] if self.n_skips == self.depth else 0
        self.deconv0 = DecoderBlock(prev, skip0, filters[-1])
        self.output0 = ConvBlock(filters[-1], 1, 3, 1, act=False, bn=False)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]):
        h = x
        for i in range(self.depth - 1):
            si = len(skips) - 1 - i
            h = getattr(self, f"deconv{self.depth - 1 - i}")(
                h, skip=skips[si] if si >= 0 else None)
        if len(skips) == self.depth:
            h = self.deconv0(h, skip=skips[0])
        else:
            h = self.deconv0(h, shape=self.out_shape)
        return self.output0(h)


class RCNet(nn.Module):
    """RC-Net in eval mode.  forward(image, points, boxes, mask) takes the
    edge-padded NHWC frame, the (B, K, 3) points in its coordinates, the
    (B, K, 4) [x1, y1, x2, y2] boxes and the (B, K) mask, and returns the
    (B, K, ph, pw) responses, 0 for a masked slot."""

    def __init__(self, rc: dict):
        super().__init__()
        if (rc["n_resolution"] != 1 or rc["activation"] != "leaky_relu"
                or not rc["use_batch_norm"]):
            raise ValueError("the reference writes the single-resolution "
                             "leaky-relu BatchNorm RC-Net only")
        filters = tuple(rc["n_filters_encoder_image"])
        neurons = tuple(rc["n_neurons_encoder_depth"])
        self.patch = tuple(rc["patch_size"])
        stride = 2 ** len(filters)
        self.latent_shape = (self.patch[0] // stride,
                             self.patch[1] // stride)
        d = neurons[-1]
        self.encoder_image = ImageEncoder(filters,
                                          rc["input_channels_image"])
        self.encoder_depth = PointEncoder(
            neurons, d * self.latent_shape[0] * self.latent_shape[1],
            rc["input_channels_depth"])
        self.attention = Attention(d, rc["attention_heads"],
                                   rc["attention_layers"])
        self.decoder = Decoder(filters[-1] + d, filters[:-1],
                               tuple(rc["n_filters_decoder"]), self.patch)

    def forward(self, image, points, boxes, mask):
        B, K = points.shape[:2]
        lh, lw = self.latent_shape
        latent, skips = self.encoder_image(image.permute(0, 3, 1, 2))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        p_lat, p_skips = roi_pool_pyramid(nhwc(latent),
                                          [nhwc(s) for s in skips],
                                          boxes, self.patch)
        p_skips = [s.reshape((B * K,) + s.shape[2:]).permute(0, 3, 1, 2)
                   for s in p_skips]
        d = self.encoder_depth.fc_out.linear.out_features // (lh * lw)
        pt = self.encoder_depth(points.reshape(B * K, -1))
        pt = pt.reshape(B * K, d, lh * lw).transpose(1, 2)
        im = p_lat.reshape(B * K, lh * lw, -1)
        pt, im = self.attention(pt, im)
        fused = torch.cat([im.reshape(B * K, lh, lw, -1),
                           pt.reshape(B * K, lh, lw, -1)], -1)
        logits = self.decoder(fused.permute(0, 3, 1, 2), p_skips)
        logits = logits.reshape((B, K) + logits.shape[-2:])
        return torch.sigmoid(logits) * (mask > 0)[:, :, None, None]


# ---- Scale Map Learner

def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


class SameConv(nn.Conv2d):
    """Bias-free conv with TF 'SAME' padding, the smaller half first."""

    def __init__(self, cin, cout, k, stride=1, groups=1):
        super().__init__(cin, cout, k, stride, 0, groups=groups,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        (t, b), (l, r) = pads
        return super().forward(F.pad(x, (l, r, t, b)))


class DSBlock(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv_dw = SameConv(cin, cin, k, stride, groups=cin)
        self.bn1 = BN(cin, eps=EFF_BN_EPS)
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = BN(cout, eps=EFF_BN_EPS)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.bn2(self.conv_pw(relu6(self.bn1(self.conv_dw(x)))))
        return h + x if self.residual else h


class MBBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BN(mid, eps=EFF_BN_EPS)
        self.conv_dw = SameConv(mid, mid, k, stride, groups=mid)
        self.bn2 = BN(mid, eps=EFF_BN_EPS)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BN(cout, eps=EFF_BN_EPS)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = relu6(self.bn1(self.conv_pw(x)))
        h = relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class Lite3(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = SameConv(3, 32, 3, 2)
        self.bn_stem = BN(32, eps=EFF_BN_EPS)
        self.stage_blocks: List[List[str]] = []
        prev = 32
        for si, (k, s, e, c, r) in enumerate(LITE3_STAGES):
            names = []
            for bi in range(r):
                stride = s if bi == 0 else 1
                name = f"stage{si}_block{bi}"
                self.add_module(name, DSBlock(prev, c, k, stride) if e == 1
                                else MBBlock(prev, c, k, stride, e))
                names.append(name)
                prev = c
            self.stage_blocks.append(names)

    def forward(self, x):
        h = relu6(self.bn_stem(self.conv_stem(x)))
        taps = []
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                h = getattr(self, name)(h)
            if si in LITE3_TAPS:
                taps.append(h)
        return taps


def conv3(cin, cout, bias=True):
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=bias)


class ResidualConvUnit(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = conv3(f, f)
        self.conv2 = conv3(f, f)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, f, expand, has_skip=True):
        super().__init__()
        self.res_conf_unit1 = ResidualConvUnit(f) if has_skip else None
        self.res_conf_unit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f // 2 if expand else f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.res_conf_unit1(skip)
        x = self.res_conf_unit2(x)
        x = resize_nchw(x, (2 * x.shape[-2], 2 * x.shape[-1]), "bilinear",
                        align_corners=True)
        return self.out_conv(x)


class Head(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = conv3(f, f // 2)
        self.conv2 = conv3(f // 2, 32)
        self.conv3 = nn.Conv2d(32, 1, 1)

    def forward(self, x):
        h = self.conv1(x)
        h = resize_nchw(h, (2 * h.shape[-2], 2 * h.shape[-1]), "bilinear")
        return self.conv3(F.relu(self.conv2(h)))


class SML(nn.Module):
    """forward(x, d): x (N, h, w, 3) normalised inputs, d (N, h, w, 1)
    aligned inverse depth; returns pred (N, h, w, 1)."""

    def __init__(self, sml: dict):
        super().__init__()
        if (sml["model_type"] != "midas-small" or not sml["expand"]
                or sml["regress_mode"] != "scale"
                or not sml["align_corners"]):
            raise ValueError("the reference writes the expanded midas-small "
                             "SML in scale mode only")
        f = sml["features"]
        widths = (f, 2 * f, 4 * f, 8 * f)
        self.min_pred, self.max_pred = sml["min_pred"], sml["max_pred"]
        self.first_conv = conv3(sml["in_channels"], 3)
        self.first_bn = BN(3, eps=1e-5)
        self.pretrained = Lite3()
        taps = [LITE3_STAGES[t][3] for t in LITE3_TAPS]
        for i, (tap, w) in enumerate(zip(taps, widths)):
            self.add_module(f"layer{i + 1}_rn", conv3(tap, w, False))
        self.refinenet4 = FusionBlock(widths[3], True, has_skip=False)
        self.refinenet3 = FusionBlock(widths[2], True)
        self.refinenet2 = FusionBlock(widths[1], True)
        self.refinenet1 = FusionBlock(widths[0], False)
        self.output_conv = Head(f)

    def head_input(self, x):
        """The tensor the head's last 1x1 conv reads (for calibration)."""
        l1, l2, l3, l4 = self.pretrained(F.relu(self.first_bn(
            self.first_conv(x.permute(0, 3, 1, 2)))))
        p = self.refinenet4(self.layer4_rn(l4))
        p = self.refinenet3(p, self.layer3_rn(l3))
        p = self.refinenet2(p, self.layer2_rn(l2))
        p = self.refinenet1(p, self.layer1_rn(l1))
        head = self.output_conv
        h = head.conv1(p)
        h = resize_nchw(h, (2 * h.shape[-2], 2 * h.shape[-1]), "bilinear")
        return F.relu(head.conv2(h))

    def forward(self, x, d):
        out = self.output_conv.conv3(self.head_input(x)).permute(0, 2, 3, 1)
        pred = d * F.relu(1.0 + out)
        if self.min_pred > 0:
            pred = pred.clamp(max=1.0 / self.min_pred)
        return pred.clamp(min=1.0 / self.max_pred)
