"""Fused stem: k x k / s2 conv + folded BN + max(y, slope * y), an
optional clip, and an optional MaxPool2d(3, 2, 1).

`stem_conv_pool` launches a CUDA kernel for CUDA tensors and runs
`stem_conv_pool_plain` for CPU tensors.  Both fold the BN scale into the
weights in f32 and round them to the input dtype (as the TPU kernel
does), accumulate in f32, add the bias, apply max(y, slope * y) (slope
0.2: RC-Net's leaky relu; 0: relu; 1: linear) and min(y, clip_max)
where one is given, round to the input dtype, then max-pool that
rounded map where `pool` asks for it.  `lead` is the conv's top/left
padding, (k - 1) // 2 by default; 0 is TF-SAME.

Two hand-written kernels serve the card, chosen by shape and form:
* (k, Cin, Cout) = (7, 3, 32) with the pool, no clip and the default
  lead, RC-Net's stem, goes to the tuned kernel of csrc/stem.cu (launch
  count "stem").  It runs the 7x7x3 contraction as a GEMM on the tensor
  cores (mma.sync m16n8k16) with K = the 147 taps (ky, kx, ci), each
  kernel row's 21 padded to 24, then to 176, in the order `k_order`
  gives.  `pack_weights` lays the folded weights out in the order its
  lanes read their B fragments; `k_offsets` gives each k's offset in the
  block's staged input tile, from which the lanes gather A.
* Every other odd k, Cin, Cout and form goes to the general kernel of
  csrc/stem_general.cu (launch count "stem_general"), the same implicit
  GEMM over any K, on the plan of `general_plan` (whose geometry
  `general_geometry` mirrors) and the weights of `pack_general`.
`stem_weights` packs either kernel's weights once, so that a module can
keep them (`models.layers.FusedStemConv`), and `stem_apply` runs them:
the one place that routes a CPU image to the plain version and a CUDA
image to a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

KERNEL_SIZE, CIN, COUT = 7, 3, 32
NEGATIVE_SLOPE = 0.2              # the leaky relu of RC-Net's stem
K_STEPS = 11                      # K = 7 kernel rows x 24 padded to 176:
                                  # eleven 16-deep mma steps
POOLED_TILE = (8, 16)             # pooled rows, columns of a block (stem.cu)
STAGED_ROW_PITCH = 216            # bf16 per staged input row (stem.cu SP)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _folded(weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """BN scale folded into (Cout, Cin, k, k) weights, in f32."""
    return weight.float() * scale.float()[:, None, None, None]


def k_order() -> np.ndarray:
    """(176, 2): the staged-window element (ky, j) that GEMM row k holds,
    j = kx * 3 + ci of kernel row ky; (-1, -1) for the 29 padding rows.
    Each kernel row's 21 taps fill three groups of 8 rows (the last with
    3 rows of padding), k = 8 G + i holding kernel row G // 3, tap
    8 (G % 3) + i; group 21 is padding.  Lane t of the kernel loads rows
    (8 G + 2 t, + 1) as one 32-bit word at offset `k_offsets()[8 G]` + 2 t
    of its pixel's window."""
    order = np.full((16 * K_STEPS, 2), -1, np.int64)
    for G in range(3 * KERNEL_SIZE):
        for i in range(8):
            j = 8 * (G % 3) + i
            if j < KERNEL_SIZE * CIN:
                order[8 * G + i] = (G // 3, j)
    return order


def pack_weights(weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The folded weights as the kernel reads B: bf16 GEMM rows k in
    `k_order` (each kernel row's 21 taps padded to 24, then 176 rows), 32
    output channels each, the padding rows zero, in fragment order (s,
    half, lane, word, element).  Lane 4 g + t's 16 bytes of half h at
    k-step s are the m16n8k16 B fragments of n-tiles 2h and 2h + 1: per
    n-tile, rows (k, k + 1) and (k + 8, k + 9) at k = 16 s + 2 t, column
    8 n + g."""
    taps = _folded(weight, scale).to(torch.bfloat16).permute(2, 3, 1, 0)
    rows = KERNEL_SIZE * CIN
    wk = torch.cat([taps.reshape(KERNEL_SIZE, rows, COUT),
                    taps.new_zeros((KERNEL_SIZE, 24 - rows, COUT))], 1)
    wk = torch.cat([wk.reshape(-1, COUT), taps.new_zeros(
        (16 * K_STEPS - 24 * KERNEL_SIZE, COUT))])
    # k = 16 s + 8 u + 2 t + e, co = 16 h + 8 nn + g  ->  (s, h, g, t, nn,
    # u, e): word 2 nn + u of lane 4 g + t's half h
    return wk.reshape(K_STEPS, 2, 4, 2, 2, 2, 8).permute(
        0, 4, 6, 2, 5, 1, 3).contiguous().reshape(-1)


def k_offsets() -> np.ndarray:
    """(176,) the K -> shared offset table: GEMM row k's element in a
    staged input tile, relative to the pixel's input window corner,
    ky * STAGED_ROW_PITCH + j (stem.cu's koffset per group of 8); -1 for
    padding."""
    ky, j = k_order().T
    return np.where(ky >= 0, ky * STAGED_ROW_PITCH + j, -1)


def _pads(H: int, W: int, k: int, lead: int) -> Tuple[int, int]:
    """The bottom and right padding that give a ceil(H/2) x ceil(W/2)
    output after `lead` rows and columns of top and left padding (the
    TPU kernel's zero tail, stem.py's padding)."""
    Ho, Wo = -(-H // 2), -(-W // 2)
    return (max(0, 2 * (Ho - 1) + k - lead - H),
            max(0, 2 * (Wo - 1) + k - lead - W))


def stem_conv_pool_plain(x: torch.Tensor, weight: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         slope: float = NEGATIVE_SLOPE, *, pool: bool = True,
                         clip_max: Optional[float] = None,
                         lead: Optional[int] = None):
    """x: (B, H, W, Cin) NHWC; weight (Cout, Cin, k, k); scale, bias
    (Cout,); the activation max(y, slope * y), then min(y, clip_max)
    where given; `lead` rows and columns of zero padding above and to the
    left ((k - 1) // 2 by default).  Returns the conv map (B, ceil(H/2),
    ceil(W/2), Cout) and, with `pool`, its MaxPool2d(3, 2, 1), NHWC in
    x's dtype (the map alone without)."""
    k = weight.shape[-1]
    lead = (k - 1) // 2 if lead is None else lead
    H, W = x.shape[1:3]
    pb, pr = _pads(H, W, k, lead)
    w = _folded(weight, scale).to(x.dtype).float()
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (lead, pr, lead, pb))
    y = F.conv2d(xp, w, stride=2)[:, :, :-(-H // 2), :-(-W // 2)]
    y = y + bias.float()[None, :, None, None]
    y = torch.maximum(y, slope * y)
    if clip_max is not None:
        y = torch.clamp(y, max=clip_max)
    y = y.to(x.dtype)
    if not pool:
        return y.permute(0, 2, 3, 1)
    pooled = F.max_pool2d(y, 3, 2, 1)
    return y.permute(0, 2, 3, 1), pooled.permute(0, 2, 3, 1)


# ---- the general kernel (csrc/stem_general.cu)

GENERAL_SMEM_LIMIT = 232448       # 227 KB of dynamic shared memory
GENERAL_TWO_BLOCKS = 233472 // 2 - 1024   # two blocks in an SM's 228 KB,
                                          # 1 KB of it reserved a block
GENERAL_MAX_THREADS = 288         # stem_general.cu MAX_THREADS
POOL_TILES = (8, 6, 4, 3, 2, 1)   # pooled rows of a block (x 16 columns)
MAP_TILES = (16, 12, 8, 4, 2, 1)  # conv rows of a block (x 32 columns)
_GENERAL_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                     + [ctypes.c_float] * 2 + [ctypes.c_void_p])


class GeneralPlan(NamedTuple):
    """A launch plan of the general kernel: `tile` pooled rows (x 16
    columns) or, without the pool, conv rows (x 32 columns) a block; K
    in chunks of `kyc` kernel rows and `cs` input channels; `nt` n-tiles
    of 8 output channels a block; its threads and shared memory."""
    tile: int
    kyc: int
    cs: int
    nt: int
    threads: int
    smem: int


class GeneralGeometry(NamedTuple):
    """stem_general.cu:layout of a plan, field for field."""
    tch: int          # conv tile rows, columns (the pool's halo in)
    tcw: int
    nm: int           # M tiles of 16 pixels
    tiw: int          # staged input columns, rows of a chunk
    tih: int
    cps: int          # staged column pitch, row pitch (bf16 elements)
    sp: int
    gr: int           # groups of 8 GEMM rows a kernel row, a chunk
    ng: int
    ksc: int          # k-steps of 16 a chunk
    nchunks: int      # K chunks, Cin slices among them
    ncs: int
    rawc: int         # 16-byte raw chunks a staged row (0: staged by 8
                      # bytes or by elements)
    warps: int
    ppw: int          # pairs of M tiles a warp
    tab: int          # byte offsets: table, weights, input, conv tile
    w: int
    inp: int
    conv: int
    total: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def general_geometry(k: int, cin: int, pool: bool, tile: int, kyc: int,
                     cs: int, nt: int) -> GeneralGeometry:
    """The kernel's geometry and shared memory for a plan
    (stem_general.cu:layout): the offset table, a chunk's packed weights,
    its staged input rows, then the conv tile in M order (16-byte channel
    groups per slot padded to a power of two), whose space also holds
    the raw rows while a chunk is staged."""
    tch = 2 * tile + 1 if pool else tile
    tcw = 33 if pool else 32
    nm = 2 * tch + (-(-tch // 16) if pool else 0)
    # 64 + k columns: what a 33-column tile reads (32 columns read two
    # fewer); the rows hold a last tap group's 8 gr - k cps extra taps
    tiw, tih = 64 + k, 2 * (tch - 1) + kyc
    cps = cs + 4 if cs % 8 == 0 else cs
    gr = -(-k * cps // 8)
    ng = kyc * gr
    ksc = -(-ng // 2)
    sp = (tiw * cps + 8 * gr - k * cps + 7) // 8 * 8
    ncs = -(-cin // cs)
    nchunks = -(-k // kyc) * ncs
    rawc = (sp + 14) // 8 if cs == cin == cps else 0
    ppw = 2 if nchunks == 1 else 1
    pairs = -(-nm // 2)
    warps = -(-pairs // ppw)
    nq, ntp = (nt + 1) // 2, 1 << (nt - 1).bit_length()
    tab = 0
    w = tab + _align16(2 * ksc * 4)
    inp = w + ksc * nq * 32 * 16
    conv = inp + _align16(tih * sp * 2)
    total = conv + max(nm * 16 * ntp * 16, tih * rawc * 16)
    return GeneralGeometry(tch, tcw, nm, tiw, tih, cps, sp, gr, ng, ksc,
                           nchunks, ncs, rawc, warps, ppw, tab, w, inp, conv,
                           total)


# The plan's cost model, fitted to every plan's time at the shapes of
# `chip_smoke.py --stem-plans` on the H100: staging an element of input
# by 16- or 8-byte copies costs 1, element by element 4; a K chunk costs
# as much as 2000 staged elements (its barriers and weights); plans of
# 8 warps or more a block come first.
ELEMENT_STAGING_COST = 4
CHUNK_COST = 2000
FULL_BLOCK_WARPS = 8


def _chunkings(k: int, cin: int):
    """(kyc, cs): all k kernel rows a chunk, or one, over all of Cin or
    slices of 64, 32, 16, 8 or 4 channels."""
    for cs in (cin,) + tuple(c for c in (64, 32, 16, 8, 4) if c < cin):
        yield k, cs
        if k > 1:
            yield 1, cs


def plan_cost(geo: GeneralGeometry, cin: int, cs: int, pool: bool,
              tile: int) -> float:
    """The cost model's cost of a plan an output pixel of its tile: each
    chunk's staged input (`tih` rows of `sp`), by its copy width, and
    its fixed cost."""
    vector = geo.rawc > 0 or (cin % 4 == 0 and cs % 4 == 0)
    per = 1 if vector else ELEMENT_STAGING_COST
    return (geo.nchunks * (geo.tih * geo.sp * per + CHUNK_COST)
            / (tile * (16 if pool else 32)))


def general_plan(cin: int, cout: int, k: int, pool: bool = True
                 ) -> GeneralPlan:
    """The general kernel's plan: of the tiles and K chunkings that take
    at most 288 threads a block (a chunked K takes a warp per pair of M
    tiles), those whose shared memory lets two blocks share an SM (else
    that fit 227 KB), and among them those of `FULL_BLOCK_WARPS` warps
    or more where there are any, the least `plan_cost` (which, among
    plans with all of K in one chunk, is the largest tile).  Raises for
    a shape that no plan fits.  Cout up to 64 channels is one block's N (nt =
    ceil(Cout / 8)), wider Cout takes blocks of 64."""
    if k % 2 != 1 or min(cin, cout, k) < 1:
        raise ValueError(f"stem kernel: an odd k and Cin, Cout >= 1, got "
                         f"k={k}, Cin={cin}, Cout={cout}")
    nt = min(8, -(-cout // 8))
    plans = []
    for tile in POOL_TILES if pool else MAP_TILES:
        for kyc, cs in _chunkings(k, cin):
            geo = general_geometry(k, cin, pool, tile, kyc, cs, nt)
            if 32 * geo.warps <= GENERAL_MAX_THREADS:
                plans.append((plan_cost(geo, cin, cs, pool, tile), geo,
                              GeneralPlan(tile, kyc, cs, nt, 32 * geo.warps,
                                          geo.total)))
    for limit in (GENERAL_TWO_BLOCKS, GENERAL_SMEM_LIMIT):
        for warps in (FULL_BLOCK_WARPS, 1):
            fit = [p for p in plans
                   if p[1].total <= limit and p[1].warps >= warps]
            if fit:
                return min(fit, key=lambda p: p[0])[2]
    raise ValueError(
        f"stem kernel: a {k}x{k} stem over Cin={cin} needs more than "
        f"{GENERAL_SMEM_LIMIT} bytes of shared memory at its smallest "
        f"plan (one kernel row and 4 input channels a chunk)")


def general_k_map(k: int, cin: int, kyc: int, cs: int) -> np.ndarray:
    """(nchunks, 16 ksc, 3): the (ky, kx, ci) that GEMM row kk of each K
    chunk holds, (-1, -1, -1) for padding.  Chunk c is kernel rows
    kyc (c // ncs) .. + kyc - 1 and input channels cs (c % ncs) .. +
    cs - 1; row kk = 8 G + e is tap j = 8 (G % gr) + e of kernel row
    G // gr of the chunk, i.e. kx = j // cps, channel j % cps of the
    slice (the kernel's offset table: staged offset (G // gr) sp + j)."""
    geo = general_geometry(k, cin, True, 1, kyc, cs, 1)
    out = np.full((geo.nchunks, 16 * geo.ksc, 3), -1, np.int64)
    kk = np.arange(16 * geo.ksc)
    G, e = np.divmod(kk, 8)
    kyl, gi = np.divmod(G, geo.gr)
    kx, cl = np.divmod(8 * gi + e, geo.cps)
    for c in range(geo.nchunks):
        ky = kyc * (c // geo.ncs) + kyl
        ci = cs * (c % geo.ncs) + cl
        ok = (G < geo.ng) & (ky < k) & (kx < k) & (cl < cs) & (ci < cin)
        out[c, ok] = np.stack([ky, kx, ci], -1)[ok]
    return out


@functools.lru_cache(maxsize=64)
def _k_index(k: int, cin: int, kyc: int, cs: int, device: torch.device
             ) -> torch.Tensor:
    """`general_k_map` on the weights' device, made once (so that packing
    copies nothing from the host, inside a CUDA graph too)."""
    return torch.from_numpy(general_k_map(k, cin, kyc, cs)).to(device)


def pack_general(weight: torch.Tensor, scale: torch.Tensor,
                 plan: GeneralPlan) -> torch.Tensor:
    """The folded bf16 weights as the general kernel reads B: for each
    block of 8 nt output channels and each K chunk, the chunk's GEMM rows
    (`general_k_map`, padding rows zero) in fragment order (s, q, lane,
    word, element), q over pairs of n-tiles (an odd nt's last pair has a
    zero n-tile).  Lane 4 g + t's 16 bytes of pair q at k-step s are the
    m16n8k16 B fragments of n-tiles 2q and 2q + 1: rows (k, k + 1) and
    (k + 8, k + 9) at k = 16 s + 2 t, column 8 n + g."""
    cout, cin, k, _ = weight.shape
    kmap = _k_index(k, cin, plan.kyc, plan.cs, weight.device)
    nc, krows, _ = kmap.shape
    nt, nq = plan.nt, (plan.nt + 1) // 2
    nco = -(-cout // (8 * nt))
    taps = _folded(weight, scale).to(torch.bfloat16).permute(2, 3, 1, 0)
    ok = kmap[..., 0] >= 0
    wk = torch.where(ok[..., None], taps[kmap[..., 0].clamp(min=0),
                                         kmap[..., 1].clamp(min=0),
                                         kmap[..., 2].clamp(min=0)], 0)
    wk = F.pad(wk, (0, nco * 8 * nt - cout)).reshape(nc, krows, nco, 8 * nt)
    wk = F.pad(wk, (0, 16 * nq - 8 * nt)).permute(2, 0, 1, 3)
    # kk = 16 s + 8 r + 2 t + e, co = 16 q + 8 nn + g -> (s, q, g, t, nn,
    # r, e): word 2 nn + r of lane 4 g + t's pair q
    return wk.reshape(nco, nc, krows // 16, 2, 4, 2, nq, 2, 8).permute(
        0, 1, 2, 6, 8, 4, 7, 3, 5).contiguous().reshape(-1)


class StemWeights(NamedTuple):
    """A stem's weights for the kernel that serves its shape and form:
    `kind` "stem" (csrc/stem.cu) or "stem_general"; `source`, the
    (weight, scale, bias) as given, which the plain version reads; on the
    card the packed bf16 weights, the f32 bias (padded to the general
    kernel's blocks) and the general kernel's plan (all three None on the
    CPU, where nothing is packed); the shape and the form."""
    kind: str
    source: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    weight: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    cin: int
    cout: int
    k: int
    pool: bool
    clip_max: Optional[float]
    lead: int
    plan: Optional[GeneralPlan]


def stem_weights(weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, *, pool: bool = True,
                 clip_max: Optional[float] = None, lead: Optional[int] = None
                 ) -> StemWeights:
    """A stem's weights for `stem_apply`, packed once where they lie on
    the card for the kernel that serves their shape and form: (7, 3, 32)
    with the pool, no clip and the default lead on the tuned kernel,
    everything else on the general one."""
    cout, cin, k, kw = weight.shape
    if kw != k or k % 2 != 1:
        raise ValueError(f"stem weight: a square kernel of odd size, got "
                         f"{tuple(weight.shape)}")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"stem scale/bias: expected ({cout},)")
    default = (k - 1) // 2
    lead = default if lead is None else int(lead)
    if not 0 <= lead < k:
        raise ValueError(f"stem lead: 0 <= lead < k, got {lead}")
    clip = None if clip_max is None else float(clip_max)
    tuned = ((k, cin, cout) == (KERNEL_SIZE, CIN, COUT) and pool
             and clip is None and lead == default)
    if on_cpu(weight, scale, bias):
        return StemWeights("stem" if tuned else "stem_general",
                           (weight, scale, bias), None, None, cin, cout, k,
                           bool(pool), clip, lead, None)
    if tuned:
        return StemWeights("stem", (weight, scale, bias),
                           pack_weights(weight, scale),
                           bias.float().contiguous(), cin, cout, k, True,
                           None, lead, None)
    return _general_weights(weight, scale, bias, pool, clip, lead)


def _general_weights(weight: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, pool: bool = True,
                     clip_max: Optional[float] = None,
                     lead: Optional[int] = None,
                     plan: Optional[GeneralPlan] = None) -> StemWeights:
    """The general kernel's packed weights for any shape and form on the
    card, the tuned kernel's (7, 3, 32) included, on `general_plan`'s
    plan or the one given."""
    cout, cin, k, _ = weight.shape
    lead = (k - 1) // 2 if lead is None else lead
    plan = general_plan(cin, cout, k, pool) if plan is None else plan
    nco = -(-cout // (8 * plan.nt))
    bk = F.pad(bias.float(), (0, nco * 8 * plan.nt - cout)).contiguous()
    return StemWeights("stem_general", (weight, scale, bias),
                       pack_general(weight, scale, plan), bk, cin, cout, k,
                       bool(pool), clip_max, lead, plan)


def stem_conv_pool(x: torch.Tensor, weight: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor,
                   slope: float = NEGATIVE_SLOPE, *, pool: bool = True,
                   clip_max: Optional[float] = None,
                   lead: Optional[int] = None):
    """The fused stem; see `stem_conv_pool_plain` for the contract and
    `stem_apply` for the devices: the weights packed for this one call."""
    return stem_apply(x, stem_weights(weight, scale, bias, pool=pool,
                                      clip_max=clip_max, lead=lead), slope)


def stem_apply(x: torch.Tensor, sw: StemWeights,
               slope: float = NEGATIVE_SLOPE):
    """The stem of `stem_weights`' output on an NHWC image: the conv map
    and, with the form's pool, the pooled map.  A CPU image (with CPU
    weights) runs `stem_conv_pool_plain`.  A CUDA image must be a
    contiguous, 16-byte aligned bf16 NHWC image beside the packed
    weights, and runs the kernel of `sw.kind`; its outputs are
    contiguous NHWC."""
    if on_cpu(x, *sw.source):
        return stem_conv_pool_plain(x, *sw.source, slope, pool=sw.pool,
                                    clip_max=sw.clip_max, lead=sw.lead)
    if sw.weight is None or sw.weight.device != x.device:
        raise ValueError("stem kernel: the image and the packed weights on "
                         "one CUDA device")
    require(x, "image", torch.bfloat16, (None, None, None, sw.cin))
    if x.data_ptr() % 16:
        raise ValueError("image: the stem kernels read 16-byte aligned rows")
    if sw.kind == "stem":
        return _launch(x, sw.weight, sw.bias, slope)
    return _launch_general(x, sw, slope)


def _launch_general(x: torch.Tensor, sw: StemWeights, slope: float):
    """The general kernel on a checked CUDA image."""
    plan = sw.plan
    B, H, W, _ = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    out = torch.empty((B, Ho, Wo, sw.cout), dtype=torch.bfloat16,
                      device=x.device)
    pooled = (torch.empty((B, Hp, Wp, sw.cout), dtype=torch.bfloat16,
                          device=x.device) if sw.pool else None)
    if out.numel():
        clip = math.inf if sw.clip_max is None else sw.clip_max
        fn = kernel_function("stem_general", "riders_stem_general",
                             _GENERAL_ARGTYPES)
        check(fn(x.data_ptr(), sw.weight.data_ptr(), sw.bias.data_ptr(),
                 out.data_ptr(), 0 if pooled is None else pooled.data_ptr(),
                 B, H, W, sw.cin, sw.cout, sw.k, sw.lead, int(sw.pool),
                 plan.tile, plan.kyc, plan.cs, plan.nt, plan.threads,
                 plan.smem, float(slope), float(clip), stream_handle(x)),
              "stem_general")
        LAUNCHES["stem_general"] += 1
    return (out, pooled) if sw.pool else out


def _launch(x: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
            slope: float = NEGATIVE_SLOPE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tuned kernel on a checked CUDA image, `pack_weights`' output
    and the f32 bias."""
    B, H, W, _ = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    out = torch.empty((B, Ho, Wo, COUT), dtype=torch.bfloat16,
                      device=x.device)
    pooled = torch.empty((B, Hp, Wp, COUT), dtype=torch.bfloat16,
                         device=x.device)
    if pooled.numel() == 0:
        return out, pooled
    fn = kernel_function("stem", "riders_stem_conv_pool", _ARGTYPES)
    check(fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
             pooled.data_ptr(), B, H, W, float(slope), stream_handle(x)),
          "stem")
    LAUNCHES["stem"] += 1
    return out, pooled
