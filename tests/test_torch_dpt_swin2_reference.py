"""The port's Swin V2 DPT SML (`models/swin2.py`, `models/dpt.py`) against
the benchmark's plain float32 reference of `dpt-swin2-large`
(`benchmark/reference/sml/dpt-swin2-large.py`), on the CPU at tiny
widths; known faults of the reference that the comparison catches; the
reference's state at the published widths against the factory's; the
`dpt.attn` spans and the `COUNTS` counter; the reference's precision
emulation."""

import copy
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.loader import load_file_module
from benchmark.reference import chain
from riders_tpu_torch.models import dpt, swin2
from riders_tpu_torch.models.factory import build_sml_model
from riders_tpu_torch.ops.kernels import swin2_attention

ROOT = Path(__file__).resolve().parents[1]
REF = load_file_module(ROOT / "benchmark" / "reference" / "sml"
                       / "dpt-swin2-large.py", "bench_sml_dpt_swin2_large")
CONFIG = ROOT / "benchmark" / "configs" / "ntu_dpt_swin2l384.json"

# net 64x64, patch 4: stage grids 16, 8, 4, 2 under window 4, so stages
# 0 and 1 shift their odd blocks, stage 2's window covers its grid and
# runs unshifted, and stage 3 clamps its window to 2; three patch
# mergings and all four fusion levels
NET = (64, 64)
TINY = dict(embed=16, depths=(2, 2, 2, 2), heads=(2, 2, 4, 4), window=4,
            pretrained_windows=(3, 3, 3, 2), patch=4, mlp_ratio=4.0,
            features=16)
BLOCKS = sum(TINY["depths"])


def _models(top_scale=2.3):
    port = dpt.DPTScaleMapLearner(dpt.DPTConfig(
        net_shape=NET, backbone="swin2", features=TINY["features"],
        swin2=swin2.Swin2Config(
            patch_size=TINY["patch"], embed_dim=TINY["embed"],
            depths=TINY["depths"], num_heads=TINY["heads"],
            window_size=TINY["window"],
            pretrained_window_sizes=TINY["pretrained_windows"])), "cpu")
    ref = REF.DPTSwin2(in_channels=3, net_shape=NET, head_features=32,
                       min_pred=0.1, max_pred=255.0, **TINY).eval()
    # LeCun-normal kernels, biases 0.1 N, LayerNorm scales 1 + 0.1 N,
    # and each block's logit scales spread from 1 to `top_scale` (timm
    # starts them at log(10) = 2.30)
    g = torch.Generator().manual_seed(1)
    state = {}
    for key, t in ref.state_dict().items():
        z = torch.randn(t.shape, generator=g)
        if key.endswith("logit_scale"):
            state[key] = torch.linspace(1.0, top_scale,
                                        t.shape[0]).reshape(t.shape)
        elif "norm" in key and key.endswith(".weight"):
            state[key] = 1.0 + 0.1 * z
        elif t.dim() > 1:
            state[key] = z / t[0].numel() ** 0.5
        else:
            state[key] = 0.1 * z
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def _inputs(n=2):
    g = torch.Generator().manual_seed(2)
    return (torch.randn(n, *NET, 3, generator=g),
            0.5 + torch.rand(n, *NET, 1, generator=g))


def _outputs(port, ref):
    """(port's pred, its head input), (the reference's)."""
    x, d = _inputs()
    seen = []
    hook = port.head_conv3.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        pred, _ = port(x, d)
        want = (ref(x, d), ref.head_input(x))
    hook.remove()
    return (pred, seen[0]), want


def _assert_close(got, want):
    """rtol 1e-4, atol 1e-4 of the largest value (relu leaves values at
    and near zero)."""
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_port_matches_the_reference():
    """pred and the head's last conv's input, f32 on both sides from one
    state dict loaded strictly into each.  The two differ only in the
    order of float operations (the patch embedding as a conv against the
    port's matmul, the coordinate table in float64 against the port's
    numpy, the normalisation, the resizes): a few ulps that the eight
    blocks and the fusion carry to ~1e-6 of the largest value, so rtol
    1e-4 leaves ~100x room, while each fault of
    `test_a_known_fault_fails_the_comparison` moves pred by percents."""
    port, ref = _models()
    got, want = _outputs(port, ref)
    for g, w in zip(got, want):
        _assert_close(g, w)


@pytest.mark.parametrize("H,W,w,s", [(16, 16, 4, 2), (8, 12, 4, 2),
                                     (48, 48, 24, 12)])
def test_the_helpers_equal_the_ports(H, W, w, s):
    """The reference's own shift mask, coordinate table and pair index,
    built from their definitions, equal the port's numpy helpers."""
    assert torch.equal(REF.shift_mask(H, W, w, s), torch.from_numpy(
        swin2_attention.shift_mask(H, W, w, s)))
    for pretrained in (0, w // 2):
        assert torch.equal(REF.log_coords(w, pretrained), torch.from_numpy(
            swin2._log_coords_table(w, pretrained)).reshape(-1, 2))
    assert torch.equal(REF.pair_rows(w), torch.from_numpy(
        swin2_attention.rel_pos_index(w, w)).long())


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("top_scale", [2.3, 5.5],
                         ids=["below_clamp", "across_clamp"])
def test_window_attention_matches_the_reference(top_scale, masked):
    """One block's window attention of a shifted stage-0 block, its
    logit scales below the clamp at log(100) = 4.61 or across it, with
    and without the shift mask, at rtol 1e-4.  Across the clamp a head's
    logits reach +-100 and its softmax is near one-hot: through the
    eight blocks of the whole network that amplifies the ulps of the
    two float orders to ~1e-4, so the whole network is compared below
    the clamp (~1e-6) and the clamp here, one attention deep."""
    port, ref = _models(top_scale)
    block, want_block = port.pretrained.stage0_block1, \
        ref.pretrained.stage0_block1
    g = torch.Generator().manual_seed(3)
    # the 16 windows of one 16x16 grid: the port's attention takes the
    # shift and the grid, the reference's the mask made from them
    x = torch.randn(16, TINY["window"] ** 2, TINY["embed"], generator=g)
    shift = 2 if masked else 0
    mask = REF.shift_mask(16, 16, 4, shift) if masked else None
    with torch.no_grad():
        got = block.attn(x, shift, (16, 16))
        want = want_block.attn(x, mask)
    _assert_close(got, want)


def _no_mask(monkeypatch):
    monkeypatch.setattr(REF, "shift_mask", lambda H, W, w, s: torch.zeros(
        (H // w) * (W // w), w * w, w * w))


def _in_the_reference(monkeypatch, name, module, **changed):
    """The reference's global `name` (a module) replaced by a copy of
    `module` with `changed`, so that the port keeps the original."""
    copied = types.SimpleNamespace(**{
        k: getattr(module, k) for k in dir(module) if not k.startswith("__")})
    for k, v in changed.items():
        setattr(copied, k, v)
    monkeypatch.setattr(REF, name, copied)


def _no_cosine(monkeypatch):
    _in_the_reference(monkeypatch, "F", F, normalize=lambda t, dim: t)


def _merge_order(monkeypatch):
    def forward(self, x):
        (H, W), (B, _, C) = self.grid, x.shape
        h = x.reshape(B, H // 2, 2, W // 2, 2, C)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(B, H * W // 4, 4 * C)
        return self.norm(self.reduction(h))
    monkeypatch.setattr(REF.PatchMerging, "forward", forward)


def _no_shift(monkeypatch):
    _in_the_reference(monkeypatch, "torch", torch,
                      roll=lambda t, shifts, dims: t)


@pytest.mark.parametrize("fault", [_no_mask, _no_cosine, _merge_order,
                                   _no_shift],
                         ids=["mask_dropped", "cosine_left_out",
                              "merge_order_swapped", "shift_dropped"])
def test_a_known_fault_fails_the_comparison(fault, monkeypatch):
    """The comparison's tolerance catches a reference with the shift
    mask dropped, q and k left unnormalised, patch merging's (1, 0) and
    (0, 1) neighbours swapped, or the cyclic shift dropped."""
    port, ref = _models()
    fault(monkeypatch)
    (pred, _), (want, _) = _outputs(port, ref)
    with pytest.raises(AssertionError):
        _assert_close(pred, want)
    assert float((pred - want).abs().max() / want.abs().max()) > 1e-3


def test_reference_state_matches_the_factory_at_published_widths():
    """The configuration's SML as the port's factory builds it and as the
    reference builds it, on the meta device: the same keys and shapes,
    ~213 M parameters."""
    config = harness.load_json(CONFIG)
    assert config["sml"]["model_type"] == "dpt-swin2-large"
    with torch.device("meta"):
        port = build_sml_model(harness.port_config(config), device="meta")
    _, ref = chain.build_models(config, "cpu", meta=True)
    assert type(ref).__name__ == "SML" and chain.sml_head(ref) == \
        "head_conv3"
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    assert got == want
    assert 2.0e8 < sum(t.numel() for t in ref.state_dict().values()) < 2.3e8


def test_attention_spans_and_counts():
    """Under a profiler each block's window attention is one
    `dpt.attn` user range (the DPT SML's attention span, as BEiT's), the forward's first and last ops lie
    outside every one of them, and `COUNTS` counts one position-bias
    table and one plain attention (the CPU's path) a block."""
    port, _ = _models()
    x, d = _inputs(1)
    swin2.COUNTS.clear()
    dpt.COUNTS.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        port(x, d)
    assert swin2.COUNTS == {"cpb_tables": BLOCKS, "attn_plain": BLOCKS}
    assert dpt.COUNTS["forwards"] == 1
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.name() == "dpt.attn"]
    assert len(ranges) == BLOCKS
    assert all(e.is_user_annotation() for e in events
               if e.name() == "dpt.attn")
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if e.name().startswith("aten::"))
    first, last = ops[0], max(ops, key=lambda o: o[1])
    assert first[0] < min(s for s, _ in ranges)
    assert last[1] > max(e for _, e in ranges)
    for s, e in ranges:
        assert not s <= first[0] < e and not s < last[1] <= e


@pytest.mark.parametrize("rounding", ["identity", "bf16"])
def test_emulate_rounds_the_attention(rounding):
    """`chain.emulate_` with an identity rounding leaves the reference's
    output bitwise as it was; with bf16 it moves it, within bf16's
    reach, and rounds the attention's raw weights, but leaves the logit
    scale, the position-bias MLP and the bias it computes float32, as
    the port's bf16 model keeps them."""
    _, ref = _models()
    x, d = _inputs()
    emulated = chain.emulate_(copy.deepcopy(ref), {
        "identity": lambda t: t, "bf16": chain.round_bf16}[rounding])
    with torch.no_grad():
        want, got = ref(x, d), emulated(x, d)
    if rounding == "identity":
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max() / want.abs().max())
        assert 1e-5 < err < 5e-2
        attn = "pretrained.stage1_block1.attn"
        for name in ("qkv_kernel", "q_bias", "v_bias"):
            name = f"{attn}.{name}"
            assert torch.equal(emulated.get_parameter(name), chain.round_bf16(
                ref.get_parameter(name))), name
        for name in ("logit_scale", "cpb_fc1.weight", "cpb_fc1.bias",
                     "cpb_fc2.weight"):
            name = f"{attn}.{name}"
            want = ref.get_parameter(name)
            assert not torch.equal(want, chain.round_bf16(want)), name
            assert torch.equal(emulated.get_parameter(name), want), name
        with torch.no_grad():
            assert torch.equal(emulated.get_submodule(attn).position_bias(),
                               ref.get_submodule(attn).position_bias())
