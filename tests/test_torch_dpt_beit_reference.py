"""The port's BEiT DPT SML (`models/dpt.py`) against the benchmark's plain
float32 reference of `dpt-beit-large` (`benchmark/reference/sml/
dpt-beit-large.py`), on the CPU at tiny widths; the reference's state
at the published widths against the factory's; the `dpt.attn` spans
and the `COUNTS` counter; the reference's precision emulation."""

import copy
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.loader import load_file_module
from benchmark.reference import chain
from riders_tpu_torch.models import dpt
from riders_tpu_torch.models.factory import build_sml_model

ROOT = Path(__file__).resolve().parents[1]
REF = load_file_module(ROOT / "benchmark" / "reference" / "sml"
                       / "dpt-beit-large.py", "bench_sml_dpt_beit_large")
CONFIG = ROOT / "benchmark" / "configs" / "ntu_dpt_beitl512.json"

# embed 64, 4 blocks of 4 heads, pretrained grid 4: every hook, every
# reassembly resize and all four fusion levels at a tiny size
TINY = dict(dim=64, depth=4, heads=4, grid=4, hooks=(0, 1, 2, 3),
            channels=(8, 16, 32, 32), features=16)


def _models(net):
    port = dpt.DPTScaleMapLearner(dpt.DPTConfig(
        net_shape=net, backbone="beit", embed_dim=TINY["dim"],
        depth=TINY["depth"], num_heads=TINY["heads"], hooks=TINY["hooks"],
        reassemble_channels=TINY["channels"], features=TINY["features"],
        pretrained_grid=TINY["grid"]), "cpu")
    ref = REF.DPTBEiT(in_channels=3, mlp_dim=4 * TINY["dim"], patch=16,
                      head_features=32, min_pred=0.1, max_pred=255.0,
                      **TINY).eval()
    # LeCun-normal kernels (the table's rows too: std 1 / sqrt(heads),
    # so that the bias moves the softmax), biases 0.1 N, gammas and
    # LayerNorm scales 1 + 0.1 N so that the layer scale is exercised
    g = torch.Generator().manual_seed(1)
    state = {}
    for key, t in ref.state_dict().items():
        z = torch.randn(t.shape, generator=g)
        if key.endswith(("gamma_1", "gamma_2")) or (
                ".norm" in key and key.endswith(".weight")):
            state[key] = 1.0 + 0.1 * z
        elif t.dim() > 1:
            state[key] = z / t[0].numel() ** 0.5
        else:
            state[key] = 0.1 * z
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def _inputs(net, n=2):
    g = torch.Generator().manual_seed(2)
    return (torch.randn(n, *net, 3, generator=g),
            0.5 + torch.rand(n, *net, 1, generator=g))


@pytest.mark.parametrize("net", [(64, 64), (48, 80)],
                         ids=["square_pretrained_grid", "resized_bias"])
def test_port_matches_the_reference(net):
    """pred and the head's last conv's input, f32 on both sides from one
    state dict loaded strictly into each.  At 64x64 the window is the
    pretrained 4x4 grid; at 48x80 it is 3x5 and the bias is resized.
    The two differ only in the order of float operations (q scaled
    before q k^T in the reference, after in the port; the patch
    embedding as a conv against the port's matmul; the resizes), a few
    ulps that the four blocks and the fusion carry to ~1e-6 of the
    largest value: rtol 1e-4 leaves ~100x room, while the cls rows of
    the table in timm's order move both by 10-30% and a resize with
    align_corners True by 1-2%.  atol is 1e-4 of the largest value,
    since relu leaves values at and near zero."""
    port, ref = _models(net)
    x, d = _inputs(net)
    seen = []
    port.head_conv3.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        pred, _ = port(x, d)
        want_pred, want_head = ref(x, d), ref.head_input(x)
    for got, want in ((pred, want_pred), (seen[0], want_head)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_reference_state_matches_the_factory_at_published_widths():
    """The configuration's SML as the port's factory builds it and as the
    reference builds it, on the meta device: the same keys and shapes."""
    config = harness.load_json(CONFIG)
    with torch.device("meta"):
        port = build_sml_model(harness.port_config(config), device="meta")
    _, ref = chain.build_models(config, "cpu", meta=True)
    assert type(ref).__name__ == "SML" and chain.sml_head(ref) == \
        "head_conv3"
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    assert got == want
    assert sum(t.numel() for t in ref.state_dict().values()) > 3.4e8


def test_attention_spans_and_counts():
    """Under a profiler each block's attention is one `dpt.attn` user
    range, the forward's first and last ops lie outside every one of
    them, and `COUNTS` counts one forward, and a bias table and a plain
    attention a block."""
    port, _ = _models((48, 80))
    x, d = _inputs((48, 80), 1)
    dpt.COUNTS.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        port(x, d)
    assert dpt.COUNTS == {"forwards": 1, "bias_tables": TINY["depth"],
                          "attn_plain": TINY["depth"]}
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.name() == "dpt.attn"]
    assert len(ranges) == TINY["depth"]
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
    reach."""
    _, ref = _models((48, 80))
    x, d = _inputs((48, 80))
    emulated = chain.emulate_(copy.deepcopy(ref), {
        "identity": lambda t: t, "bf16": chain.round_bf16}[rounding])
    with torch.no_grad():
        want, got = ref(x, d), emulated(x, d)
    if rounding == "identity":
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max() / want.abs().max())
        assert 1e-5 < err < 5e-2
        for name in ("pretrained.block0.attn.qkv_kernel",
                     "pretrained.block0.attn.rel_pos_bias_table",
                     "reassemble1.resize.weight"):
            assert torch.equal(emulated.get_parameter(name), chain.round_bf16(
                ref.get_parameter(name))), name
