"""The port's measuring entry points (riders_tpu_torch.bench and
riders_tpu_torch.tools) against the JAX package's bench.py and tools/,
on the CPU.

* `bench.build`: the batch, byte for byte, and the configuration that
  JAX's `bench.build` makes, both presets, with BATCH at 1 and 2 (JAX's
  flax inits are stubbed out: the weights differ by design, seeded
  random weights here, flax's init there, and the batch does not depend
  on them).
* bench.py's chain of two fused calls with its carry (image[0, 0, 0, 0]
  += 1e-12 * depth.sum()) at tests/test_torch_fused.py's narrow widths,
  the JAX variables carried across by models/from_jax.py, against JAX's
  fused function applied twice with the same carry, at that file's
  rtol / atol 1e-3.
* The eager chain makes exactly n calls a run and `device_time_per_call`
  makes bench.py's count of calls and returns a positive time; a CUDA
  graph asked for on the CPU raises.
* The tools' host-side inputs against the JAX tools': bench_train's
  RC-Net and SML batches and bench_serving's on-disk frames, byte for
  byte; profile_bench's category rollup and busy time on synthetic
  events.
* Without a card every measuring entry point raises.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import riders_tpu.pipelines.fused as jfused
import riders_tpu.pipelines.sml_training as jsml_training
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu_torch import bench as tbench
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.models.from_jax import rcnet_from_jax, sml_from_jax
from riders_tpu_torch.pipelines.fused import make_fused_fn
from riders_tpu_torch.tools import bench_serving as tserving
from riders_tpu_torch.tools import bench_train as ttrain
from riders_tpu_torch.tools import profile_bench as tprofile
from test_torch_fused import BACKBONE, _batch, _configs
from torch_common import perturbed

REPO = Path(__file__).resolve().parents[1]


def _load(relpath, name):
    """A module of the JAX package's scripts (bench.py, tools/) by path."""
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbench = _load("bench.py", "jax_bench_script")
jtrain = _load("tools/bench_train.py", "jax_bench_train_script")
jserving = _load("tools/bench_serving.py", "jax_bench_serving_script")


def _fields(a, b, path=""):
    """(path, a's value, b's value) of every leaf field both dataclasses
    have."""
    import dataclasses
    names = {f.name for f in dataclasses.fields(b)}
    for f in dataclasses.fields(a):
        if f.name not in names:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            yield from _fields(x, y, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", x, y


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("preset", ["ntu", "zju"])
def test_build_matches_jax_bench(monkeypatch, preset, batch):
    """The batch byte for byte and every common config field; both
    packages' models are bf16."""
    monkeypatch.setattr(jbench, "BATCH", batch)
    monkeypatch.setattr(tbench, "BATCH", batch)
    # no flax init (JAX's weights are not compared), and the config
    # captured where JAX's bench hands it to make_fused_fn
    monkeypatch.setattr(jax, "jit", lambda f: (lambda *a, **k: None))
    monkeypatch.setattr(jfused, "make_fused_fn",
                        lambda cfg, rcnet, sml: (cfg, rcnet.dtype,
                                                 sml.dtype))
    (jcfg, rc_dtype, sml_dtype), _, _, jbatch = jbench.build(preset)
    assert rc_dtype == sml_dtype == jnp.bfloat16

    fused, tbatch, tcfg = tbench.build(preset, device="cpu")
    assert sorted(tbatch) == sorted(jbatch)
    for k, v in jbatch.items():
        want = np.asarray(v)
        got = tbatch[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    assert tbatch["image"].shape[0] == batch
    fields = list(_fields(tcfg, jcfg))
    assert len(fields) > 70
    for path, x, y in fields:
        assert x == y, path
    assert tcfg.dataset.image_shape == (512, 640)
    assert tcfg.dataset.max_points == tbench.POINTS[preset][1]
    assert int(tbatch["point_mask"].sum()) == batch * tbench.POINTS[
        preset][0]
    assert callable(fused)


@pytest.mark.parametrize("case", ["ntu", "zju"])
def test_chain_matches_jax_fused_twice(rng, case):
    jcfg, tcfg = _configs(case)
    H, W = jcfg.dataset.image_shape
    ph, pw = jcfg.rcnet.patch_size
    rcnet = JaxRCNet(config=jcfg.rcnet)
    sml = JaxSML(config=jcfg.sml, **BACKBONE)
    rc_vars = perturbed(jax.jit(rcnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32 + ph, 32 + pw, 3)),
        jnp.asarray([[[pw / 2, ph / 2, 10.0]]], jnp.float32),
        jnp.asarray([[[0.0, 0.0, float(pw), float(ph)]]], jnp.float32),
        jnp.ones((1, 1))), rng)
    h, w = jcfg.sml.net_shape
    sml_vars = perturbed(jax.jit(sml.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3)),
        jnp.ones((1, h, w, 1))), rng)
    ref_fn = jfused.make_fused_fn(jcfg, rcnet, sml)
    batch = _batch(rng, (H, W))

    # bench.py's loop body, twice
    img = jnp.asarray(batch["image"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(2):
        depth = ref_fn(rc_vars, sml_vars, {**jbatch, "image": img})
        upd = (img[0, 0, 0, 0] + 1e-12 * depth.sum()).reshape(1, 1, 1, 1)
        img = jax.lax.dynamic_update_slice(img, upd, (0, 0, 0, 0))
        want.append(np.asarray(depth))

    fn = make_fused_fn(
        tcfg, rcnet_from_jax(tcfg.rcnet, rc_vars, device="cpu"),
        sml_from_jax(tcfg.sml, sml_vars, device="cpu", **BACKBONE),
        device="cpu")
    chain = tbench.Chain(fn, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    got = [chain().clone().numpy() for _ in range(2)]
    for a, b in zip(got, want):
        assert a.shape == (2, H, W) and np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    # the carry moved the first pixel alone, on both sides alike, and
    # in the chain's own copy of the batch
    final = chain.batch["image"].numpy()
    assert final[0, 0, 0, 0] != batch["image"][0, 0, 0, 0]
    np.testing.assert_allclose(final, np.asarray(img), rtol=1e-6)
    assert np.array_equal(final.reshape(-1)[1:],
                          batch["image"].reshape(-1)[1:])


def test_eager_chain_counts_calls_and_times_on_the_cpu():
    calls = []

    def fused(batch):
        calls.append(float(batch["image"][0, 0, 0, 0]))
        return batch["image"].sum(-1) * 1e6     # a carry of ~1e-4

    batch = {"image": torch.rand((2, 6, 8, 3),
                                 generator=torch.Generator().manual_seed(0))}
    chain = tbench.Chain(fused, batch)
    x0 = float(chain.batch["image"][0, 0, 0, 0])
    value = chain.run(3)
    assert len(calls) == 3
    # each call saw the last one's carry
    assert calls[0] == x0 and calls[1] > calls[0] and calls[2] > calls[1]
    assert value == float(chain.batch["image"][0, 0, 0, 0]) > calls[2]
    calls.clear()
    per_call, samples = tbench.device_time_per_call(chain, n_small=1,
                                                    n_big=4, repeats=2)
    # warm-up n_small + n_big, then each repeat n_big + n_small
    assert len(calls) == 1 + 4 + 2 * (4 + 1)
    assert per_call > 0 and len(samples) == 2
    with pytest.raises(ValueError, match="card"):
        tbench.Chain(fused, batch, graph=True)


def test_bench_train_inputs_match_jax(monkeypatch):
    """`_rcnet_inputs` at the ZJU RC-Net preset and the SML batch of
    `bench_sml`, captured where JAX's tool hands it to its step."""
    from riders_tpu.core.config import zju_config as jzju
    jcfg, tcfg = jzju(), tconfig.zju_config()
    B, K = tcfg.rcnet_train.batch_size, tcfg.rcnet_train.points_per_frame
    want = jtrain._rcnet_inputs(jcfg, np.random.default_rng(0), B, K)
    got = ttrain._rcnet_inputs(tcfg, np.random.default_rng(0), B, K)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k

    class Captured(Exception):
        pass

    seen = {}

    def make_train_step(cfg, model, tx):
        def step(state, batch):
            seen.update(batch)
            raise Captured
        return step

    monkeypatch.setattr(jsml_training, "init_train_state",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(jsml_training, "make_train_step", make_train_step)
    with pytest.raises(Captured):
        jtrain.bench_sml(1)
    got = ttrain._sml_inputs(tcfg, np.random.default_rng(0),
                             tcfg.sml_train.batch_size)
    assert sorted(got) == sorted(seen)
    for k, v in seen.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_synthesize_tree_matches_jax(tmp_path):
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    names = jserving.synthesize_tree(str(jroot), 2, 24, 32, 5)
    assert tserving.synthesize_tree(str(troot), 2, 24, 32, 5) == names
    files = sorted(os.listdir(jroot))
    assert files == sorted(os.listdir(troot)) and len(files) == 6
    for f in files:
        assert (troot / f).read_bytes() == (jroot / f).read_bytes(), f
    # a frame whose radar file exists is kept, not drawn again
    before = (troot / "frame_0000_image.png").stat().st_mtime_ns
    tserving.synthesize_tree(str(troot), 2, 24, 32, 5, seed=1)
    assert (troot / "frame_0000_image.png").stat().st_mtime_ns == before


EVENTS = [
    ("void stem_conv_pool_kernel<(int)2>(__nv_bfloat16 const*, uint4 "
     "const*)", 150.0, "stem (csrc/stem.cu)"),
    ("void stem_general_kernel<4>(unsigned short const*)", 90.0,
     "stem_general (csrc/stem_general.cu)"),
    ("void roi_pool_pyramid_kernel<__nv_bfloat16>(FwdPyramid)", 110.0,
     "roi_pool (csrc/roi_pool.cu)"),
    ("roi_max_pool_bwd_kernel(float const*, float const*)", 1200.0,
     "roi_pool (csrc/roi_pool.cu)"),
    ("compose_kernel(float const*, float const*, float const*)", 35.0,
     "compose (csrc/compose.cu)"),
    ("void (anonymous namespace)::conv_kernel<64, 128, 64>(Args)", 200.0,
     "lane_decoder (csrc/lane_decoder.cu)"),
    ("void upconv_res_kernel<32>(Args)", 100.0,
     "lane_decoder (csrc/lane_decoder.cu)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x64x64", 700.0, "convolution"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_"
     "kernel<3, float>", 300.0, "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64", 120.0,
     "GEMM"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_"
     "bf16_64x64_64x4_tn_align8>(Params)", 80.0, "GEMM"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, bool=1>", 60.0,
     "BatchNorm"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel",
     40.0, "BatchNorm"),
    ("Memcpy DtoD (Device -> Device)", 20.0, "copies"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_"
     "copy_kernel_cuda(at::TensorIteratorBase&)>", 30.0, "copies"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", 25.0, "copies"),
    ("void at::native::upsample_bicubic2d_out_frame<float, float>", 45.0,
     "resizes"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", 55.0, "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::where_"
     "kernel_impl>", 15.0, "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MaxOps<float>>>", 12.0, "reduction"),
    ("void at::native::index_elementwise_kernel<128, 4>", 18.0, "indexing"),
    ("void at::native::elementwise_kernel<convert_float_to_half>", 7.0,
     "elementwise"),
    ("nvjet_tst_64x8_64x16_1x1_h_bz_NNT", 26.0, "GEMM"),
    ("std::enable_if<true, void>::type internal::gemvx::kernel<int, int, "
     "__nv_bfloat16>", 7.0, "GEMM"),
    ("void at::native::(anonymous namespace)::replication_pad_forward_"
     "kernel2d<c10::BFloat16>", 8.0, "copies"),
    ("some_library_kernel_we_do_not_know", 3.0, "other"),
]


def test_profile_rollup_on_synthetic_events():
    for name, _, want in EVENTS:
        assert tprofile.category(name) == want, name
    ops = [(name, t) for name, t, _ in EVENTS] + [(EVENTS[0][0], 50.0)]
    totals = tprofile.rollup(ops)
    expect = {}
    for name, t in ops:
        cat = [c for n, _, c in EVENTS if n == name][0]
        expect[cat] = expect.get(cat, 0.0) + t
    assert totals == expect
    assert list(totals.values()) == sorted(totals.values(), reverse=True)
    assert next(iter(totals)) == "roi_pool (csrc/roi_pool.cu)"
    assert totals["stem (csrc/stem.cu)"] == 200.0
    assert totals["convolution"] == 1000.0
    # the union of overlapping intervals, clipped to the window
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50), (60, 70)]
    assert tprofile.busy_time(spans, (2, 45)) == 13 + 10 + 5
    assert tprofile.busy_time(spans, (0, 100)) == 15 + 10 + 10 + 10
    assert tprofile.busy_time([], (0, 1)) == 0.0


MEASURING = {
    "bench.build": lambda: tbench.build("ntu", 1),
    "bench.measure": lambda: tbench.measure("ntu"),
    "bench.main": lambda: tbench.main(["--ntu"]),
    "bench_train rcnet": lambda: ttrain.bench_rcnet(1),
    "bench_train sml": lambda: ttrain.bench_sml(1),
    "bench_serving": lambda: tserving.main(["--frames", "2"]),
    "profile_bench": lambda: tprofile.profile("ntu"),
}


@pytest.mark.parametrize("name", sorted(MEASURING))
def test_measuring_entry_points_refuse_the_cpu(monkeypatch, tmp_path, name):
    """Without a card each raises before it builds a model or writes a
    file; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tserving, "DATA_DIR", tmp_path / "serving")
    monkeypatch.setattr(tprofile, "OUT_DIR", tmp_path / "trace")
    with pytest.raises(RuntimeError, match="CUDA"):
        MEASURING[name]()
    assert not os.listdir(tmp_path)
