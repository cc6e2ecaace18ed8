"""An SML of another family than midas-small, taken by new files only:
the reference found by model type, the weights of raw parameters by
their declared kinds, the rounding of a module's own weights, and the
weights of the accepted configurations held to digests of what they
were before any of it."""

import hashlib
import json
import subprocess
import sys

import pytest
import torch
import torch.nn as nn

from benchmark import harness
from benchmark.frames import make_pool
from benchmark.reference import chain
from benchmark.tests.conftest import (ROOT, TINY, add_family_cell,
                                      add_tiny_cell, copy_checkout)
from benchmark.weights import LECUN_TRUNC, _fill, _plan, make_weights

SEED = 2 ** 31 + 17

# sha256 of json.dumps([_plan(RC-Net), _plan(SML)]) of each accepted
# configuration on the meta device, and of the tiny configuration's
# seeded weights from `make_weights` (key, then bytes, in sorted key
# order; the calibrated head left out, as its bits follow the CPU's
# thread count), all taken before the SML families were added
PLAN_DIGESTS = {
    "ntu_lite3":
        "383a5f5903712a8b4c621903a50eec4172b470d9fd86d4dea207005b0f28cf4c",
    "zju_lite3":
        "6eedb8ede1329ffcc4dd292dca6acaae74e2b3d33b6a12df896ea93ce5f5c0f6",
}
TINY_WEIGHTS_DIGEST = \
    "f22a7e83cd2485f2835ae31a18f5b73d8e53bf35874ef2d822974afb15b8ef14"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_a_second_family_added_by_files_runs_correct(tmp_path):
    """midas-small-depth, which the port's factory builds as the
    direct-depth SML, with a stand-in reference file under
    `reference/sml/`: a closed-loop run in float32 of the copy's own
    harness (the reference is found beside its modules) comes out
    correct at the tiny cell's limits of 1e-4."""
    root = copy_checkout(tmp_path / "checkout")
    cell = add_family_cell(root)
    code = (
        "import json, sys\n"
        "sys.path[:0] = [%r, %r]\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "assert harness.__file__.startswith(%r)\n"
        "r = harness.run_cell(harness.Path(%r), %r, %d, 1.0, False, "
        "device='cpu')\n"
        "print(json.dumps(r))\n" % (str(root), str(ROOT), str(root),
                                    str(root), cell, SEED))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"responses_err_ratio", "depth_err_ratio"}
    for c in r["checks"].values():
        assert c["limit"] == 1e-4 and c["value"] <= 1e-5


def test_a_model_type_without_a_reference_names_the_file():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "ntu_lite3.json").read_text())
    cfg["sml"]["model_type"] = "dpt-beit-large"
    with pytest.raises(ValueError, match=r"reference/sml/dpt-beit-large\.py"):
        chain.build_models(cfg, "cpu", meta=True)
    cfg["sml"]["model_type"] = "midas-small"
    _, sml = chain.build_models(cfg, "cpu", meta=True)
    assert type(sml) is chain.SML
    assert chain.sml_head(sml) == "output_conv.conv3"


class Raw(nn.Module):
    """A Linear beside a tensor of each raw kind."""

    INIT = {"kernel": "w", "bias": "b", "gamma": "ones", "token": "zeros",
            "table": ("normal", 0.02)}

    def __init__(self):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(6, 4))
        self.bias = nn.Parameter(torch.empty(6))
        self.gamma = nn.Parameter(torch.empty(4))
        self.token = nn.Parameter(torch.empty(1, 1, 4))
        self.table = nn.Parameter(torch.empty(9, 2))
        self.lin = nn.Linear(4, 3)


@pytest.mark.parametrize("scheme", ["he", "flax"])
def test_declared_raw_parameters_take_their_kind(scheme):
    plan = _plan(Raw())
    assert [(k, kind, fan) for k, _, kind, fan in plan] == [
        ("kernel", "w", 4), ("bias", "b", 1), ("gamma", "ones", 1),
        ("token", "zeros", 4), ("table", ("normal", 0.02), 2),
        ("lin.weight", "w", 4), ("lin.bias", "b", 1)]
    state = _fill(plan, scheme, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    z = torch.randn(24 + 6 + 4 + 4 + 18 + 12 + 3, generator=g)
    zc = z.clamp(-2.0, 2.0) if scheme == "flax" else z
    kernel, bias, table, lin = zc[:24], zc[24:30], z[38:56], zc[56:68]
    if scheme == "he":
        want_k, want_b, want_lin = (kernel * 0.5 ** 0.5, 0.02 * bias,
                                    lin * 0.5 ** 0.5)
    else:
        want_k, want_b, want_lin = (kernel * 0.5 / LECUN_TRUNC,
                                    torch.zeros(6), lin * 0.5 / LECUN_TRUNC)
    assert torch.equal(state["kernel"], want_k.view(6, 4))
    assert torch.equal(state["bias"], want_b)
    assert torch.equal(state["gamma"], torch.ones(4))
    assert torch.equal(state["token"], torch.zeros(1, 1, 4))
    assert torch.equal(state["table"], 0.02 * table.view(9, 2))
    assert torch.equal(state["lin.weight"], want_lin.view(3, 4))
    Raw().load_state_dict(state)


class ConvT(nn.ConvTranspose2d):
    INIT = {"weight": "w_t", "bias": "b"}


@pytest.mark.parametrize("scheme", ["he", "flax"])
def test_a_transposed_conv_weight_takes_its_input_fan_in(scheme):
    """"w_t" on an (in, out, kh, kw) weight: fan-in in * kh * kw, not the
    out * kh * kw of one row, and the weight rule of "w" on it."""
    m = ConvT(6, 2, 3)
    plan = _plan(m)
    assert [(k, s, kind, fan) for k, s, kind, fan in plan] == [
        ("weight", (6, 2, 3, 3), "w_t", 54), ("bias", (2,), "b", 1)]
    state = _fill(plan, scheme, torch.Generator().manual_seed(3), "cpu")
    z = torch.randn(108 + 2, generator=torch.Generator().manual_seed(3))
    zc = z.clamp(-2.0, 2.0) if scheme == "flax" else z
    want = (zc[:108] * (2.0 / 54) ** 0.5 if scheme == "he"
            else zc[:108] * (1.0 / 54) ** 0.5 / LECUN_TRUNC)
    assert torch.equal(state["weight"], want.view(6, 2, 3, 3))
    m.load_state_dict(state)


WRAPPED_REFERENCE = '''"""nets.SML one level down, its head conv at another name."""

import torch.nn as nn

from benchmark.reference import nets


class SML(nn.Module):
    HEAD = "inner.output_conv.conv3"

    def __init__(self, sml):
        super().__init__()
        self.inner = nets.SML(dict(sml, model_type="midas-small"))

    def forward(self, x, d):
        return self.inner(x, d)

    def head_input(self, x):
        return self.inner.head_input(x)
'''


def test_the_calibration_sets_the_head_its_reference_names(tmp_path,
                                                          monkeypatch):
    """A reference whose `HEAD` is not the default: `make_weights`
    finds that conv by its name and calibrates it as it does
    `nets.SML`'s, so both trees get the same weights, key for key."""
    sml_dir = tmp_path / "sml"
    sml_dir.mkdir()
    (sml_dir / "wrapped-midas.py").write_text(WRAPPED_REFERENCE)
    monkeypatch.setattr(chain, "SML_DIR", str(sml_dir))
    root = copy_checkout(tmp_path / "checkout")
    add_tiny_cell(root)
    _, _, config, traffic = harness.find_cell(root, f"{TINY}.closed")
    cfg = harness.port_config(config)
    pool = make_pool(cfg.dataset.image_shape, cfg.dataset.max_points,
                     config["real_points"], traffic["pool_batches"],
                     traffic["batch"], SEED, torch.device("cpu"))
    frame = {k: v[:1] for k, v in pool[0].items()}
    wrapped = json.loads(json.dumps(config))
    wrapped["sml"]["model_type"] = "wrapped-midas"
    plain = make_weights(config, SEED, torch.device("cpu"), frame)
    got = make_weights(wrapped, SEED, torch.device("cpu"), frame)
    assert list(got["sml"]) == ["inner." + k for k in plain["sml"]]
    for key, value in plain["rcnet"].items():
        assert torch.equal(got["rcnet"][key], value), key
    for key, value in plain["sml"].items():
        assert torch.equal(got["sml"]["inner." + key], value), key
    assert float(plain["sml"]["output_conv.conv3.bias"].abs().max()) > 0


@pytest.mark.parametrize("init", [{}, {"kernel": "uniform"},
                                  {"kernel": "normal"},
                                  {"kernel": ("w", 1.0)}])
def test_an_undeclared_raw_parameter_raises(init):
    class Bare(nn.Module):
        INIT = init

        def __init__(self):
            super().__init__()
            self.kernel = nn.Parameter(torch.empty(3, 2))

    with pytest.raises(TypeError, match="kernel"):
        _plan(Bare())


def test_emulate_calls_a_modules_own_rounding():
    """`chain.emulate_` rounds conv and linear layers as before and hands
    the rounding to every module that has an `emulate_` of its own."""
    class Own(nn.Module):
        def __init__(self):
            super().__init__()
            self.kernel = nn.Parameter(torch.full((2, 2), 1.0 + 2 ** -12))
            self.lin = nn.Linear(2, 2)
            self.seen = []

        def emulate_(self, rounding):
            self.seen.append(rounding)
            with torch.no_grad():
                self.kernel.copy_(rounding(self.kernel))

    m = Own()
    with torch.no_grad():
        m.lin.weight.fill_(1.0 + 2 ** -12)
    chain.emulate_(m, chain.round_bf16)
    assert m.seen == [chain.round_bf16]
    assert torch.equal(m.kernel, torch.ones(2, 2))
    assert torch.equal(m.lin.weight, torch.ones(2, 2))


@pytest.mark.parametrize("name", sorted(PLAN_DIGESTS))
def test_the_accepted_configurations_plan_is_unchanged(name):
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{name}.json").read_text())
    rc, sml = chain.build_models(cfg, "cpu", meta=True)
    got = json.dumps([_plan(rc), _plan(sml)])
    assert hashlib.sha256(got.encode()).hexdigest() == PLAN_DIGESTS[name]


def test_the_tiny_configurations_weights_are_unchanged(tmp_path):
    root = copy_checkout(tmp_path / "checkout")
    add_tiny_cell(root)
    _, _, config, traffic = harness.find_cell(root, f"{TINY}.closed")
    cfg = harness.port_config(config)
    pool = make_pool(cfg.dataset.image_shape, cfg.dataset.max_points,
                     config["real_points"], traffic["pool_batches"],
                     traffic["batch"], SEED, torch.device("cpu"))
    weights = make_weights(config, SEED + harness.WEIGHT_SEED_OFFSET,
                           torch.device("cpu"),
                           {k: v[:1] for k, v in pool[0].items()})
    h = hashlib.sha256()
    for part in ("rcnet", "sml"):
        for key in sorted(weights[part]):
            if key.startswith("output_conv.conv3."):
                continue
            h.update(key.encode())
            h.update(weights[part][key].contiguous().numpy().tobytes())
    assert h.hexdigest() == TINY_WEIGHTS_DIGEST
