"""Stage 1's golden-section search: the kernel (csrc/golden_section.cu)
and its plain version (ops/kernels/golden_section.py).

On the CPU: the wrapper runs the plain loop and counts no launch; the
kernel's control flow (one objective a step) and its summation order,
mirrored here in PyTorch, against the plain loop.  On the card (the
`dev` fixture skips without one; no JAX is imported, so run them there
with `python -m pytest --noconftest -q tests/test_torch_golden_section.py`):
the kernel bitwise its mirror, and within the objective criterion of the
plain loop, at the cells' shapes and awkward ones.
"""

import numpy as np
import pytest
import torch

from riders_tpu_torch.ops import alignment
from riders_tpu_torch.ops.kernels import LAUNCHES
from riders_tpu_torch.ops.kernels import golden_section as gs

BOUNDS = (0.01, 0.3)            # the presets' bounds_inv
ITERATIONS = 64
# csrc/golden_section.cu's layout
WARP, REG, RESIDENT_WARPS, MAX_WARPS = 32, 16, 8, 32


def kernel_layout(n):
    """(warps a block, whether the row stays in registers) for N = n."""
    resident = n <= RESIDENT_WARPS * WARP * REG
    return (max(1, -(-n // (WARP * REG))) if resident else MAX_WARPS,
            resident)


def kernel_objective(s, p, t, m):
    """The kernel's objective: the plain version's float32 terms, summed
    as the kernel sums them (thread i holds pixels i, i + T, ...; resident
    rows add their REG terms pairwise, streamed rows in index order; then
    the xor butterfly across each warp, then the warps in order)."""
    B, n = p.shape
    warps, resident = kernel_layout(n)
    T = WARP * warps
    K = REG if resident else max(1, -(-n // T))
    x = torch.zeros((B, K * T), dtype=torch.float32)
    x[:, :n] = m * torch.abs(s[:, None] * p - t)
    x = x.reshape(B, K, T)
    if resident:
        w = REG // 2
        while w >= 1:
            x = x[:, :w] + x[:, w:2 * w]
            w //= 2
        v = x[:, 0]
    else:
        v = torch.zeros((B, T), dtype=torch.float32)
        for k in range(K):
            v = v + x[:, k]
    v = v.reshape(B, warps, WARP)
    lanes = torch.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    total = v[:, 0, 0]
    for w in range(1, warps):
        total = total + v[:, w, 0]
    return total


def search_mirror(p, t, m, bounds, iterations, objective):
    """The kernel's search on the CPU: the plain loop's probes and update
    rule, evaluating only the objective that each step keeps."""
    B = p.shape[0]
    lo = torch.full((B,), bounds[0], dtype=torch.float32)
    hi = torch.full((B,), bounds[1], dtype=torch.float32)
    c = lo + gs._INVPHI2 * (hi - lo)
    d = lo + gs._INVPHI * (hi - lo)
    fc, fd = objective(c, p, t, m), objective(d, p, t, m)
    for _ in range(iterations):
        left = fc < fd
        lo, hi = torch.where(left, lo, c), torch.where(left, d, hi)
        s = torch.where(left, lo + gs._INVPHI2 * (hi - lo),
                        lo + gs._INVPHI * (hi - lo))
        f = objective(s, p, t, m)
        c, fc, d, fd = (torch.where(left, s, d), torch.where(left, f, fd),
                        torch.where(left, c, s), torch.where(left, fc, f))
    return 0.5 * (lo + hi)


def always_right(bounds, iterations):
    """The search where every objective is 0 (`fc < fd` never holds), in
    numpy float32 scalars: the value every version must return exactly."""
    lo, hi = np.float32(bounds[0]), np.float32(bounds[1])
    k1, k2 = np.float32(gs._INVPHI), np.float32(gs._INVPHI2)
    c, d = lo + k2 * (hi - lo), lo + k1 * (hi - lo)
    for _ in range(iterations):
        lo, c = c, d
        d = lo + k1 * (hi - lo)
    return np.float32(0.5) * (lo + hi)


def cell_rows(seed, B, n=512, valid=96, flat=False):
    """(p, t, m) rows as the fused call gathers them: `valid` radar
    returns (their prior, p = (1 / z) / 0.05 with 5% noise, against the
    radar's inverse depth), the rest of the bucket prior values under a
    zero mask.  `flat` gives frame 0 two returns with equal p, whose
    objective is flat between their two scales."""
    g = torch.Generator().manual_seed(seed)
    z = 5.0 + 50.0 * torch.rand((B, n), generator=g)
    p = (1.0 / z) / 0.05 * (1.0 + 0.05 * torch.randn((B, n), generator=g))
    t = (1.0 / z) * (1.0 + 0.02 * torch.randn((B, n), generator=g))
    m = torch.zeros((B, n))
    m[:, :min(valid, n)] = 1.0
    t = t * m
    if flat:
        m[0] = 0.0
        m[0, :2] = 1.0
        p[0, :2] = 2.0
        t[0, :2] = torch.tensor([0.1, 0.2])
    return p, t, m


def objective64(s, p, t, m):
    return (m.double() * (s.double()[:, None] * p.double()
                          - t.double()).abs()).sum(1)


def assert_objective_close(got, want, p, t, m, unique=None):
    """The float64 objective at `got` within 1e-6 relative of the one at
    `want`.  Where the minimum is unique (the frames `unique` marks) and
    the float32 sums can resolve it (moving `want` by 1e-4 relative either
    way raises the objective by more than 1e-6 relative), the scales
    within 1e-4 relative.  Random frames whose minimum is unique but
    flatter than that exist: the sums' rounding hides their slope."""
    got, want = got.cpu(), want.cpu()
    p, t, m = p.cpu(), t.cpu(), m.cpu()
    fg, fw = objective64(got, p, t, m), objective64(want, p, t, m)
    assert bool(((fg - fw).abs() <= 1e-6 * fw.abs()).all()), (
        float(((fg - fw).abs() / fw.abs()).max()))
    if unique is None:
        return
    rise = torch.minimum(objective64(want * (1 + 1e-4), p, t, m),
                         objective64(want * (1 - 1e-4), p, t, m)) - fw
    sharp = unique & (rise > 1e-6 * fw.abs())
    rel = ((got - want).abs() / want.abs())[sharp]
    assert bool((rel <= 1e-4).all()), float(rel.max())


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("B,n", [(64, 512), (16, 512), (3, 100)])
def test_wrapper_on_cpu_is_the_plain_loop(B, n):
    p, t, m = cell_rows(0, B, n, valid=min(96, n // 2))
    before = dict(LAUNCHES)
    got = gs.golden_section(p, t, m, BOUNDS, ITERATIONS)
    assert dict(LAUNCHES) == before
    want = gs.golden_section_plain(p, t, m, BOUNDS, ITERATIONS)
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert torch.equal(got, want)
    assert not got.requires_grad


def test_optimize_scale_on_cpu_runs_the_plain_loop_on_the_gathered_rows():
    g = torch.Generator().manual_seed(1)
    B, H, W = 4, 48, 40
    mono = 0.5 + torch.rand((B, H, W), generator=g)
    valid = (torch.rand((B, H, W), generator=g) < 0.05).float()
    target = 0.05 * mono * valid * (1 + 0.1 * torch.rand((B, H, W),
                                                           generator=g))
    before = dict(LAUNCHES)
    got = alignment.optimize_scale(mono, target, valid, BOUNDS, ITERATIONS,
                                   max_valid=512)
    assert dict(LAUNCHES) == before
    idx = torch.sort(valid.reshape(B, -1), dim=1, descending=True,
                     stable=True).indices[:, :512]
    rows = [x.reshape(B, -1).gather(1, idx) for x in (mono, target, valid)]
    assert torch.equal(got, gs.golden_section_plain(*rows, BOUNDS,
                                                    ITERATIONS))


@pytest.mark.parametrize("case", ["zero_mask", "zero_objective"])
@pytest.mark.parametrize("bounds", [BOUNDS, (0.5, 1.6)])
def test_a_zero_objective_gives_the_exact_always_right_value(case, bounds):
    """Every objective 0: `fc < fd` never holds, so the search shrinks
    right at every step and its result does not depend on any sum's
    order; the plain loop and the kernel's mirror give the float32
    sequence's value exactly."""
    p, t, m = cell_rows(2, 5)
    if case == "zero_mask":
        m = torch.zeros_like(m)
    else:
        p, t = torch.zeros_like(p), torch.zeros_like(t)
    want = always_right(bounds, ITERATIONS)
    plain = gs.golden_section_plain(p, t, m, bounds, ITERATIONS)
    mirror = search_mirror(p, t, m, bounds, ITERATIONS, kernel_objective)
    assert bool((plain == float(want)).all())
    assert torch.equal(mirror, plain)


@pytest.mark.parametrize("B,n,valid,flat", [
    (64, 512, 96, False), (16, 512, 64, True), (7, 100, 40, False),
    (5, 37, 37, True), (4, 1000, 700, False), (2, 5000, 300, False)])
def test_one_objective_a_step_is_the_plain_loop(B, n, valid, flat):
    """The kernel's rule (only the kept probe evaluated), with the plain
    version's sums, is the plain loop bit for bit, flat minimum and
    frames without a return included."""
    p, t, m = cell_rows(3, B, n, valid, flat)
    m[-1] = 0.0
    want = gs.golden_section_plain(p, t, m, BOUNDS, ITERATIONS)
    got = search_mirror(p, t, m, BOUNDS, ITERATIONS, gs._l1_objective)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,n,valid", [
    (64, 512, 96), (64, 512, 64), (16, 512, 96), (9, 100, 60),
    (6, 1000, 800), (3, 4096, 4096), (2, 5000, 3000)])
def test_kernel_order_keeps_the_objective(B, n, valid):
    """The kernel's summation order moves the search only where the
    float32 sums cannot tell two probes apart: the float64 objective at
    its scale within 1e-6 relative of the plain loop's, and the scales
    within 1e-4 where the sums resolve the minimum (every minimum here is
    unique)."""
    p, t, m = cell_rows(4, B, n, valid)
    want = gs.golden_section_plain(p, t, m, BOUNDS, ITERATIONS)
    got = search_mirror(p, t, m, BOUNDS, ITERATIONS, kernel_objective)
    assert_objective_close(got, want, p, t, m,
                           unique=torch.ones(B, dtype=torch.bool))


@pytest.mark.parametrize("n", [1, 31, 100, 512, 513, 4096, 4097, 40000])
def test_kernel_layout_sums_every_pixel_once(n):
    """Each pixel's term enters the kernel's sum once: with powers of two
    as terms the sum is exact, and equals the plain sum."""
    warps, resident = kernel_layout(n)
    assert warps * WARP <= 1024 and (resident or warps == MAX_WARPS)
    e = torch.arange(n) % 8
    p = (2.0 ** e.float()).reshape(1, n)
    got = kernel_objective(torch.ones(1), p, torch.zeros_like(p),
                           torch.ones_like(p))
    assert float(got) == float((2.0 ** e.double()).sum())


# ---------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on_card(dev, p, t, m, bounds=BOUNDS):
    before = LAUNCHES["golden_section"]
    got = gs.golden_section(p.to(dev), t.to(dev), m.to(dev), bounds,
                            ITERATIONS)
    torch.cuda.synchronize()
    assert LAUNCHES["golden_section"] == before + 1
    assert got.device.type == "cuda" and got.shape == (p.shape[0],)
    return got.cpu()


@pytest.mark.parametrize("B,n,valid,flat", [
    (64, 512, 96, False), (64, 512, 64, False), (16, 512, 96, True),
    (16, 512, 512, False), (13, 100, 37, False), (5, 37, 37, True),
    (8, 513, 200, False), (4, 1000, 700, False), (3, 4096, 4000, False),
    (2, 4097, 3000, False), (2, 20000, 5000, False)])
def test_kernel_is_its_mirror_and_keeps_the_objective(dev, B, n, valid,
                                                      flat):
    """Cell-like rows and awkward ones (rows not a multiple of 32, fewer
    than 512 or no valid pixels, several warps, streamed rows, a flat
    minimum): the kernel equals its CPU mirror bit for bit, and the plain
    loop (on the card) within the objective criterion."""
    p, t, m = cell_rows(5, B, n, valid, flat)
    m[-1] = 0.0
    got = _on_card(dev, p, t, m)
    assert torch.equal(got, search_mirror(p, t, m, BOUNDS, ITERATIONS,
                                          kernel_objective))
    plain = gs.golden_section_plain(p.to(dev), t.to(dev), m.to(dev),
                                    BOUNDS, ITERATIONS)
    unique = torch.ones(B, dtype=torch.bool)
    unique[-1] = False                  # no valid pixel: f is 0 everywhere
    if flat:
        unique[0] = False
    assert_objective_close(got, plain, p, t, m, unique)


@pytest.mark.parametrize("case", ["zero_mask", "zero_objective"])
@pytest.mark.parametrize("bounds", [BOUNDS, (0.5, 1.6)])
def test_kernel_zero_objective_is_exact(dev, case, bounds):
    p, t, m = cell_rows(6, 64)
    if case == "zero_mask":
        m = torch.zeros_like(m)
    else:
        p, t = torch.zeros_like(p), torch.zeros_like(t)
    got = _on_card(dev, p, t, m, bounds)
    plain = gs.golden_section_plain(p.to(dev), t.to(dev), m.to(dev), bounds,
                                    ITERATIONS).cpu()
    assert torch.equal(got, plain)
    assert bool((got == float(always_right(bounds, ITERATIONS))).all())


def test_optimize_scale_on_card_is_one_launch(dev, monkeypatch):
    """Gathered (the cells' case) and un-gathered (one 512x640 row of
    327680 pixels, streamed): one launch a call, the plain loop never
    run on a CUDA tensor, the result the kernel's mirror on the rows."""
    def refuse(p, *args):
        raise AssertionError(f"the plain loop ran on {p.device}")

    monkeypatch.setattr(gs, "golden_section_plain", refuse)
    g = torch.Generator().manual_seed(7)
    for B, max_valid in ((16, 512), (1, None)):
        z = 5.0 + 50.0 * torch.rand((B, 512, 640), generator=g)
        mono = (1.0 / z) / 0.05
        valid = torch.zeros((B, 512 * 640))
        valid[:, torch.randperm(512 * 640, generator=g)[:96]] = 1.0
        valid = valid.reshape(B, 512, 640)
        target = valid / z * (1.0 + 0.02 * torch.randn(z.shape, generator=g))
        before = LAUNCHES["golden_section"]
        got = alignment.optimize_scale(mono.to(dev), target.to(dev),
                                       valid.to(dev), BOUNDS, ITERATIONS,
                                       max_valid=max_valid).cpu()
        assert LAUNCHES["golden_section"] == before + 1
        rows = [x.reshape(B, -1) for x in (mono, target, valid)]
        if max_valid is not None:
            idx = torch.sort(rows[2], dim=1, descending=True,
                             stable=True).indices[:, :512]
            rows = [x.gather(1, idx) for x in rows]
        assert torch.equal(got, search_mirror(*rows, BOUNDS, ITERATIONS,
                                              kernel_objective))


def test_kernel_refuses_what_it_does_not_take(dev):
    p, t, m = (x.to(dev) for x in cell_rows(8, 4))
    with pytest.raises(TypeError):
        gs.golden_section(p.double(), t, m, BOUNDS, ITERATIONS)
    with pytest.raises(ValueError):
        gs.golden_section(p.t().contiguous().t(), t, m, BOUNDS, ITERATIONS)
    with pytest.raises(ValueError):
        gs.golden_section(p, t[:, 1:].contiguous(), m, BOUNDS, ITERATIONS)
    with pytest.raises(ValueError):
        gs.golden_section(p[0], t[0], m[0], BOUNDS, ITERATIONS)
    with pytest.raises(ValueError):
        gs.golden_section(p, t, m, BOUNDS, -1)
    with pytest.raises(ValueError):
        gs.golden_section(p, t.cpu(), m, BOUNDS, ITERATIONS)
