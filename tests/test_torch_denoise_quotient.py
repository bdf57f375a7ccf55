"""The denoise kernel's range quotient (``csrc/denoise.cu``
``range_quotient``): the reciprocal its wrapper computes once per launch
(``ops/denoise.py`` ``range_reciprocal``), the path each ``sigma_range``
takes, the quotient's sequence emulated in exact rational arithmetic
against float32 division, and which launches count as taking one
correction.  CPU only, except the ``cuda`` cases, which hold the kernel's
quotient against IEEE division over every non-negative float32 dividend
and the kernel against ``denoise_plain`` bit for bit on the card:

    python -m pytest -m cuda tests/test_torch_denoise_quotient.py
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from voxtracer_torch.engine import params as P
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.ops import denoise

F32 = np.float32
MAX = float(np.finfo(F32).max)
# the viewer's keys step sigma_range by 0.25 over [0.25, 8], the web
# viewer's slider by 0.05
VIEWER = [0.25 * k for k in range(1, 33)]
WEB = [round(0.25 + 0.05 * k, 2) for k in range(156)]
# below these the remainder can leave float32's normal range, and the
# quotient may miss IEEE's by an ulp (the kernel's header)
TINY_DIVIDEND = 2.0**-100
TINY_QUOTIENT = 2.0**-52


def _rn32(x: Fraction) -> float:
    """``x`` rounded to float32, to nearest, ties to even, subnormals and
    overflow to inf included."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(x, quantum)
    if 2 * rem > quantum or (2 * rem == quantum and n % 2):
        n += 1
    v = n * quantum
    return sign * (math.inf if v >= 2**128 else float(v))


def _mul(x: float, y: float) -> float:
    if math.isfinite(x) and math.isfinite(y):
        return _rn32(Fraction(x) * Fraction(y))
    return float(F32(x) * F32(y))


def _fma(x: float, y: float, z: float) -> float:
    """fmaf: x * y + z rounded once (IEEE's inf and NaN rules)."""
    if all(math.isfinite(v) for v in (x, y, z)):
        return _rn32(Fraction(x) * Fraction(y) + Fraction(z))
    return float(F32(np.float64(x) * np.float64(y) + np.float64(z)))


def _quotient(a: float, rr: denoise.RangeReciprocal, steps: int) -> float:
    """``range_quotient<steps>(a, b, y)``, step by step."""
    q = _mul(a, rr.y)
    for _ in range(steps):
        q = float(np.fmin(q, MAX))  # fminf: NaN gives the other operand
        q = _fma(_fma(-rr.b, q, a), rr.y, q)
    return q


def _ieee(a: float, b: float) -> float:
    with np.errstate(all="ignore"):
        return float(F32(a) / F32(b))


def _same(x: float, y: float) -> bool:
    return (math.isnan(x) and math.isnan(y)) or (
        F32(x).view(np.uint32) == F32(y).view(np.uint32))


def _dividends(b: float) -> list:
    """Edges (zero, subnormals, the normal range's ends, around the
    quotient's overflow, inf, NaN), every power of two and a seeded
    spread of finite bit patterns and of the magnitudes a tap's range
    term takes."""
    rng = np.random.default_rng(25)
    edge_bits = [0, 1, 2, 0x7FFFFF, 0x800000, 0x1800009, 0x7F7FFFFF,
                 0x7F800000, 0x7FC00000, 0x7F800001]
    with np.errstate(over="ignore"):
        over = F32(MAX) * F32(b)  # a / b crosses float32's largest here
    near = [np.nextafter(over, F32(np.inf) * s) for s in (1, -1)]
    powers = [2.0**e for e in range(-149, 128)]
    spread = rng.integers(0, 0x7F800000, 1500, dtype=np.uint32)
    typical = (10.0 ** rng.uniform(-8, 6, 1000)).astype(F32)
    out = [float(v) for v in np.array(edge_bits, np.uint32).view(F32)]
    out += [float(over), *map(float, near), *powers]
    out += [float(v) for v in spread.view(F32)] + [float(v) for v in typical]
    return out


def test_one_correction_passes_on_the_viewer_grid_but_four():
    """Markstein's test (|b y - 1| <= 2^-25, exact rationals) passes at 28
    of the viewer's 32 values, the default 1.5 among them, and at 124 of
    the web viewer's 156."""
    steps = {s: denoise.range_reciprocal(s).steps for s in VIEWER}
    assert [s for s in VIEWER if steps[s] == 2] == [2.75, 4.25, 5.5, 7.75]
    assert denoise.range_reciprocal(1.5).steps == 1
    assert sum(denoise.range_reciprocal(s).steps == 1 for s in WEB) == 124
    assert denoise.range_reciprocal(P.DenoiseParams().sigma_range).steps == 1


@pytest.mark.parametrize("sigma, steps", [
    (1.5, 1), (0.25, 1), (0.3, 1), (0.75, 1), (8.0, 1), (100.0, 1),
    (2.75, 2), (4.25, 2), (5.5, 2), (7.75, 2), (0.35, 2), (0.7, 2)])
def test_path_of_each_sigma(sigma, steps):
    """The reciprocal is float32's RN(1 / b) for the kernel's float32
    b = 2 * sigma^2, and the path follows the exact test."""
    rr = denoise.range_reciprocal(sigma)
    s = F32(sigma)
    assert rr.b == float(F32(2) * (s * s)) == denoise._sigma2(sigma)
    assert rr.y == float(F32(1) / F32(rr.b))
    off = abs(Fraction(rr.b) * Fraction(rr.y) - 1)
    assert (off <= Fraction(1, 2**25)) == (steps == 1) == (rr.steps == 1)
    assert rr.steps == steps


def test_default_reciprocal_is_a_quarter_of_the_bound_off():
    rr = denoise.range_reciprocal(1.5)
    assert rr.b == 4.5
    assert abs(Fraction(rr.b) * Fraction(rr.y) - 1) == Fraction(1, 2**27)


@pytest.mark.parametrize("sigma", [0.0, -0.0, 1e-25, 1e19, 1e20, math.inf,
                                   math.nan])
def test_a_sigma_whose_reciprocal_is_not_normal_is_refused(sigma):
    with pytest.raises(ValueError, match="normal"):
        denoise.range_reciprocal(sigma)


@pytest.mark.parametrize("sigma, steps", [
    (1.5, 1), (0.3, 1), (8.0, 1), (2.75, 2), (7.75, 2), (0.7, 2)])
def test_emulated_quotient_is_float32_division(sigma, steps):
    """The kernel's sequence in exact rational arithmetic equals float32
    division on every dividend of ``_dividends``, inf and NaN included,
    except tiny dividends, where both quotients lie below 2^-52 (the
    kernel's header: the tap's weight cannot tell them apart)."""
    rr = denoise.range_reciprocal(sigma)
    assert rr.steps == steps
    apart = []
    for a in _dividends(rr.b):
        q, want = _quotient(a, rr, steps), _ieee(a, rr.b)
        if not _same(q, want):
            apart.append((a, q, want))
    assert all(a < TINY_DIVIDEND and max(q, want) < TINY_QUOTIENT
               for a, q, want in apart), apart[:5]
    assert _quotient(math.inf, rr, steps) == math.inf
    assert math.isnan(_quotient(math.nan, rr, steps))
    assert F32(_quotient(0.0, rr, steps)).view(np.uint32) == 0  # +0


def test_tiny_dividend_where_one_ulp_is_missed():
    """The exception itself: at the default sigma_range the dividend with
    bits 0x01800009 (4.7e-38) has a remainder of -2.5 * 2^-149, which
    float32 rounds to -2^-148, so the quotient lands an ulp above IEEE's
    (both about 1.04e-38)."""
    rr = denoise.range_reciprocal(1.5)
    a = float(np.uint32(0x1800009).view(F32))
    q, want = _quotient(a, rr, 1), _ieee(a, rr.b)
    assert F32(q).view(np.uint32) == F32(want).view(np.uint32) + 1
    assert q < TINY_QUOTIENT


@pytest.mark.parametrize("instance, steps, counted", [
    (2, 1, 1), (8, 1, 1), (0, 1, 1), (8, 2, 0),
    (denoise.GLOBAL_INSTANCE, 1, 0), (denoise.GLOBAL_INSTANCE, 2, 0)])
def test_reciprocal_launches_count_tiled_one_step_launches(instance, steps,
                                                           counted):
    plan = denoise.TilePlan(instance, denoise.BLOCK, (1, 1), 4, 0)
    rr = denoise.RangeReciprocal(4.5, 1 / 4.5, steps)
    assert denoise.reciprocal_launch(plan, rr) == counted


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.5, 0.3, 2.75, 7.75])
def test_quotient_against_ieee_division_on_the_card(cuda, sigma):
    """Every non-negative float32 dividend (inf and the NaNs among them):
    the kernel's quotient is IEEE's but for tiny dividends, whose
    quotients both lie below 2^-52, and expf is 1 on [-2^-25, 0]: the two
    facts the kernel's tiny-dividend argument rests on."""
    got = denoise.quotient_check(sigma)
    assert got["top"] < TINY_QUOTIENT, got
    assert got["plateau"] == 0, got


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.5, 0.3, 2.75, 7.75])
@pytest.mark.parametrize("radius", [1, 2, 8, 12])
def test_kernel_is_bit_equal_to_plain_at_either_path(cuda, sigma, radius):
    """Both paths of the quotient, every value of a ragged frame with
    misses and equal neighbours, bit for bit."""
    rng = np.random.default_rng(radius)
    h, w = 75, 133
    colors = rng.random((3, h, w), F32)
    colors[:, :20] = 0.5  # equal elements: zero dividends
    normal = rng.normal(size=(3, h, w)).astype(F32)
    depth = (rng.random((h, w)) * 10 + 0.5).astype(F32)
    depth[:10] = -1.0  # misses
    node = rng.integers(0, 4, (h, w), dtype=np.int32) << 24
    albedo = rng.random((3, h, w), F32)
    planes = [torch.from_numpy(a).to(cuda)
              for a in (colors, normal, depth, albedo, node)]
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    dp = P.pack_denoise_params(cam.rows(w, h), P.DenoiseParams(
        sigma_distance=1.7, sigma_range=sigma, albedo_factor=0.6))
    k = denoise.denoise_cuda(*planes, dp, radius)
    p = denoise.denoise_plain(*planes, dp, radius)
    assert torch.isfinite(p).all()
    assert torch.equal(k, p)
