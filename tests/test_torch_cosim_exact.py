"""The co-simulation's physics, bit for bit against the JAX reference on
the CPU (ROADMAP §C.3): ``fmath.pow`` against glibc's ``powf`` and the
reference backend's float32 power on over a million points, the aging
update and the stress rates as the co-sim's scan compiles them, the delay
polynomial's sum order, and the 96-epoch wear_level / rest_to_recover
fleet of ``tests/test_sched.py`` element by element."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aging as jax_aging
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.policy import FaultTolerantPolicy as JaxFaultTolerantPolicy
from repro.core.scenario import Scenario as JaxScenario
from repro.sched import cosimulate as jax_cosimulate
from repro_torch import fmath
from repro_torch.core import aging
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.constants import T_AMB
from repro_torch.core.policy import FaultTolerantPolicy
from repro_torch.core.resilience import OPERATORS
from repro_torch.core.scenario import Scenario
from repro_torch.sched import cosimulate, get_workload

YEAR_S = 365.25 * 24 * 3600.0
N_DEV = 8
N_EPOCHS = 96
FLT_MIN = np.float32(2.0 ** -126)


def _bits_equal(a, b):
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def _pow_grid():
    """>= 2**20 float32 (x, y): the co-sim's operands (dv/K up to 1e3 with
    1/n, t_new up to 1e9 with n, 10 to the leakage exponent), general
    operands over the whole range, negative bases with integer exponents,
    and every pairing of the special values."""
    rng = np.random.default_rng(0)
    n = 150_000
    xs = [rng.uniform(0, 1000, n), rng.uniform(1e3, 1e9, n),
          np.full(n, 10.0), rng.uniform(0, 2, n),
          10.0 ** rng.uniform(-37, 38, n), rng.uniform(-5, 5, n),
          rng.uniform(0.5, 1.5, n)]
    ys = [1.0 / rng.uniform(0.1, 0.6, n), rng.uniform(0.1, 0.6, n),
          rng.uniform(-6, 2, n), rng.uniform(-20, 20, n),
          rng.uniform(-4, 4, n), rng.integers(-9, 10, n).astype(float),
          rng.uniform(-200, 200, n)]
    sp = np.array([0, -0.0, 1, -1, np.inf, -np.inf, np.nan, 2, -2, 0.5,
                   -0.5, 1e-40, -1e-40, 1e38, 3.4e38, 1e-45, 10], np.float32)
    sy = np.concatenate([sp, np.array([3, -3, 2.5, -2.5, 127, -127, 200,
                                       -200, 149.5, 1e10, -1e10],
                                      np.float32)])
    gx, gy = np.meshgrid(sp, sy)
    x = np.concatenate(xs + [gx.ravel()]).astype(np.float32)
    y = np.concatenate(ys + [gy.ravel()]).astype(np.float32)
    return x, y


def test_pow_matches_glibc_and_the_reference_backend():
    """Bit for bit with ``jax.jit(jnp.power)`` everywhere, and with glibc's
    ``powf`` (through ctypes) wherever neither the base nor the result is
    subnormal: the reference backend's threads read subnormal inputs as
    zero and flush subnormal results, glibc on this thread does not, and
    there the two references themselves differ."""
    x, y = _pow_grid()
    assert x.size >= 2 ** 20
    got = fmath.pow(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jax.jit(jnp.power)(x, y))
    assert _bits_equal(got, want).all()
    libm = ctypes.CDLL("libm.so.6")
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    glibc = np.array([libm.powf(a, b) for a, b in zip(x.tolist(),
                                                       y.tolist())],
                     np.float32)
    sub = lambda a: (np.abs(a) < FLT_MIN) & (a != 0)
    normal = ~sub(x) & ~sub(glibc)
    assert normal.sum() > 0.99 * x.size
    assert _bits_equal(got[normal], glibc[normal]).all()
    assert _bits_equal(glibc, want)[normal].all()


def test_fma64_is_the_exactly_rounded_double_fma():
    """The double multiply-add of ``fmath.pow``'s polynomials against an
    exact rational evaluation."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-8, 8, 2000)
               for _ in range(3))
    got = fmath.fma64(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = [float(Fraction(p) * Fraction(q) + Fraction(r))
            for p, q, r in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("shape", [(8, 9), (4, 9), (3, 7)])
def test_update_state_is_bit_exact(shape):
    """``update_state`` at the co-sim's broadcasts ((N, O, 6) shifts, (N, 6)
    rates, (N,) temperatures) against the reference jitted the same way:
    the float32 ``pow`` and the self-heating reciprocal.  (The rates'
    ``act + chi * (1 - act)`` multiply-add is held by the co-sims below:
    whether the reference backend fuses it depends on what else its scan
    fuses with it.)"""
    jcal, cal = jax_load_calibration(), load_calibration()
    N, O = shape
    rng = np.random.default_rng(N * O)
    dv = rng.uniform(0, 80, (N, O, 6)).astype(np.float32)
    dv[..., 0] *= rng.integers(0, 2, (N, O))
    V = rng.uniform(0.8, 1.0, (N, O)).astype(np.float32)
    rates = rng.uniform(0, 1, (N, 6)).astype(np.float32)
    tamb = rng.uniform(290, 340, (N,)).astype(np.float32)
    dt = np.float32(1.6e6)
    want = jax.jit(lambda dv, V, r, t: jax_aging.update_state(
        jcal.aging, dv, V[..., None], r[:, None, :], dt, t[:, None, None]))(
        dv, V, rates, tamb)
    T = torch.from_numpy
    got = aging.update_state(cal.aging, T(dv), T(V)[..., None],
                             T(rates)[:, None, :], dt, T(tamb)[:, None, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def fleet8():
    """``tests/test_sched.py``'s fleet (8 devices over a 30 K gradient,
    5-year horizon) under 96 epochs of diurnal traffic at 55 %, with the
    reference's co-sims for the two wear-steering routers."""
    jcal, cal = jax_load_calibration(), load_calibration()
    t_amb = (T_AMB + np.linspace(0.0, 30.0, N_DEV)).astype(np.float32)
    jscn = JaxScenario.from_lifetime_config(jcal.lifetime_cfg).replace(
        lifetime_s=5 * YEAR_S, t_amb=jnp.asarray(t_amb))
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=5 * YEAR_S, t_amb=torch.from_numpy(t_amb))
    jdmax = JaxFaultTolerantPolicy(ber_model=jcal.ber).thresholds(
        jscn, OPERATORS)
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    loads = get_workload("diurnal", n_devices=N_DEV, utilization=0.55,
                         n_epochs=N_EPOCHS).loads(0, "cpu").numpy()
    refs = {r: jax_cosimulate(jcal.aging, jcal.delay_poly, jscn, jdmax, loads,
                              router=r, n_devices=N_DEV)
            for r in ("wear_level", "rest_to_recover")}
    return cal, scn, dmax, loads, refs


def test_delay_polynomial_is_bit_exact_in_the_cosim(fleet8):
    """The port's polynomial on the reference co-sim's own shifts and
    supplies gives its delays bit for bit: the 84-term dot summed in the
    order of the reference backend's compiled loop (fused products, four
    8-lane accumulators, the lane trees, the scalar tail)."""
    cal, _, _, _, refs = fleet8
    for ref in refs.values():
        T = lambda a: torch.from_numpy(np.asarray(a))
        got = cal.delay_poly(T(ref.dvp) * 1e-3, T(ref.dvn) * 1e-3, T(ref.V))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.delay))


@pytest.mark.parametrize("router", ["wear_level", "rest_to_recover"])
def test_cosim_96_epochs_equal_the_reference(fleet8, router):
    """C.3's reproduction: every epoch's utilizations, supplies, shifts,
    delays and boosts equal the reference's (before the repair the first
    supply moved at epoch 28 and 16 (device, op) pairs by epoch 96)."""
    cal, scn, dmax, loads, refs = fleet8
    ref = refs[router]
    got = cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads,
                     router=router, n_devices=N_DEV, device="cpu")
    for f in ("util", "V", "dv", "dvp", "dvn", "delay", "boosts", "t"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), f)
