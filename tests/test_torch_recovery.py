"""The port's short-term recovery and thermal feedback vs the JAX
reference on the CPU: ``RecoveryParams`` and ``relax_step`` (with its
invariants: the pool bounded by the recoverable fraction, an
always-stressed pool exactly empty), ``hci_gamma`` and ``dc_shift``, and
the co-simulation with ``recovery_dynamics`` and with ``thermal``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aging as jaging
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.policy import FaultTolerantPolicy as JaxFaultTolerantPolicy
from repro.core.scenario import Scenario as JaxScenario
from repro.sched import ThermalParams as JaxThermalParams
from repro.sched import cosimulate as jax_cosimulate
from repro_torch.core import aging
from repro_torch.core.aging import (IS_PMOS, N_POP, RecoveryParams,
                                    effective_dv, relax_step)
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.policy import FaultTolerantPolicy
from repro_torch.core.resilience import OPERATORS
from repro_torch.core.scenario import Scenario
from repro_torch.sched import ThermalParams, cosimulate

YEAR_S = 365.25 * 24 * 3600.0
SHIFT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's co-sims are loops of tiny tensor operations: run them
    on one intra-op thread (the suite runs several workers, and a worker's
    idle pool threads spinning against the others' slow every small
    operation many times over); restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# --------------------------------------------------------------------------- #
# relax_step
# --------------------------------------------------------------------------- #
def test_recovery_params_match_reference_and_round_trip():
    rp, jrp = RecoveryParams.default(), jaging.RecoveryParams.default()
    assert rp.to_dict() == jrp.to_dict()
    back = RecoveryParams.from_dict(json.loads(json.dumps(rp.to_dict())))
    for f in ("rho", "k_relax", "k_retrap"):
        assert torch.equal(getattr(back, f), getattr(rp, f))
        assert getattr(rp.to("cpu"), f).dtype == torch.float32


def test_relax_step_matches_reference():
    """Bit for bit with the reference as its backend compiles it (jitted,
    as in its co-sim scan, where the multiply-adds are fused; dispatched op
    by op it rounds each product on its own)."""
    rng = np.random.default_rng(0)
    rp, jrp = RecoveryParams.default(), jaging.RecoveryParams.default()
    dv = rng.uniform(0, 250, (2000, N_POP)).astype(np.float32)
    rec = (rng.uniform(0, 1, (2000, N_POP)) * 0.45 * dv).astype(np.float32)
    act = rng.uniform(0, 1, (2000, 1)).astype(np.float32)
    act[:100] = 0.0
    act[100:200] = 1.0
    step = jax.jit(jaging.relax_step)
    for dt in (60.0, 3.6e3, 3.2e5, 3.0e7):
        want = np.asarray(step(jrp, jnp.asarray(dv), jnp.asarray(rec),
                               jnp.asarray(act), np.float32(dt)))
        got = relax_step(rp, T(dv), T(rec), T(act), dt).numpy()
        np.testing.assert_array_equal(got, want)
    assert effective_dv(T(dv), None) is not None
    np.testing.assert_array_equal(effective_dv(T(dv), T(rec)).numpy(),
                                  dv - rec)


def test_relax_step_invariants():
    """0 <= rec <= rho*dv over random histories; act == 1 keeps an empty
    pool exactly empty; at act == 0 the pool approaches rho*dv
    monotonically."""
    rp = RecoveryParams.default()
    rho = rp.rho.numpy()
    rng = np.random.default_rng(1)
    for _ in range(20):
        dv = np.zeros(N_POP, np.float32)
        rec = torch.zeros(N_POP)
        for _ in range(12):
            dv = dv + rng.uniform(0.0, 8.0, N_POP).astype(np.float32)
            rec = relax_step(rp, T(dv), rec, float(rng.uniform()),
                             float(rng.uniform(60, 1e6)))
            r = rec.numpy()
            assert (r >= 0).all() and (r <= rho * dv + 1e-4).all()
    for dv in (0.5, 37.0, 250.0):
        full = torch.full((N_POP,), dv)
        for dt in (1.0, 3.6e3, 3.0e7):
            assert not relax_step(rp, full, torch.zeros(N_POP), 1.0,
                                  dt).any()
        rec, prev = torch.zeros(N_POP), np.zeros(N_POP, np.float32)
        for dt in (3.6e3, 3.6e4, 3.6e5, 3.6e6):
            rec = relax_step(rp, full, rec, 0.0, dt)
            assert (rec.numpy() >= prev - 1e-5).all()
            prev = rec.numpy()
        assert prev[0] == pytest.approx(float(rho[0]) * dv, rel=1e-3)


def test_hci_gamma_and_dc_shift_match_reference():
    cal, jcal = load_calibration(), jax_load_calibration()
    for B in (2.0, 5.0, 11.3):
        for V in (0.8, 0.9, 1.02):
            for n in (0.15, 0.3, 0.5):
                assert aging.hci_gamma(B, V, n) == jaging.hci_gamma(B, V, n)
                for num in (16, 257):
                    assert aging.hci_gamma(B, V, n, num) == \
                        jaging.hci_gamma(B, V, n, num)
    for idx in range(N_POP):
        for V, t, rate in ((0.9, 3.15e8, 0.5), (1.02, 1e5, 0.01)):
            assert aging.dc_shift(cal.aging, idx, V, t, rate) == \
                pytest.approx(jaging.dc_shift(jcal.aging, idx, V, t, rate),
                              rel=SHIFT_RTOL)


# --------------------------------------------------------------------------- #
# the co-simulation with recovery and thermal feedback
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def setup():
    jcal, cal = jax_load_calibration(), load_calibration()
    jscn = JaxScenario.from_lifetime_config(jcal.lifetime_cfg).replace(
        lifetime_s=2.0 * YEAR_S)
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=2.0 * YEAR_S)
    jdmax = JaxFaultTolerantPolicy(ber_model=jcal.ber).thresholds(
        jscn, OPERATORS)
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    return jcal, cal, jscn, scn, jdmax, dmax


def _port(setup, util, **kw):
    _, cal, _, scn, _, dmax = setup
    return cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                      util_trace=util, device="cpu", **kw)


def _duty_cycled(E=64, N=4):
    U = np.zeros((E, N), np.float32)
    U[0::3] = 1.0                                 # stressed 1 epoch in 3
    U[:, 1] *= 0.5
    return U


@pytest.mark.parametrize("case", ["recovery", "thermal", "both",
                                  "swept"])
def test_cosim_recovery_and_thermal_match_reference(setup, case):
    """Replayed duty (idle windows relax the pool; the thermal node follows
    routed power): supplies equal the reference's, shifts, the relaxed
    pool and the node temperature within SHIFT_RTOL."""
    rp = RecoveryParams.default()
    kw = {"recovery": {"recovery_dynamics": True},
          "thermal": {"thermal": True},
          "both": {"recovery_dynamics": True, "thermal": True},
          "swept": {"recovery_dynamics": RecoveryParams(
              rho=rp.rho * 0.5, k_relax=rp.k_relax * 2.0,
              k_retrap=rp.k_retrap * 3.0),
              "thermal": ThermalParams.from_power_model(
                  load_calibration().power, r_th=5.0, tau_s=7200.0)}}[case]
    jkw = dict(kw)
    if "swept" == case:
        jrp = jaging.RecoveryParams.default()
        jkw["recovery_dynamics"] = jaging.RecoveryParams(
            rho=jrp.rho * 0.5, k_relax=jrp.k_relax * 2.0,
            k_retrap=jrp.k_retrap * 3.0)
    jcal, cal, jscn, scn, jdmax, dmax = setup
    U = _duty_cycled()
    want = jax_cosimulate(jcal.aging, jcal.delay_poly, jscn, jdmax, None,
                          util_trace=jnp.asarray(U),
                          **{k: (JaxThermalParams(**{
                              f: getattr(v, f)
                              for f in ThermalParams._FIELDS})
                              if isinstance(v, ThermalParams) else v)
                             for k, v in jkw.items()})
    got = cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                     util_trace=U, device="cpu", **kw)
    np.testing.assert_array_equal(got.V, np.asarray(want.V))
    for f in ("dv", "dvp", "dvn", "delay", "rec", "t_node"):
        w = getattr(want, f)
        assert (w is None) == (getattr(got, f) is None), f
        if w is not None:
            np.testing.assert_allclose(getattr(got, f), np.asarray(w),
                                       rtol=SHIFT_RTOL, atol=1e-5,
                                       err_msg=f)


def test_always_stressed_pool_collapses_onto_the_monotone_run(setup):
    """Fully stressed: the pool stays exactly empty and the run equals the
    run without recovery dynamics, as in the reference."""
    U = np.ones((48, 4), np.float32)
    off = _port(setup, U)
    on = _port(setup, U, recovery_dynamics=True)
    assert not on.rec.any() and off.rec is None
    for f in ("V", "dvp", "dvn", "dv", "delay"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))


def test_idle_windows_relax_effective_wear_only(setup):
    E = 64
    U = np.zeros((E, 4), np.float32)
    U[0::3] = 1.0
    off = _port(setup, U)
    on = _port(setup, U, recovery_dynamics=True)
    np.testing.assert_allclose(on.dv, off.dv, atol=1e-5)
    assert (on.dvp <= off.dvp + 1e-5).all()
    assert on.dvp[-2].max() < 0.9 * off.dvp[-2].max()
    rho_max = float(RecoveryParams.default().rho.max())
    assert (on.dvp >= (1.0 - rho_max) * off.dvp - 1e-4).all()
    rec_tot = (on.rec * IS_PMOS).sum(-1)
    np.testing.assert_allclose(off.dvp - on.dvp, rec_tot, atol=2e-3)


def test_thermal_node_is_bounded_and_monotone_in_power(setup):
    """The reference's thermal-node tests on the port (1-year horizon):
    dissipation only heats, the fixed point is bounded and settles, and
    the node is monotone in routed power."""
    _, cal, _, scn, _, dmax = setup
    scn = scn.replace(lifetime_s=1.0 * YEAR_S)
    run = lambda u: cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                               util_trace=np.full((48, 4), u, np.float32),
                               thermal=True, device="cpu").t_node
    tn, lo, hi = run(1.0), run(0.2), run(0.9)
    t_amb = float(scn.t_amb)
    assert np.isfinite(tn).all() and (tn >= t_amb - 1e-3).all()
    assert tn.max() < t_amb + 60.0
    assert abs(tn[-1].max() - tn[-2].max()) < 0.1
    assert (hi >= lo - 1e-4).all()
    assert hi[-1].max() > lo[-1].max() + 1.0
    assert ThermalParams.from_power_model(cal.power).v0 == \
        pytest.approx(0.9)
