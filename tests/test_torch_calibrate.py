"""The port's physics calibration vs the JAX reference on the CPU:
``calibrate_aging`` (bit for bit, and equal to the checked-in artifact),
``PathModel`` and ``fit_delay_polynomial`` (the checked-in polynomial
reproduced bit for bit), ``solve_ber_model``, ``calibrate_power``,
``verify_table1`` (Table I within the reference tests' 1 %) and the
equivalent-waveform module.  ``calibrate.main`` as a whole (a Nelder-Mead
search over ~400 lifetimes) is not run here: too slow on the CPU."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ber as jber
from repro.core import calibrate as jcal
from repro.core import delay as jdelay
from repro.core import power as jpower
from repro.core import waveform as jwave
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.avs import run_lifetime as jax_run_lifetime
from repro_torch.core import ber, calibrate, delay, power, waveform
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.avs import run_lifetime

ROOT = Path(__file__).resolve().parents[1]
RAW = json.loads((ROOT / "src" / "repro_torch" / "core"
                  / "calibrated.json").read_text())
# float32 transcendentals of the backends (torch's pow/exp/log against
# XLA's): the waveform recursions agree to this
WAVE_RTOL = 1e-5
# the lifetime simulator's known float32 drift against XLA (ROADMAP §C)
SHIFT_RTOL = 1e-5


def test_calibrate_aging_matches_reference_and_artifact():
    got = calibrate.calibrate_aging(device="cpu")
    want = jcal.calibrate_aging()
    for f in ("A", "B", "Ea", "n", "chi"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(RAW["aging"][f], np.float32), f)
    assert got.to_dict() == {**RAW["aging"],
                             "dT_sh": RAW["aging"]["dT_sh"]}


def test_path_model_and_fit_reproduce_the_artifact():
    pm = delay.PathModel.from_dict(RAW["path_model"])
    jpm = jdelay.PathModel.from_dict(RAW["path_model"])
    V = np.linspace(0.88, 1.06, 64)
    dp = np.linspace(0.0, 0.15, 64)
    np.testing.assert_array_equal(
        pm.stage_delay(V, dp, dp[::-1].copy()).numpy(),
        np.asarray(jpm.stage_delay(jnp.asarray(V), jnp.asarray(dp),
                                   jnp.asarray(dp[::-1].copy()))))
    np.testing.assert_array_equal(pm.path_weights(), jpm.path_weights())
    assert pm.to_dict() == RAW["path_model"]
    poly = delay.fit_delay_polynomial(pm)
    assert poly.to_dict() == RAW["delay_poly"]
    assert len(delay._monomial_exponents()) == 84
    assert delay._monomial_exponents() == jdelay._monomial_exponents()
    # a second path model, held against the reference's fit
    other = dict(RAW["path_model"], alpha=1.45, wire_frac=0.3)
    got = delay.fit_delay_polynomial(delay.PathModel.from_dict(other))
    want = jdelay.fit_delay_polynomial(jdelay.PathModel.from_dict(other))
    np.testing.assert_array_equal(got.coeffs.numpy(),
                                  np.asarray(want.coeffs))
    assert got.rmse == want.rmse


def test_solve_ber_model_matches_reference_and_artifact():
    tols = calibrate.tolerable_bers(max_loss_pct=0.5)
    anchors = {RAW["dmax_targets"][op]: tols[op] for op in ("o", "down", "k")}
    got = ber.solve_ber_model(anchors)
    assert got.to_dict() == jber.solve_ber_model(anchors).to_dict()
    assert got.to_dict() == RAW["ber"]
    bm, resid = calibrate.calibrate_ber(RAW["dmax_targets"], 1.6e-9)
    jbm, jresid = jcal.calibrate_ber(RAW["dmax_targets"], 1.6e-9)
    assert bm.to_dict() == jbm.to_dict()
    assert resid == pytest.approx(jresid, abs=1e-6)
    with pytest.raises(ValueError, match="saturation"):
        ber.solve_ber_model(anchors, sat_cap=1e-9)


@pytest.fixture(scope="module")
def trajs():
    """The nominal (0.90 V, recovery) and classical-AVS lifetimes of the
    checked-in calibration, on the port."""
    cal = load_calibration()
    cfg = cal.lifetime_cfg
    nom = run_lifetime(cal.aging, cal.delay_poly, cfg, recovery=True,
                       avs_enabled=False, device="cpu")
    avs = run_lifetime(cal.aging, cal.delay_poly, cfg, delay_max=cfg.t_clk,
                       recovery=True, device="cpu")
    return ({k: np.asarray(v) for k, v in nom.items()},
            {k: np.asarray(v) for k, v in avs.items()})


def test_calibrate_power_matches_reference_and_artifact(trajs):
    nom, avs = trajs
    got = power.calibrate_power(nom, avs, 0.85, 1.03)
    want = jpower.calibrate_power(nom, avs, 0.85, 1.03)
    assert got.p_dyn0 == pytest.approx(want.p_dyn0, rel=1e-6)
    assert got.p_leak0 == pytest.approx(want.p_leak0, rel=1e-6)
    assert got.p_dyn0 == pytest.approx(RAW["power"]["p_dyn0"], rel=1e-5)
    assert got.p_leak0 == pytest.approx(RAW["power"]["p_leak0"], rel=1e-5)
    # the reference's own lifetimes give the same fit
    jc = jax_load_calibration()
    jnom = {k: np.asarray(v) for k, v in jax_run_lifetime(
        jc.aging, jc.delay_poly, jc.lifetime_cfg, recovery=True,
        avs_enabled=False).items()}
    assert power.calibrate_power(jnom, avs).p_dyn0 == pytest.approx(
        got.p_dyn0, rel=1e-5)


def test_verify_table1_within_one_percent():
    """Table I from the port's simulator against the checked-in rows and
    the paper's targets (rows 1-3 within the reference tests' 1 %, row 4
    the prediction within 5 %)."""
    cal = load_calibration()
    rows = calibrate.verify_table1(cal.aging, cal.delay_poly,
                                   cal.lifetime_cfg, device="cpu")
    for row, vals in RAW["table1_check"].items():
        for k, v in vals.items():
            assert rows[row][k] == pytest.approx(v, rel=SHIFT_RTOL,
                                                 abs=1e-6), (row, k)
    targets = {"nom_norec": dict(pmos_total=82.0, nmos=50.5, pmos_hci=19.8,
                                 pmos_bti=62.2),
               "nom_rec": dict(pmos_total=73.1, nmos=46.1),
               "vmax_norec": dict(pmos_total=130.7, nmos=105.2,
                                  pmos_hci=27.3, pmos_bti=103.4)}
    for row, vals in targets.items():
        for k, v in vals.items():
            assert rows[row][k] == pytest.approx(v, rel=0.01), (row, k)
    assert rows["avs"]["pmos_total"] == pytest.approx(105.3, rel=0.05)
    assert rows["avs"]["v_final"] == pytest.approx(1.02, abs=0.005)


def test_find_delay_max_bisection_step():
    """One threshold of step 3 against the reference's bisection, cut to
    a short lifetime grid so it runs in seconds."""
    cal = load_calibration()
    jc = jax_load_calibration()
    cfg = calibrate.LifetimeConfig(n_steps=48)
    got = calibrate.find_delay_max_for_vfinal(cal.aging, cal.delay_poly,
                                              cfg, 0.99, device="cpu")
    want = jcal.find_delay_max_for_vfinal(jc.aging, jc.delay_poly,
                                          jcal.LifetimeConfig(n_steps=48),
                                          0.99)
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("duty", [0.3, 0.5, 0.7])
def test_waveform_matches_reference(duty):
    mp, jmp = waveform.MicroTrapParams(), jwave.MicroTrapParams()
    V, period, n = 0.95, 1e-3, 48
    np.testing.assert_allclose(
        waveform.simulate_cycles(mp, V, duty, period, 0.0, n,
                                 device="cpu").numpy(),
        np.asarray(jwave.simulate_cycles(jmp, V, duty, period, 0.0, n)),
        rtol=WAVE_RTOL)
    assert float(waveform.extrapolate(mp, V, duty, period, 800 * period,
                                      device="cpu")) == pytest.approx(
        float(jwave.extrapolate(jmp, V, duty, period, 800 * period)),
        rel=WAVE_RTOL)
    assert float(waveform.ac_factor_empirical(
        mp, V, duty, period, 64, device="cpu")) == pytest.approx(
        float(jwave.ac_factor_empirical(jmp, V, duty, period, 64)),
        rel=WAVE_RTOL)
    x = np.linspace(1.0, 50.0, 16, dtype=np.float32)
    for got, want in (
            (waveform.f_trapping(mp, x, V, 10.0),
             jwave.f_trapping(jmp, jnp.asarray(x), V, 10.0)),
            (waveform.f_detrapping(mp, x, 0.1, 5.0, V),
             jwave.f_detrapping(jmp, jnp.asarray(x), 0.1, 5.0, V)),
            (waveform.equivalent_stress_voltage(mp, x, 10.0),
             jwave.equivalent_stress_voltage(jmp, jnp.asarray(x), 10.0)),
            (waveform.equivalent_recovery_voltage(mp, x, 0.8 * x, 10.0, V),
             jwave.equivalent_recovery_voltage(
                 jmp, jnp.asarray(x), jnp.asarray(0.8 * x), 10.0, V))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=WAVE_RTOL)


def test_waveform_extrapolation_tracks_explicit_cycles():
    """The reference's own check on the port: the equivalent-waveform
    iteration within 25 % of 4096 explicit cycles, both below the DC
    (no-recovery) bound; the AC factor below one and rising with duty."""
    mp = waveform.MicroTrapParams()
    V, duty, period, n = 0.9, 0.5, 1e-4, 4096
    explicit = float(waveform.simulate_cycles(mp, V, duty, period, 0.0, n,
                                              device="cpu")[-1])
    extrap = float(waveform.extrapolate(mp, V, duty, period, n * period,
                                        n_base=16, device="cpu"))
    dc = float(waveform.f_trapping(mp, 0.0, V, n * period))
    assert explicit > 0
    assert abs(extrap - explicit) / explicit < 0.25, (extrap, explicit)
    assert explicit < dc and extrap < dc
    prev = 0.0
    for d in (0.25, 0.5, 0.75):
        r = float(waveform.ac_factor_empirical(mp, 0.9, d, 1e-4, 2048,
                                               device="cpu"))
        assert prev < r < 1.0
        prev = r
