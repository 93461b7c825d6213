"""The port's physics core (repro_torch.core) vs the JAX reference, the
paper's Table I/II at the reference tests' tolerances, and the port's
isolation from jax and from the reference package."""
import ast
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.core.policy import FaultTolerantPolicy as JaxFaultTolerantPolicy
from repro.core.policy import evaluate_policy as jax_evaluate_policy
from repro_torch import device as pdevice
from repro_torch.core.artifacts import CAL_PATH, load_calibration
from repro_torch.core.avs import final_shifts, run_lifetime
from repro_torch.core.constants import V_MAX, V_NOM
from repro_torch.core.fleet import FleetRuntime
from repro_torch.core.policy import (BaselinePolicy, FaultTolerantPolicy,
                                     evaluate_policy)

ROOT = Path(__file__).resolve().parents[1]
# paper Table II: op -> (V_final, dvp, dvn, power saving %)
TABLE2 = {
    "q": (0.90, 73.1, 46.1, 17.0), "k": (0.94, 79.0, 52.1, 14.3),
    "v": (0.90, 73.1, 46.1, 17.0), "qkt": (0.90, 73.1, 46.1, 17.0),
    "sv": (0.90, 73.1, 46.1, 17.0), "o": (1.01, 99.7, 77.8, 3.1),
    "gate": (0.90, 73.1, 46.1, 17.0), "up": (0.90, 73.1, 46.1, 17.0),
    "down": (0.99, 90.8, 66.7, 7.8),
}
# float32 exp/log/pow differ from XLA's by an ulp here and there; the
# trap populations integrate that drift over 480 steps
SHIFT_RTOL = 1e-5


@pytest.fixture(scope="module")
def cal():
    return load_calibration()


@pytest.fixture(scope="module")
def port_results(cal):
    return evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber), cal.aging,
                           cal.delay_poly, cal.power, cal.lifetime_cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def jax_results():
    jc = jax_load_calibration()
    return jax_evaluate_policy(JaxFaultTolerantPolicy(ber_model=jc.ber),
                               jc.aging, jc.delay_poly, jc.power,
                               jc.lifetime_cfg)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("op", list(TABLE2) + ["baseline"])
def test_simulate_matches_reference(op, port_results, jax_results):
    """V trajectory exact (a discrete decision per step); shifts, delay and
    the time grid within float32 drift."""
    jt, pt = jax_results[op]["traj"], port_results[op]["traj"]
    V_j, V_p = np.asarray(jt["V"]), pt["V"]
    if not np.array_equal(V_j, V_p):
        i = int(np.argmax(V_j != V_p))
        pytest.fail(f"{op}: V differs first at step {i}: {V_j[i]} vs "
                    f"{V_p[i]}; delay {pt['delay'][i]} vs delay_max "
                    f"{port_results[op].get('delay_max')}")
    for k in ("dvp", "dvn", "delay", "t"):
        np.testing.assert_allclose(pt[k], np.asarray(jt[k]),
                                   rtol=SHIFT_RTOL, err_msg=k)
    for k in ("v_eff", "p_avg"):
        assert port_results[op][k] == pytest.approx(jax_results[op][k],
                                                    rel=1e-6)


def test_final_voltages_match_table2(port_results):
    for op, (vf, *_r) in TABLE2.items():
        assert port_results[op]["v_final"] == pytest.approx(vf, abs=0.015)


def test_vth_shifts_match_table2(port_results):
    for op, (_vf, dvp, dvn, _s) in TABLE2.items():
        assert port_results[op]["dvp_final"] == pytest.approx(dvp, rel=0.05)
        assert port_results[op]["dvn_final"] == pytest.approx(dvn, rel=0.13)


def test_power_savings_match_table2(port_results):
    for op, (*_x, saving) in TABLE2.items():
        assert port_results[op]["power_saving_pct"] == \
            pytest.approx(saving, abs=2.5), op
    assert port_results["avg_power_saving_pct"] == pytest.approx(14.0,
                                                                 abs=2.0)


def test_max_aging_reduction_claims(port_results):
    base = port_results["baseline"]
    best_p = min(port_results[op]["dvp_final"] for op in TABLE2)
    best_n = min(port_results[op]["dvn_final"] for op in TABLE2)
    assert 1 - best_p / base["dvp_final"] == pytest.approx(0.306, abs=0.05)
    assert 1 - best_n / base["dvn_final"] == pytest.approx(0.458, abs=0.06)


def test_policy_thresholds(cal):
    """O and Down are the most error-sensitive (tightest delay_max); the
    tolerant group never reaches its threshold; classical AVS is t_clk."""
    scn = cal.lifetime_cfg.scenario()
    d = dict(zip(TABLE2, FaultTolerantPolicy(ber_model=cal.ber)
                 .thresholds(scn, tuple(TABLE2)).tolist()))
    assert d["o"] == min(d.values())
    assert d["down"] < d["k"] < d["q"]
    for op in ("q", "v", "qkt", "sv", "gate", "up"):
        assert d[op] == max(d.values())
    base = BaselinePolicy().thresholds(scn, tuple(TABLE2))
    assert torch.all(base == torch.tensor(cal.lifetime_cfg.t_clk,
                                          dtype=torch.float32))


def test_table1_rows_and_avs_staircase(cal):
    """Rows 1-3 of Table I are calibration targets (<1%); row 4 is the
    AVS run, regenerated live: staircase 0.90 -> 1.02 V in ~12 steps."""
    chk = cal.raw["table1_check"]
    targets = {"nom_norec": dict(pmos_total=82.0, nmos=50.5),
               "nom_rec": dict(pmos_total=73.1, nmos=46.1),
               "vmax_norec": dict(pmos_total=130.7, nmos=105.2)}
    for row, vals in targets.items():
        for k, v in vals.items():
            assert chk[row][k] == pytest.approx(v, rel=0.01), (row, k)
    traj = run_lifetime(cal.aging, cal.delay_poly, cal.lifetime_cfg,
                        delay_max=cal.lifetime_cfg.t_clk, device="cpu")
    assert final_shifts(traj)["v_final"] == pytest.approx(V_MAX, abs=0.005)
    V = traj["V"]
    assert V[0] == pytest.approx(V_NOM, abs=1e-6)
    assert np.all(np.diff(V) >= -1e-9)
    assert np.count_nonzero(np.diff(V) > 1e-6) == pytest.approx(12, abs=1)


def test_delay_polynomial(cal):
    d0 = float(cal.delay_poly(0.0, 0.0, V_NOM))
    assert d0 == pytest.approx(1.542e-9, rel=0.01)
    assert float(cal.delay_poly(0.08, 0.05, V_NOM)) > d0
    assert float(cal.delay_poly(0.0, 0.0, 1.0)) < d0


def test_fleet_age9_bers_match_reference():
    """The steep BER curve amplifies float32 delay drift ~100x."""
    jf = JaxFleetRuntime(n_devices=1)
    jf.set_age(years=9.0)
    pf = FleetRuntime(n_devices=1, device="cpu")
    pf.set_age(years=9.0)
    jb, pb = jf.op_bers(), pf.op_bers()
    assert set(jb) == set(pb)
    for op in jb:
        assert pb[op] == pytest.approx(jb[op], rel=1e-3), op
    assert pf.total_power() == pytest.approx(jf.total_power(), rel=1e-5)
    view = pf.device(0)
    assert view.age_years == pytest.approx(9.0)
    view.advance(365.25 * 24 * 3600.0)
    assert pf.age_years == pytest.approx(10.0)


# --------------------------------------------------------------------------- #
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRuntime(n_devices=1)
    assert pdevice.resolve_device("cpu").type == "cpu"


def test_calibration_artifact_is_a_byte_identical_copy():
    ref = ROOT / "src" / "repro" / "core" / "calibrated.json"
    assert filecmp.cmp(CAL_PATH, ref, shallow=False)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
