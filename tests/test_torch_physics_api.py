"""The rest of the port's physics API vs the JAX reference on the CPU:
scenario grids and stacks, the ``Scenario`` / ``LifetimeTrajectory``
methods, the policy registry, ``sweep_policy``, the scalar policy, power,
BER and resilience helpers, ``per_population_finals``,
``AgingAwareRuntime``; and the paper-table benchmarks
(``repro_torch.benchmarks``) and the lifetime study
(``repro_torch.examples.lifetime_study``) against the reference's."""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's benchmarks are a namespace package at the repository root
ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import fig5_curves as jax_fig5  # noqa: E402
from benchmarks import table1_aging as jax_table1
from benchmarks import table2_policy as jax_table2
from repro.configs import get_config as jax_get_config
from repro.core import avs as jax_avs
from repro.core import policy as jax_policy
from repro.core import resilience as jax_resilience
from repro.core import scenario as jax_scenario
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.power import batched_lifetime_stats as jax_lifetime_stats
from repro.core.runtime import AgingAwareRuntime as JaxAgingAwareRuntime
from repro_torch.benchmarks import fig5_curves, table1_aging, table2_policy
from repro_torch.configs import get_config
from repro_torch.core import avs, policy, resilience, scenario
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.power import batched_lifetime_stats
from repro_torch.core.runtime import AgingAwareRuntime
from repro_torch.examples import lifetime_study

# float32 exp/log/pow differ from XLA's by an ulp here and there; the trap
# populations integrate that drift over the grid (ROADMAP §C, known drift)
SHIFT_RTOL = 1e-5
# the BERs: the curve is steep in delay, so delay drift of ~1e-7 becomes
# ~1e-4 (ROADMAP §C)
BER_RTOL = 1e-3
# float32 power: pow / exp of the leakage term against XLA's
POWER_RTOL = 1e-6
GRID = dict(max_loss_pct=[0.1, 0.5, 1.0, 2.0], duty=[0.3, 0.5, 0.7])
SHORT = dict(n_steps=48)          # a coarse grid keeps the sweeps quick


@pytest.fixture(scope="module")
def cals():
    return jax_load_calibration(), load_calibration()


def _leaves(scn):
    return {f: np.asarray(getattr(scn, f)) for f in scenario.SCENARIO_FIELDS}


def _assert_same_scenario(got, want):
    assert got.batch_shape == tuple(want.batch_shape)
    assert got.n_scenarios == want.n_scenarios
    assert (got.n_steps, got.max_boosts_per_step) == \
        (want.n_steps, want.max_boosts_per_step)
    g, w = _leaves(got), _leaves(want)
    for f in scenario.SCENARIO_FIELDS:
        assert g[f].shape == w[f].shape, f
        np.testing.assert_array_equal(g[f].astype(np.float32),
                                      w[f].astype(np.float32), err_msg=f)


def _assert_same_traj(got, want):
    assert got.batch_shape == tuple(want.batch_shape)
    assert got.n_steps == want.n_steps
    np.testing.assert_array_equal(got.V, np.asarray(want.V))
    for k in ("t", "delay", "dvp", "dvn", "dv"):
        np.testing.assert_allclose(getattr(got, k),
                                   np.asarray(getattr(want, k)),
                                   rtol=SHIFT_RTOL, err_msg=k)


# --------------------------------------------------------------------------- #
# scenarios
# --------------------------------------------------------------------------- #
def test_scenario_grid_matches_reference():
    """Swept leaves ``(4, 1)`` / ``(1, 3)``, the rest scalar; batch shape
    and count of the grid; unknown fields raise."""
    got = scenario.scenario_grid(**GRID)
    want = jax_scenario.scenario_grid(**GRID)
    _assert_same_scenario(got, want)
    assert got.batch_shape == (4, 3) and got.n_scenarios == 12
    assert tuple(got.max_loss_pct.shape) == (4, 1)
    based = scenario.scenario_grid(scenario.Scenario.nominal(t_amb=310.0),
                                   duty=[0.2, 0.4])
    _assert_same_scenario(based, jax_scenario.scenario_grid(
        jax_scenario.Scenario.nominal(t_amb=310.0), duty=[0.2, 0.4]))
    with pytest.raises(ValueError, match="unknown scenario field"):
        scenario.scenario_grid(dutty=[0.1])


def test_scenario_methods_match_reference():
    """``broadcast_leaves`` / ``reshape`` / ``__getitem__`` / ``nominal``
    / ``to_dict`` / ``n_scenarios``, on a grid and a scalar scenario."""
    got = scenario.scenario_grid(**GRID)
    want = jax_scenario.scenario_grid(**GRID)
    _assert_same_scenario(got.broadcast_leaves(), want.broadcast_leaves())
    _assert_same_scenario(got.broadcast_leaves((2, 4, 3)),
                          want.broadcast_leaves((2, 4, 3)))
    _assert_same_scenario(got.reshape((12,)), want.reshape((12,)))
    _assert_same_scenario(got.reshape((3, 2, 2)), want.reshape((3, 2, 2)))
    for idx in (1, (slice(1, 3), 2), (-1, slice(None))):
        _assert_same_scenario(got[idx], want[idx])
    nom = scenario.Scenario.nominal(duty=0.4, n_steps=100)
    jnom = jax_scenario.Scenario.nominal(duty=0.4, n_steps=100)
    _assert_same_scenario(nom, jnom)
    assert nom.n_scenarios == jnom.n_scenarios == 1
    assert nom.to_dict() == jnom.to_dict()
    assert got.to_dict() == want.to_dict()


def test_stack_scenarios_matches_reference():
    kws = [dict(duty=0.3), dict(duty=0.5, t_amb=320.0),
           dict(max_loss_pct=2.0)]
    got = scenario.stack_scenarios([scenario.Scenario(**k) for k in kws])
    want = jax_scenario.stack_scenarios(
        [jax_scenario.Scenario(**k) for k in kws])
    _assert_same_scenario(got, want)
    grids = [scenario.scenario_grid(duty=[0.3, 0.6]),
             scenario.scenario_grid(duty=[0.4, 0.7])]
    jgrids = [jax_scenario.scenario_grid(duty=[0.3, 0.6]),
              jax_scenario.scenario_grid(duty=[0.4, 0.7])]
    _assert_same_scenario(scenario.stack_scenarios(grids, axis=1),
                          jax_scenario.stack_scenarios(jgrids, axis=1))
    with pytest.raises(ValueError, match="static structure"):
        scenario.stack_scenarios([scenario.Scenario(),
                                  scenario.Scenario(n_steps=10)])
    with pytest.raises(ValueError, match="at least one"):
        scenario.stack_scenarios([])


@pytest.fixture(scope="module")
def trajs(cals):
    """A (2, 3) batch (budget x duty) at one delay threshold past the
    clock, simulated by both sides on a 48-point grid."""
    jc, pc = cals
    grid = dict(max_loss_pct=[0.1, 2.0], duty=[0.3, 0.5, 0.7])
    jscn = jax_scenario.scenario_grid(
        jax_scenario.Scenario.from_lifetime_config(jc.lifetime_cfg, **SHORT),
        **grid)
    pscn = scenario.scenario_grid(
        scenario.Scenario.from_lifetime_config(pc.lifetime_cfg, **SHORT),
        **grid)
    want = jax_avs.simulate(jc.aging, jc.delay_poly, jscn,
                            delay_max=jnp.float32(1.63e-9))
    got = avs.simulate(pc.aging, pc.delay_poly, pscn, delay_max=1.63e-9,
                       device="cpu")
    return got, want


def test_trajectory_methods_match_reference(trajs):
    """``n_steps``, ``to_dict`` / ``from_dict``, ``reshape``, ``final``,
    ``at_age`` (a scalar age and one per cell) and ``__getitem__``."""
    got, want = trajs
    _assert_same_traj(got, want)
    assert got.n_steps == 48
    again = scenario.LifetimeTrajectory.from_dict(got.to_dict())
    for k in again.to_dict():
        np.testing.assert_array_equal(getattr(again, k), getattr(got, k))
    _assert_same_traj(got.reshape((6,)), want.reshape((6,)))
    _assert_same_traj(got[1], want[1])
    gf, wf = got.final(), want.final()
    assert set(gf) == set(wf)
    np.testing.assert_array_equal(gf["v_final"], wf["v_final"])
    for k in ("delay_final", "dvp", "dvn", "dv"):
        assert gf[k].shape == wf[k].shape, k
        np.testing.assert_allclose(gf[k], wf[k], rtol=SHIFT_RTOL, err_msg=k)
    ages = np.array([[1e6, 1e7, 1e8], [3e7, 2e8, 3.2e8]])
    for age in (2e7, ages):
        ga, wa = got.at_age(age), want.at_age(age)
        np.testing.assert_array_equal(got.age_index(age),
                                      want.age_index(age))
        np.testing.assert_array_equal(ga["V"], wa["V"])
        for k in ("delay", "dvp", "dvn"):
            np.testing.assert_allclose(ga[k], wa[k], rtol=SHIFT_RTOL,
                                       err_msg=k)


def test_per_population_finals_match_reference(trajs):
    got, want = trajs
    g = avs.per_population_finals(got[0, 1])
    w = jax_avs.per_population_finals(want[0, 1])
    assert list(g) == list(w)
    for name in w:
        assert g[name] == pytest.approx(w[name], rel=SHIFT_RTOL), name


# --------------------------------------------------------------------------- #
# policies
# --------------------------------------------------------------------------- #
def test_policy_registry_matches_reference(cals):
    """``get_policy`` builds the registered policies, whose thresholds
    equal the reference's; a registered custom policy is found by name;
    ``measured`` builds the measured policy; unknown names raise
    ``KeyError``."""
    jc, pc = cals
    assert {"baseline", "fault_tolerant"} <= set(policy.POLICY_REGISTRY)
    grid = scenario.scenario_grid(**GRID)
    jgrid = jax_scenario.scenario_grid(**GRID)
    for name, kw, jkw in (("baseline", {"t_clk": 1.6e-9}, {"t_clk": 1.6e-9}),
                          ("fault_tolerant", {"ber_model": pc.ber},
                           {"ber_model": jc.ber})):
        got = policy.get_policy(name, **kw)
        want = jax_policy.get_policy(name, **jkw)
        assert isinstance(got, policy.Policy) and got.name == want.name
        np.testing.assert_allclose(got.thresholds(grid).numpy(),
                                   np.asarray(want.thresholds(jgrid)),
                                   rtol=SHIFT_RTOL)

    @policy.register_policy
    @dataclasses.dataclass(frozen=True)
    class Fixed:
        name = "fixed_for_test"
        d: float = 1.7e-9

        def thresholds(self, scn, operators=resilience.OPERATORS):
            return torch.full(scn.batch_shape + (len(operators),), self.d)
    try:
        got = policy.get_policy("fixed_for_test", d=1.65e-9)
        assert isinstance(got, policy.Policy)
        assert float(got.thresholds(scenario.Scenario())[0]) == \
            pytest.approx(1.65e-9)
    finally:
        policy.POLICY_REGISTRY.pop("fixed_for_test")
    measured = policy.get_policy("measured", ber_model=pc.ber)
    assert isinstance(measured, policy.MeasuredResiliencePolicy)
    assert measured.model == "llama3_8b"
    with pytest.raises(KeyError, match="registered"):
        policy.get_policy("nonesuch")


def test_scalar_policy_api_matches_reference(cals):
    """``BaselinePolicy.delay_max`` and the fault-tolerant
    ``tolerable_ber`` / ``delay_max`` (Python floats, as the reference's),
    at the default and at a pinned budget."""
    jc, pc = cals
    assert policy.BaselinePolicy(t_clk=1.7e-9).delay_max() == \
        jax_policy.BaselinePolicy(t_clk=1.7e-9).delay_max()
    for budget in (None, 2.0):
        got = policy.FaultTolerantPolicy(ber_model=pc.ber,
                                         max_loss_pct=budget)
        want = jax_policy.FaultTolerantPolicy(ber_model=jc.ber,
                                              max_loss_pct=budget)
        assert got.tolerable_ber() == want.tolerable_ber()
        assert got.delay_max() == want.delay_max()


def test_sweep_policy_matches_reference(cals):
    """One batched simulation over ``grid.batch_shape + (O,)``."""
    jc, pc = cals
    jscn = jax_scenario.Scenario.from_lifetime_config(jc.lifetime_cfg,
                                                      **SHORT)
    pscn = scenario.Scenario.from_lifetime_config(pc.lifetime_cfg, **SHORT)
    grid = dict(max_loss_pct=[0.1, 2.0], duty=[0.3, 0.7])
    want = jax_policy.sweep_policy(
        jax_policy.FaultTolerantPolicy(ber_model=jc.ber), jc.aging,
        jc.delay_poly, jax_scenario.scenario_grid(jscn, **grid))
    got = policy.sweep_policy(policy.FaultTolerantPolicy(ber_model=pc.ber),
                              pc.aging, pc.delay_poly,
                              scenario.scenario_grid(pscn, **grid),
                              device="cpu")
    assert got.batch_shape == (2, 2, len(resilience.OPERATORS))
    _assert_same_traj(got, want)


# --------------------------------------------------------------------------- #
# power, BER, resilience, runtime
# --------------------------------------------------------------------------- #
def test_power_model_api_matches_reference(cals):
    jc, pc = cals
    rng = np.random.default_rng(0)
    V = rng.uniform(0.85, 1.05, size=(5, 7)).astype(np.float32)
    dvp = rng.uniform(0, 120, size=(5, 7)).astype(np.float32)
    dvn = rng.uniform(0, 90, size=(5, 7)).astype(np.float32)
    act = rng.uniform(0, 1, size=(7,)).astype(np.float32)
    for g, w in zip(pc.power.power_split(V, dvp, dvn),
                    jc.power.power_split(jnp.asarray(V), jnp.asarray(dvp),
                                         jnp.asarray(dvn))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=POWER_RTOL)
    np.testing.assert_allclose(
        pc.power.power_at_activity(V, dvp, dvn, act).numpy(),
        np.asarray(jc.power.power_at_activity(
            jnp.asarray(V), jnp.asarray(dvp), jnp.asarray(dvn),
            jnp.asarray(act))), rtol=POWER_RTOL)
    np.testing.assert_array_equal(
        pc.power.power(V, dvp, dvn).numpy(),
        sum(pc.power.power_split(V, dvp, dvn)).numpy())
    assert pc.power.to_dict() == jc.power.to_dict()
    assert type(pc.power).from_dict(pc.power.to_dict()) == pc.power


def test_ber_and_resilience_helpers_match_reference(cals):
    """``delay_max_for_ber`` (below, inside and above saturation),
    ``BerModel.to_dict``, ``tolerable_bers`` and the curve's
    ``accuracy_loss`` / ``tolerable_ber``: Python floats, equal."""
    jc, pc = cals
    for tol in (1e-12, 1e-7, 3e-6, 1e-4, 1e-2, 0.0):
        assert pc.ber.delay_max_for_ber(tol) == \
            jc.ber.delay_max_for_ber(tol)
    assert pc.ber.to_dict() == jc.ber.to_dict()
    np.testing.assert_allclose(
        pc.ber.delay_for_ber(torch.tensor([1e-7, 3e-6])).numpy(),
        [pc.ber.delay_max_for_ber(t) for t in (1e-7, 3e-6)], rtol=1e-6)
    for budget in (0.1, 0.5, 2.0):
        assert resilience.tolerable_bers(max_loss_pct=budget) == \
            jax_resilience.tolerable_bers(max_loss_pct=budget)
        ops = resilience.FAMILY_OPERATORS["moe"]
        assert resilience.tolerable_bers(resilience.default_curves(ops),
                                         budget) == \
            jax_resilience.tolerable_bers(jax_resilience.default_curves(ops),
                                          budget)
    curve = resilience.ResilienceCurve(ber50=2e-5, steepness=3.0)
    jcurve = jax_resilience.ResilienceCurve(ber50=2e-5, steepness=3.0)
    for ber in (0.0, 1e-9, 2e-5, 1e-3, 0.5):
        assert curve.accuracy_loss(ber) == jcurve.accuracy_loss(ber)
    for loss in (0.0, 0.5, 50.0, 100.0):
        assert curve.tolerable_ber(loss) == jcurve.tolerable_ber(loss)


@pytest.mark.parametrize("arch", [None, "qwen3_moe_235b"])
def test_aging_aware_runtime_matches_reference(arch):
    """The one-device runtime aged 9 years (and ``for_model``'s domains):
    its BERs, power and domain state against the reference's."""
    if arch is None:
        got, want = AgingAwareRuntime(device="cpu"), JaxAgingAwareRuntime()
    else:
        got = AgingAwareRuntime.for_model(get_config(arch), device="cpu")
        want = JaxAgingAwareRuntime.for_model(jax_get_config(arch))
    got.set_age(years=9.0)
    want.set_age(years=9.0)
    assert got.operators == tuple(want.operators)
    gb, wb = got.op_bers(), want.op_bers()
    assert list(gb) == list(wb)
    for op in wb:
        assert gb[op] == pytest.approx(wb[op], rel=BER_RTOL), op
    assert got.total_power() == pytest.approx(want.total_power(),
                                              rel=SHIFT_RTOL)
    assert got.domain_state("o").v_dd == want.domain_state("o").v_dd
    base = AgingAwareRuntime(fault_tolerant=False, device="cpu")
    base.set_age(years=9.0)
    assert base.policy.name == "baseline"


# --------------------------------------------------------------------------- #
# the paper-table benchmarks and the lifetime study
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bench", [(table1_aging, jax_table1),
                                   (table2_policy, jax_table2),
                                   (fig5_curves, jax_fig5)],
                         ids=["table1_aging", "table2_policy", "fig5_curves"])
def test_paper_benchmarks_pass_and_match_reference(bench):
    """Every check of the ported benchmark passes on the CPU, and its
    printed table and checks are the reference benchmark's, line for
    line."""
    port, ref = bench
    res = port.evaluate(device="cpu")
    assert res["checks"] and all(c["ok"] for c in res["checks"]), \
        [c for c in res["checks"] if not c["ok"]]
    assert "[FAIL]" not in res["text"]
    assert res["text"].splitlines() == ref.run().splitlines()


def test_benchmarks_default_to_the_card(monkeypatch, capsys):
    """``--device`` defaults to cuda and raises without one; ``--device
    cpu`` prints the table and exits 0 when every check passes."""
    from repro_torch.benchmarks import common
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.main(table1_aging.evaluate, table1_aging.__doc__, [])
    assert common.main(table1_aging.evaluate, table1_aging.__doc__,
                       ["--device", "cpu"]) == 0
    assert "[PASS] AVS V trajectory" in capsys.readouterr().out


def test_lifetime_study_matches_reference(cals):
    """The study's 4 x 3 budget x duty sweep of every domain, its
    baseline and its clock-guardband sweep against the reference's calls
    (the example's own), at the full 480-point grid."""
    jc, _ = cals
    got = lifetime_study.study(device="cpu")
    base = jax_scenario.Scenario.from_lifetime_config(jc.lifetime_cfg)
    grid = jax_scenario.scenario_grid(base, max_loss_pct=list(
        lifetime_study.BUDGETS), duty=list(lifetime_study.DUTIES))
    want = jax_policy.sweep_policy(
        jax_policy.FaultTolerantPolicy(ber_model=jc.ber), jc.aging,
        jc.delay_poly, grid)
    want_base = jax_policy.sweep_policy(
        jax_policy.BaselinePolicy(t_clk=jc.lifetime_cfg.t_clk), jc.aging,
        jc.delay_poly, jax_scenario.scenario_grid(
            base, duty=list(lifetime_study.DUTIES)))
    tclks = jnp.asarray(lifetime_study.T_CLKS)
    want_g = jax_avs.simulate(jc.aging, jc.delay_poly,
                              base.replace(t_clk=tclks), delay_max=tclks)
    assert got["traj"].batch_shape == (4, 3, len(resilience.OPERATORS))
    _assert_same_traj(got["traj"], want)
    _assert_same_traj(got["base_traj"], want_base)
    _assert_same_traj(got["guardband"], want_g)
    ws = jax_lifetime_stats(jc.power, want)
    wb = jax_lifetime_stats(jc.power, want_base)
    np.testing.assert_allclose(
        got["saving"], 100.0 * (1.0 - ws["p_avg"] / wb["p_avg"][None]),
        rtol=1e-4)
    assert got["stats"]["p_avg"].shape == (4, 3, len(resilience.OPERATORS))
    np.testing.assert_allclose(
        got["stats"]["p_avg"], batched_lifetime_stats(
            load_calibration().power, got["traj"])["p_avg"], rtol=0)
