"""The port's traffic-aged fleet vs the JAX reference on the CPU:
``FleetRuntime.apply_load`` (staggered ages, chained calls, measured
``util_trace``), the aging state's round trips (``trap_state``,
``state_dict``, ``resize``), ``health``, the three disruption runs and
the re-mesh planner, and ``FleetServeEngine(router=...)`` on reduced
llama3_8b with three lanes on the fused and three-pass routes."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.core.scenario import Scenario as JaxScenario
from repro.distributed.elastic import plan_remesh_shape as jax_plan
from repro.models import transformer as jax_tf
from repro.obs.health import fleet_health as jax_fleet_health
from repro.sched import disruption as jdisruption
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.core.scenario import Scenario
from repro_torch.data import SyntheticLM
from repro_torch.distributed.elastic import RemeshPlan, plan_remesh_shape
from repro_torch.models.transformer import init_params
from repro_torch.obs.health import eta_to_threshold_s, fleet_health
from repro_torch.sched import disruption
from repro_torch.serve.engine import FleetServeEngine

YEAR_S = 365.25 * 24 * 3600.0
SHIFT_RTOL = 1e-5
BER_RTOL = 1e-3
STAGGER = (1.0, 3.0, 5.0, 7.0)


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


def _fleets(n=4, ages=STAGGER, jax_scenario=None, scenario=None):
    jf = JaxFleetRuntime(n_devices=n, scenario=jax_scenario)
    pf = FleetRuntime(n_devices=n, scenario=scenario, device="cpu")
    for i, age in enumerate(ages):
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    return jf, pf


def _assert_cosim(got, want, rec=False):
    """The parity targets: equal loads, clock and supplies; shifts, delay
    and the pool within SHIFT_RTOL (a fleet resumed from aged devices
    starts from ``simulate``'s state, an ulp apart: ROADMAP §C.3)."""
    np.testing.assert_array_equal(got.load, np.asarray(want.load))
    np.testing.assert_array_equal(got.V, np.asarray(want.V))
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    for f in ("dv", "dvp", "dvn", "delay") + (("rec",) if rec else ()):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   rtol=SHIFT_RTOL, atol=1e-6, err_msg=f)


def _assert_fleet(pf, jf):
    np.testing.assert_array_equal(pf.ages_years, jf.ages_years)
    a, b = pf.snapshot(), jf.snapshot()
    np.testing.assert_array_equal(a.v_dd, b.v_dd)
    for f in ("delay", "dvth_p_mv", "dvth_n_mv", "power_w"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                   rtol=SHIFT_RTOL, err_msg=f)
    np.testing.assert_allclose(pf.op_ber_array(), jf.op_ber_array(),
                               rtol=BER_RTOL)


# --------------------------------------------------------------------------- #
# apply_load
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("router", ["round_robin", "wear_level"])
def test_apply_load_from_staggered_ages_matches_reference(router):
    """A fleet aged 1/3/5/7 years resumes from its per-device state under
    routed diurnal traffic; the serving view then sits at the end of the
    horizon."""
    jf, pf = _fleets()
    kw = dict(workload="diurnal", router=router, n_epochs=36,
              utilization=0.5, horizon_s=2 * YEAR_S)
    want, got = jf.apply_load(**kw), pf.apply_load(**kw)
    _assert_cosim(got, want)
    assert pf.last_cosim is got
    _assert_fleet(pf, jf)
    np.testing.assert_allclose(pf.ages_years, float(got.t[-1]) / YEAR_S)
    # the co-sim starts from (not below) each device's pre-aged state
    pre = FleetRuntime(n_devices=4, device="cpu")
    for i, age in enumerate(STAGGER):
        pre.set_age(years=age, device=i)
    assert (got.dvp[0] >= pre.snapshot().dvth_p_mv - 1e-3).all()
    # the clock rewinds within the horizon
    pf.set_age(seconds=0.0)
    np.testing.assert_allclose(pf.snapshot().dvth_p_mv, got.dvp[0],
                               rtol=1e-6)


def test_apply_load_chained_with_recovery_matches_reference():
    """A second call resumes from the wear the first one left, the second
    with the recovery pool and thermal feedback."""
    jf, pf = _fleets()
    kw = dict(workload="poisson", router="least_aged", n_epochs=24,
              utilization=0.6, horizon_s=YEAR_S)
    jf.apply_load(**kw)
    first = pf.apply_load(**kw)
    kw.update(workload="bursty", key=3, recovery=True, thermal=True)
    want, got = jf.apply_load(**kw), pf.apply_load(**kw)
    _assert_cosim(got, want, rec=True)
    np.testing.assert_allclose(got.t_node, np.asarray(want.t_node),
                               rtol=SHIFT_RTOL)
    assert (got.device_wear()[0] >= first.device_wear()[-1] - 1e-3).all()
    _assert_fleet(pf, jf)
    st, jst = pf.trap_state(), jf.trap_state()
    for k in ("dv", "rec", "v"):
        np.testing.assert_allclose(st[k], jst[k], rtol=SHIFT_RTOL,
                                   atol=1e-6, err_msg=k)


def test_apply_load_util_trace_and_explicit_loads_match_reference():
    U = np.random.default_rng(3).uniform(0, 1, (30, 4)).astype(np.float32)
    U[:, 0] = 0.95
    jf, pf = _fleets()
    want = jf.apply_load(util_trace=U, horizon_s=YEAR_S, recovery=True)
    got = pf.apply_load(util_trace=U, horizon_s=YEAR_S, recovery=True)
    _assert_cosim(got, want, rec=True)
    np.testing.assert_array_equal(got.util, U)
    _assert_fleet(pf, jf)
    loads = np.full(24, 1.0, np.float32)
    jf2, pf2 = _fleets(2, (0.0, 0.0))
    _assert_cosim(pf2.apply_load(loads=loads, router="least_aged"),
                  jf2.apply_load(loads=loads, router="least_aged"))
    with pytest.raises(KeyError, match="unknown workload"):
        pf2.apply_load(workload="nope", n_epochs=8)
    with pytest.raises(KeyError, match="unknown router"):
        pf2.apply_load(loads=loads, router="nope")


# --------------------------------------------------------------------------- #
# the aging state's round trips, resize, health
# --------------------------------------------------------------------------- #
def test_state_dict_round_trip_matches_reference():
    jf, pf = _fleets()
    kw = dict(workload="diurnal", router="round_robin", n_epochs=24,
              horizon_s=YEAR_S, recovery=True)
    jf.apply_load(**kw)
    pf.apply_load(**kw)
    sd, jsd = pf.state_dict(), jf.state_dict()
    assert sd.keys() == jsd.keys() and sd["operators"] == jsd["operators"]
    for k in ("ages_s", "v"):
        np.testing.assert_array_equal(sd[k], jsd[k])
    for k in ("dv_mv", "rec_mv"):
        np.testing.assert_allclose(sd[k], jsd[k], rtol=SHIFT_RTOL, atol=1e-6)
    back = FleetRuntime(n_devices=4, device="cpu")
    back.load_state_dict(json.loads(json.dumps(sd)))
    st, st2 = pf.trap_state(), back.trap_state()
    for k in st:
        np.testing.assert_array_equal(st2[k], st[k].astype(st2[k].dtype))
    # the staged state resumes bit-exactly: the same traffic from both
    nxt = dict(kw, workload="poisson", key=5)
    np.testing.assert_array_equal(back.apply_load(**nxt).dv,
                                  pf.apply_load(**nxt).dv)
    # an artifact without the recoverable pool loads an empty one
    old = {k: v for k, v in sd.items() if k != "rec_mv"}
    back.load_state_dict(old)
    assert not back.trap_state()["rec"].any()
    with pytest.raises(ValueError, match="operator mismatch"):
        back.load_state_dict(dict(sd, operators=["q"]))
    with pytest.raises(ValueError, match="do not fit"):
        FleetRuntime(n_devices=3, device="cpu").load_state_dict(sd)
    with pytest.raises(NotImplementedError, match="n_shards"):
        back.load_state_dict(dict(sd, n_shards=2))


def test_resize_matches_reference_and_survivors_resume_bit_exactly():
    """Retire devices of a rack-gradient fleet and hot-swap one: the
    survivors carry their exact state, the fresh device starts at zero in a
    retired slot's seat; a mid-horizon resize replays the undisturbed
    run's survivors bit for bit."""
    t_amb = (298.15 + np.linspace(0.0, 20.0, 4)).astype(np.float32)
    jf, pf = _fleets(ages=(0, 0, 0, 0),
                     jax_scenario=JaxScenario(t_amb=jnp.asarray(t_amb)),
                     scenario=Scenario(t_amb=torch.from_numpy(t_amb)))
    U = np.ones((16, 4), np.float32)
    jf.apply_load(util_trace=U, horizon_s=YEAR_S, recovery=True)
    pf.apply_load(util_trace=U, horizon_s=YEAR_S, recovery=True)
    jr, pr = jf.resize([1, 2, 3], n_fresh=1), pf.resize([1, 2, 3], n_fresh=1)
    a, b = pr.trap_state(), jr.trap_state()
    np.testing.assert_array_equal(a["ages_s"], b["ages_s"])
    np.testing.assert_array_equal(a["v"], b["v"])
    np.testing.assert_allclose(a["dv"], b["dv"], rtol=SHIFT_RTOL)
    assert not a["dv"][3].any() and not a["rec"][3].any()
    assert a["ages_s"][3] == 0.0 and (a["ages_s"][:3] > 0).all()
    assert float(pr.scenario.t_amb[3]) == pytest.approx(float(t_amb[0]))
    with pytest.raises(ValueError, match="distinct"):
        pf.resize([1, 1])

    E, e, keep = 48, 24, [0, 2, 3]
    U = np.random.default_rng(7).uniform(0, 1, (E, 4)).astype(np.float32)
    H = 2.0 * YEAR_S
    full = FleetRuntime(n_devices=4, device="cpu").apply_load(
        util_trace=U, horizon_s=H, recovery=True)
    cut = FleetRuntime(n_devices=4, device="cpu")
    cut.apply_load(util_trace=U[:e], horizon_s=H * e / E, recovery=True)
    after = cut.resize(keep).apply_load(util_trace=U[e:][:, keep],
                                        horizon_s=H * (E - e) / E,
                                        recovery=True)
    for f in ("dv", "rec", "V"):
        np.testing.assert_array_equal(getattr(after, f),
                                      getattr(full, f)[e:][:, keep])


def test_health_matches_reference():
    jf, pf = _fleets()
    kw = dict(workload="diurnal", router="round_robin", n_epochs=24,
              horizon_s=8 * YEAR_S)
    jf.apply_load(**kw)
    pf.apply_load(**kw)
    h, jh = pf.health(), jax_fleet_health(jf)
    d, jd = h.to_dict(), jh.to_dict()
    assert d["operators"] == jd["operators"] and d["n_shards"] == 1
    for u, ju in zip(d["units"], jd["units"]):
        for k in ("age_years", "v_dd"):
            assert u[k] == ju[k], k
        for k in ("dvth_p_mv", "headroom_ps"):
            assert u[k] == pytest.approx(ju[k], rel=SHIFT_RTOL), k
        assert u["ber"] == pytest.approx(ju["ber"], rel=BER_RTOL)
        assert (u["eta_years"] is None) == (ju["eta_years"] is None)
        if ju["eta_years"] is not None:
            assert u["eta_years"] == pytest.approx(ju["eta_years"],
                                                   rel=1e-9)
    np.testing.assert_array_equal(eta_to_threshold_s(pf),
                                  np.asarray(h.eta_s))
    text = h.render()
    assert text.splitlines()[0] == jh.render().splitlines()[0]
    assert len(text.splitlines()) >= 3 + pf.n_devices
    with pytest.raises(NotImplementedError, match="online"):
        fleet_health(pf, online_result=object())


# --------------------------------------------------------------------------- #
# the disruption runs and the re-mesh planner
# --------------------------------------------------------------------------- #
def _assert_stats(got, want, rtol=SHIFT_RTOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=rtol, abs=1e-6), k
        else:
            assert got[k] == v, k


def test_run_flash_crowd_matches_reference():
    want = jdisruption.run_flash_crowd(n_devices=4, epochs=48)
    got = disruption.run_flash_crowd(n_devices=4, epochs=48, device="cpu")
    _assert_cosim(got["cos"], want["cos"], rec=True)
    _assert_stats(got["stats"], want["stats"])
    s = got["stats"]
    assert s["t_surge_rise_k"] > 1.0 and 0.0 < s["surge_served_frac"] < 1.0
    rec = disruption.recovered_totals(got["cos"])
    assert rec.shape == (48, 4) and (rec >= 0.0).all()
    assert rec[-1].max() == pytest.approx(s["recovered_mv_final"], rel=1e-6)
    with pytest.raises(ValueError, match="recovery"):
        disruption.recovered_totals(
            disruption.run_flash_crowd(n_devices=2, epochs=8, recovery=None,
                                       device="cpu")["cos"])


def test_run_retirement_matches_reference():
    kw = dict(n_devices=8, retire=(0, 1), hot_swap=1, epochs=48, tp=2,
              global_batch=64)
    want = jdisruption.run_retirement(**kw)
    got = disruption.run_retirement(device="cpu", **kw)
    for seg in ("cos_before", "cos_after"):
        _assert_cosim(got[seg], want[seg], rec=True)
    _assert_stats(got["stats"], want["stats"])
    for plan in ("plan_degraded", "plan_restored"):
        assert got[plan] == RemeshPlan(*map(
            lambda v: tuple(v) if isinstance(v, tuple) else v,
            (want[plan].old_shape, want[plan].new_shape,
             want[plan].axis_names, want[plan].microbatches)))
    assert got["keep"] == want["keep"]
    with pytest.raises(ValueError, match="whole fleet"):
        disruption.run_retirement(n_devices=2, retire=(0, 1), epochs=8,
                                  device="cpu")


def test_run_rest_to_recover_matches_reference():
    """Resting the most-worn devices beats round_robin by > 5 % on the
    8-device fleet, as the reference's acceptance test asks."""
    want = jdisruption.run_rest_to_recover(n_devices=8, epochs=120)
    got = disruption.run_rest_to_recover(n_devices=8, epochs=120,
                                         device="cpu")
    for name in ("round_robin", "wear_level", "rest_to_recover"):
        np.testing.assert_array_equal(got[name]["traj"].V,
                                      np.asarray(want[name]["traj"].V))
        _assert_stats({k: v for k, v in got[name].items() if k != "traj"},
                      {k: v for k, v in want[name].items() if k != "traj"})
    _assert_stats(got["headline"], want["headline"])
    assert got["headline"]["rest_vs_round_robin_pct"] > 5.0
    assert got["rest_to_recover"]["served_frac"] == pytest.approx(1.0,
                                                                  abs=1e-3)


@pytest.mark.parametrize("names,sizes,n,gb,micro", [
    (("data", "model"), {"data": 8, "model": 2}, 12, 64, 1),
    (("data", "model"), {"data": 8, "model": 1}, 5, 64, 2),
    (("pod", "data", "model"), {"pod": 2, "data": 4, "model": 2}, 8, 64, 1),
    (("pod", "data", "model"), {"pod": 2, "data": 4, "model": 2}, 10, 60,
     1)])
def test_plan_remesh_shape_matches_reference(names, sizes, n, gb, micro):
    want = jax_plan(names, sizes, n, global_batch=gb, old_microbatches=micro)
    got = plan_remesh_shape(names, sizes, n, global_batch=gb,
                            old_microbatches=micro)
    assert (got.old_shape, got.new_shape, got.axis_names,
            got.microbatches) == (want.old_shape, want.new_shape,
                                  want.axis_names, want.microbatches)
    with pytest.raises(ValueError, match="divisible"):
        plan_remesh_shape(("data", "model"), {"data": 4, "model": 2}, 5,
                          global_batch=8)


# --------------------------------------------------------------------------- #
# FleetServeEngine(router=...)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def llama():
    cfg_j = jax_get_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    lane_prompts = np.stack([prompts, prompts + 1, prompts + 2]) % cfg.vocab
    return cfg_j, cfg, params_j, params, lane_prompts


@pytest.mark.parametrize("route", ["fused", "three_pass"])
def test_fleet_engine_router_tokens_match_reference(llama, route):
    """Three lanes aged 3/6/9 years, aged further under wear-levelled
    diurnal traffic at construction, then served: tokens equal the
    reference's on the route, and the co-sim's supplies are equal.  (The
    aged lanes start from ``simulate``'s state, whose time grid is an ulp
    off the reference's here and there; the wear_level router divides by
    the fleet's shrinking wear spread, so its utilization, and the BERs it
    leaves, drift from there by more than BER_RTOL: ROADMAP §C.3.)"""
    cfg_j, cfg, params_j, params, lane_prompts = llama
    jf, pf = _fleets(3, (3.0, 6.0, 9.0))
    kw = dict(max_len=32, seed=5, use_systolic_kernel=True,
              use_fused_kernel=route == "fused", router="wear_level",
              workload="diurnal",
              apply_load_kw=dict(n_epochs=48, utilization=0.6))
    jeng = JaxFleetServeEngine(cfg_j, params_j, jf, **kw)
    peng = FleetServeEngine(cfg, params, pf, device="cpu", **kw)
    np.testing.assert_array_equal(pf.last_cosim.V, np.asarray(
        jf.last_cosim.V))
    np.testing.assert_array_equal(pf.last_cosim.load, np.asarray(
        jf.last_cosim.load))
    np.testing.assert_array_equal(pf.ages_years, jf.ages_years)
    want, got = jeng.generate(lane_prompts, 4), peng.generate(lane_prompts, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.bers, pf.op_ber_array())


def test_fleet_engine_loads_reach_apply_load():
    """``loads=`` is the arrival trace apply_load routes; without
    ``router=`` the fleet is not re-aged."""
    cfg = get_config("llama3_8b").reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    fleet = FleetRuntime(n_devices=2, device="cpu")
    FleetServeEngine(cfg, params, fleet, loads=np.ones(8, np.float32),
                     device="cpu")
    assert not hasattr(fleet, "last_cosim")
    loads = np.linspace(0.2, 1.8, 12).astype(np.float32)
    FleetServeEngine(cfg, params, fleet, router="least_aged", loads=loads,
                     apply_load_kw={"horizon_s": YEAR_S}, device="cpu")
    np.testing.assert_array_equal(fleet.last_cosim.load, loads)
    np.testing.assert_allclose(fleet.ages_years, 1.0)
