"""The port's scheduler slice vs the JAX reference on the CPU: the
backend-exact float32 functions (``repro_torch.fmath``), the Poisson and
Bernoulli samplers, every workload trace, ``waterfill`` and the five
routers, the routed and replayed co-simulation on the reference tests'
8-device thermal-gradient fleet, ``compare_routers`` and ``cosim_stats``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.policy import FaultTolerantPolicy as JaxFaultTolerantPolicy
from repro.core.scenario import Scenario as JaxScenario
from repro.sched import compare_routers as jax_compare_routers
from repro.sched import cosimulate as jax_cosimulate
from repro.sched import initial_state_at_ages as jax_initial_state_at_ages
from repro.sched import router as jrouter
from repro.sched import workload as jworkload
from repro_torch import fmath
from repro_torch import random as prandom
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.constants import T_AMB
from repro_torch.core.policy import FaultTolerantPolicy
from repro_torch.core.resilience import OPERATORS
from repro_torch.core.scenario import Scenario
from repro_torch.sched import (ROUTER_REGISTRY, compare_routers,
                               cosim_stats, cosimulate, get_router,
                               get_workload, initial_state_at_ages,
                               waterfill)
from repro_torch.sched.lifetime import _pop_totals
from repro_torch.sched.workload import WORKLOADS, Workload

YEAR_S = 365.25 * 24 * 3600.0
N_DEV = 8
# simulate's shifts: exp/pow differ from XLA's by an ulp here and there
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
    return torch.from_numpy(np.ascontiguousarray(x))


def ulps(a, b):
    """Largest distance between ``a`` and ``b`` in float32 ulps of the
    larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / gap)) \
        if a.size else 0.0


# --------------------------------------------------------------------------- #
# backend-exact float32 functions and the samplers
# --------------------------------------------------------------------------- #
_RNG = np.random.default_rng(0)
FMATH_GRIDS = {
    "log": np.concatenate([_RNG.random(200_000, dtype=np.float32),
                           (_RNG.random(50_000) * 1e4).astype(np.float32),
                           np.arange(1, 3000, dtype=np.float32),
                           np.array([0.0, 1e-38, 1e-45, np.inf],
                                    np.float32)]),
    "log1p": np.concatenate([(_RNG.random(200_000) * 2 - 0.9).astype(
        np.float32), (_RNG.random(50_000) * 1e4).astype(np.float32)]),
    "sin": np.concatenate([(_RNG.random(200_000) * 300).astype(np.float32),
                           -(_RNG.random(20_000) * 2e3).astype(np.float32),
                           np.arange(0, 500, dtype=np.float32)]),
    # the samplers' domain (k + 1 for counts k >= 0) and x >= 0.5
    "lgamma": np.concatenate([np.arange(1, 6000, dtype=np.float32),
                              (_RNG.random(100_000) * 1e4 + 0.5).astype(
                                  np.float32)]),
}
JAX_FN = {"log": jnp.log, "log1p": jnp.log1p, "sin": jnp.sin,
          "lgamma": jax.lax.lgamma}


@pytest.mark.parametrize("name", list(FMATH_GRIDS))
def test_fmath_is_bit_exact_with_the_reference_backend(name):
    x = FMATH_GRIDS[name]
    want = np.asarray(JAX_FN[name](jnp.asarray(x)))
    got = getattr(fmath, name)(T(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fmath_lgamma_reflection_is_close():
    """Below 0.5 the reflection takes torch's sin/log: within a few ulps
    of the reference (the samplers never use it)."""
    x = np.linspace(-7.3, 0.49, 4001).astype(np.float32)
    x = x[np.abs(x - np.round(x)) > 1e-3]
    want = np.asarray(jax.lax.lgamma(jnp.asarray(x)))
    got = fmath.lgamma(T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poisson_is_bit_exact(seed):
    """Both samplers (Knuth below lam = 10, rejection above), lam = 0 and
    the boundary, from one key: counts equal ``jax.random.poisson``."""
    rng = np.random.default_rng(seed)
    lam = np.concatenate([rng.random(300) * 12, rng.random(300) * 500,
                          [0.0, 1e-3, 9.999, 10.0, 1e4]]).astype(np.float32)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed),
                                         jnp.asarray(lam), shape=lam.shape))
    got = prandom.poisson(prandom.PRNGKey(seed), T(lam))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a broadcast shape draws per element of the shape
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed),
                                         jnp.float32(42.0), shape=(3, 50)))
    np.testing.assert_array_equal(
        prandom.poisson(prandom.PRNGKey(seed), 42.0, (3, 50)).numpy(), want)


def test_bernoulli_is_bit_exact():
    for seed in range(3):
        p = np.random.default_rng(seed).random(500).astype(np.float32)
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed),
                                               jnp.asarray(p)))
        np.testing.assert_array_equal(
            prandom.bernoulli(prandom.PRNGKey(seed), T(p)).numpy(), want)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), 0.3,
                                           (2, 64)))
    np.testing.assert_array_equal(
        prandom.bernoulli(prandom.PRNGKey(4), 0.3, (2, 64)).numpy(), want)


# --------------------------------------------------------------------------- #
# workloads
# --------------------------------------------------------------------------- #
WORKLOAD_CASES = {
    "poisson": ("poisson", {}), "diurnal": ("diurnal", {}),
    "bursty": ("bursty", {}), "flash_crowd": ("flash_crowd", {}),
    "diurnal_480": ("diurnal", {"utilization": 0.55, "n_epochs": 480}),
    "bursty_zero": ("bursty", {"utilization": 0.0, "burst_prob": 1.0,
                               "burst_gain": 10.0, "n_epochs": 256}),
    "diurnal_fine": ("diurnal", {"quanta": 1e4, "n_epochs": 240}),
}


@pytest.mark.parametrize("case", list(WORKLOAD_CASES))
def test_workload_traces_are_bit_exact(case):
    name, extra = WORKLOAD_CASES[case]
    kw = dict(dict(n_devices=4, utilization=0.5, n_epochs=144), **extra)
    jwl, wl = jworkload.get_workload(name, **kw), get_workload(name, **kw)
    np.testing.assert_array_equal(wl.envelope("cpu").numpy(),
                                  np.asarray(jwl.envelope()))
    for seed in (0, 3, 7):
        np.testing.assert_array_equal(wl.loads(seed, "cpu").numpy(),
                                      np.asarray(jwl.loads(seed)))
    assert wl.to_dict() == jwl.to_dict()


def test_workload_batched_fields_are_bit_exact():
    """Batch dims carried by ``quanta`` or ``burst_prob`` alone broadcast
    into the trace batch, as the reference's."""
    cases = [dict(mean_load=2.0, quanta=[4.0, 64.0, 1e4], n_epochs=16),
             dict(mean_load=2.0, burst_prob=[[0.0], [1.0]], burst_gain=5.0,
                  quanta=1e4, n_epochs=64),
             dict(mean_load=[2.0, 4.0], amplitude=0.5, n_epochs=64)]
    for kw in cases:
        jkw = {k: jnp.asarray(v) if isinstance(v, list) else v
               for k, v in kw.items()}
        pkw = {k: np.asarray(v, np.float32) if isinstance(v, list) else v
               for k, v in kw.items()}
        jwl, wl = jworkload.Workload(**jkw), Workload(**pkw)
        assert wl.batch_shape == jwl.batch_shape
        np.testing.assert_array_equal(wl.loads(0, "cpu").numpy(),
                                      np.asarray(jwl.loads(0)))


def test_workload_int_seed_is_its_prngkey_stream_and_registry(
        monkeypatch):
    wl = get_workload("diurnal", n_devices=4, utilization=0.5, n_epochs=64)
    np.testing.assert_array_equal(
        wl.loads(7, "cpu").numpy(),
        wl.loads(prandom.PRNGKey(7), "cpu").numpy())
    np.testing.assert_array_equal(wl.loads(None, "cpu").numpy(),
                                  wl.loads(0, "cpu").numpy())
    assert sorted(WORKLOADS) == sorted(jworkload.WORKLOADS)
    with pytest.raises(KeyError, match="unknown workload"):
        get_workload("nope")
    # entry points run on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wl.loads(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cosimulate(None, None, None, None, np.ones(2, np.float32))


# --------------------------------------------------------------------------- #
# waterfill and the routers
# --------------------------------------------------------------------------- #
def _router_cases():
    rng = np.random.default_rng(1)
    cases = []
    for trial in range(21):
        n = int(rng.choice([2, 5, 8]))
        wear = rng.uniform(0, 80, n).astype(np.float32)
        if trial % 5 == 0:
            wear[:] = 0.0                       # a fresh fleet: all tied
        if trial % 7 == 0:
            wear[1] = wear[0]                   # a tie
        util_prev = rng.uniform(0, 1, n).astype(np.float32)
        cap = (rng.uniform(0.2, 1, n).astype(np.float32) if trial % 3 == 0
               else 1.0)
        load = np.float32(rng.uniform(0, n * 1.2))
        cases.append((load, wear, util_prev, cap))
    wear = np.linspace(10.0, 60.0, 6).astype(np.float32)
    cases += [(np.float32(x), wear, np.zeros(6, np.float32), 1.0)
              for x in (0.0, 0.7, 3.2, 6.0, 9.5)]
    return cases


ROUTER_CASES = _router_cases()


def test_waterfill_matches_reference():
    for i, (load, wear, _, cap) in enumerate(ROUTER_CASES):
        for gain in ((1.0, 4.0) if i % 4 == 0 else (4.0,)):
            want = np.asarray(jrouter.waterfill(jnp.asarray(wear), load,
                                                jnp.asarray(cap), gain=gain))
            got = waterfill(T(wear), torch.tensor(load), torch.as_tensor(cap),
                            gain=gain).numpy()
            assert ulps(got, want) <= 1.0, (load, wear, cap, got, want)
    # zero load gives exactly zero, heterogeneous capacity is respected
    assert not waterfill(torch.zeros(4), 0.0, 1.0).any()
    u = waterfill(torch.zeros(4), 2.0, torch.tensor([0.25, 1, 1, 0.25]))
    assert float(u.sum()) == pytest.approx(2.0, abs=2e-3)


@pytest.mark.parametrize("name", sorted(jrouter.ROUTER_REGISTRY))
def test_router_matches_reference(name):
    """Every router within one float32 ulp of the reference (in fact
    equal), ties and the all-zero wear of a fresh fleet included."""
    jr, pr = jrouter.get_router(name), get_router(name)
    for load, wear, util_prev, cap in ROUTER_CASES:
        want = np.asarray(jr.assign(jnp.float32(load), jnp.asarray(wear),
                                    jnp.asarray(util_prev),
                                    jnp.asarray(cap)))
        got = pr.assign(torch.tensor(load), T(wear), T(util_prev),
                        torch.as_tensor(cap)).numpy()
        assert ulps(got, want) <= 1.0, (name, load, wear, cap, got, want)


def test_router_registry_mirrors_the_reference():
    assert sorted(ROUTER_REGISTRY) == sorted(jrouter.ROUTER_REGISTRY)
    with pytest.raises(KeyError, match="unknown router"):
        get_router("nope")
    r = get_router("wear_level", gain=2.0)
    assert get_router(r) is r and r.gain == 2.0


# --------------------------------------------------------------------------- #
# the co-simulation on the reference tests' thermal-gradient fleet
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fleet8():
    """``tests/test_sched.py``'s heterogeneous fleet: 8 devices over a
    30 K rack gradient, 5-year horizon; diurnal traffic at 55 %."""
    jcal, cal = jax_load_calibration(), load_calibration()
    t_amb = (T_AMB + np.linspace(0.0, 30.0, N_DEV)).astype(np.float32)
    jscn = JaxScenario.from_lifetime_config(jcal.lifetime_cfg).replace(
        lifetime_s=5 * YEAR_S, t_amb=jnp.asarray(t_amb))
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=5 * YEAR_S, t_amb=T(t_amb))
    jdmax = JaxFaultTolerantPolicy(ber_model=jcal.ber).thresholds(
        jscn, OPERATORS)
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    np.testing.assert_array_equal(dmax.numpy(), np.asarray(jdmax))
    loads = get_workload("diurnal", n_devices=N_DEV, utilization=0.55,
                         n_epochs=48).loads(0, "cpu").numpy()
    return jcal, cal, jscn, scn, jdmax, dmax, loads


@pytest.mark.parametrize("router", sorted(jrouter.ROUTER_REGISTRY))
def test_cosim_routed_matches_reference(fleet8, router):
    """The routed co-sim end to end, element by element: the port's router
    assigns the reference's utilization (within an ulp) to the reference's
    wear, and the whole run gives the reference's utilizations, supplies,
    shifts, delays and boosts exactly.  The wear-steering routers turn an
    ulp of wear into a share of load, so this holds only because the
    physics rounds as the reference backend does (``fmath.pow``, its fused
    multiply-adds, the polynomial's sum order; ROADMAP §C.3)."""
    jcal, cal, jscn, scn, jdmax, dmax, loads = fleet8
    ref = jax_cosimulate(jcal.aging, jcal.delay_poly, jscn, jdmax, loads,
                         router=router, n_devices=N_DEV)
    E = loads.shape[0]
    # routing: the reference's wear before each epoch, in the port's router
    dv_prev = np.concatenate([np.zeros((1,) + ref.dv.shape[1:], np.float32),
                              np.asarray(ref.dv)[:-1]])
    wear = _pop_totals(T(dv_prev))[0].amax(dim=-1)               # (E, N)
    util_prev = np.concatenate([np.zeros((1, N_DEV), np.float32),
                                np.asarray(ref.util)[:-1]])
    r = get_router(router)
    for e in range(E):
        got = r.assign(torch.tensor(loads[e]), wear[e], T(util_prev[e]),
                       torch.tensor(1.0)).numpy()
        assert ulps(got, np.asarray(ref.util)[e]) <= 1.0, e
    got = cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads,
                     router=router, n_devices=N_DEV, device="cpu")
    for f in ("util", "V", "dv", "dvp", "dvn", "delay", "boosts", "t"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), f)


def test_cosim_replay_of_routed_util_is_bit_identical(fleet8):
    """Replaying a routed co-sim's own util is the routed run, with the
    recovery pool and thermal loop too; loads default to the trace's
    per-epoch sum."""
    _, cal, _, scn, _, dmax, loads = fleet8
    for kw in ({}, {"recovery_dynamics": True, "thermal": True}):
        routed = cosimulate(cal.aging, cal.delay_poly, scn, dmax,
                            loads[:24], router="wear_level", n_devices=N_DEV,
                            device="cpu", **kw)
        replay = cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                            util_trace=routed.util, n_devices=N_DEV,
                            device="cpu", epoch_s=5 * YEAR_S / 24, **kw)
        for f in routed._FIELDS:
            if f != "load" and getattr(routed, f) is not None:
                np.testing.assert_array_equal(getattr(replay, f),
                                              getattr(routed, f), f)
        np.testing.assert_allclose(replay.load, routed.util.sum(-1),
                                   rtol=1e-6)


def test_cosim_layout_and_argument_checks(fleet8):
    _, cal, _, scn, _, dmax, loads = fleet8
    cos = cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads[:6],
                     router="round_robin", n_devices=N_DEV, device="cpu")
    O = len(OPERATORS)
    assert cos.V.shape == (6, N_DEV, O) and cos.dv.shape == (6, N_DEV, O, 6)
    assert cos.rec is None and cos.t_node is None
    traj = cos.as_lifetime_trajectory()
    assert traj.V.shape == (N_DEV, O, 6)
    np.testing.assert_array_equal(traj.V[1, 2], cos.V[:, 1, 2])
    assert cos.device_wear().shape == (6, N_DEV)
    with pytest.raises(ValueError, match="util_trace"):
        cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                   util_trace=np.ones(6, np.float32), device="cpu")
    with pytest.raises(ValueError, match="loads"):
        cosimulate(cal.aging, cal.delay_poly, scn, dmax,
                   np.ones((2, 3), np.float32), device="cpu")
    with pytest.raises(KeyError, match="unknown router"):
        cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads[:2],
                   router="nope", device="cpu")


def test_initial_state_at_ages_matches_reference(fleet8):
    jcal, cal, jscn, scn, jdmax, dmax, _ = fleet8
    ages = np.linspace(0.0, 7.0, N_DEV) * YEAR_S
    jdv, jv = jax_initial_state_at_ages(jcal.aging, jcal.delay_poly, jscn,
                                        jdmax, ages)
    dv, v = initial_state_at_ages(cal.aging, cal.delay_poly, scn, dmax,
                                  ages, device="cpu")
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_allclose(dv, np.asarray(jdv), rtol=SHIFT_RTOL)


def test_compare_routers_and_cosim_stats_match_reference(fleet8):
    """compare_routers on the staggered (0-7 y) thermal-gradient fleet, for
    the wear-blind routers: every stat within SHIFT_RTOL of the
    reference's; cosim_stats of the reference's own trajectory equal."""
    jcal, cal, jscn, scn, _, _, loads = fleet8
    ages = np.linspace(0.0, 7.0, N_DEV) * YEAR_S
    routers = ("round_robin", "least_aged")
    want = jax_compare_routers(jcal, jscn,
                               JaxFaultTolerantPolicy(ber_model=jcal.ber),
                               loads, routers=routers, n_devices=N_DEV,
                               ages_s=ages, recovery_dynamics=True)
    got = compare_routers(cal, scn, FaultTolerantPolicy(ber_model=cal.ber),
                          loads, routers=routers, n_devices=N_DEV,
                          ages_s=ages, recovery_dynamics=True, device="cpu")
    for name in routers:
        np.testing.assert_array_equal(got[name]["traj"].V,
                                      np.asarray(want[name]["traj"].V))
        for k, v in want[name].items():
            if k != "traj":
                assert got[name][k] == pytest.approx(v, rel=SHIFT_RTOL,
                                                     abs=1e-6), (name, k)
    # cosim_stats of the same trajectory (the reference's, re-laid)
    from repro.sched import cosim_stats as jax_cosim_stats
    ref = want["round_robin"]["traj"]
    mine = type(got["round_robin"]["traj"])(**{
        f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
        for f in ref._FIELDS})
    a, b = cosim_stats(cal.power, mine), jax_cosim_stats(jcal.power, ref)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k] == pytest.approx(b[k], rel=1e-6), k


def test_wear_level_cuts_fleet_max_dvth_and_power(fleet8):
    """The reference's acceptance test, on the port: on the staggered
    8-device fleet under diurnal traffic, wear_level cuts fleet-max ΔVth by
    > 5 %, lowers lifetime power and halves the wear spread against
    round_robin, and serves everything."""
    _, cal, _, scn, _, _, _ = fleet8
    loads = get_workload("diurnal", n_devices=N_DEV, utilization=0.55,
                         n_epochs=240).loads(0, "cpu")
    res = compare_routers(cal, scn, FaultTolerantPolicy(ber_model=cal.ber),
                          loads, routers=("round_robin", "wear_level"),
                          n_devices=N_DEV,
                          ages_s=np.linspace(0.0, 7.0, N_DEV) * YEAR_S,
                          device="cpu")
    rr, wl = res["round_robin"], res["wear_level"]
    assert wl["fleet_max_dvp_mv"] < 0.95 * rr["fleet_max_dvp_mv"]
    assert wl["p_avg_w"] < rr["p_avg_w"] * (1.0 - 1e-3)
    assert wl["wear_spread_mv"] < 0.5 * rr["wear_spread_mv"]
    assert wl["served_frac"] == pytest.approx(1.0, abs=1e-3)
