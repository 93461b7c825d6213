"""Shard-granular fleets (``FleetRuntime(n_shards=S)``) of the port
against the reference on the CPU: the unit layout, every ``shard=``
method, ``state_dict`` round trips, ``apply_load`` (a device-granular duty
replayed onto its shards, and routed traffic over the units) and
``fleet_health``.  BERs within ROADMAP §C's 1e-3 relative; ages
exact."""

import numpy as np
import pytest

from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.core.scenario import Scenario as JaxScenario
from repro.obs.health import fleet_health as jax_fleet_health
from repro_torch.core.fleet import FleetRuntime
from repro_torch.core.scenario import Scenario
from repro_torch.obs.health import fleet_health
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

YEAR_S = 365.25 * 24 * 3600.0
BER_RTOL = 1e-3
SHIFT_RTOL = 1e-5


def _fleets(n=2, s=3, **kw):
    jf = JaxFleetRuntime(n_devices=n, n_shards=s, **kw.get("jax", {}))
    pf = FleetRuntime(n_devices=n, n_shards=s, device="cpu",
                      **kw.get("port", {}))
    return jf, pf


def _both(jf, pf, fn):
    fn(jf)
    fn(pf)


def _same_bers(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=BER_RTOL,
                               atol=1e-30)


def test_shard_ages_and_bers_match_reference():
    jf, pf = _fleets()
    _both(jf, pf, lambda f: f.set_age(years=2.0))
    _both(jf, pf, lambda f: f.set_age(years=9.0, device=1, shard=2))
    _both(jf, pf, lambda f: f.set_age(years=5.0, shard=0))
    _both(jf, pf, lambda f: f.advance(0.5 * YEAR_S, device=0))
    _both(jf, pf, lambda f: f.advance(YEAR_S, device=1, shard=1))
    _both(jf, pf, lambda f: f.advance(0.25 * YEAR_S, shard=2))
    np.testing.assert_array_equal(pf.ages_years, jf.ages_years)
    assert pf.ages_years.shape == (2, 3)
    assert pf.age_years == jf.age_years
    _same_bers(pf.op_ber_array(), jf.op_ber_array())
    _same_bers(pf.op_ber_shard_array(), jf.op_ber_shard_array())
    assert pf.op_ber_shard_array().shape == (2, 3, len(pf.operators))
    # the device row is the per-domain max over its shards
    np.testing.assert_array_equal(pf.op_ber_array(),
                                  pf.op_ber_shard_array().max(axis=1))
    for d in range(2):
        for shard in (None, 0, 1, 2):
            got, want = pf.op_bers(d, shard), jf.op_bers(d, shard)
            assert got.keys() == want.keys()
            for op in got:
                assert got[op] == pytest.approx(want[op], rel=BER_RTOL)
            assert pf.op_ber("q", d, shard) == got["q"]
        for shard in range(3):
            g, w = pf.domain_state("k", d, shard), jf.domain_state("k", d,
                                                                   shard)
            assert g.v_dd == w.v_dd
            assert g.ber == pytest.approx(w.ber, rel=BER_RTOL)
            assert g.dvth_p_mv == pytest.approx(w.dvth_p_mv, rel=SHIFT_RTOL)
            gs, ws = pf.summary(d, shard), jf.summary(d, shard)
            assert gs["down"]["v_dd"] == ws["down"]["v_dd"]
            assert gs["down"]["power_w"] == pytest.approx(
                ws["down"]["power_w"], rel=SHIFT_RTOL)
    np.testing.assert_allclose(pf.fleet_power(), jf.fleet_power(),
                               rtol=SHIFT_RTOL)
    view = pf.device(1)
    assert view.age_years == jf.device(1).age_years
    assert view.op_bers() == pf.op_bers(1)


def test_shard_ber_table_is_cached_until_ages_change():
    _, pf = _fleets(1, 4)
    for s in range(4):
        pf.set_age(years=1.5 + 2.5 * s, shard=s)
    tab = pf.op_ber_shard_array()
    assert pf.op_ber_shard_array() is tab
    assert len(np.unique(tab[0, :, 0])) == 4
    pf.advance(YEAR_S, shard=1)
    new = pf.op_ber_shard_array()
    assert new is not tab and new[0, 1, 0] > tab[0, 1, 0]


def test_unit_scenario_repeats_a_batched_scenario():
    """A (N,)-batched scenario gives every shard its device's profile,
    device-major, and the trajectories follow it."""
    duty = [0.3, 0.7]
    jf, pf = _fleets(2, 2, jax={"scenario": JaxScenario(duty=np.asarray(duty, np.float32))},
                     port={"scenario": Scenario(duty=duty)})
    np.testing.assert_array_equal(
        np.asarray(pf.unit_scenario.duty), np.asarray(jf.unit_scenario.duty))
    _both(jf, pf, lambda f: f.set_age(years=6.0))
    _same_bers(pf.op_ber_shard_array(), jf.op_ber_shard_array())
    assert pf.trajectories.V.shape[:2] == (4, len(pf.operators))


def test_state_dict_round_trips_a_sharded_fleet():
    jf, pf = _fleets()
    for f in (jf, pf):
        for s in range(3):
            f.set_age(years=1.0 + s, shard=s)
    sd, jsd = pf.state_dict(), jf.state_dict()
    assert sd["n_shards"] == jsd["n_shards"] == 3
    assert np.asarray(sd["dv_mv"]).shape == np.asarray(jsd["dv_mv"]).shape
    np.testing.assert_array_equal(sd["ages_s"], jsd["ages_s"])
    np.testing.assert_allclose(sd["dv_mv"], jsd["dv_mv"], rtol=SHIFT_RTOL)
    back = FleetRuntime(n_devices=2, n_shards=3, device="cpu")
    back.load_state_dict(sd)
    np.testing.assert_array_equal(back.ages_years, pf.ages_years)
    st, want = back.trap_state(), pf.trap_state()
    for k in ("dv", "rec", "v"):
        np.testing.assert_array_equal(st[k], want[k].astype(np.float32))
    # the reference's artifact loads too
    from_ref = FleetRuntime(n_devices=2, n_shards=3, device="cpu")
    from_ref.load_state_dict(jsd)
    np.testing.assert_array_equal(from_ref.ages_years, jf.ages_years)
    with pytest.raises(ValueError, match="n_shards"):
        FleetRuntime(n_devices=2, n_shards=2,
                     device="cpu").load_state_dict(sd)
    with pytest.raises(ValueError, match="device-granular"):
        pf.resize([0])


def test_apply_load_replays_a_device_duty_onto_its_shards():
    """A measured ``(E, N)`` duty is repeated onto each device's shards;
    the co-sim runs over the N*S units from their staggered ages."""
    jf, pf = _fleets(2, 2)
    for f in (jf, pf):
        for s in range(2):
            f.set_age(years=1.0 + 3 * s, shard=s)
    U = np.random.default_rng(0).uniform(0.2, 0.9, (12, 2)).astype(
        np.float32)
    kw = dict(util_trace=U, horizon_s=YEAR_S)
    cos, jcos = pf.apply_load(**kw), jf.apply_load(**kw)
    assert np.asarray(cos.V).shape == np.asarray(jcos.V).shape
    assert np.asarray(cos.V).shape[1] == 4
    np.testing.assert_array_equal(np.asarray(cos.V), np.asarray(jcos.V))
    np.testing.assert_allclose(np.asarray(cos.dv), np.asarray(jcos.dv),
                               rtol=SHIFT_RTOL, atol=1e-6)
    np.testing.assert_array_equal(pf.ages_years, jf.ages_years)
    _same_bers(pf.op_ber_shard_array(), jf.op_ber_shard_array())


@pytest.mark.parametrize("router", ["round_robin", "wear_level"])
def test_apply_load_routes_over_the_units(router):
    jf, pf = _fleets(1, 4)
    kw = dict(workload="diurnal", router=router, n_epochs=24,
              horizon_s=4 * YEAR_S)
    cos, jcos = pf.apply_load(**kw), jf.apply_load(**kw)
    np.testing.assert_array_equal(np.asarray(cos.V), np.asarray(jcos.V))
    np.testing.assert_allclose(np.asarray(cos.util), np.asarray(jcos.util),
                               rtol=1e-6)
    _same_bers(pf.op_ber_shard_array(), jf.op_ber_shard_array())
    np.testing.assert_allclose(pf.fleet_power(), jf.fleet_power(),
                               rtol=SHIFT_RTOL)


def test_fleet_health_of_a_sharded_fleet_matches_reference():
    jf, pf = _fleets(2, 2)
    for f in (jf, pf):
        f.set_age(years=3.0)
        f.set_age(years=8.0, device=1, shard=0)
    h, jh = fleet_health(pf), jax_fleet_health(jf)
    d, jd = h.to_dict(), jh.to_dict()
    assert d["n_shards"] == jd["n_shards"] == 2
    assert len(d["units"]) == len(jd["units"]) == 4
    for u, ju in zip(d["units"], jd["units"]):
        assert u["unit"] == ju["unit"]
        for k in ("age_years", "v_dd"):
            assert u[k] == ju[k], k
        assert u["dvth_p_mv"] == pytest.approx(ju["dvth_p_mv"],
                                               rel=SHIFT_RTOL)
        assert u["ber"] == pytest.approx(ju["ber"], rel=BER_RTOL)
        assert (u["eta_years"] is None) == (ju["eta_years"] is None)
    text = h.render()
    assert "1.0" in text and "1.1" in text
