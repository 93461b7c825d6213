"""The port's fleet online engine against the reference's on the CPU: the
router-dispatched lanes (each lane's slots folded lane-major into one
batch, one lane config, ``split(key, N)`` keys) on a workload-derived
queue, the measured ``(T, N, K)`` occupancy and its replay into
``FleetRuntime.apply_load``, the taps under ``enable_taps``, and the MoE
family's fleet.

Tolerances: tokens, lanes, ``t_start`` / ``t_done``, occupancy and drop
counts exact; ``lane_utilization`` to 1e-12; the replayed co-sim's shifts
within 1e-5 relative and its ``util`` within 1e-6 (ROADMAP §C); taps
within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import transformer as jax_tf
from repro.obs.taps import enable_taps as jax_enable_taps
from repro.serve.online import OnlineFleetEngine as JaxOnlineFleetEngine
from repro.serve.online import Request as JaxRequest
from repro.serve.online import requests_from_workload as jax_requests
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.obs.taps import enable_taps
from repro_torch.serve.online import OnlineFleetEngine, Request
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

S = 8
MAX_LEN = 64
SHIFT_RTOL = 1e-5


def _model(arch):
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    pj = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = params_from_reference(jax.tree.map(np.asarray, pj), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, S)).astype(np.int32)
    return cfg_j, cfg, pj, p, prompts


@pytest.fixture(scope="module")
def setup():
    return _model("deepseek_7b")


def _fleets(N, ages):
    jf = JaxFleetRuntime(n_devices=N)
    pf = FleetRuntime(n_devices=N, device="cpu")
    for i, age in ages.items():
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    return jf, pf


def _serve_both(model, reqs, N, ages, serve_kw, **kw):
    cfg_j, cfg, pj, p, _ = model
    jf, pf = _fleets(N, ages)
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, max_new_cap=8,
                   chunk_steps=4), **kw)
    want = JaxOnlineFleetEngine(cfg_j, pj, jf, **kw).serve(
        [JaxRequest(**r) if isinstance(r, dict) else r for r in reqs[0]],
        **serve_kw)
    got = OnlineFleetEngine(cfg, p, pf, device="cpu", **kw).serve(
        [Request(**r) if isinstance(r, dict) else r for r in reqs[1]],
        **serve_kw)
    by = lambda res: sorted(res.completed, key=lambda r: r.id)
    assert [r.id for r in by(got)] == [r.id for r in by(want)]
    for g, w in zip(by(got), by(want)):
        assert (g.lane, g.t_start, g.t_done, g.n_generated) == (
            w.lane, w.t_start, w.t_done, w.n_generated), g.id
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    np.testing.assert_array_equal(got.occupancy, np.asarray(want.occupancy))
    assert (got.n_arrived, got.n_dropped, got.total_steps) == (
        want.n_arrived, want.n_dropped, want.total_steps)
    return got, want, jf, pf


def test_fleet_router_dispatch_matches_reference(setup):
    """A poisson queue over 2 lanes (lane 0 aged 8 y: wear_level steers
    away from it): every request's lane, times and tokens equal the
    reference's, and the queue drains."""
    kw = dict(n_slots=2, steps_per_epoch=16, max_new=6, prompt_len=S,
              vocab=setup[1].vocab, n_devices=2, seed=0, n_epochs=3)
    reqs = (jax_requests("poisson", **kw),
            [Request(id=r.id, prompt=r.prompt, max_new=r.max_new,
                     arrival=r.arrival) for r in jax_requests("poisson",
                                                              **kw)])
    got, _, _, _ = _serve_both(setup, reqs, 2, {0: 8.0},
                               dict(greedy=True, max_steps=600),
                               router="wear_level", seed=2)
    assert got.n_completed + got.n_dropped == got.n_arrived > 0
    assert {r.lane for r in got.completed} <= {0, 1}
    for r in got.completed:
        assert r.n_generated == min(6, r.max_new)
        assert r.t_done > r.t_start >= r.arrival


def test_occupancy_replay_drives_fleet_aging(setup):
    """The measured ``(E, N)`` duty replays into ``apply_load`` as the
    reference's does: the same utilization, the co-sim's util and wear
    within the physics' drift, and the lanes' taps (sampled, under
    ``enable_taps``) beside the reference's."""
    prompts = setup[4]
    reqs = [dict(id=i, prompt=prompts[i % 4], max_new=6, arrival=i)
            for i in range(10)]
    with enable_taps(), jax_enable_taps():
        got, want, jf, pf = _serve_both(
            setup, (reqs, reqs), 2, {}, dict(greedy=False, temperature=0.8),
            seed=4)
    assert got.occupancy.shape[1:] == (2, 2)
    for name in ("logit_max", "logit_margin"):
        assert got.telemetry[name].shape == want.telemetry[name].shape
        np.testing.assert_allclose(got.telemetry[name],
                                   np.asarray(want.telemetry[name]),
                                   atol=1e-4)
    util = got.lane_utilization(6)
    np.testing.assert_allclose(util, want.lane_utilization(6), atol=1e-12)
    assert util.shape == (6, 2)
    cos = pf.apply_load(util_trace=util, horizon_s=3.15e7)
    jcos = jf.apply_load(util_trace=util, horizon_s=3.15e7)
    np.testing.assert_allclose(np.asarray(cos.util), util, atol=1e-6)
    np.testing.assert_allclose(cos.device_wear(), jcos.device_wear(),
                               rtol=SHIFT_RTOL)
    assert pf.age_years > 0.9 and np.isfinite(cos.device_wear()).all()


def test_moe_fleet_matches_reference():
    """Reduced qwen3_moe_235b over 2 lanes (ages 3 / 9 y), sampled, on
    the fused route (the reference's Pallas in interpret mode): each
    lane's MoE capacity counts its own rows, idle slots' included."""
    model = _model("qwen3_moe_235b")
    prompts = model[4]
    reqs = [dict(id=i, prompt=prompts[i % 4], max_new=5 + i % 3,
                 arrival=2 * i) for i in range(7)]
    got, _, _, _ = _serve_both(model, (reqs, reqs), 2, {0: 3.0, 1: 9.0},
                               dict(greedy=False, temperature=0.8),
                               seed=6, use_systolic_kernel=True,
                               max_len=32)
    assert got.n_completed == 7
