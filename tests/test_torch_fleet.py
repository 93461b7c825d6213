"""The port's fleet slice vs the JAX reference on the CPU: the vectorised
``FleetRuntime`` (policies, per-device scenario batches), the lane modes'
plain versions against ``jax.vmap`` of the reference's Pallas kernels
(interpret mode), the lane ``FaultConfig``, and ``FleetServeEngine`` on
reduced llama3_8b and deepseek_7b: three lanes aged 3/6/9 years on the
fused, three-pass and kernel-free routes, greedy and sampled."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.avs import simulate as jax_simulate
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.core.scenario import Scenario as JaxScenario
from repro.kernels import ops as jops
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.avs import simulate
from repro_torch.core.fleet import SECONDS_PER_YEAR, FleetRuntime
from repro_torch.core.scenario import Scenario
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels.bitflip import bitflip_draw_lanes
from repro_torch.kernels.fused_aged_matmul import fused_aged_matmul_lanes
from repro_torch.models.layers import FaultConfig
from repro_torch.obs.taps import enable_taps
from repro_torch.serve import steps
from repro_torch.serve.engine import FleetServeEngine

# the age-9 BERs: the BER curve is steep in delay, so float32 delay drift
# of ~1e-7 relative becomes ~1e-4 (ROADMAP §C, known drift)
BER_RTOL = 1e-3
# simulate's shifts: exp/log/pow differ from XLA's by an ulp here and there
SHIFT_RTOL = 1e-5
# prefill logits: float32 reductions sum in another order than XLA's
LOGIT_ATOL = 1e-4
AGES = (3.0, 6.0, 9.0)           # the reference fleet test's lane ages
OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")
ROUTES = {"fused": (True, True), "three_pass": (True, False),
          "kernel_free": (False, True)}


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _fleets(n, ages, **kw):
    jf, pf = JaxFleetRuntime(n_devices=n, **kw), \
        FleetRuntime(n_devices=n, device="cpu", **kw)
    for i, age in enumerate(ages):
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    return jf, pf


# --------------------------------------------------------------------------- #
# FleetRuntime
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["fault_tolerant", "baseline"])
def test_fleet_arrays_match_reference(policy):
    """A heterogeneous-age fleet (the serving example's ages, floored at
    1e-3 years): the (N, O) BER matrix, per-device power, ages and the
    per-domain summaries."""
    jf, pf = _fleets(4, (1e-3, 3.0, 6.0, 9.5), policy=policy)
    assert pf.policy.name == policy
    np.testing.assert_allclose(pf.op_ber_array(), jf.op_ber_array(),
                               rtol=BER_RTOL)
    assert pf.op_ber_array().shape == (4, len(pf.operators))
    np.testing.assert_allclose(pf.fleet_power(), jf.fleet_power(),
                               rtol=SHIFT_RTOL)
    np.testing.assert_array_equal(pf.ages_years, jf.ages_years)
    assert pf.op_index("o") == jf.op_index("o")
    assert pf.op_ber("down", device=2) == pytest.approx(
        jf.op_ber("down", device=2), rel=BER_RTOL)
    view, jview = pf.device(3), jf.device(3)
    assert view.cal is pf.cal and view.policy is pf.policy
    assert view.operators == tuple(jview.operators)
    got, want = view.summary(), jview.summary()
    assert set(got) == set(want)
    for op in want:
        assert set(got[op]) == set(want[op])
        assert got[op]["v_dd"] == want[op]["v_dd"]
        assert got[op]["ber"] == pytest.approx(want[op]["ber"], rel=BER_RTOL)
        assert got[op]["dvth_p_mv"] == pytest.approx(
            want[op]["dvth_p_mv"], rel=SHIFT_RTOL)
    assert view.domain_state("k").power_w == pytest.approx(
        jview.domain_state("k").power_w, rel=SHIFT_RTOL)
    assert view.op_ber("q") == got["q"]["ber"]


def test_unported_fleet_options_raise():
    with pytest.raises(NotImplementedError, match="n_shards"):
        FleetRuntime(n_devices=2, n_shards=2, device="cpu")
    with pytest.raises(KeyError, match="nonesuch"):
        FleetRuntime(policy="nonesuch", device="cpu")
    grid = Scenario(duty=np.full((2, 3), 0.5, np.float32))
    with pytest.raises(ValueError, match="batch shape"):
        FleetRuntime(scenario=grid, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        FleetRuntime(n_devices=2, scenario=Scenario(duty=[0.3, 0.5, 0.7]),
                     device="cpu")


# per-device mission profiles: duty, temperature, budget, and time grids of
# their own (first grid point and horizon)
SCENARIO_BATCH = dict(
    duty=[0.3, 0.5, 0.7], t_amb=[298.0, 318.0, 348.0],
    t_start=[600.0, 300.0, 1200.0], lifetime_s=[3.15e8, 2.0e8, 3.6e8],
    max_loss_pct=[0.1, 0.5, 2.0])


def _scenarios():
    leaves = {k: np.asarray(v, np.float32) for k, v in SCENARIO_BATCH.items()}
    return JaxScenario(**leaves), Scenario(**leaves)


def test_scenario_batch_simulate_matches_reference():
    """A (3,)-batched scenario simulates in one batched call, each profile
    on its own time grid, as the reference's vmapped scan."""
    jscn, pscn = _scenarios()
    jc, pc = jax_load_calibration(), load_calibration()
    want = jax_simulate(jc.aging, jc.delay_poly, jscn)
    got = simulate(pc.aging, pc.delay_poly, pscn, device="cpu")
    assert got.batch_shape == (3,)
    np.testing.assert_array_equal(got.V, np.asarray(want.V))
    for k in ("t", "delay", "dvp", "dvn", "dv"):
        np.testing.assert_allclose(getattr(got, k),
                                   np.asarray(getattr(want, k)),
                                   rtol=SHIFT_RTOL, err_msg=k)
    assert got.t[1, 0] == pytest.approx(300.0) != got.t[0, 0]


@pytest.mark.parametrize("policy", ["fault_tolerant", "baseline"])
def test_scenario_batched_fleet_matches_reference(policy):
    """The fleet takes n_devices from the scenario batch; each device's
    BERs follow its own profile and its own budget."""
    jscn, pscn = _scenarios()
    jf = JaxFleetRuntime(scenario=jscn, policy=policy)
    pf = FleetRuntime(scenario=pscn, policy=policy, device="cpu")
    assert pf.n_devices == jf.n_devices == 3
    for i, age in enumerate((1.0, 5.0, 9.5)):
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    assert pf.trajectories.V.shape == (3, len(pf.operators), 480)
    np.testing.assert_allclose(pf.op_ber_array(), jf.op_ber_array(),
                               rtol=BER_RTOL)
    np.testing.assert_allclose(pf.fleet_power(), jf.fleet_power(),
                               rtol=SHIFT_RTOL)


# --------------------------------------------------------------------------- #
# lane modes: plain versions vs jax.vmap of the Pallas kernels
# --------------------------------------------------------------------------- #
LANE_BERS = (1e-2, 0.0, 5e-2)      # one lane at BER 0


@pytest.mark.parametrize("M,K,N", [(2, 96, 130), (9, 64, 300),
                                   (32, 256, 128)])
@pytest.mark.parametrize("dequant", [False, True], ids=["int32", "float32"])
def test_fused_lanes_plain_matches_vmapped_pallas(M, K, N, dequant):
    """The fused GEMM's lane mode (plain version, through the op) equals
    ``jax.vmap`` of the reference's Pallas kernel with per-lane seeds and
    BERs, every lane tiled on its own M rows."""
    L = len(LANE_BERS)
    rng = np.random.default_rng(M * K + N)
    a = rng.integers(-128, 128, (L, M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    xs = rng.random((L, M, 1), dtype=np.float32) + 0.5 if dequant else None
    ws = rng.random((1, N), dtype=np.float32) + 0.5 if dequant else None
    seeds = np.asarray([7, -123456789, 2 ** 31 - 5], np.int32)
    bers = np.asarray(LANE_BERS, np.float32)

    def one(a_l, xs_l, ber, seed):
        return jops.fused_aged_matmul(
            a_l, jnp.asarray(b), xs_l, None if ws is None else jnp.asarray(ws),
            ber=ber, seed=seed, interpret=True)
    want = np.asarray(jax.vmap(one)(jnp.asarray(a), None if xs is None else
                                    jnp.asarray(xs), jnp.asarray(bers),
                                    jnp.asarray(seeds)))
    folded_xs = None if xs is None else T(xs.reshape(L * M, 1))
    got = ops.fused_aged_matmul(
        T(a.reshape(L * M, K)), T(b), folded_xs,
        None if ws is None else T(ws), ber=[float(x) for x in bers],
        seed=[int(s) for s in seeds], lanes=L)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    clean = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    if not dequant:
        assert (want[1] == clean[1]).all()           # the BER-0 lane
        assert (want[2] != clean[2]).any()


@pytest.mark.parametrize("shape", [(2, 8, 4, 1, 64), (3, 5, 7), (1,),
                                   (256 * 128 + 1,)])
def test_inject_lanes_plain_matches_vmapped_pallas(shape):
    """The draw-mode lane injection (plain version) equals ``jax.vmap`` of
    the reference's ``inject_bitflips`` (its padded Pallas pass in
    interpret mode) with per-lane keys and BERs: each lane draws over its
    own word indices."""
    L = len(LANE_BERS)
    rng = np.random.default_rng(len(shape))
    x = rng.integers(-2 ** 31, 2 ** 31, (L,) + shape, dtype=np.int64) \
        .astype(np.int32)
    bers = np.asarray(LANE_BERS, np.float32) * 10
    jkeys = jax.random.split(jax.random.PRNGKey(21), L)
    pkeys = prandom.split(prandom.PRNGKey(21), L)
    want = np.asarray(jax.vmap(
        lambda x_l, b, k: jops.inject_bitflips(x_l, b, k, interpret=True))(
            jnp.asarray(x), jnp.asarray(bers), jkeys))
    folded = T(x.reshape((L * shape[0],) + shape[1:]))
    for fn in (ops.inject_bitflips, ops.inject_bitflips_ref):
        got = fn(folded, [float(v) for v in bers], pkeys, lanes=L)
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    np.testing.assert_array_equal(want[1], x[1])      # the BER-0 lane
    if x[0].size >= 100:
        assert (want[0] != x[0]).any()


def test_lane_ops_check_their_arguments():
    a = torch.ones((6, 32), dtype=torch.int8)
    b = torch.ones((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="lanes"):
        ops.fused_aged_matmul(a, b, ber=[1e-3] * 2, seed=[1, 2, 3], lanes=3)
    with pytest.raises(ValueError, match="lanes"):
        fused_aged_matmul_lanes(a[:5], b, None, None, [0.0] * 3, [0] * 3,
                                lanes=3)
    with pytest.raises(ValueError, match="lanes"):
        bitflip_draw_lanes(torch.zeros((3, 4), dtype=torch.int32),
                           [(0, 0, 0, 0)] * 2, [0.0] * 2)
    x = torch.zeros((6, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="keys"):
        ops.inject_bitflips(x, [1e-3] * 3, prandom.PRNGKey(0), lanes=3)
    # a lane axis is never read from a BER vector's shape
    w = torch.ones((32, 16))
    with pytest.raises(NotImplementedError, match="lanes="):
        ops.aged_linear(torch.ones((6, 32)), w, ber=[1e-3] * 3, seed=1)


# --------------------------------------------------------------------------- #
# the lane FaultConfig
# --------------------------------------------------------------------------- #
def test_lane_fault_config_derives_the_reference_streams():
    """Per-lane stream bases, seeds and keys equal the reference's config of
    each lane alone, and ``lane(i)`` slices that config out."""
    L = 3
    jkeys = jax.random.split(jax.random.PRNGKey(9), L)
    pkeys = prandom.split(prandom.PRNGKey(9), L)
    bers = {op: tuple(1e-4 * (i + 1) for i in range(L)) for op in OPS}
    fi = FaultConfig(bers=bers, key=pkeys).with_seeds().for_step(5)
    assert fi.lanes == L and fi.ber_for("router") == (0.0,) * L
    for i in range(L):
        jfi = JaxFaultConfig(bers={op: jnp.float32(v[i])
                                   for op, v in bers.items()},
                             key=jkeys[i]).with_seeds().for_step(5)
        one = fi.lane(i)
        assert one.lanes is None and one.bers["gate"] == bers["gate"][i]
        for op, salt in (("q", 0), ("down", 7), ("sv", 31)):
            want_seed = int(jfi.seed_for(op, salt))
            assert fi.seed_for(op, salt)[i] == want_seed
            assert one.seed_for(op, salt) == want_seed
            want_key = np.asarray(jfi.key_for(op, salt)).astype(np.int64)
            np.testing.assert_array_equal(fi.key_for(op, salt)[i].numpy(),
                                          want_key)
            np.testing.assert_array_equal(one.key_for(op, salt).numpy(),
                                          want_key)
    with pytest.raises(ValueError, match="lane config"):
        fi.lane(0).lane(0)


# --------------------------------------------------------------------------- #
# FleetServeEngine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["llama3_8b", "deepseek_7b"])
def model(request):
    arch = request.param
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    lane_prompts = np.stack([prompts, prompts + 1, prompts + 2]) % cfg.vocab
    jf, pf = _fleets(3, AGES)
    return cfg_j, cfg, params_j, params, lane_prompts, jf, pf


def _engines(model, route, seed):
    cfg_j, cfg, params_j, params, _, jf, pf = model
    use_kernel, fused = ROUTES[route]
    kw = dict(max_len=32, seed=seed, use_systolic_kernel=use_kernel,
              use_fused_kernel=fused)
    return (JaxFleetServeEngine(cfg_j, params_j, jf, **kw),
            FleetServeEngine(cfg, params, pf, device="cpu", **kw))


@pytest.mark.parametrize("route", list(ROUTES))
def test_fleet_tokens_match_reference(model, route):
    """Greedy tokens of every lane equal the reference's vmapped dispatch
    on each route; the served BER matrix, ages and power match."""
    lane_prompts = model[4]
    jeng, peng = _engines(model, route, seed=5)
    want = jeng.generate(lane_prompts, 4)
    with enable_taps():
        got = peng.generate(lane_prompts, 4)
    assert got.tokens.shape == (3, 2, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.operators == tuple(want.operators)
    np.testing.assert_allclose(got.bers, np.asarray(want.bers),
                               rtol=BER_RTOL)
    np.testing.assert_array_equal(got.ages_years, want.ages_years)
    np.testing.assert_allclose(got.power_w, want.power_w, rtol=SHIFT_RTOL)
    assert {k: v.shape for k, v in got.telemetry.items()} == {
        "logit_max": (3, 4), "logit_margin": (3, 4)}


def test_fleet_sampled_tokens_match_reference(model):
    """T = 0.8, top_k 8: each lane samples from its own key chain."""
    lane_prompts = model[4]
    jeng, peng = _engines(model, "fused", seed=8)
    want = jeng.generate(lane_prompts, 4, temperature=0.8, top_k=8)
    got = peng.generate(lane_prompts, 4, temperature=0.8, top_k=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_fleet_prefill_logits_match_reference(model):
    """The lane-batched prefill's logits against ``jax.vmap`` of the
    reference's prefill with a batched FaultConfig, on the fused route."""
    cfg_j, cfg, params_j, params, lane_prompts, jf, pf = model
    L = len(AGES)
    jkeys = jax.random.split(jax.random.PRNGKey(13), L)
    jber = jnp.asarray(jf.op_ber_array(), jnp.float32)
    jfi = JaxFaultConfig(bers={op: jber[:, i]
                               for i, op in enumerate(jf.operators)},
                         key=jkeys, step=jnp.zeros((L,), jnp.int32))
    want, _ = jax.vmap(
        lambda p, f: jax_steps.make_prefill_fn(cfg_j, 32)(
            params_j, p, f.with_seeds()))(jnp.asarray(lane_prompts), jfi)
    ber = pf.op_ber_array()
    pfi = FaultConfig(bers={op: tuple(float(b) for b in ber[:, i])
                            for i, op in enumerate(pf.operators)},
                      key=prandom.split(prandom.PRNGKey(13), L)).with_seeds()
    got, cache = steps.prefill(params, cfg,
                               T(lane_prompts.reshape(2 * L, -1)), pfi, 32)
    np.testing.assert_allclose(got.numpy().reshape(np.shape(want)),
                               np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert cache[0]["k"].shape[0] == 2 * L


@pytest.mark.parametrize("sample", [{}, {"temperature": 0.8, "top_k": 8}],
                         ids=["greedy", "sampled"])
def test_fleet_lanes_equal_single_lane_replay(model, sample):
    """Every lane equals the port's single-device generation of its slice
    of the engine's lane config (``FaultConfig.lane(i)``) and of its
    sampling key: the folded forward changes nothing per lane."""
    cfg, params, lane_prompts = model[1], model[3], model[4]
    eng = FleetServeEngine(cfg, params, model[6], max_len=32, seed=6,
                           use_systolic_kernel=True, device="cpu")
    with enable_taps():
        res = eng.generate(lane_prompts, 4, **sample)
    _, call_key = prandom.split(prandom.PRNGKey(6))
    fi = eng._fleet_fault_config(call_key)
    keys = prandom.split(prandom.fold_in(call_key, 1), 3)
    for i in range(3):
        toks, telem, _ = steps.generate(
            params, cfg, T(lane_prompts[i]), fi.lane(i), keys[i], max_len=32,
            n_steps=4, **sample)
        np.testing.assert_array_equal(res.tokens[i], toks)
        for k, v in telem.items():
            np.testing.assert_allclose(res.telemetry[k][i], v, rtol=1e-6)


def test_fleet_engine_shards_a_flat_batch(model):
    cfg, params, lane_prompts = model[1], model[3], model[4]
    fleet = FleetRuntime(n_devices=2, device="cpu")
    fleet.set_age(years=1.0)
    eng = FleetServeEngine(cfg, params, fleet, max_len=32, seed=5,
                           device="cpu")
    flat = np.concatenate([lane_prompts[0], lane_prompts[1]])   # (4, S)
    res = eng.generate(flat, 3)
    assert res.tokens.shape == (2, 2, 3)
    assert res.ages_years.shape == (2,) and res.power_w.shape == (2,)
    # a flat (N, S) batch is one prompt per lane, not a rank-1 lane batch
    assert eng.generate(lane_prompts[0], 3).tokens.shape == (2, 1, 3)
    with pytest.raises(ValueError, match="lane dim"):
        eng.generate(lane_prompts, 3)
    with pytest.raises(ValueError, match="flat"):
        eng.generate(lane_prompts[0][:1], 3)


def test_fleet_engine_applies_load_before_serving():
    """``router=`` ages the fleet under routed traffic once, at
    construction (``FleetRuntime.apply_load``), and the lanes then serve
    the traffic-aged BERs (parity with the reference:
    ``tests/test_torch_fleet_load.py``)."""
    from repro_torch.models.transformer import init_params
    cfg = get_config("llama3_8b").reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    fleet = FleetRuntime(n_devices=2, device="cpu")
    fleet.set_age(years=4.0, device=1)
    static = fleet.op_ber_array().copy()
    eng = FleetServeEngine(cfg, params, fleet, max_len=32, seed=5,
                           router="wear_level",
                           apply_load_kw={"n_epochs": 12,
                                          "utilization": 0.6},
                           device="cpu")
    assert fleet.last_cosim is not None and fleet.last_cosim.n_epochs == 12
    res = eng.generate(np.ones((2, 1, 8), np.int64), 2)
    np.testing.assert_array_equal(res.bers, fleet.op_ber_array())
    assert not np.array_equal(res.bers, static)
    np.testing.assert_allclose(res.ages_years,
                               fleet.last_cosim.t[-1] / SECONDS_PER_YEAR)


def test_fleet_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    cfg = get_config("llama3_8b").reduced()
    fleet = FleetRuntime(n_devices=2, device="cpu")
    params = {"embed": torch.zeros((cfg.vocab, cfg.d_model))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetServeEngine(cfg, params, fleet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRuntime(n_devices=2, scenario=_scenarios()[1])
