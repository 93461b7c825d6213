"""The port's measured-resilience path vs the JAX reference on the CPU:
``grid_fault_config``'s lanes and keys, ``run_sweep``'s loss surface on
the kernel-free and the fused route (the reference's Pallas kernel in
interpret mode), chunk invariance, ``fit_curve`` / ``fit_sweep``, the
artifact and its byte-identical copy, ``MeasuredResiliencePolicy``
(thresholds, Table II), ``FleetRuntime`` / ``for_model`` with
``policy="measured"``, the missing-model hint, the serving example's
``recalibrate_for_deployment``, the calibration CLI and the bench."""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.calibrate import resilience_sweep as jrs
from repro.configs import get_config as jax_get_config
from repro.core import resilience as jres
from repro.core.artifacts import load_calibration as jax_load_calibration
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.core.policy import MeasuredResiliencePolicy as JaxMeasured
from repro.core.policy import evaluate_policy as jax_evaluate_policy
from repro.core.scenario import Scenario as JaxScenario
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import random as prandom
from repro_torch.calibrate import resilience_sweep as rs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import resilience
from repro_torch.core.artifacts import load_calibration
from repro_torch.core.fleet import FleetRuntime
from repro_torch.core.policy import (FaultTolerantPolicy,
                                     MeasuredResiliencePolicy,
                                     evaluate_policy, get_policy)
from repro_torch.core.scenario import Scenario
from repro_torch.data import SyntheticLM
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
GRID = (1e-5, 1e-3, 3e-2)
# thresholds and lifetimes: the float32 physics' known drift against XLA
# (ROADMAP §C), as tests/test_torch_physics_api.py holds them
SHIFT_RTOL = 1e-5
BER_RTOL = 1e-3


def _plain(curves):
    """Curves of either package as comparable ``{op: (ber50, k, l_max)}``."""
    return {op: (c.ber50, c.steepness, c.l_max) for op, c in curves.items()}


@pytest.fixture(scope="module")
def setup():
    """Reduced llama3_8b from the reference's ``init_train_state``
    (PRNGKey 0), carried across; B=2, S=16 tokens of step 0."""
    jcfg = jax_get_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    jparams = jax_init_train_state(jcfg, jax.random.PRNGKey(0)).params
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    tokens = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                         global_batch=2).batch_at(0).tokens
    assert np.array_equal(tokens, JaxSyntheticLM(
        vocab=jcfg.vocab, seq_len=16, global_batch=2).batch_at(0).tokens)
    return jcfg, cfg, jparams, params, tokens


@pytest.fixture(scope="module")
def surfaces(setup):
    """The kernel-free 3 BERs x 9 operators surface, one seed, both
    packages."""
    jcfg, cfg, jparams, params, tokens = setup
    want = jrs.run_sweep(jcfg, jparams, tokens, ber_grid=GRID, n_seeds=1)
    got = rs.run_sweep(cfg, params, tokens, ber_grid=GRID, n_seeds=1,
                       device="cpu")
    return want, got


@pytest.fixture(scope="module")
def cals():
    return jax_load_calibration(), load_calibration()


def test_grid_fault_config_lanes_and_keys_match_reference():
    ops = ("q", "k", "o")
    grid = (1e-5, 1e-3)
    want = jrs.grid_fault_config(ops, grid, jax.random.PRNGKey(3),
                                 use_kernel=True, fused=True)
    got = rs.grid_fault_config(ops, grid, prandom.PRNGKey(3),
                               use_kernel=True, fused=True)
    assert got.lanes == 6 and got.use_systolic_kernel and got.fused
    for op in ops:
        np.testing.assert_array_equal(np.asarray(got.bers[op], np.float32),
                                      np.asarray(want.bers[op]))
    np.testing.assert_array_equal(got.key.numpy().astype(np.uint32),
                                  np.asarray(want.key))
    np.testing.assert_array_equal(np.asarray(want.step), np.zeros(6))
    assert got.bers["k"] == (0.0, float(np.float32(1e-5)), 0.0,
                             0.0, float(np.float32(1e-3)), 0.0)


def test_sweep_plain_route_matches_reference(surfaces):
    want, got = surfaces
    assert got.operators == tuple(want.operators)
    assert got.model == want.model and got.family == want.family
    np.testing.assert_array_equal(got.ber_grid, want.ber_grid)
    np.testing.assert_array_equal(got.loss_pct, want.loss_pct)
    assert got.loss_pct.dtype == np.float64
    # the surface is informative: clean at 1e-5 for most ops, collapsed
    # at 3e-2
    assert got.loss_pct[0].max() < 20.0 and got.loss_pct[-1].min() > 40.0


def test_sweep_fused_route_matches_reference(setup):
    """The fused route (the reference's Pallas kernel in interpret mode,
    the port's plain lane version of the CUDA kernel) on a 1 x 2 grid."""
    jcfg, cfg, jparams, params, tokens = setup
    kw = dict(ber_grid=(1e-3,), operators=("q", "o"), n_seeds=1,
              use_kernel=True, fused=True)
    want = jrs.run_sweep(jcfg, jparams, tokens[:1, :8], **kw)
    got = rs.run_sweep(cfg, params, tokens[:1, :8], device="cpu", **kw)
    np.testing.assert_array_equal(got.loss_pct, want.loss_pct)


def test_sweep_two_seeds_match_reference(setup):
    """Seeds are ``fold_in(key, s)``; the per-seed losses average in
    numpy as the reference averages them."""
    jcfg, cfg, jparams, params, tokens = setup
    kw = dict(ber_grid=(1e-3, 1e-2), operators=("k", "sv", "down"),
              n_seeds=2, seed=7)
    want = jrs.run_sweep(jcfg, jparams, tokens, **kw)
    got = rs.run_sweep(cfg, params, tokens, device="cpu", **kw)
    np.testing.assert_array_equal(got.loss_pct, want.loss_pct)


@pytest.mark.parametrize("chunk", [1, 4, 27])
def test_chunk_changes_no_loss(setup, surfaces, chunk):
    _, cfg, _, params, tokens = setup
    got = rs.run_sweep(cfg, params, tokens, ber_grid=GRID, n_seeds=1,
                       chunk=chunk, device="cpu")
    np.testing.assert_array_equal(got.loss_pct, surfaces[1].loss_pct)


def test_default_chunk_fits_the_budget():
    cfg = get_config("llama3_8b")
    rows = 8 * 64
    assert rs.lane_bytes(cfg, rows) == rows * 4 * (cfg.vocab + 6 * cfg.d_ff)
    # on the CPU: a fixed budget, never more than one launch's lanes
    assert rs.default_chunk(cfg, rows, 108, "cpu") == int(
        rs.CPU_CHUNK_BUDGET_BYTES // rs.lane_bytes(cfg, rows))
    small = cfg.reduced()
    assert rs.default_chunk(small, 32, 108, "cpu") == 32
    assert rs.default_chunk(small, 32, 9, "cpu") == 9


def test_fit_matches_reference(surfaces):
    want, got = surfaces
    assert _plain(rs.fit_sweep(got)) == _plain(jrs.fit_sweep(want))
    for j in range(len(got.operators)):
        a = resilience.fit_curve(got.ber_grid, got.loss_pct[:, j])
        b = jres.fit_curve(want.ber_grid, want.loss_pct[:, j])
        assert (a.ber50, a.steepness, a.l_max) == \
            (b.ber50, b.steepness, b.l_max)


def test_fit_recovers_planted_knees():
    """Losses from known curves come back with their knees, as the
    reference's harness test plants them."""
    ops = ("q", "o", "down")
    planted = {"q": resilience.ResilienceCurve(ber50=3e-4, steepness=4.0),
               "o": resilience.ResilienceCurve(ber50=2e-6, steepness=6.0),
               "down": resilience.ResilienceCurve(ber50=5e-5,
                                                  steepness=3.0)}
    grid = np.logspace(-8, -2, 25)
    loss = np.stack([[planted[op].accuracy_loss(b) for op in ops]
                     for b in grid])
    res = rs.SweepResult(model="synthetic", family="dense", operators=ops,
                         ber_grid=grid, loss_pct=loss, n_seeds=1)
    curves = rs.fit_sweep(res)
    jcurves = jrs.fit_sweep(jrs.SweepResult(
        model="synthetic", family="dense", operators=ops, ber_grid=grid,
        loss_pct=loss, n_seeds=1))
    assert _plain(curves) == _plain(jcurves)
    for op in ops:
        assert np.log10(curves[op].ber50) == pytest.approx(
            np.log10(planted[op].ber50), abs=0.35)


def test_artifact_round_trip(tmp_path, surfaces):
    """``write_artifact`` writes the reference's layout where it is told,
    merges, and clears the loader's cache; ``measured_curves`` reads it
    back (config-name spellings too)."""
    want, got = surfaces
    curves, jcurves = rs.fit_sweep(got), jrs.fit_sweep(want)
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    meta = {"mode": "test"}
    rs.write_artifact({"llama3_8b": (got, curves)}, meta, path=path)
    jrs.write_artifact({"llama3_8b": (want, jcurves)}, meta, path=jpath)
    a, b = json.load(open(path)), json.load(open(jpath))
    assert a["models"] == b["models"]
    assert a["_meta"]["metric"] == b["_meta"]["metric"]
    assert "repro_torch.launch.calibrate_resilience" in \
        a["_meta"]["generator"]
    assert resilience.measured_curves("llama3_8b", path) == curves
    assert resilience.measured_curves("llama3-8b", path) == curves
    # a second model merges; the loader sees it without a cache clear
    rs.write_artifact({"other": (got, curves)}, meta, path=path)
    assert set(resilience.load_measured(path)["models"]) == {"llama3_8b",
                                                             "other"}
    jres.load_measured.cache_clear()


def test_checked_in_artifact_is_the_reference_copy():
    port = ROOT / "src" / "repro_torch" / "core" / "resilience_calibrated.json"
    ref = ROOT / "src" / "repro" / "core" / "resilience_calibrated.json"
    assert port.read_bytes() == ref.read_bytes()
    assert resilience.MEASURED_PATH == str(port)
    for model in ("llama3_8b", "qwen3_moe_235b", "rwkv6_3b"):
        assert _plain(resilience.measured_curves(model)) == \
            _plain(jres.measured_curves(model))


def test_missing_model_hint():
    with pytest.raises(KeyError, match="calibrate_resilience"):
        resilience.measured_curves("no_such_model_xyz")
    with pytest.raises(FileNotFoundError, match="calibrate_resilience"):
        resilience.load_measured("/nonexistent/measured.json")


@pytest.mark.parametrize("source", ["default_curves", "artifact"])
def test_measured_policy_thresholds_match_reference(cals, source):
    jc, pc = cals
    kw = ({"curves": resilience.default_curves()}
          if source == "default_curves" else {"model": "llama3_8b"})
    jkw = ({"curves": jres.default_curves()}
           if source == "default_curves" else {"model": "llama3_8b"})
    got = MeasuredResiliencePolicy(ber_model=pc.ber, **kw)
    want = JaxMeasured(ber_model=jc.ber, **jkw)
    scn = Scenario.from_lifetime_config(pc.lifetime_cfg)
    jscn = JaxScenario.from_lifetime_config(jc.lifetime_cfg)
    batch = scn.replace(max_loss_pct=np.asarray([0.1, 0.5, 2.0]))
    jbatch = jscn.replace(max_loss_pct=np.asarray([0.1, 0.5, 2.0]))
    for s, js in ((scn, jscn), (batch, jbatch)):
        np.testing.assert_allclose(got.thresholds(s).numpy(),
                                   np.asarray(want.thresholds(js)),
                                   rtol=SHIFT_RTOL)
    assert got.tolerable_ber() == want.tolerable_ber()
    if source == "default_curves":
        ft = FaultTolerantPolicy(ber_model=pc.ber)
        np.testing.assert_array_equal(got.thresholds(batch).numpy(),
                                      ft.thresholds(batch).numpy())
    else:
        assert get_policy("measured", ber_model=pc.ber).tolerable_ber() \
            == want.tolerable_ber()


def test_measured_policy_table2_from_default_curves(cals):
    """Fed the published curves, the measured policy regenerates Table II
    as the reference's does."""
    jc, pc = cals
    got = evaluate_policy(
        MeasuredResiliencePolicy(ber_model=pc.ber,
                                 curves=resilience.default_curves()),
        pc.aging, pc.delay_poly, pc.power,
        Scenario.from_lifetime_config(pc.lifetime_cfg), device="cpu")
    want = jax_evaluate_policy(
        JaxMeasured(ber_model=jc.ber, curves=jres.default_curves()),
        jc.aging, jc.delay_poly, jc.power,
        JaxScenario.from_lifetime_config(jc.lifetime_cfg))
    assert abs(got["avg_power_saving_pct"] - 14.0) < 2.0
    assert got["avg_power_saving_pct"] == pytest.approx(
        want["avg_power_saving_pct"], rel=1e-4)
    for op in resilience.OPERATORS:
        assert got[op]["v_final"] == want[op]["v_final"], op


def test_fleet_runtime_measured_policy(cals):
    jf = JaxFleetRuntime(n_devices=2, policy="measured")
    pf = FleetRuntime(n_devices=2, policy="measured", device="cpu")
    for f in (jf, pf):
        f.set_age(years=5.0)
    assert pf.policy.name == "measured" and pf.policy.model == "llama3_8b"
    np.testing.assert_allclose(pf.op_ber_array(), jf.op_ber_array(),
                               rtol=BER_RTOL)
    np.testing.assert_array_equal(pf.snapshot().v_dd, jf.snapshot().v_dd)


def test_for_model_measured_policy():
    """``for_model(policy="measured")`` is keyed on the model's name and
    takes its family's operator set: qwen3_moe_235b's ten domains, the
    router's included (the reference's own test uses rwkv6_3b, a family
    the port has not ported)."""
    cfg = get_config("qwen3_moe_235b").reduced()
    jcfg = jax_get_config("qwen3_moe_235b").reduced()
    pf = FleetRuntime.for_model(cfg, policy="measured", n_devices=2,
                                device="cpu")
    jf = JaxFleetRuntime.for_model(jcfg, policy="measured", n_devices=2)
    assert pf.policy.model == cfg.name == jf.policy.model
    assert pf.operators == tuple(jf.operators)
    assert "router" in pf.operators
    for f in (jf, pf):
        f.set_age(years=6.0)
    np.testing.assert_allclose(pf.op_ber_array(), jf.op_ber_array(),
                               rtol=BER_RTOL)
    # the router's curve comes from the artifact, not the default
    curves = pf.policy._curves_for(pf.operators)
    assert curves["router"] == resilience.measured_curves(
        "qwen3_moe_235b")["router"]
    assert curves["router"] != resilience.default_curves(
        ("router",))["router"]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "aging_aware_serving_reference",
        ROOT / "examples" / "aging_aware_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_recalibration_matches_reference(setup, capsys):
    from repro_torch.examples import aging_aware_serving
    jcfg, cfg, jparams, params, tokens = setup
    want = _reference_example().recalibrate_for_deployment(
        jcfg, jparams, tokens, ber_grid=(1e-5, 1e-3), n_seeds=1)
    got = aging_aware_serving.recalibrate_for_deployment(
        cfg, params, tokens, ber_grid=(1e-5, 1e-3), n_seeds=1,
        device="cpu")
    assert set(got) == set(resilience.OPERATORS)
    assert _plain(got) == _plain(want)
    assert "measured" in capsys.readouterr().out


def test_calibration_cli_quick_and_report(tmp_path, capsys):
    """The CLI writes where ``--out`` says, and ``--report`` reads it."""
    from repro_torch.launch import calibrate_resilience as cli
    out = str(tmp_path / "quick.json")
    entries = cli.main(["--quick", "--train-steps", "2", "--batch", "2",
                        "--seq-len", "16", "--device", "cpu", "--out", out])
    assert set(entries) == {"llama3_8b"}
    blob = json.load(open(out))
    assert blob["_meta"]["mode"] == "quick"
    assert len(blob["models"]["llama3_8b"]["ber_grid"]) == 5
    rep = cli.main(["--report", "--device", "cpu", "--out", out])
    assert set(rep["models"]) == {"llama3_8b"}
    assert abs(rep["published_avg_saving_pct"] - 14.0) < 2.0
    assert "[report]" in capsys.readouterr().out


def test_resilience_bench_cpu(tmp_path):
    from repro_torch.benchmarks import resilience_bench
    out = tmp_path / "bench.json"
    assert resilience_bench.main(["--quick", "--device", "cpu",
                                  "--out", str(out)]) == 0
    rec = json.load(open(out))
    assert rec["rows"]["lanes"] == 27
    assert all(c["ok"] for c in rec["checks"])


def test_windowed_sweep_matches_reference(setup):
    """A sliding window (reduced llama3_8b at ``window=4``, which the port
    used to refuse) changes the surface as it does the reference's."""
    import dataclasses
    jcfg, cfg, jparams, params, tokens = setup
    kw = dict(ber_grid=(1e-3, 1e-2), operators=("qkt", "sv", "o"),
              n_seeds=1)
    want = jrs.run_sweep(dataclasses.replace(jcfg, window=4), jparams,
                         tokens, **kw)
    got = rs.run_sweep(dataclasses.replace(cfg, window=4), params, tokens,
                       device="cpu", **kw)
    np.testing.assert_array_equal(got.loss_pct, want.loss_pct)
