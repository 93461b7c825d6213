"""The port's telemetry vs the JAX reference on the CPU: the serving
engines return and record their taps only under ``enable_taps`` (C.4,
ROADMAP §C), ``cosim_taps`` of a co-sim trajectory, the ``Telemetry``
bundle and the toggle, and the export sinks (JSONL, the Prometheus text,
equal to the reference's text for the same samples)."""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.obs import export as jax_export
from repro.obs import metrics as jax_metrics
from repro.obs.taps import cosim_taps as jax_cosim_taps
from repro.obs.taps import enable_taps as jax_enable_taps
from repro.obs.taps import telemetry_to_host as jax_telemetry_to_host
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.data import SyntheticLM
from repro_torch.obs import export, metrics
from repro_torch.obs.taps import (Telemetry, cosim_taps, enable_taps,
                                  taps_enabled, telemetry_to_host)
from repro_torch.sched.lifetime import CoSimTrajectory
from repro_torch.serve.engine import FleetServeEngine, ServeEngine

YEAR_S = 365.25 * 24 * 3600.0
LOGIT_ATOL = 1e-4         # the port's logits against the reference's
BER_RTOL = 1e-3           # served BERs (ROADMAP §C, known drift)
QUANTILE_RTOL = 0.05      # a histogram quantile is a 1.05-growth bucket


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    jparams = jax_init_train_state(jcfg, jax.random.PRNGKey(0)).params
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=4).batch_at(0).tokens
    return jcfg, cfg, jparams, params, prompts


def _recorded(registry, prefixes=("serve_", "fleet_")):
    """``{sample name + labels: Sample}`` of the serving instruments that
    hold something (a reset counter, gauge or histogram exports zeros);
    trace counters are left out (the port traces nothing)."""
    out = {}
    for name in registry.names():
        m = registry.get(name)
        if not name.startswith(prefixes) or isinstance(m, dict):
            continue
        empty = (getattr(m, "count", None) == 0
                 or getattr(m, "value", None) == 0.0
                 or (isinstance(getattr(m, "value", None), float)
                     and math.isnan(m.value)))
        if not empty:
            for s in m.samples():
                out[(s.name, s.labels)] = s
    return out


def _assert_same_records(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert (g.kind, g.help) == (w.kind, w.help), key
        name = key[0]
        if name.endswith("_s_sum") or (name.endswith("_s")
                                       and key[1]):
            continue                     # wall-clock spans: counts only
        if name.startswith("serve_admitted_ber"):
            assert g.value == pytest.approx(w.value, rel=BER_RTOL), key
        elif name.endswith("_sum"):
            assert g.value == pytest.approx(w.value, rel=1e-5,
                                            abs=LOGIT_ATOL), key
        elif key[1]:
            assert g.value == pytest.approx(w.value, rel=QUANTILE_RTOL), key
        else:
            assert g.value == w.value, key


def _aged(fleet_cls, n, **kw):
    f = fleet_cls(n_devices=n, **kw)
    for i, age in enumerate((9.0, 3.0, 6.0)[:n]):
        f.set_age(years=age, device=i)
    return f


def test_serve_telemetry_only_under_taps(model):
    """C.4: ``generate`` returns ``telemetry=None`` unless taps are on;
    on, the taps equal the reference's and the call lands in REGISTRY as
    the reference's does; tokens equal either way."""
    jcfg, cfg, jparams, params, prompts = model
    jrt = _aged(JaxFleetRuntime, 1)
    prt = _aged(FleetRuntime, 1, device="cpu")
    make_j = lambda: JaxServeEngine(jcfg, jparams, runtime=jrt, max_len=32,
                                    seed=5)
    make_p = lambda: ServeEngine(cfg, params, runtime=prt, max_len=32,
                                 seed=5, device="cpu")
    jax_metrics.clear_caches()
    metrics.clear_caches()
    jax_metrics.REGISTRY.reset()
    metrics.REGISTRY.reset()
    off, joff = make_p().generate(prompts, 4), make_j().generate(prompts, 4)
    assert off.telemetry is None and joff.telemetry is None
    assert _recorded(metrics.REGISTRY) == {}
    jax_metrics.clear_caches()          # the next call of each is cold
    metrics.clear_caches()
    with enable_taps(), jax_enable_taps():
        on, jon = make_p().generate(prompts, 4), make_j().generate(prompts, 4)
        make_p().generate(prompts, 4)            # a warm call of each
        make_j().generate(prompts, 4)
    np.testing.assert_array_equal(off.tokens, on.tokens)
    np.testing.assert_array_equal(on.tokens, jon.tokens)
    assert set(on.telemetry) == set(jon.telemetry) == {"logit_max",
                                                       "logit_margin"}
    for k, v in jon.telemetry.items():
        assert on.telemetry[k].shape == v.shape == (4,)
        np.testing.assert_allclose(on.telemetry[k], v, rtol=0,
                                   atol=LOGIT_ATOL)
    got, want = _recorded(metrics.REGISTRY), _recorded(jax_metrics.REGISTRY)
    assert got[("serve_generate_calls_total", ())].value == 2.0
    assert got[("serve_generate_compile_s_count", ())].value == 1.0
    assert got[("serve_generate_warm_s_count", ())].value == 1.0
    _assert_same_records(got, want)


def test_fleet_telemetry_only_under_taps(model):
    jcfg, cfg, jparams, params, prompts = model
    jf = _aged(JaxFleetRuntime, 2)
    pf = _aged(FleetRuntime, 2, device="cpu")
    lanes = prompts.reshape(2, 2, -1)
    make_j = lambda: JaxFleetServeEngine(jcfg, jparams, jf, max_len=32,
                                         seed=3)
    make_p = lambda: FleetServeEngine(cfg, params, pf, max_len=32, seed=3,
                                      device="cpu")
    jax_metrics.clear_caches()
    metrics.clear_caches()
    jax_metrics.REGISTRY.reset()
    metrics.REGISTRY.reset()
    off, joff = make_p().generate(lanes, 3), make_j().generate(lanes, 3)
    assert off.telemetry is None and joff.telemetry is None
    assert _recorded(metrics.REGISTRY) == {}
    jax_metrics.clear_caches()
    metrics.clear_caches()
    with enable_taps(), jax_enable_taps():
        on, jon = make_p().generate(lanes, 3), make_j().generate(lanes, 3)
    np.testing.assert_array_equal(off.tokens, on.tokens)
    np.testing.assert_array_equal(on.tokens, jon.tokens)
    for k, v in jon.telemetry.items():
        assert on.telemetry[k].shape == v.shape == (2, 3)
        np.testing.assert_allclose(on.telemetry[k], v, rtol=0,
                                   atol=LOGIT_ATOL)
    got, want = _recorded(metrics.REGISTRY), _recorded(jax_metrics.REGISTRY)
    assert got[("fleet_generate_calls_total", ())].value == 1.0
    assert got[("fleet_generate_compile_s_count", ())].value == 1.0
    _assert_same_records(got, want)


@pytest.fixture(scope="module")
def cosims():
    """The reference's co-sim of a 2-device fleet (recovery and thermal
    on, so every tap is present) and the port's own of the same fleet."""
    kw = dict(workload="diurnal", utilization=0.7, n_epochs=96,
              horizon_s=2 * YEAR_S, recovery=True, thermal=True)
    jf, pf = _aged(JaxFleetRuntime, 2), _aged(FleetRuntime, 2, device="cpu")
    return jf, jf.apply_load(**kw), pf, pf.apply_load(**kw)


def test_cosim_taps_equal_reference_on_the_same_cosim(cosims):
    """The reference's trajectory, read by both packages' ``cosim_taps``:
    every series equal bit for bit."""
    jf, jcos, pf, _ = cosims
    fields = {f.name: None if getattr(jcos, f.name) is None
              else np.asarray(getattr(jcos, f.name))
              for f in dataclasses.fields(CoSimTrajectory)}
    same = CoSimTrajectory(**fields)
    want = jax_telemetry_to_host(jax_cosim_taps(jcos, jf.unit_scenario))
    got = telemetry_to_host(cosim_taps(same, pf.unit_scenario))
    assert set(got) == set(want) == {
        "dvth_eff_mv", "dvth_mono_mv", "headroom_s", "vdd_v", "util",
        "t_node_k", "boosts"}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cosim_taps_of_the_ports_cosim(cosims):
    """The port's own co-sim's taps against the reference's: the supplies
    and the routing equal, the shifts within the co-sim's known drift."""
    jf, jcos, pf, pcos = cosims
    want = jax_telemetry_to_host(jax_cosim_taps(jcos, jf.unit_scenario))
    got = telemetry_to_host(cosim_taps(pcos, pf.unit_scenario))
    assert got["dvth_eff_mv"].shape == (2, 96)
    np.testing.assert_array_equal(got["vdd_v"], want["vdd_v"])
    np.testing.assert_array_equal(got["boosts"], want["boosts"])
    for k in ("dvth_eff_mv", "dvth_mono_mv", "t_node_k", "util"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert (got["dvth_mono_mv"] >= got["dvth_eff_mv"] - 1e-5).all()


def test_telemetry_bundle_and_toggle():
    t = Telemetry({"b": np.ones(3), "a": np.zeros(2)})
    assert sorted(t.keys()) == ["a", "b"] and "a" in t
    assert t["b"].shape == (3,)
    assert repr(t) == "Telemetry(['a', 'b'])"
    assert telemetry_to_host(None) is None
    import torch
    host = telemetry_to_host(Telemetry({"x": torch.arange(3)}))
    assert isinstance(host["x"], np.ndarray)
    assert not taps_enabled()
    with enable_taps():
        assert taps_enabled()
        with enable_taps(False):
            assert not taps_enabled()
        assert taps_enabled()
    assert not taps_enabled()


def _populated(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve_tokens", "tokens generated").inc(48)
    reg.gauge("serve_admitted_ber_max", "worst BER").set(2.5e-5)
    h = reg.histogram("serve_logit_max", "per-step serving health")
    h.observe_many([1.5, 2.25, 0.0, 3.125, 7.0])
    tc = reg.trace_counter("sweep")
    tc['a "quoted", site\\n'] += 3
    return reg


def test_prometheus_text_equals_reference():
    reg = _populated(metrics)
    samples = reg.collect()
    jsamples = [jax_metrics.Sample(*dataclasses.astuple(s)) for s in samples]
    text = export.prometheus_text(samples)
    assert text == jax_export.prometheus_text(jsamples)
    # and the port's registry exports what the reference's exports for the
    # same observations, but for the trace counter's help text
    jtext = jax_export.prometheus_text(registry=_populated(jax_metrics))
    assert [ln for ln in text.splitlines() if not ln.startswith("# HELP")] \
        == [ln for ln in jtext.splitlines() if not ln.startswith("# HELP")]
    assert export.prometheus_text(registry=reg) == text
    back = export.parse_prometheus(text)
    assert [(s.name, s.labels, s.value, s.kind) for s in back] == \
        [(s.name, s.labels, s.value, s.kind) for s in samples]
    assert [(s.name, s.labels, s.value) for s in back] == \
        [(s.name, s.labels, s.value)
         for s in jax_export.parse_prometheus(text)]


def test_jsonl_round_trip(tmp_path):
    reg = _populated(metrics)
    reg.gauge("empty_gauge")                # NaN survives as null
    samples = reg.collect()
    path = tmp_path / "run.jsonl"
    man = export.run_manifest("smoke", note="x")
    assert man["schema"] == 1 and "torch" in man and "device" in man
    assert "jax" not in man
    n = export.write_jsonl(path, samples, manifest=man,
                           health={"n_units": 2}, events=[{"phase": "a"}])
    assert n == 3 + len(samples)
    manifest, back, other = export.read_jsonl(path)
    assert manifest == man
    assert other == [{"type": "health", "n_units": 2},
                     {"type": "event", "phase": "a"}]
    assert len(back) == len(samples)
    for a, b in zip(back, samples):
        assert (a.name, a.labels, a.kind) == (b.name, b.labels, b.kind)
        assert a.value == b.value or (math.isnan(a.value)
                                      and math.isnan(b.value))
    # the reference's reader takes the port's log
    _, jback, _ = jax_export.read_jsonl(path)
    assert [(s.name, s.labels) for s in jback] == \
        [(s.name, s.labels) for s in samples]
