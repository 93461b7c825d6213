"""The port's ``launch.obs_report`` (``--mode cosim`` and ``--mode
online``, with ``--jsonl`` / ``--prom``) against the reference's
``main(argv)``, and the ported ``online_bench`` / ``obs_bench`` (their
workload sweep against the reference's ``bench_workloads``, and both
through ``benchmarks.run``) on the CPU.  Both packages serve the
reference's seed-0 params through the launchers' params hook.  Counts,
latencies and occupancy exact; the health table's physics within the
drift ROADMAP §C states (ΔVth and headroom 1e-5 relative, BER 1e-3)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import online_bench as jax_online_bench
from repro.launch import obs_report as jax_obs_report
from repro_torch.benchmarks import obs_bench, online_bench, run
from repro_torch.launch import obs_report, serve
from repro_torch.obs import export

from test_torch_launch import reference_served_params
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SHIFT_RTOL = 1e-5
BER_RTOL = 1e-3


@pytest.fixture(autouse=True)
def reference_params(monkeypatch):
    monkeypatch.setattr(serve, "served_params", reference_served_params)
    monkeypatch.setattr(online_bench, "served_params",
                        reference_served_params)


def _assert_health(got, want):
    d, jd = got.to_dict(), want.to_dict()
    assert d["operators"] == jd["operators"]
    for u, ju in zip(d["units"], jd["units"]):
        assert u["age_years"] == pytest.approx(ju["age_years"], rel=1e-9)
        for k in ("dvth_p_mv", "headroom_ps"):
            assert u[k] == pytest.approx(ju[k], rel=SHIFT_RTOL), k
        assert u["ber"] == pytest.approx(ju["ber"], rel=BER_RTOL)


@pytest.mark.parametrize("mode", ["cosim", "online"])
def test_obs_report_matches_reference(mode, tmp_path, capsys):
    argv = ["--mode", mode, "--quick", "--arch", "llama3_8b"]
    got = obs_report.main(argv + ["--device", "cpu", "--jsonl",
                                  str(tmp_path / "a.jsonl"), "--prom",
                                  str(tmp_path / "a.prom")])
    out = capsys.readouterr().out
    want = jax_obs_report.main(argv)
    jout = capsys.readouterr().out
    _assert_health(got, want)
    first = lambda text: [l for l in text.splitlines()
                          if l.startswith("[obs] ")][0]
    assert first(out) == first(jout)
    if mode == "online":
        for k in ("p50_latency_steps", "p99_latency_steps", "drop_rate",
                  "n_completed"):
            assert got.extra[k] == want.extra[k], k
        assert got.extra["tok_per_s"] > 0
        assert "online_prefill" in got.cache_stats \
            or "online_fleet_prefill" in got.cache_stats
    else:
        assert got.extra == want.extra == {}
    manifest, samples, events = export.read_jsonl(tmp_path / "a.jsonl")
    assert manifest["run"] == f"obs_report:{mode}"
    assert samples and export.parse_prometheus(
        (tmp_path / "a.prom").read_text())


def test_online_bench_workloads_match_reference():
    """The quick workload sweep serves the reference's queues: the same
    arrivals, completions, drops, latencies and occupancy."""
    _, want = jax_online_bench.bench_workloads(quick=True)
    cfg, params = online_bench._setup(torch.device("cpu"))
    _, got, drained = online_bench.bench_workloads(cfg, params,
                                                   torch.device("cpu"), True)
    assert drained and set(got) == set(want)
    for name in want:
        for k in ("n_arrived", "n_dropped", "n_completed", "total_steps",
                  "n_tokens", "mean_occupancy", "p50", "p99"):
            assert got[name][k] == pytest.approx(want[name][k], abs=1e-12), \
                (name, k)


def test_run_online_obs_quick(tmp_path, capsys):
    """``run --only online --quick``: every check passes on the CPU (the
    launch-count guard says it needs a card), the record goes under
    ``--out-dir`` and no repo-root BENCH_*.json is touched; ``obs_bench``'s
    quick run: its structural checks pass and the taps-overhead check
    keeps its 1.10x limit (the ratio is a host-clock reading, held on the
    card)."""
    before = {p: p.stat().st_mtime_ns for p in ROOT.glob("BENCH_*.json")}
    out = tmp_path / "bench"
    rc = run.main(["--only", "online", "--quick", "--device", "cpu",
                   "--out-dir", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "not run: it needs a card" in text
    rec = json.loads((out / "online.json").read_text())
    assert [c["ok"] for c in rec["checks"]] == [True] * 4
    assert rec["rows"]["structural"] == {"no_arrival_bit_exact": True,
                                         "no_new_served_shapes": True}
    res = obs_bench.evaluate(device="cpu", quick=True)
    names = [c["name"] for c in res["checks"]]
    assert names[0].startswith("taps overhead <= 1.10x")
    assert all(c["ok"] for c in res["checks"][1:]), res["checks"]
    ov = res["rows"]["overhead"]
    assert ov["limit"] == 1.10 and np.isfinite(
        [ov["serve_ratio"], ov["online_ratio"]]).all()
    assert {p: p.stat().st_mtime_ns
            for p in ROOT.glob("BENCH_*.json")} == before
