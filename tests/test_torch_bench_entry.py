"""The port's quickstart and benchmark entry points on the CPU:
``repro_torch.examples.quickstart`` and ``launch.serve --use-kernel``
against the reference's (the reference's params served through the
launcher's params hook), and the ported ``scenario_bench``,
``serve_bench``, ``kernel_bench`` and ``run`` (``--only`` over the
unported sections raises naming its ROADMAP item; ``--summary`` writes
only under its output directory)."""
import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (kernel_bench, run, scenario_bench,
                                    serve_bench)
from repro_torch.examples import quickstart

from test_torch_launch import reference_served_params
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def test_scenario_bench_cpu():
    res = scenario_bench.evaluate(device="cpu", n_loop=1)
    assert res["rows"]["lifetimes"] == 81
    assert [c["name"] for c in res["checks"]] == [
        "one batched sweep beats the per-scenario loop"]


def test_serve_bench_quick_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--quick", "--device", "cpu",
                             "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["rows"]["decode"]["decode_tok_s"] > 0
    assert rec["rows"]["fleet"]["n_devices"] == 2
    assert rec["checks"] == []       # the structural guards need a card
    assert "not run: they need a card" in capsys.readouterr().out


def test_kernel_bench_cpu_plans_bounds_parity():
    res = kernel_bench.evaluate(device="cpu")
    rows = res["rows"]["rows"]
    gemms = [r for r in rows if r["kernel"] == "fused_aged_matmul"]
    assert len(gemms) == len(kernel_bench.GEMM_SHAPES) * len(
        kernel_bench.GEMM_MS)
    assert all(r["plan"]["path"] == "fast" for r in rows if "plan" in r)
    assert all(r["bound_ms"] > 0 and "ms" not in r for r in rows)
    assert sum("exact" in r for r in rows) >= 30
    assert all(c["ok"] for c in res["checks"])
    assert "nothing timed" in res["text"]
    quick = kernel_bench.evaluate(device="cpu", quick=True)["rows"]["rows"]
    assert [r["kernel"] for r in quick] == ["fused_aged_matmul",
                                            "bitflip_draw"]


def test_run_refuses_unported_sections():
    """``roofline`` (A.10) is the one section left unported; ``mesh``
    (refused until A.8a) is a section now (tests/test_torch_mesh_cli.py
    runs it)."""
    assert set(run.UNPORTED) == {"roofline"} and "mesh" in run.SECTIONS
    for section, item in (("roofline", "A.10"),):
        with pytest.raises(NotImplementedError, match=re.escape(item)):
            run.main(["--only", section, "--device", "cpu"])


def test_run_writes_only_under_its_out_dir(tmp_path):
    """A section run and ``--summary`` write their records under
    ``--out-dir`` and leave the reference's repo-root BENCH_*.json as
    they were."""
    before = {p: p.stat().st_mtime_ns for p in ROOT.glob("BENCH_*.json")}
    out = tmp_path / "bench"
    assert run.main(["--only", "table1,kernels", "--quick", "--device",
                     "cpu", "--out-dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["kernels.json", "summary.json",
                                       "table1.json"]
    assert run.main(["--summary", "--out-dir", str(out)]) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["sections"] == ["kernels", "table1"]
    assert {p: p.stat().st_mtime_ns
            for p in ROOT.glob("BENCH_*.json")} == before


def _reference_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_reference", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference(capsys, monkeypatch):
    """The north star's three steps print the reference's numbers and
    tokens."""
    monkeypatch.setattr(quickstart, "served_params",
                        reference_served_params)
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    _reference_quickstart().main()
    ref_out = capsys.readouterr().out
    tokens = lambda s: [int(t) for t in re.findall(
        r"-?\d+", s.split("generated tokens:")[1])]
    assert tokens(out) == tokens(ref_out)
    assert np.asarray(got["serve"].tokens).ravel().tolist() == tokens(out)
    saving = lambda s: re.search(r"average lifetime power saving: ([\d.]+)%",
                                 s).group(1)
    assert saving(out) == saving(ref_out)
    assert out.splitlines()[0] == ref_out.splitlines()[0]   # nominal delay
    # the admitted BERs, as printed (3 significant digits)
    bers = lambda s: dict(re.findall(r"^  (\w+)\s+([\d.e+-]+)$", s, re.M))
    b, rb = bers(out), bers(ref_out)
    assert set(b) == set(rb) and len(b) == 9
    for op in b:
        assert float(b[op]) == pytest.approx(float(rb[op]), rel=1e-2)


def test_quickstart_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


def test_serve_kernel_route_matches_reference(monkeypatch):
    """``serve --use-kernel``: the faulted matmuls on the kernel route (the
    kernels' plain versions on the CPU, Pallas in interpret mode in the
    reference)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "served_params", reference_served_params)
    argv = ["--gen-len", "2", "--prompt-len", "8", "--batch", "1",
            "--router", "static", "--arch", "llama3_8b", "--use-kernel"]
    got = serve.main(argv + ["--torch-device", "cpu"])
    want = jax_serve.main(argv)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))

