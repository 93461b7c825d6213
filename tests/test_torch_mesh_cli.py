"""Mesh serving's entry points on the CPU: ``MeshServeEngine`` at tp = 1
against the reference's own on its one CPU device (and the ``runtime=``
and clean paths against its ``ServeEngine``); ``serve --mesh`` (at ``--tp
1`` against the reference's ``main(argv)``, at ``--tp 4`` against the
port's engine), ``mesh_bench --quick`` and ``run --only mesh``; the lane
engines' refusal of a shard-granular fleet; and A.8b's entry points (the
data-parallel half, ported) beside tensor-parallel training (A.8c),
which still raises naming it."""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.launch import serve as jax_serve
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.sharded import MeshServeEngine as JaxMeshServeEngine
from repro_torch.benchmarks import mesh_bench, run
from repro_torch.configs import get_config
from repro_torch.core.fleet import FleetRuntime
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve.engine import FleetServeEngine
from repro_torch.serve.online import OnlineFleetEngine
from repro_torch.serve.sharded import MeshServeEngine
from repro_torch.train import steps

from test_torch_launch import reference_served_params
from test_torch_mesh_common import model, prompts

SMALL = ["--gen-len", "3", "--prompt-len", "8", "--batch", "2",
         "--router", "static"]
BER_RTOL = 1e-3


@pytest.fixture(autouse=True)
def reference_params(monkeypatch):
    """Both packages serve the reference's seed-0 params."""
    monkeypatch.setattr(serve, "served_params", reference_served_params)


def test_mesh_tp1_and_uniform_paths_match_reference():
    """tp = 1: the fleet path against the reference's own
    ``MeshServeEngine`` on its one CPU device; the ``runtime=`` path
    (scalar BERs, kernel-free) and the clean path against its
    ``ServeEngine``."""
    jcfg, cfg, jp, params = model("llama3_8b")
    p = prompts(cfg.vocab, 1)
    jf = JaxFleetRuntime(n_devices=1, n_shards=1)
    pf = FleetRuntime(n_devices=1, n_shards=1, device="cpu")
    jf.set_age(years=9.0)
    pf.set_age(years=9.0)
    want = JaxMeshServeEngine(jcfg, jp, fleet=jf, max_len=32, seed=2,
                              serve_dtype=jnp.float32).generate(p, 4)
    got = MeshServeEngine(cfg, params, fleet=pf, max_len=32, seed=2,
                          serve_dtype=torch.float32, device="cpu").generate(p, 4)
    assert got.bers.shape == (1, 9)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    rt, jrt = pf.device(0), jf.device(0)
    want = JaxServeEngine(jcfg, jp, runtime=jrt, max_len=32, seed=3,
                          use_systolic_kernel=False,
                          use_fused_kernel=False).generate(p, 4)
    got = MeshServeEngine(cfg, params, tp=4, runtime=rt, max_len=32,
                          seed=3, serve_dtype=torch.float32, device="cpu").generate(p, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.bers.shape == (1, 9) and got.ages_years.tolist() == [9.0]
    want = JaxServeEngine(jcfg, jp, max_len=32, seed=3).generate(p, 4)
    got = MeshServeEngine(cfg, params, tp=4, max_len=32, seed=3,
                          serve_dtype=torch.float32, device="cpu").generate(p, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.bers.shape == (1, 0) and got.power_w == 0.0


def test_serve_mesh_tp1_matches_reference(capsys):
    """``--mesh --tp 1`` (one shard: the reference's one CPU device) on
    both launchers: the BER table, ages and power; the tokens of both
    routes are equal, and the fused route's equal the reference's."""
    argv = SMALL + ["--arch", "llama3_8b", "--mesh", "--tp", "1"]
    want = jax_serve.main(argv)
    got = serve.main(argv + ["--torch-device", "cpu"])
    plain = serve.main(argv + ["--no-fused", "--torch-device", "cpu"])
    np.testing.assert_array_equal(got.tokens, plain.tokens)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.operators == tuple(want.operators)
    np.testing.assert_allclose(got.bers, np.asarray(want.bers),
                               rtol=BER_RTOL)
    np.testing.assert_array_equal(got.ages_years, want.ages_years)
    out = capsys.readouterr().out
    assert "per-shard BER table" in out and "shard0" in out


def test_serve_mesh_tp4_is_the_engine():
    """``--mesh --tp 4`` serves one device of four shards aged
    ``age * (s+1)/4``, as the engine does on the same params."""
    argv = SMALL + ["--arch", "llama3_8b", "--mesh", "--tp", "4",
                    "--age-years", "8", "--temperature", "0.8",
                    "--top-k", "8"]
    got = serve.main(argv + ["--torch-device", "cpu"])
    cfg = get_config("llama3_8b").reduced()
    fleet = FleetRuntime(n_devices=1, n_shards=4, device="cpu")
    for s in range(4):
        fleet.set_age(years=8 * (s + 1) / 4, shard=s)
    eng = MeshServeEngine(cfg, reference_served_params(cfg, "cpu"), tp=4,
                          fleet=fleet, max_len=8 + 3 + 1, device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    want = eng.generate(prompts, 3, temperature=0.8, top_k=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.bers, want.bers)
    np.testing.assert_allclose(got.ages_years, [2.0, 4.0, 6.0, 8.0])
    assert len(np.unique(got.bers[:, 0])) == 4


def test_mesh_bench_and_run_only_mesh(tmp_path):
    res = mesh_bench.evaluate(device="cpu", quick=True)
    assert all(c["ok"] for c in res["checks"]), res["text"]
    rows = res["rows"]
    assert rows["tp"] == 8 and rows["dispatch"]["bit_exact"]
    aging = rows["per_shard_aging"]
    assert aging["routes_bit_exact"] and aging["shard_bers_differ"]
    assert aging["launches"] is None          # counted on a card only
    out = tmp_path / "bench"
    assert run.main(["--only", "mesh", "--quick", "--device", "cpu",
                     "--out-dir", str(out)]) == 0
    rec = json.loads((out / "mesh.json").read_text())
    assert all(c["ok"] for c in rec["checks"])


def test_lane_engines_refuse_a_sharded_fleet():
    cfg = get_config("llama3_8b").reduced()
    fleet = FleetRuntime(n_devices=1, n_shards=2, device="cpu")
    params = reference_served_params(cfg, "cpu")
    for engine in (FleetServeEngine, OnlineFleetEngine):
        with pytest.raises(ValueError, match="MeshServeEngine"):
            engine(cfg, params, fleet, device="cpu")


def test_a8b_entry_points_still_raise():
    """A.8b's data-parallel half is ported: its entry points refuse a mesh
    without a process group (tests/test_torch_dp_train.py runs them over
    one), and tensor-parallel training still raises, naming A.8c."""
    cfg = get_config("llama3_8b").reduced()
    with pytest.raises(ValueError, match="process group"):
        steps.make_dp_train_step(cfg, None, None)
    assert steps.dp_residuals_init({}, make_local_mesh(device="cpu")) == {}
    with pytest.raises(NotImplementedError, match=re.escape("A.8c")):
        train.main(["--model-parallel", "2", "--device", "cpu"])
