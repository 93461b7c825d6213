"""The port's ``MeshServeEngine`` on the CPU against the reference: one
device of ``tp`` mesh shards, each aged on its own, on reduced llama3_8b
and deepseek_7b at tp = 4 (shard ages 1.5/4/6.5/9 y) and tp = 3 (uneven
blocks), greedy and sampled, the fused route (the shard-mode GEMM and the
counter-upset kernel's wrappers) and the plain route giving the
reference's tokens exactly (tests/test_torch_mesh_common.py has the
oracle); the engine's cast, specs, checks and telemetry.  (tp = 1
against the reference's own ``MeshServeEngine``, and the ``runtime=`` and
clean paths, are in tests/test_torch_mesh_cli.py.)"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import LogicalMesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.taps import enable_taps
from repro_torch.serve.sharded import MeshServeEngine

from test_torch_mesh_common import (AGES, BER_RTOL, model, oracle_tokens,
                                    prompts, shard_fleets)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

F32 = dict(serve_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", params=["llama3_8b", "deepseek_7b"])
def dense(request):
    return model(request.param)


@pytest.mark.parametrize("tp", [4, 3])
def test_mesh_tokens_match_reference(dense, tp):
    """Greedy tokens of both routes equal the reference's mesh engine's;
    the served (S, O) BERs, shard ages and power match its fleet's."""
    jcfg, cfg, jp, params = dense
    jf, pf = shard_fleets(tp)
    p = prompts(cfg.vocab, tp)
    want = oracle_tokens(jcfg, jp, jf, p, 4)
    for fused in (True, False):
        eng = MeshServeEngine(cfg, params, tp=tp, fleet=pf, max_len=32,
                              use_fused_kernel=fused, **F32)
        got = eng.generate(p, 4)
        np.testing.assert_array_equal(got.tokens, want)
    assert got.bers.shape == (tp, len(pf.operators))
    np.testing.assert_allclose(got.bers, np.asarray(
        jf.op_ber_shard_array())[0], rtol=BER_RTOL)
    assert len(np.unique(got.bers[:, 0])) == min(tp, len(AGES))
    np.testing.assert_array_equal(got.ages_years,
                                  np.asarray(jf.ages_years)[0])
    assert got.power_w == pytest.approx(float(jf.fleet_power()[0]),
                                        rel=1e-5)


def test_mesh_sampled_tokens_match_reference(dense):
    jcfg, cfg, jp, params = dense
    jf, pf = shard_fleets(4)
    p = prompts(cfg.vocab, 7)
    want = oracle_tokens(jcfg, jp, jf, p, 4, seed=3, temperature=0.8,
                         top_k=8)
    for fused in (True, False):
        eng = MeshServeEngine(cfg, params, tp=4, fleet=pf, max_len=32,
                              seed=3, use_fused_kernel=fused, **F32)
        got = eng.generate(p, 4, temperature=0.8, top_k=8)
        np.testing.assert_array_equal(got.tokens, want)


def test_mesh_engine_defaults_checks_and_telemetry():
    """The bf16 cast and the serve-layout specs; the fleet checks;
    telemetry only under ``enable_taps``; an age change reaches the
    served BERs (the table is cached per fleet table); a one-process mesh
    of two data replicas serves the one replica's tokens."""
    _, cfg, _, params = model("llama3_8b")
    jf, pf = shard_fleets(4)
    eng = MeshServeEngine(cfg, params, tp=4, fleet=pf, max_len=32,
                          device="cpu")
    assert eng.params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert eng.specs["layers"][0]["attn"]["wq"] == (None, "model", None)
    assert eng.specs["layers"][0]["ffn"]["w_down"] == (None, "model")
    p = prompts(cfg.vocab, 4)
    fused = eng.generate(p, 3)
    plain = MeshServeEngine(cfg, params, tp=4, fleet=pf, max_len=32,
                            use_fused_kernel=False,
                            device="cpu").generate(p, 3)
    np.testing.assert_array_equal(fused.tokens, plain.tokens)
    assert fused.telemetry is None
    with enable_taps():
        before = obs_metrics.REGISTRY.counter("mesh_generate_calls").value
        res = eng.generate(p, 3)
        assert obs_metrics.REGISTRY.counter(
            "mesh_generate_calls").value == before + 1
    assert {k: v.shape for k, v in res.telemetry.items()} == {
        "logit_max": (3,), "logit_margin": (3,)}
    old = res.bers[1, 0]
    pf.advance(3.15e7, shard=1)
    assert eng.generate(p, 3).bers[1, 0] > old
    with pytest.raises(ValueError, match="n_shards"):
        MeshServeEngine(cfg, params, tp=2, fleet=pf, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        MeshServeEngine(cfg, params, tp=4, fleet=pf, runtime=pf.device(0),
                        device="cpu")
    # two data replicas on the one device serve the same prompts: one
    # computation gives both (over ranks: tests/test_torch_mesh_ranks.py)
    two = MeshServeEngine(cfg, params, fleet=pf, max_len=32, device="cpu",
                          mesh=LogicalMesh(("data", "model"), (2, 4),
                                           torch.device("cpu")))
    np.testing.assert_array_equal(two.generate(p, 3).tokens,
                                  MeshServeEngine(cfg, params, tp=4,
                                                  fleet=pf, max_len=32,
                                                  device="cpu")
                                  .generate(p, 3).tokens)
