"""``MeshServeEngine`` at tp = 4 over 4 gloo ranks on the CPU beyond the
dense decoders: reduced qwen3_moe_235b (the expert axis: each rank runs
its block of the experts' queues and the expert outputs are gathered; the
router domain replicated, on the model's fleet) and reduced
whisper_large_v3 (the encoder's heads and the cross-attention; the
d-split decoder positions; the vocab-split embedding and head of the
reduced width, vocab 256, where the published 51,866 does not divide:
there the embedding splits d and the head replicates), greedy and sampled
on the fused and the plain route: every rank's tokens equal to the
reference's one-device mesh oracle (tests/test_torch_mesh_common.py) and
to the port's one-device engine, and each rank holding its blocks and the
replicated leaves.  The ranks (``tests/torch_dist_ranks.py::
mesh_serve_rank``) are spawned once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.serve.sharded import MeshServeEngine
from repro_torch.tree import flatten

from test_torch_mesh_common import (model, oracle_tokens, prompts,
                                    ranks_beside, shard_fleets)
from test_torch_mesh_ranks import expected_bytes

ARCHS = ("qwen3_moe_235b", "whisper_large_v3")
# greedy through the sampler's top_k (temperature 0: the exact argmax),
# so the reference's generation compiles once for both modes
MODES = {"greedy": dict(temperature=0.0, top_k=8),
         "sampled": dict(temperature=0.8, top_k=8)}
F32 = dict(serve_dtype=torch.float32, device="cpu")
TP = 4


def _extras(cfg) -> dict:
    if not cfg.n_encoder_layers:
        return {}
    return {"frames": np.random.default_rng(2).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def served():
    models = {arch: model(arch) for arch in ARCHS}
    jobs = {}
    for arch, (_, cfg, _, params) in models.items():
        p = prompts(cfg.vocab, 11)
        jobs[arch] = {"params": {k: v.numpy()
                                 for k, v in flatten(params).items()},
                      "runs": [dict(tp=TP, fleet="model", fused=f, seed=1,
                                    prompts=p, n=3, kw=kw,
                                    extras=_extras(cfg))
                               for kw in MODES.values()
                               for f in (True, False)]}

    def oracle():
        want = {}
        for arch, (jcfg, cfg, jp, params) in models.items():
            jf, pf = shard_fleets(TP, cfg=(jcfg, cfg))
            run = jobs[arch]["runs"][0]
            jextras = tuple(jnp.asarray(v) for v in run["extras"].values())
            for mode, kw in MODES.items():
                want[arch, mode] = oracle_tokens(
                    jcfg, jp, jf, run["prompts"], 3, seed=1, extras=jextras,
                    **kw)
                eng = MeshServeEngine(cfg, params, tp=TP, fleet=pf,
                                      max_len=32, seed=1, **F32)
                want[arch, mode, "one_device"] = eng.generate(
                    run["prompts"], 3, **kw, **run["extras"]).tokens
        return want

    out, want = ranks_beside(ranks.mesh_serve_rank, TP, jobs, beside=oracle)
    return models, out, want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_rank_tokens_match_reference(served, arch, mode):
    _, out, want = served
    np.testing.assert_array_equal(want[arch, mode, "one_device"],
                                  want[arch, mode])
    first = list(MODES).index(mode) * 2
    for i in (first, first + 1):
        for r in range(TP):
            rec = out[r][arch]["runs"][i]
            assert rec["shard"] == r
            np.testing.assert_array_equal(rec["tokens"], want[arch, mode],
                                          err_msg=f"rank {r} run {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_family_ranks_hold_their_blocks(served, arch):
    """The experts (qwen3) and whisper's projections, embedding, decoder
    positions and head are split a quarter a rank; the router and the
    norms whole."""
    models, out, _ = served
    cfg, params = models[arch][1], models[arch][3]
    one = dict(ranks._spec_items(MeshServeEngine(
        cfg, params, tp=TP, **F32).specs))
    for r in range(TP):
        assert out[r][arch]["runs"][0]["specs"] == one
        assert out[r][arch]["runs"][0]["held_bytes"] == expected_bytes(
            params, one, TP)
        assert out[r][arch]["runs"][0]["gathers"]["calls"] > 0
    if cfg.moe:
        assert one["layers/0/ffn/w_up"] == ("model", None, None)
        assert one["layers/0/ffn/w_router"] == ()
    else:
        assert one["dec_pos"] == (None, "model")
        assert one["embed"] == ("model", None)
        assert one["lm_head"] == (None, "model")
