"""The port's ``MeshServeEngine`` against the reference on the CPU
beyond the dense decoders: reduced qwen3_moe_235b at tp = 4 (the router
domain reaches the shard route through ``op_linear``; the expert ``bmm``
stays clean) and reduced whisper_large_v3 at tp = 4 (vocab 51,866: uneven
column blocks; the encoder's qkt/sv heads split over the shards), both
routes equal to the reference's mesh-engine tokens
(tests/test_torch_mesh_common.py has the oracle)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serve.sharded import MeshServeEngine

from test_torch_mesh_common import (model, oracle_tokens, prompts,
                                    shard_fleets)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

F32 = dict(serve_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("arch,sample", [
    ("qwen3_moe_235b", False), ("qwen3_moe_235b", True),
    ("whisper_large_v3", False)], ids=["moe", "moe_sampled", "whisper"])
def test_mesh_family_tokens_match_reference(arch, sample):
    jcfg, cfg, jp, params = model(arch)
    jf, pf = shard_fleets(4, cfg=(jcfg, cfg))
    p = prompts(cfg.vocab, 11)
    kw, extras, jextras = {}, {}, ()
    if sample:
        kw = dict(temperature=0.8, top_k=8)
    if cfg.n_encoder_layers:
        frames = np.random.default_rng(2).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        extras, jextras = {"frames": frames}, (jnp.asarray(frames),)
    want = oracle_tokens(jcfg, jp, jf, p, 3, seed=1, extras=jextras, **kw)
    assert tuple(pf.operators) == tuple(jf.operators)
    for fused in (True, False):
        eng = MeshServeEngine(cfg, params, tp=4, fleet=pf, max_len=32,
                              seed=1, use_fused_kernel=fused, **F32)
        got = eng.generate(p, 3, **kw, **extras)
        np.testing.assert_array_equal(got.tokens, want)
    if arch == "qwen3_moe_235b":
        assert "router" in got.operators
