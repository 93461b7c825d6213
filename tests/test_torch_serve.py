"""The port's serving path (repro_torch.serve) vs the JAX reference on the
CPU: reduced llama3_8b with the reference's params carried across by
repro_torch.convert, the JAX ServeEngine on its Pallas kernel routes
(interpret mode) against the port on the same routes (plain versions);
prefill logits of the reduced dense zoo."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.data import SyntheticLM
from repro_torch.models.layers import FaultConfig
from repro_torch.serve import steps
from repro_torch.serve.engine import ServeEngine

OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")
# prefill logits: float32 reductions (norm means, softmax, the unembed
# matmul) sum in another order than XLA's; the int32 accumulators and
# upsets are identical, so the drift stays at float32 rounding level
LOGIT_ATOL = 1e-4


class Forced:
    """A runtime admitting one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in OPS}

    def total_power(self):
        return 0.0


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_get_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    return cfg_j, cfg, params_j, params, prompts


@pytest.fixture(scope="module")
def runtimes():
    jf = JaxFleetRuntime(n_devices=1)
    jf.set_age(years=9.0)
    pf = FleetRuntime(n_devices=1, device="cpu")
    pf.set_age(years=9.0)
    return jf, pf


def test_convert_carries_the_reference_tree(model):
    cfg_j, cfg, params_j, params, _ = model
    assert len(params["layers"]) == cfg.n_layers
    g = params_j["groups"]["b0_attn"]
    for i, lp in enumerate(params["layers"]):
        assert tuple(lp["attn"]["wq"].shape) == (cfg.d_model, cfg.n_heads,
                                                 cfg.hd)
        np.testing.assert_array_equal(lp["attn"]["wo"].numpy(),
                                      np.asarray(g["attn"]["wo"][i]))
        np.testing.assert_array_equal(lp["ffn"]["w_down"].numpy(),
                                      np.asarray(g["ffn"]["w_down"][i]))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("age", ["ber_1e-3", "age_9y"])
def test_generate_tokens_match_reference(model, runtimes, fused, age):
    """Greedy tokens equal on the kernel route and the three-pass route, at
    a forced BER of 1e-3 on every operator (so flips really occur) and at
    the fleet's age-9 BERs."""
    cfg_j, cfg, params_j, params, prompts = model
    jrt, prt = (Forced(1e-3), Forced(1e-3)) if age == "ber_1e-3" \
        else runtimes
    want = JaxServeEngine(cfg_j, params_j, runtime=jrt, max_len=32,
                          use_systolic_kernel=True, use_fused_kernel=fused,
                          seed=3).generate(prompts, 4)
    got = ServeEngine(cfg, params, runtime=prt, max_len=32,
                      use_systolic_kernel=True, use_fused_kernel=fused,
                      seed=3, device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape == (2, 4)
    assert got.age_years == pytest.approx(want.age_years)


def test_kernel_free_route_matches_reference(model):
    cfg_j, cfg, params_j, params, prompts = model
    want = JaxServeEngine(cfg_j, params_j, runtime=Forced(1e-3), max_len=32,
                          seed=4).generate(prompts, 3)
    got = ServeEngine(cfg, params, runtime=Forced(1e-3), max_len=32, seed=4,
                      device="cpu").generate(prompts, 3)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_prefill_logits_match_reference(model, fused):
    cfg_j, cfg, params_j, params, prompts = model
    bers = {op: 1e-3 for op in OPS}
    jfi = JaxFaultConfig(bers={op: jnp.float32(b) for op, b in bers.items()},
                         key=jax.random.PRNGKey(11), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=fused).with_seeds()
    pfi = FaultConfig(bers=bers, key=prandom.PRNGKey(11),
                      use_systolic_kernel=True, fused=fused).with_seeds()
    want, _ = jax_steps.make_prefill_fn(cfg_j, 32)(
        params_j, jnp.asarray(prompts), jfi)
    got, cache = steps.prefill(params, cfg, torch.as_tensor(prompts), pfi, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    assert cache[0]["k"].shape == (2, 32, cfg.n_kv_heads, cfg.hd)


DENSE_ZOO = ("deepseek_7b", "starcoder2_7b", "granite_20b",
             "command_r_plus_104b")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("arch", DENSE_ZOO)
def test_dense_zoo_prefill_logits_match_reference(arch, fused):
    """Reduced dense zoo at BER 1e-3: MHA (deepseek_7b), LayerNorm + tanh
    GELU (starcoder2_7b), MQA (granite_20b), tied embeddings under a
    bias-free LayerNorm (command_r_plus_104b)."""
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(2),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    bers = {op: 1e-3 for op in OPS}
    jfi = JaxFaultConfig(bers={op: jnp.float32(b) for op, b in bers.items()},
                         key=jax.random.PRNGKey(12), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=fused).with_seeds()
    pfi = FaultConfig(bers=bers, key=prandom.PRNGKey(12),
                      use_systolic_kernel=True, fused=fused).with_seeds()
    want, _ = jax_steps.make_prefill_fn(cfg_j, 32)(
        params_j, jnp.asarray(prompts), jfi)
    got, _ = steps.prefill(params, cfg, torch.as_tensor(prompts), pfi, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
