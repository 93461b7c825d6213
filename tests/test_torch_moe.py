"""The port's MoE family (repro_torch.models.moe, the MoE decoder, the
family's fleet) vs the JAX reference on the CPU: reduced qwen3_moe_235b
and arctic_480b from the reference's ``init_params`` (float32), carried
across by repro_torch.convert, with Pallas in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import resilience as jax_resilience
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.kernels import ops as jops
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import random as prandom
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import resilience
from repro_torch.core.fleet import FleetRuntime
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from repro_torch.serve import steps
from repro_torch.serve.engine import FleetServeEngine, ServeEngine

OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "router")
MOE_ARCHS = ("qwen3_moe_235b", "arctic_480b")
LOGIT_ATOL = 1e-4    # float32 reductions in another order than XLA's
MOE_ATOL = 1e-5      # moe_apply outputs and aux: float32 softmax / matmuls
# accumulator upsets blow faulted outputs up to ~1e3-1e6, where float32
# rounding alone exceeds MOE_ATOL: faulted outputs also get 8 ulps relative
MOE_RTOL = 1e-6


class Forced:
    """A runtime admitting one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in OPS}

    def total_power(self):
        return 0.0


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    cfg_j = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    return cfg_j, cfg, params_j, params, prompts


def _fault_configs(fused, ber=1e-3, key=11):
    bers = {op: ber for op in OPS}
    jfi = JaxFaultConfig(bers={op: jnp.float32(b) for op, b in bers.items()},
                         key=jax.random.PRNGKey(key), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=fused).with_seeds()
    pfi = FaultConfig(bers=bers, key=prandom.PRNGKey(key),
                      use_systolic_kernel=True, fused=fused).with_seeds()
    return jfi, pfi


# --------------------------------------------------------------------------- #
# configs and the family's fleet
# --------------------------------------------------------------------------- #
def test_configs_are_copies_of_the_reference():
    """Every ported config, its reduced cut and its parameter counts equal
    the reference's."""
    for arch in ARCH_IDS:
        cfg, ref = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert (dataclasses.asdict(cfg.reduced())
                == dataclasses.asdict(ref.reduced())), arch
        assert cfg.param_count() == ref.param_count(), arch
        assert cfg.active_param_count() == ref.active_param_count(), arch


NEW_FAMILIES = ("recurrentgemma_2b", "rwkv6_3b", "paligemma_3b",
                "whisper_large_v3")


def test_new_family_configs_match_reference():
    """The hybrid, SSM, VLM and enc-dec configs (full and reduced) equal
    the reference's, and ``get_config`` knows every reference arch."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    for arch in NEW_FAMILIES:
        cfg, ref = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert (dataclasses.asdict(cfg.reduced())
                == dataclasses.asdict(ref.reduced())), arch
        assert cfg.param_count() == ref.param_count(), arch


# config fields the port used to refuse (ROADMAP §C.1): the reference
# applies each in any family; a reduced llama3_8b with the field set now
# gives the reference's logits
CONFIG_FIELDS = {"window": 4, "prefix_tokens": 8, "n_encoder_layers": 2,
                 "block_pattern": ("rec", "rec", "attn")}


@pytest.mark.parametrize("field", list(CONFIG_FIELDS))
def test_config_fields_match_reference(field):
    """C.1's reproduction (``window=4``, where the port once returned the
    unwindowed logits), prefix embeddings, encoder layers and a hybrid
    block pattern (two ``rec`` tail layers): the prefill logits on the
    fused route at BER 1e-3 (and the clean logits) equal the reference's
    within 1e-4."""
    from repro.models import encdec as jax_encdec
    from repro_torch.models import encdec
    base_j, base = (get_config("llama3_8b").reduced(),
                    jax_get_config("llama3_8b").reduced())[::-1]
    cfg_j = dataclasses.replace(base_j, **{field: CONFIG_FIELDS[field]})
    cfg = dataclasses.replace(base, **{field: CONFIG_FIELDS[field]})
    enc = field == "n_encoder_layers"
    init = jax_encdec.init_params if enc else jax_tf.init_params
    params_j = init(cfg_j, jax.random.PRNGKey(2), dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (2, 12))
    extra = rng.normal(size=(2, cfg.encoder_seq if enc else
                             cfg.prefix_tokens, cfg.d_model)).astype(
        np.float32)
    for fused in (None, True):
        jfi, pfi = _fault_configs(True) if fused else (None, None)
        if enc:      # op by op: see tests/test_torch_families_common.py::EAGER
            with jax.disable_jit():
                want, _ = jax_encdec.decode(
                    params_j, cfg_j, jnp.asarray(prompts),
                    enc_out=jax_encdec.encode(params_j, cfg_j,
                                              jnp.asarray(extra), fi=jfi),
                    fi=jfi)
            got, _ = encdec.decode(
                params, cfg, torch.as_tensor(prompts),
                enc_out=encdec.encode(params, cfg, torch.from_numpy(extra),
                                      fi=pfi), fi=pfi)
        else:
            pe = extra if cfg.prefix_tokens else None
            want, _, _ = jax_tf.forward_logits(
                params_j, cfg_j, jnp.asarray(prompts), fi=jfi,
                prefix_embeds=None if pe is None else jnp.asarray(pe))
            got, _, _ = tf.forward_logits(
                params, cfg, torch.as_tensor(prompts), fi=pfi,
                prefix_embeds=None if pe is None else torch.from_numpy(pe))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
    if field == "window":                       # the window really bites
        unwindowed, _, _ = tf.forward_logits(params, base,
                                             torch.as_tensor(prompts))
        assert not torch.allclose(unwindowed, got, atol=1e-3)


def test_family_operators_match_reference():
    assert resilience.FAMILY_OPERATORS == jax_resilience.FAMILY_OPERATORS
    for fam in ("dense", "moe", "hybrid", "ssm", "encdec", "vlm", "unknown"):
        assert resilience.operators_for(fam) \
            == jax_resilience.operators_for(fam)


def test_for_model_bers_match_reference():
    """A moe fleet admits 10 domains, the router's included, at the
    reference's BERs (float32 drift of the age-9 BERs: rtol 1e-3)."""
    cfg_j, cfg = (jax_get_config("qwen3_moe_235b"),
                  get_config("qwen3_moe_235b"))
    jf = JaxFleetRuntime.for_model(cfg_j)
    jf.set_age(years=9.0)
    pf = FleetRuntime.for_model(cfg, device="cpu")
    pf.set_age(years=9.0)
    jb, pb = jf.op_bers(), pf.op_bers()
    assert tuple(pb) == tuple(jb) == OPS
    for op in jb:
        assert pb[op] == pytest.approx(jb[op], rel=1e-3), op
    assert pf.total_power() == pytest.approx(jf.total_power(), rel=1e-5)


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #
def test_convert_carries_moe_leaves(model):
    """Expert leaves keep their (E, ...) layouts, the router stays float32
    under a bf16 conversion, arctic's dense residual comes along."""
    cfg_j, cfg, params_j, _, _ = model
    bf = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                               dtype=torch.bfloat16, device="cpu")
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    for i, lp in enumerate(bf["layers"]):
        ffn = lp["ffn"]
        assert ffn["w_router"].dtype == torch.float32
        assert tuple(ffn["w_router"].shape) == (d, E)
        assert ffn["w_gate"].dtype == torch.bfloat16
        assert tuple(ffn["w_up"].shape) == (E, d, f)
        assert tuple(ffn["w_down"].shape) == (E, f, d)
        assert ("dense" in ffn) == cfg.moe.dense_residual
        np.testing.assert_array_equal(
            ffn["w_router"].numpy(),
            np.asarray(params_j["groups"]["b0_attn"]["ffn"]["w_router"][i]))
        assert ("q_norm" in lp["attn"]) == cfg.qk_norm


@pytest.mark.parametrize("capacity_factor", [None, 0.25],
                         ids=["capacity", "overflow"])
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "ber_1e-3"])
def test_moe_apply_matches_reference(model, faulted, capacity_factor):
    """Outputs and aux within 1e-5 (faulted outputs: plus 1e-6 relative),
    clean and faulted (router and arctic's dense residual on the fused
    kernel), with room for every token and with a capacity so small that
    pairs overflow and drop."""
    cfg_j, cfg, params_j, params, _ = model
    mcfg_j, mcfg = cfg_j.moe, cfg.moe
    if capacity_factor is not None:
        mcfg_j = dataclasses.replace(mcfg_j, capacity_factor=capacity_factor)
        mcfg = dataclasses.replace(mcfg, capacity_factor=capacity_factor)
        assert 2 * 16 * mcfg.top_k > mcfg.n_experts * moe._capacity(32, mcfg)
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    jfi, pfi = _fault_configs(True) if faulted else (None, None)
    p_j = jax.tree.map(lambda v: v[1], params_j["groups"]["b0_attn"]["ffn"])
    want, want_aux = jax_moe.moe_apply(jnp.asarray(x), p_j, mcfg_j, cfg_j.mlp,
                                       jfi, 1)
    got, aux = moe.moe_apply(torch.from_numpy(x), params["layers"][1]["ffn"],
                             mcfg, cfg.mlp, pfi, 1)
    assert moe._capacity(32, mcfg) == jax_moe._capacity(32, mcfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MOE_RTOL if faulted else 0,
                               atol=MOE_ATOL)
    assert float(aux) == pytest.approx(float(want_aux), abs=MOE_ATOL)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(8), size=40).astype(np.float32)
    top_e = np.argsort(-probs, axis=-1)[:, :3].astype(np.int32)
    want = jax_moe.aux_load_balance_loss(jnp.asarray(probs),
                                         jnp.asarray(top_e), 8)
    got = moe.aux_load_balance_loss(torch.from_numpy(probs),
                                    torch.from_numpy(top_e).long(), 8)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_router_accumulator_full_shape_bit_exact(fused):
    """The router's aged matmul at qwen3_moe_235b's full router shape
    (M=2 decode tokens, K=4096, N=128 experts): the int32 accumulator with
    its upsets, and the dequantised output, equal the reference's."""
    full = get_config("qwen3_moe_235b")
    K, N = full.d_model, full.moe.n_experts
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    jfi, pfi = _fault_configs(fused, ber=1e-3)
    xq, _ = ops.quantize_int8(torch.from_numpy(x), axis=-1)
    wq, _ = ops.quantize_int8(torch.from_numpy(w), axis=0)
    jxq, _ = jops.quantize_int8(jnp.asarray(x), axis=-1)
    jwq, _ = jops.quantize_int8(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    if fused:
        seed = pfi.seed_for("router", 3)
        assert seed == int(jfi.seed_for("router", 3))
        acc = ops.fused_aged_matmul(xq, wq, ber=1e-3, seed=seed)
        want = jops.fused_aged_matmul(jxq, jwq, ber=jnp.float32(1e-3),
                                      seed=jnp.int32(seed))
        got_y = ops.aged_linear(torch.from_numpy(x), torch.from_numpy(w),
                                ber=1e-3, seed=seed)
        want_y = jops.aged_linear(jnp.asarray(x), jnp.asarray(w),
                                  ber=jnp.float32(1e-3), seed=jnp.int32(seed))
    else:
        key = pfi.key_for("router", 3)
        jkey = jfi.key_for("router", 3)
        np.testing.assert_array_equal(key.numpy(),
                                      np.asarray(jkey).astype(np.int64))
        acc = ops.inject_bitflips(ops.quantized_matmul(xq, wq), 1e-3, key)
        want = jops.inject_bitflips(jops.quantized_matmul(jxq, jwq),
                                    jnp.float32(1e-3), jkey)
        got_y = ops.aged_linear(torch.from_numpy(x), torch.from_numpy(w),
                                ber=1e-3, key=key, fused=False)
        want_y = jops.aged_linear(jnp.asarray(x), jnp.asarray(w),
                                  ber=jnp.float32(1e-3), key=jkey,
                                  fused=False)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (2, N)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    clean = (xq.to(torch.int64) @ wq.to(torch.int64)).to(torch.int32)
    assert bool((acc != clean).any())          # upsets really occurred
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


# --------------------------------------------------------------------------- #
# the MoE decoder
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_prefill_logits_match_reference(model, fused):
    cfg_j, cfg, params_j, params, prompts = model
    jfi, pfi = _fault_configs(fused)
    want, _ = jax_steps.make_prefill_fn(cfg_j, 32)(
        params_j, jnp.asarray(prompts), jfi)
    got, cache = steps.prefill(params, cfg, torch.as_tensor(prompts), pfi, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    assert cache[0]["k"].shape == (2, 32, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_wide_head_dim_prefill_logits_match_reference(fused):
    """qwen3_moe_235b's published head_dim is twice d_model // n_heads (128
    against 4096 / 64), so q's output and o's input are 2 * d_model wide:
    the reduced config at that ratio (head_dim 32 for d_model 64, 4 heads)
    gives the reference's logits."""
    cfg_j = dataclasses.replace(
        jax_get_config("qwen3_moe_235b").reduced(), head_dim=32)
    cfg = dataclasses.replace(get_config("qwen3_moe_235b").reduced(),
                              head_dim=32)
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(2),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    assert params["layers"][0]["attn"]["wq"].shape == (64, 4, 32)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    jfi, pfi = _fault_configs(fused)
    want, _ = jax_steps.make_prefill_fn(cfg_j, 32)(
        params_j, jnp.asarray(prompts), jfi)
    got, _ = steps.prefill(params, cfg, torch.as_tensor(prompts), pfi, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def test_forward_aux_matches_reference(model):
    """The load-balance loss summed over layers, clean forward."""
    cfg_j, cfg, params_j, params, prompts = model
    _, _, want = jax_tf.forward_logits(params_j, cfg_j, jnp.asarray(prompts))
    _, _, got = tf.forward_logits(params, cfg, torch.as_tensor(prompts))
    assert float(got) == pytest.approx(float(want), abs=MOE_ATOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_generate_greedy_tokens_match_reference(model, fused):
    """Greedy tokens equal at a forced BER of 1e-3 on every domain."""
    cfg_j, cfg, params_j, params, prompts = model
    want = JaxServeEngine(cfg_j, params_j, runtime=Forced(1e-3), max_len=32,
                          use_systolic_kernel=True, use_fused_kernel=fused,
                          seed=3).generate(prompts, 4)
    got = ServeEngine(cfg, params, runtime=Forced(1e-3), max_len=32,
                      use_systolic_kernel=True, use_fused_kernel=fused,
                      seed=3, device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
