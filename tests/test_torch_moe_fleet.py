"""The port's MoE fleet vs the JAX reference on the CPU: the lane-aware
expert dispatch (``moe_apply`` with ``lanes=N``) against ``jax.vmap`` of the
reference's ``moe_apply_global``, with a capacity that binds per lane, and
``FleetServeEngine`` on reduced qwen3_moe_235b and arctic_480b: three lanes
aged 3/6/9 years on ``FleetRuntime.for_model``, greedy and sampled tokens
and prefill logits against the reference's vmapped dispatch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.data import SyntheticLM
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from repro_torch.serve import steps
from repro_torch.serve.engine import FleetServeEngine
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

MOE_ARCHS = ("qwen3_moe_235b", "arctic_480b")
AGES = (3.0, 6.0, 9.0)           # the reference fleet test's lane ages
LANE_BERS = (1e-3, 0.0, 3e-3)    # the moe_apply lanes: one lane clean
OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "router")
# the age-9 BERs: the BER curve is steep in delay (ROADMAP §C, known drift)
BER_RTOL = 1e-3
LOGIT_ATOL = 1e-4    # float32 reductions in another order than XLA's
MOE_ATOL = 1e-5      # moe_apply outputs and aux: float32 softmax / matmuls
# accumulator upsets blow faulted outputs up to ~1e3-1e6, where float32
# rounding alone exceeds MOE_ATOL: faulted outputs also get 8 ulps relative
MOE_RTOL = 1e-6
# a capacity factor at which one lane's 16 tokens x top-2 over 4 experts
# overflow the minimum capacity of 8, while 3 lanes folded would get 16
BINDING_CF = 0.5


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    arch = request.param
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    lane_prompts = np.stack([prompts, prompts + 1, prompts + 2]) % cfg.vocab
    jf = JaxFleetRuntime.for_model(cfg_j, n_devices=3)
    pf = FleetRuntime.for_model(cfg, n_devices=3, device="cpu")
    for i, age in enumerate(AGES):
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    return cfg_j, cfg, params_j, params, lane_prompts, jf, pf


def _lane_fault_configs(bers, key=11):
    """The same lane config on both sides: per-lane BERs on every domain,
    ``split(PRNGKey(key), N)`` lane keys, the fused route."""
    N = len(bers)
    jb = jnp.asarray(bers, jnp.float32)
    jfi = JaxFaultConfig(bers={op: jb for op in OPS},
                         key=jax.random.split(jax.random.PRNGKey(key), N),
                         step=jnp.zeros((N,), jnp.int32),
                         use_systolic_kernel=True, fused=True)
    pfi = FaultConfig(bers={op: tuple(bers) for op in OPS},
                      key=prandom.split(prandom.PRNGKey(key), N),
                      use_systolic_kernel=True, fused=True)
    return jfi, pfi.with_seeds()


def _dropped_pairs(x, w_router, mcfg):
    """Pairs each lane drops at ``mcfg``'s capacity under a clean router
    (numpy, the reference's rule: top-k, then a queue position per expert
    in token order, kept below ``_capacity`` of one lane's tokens)."""
    N, B, S, d = x.shape
    logits = x.reshape(N, B * S, d) @ w_router
    top_e = np.argsort(-logits, axis=-1, kind="stable")[..., :mcfg.top_k]
    C = moe._capacity(B * S, mcfg)
    drops = []
    for lane in top_e.reshape(N, -1):
        counts = np.bincount(lane, minlength=mcfg.n_experts)
        drops.append(int(np.maximum(counts - C, 0).sum()))
    return drops


# --------------------------------------------------------------------------- #
# the lane-aware dispatch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "lane_bers"])
def test_moe_apply_lanes_match_vmapped_reference(model, faulted):
    """Three lanes of (2, 8) tokens at a capacity that binds per lane: the
    lane path equals ``jax.vmap`` of the reference's ``moe_apply_global``
    (outputs within 1e-5, faulted also 1e-6 relative; the per-lane aux
    within 1e-5), and the naive fold (one capacity from all lanes' tokens,
    one cumsum across lanes) does not."""
    cfg_j, cfg, params_j, params, *_ = model
    mcfg_j = dataclasses.replace(cfg_j.moe, capacity_factor=BINDING_CF)
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=BINDING_CF)
    N, B, S = len(LANE_BERS), 2, 8
    assert moe._capacity(B * S, mcfg) == jax_moe._capacity(B * S, mcfg_j) == 8
    assert moe._capacity(N * B * S, mcfg) == 16
    x = np.random.default_rng(3).normal(
        size=(N, B, S, cfg.d_model)).astype(np.float32)
    p = params["layers"][1]["ffn"]
    p_j = jax.tree.map(lambda v: v[1], params_j["groups"]["b0_attn"]["ffn"])
    assert max(_dropped_pairs(x, p["w_router"].numpy(), mcfg)) > 0
    jfi, pfi = _lane_fault_configs(LANE_BERS) if faulted else (None, None)

    def ref(xl, f):
        return jax_moe.moe_apply_global(
            xl, p_j, mcfg_j, cfg_j.mlp,
            None if f is None else f.with_seeds(), 1)
    if faulted:
        want, want_aux = jax.vmap(ref)(jnp.asarray(x), jfi)
    else:
        want, want_aux = jax.vmap(lambda xl: ref(xl, None))(jnp.asarray(x))
    got, aux = moe.moe_apply(T(x.reshape(N * B, S, -1)), p, mcfg, cfg.mlp,
                             pfi, 1, lanes=N)
    np.testing.assert_allclose(got.numpy().reshape(np.shape(want)),
                               np.asarray(want),
                               rtol=MOE_RTOL if faulted else 0,
                               atol=MOE_ATOL)
    assert tuple(aux.shape) == (N,)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=0,
                               atol=MOE_ATOL)
    if not faulted:
        naive, _ = moe.moe_apply(T(x.reshape(N * B, S, -1)), p, mcfg,
                                 cfg.mlp)
        assert not np.allclose(naive.numpy().reshape(np.shape(want)),
                               np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "lane_bers"])
def test_moe_apply_lanes_equal_single_lane_replay(model, faulted):
    """Each lane of the lane path equals ``moe_apply`` of its rows alone
    under ``FaultConfig.lane(i)`` (outputs and aux), at the binding
    capacity: a lane's dispatch sees nothing of the others."""
    cfg, params = model[1], model[3]
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=BINDING_CF)
    N, B, S = len(LANE_BERS), 2, 8
    x = T(np.random.default_rng(4).normal(
        size=(N * B, S, cfg.d_model)).astype(np.float32))
    p = params["layers"][0]["ffn"]
    pfi = _lane_fault_configs(LANE_BERS, key=12)[1] if faulted else None
    got, aux = moe.moe_apply(x, p, mcfg, cfg.mlp, pfi, 0, lanes=N)
    for i in range(N):
        one, one_aux = moe.moe_apply(x[i * B:(i + 1) * B], p, mcfg, cfg.mlp,
                                     None if pfi is None else pfi.lane(i), 0)
        torch.testing.assert_close(got[i * B:(i + 1) * B], one, rtol=0,
                                   atol=0)
        assert float(aux[i]) == float(one_aux)


def test_moe_apply_takes_lanes_from_the_fault_config(model):
    """``lanes`` defaults to ``fi.lanes``; a batch that does not fold the
    lanes raises; decode's ``with_aux=False`` returns no loss."""
    cfg, params = model[1], model[3]
    p = params["layers"][0]["ffn"]
    pfi = _lane_fault_configs(LANE_BERS)[1]
    x = T(np.random.default_rng(5).normal(
        size=(6, 1, cfg.d_model)).astype(np.float32))
    got, aux = moe.moe_apply(x, p, cfg.moe, cfg.mlp, pfi, 0)
    want, want_aux = moe.moe_apply(x, p, cfg.moe, cfg.mlp, pfi, 0, lanes=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)
    assert moe.moe_apply(x, p, cfg.moe, cfg.mlp, pfi, 0,
                         with_aux=False)[1] is None
    with pytest.raises(ValueError, match="fold"):
        moe.moe_apply(x[:5], p, cfg.moe, cfg.mlp, pfi, 0)


def test_forward_aux_is_per_lane(model):
    """A lane-config forward's load-balance loss is ``(N,)``: the vmapped
    reference forward's, lane by lane."""
    cfg_j, cfg, params_j, params, lane_prompts, *_ = model
    jfi, pfi = _lane_fault_configs(LANE_BERS, key=13)
    _, _, want = jax.vmap(lambda t, f: jax_tf.forward_logits(
        params_j, cfg_j, t, fi=f.with_seeds()))(jnp.asarray(lane_prompts),
                                                jfi)
    _, _, got = tf.forward_logits(params, cfg,
                                  T(lane_prompts.reshape(6, -1)), fi=pfi)
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MOE_ATOL)


# --------------------------------------------------------------------------- #
# FleetServeEngine on the MoE family
# --------------------------------------------------------------------------- #
def _engines(model, seed):
    cfg_j, cfg, params_j, params, _, jf, pf = model
    kw = dict(max_len=32, seed=seed, use_systolic_kernel=True,
              use_fused_kernel=True)
    return (JaxFleetServeEngine(cfg_j, params_j, jf, **kw),
            FleetServeEngine(cfg, params, pf, device="cpu", **kw))


@pytest.mark.parametrize("sample", [{}, {"temperature": 0.8, "top_k": 8}],
                         ids=["greedy", "sampled"])
def test_moe_fleet_tokens_match_reference(model, sample):
    """Every lane's tokens equal the reference's vmapped dispatch over a
    ``for_model`` fleet (10 domains, the router's included), greedy and at
    T = 0.8, top_k 8; the served BER matrix matches."""
    lane_prompts = model[4]
    jeng, peng = _engines(model, seed=5)
    want = jeng.generate(lane_prompts, 4, **sample)
    got = peng.generate(lane_prompts, 4, **sample)
    assert got.tokens.shape == (3, 2, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.operators == tuple(want.operators) == OPS
    np.testing.assert_allclose(got.bers, np.asarray(want.bers),
                               rtol=BER_RTOL)


def test_moe_fleet_prefill_logits_match_reference(model):
    """The lane-batched prefill's logits against ``jax.vmap`` of the
    reference's prefill at the fleet's per-lane BERs."""
    cfg_j, cfg, params_j, params, lane_prompts, jf, pf = model
    L = len(AGES)
    jber = jnp.asarray(jf.op_ber_array(), jnp.float32)
    jfi = JaxFaultConfig(bers={op: jber[:, i]
                               for i, op in enumerate(jf.operators)},
                         key=jax.random.split(jax.random.PRNGKey(13), L),
                         step=jnp.zeros((L,), jnp.int32))
    want, _ = jax.vmap(
        lambda p, f: jax_steps.make_prefill_fn(cfg_j, 32)(
            params_j, p, f.with_seeds()))(jnp.asarray(lane_prompts), jfi)
    ber = pf.op_ber_array()
    pfi = FaultConfig(bers={op: tuple(float(b) for b in ber[:, i])
                            for i, op in enumerate(pf.operators)},
                      key=prandom.split(prandom.PRNGKey(13), L)).with_seeds()
    got, _ = steps.prefill(params, cfg, T(lane_prompts.reshape(2 * L, -1)),
                           pfi, 32)
    np.testing.assert_allclose(got.numpy().reshape(np.shape(want)),
                               np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_moe_fleet_lanes_equal_single_lane_replay(model):
    """Every lane's sampled tokens equal the port's single-device
    generation under its slice of the engine's lane config and key."""
    cfg, params, lane_prompts, pf = model[1], model[3], model[4], model[6]
    sample = {"temperature": 0.8, "top_k": 8}
    eng = FleetServeEngine(cfg, params, pf, max_len=32, seed=6,
                           use_systolic_kernel=True, device="cpu")
    res = eng.generate(lane_prompts, 4, **sample)
    _, call_key = prandom.split(prandom.PRNGKey(6))
    fi = eng._fleet_fault_config(call_key)
    keys = prandom.split(prandom.fold_in(call_key, 1), 3)
    for i in range(3):
        toks, _, _ = steps.generate(params, cfg, T(lane_prompts[i]),
                                    fi.lane(i), keys[i], max_len=32,
                                    n_steps=4, **sample)
        np.testing.assert_array_equal(res.tokens[i], toks)
