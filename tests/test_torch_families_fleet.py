"""The hybrid, SSM, VLM and enc-dec families on a fleet, in the resilience
sweep and in training, vs the JAX reference on the CPU (reduced configs
from the reference's params, float32, Pallas in interpret mode):
``FleetServeEngine`` over three lanes of ``FleetRuntime.for_model`` aged
3/6/9 years against the reference's vmapped dispatch and each lane's
single-lane replay; ``run_sweep`` with the VLM's prefix embeddings and the
enc-dec model's frames; ``make_loss_fn``'s loss and gradients against
``jax.value_and_grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calibrate import resilience_sweep as jrs
from repro.configs import get_config as jax_get_config
from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models import encdec as jax_encdec
from repro.models import transformer as jax_tf
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro.train import steps as jax_steps
from repro_torch import random as prandom
from repro_torch.calibrate import resilience_sweep as rs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.fleet import FleetRuntime
from repro_torch.models import family
from repro_torch.serve import steps
from repro_torch.serve.engine import FleetServeEngine
from repro_torch.train import steps as train_steps
from repro_torch.tree import flatten
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

FAMILIES = ("recurrentgemma_2b", "rwkv6_3b", "paligemma_3b",
            "whisper_large_v3")
AGES = (3.0, 6.0, 9.0)
# the age-9 BERs: the BER curve is steep in delay (ROADMAP §C, known drift)
BER_RTOL = 1e-3
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5


def _build(arch, seed=0):
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    init = jax_encdec.init_params if cfg.n_encoder_layers \
        else jax_tf.init_params
    params_j = init(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg_j, cfg, params_j, params_from_reference(
        jax.tree.map(np.asarray, params_j), cfg, device="cpu")


def _extra(cfg, lead, rng):
    return rng.normal(size=lead + family.extra_shape(cfg)).astype(np.float32)


@pytest.fixture(scope="module", params=FAMILIES)
def fleet_model(request):
    cfg_j, cfg, params_j, params = _build(request.param)
    rng = np.random.default_rng(1)
    lane_prompts = rng.integers(0, cfg.vocab, (3, 2, 8))
    name = family.extra_name(cfg)
    extra = {} if name is None else {name: _extra(cfg, (3, 2), rng)}
    jf = JaxFleetRuntime.for_model(cfg_j, n_devices=3)
    pf = FleetRuntime.for_model(cfg, n_devices=3, device="cpu")
    for i, age in enumerate(AGES):
        jf.set_age(years=age, device=i)
        pf.set_age(years=age, device=i)
    return cfg_j, cfg, params_j, params, lane_prompts, extra, jf, pf


def test_fleet_tokens_match_reference(fleet_model):
    """Every lane's greedy tokens equal the reference's vmapped dispatch
    on the fused kernel route (per-lane extras, ``(N, B, ...)``), and the
    served BER matrix matches."""
    cfg_j, cfg, params_j, params, lane_prompts, extra, jf, pf = fleet_model
    kw = dict(max_len=32, seed=5, use_systolic_kernel=True,
              use_fused_kernel=True)
    want = JaxFleetServeEngine(cfg_j, params_j, jf, **kw).generate(
        lane_prompts, 4, **extra)
    got = FleetServeEngine(cfg, params, pf, device="cpu", **kw).generate(
        lane_prompts, 4, **extra)
    assert got.tokens.shape == (3, 2, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.operators == tuple(want.operators)
    np.testing.assert_allclose(got.bers, np.asarray(want.bers),
                               rtol=BER_RTOL)


def test_fleet_lanes_equal_single_lane_replay(fleet_model):
    """Each lane's tokens equal the port's single-device generation under
    its slice of the engine's lane config and key; a flat ``(N * B, ...)``
    batch of prompts and extras serves the same."""
    cfg, params, lane_prompts, extra, pf = (fleet_model[1], fleet_model[3],
                                            fleet_model[4], fleet_model[5],
                                            fleet_model[7])
    eng = FleetServeEngine(cfg, params, pf, max_len=32, seed=6,
                           use_systolic_kernel=True, device="cpu")
    res = eng.generate(lane_prompts, 4, **extra)
    _, call_key = prandom.split(prandom.PRNGKey(6))
    fi = eng._fleet_fault_config(call_key)
    keys = prandom.split(prandom.fold_in(call_key, 1), 3)
    for i in range(3):
        toks, _, _ = steps.generate(
            params, cfg, torch.as_tensor(lane_prompts[i]), fi.lane(i),
            keys[i], max_len=32, n_steps=4,
            **{k: torch.from_numpy(v[i]) for k, v in extra.items()})
        np.testing.assert_array_equal(res.tokens[i], toks)
    flat = FleetServeEngine(cfg, params, pf, max_len=32, seed=6,
                            use_systolic_kernel=True, device="cpu").generate(
        lane_prompts.reshape(6, -1), 4,
        **{k: v.reshape((6,) + v.shape[2:]) for k, v in extra.items()})
    np.testing.assert_array_equal(flat.tokens, res.tokens)


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_large_v3"])
def test_sweep_with_extras_matches_reference(arch):
    """``run_sweep`` with the family's extra input (prefix embeddings,
    frames) broadcast to every lane: the loss surface equals the
    reference's, on the kernel-free route and the fused route."""
    cfg_j, cfg, params_j, params = _build(arch, seed=2)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 8))
    extras = (_extra(cfg, (2,), rng),)
    for kw in (dict(ber_grid=(1e-4, 1e-2), operators=("q", "qkt", "down")),
               dict(ber_grid=(1e-3,), operators=("v", "o"),
                    use_kernel=True, fused=True)):
        want = jrs.run_sweep(cfg_j, params_j, tokens, n_seeds=1,
                             extras=extras, **kw)
        got = rs.run_sweep(cfg, params, tokens, n_seeds=1, extras=extras,
                           device="cpu", **kw)
        np.testing.assert_array_equal(got.loss_pct, want.loss_pct)


def _leaves(tree):
    """Every leaf, by sorted path (the same order for any two trees of
    one structure)."""
    return [x for _, x in sorted(flatten(tree).items())]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """``make_loss_fn``'s loss (the VLM's prefix logits dropped, the
    enc-dec decoder over its encoded frames) and every gradient leaf
    against ``jax.value_and_grad`` of the reference's; remat changes
    neither."""
    cfg_j, cfg, params_j, params = _build(arch, seed=3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    name = family.extra_name(cfg)
    if name:
        batch[name] = _extra(cfg, (2,), rng)
    (jl, _), jg = jax.value_and_grad(jax_steps.make_loss_fn(cfg_j),
                                     has_aux=True)(
        params_j, jax.tree.map(jnp.asarray, batch))
    want = params_from_reference(jax.tree.map(np.asarray, jg), cfg,
                                 device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        for p in _leaves(params):
            p.grad = None
            p.requires_grad_(True)
        loss, _ = train_steps.make_loss_fn(cfg, remat=remat)(params, tb)
        loss.backward()
        assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
        grads.append([p.grad.clone() for p in _leaves(params)])
    for p in _leaves(params):
        p.grad = None
        p.requires_grad_(False)
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], _leaves(want)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_RTOL * np.max(np.abs(b)))


def test_init_train_state_builds_enc_dec():
    st = train_steps.init_train_state(get_config("whisper_large_v3")
                                      .reduced(), 0, device="cpu")
    assert {"enc_layers", "dec_layers", "dec_pos"} <= set(st.params)
    assert all(m.dtype == torch.float32 for m in _leaves(st.opt.mu))
