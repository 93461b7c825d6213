"""The grouped MoE dispatch (repro_torch.models.moe.moe_apply_grouped,
``MOE_DISPATCH = "grouped"``) against the reference's
``moe_apply_grouped`` on the CPU: float32 inputs from numpy, outputs
within 1e-5 and the load-balance loss within 1e-6 (float32 sums in
another order), kept tokens in float32 and bf16; a capacity that drops
tokens; arctic's dense residual; B = 1 equal to the global dispatch;
with a fault config ``moe_apply`` stays on the global path, as the
reference's; and the dispatch knob through a whole forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import random as prandom
from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig

ATOL = 1e-5


def _torch_tree(p_j, dtype):
    """A reference param dict -> torch, the router float32 as in both."""
    return {k: _torch_tree(v, dtype) if isinstance(v, dict) else
            torch.as_tensor(np.asarray(v, np.float32)).to(
                torch.float32 if k == "w_router" else dtype)
            for k, v in p_j.items()}


def _expert_params(d, f, moe_cfg, variant, dtype, seed=0):
    """The reference's MoE block params, and the same values in torch."""
    p_j = jax_moe.moe_init(jax.random.PRNGKey(seed), d, f, moe_cfg, variant,
                           dtype)
    return p_j, _torch_tree(p_j, torch.float32 if dtype == jnp.float32
                            else torch.bfloat16)


def _cfgs(E, K, cf, dense=False):
    return (JaxMoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                         dense_residual=dense),
            MoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                      dense_residual=dense))


CASES = {
    # (B, S, d, f, E, K, capacity factor, variant, dense residual)
    "gated": (3, 16, 32, 48, 4, 2, 1.25, "gated", False),
    "drops": (2, 24, 32, 48, 4, 2, 0.5, "gated", False),
    "arctic_dense": (2, 16, 32, 48, 8, 2, 1.0, "gated", True),
    "plain_gelu": (2, 16, 32, 48, 4, 1, 1.0, "plain", False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_grouped_matches_reference(case, dtype):
    B, S, d, f, E, K, cf, variant, dense = CASES[case]
    mj, mp = _cfgs(E, K, cf, dense)
    jdt = getattr(jnp, dtype)
    p_j, p = _expert_params(d, f, mj, variant, jdt)
    x = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    want, aux_j = jax.jit(lambda x, p: jax_moe.moe_apply_grouped(
        x, p, mj, variant))(jnp.asarray(x, jdt), p_j)
    got, aux = moe.moe_apply_grouped(
        torch.as_tensor(x).to(getattr(torch, dtype)), p, mp, variant)
    if case == "drops":     # the per-row capacity 8 < 24 * 2 / 4 pairs
        assert moe._capacity(S, mp) == 8
    # float32: the router and expert sums in another order; bf16: those
    # orders move a bf16 rounding now and then
    atol = ATOL if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)
    assert float(aux) == pytest.approx(float(aux_j), abs=1e-6)


def test_one_row_is_the_global_dispatch():
    """At B = 1 the per-row capacity is the global one: the two
    dispatches give the same output bit for bit."""
    mj, mp = _cfgs(4, 2, 1.0)
    _, p = _expert_params(32, 48, mj, "gated", jnp.float32)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 20, 32)).astype(np.float32))
    a, aux_a = moe.moe_apply_grouped(x, p, mp, "gated")
    b, aux_b = moe.moe_apply(x, p, mp, "gated")
    assert torch.equal(a, b)
    assert torch.equal(aux_a, aux_b)


def test_dispatch_knob(monkeypatch):
    """``MOE_DISPATCH = "grouped"`` sends a clean call to the grouped
    dispatch and a faulted one to the global path, as the reference."""
    mj, mp = _cfgs(4, 2, 1.0)
    _, p = _expert_params(32, 48, mj, "gated", jnp.float32)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 16, 32)).astype(np.float32))
    fi = FaultConfig(bers={"router": 1e-3}, key=prandom.PRNGKey(0))
    glob_clean = moe.moe_apply(x, p, mp, "gated")[0]
    glob_fault = moe.moe_apply(x, p, mp, "gated", fi)[0]
    monkeypatch.setattr(moe, "MOE_DISPATCH", "grouped")
    assert torch.equal(moe.moe_apply(x, p, mp, "gated")[0],
                       moe.moe_apply_grouped(x, p, mp, "gated")[0])
    assert torch.equal(moe.moe_apply(x, p, mp, "gated", fi)[0], glob_fault)
    assert not torch.equal(moe.moe_apply(x, p, mp, "gated")[0], glob_clean)


def test_grouped_forward_matches_reference(monkeypatch):
    """Reduced qwen3_moe_235b, float32, a whole clean forward under
    ``MOE_DISPATCH = "grouped"`` in both packages (B = 3 rows)."""
    cfg_j = jax_get_config("qwen3_moe_235b").reduced()
    cfg = get_config("qwen3_moe_235b").reduced()
    pj = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = params_from_reference(jax.tree.map(np.asarray, pj), cfg,
                              device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (3, 12))
    monkeypatch.setattr(jax_moe, "MOE_DISPATCH", "grouped")
    monkeypatch.setattr(moe, "MOE_DISPATCH", "grouped")
    want = jax.jit(lambda pj, t: jax_tf.forward_logits(pj, cfg_j, t)[:3:2])(
        pj, jnp.asarray(toks))
    got = tf.forward_logits(p, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    assert float(got[2]) == pytest.approx(float(want[1]), abs=1e-6)
