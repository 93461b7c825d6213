"""Serving an int8 weight tree (repro_torch.models.transformer.
quantize_params) against the reference serving its own on the CPU,
reduced llama3_8b: ``ServeEngine.generate`` on a 9-year device on the
fused and three-pass routes (the reference's Pallas kernels in interpret
mode, the port's plain versions), the prefill logits, ``score``, a
``FleetServeEngine`` of two devices aged 3 and 8 years, and
``OnlineServeEngine``'s no-arrival run.  The int8 tree serves in bf16
in both packages, the reference as XLA compiles it by default: greedy
tokens are held by :func:`torch_int8_common.assert_same_greedy`,
faulted logits within :data:`torch_int8_common.LOGIT_ATOL`, the score
within 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fleet import FleetRuntime as JaxFleetRuntime
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro.serve.engine import FleetServeEngine as JaxFleetServeEngine
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.online import OnlineServeEngine as JaxOnlineServeEngine
from repro.serve.online import Request as JaxRequest
from repro_torch import random as prandom
from repro_torch.core.fleet import FleetRuntime
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from repro_torch.serve import steps
from repro_torch.serve.engine import FleetServeEngine, ServeEngine
from repro_torch.serve.online import OnlineServeEngine, Request
from torch_int8_common import (LOGIT_ATOL, assert_same_greedy, int8_pair,
                               prompts, sampled_logits)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

MAX_LEN = 32


@pytest.fixture(scope="module")
def model():
    return int8_pair("llama3_8b")


def _fleets(ages):
    jf = JaxFleetRuntime(n_devices=len(ages))
    pf = FleetRuntime(n_devices=len(ages), device="cpu")
    for f in (jf, pf):
        for i, a in enumerate(ages):
            f.set_age(years=a, device=i)
    return jf, pf


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_generate_at_9y_matches_reference(model, fused):
    cfg_j, cfg, q_j, q = model
    jf, pf = _fleets([9.0])
    kw = dict(max_len=MAX_LEN, use_systolic_kernel=True,
              use_fused_kernel=fused, seed=3)
    want = JaxServeEngine(cfg_j, q_j, runtime=jf, **kw).generate(
        prompts(cfg), 6)
    with sampled_logits() as logits:
        got = ServeEngine(cfg, q, runtime=pf, device="cpu", **kw).generate(
            prompts(cfg), 6)
    assert_same_greedy(got.tokens, want.tokens, logits)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_prefill_logits_and_cache_dtype(model, fused):
    """Prefill logits at BER 1e-3 on every domain within bf16 rounding;
    the int8 tree's cache is bf16, as the reference's default."""
    cfg_j, cfg, q_j, q = model
    ops = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")
    jfi = JaxFaultConfig(bers={op: jnp.float32(1e-3) for op in ops},
                         key=jax.random.PRNGKey(11), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=fused).with_seeds()
    pfi = FaultConfig(bers={op: 1e-3 for op in ops},
                      key=prandom.PRNGKey(11), use_systolic_kernel=True,
                      fused=fused).with_seeds()
    want, _ = jax_steps.make_prefill_fn(cfg_j, MAX_LEN)(
        q_j, jnp.asarray(prompts(cfg)), jfi)
    got, cache = steps.prefill(q, cfg, torch.as_tensor(prompts(cfg)), pfi,
                               MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    assert cache[0]["k"].dtype == torch.bfloat16


def test_int8_tree_serves_as_its_dequantised_tree(model):
    """The int8 tree and ``dequant_tree`` of it (a bf16 tree) give the same
    tokens and bit-equal logits: each layer dequantises to those values."""
    _, cfg, _, q = model
    pf = _fleets([9.0])[1]
    eng = lambda p: ServeEngine(cfg, p, runtime=pf, max_len=MAX_LEN, seed=3,
                                use_systolic_kernel=True, device="cpu")
    a, b = eng(q).generate(prompts(cfg), 5), eng(
        tf.dequant_tree(q)).generate(prompts(cfg), 5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    toks = torch.as_tensor(prompts(cfg))
    la = tf.forward_logits(q, cfg, toks)[0]
    lb = tf.forward_logits(tf.dequant_tree(q), cfg, toks)[0]
    assert torch.equal(la, lb)


def test_score_matches_reference(model):
    cfg_j, cfg, q_j, q = model
    jf, pf = _fleets([9.0])
    toks = prompts(cfg, B=2, S=12, seed=4)
    want = JaxServeEngine(cfg_j, q_j, runtime=jf, seed=2).score(toks)
    got = ServeEngine(cfg, q, runtime=pf, seed=2, device="cpu").score(toks)
    assert got == pytest.approx(float(want), rel=1e-3)


def test_fleet_3y_8y_matches_reference(model):
    cfg_j, cfg, q_j, q = model
    jf, pf = _fleets([3.0, 8.0])
    lane_prompts = np.stack([prompts(cfg), prompts(cfg, seed=5)])
    kw = dict(max_len=MAX_LEN, seed=1, use_systolic_kernel=True)
    want = JaxFleetServeEngine(cfg_j, q_j, jf, **kw).generate(lane_prompts, 5)
    with sampled_logits() as logits:     # (lanes * B, vocab), lane-major
        got = FleetServeEngine(cfg, q, pf, device="cpu", **kw).generate(
            lane_prompts, 5)
    assert_same_greedy(got.tokens, np.asarray(want.tokens), logits)
    np.testing.assert_allclose(got.bers, np.asarray(want.bers), rtol=1e-3)


def test_online_no_arrival_matches_reference(model):
    """All slots filled at step 0, 7 = 1 + 2 chunks of 3 tokens each: each
    package's online engine gives its ``ServeEngine.generate``'s tokens
    from the int8 tree, and the two ``generate`` streams agree
    (:func:`torch_int8_common.assert_same_greedy`)."""
    cfg_j, cfg, q_j, q = model
    jf, pf = _fleets([9.0])
    p = prompts(cfg, B=3)
    kw = dict(n_slots=3, max_len=MAX_LEN, max_new_cap=8, chunk_steps=3,
              seed=5)
    reqs = [dict(id=i, prompt=p[i], max_new=7) for i in range(3)]
    want = JaxOnlineServeEngine(cfg_j, q_j, runtime=jf, **kw).serve(
        [JaxRequest(**r) for r in reqs])
    got = OnlineServeEngine(cfg, q, runtime=pf, device="cpu", **kw).serve(
        [Request(**r) for r in reqs])
    by_id = lambda res: np.stack([np.asarray(r.tokens) for r in sorted(
        res.completed, key=lambda r: r.id)])
    want_gen = JaxServeEngine(cfg_j, q_j, runtime=jf, max_len=MAX_LEN,
                              seed=5).generate(p, 7)
    np.testing.assert_array_equal(by_id(want), want_gen.tokens)
    with sampled_logits() as logits:
        gen = ServeEngine(cfg, q, runtime=pf, max_len=MAX_LEN, seed=5,
                          device="cpu").generate(p, 7)
    np.testing.assert_array_equal(by_id(got), gen.tokens)
    assert_same_greedy(gen.tokens, want_gen.tokens, logits)
