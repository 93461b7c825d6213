"""ROADMAP C.6: a clean call of S >= 2048 queries runs chunked
(flash-style) attention in both packages.  ``repro_torch.models.attention.
attention`` against ``repro.models.attention.attention`` on the C.6
inputs (B 1, H 4, KV 2, hd 64 from ``numpy.random.default_rng(0)``), and
the three paths that reach it: the training loss and its gradients, a
runtime-less ``ServeEngine.generate`` of a 2,064-token prompt, and a
faulted call, which stays full attention."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import steps as jax_steps
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.data import SyntheticLM
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import steps
from repro_torch.tree import flatten
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

# float32: products and sums in another order than XLA's
F32_ATOL = 1e-5
# the S = 2047 rows are the full-attention baseline (no chunking in either
# package): its non-causal softmax over 1,500 keys reads 1.2e-5
FULL_F32_ATOL = 2e-5
# bf16: the reference rounds the unnormalised exp to bf16 before the PV
# product, the port does the same; what is left is the float32 summation
# order, which moves a rounding now and then.  At S = 2047 (full attention
# in both packages) 0.04 % of outputs differ, by at most 2**-7 (one bf16
# ulp in [1, 2)); the chunked path must stay at that level: at most 1 %
# differ, by at most 2**-7, and few beyond one ulp of their own value (a
# value that is a small difference of large terms moves by more ulps of
# its own: the full-attention baseline has ~0.004 % such outputs)
BF16_MAX_FRAC = 0.01
BF16_ATOL = 2.0 ** -7
BF16_OWN_ULP_FRAC = 2e-4
# reduced llama3_8b, clean bf16 prefill: last-position logits (|logit| < 4,
# one bf16 ulp 2**-6 there) drift from the reference's by 0.016-0.047 at
# every length, S = 16 and 64 included, where neither package chunks (bf16
# roundings of the projections and norms); S = 2048 must stay inside that
LOGIT_ATOL = 0.05
# the loss and gradient tolerances of tests/test_torch_train.py
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5

CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=512),
    "prefix": dict(causal=True, prefix_len=256),
    "cross": dict(causal=False),         # Sk = 1500: kv_valid masks the pad
}


def _inputs(S, Sk):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, S, 4, 64)).astype(np.float32) * 2
    k = rng.standard_normal((1, Sk, 2, 64)).astype(np.float32) * 2
    v = rng.standard_normal((1, Sk, 2, 64)).astype(np.float32)
    return q, k, v


def _bf16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("S", [2047, 2048, 2064])
def test_attention_matches_reference(S, case, dtype):
    kw = CASES[case]
    Sk = 1500 if case == "cross" else S
    q, k, v = _inputs(S, Sk)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_attn.attention(
        *(jnp.asarray(x, jd) for x in (q, k, v)), **kw).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(x).to(td) for x in (q, k, v))
    out = attn.attention(tq, tk, tv, **kw)
    # the dispatch: chunked from 2048 queries, full attention below
    path = attn.chunked_attention if S >= 2048 else attn.full_attention
    assert torch.equal(out, path(tq, tk, tv, **kw))
    got = out.float().numpy()
    assert got.shape == want.shape == (1, S, 4, 64)
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= (F32_ATOL if S >= 2048 else FULL_F32_ATOL)
        return
    own_ulp = np.maximum(_bf16_ulp(want), _bf16_ulp(got))
    assert (d > 0).mean() <= BF16_MAX_FRAC
    assert d.max() <= BF16_ATOL
    assert (d > own_ulp).mean() <= BF16_OWN_ULP_FRAC


def test_fully_masked_chunks_are_wiped():
    """A windowed query meets whole KV chunks of masked keys before its
    first valid one (p == 1 gathers there); the next valid chunk's
    alpha == 0 wipes it, so the result is the window's attention."""
    S = 2048
    q, k, v = (torch.tensor(x) for x in _inputs(S, S))
    got = attn.chunked_attention(q, k, v, causal=True, window=100)
    want = attn.full_attention(q, k, v, causal=True, window=100)
    assert float((got - want).abs().max()) <= F32_ATOL


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_get_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    return jcfg, cfg, jparams


def test_reduced_llama_bf16_prefill_at_2048(llama):
    """Clean bf16 prefill of reduced llama3_8b at S = 2048 (the chunked
    path at every layer): last-position logits and their argmax."""
    jcfg, cfg, jparams = llama
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   dtype=torch.bfloat16, device="cpu")
    tokens = SyntheticLM(vocab=cfg.vocab, seq_len=2048,
                         global_batch=1).batch_at(0).tokens
    want = np.asarray(jax_tf.forward_logits(
        jp16, jcfg, jnp.asarray(tokens))[0][:, -1].astype(jnp.float32))
    with torch.no_grad():
        got = tf.forward_logits(params, cfg, torch.as_tensor(tokens))[0]
    got = got[:, -1].float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def reference_grads(llama):
    """The reference's loss and gradients at S = 2048 (remat changes no
    value in either package)."""
    jcfg, _, jparams = llama
    tb = SyntheticLM(vocab=jcfg.vocab, seq_len=2048,
                     global_batch=1).batch_at(0)
    batch = {"tokens": tb.tokens, "labels": tb.labels}
    (jl, _), jg = jax.value_and_grad(jax_steps.make_loss_fn(jcfg),
                                     has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    return batch, float(jl), jg


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_at_2048(llama, reference_grads, remat):
    """make_loss_fn runs clean, so at S = 2048 its attention is chunked:
    the loss and every gradient leaf against jax.value_and_grad, through
    the KV loop under autograd (and recomputed under remat)."""
    _, cfg, jparams = llama
    batch, jl, jg = reference_grads
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    loss, _ = steps.make_loss_fn(cfg, remat=remat)(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert float(loss) == pytest.approx(jl, rel=LOSS_RTOL)
    want = flatten(params_from_reference(jax.tree.map(np.asarray, jg), cfg,
                                         device="cpu"))
    got = flatten(steps.grads_of(params))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_runtime_less_generate_with_long_prompt(llama):
    """A runtime-less ServeEngine (the clean path) prefills a 2,064-token
    prompt chunked, then decodes: the reference's tokens."""
    jcfg, cfg, jparams = llama
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=2064,
                          global_batch=1).batch_at(3).tokens
    want = JaxServeEngine(jcfg, jparams, max_len=2070, seed=0).generate(
        prompts, 3).tokens
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    got = ServeEngine(cfg, params, max_len=2070, seed=0,
                      device="cpu").generate(prompts, 3).tokens
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_faulted_call_stays_full_attention():
    """A faulted call at S = 2048 is full attention in both packages: the
    dispatch hands ``fi`` to full_attention, bit for bit.  (One head of
    width 16: the plain upset draw hashes each of the 2048**2 qkt words.)"""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2048, 1, 16)),
                            dtype=torch.float32) for _ in range(3))
    fi = FaultConfig(bers={"qkt": 1e-3, "sv": 1e-3}, key=prandom.PRNGKey(7),
                     use_systolic_kernel=False, fused=False)
    got = attn.attention(q, k, v, causal=True, fi=fi, salt=3)
    want = attn.full_attention(q, k, v, causal=True, fi=fi, salt=3)
    assert torch.equal(got, want)
    clean = attn.chunked_attention(q, k, v, causal=True)
    assert float((got - clean).abs().max()) > 0      # the upsets landed
