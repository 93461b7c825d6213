"""The int8 KV cache (repro_torch.models.transformer.init_cache(quantized=
True), quantize_cache_entry) against the reference's on the CPU, reduced
configs from the reference's bf16 params, the reference as XLA compiles
it by default.  ``quantize_cache_entry`` is the reference's bit for bit.
The cache a prefill leaves, clean and at BER 1e-3 on the fused route:
in each package the int8 cache is its own bf16 cache quantised by
``quantize_cache_entry``, bit for bit; clean, the port's entries
dequantised are the reference's within :data:`CACHE_ATOL`, the first
layer's (K/V of the embeddings, which no fused bf16 chain precedes) bit
for bit.  Decode on the cache against the reference's
``make_decode_step`` at one depth and at per-row depths, and on a
windowed config whose ring wraps, both packages fed the reference's
greedy tokens: logits within :data:`torch_int8_common.LOGIT_ATOL` every
step, the port's greedy token the reference's wherever the runner-up is
more than :data:`torch_int8_common.TIE_MARGIN` behind, the caches as
after prefill.  The reference quantises the cache inside its compiled
steps (:func:`repro_torch.models.transformer.quantize_cache_entry` says
how that rounds), so its entry is compared jitted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.serve import steps as jax_steps
from repro_torch import random as prandom
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from torch_int8_common import (LOGIT_ATOL, TIE_MARGIN, configs, prompts,
                               reference_params, to_numpy)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")
# K/V of magnitude ~3 in bf16, one layer of bf16 rounding apart (the
# reference's fused chains round less often): a few bf16 ulps, two int8
# steps of a row's scale
CACHE_ATOL = 0.0625


def _model(arch, **kw):
    cfg_j, cfg = configs(arch, **kw)
    pj = reference_params(cfg_j, seed=1)
    return cfg_j, cfg, pj, params_from_reference(
        to_numpy(pj), cfg, dtype=torch.bfloat16, device="cpu")


@pytest.fixture(scope="module")
def llama():
    return _model("llama3_8b")


def _fault_configs(faulted):
    if not faulted:
        return None, None
    jfi = JaxFaultConfig(bers={op: jnp.float32(1e-3) for op in OPS},
                         key=jax.random.PRNGKey(7), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=True).with_seeds()
    pfi = FaultConfig(bers={op: 1e-3 for op in OPS}, key=prandom.PRNGKey(7),
                      use_systolic_kernel=True, fused=True).with_seeds()
    return jfi, pfi


@torch.no_grad()
def _prefill(model, toks, max_len, fis=(None, None), quantized=True):
    cfg_j, cfg, pj, p = model
    S = toks.shape[1]
    lj, cj, _ = jax.jit(lambda pj, t, fi: jax_tf.forward_logits(
        pj, cfg_j, t, states=jax_tf.init_cache(cfg_j, t.shape[0], max_len,
                                               quantized=quantized),
        cache_len=jnp.int32(S), fi=fi))(pj, jnp.asarray(toks), fis[0])
    lp, cp, _ = tf.forward_logits(
        p, cfg, torch.as_tensor(toks),
        states=tf.init_cache(cfg, toks.shape[0], max_len, device="cpu",
                             quantized=quantized), cache_len=S, fi=fis[1])
    return (lj, cj), (lp, cp)


def _attn_layers(cfg):
    return [i for i, kind in enumerate(tf.layer_kinds(cfg)) if kind == "attn"]


def _assert_cache_close(cp, cj, cfg, exact=()):
    """The port's int8 cache against the reference's: the layers in
    ``exact`` bit for bit, every layer dequantised within CACHE_ATOL."""
    want = cache_from_reference(to_numpy(cj), cfg, device="cpu")
    for i in _attn_layers(cfg):
        for name in ("k", "v"):
            got, w = cp[i][name], want[i][name]
            for f in ("int8_q", "int8_s"):
                assert got[f].dtype == w[f].dtype
                if i in exact:
                    assert torch.equal(got[f], w[f]), (i, name, f)
            torch.testing.assert_close(
                tf.dequant_tree(got, torch.float32),
                tf.dequant_tree(w, torch.float32), rtol=0, atol=CACHE_ATOL)


def _assert_quantises(cq, cb, cfg):
    """An int8 cache ``cq`` is :func:`tf.quantize_cache_entry` of the bf16
    cache ``cb`` (port caches), bit for bit."""
    for i in _attn_layers(cfg):
        for name in ("k", "v"):
            own = tf.quantize_cache_entry(cb[i][name])
            for f in ("int8_q", "int8_s"):
                assert torch.equal(cq[i][name][f], own[f]), (i, name, f)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "ber_1e-3"])
def test_prefill_cache_matches_reference(llama, faulted):
    """Each package's int8 cache is its own bf16 cache quantised the port's
    way, bit for bit.  Clean, the two packages' int8 caches agree within
    CACHE_ATOL, the first layer bit for bit; at BER 1e-3 an upset turns a
    one-unit difference of an int32 sum into one of up to its flipped bit,
    so only the quantisation is compared there."""
    cfg = llama[1]
    toks = prompts(cfg, S=10)
    (lj, cj), (lp, cp) = _prefill(llama, toks, 16, _fault_configs(faulted))
    (_, cjb), (_, cpb) = _prefill(llama, toks, 16, _fault_configs(faulted),
                                  quantized=False)
    _assert_quantises(cp, cpb, cfg)
    _assert_quantises(cache_from_reference(to_numpy(cj), cfg, device="cpu"),
                      cache_from_reference(to_numpy(cjb), cfg, device="cpu"),
                      cfg)
    assert cp[0]["k"]["int8_q"].shape == (2, 16, cfg.n_kv_heads, cfg.hd)
    assert cp[0]["k"]["int8_s"].shape == (2, 16, cfg.n_kv_heads, 1)
    if not faulted:
        _assert_cache_close(cp, cj, cfg, exact=_attn_layers(cfg)[:1])
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)


def test_quantize_cache_entry_matches_reference(llama):
    x = np.random.default_rng(2).normal(size=(2, 3, 2, 16)).astype(
        np.float32)
    x[0, 1] = 0.0                    # an all-zero head: scale 1e-8 / 127
    want = jax.jit(jax_tf.quantize_cache_entry)(jnp.asarray(x, jnp.bfloat16))
    got = tf.quantize_cache_entry(torch.as_tensor(x).bfloat16())
    np.testing.assert_array_equal(got["int8_q"].numpy(),
                                  np.asarray(want["int8_q"]))
    np.testing.assert_array_equal(got["int8_s"].numpy(),
                                  np.asarray(want["int8_s"]))


@torch.no_grad()
def _decode_both(model, toks, max_len, n, per_row, exact=()):
    """Prefill ``toks`` into int8 caches, then ``n`` decode steps in both
    packages (the reference's ``make_decode_step``), both fed the
    reference's greedy token; the cache depth is an int, or a (B,) vector
    of equal depths when ``per_row``.  Each step's logits agree within
    LOGIT_ATOL and the greedy tokens where the choice is not a tie within
    TIE_MARGIN; the caches after the last step as :func:`
    _assert_cache_close`."""
    cfg_j, cfg, pj, p = model
    (lj, cj), (lp, cp) = _prefill(model, toks, max_len)
    step_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    B, S = toks.shape

    def check(lj, lp):
        lj = torch.as_tensor(np.array(lj))
        torch.testing.assert_close(lp, lj, rtol=0, atol=LOGIT_ATOL)
        tj, tp = torch.argmax(lj, -1), torch.argmax(lp, -1)
        gap = lp.gather(-1, tp[:, None]) - lp.gather(-1, tj[:, None])
        assert torch.all((tp == tj) | (gap[:, 0] <= TIE_MARGIN))
        return tj

    tj = check(lj[:, -1], lp[:, -1])
    for t in range(n):
        depth = S + 1 + t
        lj, cj = step_j(pj, jnp.asarray(tj.numpy(), jnp.int32)[:, None], cj,
                        jnp.full((B,), depth, jnp.int32) if per_row
                        else jnp.int32(depth))
        lp, cp = tf.decode_step(p, cfg, tj[:, None], cp,
                                torch.full((B,), depth) if per_row
                                else depth)
        tj = check(lj, lp[:, -1])                          # (B, vocab)
    _assert_cache_close(cp, cj, cfg, exact)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_decode_on_int8_cache_matches_reference(llama, per_row):
    _decode_both(llama, prompts(llama[1], S=6), 16, 6, per_row,
                 exact=_attn_layers(llama[1])[:1])


def test_windowed_ring_wraps(llama):
    """recurrentgemma (window 16, a ring of 16 slots): a 20-token prompt
    keeps its last 16 tokens rolled into the ring, and 6 decode steps
    wrap it further; the cache stays the reference's within CACHE_ATOL."""
    model = _model("recurrentgemma_2b")
    assert model[1].window == 16
    _decode_both(model, prompts(model[1], S=20), 32, 6, False)
