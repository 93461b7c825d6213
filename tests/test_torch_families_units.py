"""The hybrid, SSM and VLM families of the port vs the JAX reference on
the CPU, unit by unit and at the edges (tests/test_torch_families_common.py
sets up the reduced models): ``convert``'s unrolling of groups + tail, a
sliding-window ring past its capacity, windowed llama (C.1), the RG-LRU
scan and conv, the WKV chunks and RWKV time mix, the attention masks,
ROADMAP C.5 (norm rows whose float32 sum overflows), the decode state per
block kind, and the port's own params of all four families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families_common import (LOGIT_ATOL, Forced, _build, _extra,
                                        _fault_configs, _kw, _logits)
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.models import attention, encdec, layers, rglru, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.serve import steps
from repro_torch.serve.engine import ServeEngine

FAMILIES = ("recurrentgemma_2b", "rwkv6_3b", "paligemma_3b",
            "whisper_large_v3")


def test_convert_unrolls_groups_and_tail():
    """recurrentgemma's 26 layers are 8 (rec, rec, attn) groups and a (rec,
    rec) tail; at 5 reduced layers (1 group + tail) the port's layer i is
    the reference's group block or tail block of that index, and the
    faulted forward (salt = layer index) equals the reference's."""
    full = get_config("recurrentgemma_2b")
    assert tf.layer_kinds(full)[-3:] == ["attn", "rec", "rec"]
    assert tf.layer_kinds(full).count("attn") == 8
    cfg_j = dataclasses.replace(
        jax_get_config("recurrentgemma_2b").reduced(), n_layers=5)
    cfg = dataclasses.replace(get_config("recurrentgemma_2b").reduced(),
                              n_layers=5)
    params_j, params = _build(cfg_j, cfg, seed=1)
    assert tf.layer_kinds(cfg) == ["rec", "rec", "attn", "rec", "rec"]
    np.testing.assert_array_equal(
        params["layers"][1]["rglru"]["w_x"].numpy(),
        np.asarray(params_j["groups"]["b1_rec"]["rglru"]["w_x"][0]))
    np.testing.assert_array_equal(
        params["layers"][4]["ffn"]["w_up"].numpy(),
        np.asarray(params_j["tail"][1]["b0_rec"]["ffn"]["w_up"]))
    assert params["layers"][0]["rglru"]["lam"].dtype == torch.float32
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10))
    want, got = _logits("recurrentgemma_2b", cfg_j, cfg, params_j, params,
                        prompts, None, *_fault_configs(True))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_window_ring_past_capacity():
    """recurrentgemma reduced (window 16) with a 20-token prompt and 8
    decode tokens at max_len 64: the prefill keeps the last 16 tokens
    rolled to slot t % 16, each decode step ring-writes past the window,
    and the tokens equal the reference's (fused route, BER 1e-3)."""
    cfg_j = jax_get_config("recurrentgemma_2b").reduced()
    cfg = get_config("recurrentgemma_2b").reduced()
    assert cfg.window == 16
    params_j, params = _build(cfg_j, cfg, seed=2)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (2, 20))
    cache = tf.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    assert cache[2]["k"].shape[1] == 16
    kw = dict(runtime=Forced(1e-3), max_len=64, use_systolic_kernel=True,
              seed=9)
    want = JaxServeEngine(cfg_j, params_j, **kw).generate(prompts, 9)
    got = ServeEngine(cfg, params, device="cpu", **kw).generate(prompts, 9)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    # the prefill's ring: token t of the prompt at slot t % 16
    _, cache = steps.prefill(params, cfg, torch.as_tensor(prompts), None, 64)
    _, _, k_ref = _prompt_keys(params, cfg, prompts)
    for t in range(4, 20):
        torch.testing.assert_close(cache[2]["k"][:, t % 16], k_ref[:, t],
                                   rtol=0, atol=0)


def _prompt_keys(params, cfg, prompts):
    """Layer 2's (the attention layer's) roped keys of every prompt
    token."""
    x = tf.embed_tokens(params, cfg, torch.as_tensor(prompts))
    pos = torch.arange(x.shape[1])[None]
    for i in range(2):
        x, _, _ = tf._rec_block(x, params["layers"][i], cfg, salt=i)
    bp = params["layers"][2]
    h = layers.norm(x, bp["norm1"], cfg.norm)
    k = torch.einsum("bsd,dhk->bshk", h, bp["attn"]["wk"])
    return x, h, layers.apply_rope(k, pos, cfg.rope_theta)


def test_windowed_llama_generate_matches_reference():
    """C.1's reproduction served: reduced llama3_8b with ``window=4`` (the
    prompt longer than the window, decode past it) generates the windowed
    reference's tokens on the fused route."""
    cfg_j = dataclasses.replace(jax_get_config("llama3_8b").reduced(),
                                window=4)
    cfg = dataclasses.replace(get_config("llama3_8b").reduced(), window=4)
    params_j, params = _build(cfg_j, cfg, seed=3)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (2, 10))
    kw = dict(runtime=Forced(1e-3), max_len=32, use_systolic_kernel=True,
              seed=2)
    want = JaxServeEngine(cfg_j, params_j, **kw).generate(prompts, 6)
    got = ServeEngine(cfg, params, device="cpu", **kw).generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)


# --------------------------------------------------------------------------- #
# units
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [1, 2, 7, 16, 37])
def test_rglru_scan_matches_reference(S):
    """The associative scan in the reference's odd/even order: equal to
    its op-by-op evaluation bit for bit (its compiled form contracts
    multiply-adds, within 5e-7 of this)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 32)).astype(np.float32)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    h0 = rng.normal(size=(2, 32)).astype(np.float32)
    for h in (None, h0):
        want = jax_rglru._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                                     None if h is None else jnp.asarray(h))
        got = rglru._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                                None if h is None else torch.from_numpy(h))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv1d_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    w = rng.normal(size=(4, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 32)).astype(np.float32)
    for s in (None, st):
        wy, ws = jax_rglru._conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if s is None else jnp.asarray(s))
        gy, gs = rglru._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if s is None else torch.from_numpy(s))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_chunked_wkv_matches_reference():
    """Three 128-token chunks from a non-zero state: output and final
    state within 4e-6 of their largest magnitude (float32 einsums in
    another order; measured 2.2e-6 on the state, 6e-7 on the output)."""
    rng = np.random.default_rng(2)
    B, S, H, N = 2, 384, 4, 8
    r, k, v = (rng.normal(size=(B, S, H, N)).astype(np.float32)
               for _ in range(3))
    w = -rng.uniform(1e-6, 0.25, (B, S, H, N)).astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    wo, ws = jax_rwkv._chunked_wkv(*(jnp.asarray(t) for t in (r, k, v, w, u)),
                                   128, jnp.asarray(s0))
    go, gs = rwkv6._chunked_wkv(*(torch.from_numpy(t)
                                  for t in (r, k, v, w, u)), 128,
                                torch.from_numpy(s0))
    for got, want in ((go, wo), (gs, ws)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4e-6 * np.abs(want).max())


@pytest.mark.parametrize("state", [False, True], ids=["prefill", "carried"])
def test_rwkv_time_mix_pads_like_reference(state):
    """S = 320 tokens (2.5 chunks): the zero padding to 384 gives the
    reference's output and final WKV state (which depends on it), from a
    zero or a carried state; and the decode fast path after it.  Within
    1e-6 (outputs; measured 2.8e-7) and 4e-6 (the state) of the largest
    magnitude."""
    cfg_j = jax_get_config("rwkv6_3b").reduced()
    cfg = get_config("rwkv6_3b").reduced()
    params_j, params = _build(cfg_j, cfg, seed=4)
    p_j = jax.tree.map(lambda t: t[0], params_j["groups"]["b0_rwkv"]["tm"])
    p = params["layers"][0]["tm"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 320, cfg.d_model)).astype(np.float32)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    st = {"shift": rng.normal(size=(2, cfg.d_model)).astype(np.float32),
          "wkv": rng.normal(size=(2, H, hd, hd)).astype(np.float32)}
    st_j = ({k: jnp.asarray(v) for k, v in st.items()} if state
            else jax_rwkv.rwkv_init_state(2, cfg.d_model, hd)["tm"])
    st_p = ({k: torch.from_numpy(v) for k, v in st.items()} if state
            else rwkv6.rwkv_init_state(2, cfg.d_model, hd, "cpu")["tm"])
    want, ns_j = jax_rwkv.rwkv_time_mix(jnp.asarray(x), p_j, hd, state=st_j)
    got, ns = rwkv6.rwkv_time_mix(torch.from_numpy(x), p, hd, state=st_p)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    wkv = np.asarray(ns_j["wkv"])
    np.testing.assert_allclose(ns["wkv"].numpy(), wkv, rtol=0,
                               atol=4e-6 * np.abs(wkv).max())
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want1, _ = jax_rwkv.rwkv_time_mix(jnp.asarray(x1), p_j, hd, state=ns_j)
    got1, _ = rwkv6.rwkv_time_mix(torch.from_numpy(x1), p, hd, state=ns)
    want1 = np.asarray(want1)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=0,
                               atol=1e-6 * np.abs(want1).max())


@pytest.mark.parametrize("causal,window,prefix", [
    (True, None, 0), (True, 4, 0), (True, None, 5), (True, 3, 5),
    (False, None, 0)])
def test_mask_matches_reference(causal, window, prefix):
    q = np.arange(12) + 3
    k = np.arange(15)
    want = np.asarray(jax_attn._mask(jnp.asarray(q), jnp.asarray(k), causal,
                                     window, prefix))
    got = attention._mask(torch.as_tensor(q), torch.as_tensor(k), causal,
                          window, prefix)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_row_sum_overflow_matches_reference(kind):
    """ROADMAP C.5: a row whose float32 sum overflows (accumulator upsets
    make such rows) has an infinite mean in the reference, so its RMS
    norm is 0 (a sum of squares past float32's range) and its layer norm
    NaN (a sum of values past it); the port's float64-accumulated mean
    once kept such rows finite."""
    x = np.stack([np.full(64, 5e18 if kind == "rms" else 6e36, np.float32),
                  np.linspace(-1.0, 1.0, 64, dtype=np.float32)])
    scale = np.ones(64, np.float32)
    want = np.asarray(jax_layers.norm(jnp.asarray(x),
                                      {"scale": jnp.asarray(scale)}, kind))
    got = layers.norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)},
                      kind).numpy()
    assert (want[0] == 0).all() if kind == "rms" else np.isnan(want[0]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_init_cache_per_block_kind():
    """Decode state per layer kind, with the reference's dtypes: a ring of
    ``window`` slots for windowed attention, the RG-LRU's conv tail in the
    cache dtype and float32 h, RWKV's bf16 shifts and float32 WKV."""
    hyb = get_config("recurrentgemma_2b").reduced()
    c = tf.init_cache(hyb, 2, 64, dtype=torch.bfloat16, device="cpu")
    assert c[0]["conv"].shape == (2, 3, hyb.d_model)
    assert c[0]["conv"].dtype == torch.bfloat16
    assert c[0]["h"].dtype == torch.float32
    assert c[2]["k"].shape == (2, hyb.window, hyb.n_kv_heads, hyb.hd)
    ssm = get_config("rwkv6_3b").reduced()
    c = tf.init_cache(ssm, 2, 64, device="cpu")
    H = ssm.d_model // ssm.rwkv_head_dim
    assert c[0]["tm"]["shift"].dtype == torch.bfloat16
    assert c[0]["cm_shift"].dtype == torch.bfloat16
    assert c[0]["tm"]["wkv"].shape == (2, H, ssm.rwkv_head_dim,
                                       ssm.rwkv_head_dim)
    assert c[0]["tm"]["wkv"].dtype == torch.float32
    ed = get_config("whisper_large_v3").reduced()
    c = encdec.init_cache(ed, 2, 64, dtype=torch.float32, device="cpu")
    assert len(c) == ed.n_layers and c[0]["k"].shape == (2, 64, 2, ed.hd)


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_init_params_serve(arch):
    """The port's own random params (bf16, from a seed) serve each family
    on the CPU: finite taps, tokens in the vocabulary, a finite score."""
    cfg = get_config(arch).reduced()
    init = encdec.init_params if cfg.n_encoder_layers else tf.init_params
    params = init(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (2, 8))
    kw = _kw(cfg, _extra(cfg, 2, rng), np.asarray)
    eng = ServeEngine(cfg, params, runtime=Forced(1e-4), max_len=32,
                      use_systolic_kernel=True, device="cpu")
    out = eng.generate(prompts, 4, **kw)
    assert out.tokens.shape == (2, 4)
    assert ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()
    assert np.isfinite(eng.score(np.concatenate([prompts, out.tokens], 1),
                                 **kw))
