"""The online slots' model-level pieces against the reference on the CPU:
ragged-depth decode (a ``(B,)`` vector ``cache_len``: per-row RoPE
positions, per-row ring writes, per-row valid masks) for a dense model,
the hybrid (windowed ring past its window, RG-LRU states) and the SSM
(RWKV states), clean and faulted; an all-equal vector against the scalar
bit for bit; ``logit_taps(active=)``; the slot refill's cache merge; and
the families the online slots refuse.

Inputs come from numpy; the reference's params are carried across by
``repro_torch.convert``.  Tolerances: tokens (argmax) exact, logits 1e-4
(float32 reductions in another order, ROADMAP §C), taps 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro.obs.taps import logit_taps as jax_logit_taps
from repro.serve import slots as jax_slots
from repro.serve import steps as jax_steps
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import FaultConfig
from repro_torch.obs.taps import logit_taps
from repro_torch.serve import slots, steps
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

LOGIT_ATOL = 1e-4
TAP_ATOL = 1e-5
OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "r", "g",
       "w")


def T(x):
    return torch.from_numpy(np.array(x))


def _model(arch):
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    pj = jax_tf.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = params_from_reference(jax.tree.map(np.asarray, pj), cfg,
                              device="cpu")
    return cfg_j, cfg, pj, p


def _faults(faulted: bool):
    if not faulted:
        return None, None
    bers = {op: 1e-3 for op in OPS}
    jfi = JaxFaultConfig(bers={k: jnp.float32(v) for k, v in bers.items()},
                         key=jax.random.PRNGKey(3), use_systolic_kernel=False)
    fi = FaultConfig(bers=bers, key=prandom.PRNGKey(3),
                     use_systolic_kernel=False)
    return jfi.with_seeds(), fi.with_seeds()


# recurrentgemma_2b's reduced window is 16: a 20-token prompt and decode
# depths up to 27 keep its local-attention ring past the window
@pytest.mark.parametrize("arch,faulted", [
    ("llama3_8b", False), ("llama3_8b", True),
    ("recurrentgemma_2b", False), ("recurrentgemma_2b", True),
    ("rwkv6_3b", True)])
def test_ragged_decode_matches_reference(arch, faulted):
    """Four decode steps at per-row depths (rows 2 and 3 held back, as
    retired slots are) equal the reference's ``decode_step`` with the
    same vector: logits within 1e-4 and the same argmax."""
    cfg_j, cfg, pj, p = _model(arch)
    B, S, max_len = 4, 20, 32
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jfi, fi = _faults(faulted)
    jlogits, jcache = jax.jit(jax_steps.make_prefill_fn(cfg_j, max_len))(
        pj, jnp.asarray(prompts), jfi)
    logits, cache = steps.prefill(p, cfg, T(prompts).long(), fi, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    depth = np.full((B,), S, np.int64)
    tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    jdecode = jax.jit(lambda *a: jax_tf.decode_step(pj, cfg_j, *a[:3],
                                                    fi=a[3]))
    for t in range(1, 5):
        depth = depth + np.asarray([1, 1, t % 2, 0])   # ragged advance
        cl = depth + 1
        jl, jcache = jdecode(jnp.asarray(tok)[:, None], jcache,
                             jnp.asarray(cl, jnp.int32),
                             None if jfi is None else jfi.for_step(t))
        pl, cache = tf.decode_step(
            p, cfg, T(tok)[:, None], cache, T(cl),
            fi=None if fi is None else fi.for_step(t))
        jl = np.asarray(jl[:, -1])
        np.testing.assert_allclose(pl[:, -1].numpy(), jl, atol=LOGIT_ATOL)
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(),
                                      jl.argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["llama3_8b", "recurrentgemma_2b",
                                  "rwkv6_3b"])
def test_all_equal_vector_equals_scalar(arch):
    """An all-equal ``(B,)`` cache_len gives the int's logits and caches
    bit for bit (faulted, so the qkt/sv streams see the same words)."""
    _, cfg, _, p = _model(arch)
    B, S, max_len = 3, 20, 32
    prompts = T(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int64))
    _, fi = _faults(True)
    _, cache = steps.prefill(p, cfg, prompts, fi, max_len)
    clone = lambda c: [{k: (v.clone() if isinstance(v, torch.Tensor)
                            else {kk: vv.clone() for kk, vv in v.items()})
                        for k, v in d.items()} for d in c]
    c_int, c_vec = cache, clone(cache)
    tok = prompts[:, -1:]
    for t in range(1, 4):
        a, c_int = tf.decode_step(p, cfg, tok, c_int, S + t,
                                  fi=fi.for_step(t))
        b, c_vec = tf.decode_step(p, cfg, tok, c_vec,
                                  torch.full((B,), S + t), fi=fi.for_step(t))
        assert torch.equal(a, b)
        for da, db in zip(c_int, c_vec):
            for k in da:
                va, vb = da[k], db[k]
                if isinstance(va, dict):
                    assert all(torch.equal(va[x], vb[x]) for x in va)
                else:
                    assert torch.equal(va, vb), k
        tok = a[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("window_past", [False, True])
def test_decode_attention_vector_matches_reference(window_past):
    """``decode_attention`` at per-row depths (some past the ring's
    length, some short) against the reference's, clean."""
    rng = np.random.default_rng(3)
    B, Smax, H, KV, hd = 4, 16, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    cl = np.asarray([3, 16, 9, 40] if window_past else [1, 5, 16, 12])
    want = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(cl))
    got = attn.decode_attention(T(q), T(k), T(v), T(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    one = attn.decode_attention(T(q), T(k), T(v), 9)
    assert torch.equal(one, attn.decode_attention(T(q), T(k), T(v),
                                                  torch.full((B,), 9)))


@pytest.mark.parametrize("lanes", [None, 2])
def test_logit_taps_active_matches_reference(lanes):
    """Masked taps over the live rows (0 with none live), per lane under
    ``lanes`` as the reference's under ``jax.vmap``."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 32)).astype(np.float32)
    for active in ([1, 0, 1, 1, 0, 0], [0] * 6, [1] * 6):
        active = np.asarray(active, bool)
        got = logit_taps(T(logits), lanes, active=T(active))
        if lanes is None:
            want = jax_logit_taps(jnp.asarray(logits),
                                  active=jnp.asarray(active))
        else:
            want = jax.vmap(lambda l, a: jax_logit_taps(l, active=a))(
                jnp.asarray(logits).reshape(lanes, -1, 32),
                jnp.asarray(active).reshape(lanes, -1))
        for name in ("logit_max", "logit_margin"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]),
                                       atol=TAP_ATOL)
    zero = logit_taps(T(logits), active=torch.zeros(6, dtype=torch.bool))
    assert float(zero["logit_max"]) == 0.0
    plain = logit_taps(T(logits), lanes)
    full = logit_taps(T(logits), lanes, active=torch.ones(6,
                                                          dtype=torch.bool))
    for name in plain:
        torch.testing.assert_close(full[name], plain[name], atol=TAP_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ["llama3_8b", "recurrentgemma_2b",
                                  "rwkv6_3b"])
def test_merge_cache_takes_refilled_rows_into_fresh_tensors(arch):
    """Every leaf kind's slot axis is axis 0: the refilled rows come from
    the new cache, the others from the old one, and no leaf aliases
    either input."""
    _, cfg, _, _ = _model(arch)
    K = 3
    old = tf.init_cache(cfg, K, 24, dtype=torch.float32, device="cpu")
    new = tf.init_cache(cfg, K, 24, dtype=torch.float32, device="cpu")
    fill = lambda c, x: [{k: (v.fill_(x) if isinstance(v, torch.Tensor)
                              else {kk: vv.fill_(x) for kk, vv in v.items()})
                          for k, v in d.items()} for d in c]
    old, new = fill(old, 1.0), fill(new, 2.0)
    mask = torch.tensor([True, False, True])
    merged = slots._merge_cache(mask, new, old)

    def leaves(c):
        for d in c:
            for v in d.values():
                yield from (v.values() if isinstance(v, dict) else [v])
    for m, n, o in zip(leaves(merged), leaves(new), leaves(old)):
        assert m.shape[0] == K and m.shape == n.shape
        assert torch.equal(m[0], n[0]) and torch.equal(m[2], n[2])
        assert torch.equal(m[1], o[1])
        assert m.data_ptr() not in (n.data_ptr(), o.data_ptr())


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_large_v3"])
def test_online_slots_refuse_vlm_and_encdec(arch):
    """The reference refuses the prefix and enc-dec families (an
    assertion); the port raises ValueError."""
    with pytest.raises(AssertionError, match="decoder-only"):
        jax_slots.make_decode_chunk_fn(jax_get_config(arch).reduced(), 4)
    with pytest.raises(ValueError, match="decoder-only"):
        slots.check_family(get_config(arch).reduced())
