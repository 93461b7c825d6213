"""The reference's cost-probe knob ``FORCE_SINGLE_CHUNK`` in the port
(repro_torch.models.attention / rwkv6) against the reference's on the
CPU at S = 2048, float32 inputs from numpy: a clean attention call of
2,048 queries runs full attention instead of the chunked loop (within
1e-5 of the reference's; bit for bit the port's own full attention),
and RWKV's prefill runs the whole sequence as one chunk (output and
state within 1e-4 relative of the reference's: float32 sums of up to
2,048 decayed terms in another order; bit for bit the port's own
``chunk = S`` call)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import rwkv6 as jax_rwkv
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6

S = 2048


@pytest.fixture
def single_chunk(monkeypatch):
    for mod in (jax_attn, jax_rwkv, attn, rwkv6):
        monkeypatch.setattr(mod, "FORCE_SINGLE_CHUNK", True)


def test_attention_full_at_2048(single_chunk):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, S, h, 16)).astype(np.float32)
               for h in (2, 1, 1))
    want = jax.jit(lambda q, k, v: jax_attn.attention(q, k, v, causal=True))(
        q, k, v)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = attn.attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, attn.full_attention(tq, tk, tv, causal=True))


def test_rwkv_one_chunk_at_2048(single_chunk):
    d, hd = 16, 8
    p_j = jax_rwkv.rwkv_time_mix_init(jax.random.PRNGKey(0), d, hd,
                                      jnp.float32)
    p = {k: torch.as_tensor(np.asarray(v)) for k, v in p_j.items()}
    x = np.random.default_rng(1).normal(size=(1, S, d)).astype(np.float32)
    state_j = jax_rwkv.rwkv_init_state(1, d, hd)["tm"]
    state_j = {"shift": state_j["shift"].astype(jnp.float32),
               "wkv": state_j["wkv"]}
    want, st_j = jax.jit(lambda x, p, s: jax_rwkv.rwkv_time_mix(
        x, p, hd, state=s))(x, p_j, state_j)
    state = {"shift": torch.zeros((1, d)),
             "wkv": torch.zeros((1, d // hd, hd, hd))}
    got, st = rwkv6.rwkv_time_mix(torch.as_tensor(x), p, hd, state=state)
    for g, w in ((got, want), (st["wkv"], st_j["wkv"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    rwkv6.FORCE_SINGLE_CHUNK = False
    try:
        ref, _ = rwkv6.rwkv_time_mix(torch.as_tensor(x), p, hd, state=state,
                                     chunk=S)
    finally:
        rwkv6.FORCE_SINGLE_CHUNK = True
    assert torch.equal(got, ref)
