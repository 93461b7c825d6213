"""The port's temperature / top-k sampling and ``ServeEngine.score`` vs the
JAX reference on the CPU: the threefry uniform, Gumbel and categorical
draws, ``sample_token``, sampled generation and scoring on reduced
llama3_8b and qwen3_moe_235b (Pallas in interpret mode in the
reference, plain versions in the port)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.serve import steps as jax_steps
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.steps import softmax_xent as jax_softmax_xent
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.data import SyntheticLM
from repro_torch.serve import steps
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.steps import softmax_xent

TINY = float(np.finfo(np.float32).tiny)
OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "router")
# score: the mean NLL sums float32 logsumexps in another order than XLA's
SCORE_RTOL = 1e-5


class Forced:
    """A runtime admitting one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in OPS}

    def total_power(self):
        return 0.0


def _ulps(a, b):
    """Distance in float32 ulps of ``max(|a|, 1)``: XLA's and torch's
    ``log`` differ by an ulp, so ``-log(-log(u))`` differs by one ulp of
    ``log(u)``'s magnitude where the outer log is near 0."""
    scale = np.spacing(np.maximum(np.abs(a), 1.0).astype(np.float32))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale


# --------------------------------------------------------------------------- #
# draws
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("minval,maxval", [(TINY, 1.0), (0.0, 1.0),
                                           (-2.5, 7.0), (1e-3, 2e-3)])
@pytest.mark.parametrize("seed", [0, 1, 77])
def test_uniform_bounds_bit_exact(seed, minval, maxval):
    shape = (3, 1000)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, minval, maxval))
    got = prandom.uniform(prandom.PRNGKey(seed), shape, minval, maxval)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert float(got.min()) >= np.float32(minval)


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_gumbel_within_two_ulps(seed):
    shape = (4, 4096)
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prandom.gumbel(prandom.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _ulps(got, want).max() <= 2.0


@pytest.mark.parametrize("seed", range(6))
def test_categorical_matches_reference(seed):
    logits = np.random.default_rng(seed).normal(size=(8, 256)).astype(
        np.float32) * 3
    want = jax.random.categorical(jax.random.PRNGKey(seed),
                                  jnp.asarray(logits))
    got = prandom.categorical(prandom.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# sample_token
# --------------------------------------------------------------------------- #
_jax_sample = jax.jit(jax_steps.sample_token, static_argnums=3)


@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 0.0])
def test_sample_token_matches_reference(temperature, top_k):
    """Over 16 keys at vocab 256, as the reference samples inside its
    compiled generation (a traced temperature)."""
    rng = np.random.default_rng(int(temperature * 10) + (top_k or 0))
    for i in range(16):
        logits = (rng.normal(size=(4, 256)) * 2).astype(np.float32)
        want = _jax_sample(jnp.asarray(logits), jax.random.PRNGKey(i),
                           jnp.float32(temperature), top_k)
        got = steps.sample_token(torch.from_numpy(logits),
                                 prandom.PRNGKey(i), temperature, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if top_k is not None:       # only the top_k logits can be drawn
            kth = np.sort(logits, axis=-1)[:, -top_k]
            assert (logits[np.arange(4), got.numpy()] >= kth).all()


def test_greedy_ignores_key_and_top_k():
    logits = torch.tensor([[0.1, 3.0, 3.0, -1.0]])
    for t, k in ((0.0, None), (0.0, 2), (-1.0, 1)):
        tok = steps.sample_token(logits, prandom.PRNGKey(4), t, k)
        assert tok.tolist() == [1]


def test_temperature_resolution():
    assert ServeEngine._temperature(True, None) == 0.0
    assert ServeEngine._temperature(False, None) == 1.0
    assert ServeEngine._temperature(True, 0.7) == pytest.approx(0.7)
    assert JaxServeEngine._temperature(False, None) == 1.0


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(2, 7, 256)) * 4).astype(np.float32)
    labels = rng.integers(0, 256, (2, 7)).astype(np.int32)
    want = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), rel=SCORE_RTOL)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["llama3_8b", "qwen3_moe_235b"])
def model(request):
    cfg_j = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    params_j = jax_tf.init_params(cfg_j, jax.random.PRNGKey(1),
                                  dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, params_j), cfg,
                                   device="cpu")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=8,
                          global_batch=2).batch_at(0).tokens
    return cfg_j, cfg, params_j, params, prompts


def _engines(model, seed, fused=True):
    cfg_j, cfg, params_j, params, _ = model
    return (JaxServeEngine(cfg_j, params_j, runtime=Forced(1e-3), max_len=32,
                           use_systolic_kernel=True, use_fused_kernel=fused,
                           seed=seed),
            ServeEngine(cfg, params, runtime=Forced(1e-3), max_len=32,
                        use_systolic_kernel=True, use_fused_kernel=fused,
                        seed=seed, device="cpu"))


def test_generate_sampled_tokens_match_reference(model):
    """T=0.8, top_k=8 at a forced BER of 1e-3 on every domain, two calls
    on one engine (the engine key advances between them)."""
    prompts = model[4]
    jeng, peng = _engines(model, seed=6)
    for _ in range(2):
        want = jeng.generate(prompts, 5, temperature=0.8, top_k=8)
        got = peng.generate(prompts, 5, temperature=0.8, top_k=8)
        np.testing.assert_array_equal(got.tokens, want.tokens)
    greedy = peng.generate(prompts, 5)
    assert not np.array_equal(greedy.tokens, got.tokens)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_score_matches_reference(model, fused):
    """Mean next-token NLL of prompts + generated tokens under the aged
    device (BER 1e-3 on every domain)."""
    prompts = model[4]
    jeng, peng = _engines(model, seed=8, fused=fused)
    tokens = np.concatenate(
        [prompts, jeng.generate(prompts, 4).tokens], axis=1)
    peng.generate(prompts, 4)               # keep the engine keys in step
    want = jeng.score(tokens)
    got = peng.score(tokens)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=SCORE_RTOL)
