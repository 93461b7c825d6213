"""Shared set-up of the int8 serving tests (``test_torch_int8_*.py``):
reduced configs of both packages, the reference's params and its int8
tree (``quantize_params``) carried across by repro_torch.convert, and a
runtime that admits one BER on every domain.

The int8 trees serve in bf16 in both packages (each layer dequantises to
bf16, the embedding rows too).  The reference runs as its users compile
it, with XLA's default "excess precision": inside a fusion it may keep a
bf16 intermediate unrounded (an activation's steps, a residual sum read
by the next norm), where the port's ops round each result to bf16.  So
logits are held within :data:`LOGIT_ATOL` and greedy tokens by
:func:`assert_same_greedy`: equal at every step whose choice the logit
tolerance decides.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference

OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "r", "g",
       "router")
# bf16 logits: a few bf16 ulps of logits of magnitude ~1-8
LOGIT_ATOL = 0.1
# two streams with logits within LOGIT_ATOL of each other can pick
# different tokens only where the runner-up is within twice it of the best
TIE_MARGIN = 2 * LOGIT_ATOL
DECODER_ARCHS = ("llama3_8b", "qwen3_moe_235b", "arctic_480b",
                 "recurrentgemma_2b", "rwkv6_3b", "paligemma_3b")


class Forced:
    """A runtime admitting one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in OPS}

    def total_power(self):
        return 0.0


def configs(arch, **kw):
    """The two packages' reduced configs of ``arch``, with ``kw``
    replaced in both (``n_layers=4`` gives recurrentgemma a tail)."""
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    return cfg_j, cfg


def reference_params(cfg_j, seed=0, dtype=jnp.bfloat16):
    init = jax_encdec.init_params if cfg_j.n_encoder_layers \
        else jax_tf.init_params
    return init(cfg_j, jax.random.PRNGKey(seed), dtype=dtype)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def int8_pair(arch, seed=0, **kw):
    """``(cfg_j, cfg, reference int8 tree, port int8 tree)``: the port's
    is the reference's carried across."""
    cfg_j, cfg = configs(arch, **kw)
    q_j = jax_tf.quantize_params(reference_params(cfg_j, seed))
    return cfg_j, cfg, q_j, params_from_reference(
        to_numpy(q_j), cfg, dtype=torch.bfloat16, device="cpu")


def prompts(cfg, B=2, S=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def prefix(cfg, B=2, seed=1):
    """A VLM's prefix embeddings (numpy float32), else None."""
    if not cfg.prefix_tokens:
        return None
    return np.random.default_rng(seed).normal(
        size=(B, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)


def _extras(cfg):
    pe = prefix(cfg)
    return {} if pe is None else {"prefix_embeds": pe}


@contextlib.contextmanager
def sampled_logits():
    """The logits every port sampler call of the block draws from
    (``repro_torch.serve.steps.sample_token``, which ``generate``, the
    fleet and the online engines call), float32 on the CPU, in call
    order."""
    from repro_torch.serve import steps
    seen, orig = [], steps.sample_token

    def record(logits, *args, **kw):
        seen.append(logits.detach().to(torch.float32).cpu())
        return orig(logits, *args, **kw)

    steps.sample_token = record
    try:
        yield seen
    finally:
        steps.sample_token = orig


def assert_same_greedy(got, want, logits):
    """Greedy token streams of the port (``got``) and the reference
    (``want``) from the same prompts, ``(..., T)`` each, and the ``T``
    port logits ``(rows, V)`` they were drawn from (rows in the streams'
    flattened order).  Each row's streams are equal until the step where
    they first part, if they do; the history up to there is the same in
    both, so there the reference's token must be within
    :data:`TIE_MARGIN` of the port's best logit (a choice the logit
    tolerance leaves open).  After it the histories differ and the row is
    not compared.  Returns the number of rows that parted."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    T = got.shape[-1]
    got, want = got.reshape(-1, T), want.reshape(-1, T)
    assert len(logits) == T
    parted = 0
    for r in range(got.shape[0]):
        apart = np.nonzero(got[r] != want[r])[0]
        if not len(apart):
            continue
        t = apart[0]
        row = logits[t][r]
        gap = float(row[got[r, t]] - row[want[r, t]])
        assert 0 <= gap <= TIE_MARGIN, (r, t, gap)
        parted += 1
    return parted


@torch.no_grad()
def check_clean_logits(model):
    """A clean prefill's logits of both packages' int8 trees, within
    :data:`LOGIT_ATOL`."""
    from repro_torch.models import transformer as tf
    cfg_j, cfg, q_j, q = model
    p, extras = prompts(cfg), _extras(cfg)
    want = jax_tf.forward_logits(
        q_j, cfg_j, jnp.asarray(p),
        **{k: jnp.asarray(v) for k, v in extras.items()})[0]
    got = tf.forward_logits(q, cfg, torch.as_tensor(p), **{
        k: torch.as_tensor(v) for k, v in extras.items()})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def check_generate_at_9y(model, fused, n_steps=5):
    """``ServeEngine.generate`` of both packages' int8 trees on a 9-year
    device (the kernel route, fused or three-pass): the same greedy
    tokens (:func:`assert_same_greedy`)."""
    from repro.core.fleet import FleetRuntime as JaxFleetRuntime
    from repro.serve.engine import ServeEngine as JaxServeEngine
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.serve.engine import ServeEngine
    cfg_j, cfg, q_j, q = model
    jf, pf = JaxFleetRuntime(n_devices=1), FleetRuntime(n_devices=1,
                                                         device="cpu")
    jf.set_age(years=9.0)
    pf.set_age(years=9.0)
    kw = dict(max_len=32, use_systolic_kernel=True, use_fused_kernel=fused,
              seed=3)
    want = JaxServeEngine(cfg_j, q_j, runtime=jf, **kw).generate(
        prompts(cfg), n_steps, **_extras(cfg))
    with sampled_logits() as logits:
        got = ServeEngine(cfg, q, runtime=pf, device="cpu", **kw).generate(
            prompts(cfg), n_steps, **_extras(cfg))
    assert_same_greedy(got.tokens, want.tokens, logits)
