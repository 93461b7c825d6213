"""The port's training slice (repro_torch.optim, repro_torch.train.steps,
the remat forward, the rest of repro_torch.data) vs the JAX reference on
the CPU: reduced llama3_8b and qwen3_moe_235b from the reference's
``init_train_state`` (float32), carried across by repro_torch.convert;
gradients from torch.autograd against ``jax.value_and_grad``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim import global_norm as jax_global_norm
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.benchmarks import fig1b_ber
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.optim.adamw import ref_order_groups
from repro_torch.train import steps
from repro_torch.tree import flatten
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("llama3_8b", "qwen3_moe_235b")
# the train-step tests also run the hybrid, at two full periods of its
# block pattern and a two-layer tail, so that the clip norm sums the
# stacked groups and the tail in the reference's order
STEP_ARCHS = ARCHS + ("recurrentgemma_2b",)
HYBRID_LAYERS = 8
# the hybrid's gradients carry the RG-LRU scan's float order (the embed
# gradient within 2.5e-6 of its largest element, where a dense model's is
# within a few ulps), and AdamW's normalised steps carry that into the
# params: its clip norm within HYBRID_NORM_RTOL over five steps (measured
# 1.76e-5 at the fifth)
HYBRID_NORM_RTOL = 5e-5
# float32 sums in another order than XLA's (and its fused multiply-adds):
# the loss and the clip norm within a few ulps, each gradient leaf within
# GRAD_RTOL of its largest element
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
# after 5 AdamW steps at lr 3e-3 an element whose gradient is at the level
# of that noise moves by a share of lr: params within PARAM_ATOL
PARAM_ATOL = 2e-4
OPT_KW = dict(lr=3e-3, total_steps=10, warmup_steps=2)


def _leaves(tree):
    """Every leaf, by sorted path (the same order for any two trees of
    one structure)."""
    return [x for _, x in sorted(flatten(tree).items())]


def _configs(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if len(cfg.block_pattern) > 1:
        jcfg, cfg = (dataclasses.replace(c, n_layers=HYBRID_LAYERS)
                     for c in (jcfg, cfg))
    return jcfg, cfg


def _reference(arch, seed=0):
    jcfg, cfg = _configs(arch)
    jst = jax_steps.init_train_state(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, jst.params), cfg,
                                   device="cpu")
    return jcfg, cfg, jst, params


def _port_tree(jtree, cfg):
    return params_from_reference(jax.tree.map(np.asarray, jtree), cfg,
                                 device="cpu")


def _assert_leaves(got, want, rtol=None, atol=None):
    for a, b in zip(_leaves(got), _leaves(want)):
        a, b = a.detach().numpy(), b.numpy()
        tol = atol if atol is not None else rtol * np.max(np.abs(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _batch(cfg, step, B=4, S=16):
    tb = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B).batch_at(step)
    return {"tokens": tb.tokens, "labels": tb.labels}


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_local_batches_match_reference(n_shards):
    d = SyntheticLM(vocab=100, seq_len=16, global_batch=8, seed=1)
    jd = JaxSyntheticLM(vocab=100, seq_len=16, global_batch=8, seed=1)
    parts = [d.local_batch_at(5, s, n_shards) for s in range(n_shards)]
    for s, p in enumerate(parts):
        np.testing.assert_array_equal(p.tokens,
                                      jd.local_batch_at(5, s, n_shards).tokens)
    np.testing.assert_array_equal(
        np.concatenate([p.tokens for p in parts]), d.batch_at(5).tokens)
    assert d.uniform_nll() == jd.uniform_nll()
    assert d.oracle_nll() == jd.oracle_nll() < d.uniform_nll()
    with pytest.raises(ValueError):
        d.local_batch_at(0, 0, 3)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def test_cosine_schedule_matches_reference():
    """Warmup, cosine and the floor: every step's lr within an ulp."""
    kw = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    s = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda x: jax_cosine_schedule(jcfg, x))(s))
    got = np.array([float(cosine_schedule(cfg, torch.tensor(int(i),
                                                             dtype=torch.int32)))
                    for i in s], np.float32)
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    assert got[0] == 0.0 and got[-1] == pytest.approx(2e-4, rel=1e-3)


def test_global_norm_matches_reference():
    """The clip norm over a reduced llama3_8b gradient tree, summed in the
    reference's leaf order, within LOSS_RTOL."""
    jcfg, cfg, jst, params = _reference("llama3_8b")
    rng = np.random.default_rng(0)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), jnp.float32), jst.params)
    want = float(jax_global_norm(jg))
    got = float(global_norm(_port_tree(jg, cfg)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert float(global_norm({"a": torch.tensor([3.0]),
                              "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("arch", STEP_ARCHS + (
    "rwkv6_3b", "paligemma_3b", "whisper_large_v3"))
def test_ref_order_groups_follow_reference_leaves(arch):
    """``ref_order_groups`` yields one group per leaf of the reference's
    param tree, in ``jax.tree.leaves`` order: each group stacked equals
    that leaf (the hybrid's ``groups`` by pattern position, then its
    tail; the enc-dec's stacked encoder and decoder)."""
    jcfg, cfg = _configs(arch)
    if cfg.n_encoder_layers:
        from repro.models import encdec as jax_encdec
        jparams = jax_encdec.init_params(jcfg, jax.random.PRNGKey(0),
                                         dtype=jnp.float32)
    else:
        jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
    params = _port_tree(jparams, cfg)
    want = jax.tree.leaves(jparams)
    got = list(ref_order_groups(params, len(cfg.block_pattern)))
    assert len(got) == len(want)
    for group, leaf in zip(got, want):
        stacked = (group[0] if leaf.ndim == group[0].ndim
                   and len(group) == 1 else torch.stack(group))
        np.testing.assert_array_equal(stacked.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three updates from seeded params and gradients (one clipped, one
    not): params, moments, step, grad_norm and lr.  bfloat16 params keep
    float32 moments and round the float32 update back."""
    rng = np.random.default_rng(1)
    shapes = {"w": (8, 16), "b": (16,), "n": {"s": (4,)}}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=2.0,
               weight_decay=0.1)
    mk = lambda: jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    p0 = mk()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    pp = jax.tree.map(lambda x: torch.tensor(x).to(tdt), p0)
    jopt, popt = jax_adamw_init(jp), adamw_init(pp)
    for scale in (5.0, 0.01, 1.0):
        g = jax.tree.map(lambda x: x * scale, mk())
        jp, jopt, jm = jax_adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x, jdt), g), jopt, jp,
            JaxAdamWConfig(**cfg))
        pp, popt, m = adamw_update(
            jax.tree.map(lambda x: torch.tensor(x).to(tdt), g), popt, pp,
            AdamWConfig(**cfg))
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=LOSS_RTOL)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(popt.step) == int(jopt.step) == 3
    atol = 1e-6 if dtype == "float32" else 0.0
    for got, want in ((pp, jp), (popt.mu, jopt.mu), (popt.nu, jopt.nu)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == (tdt if got is pp else torch.float32)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-5, atol=atol)


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """make_loss_fn's loss, xent and aux (the MoE load balance, through the
    router's softmax), and every gradient leaf, against
    jax.value_and_grad."""
    jcfg, cfg, jst, params = _reference(arch)
    b = _batch(cfg, 0)
    (jl, jm), jg = jax.value_and_grad(jax_steps.make_loss_fn(jcfg),
                                      has_aux=True)(
        jst.params, jax.tree.map(jnp.asarray, b))
    for p in _leaves(params):
        p.requires_grad_(True)
    loss, m = steps.make_loss_fn(cfg)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    loss.backward()
    for k in ("loss", "xent", "aux"):
        assert float(m[k].detach()) == pytest.approx(
            float(jm[k]), rel=LOSS_RTOL, abs=1e-7), k
    if cfg.moe:
        assert float(m["aux"]) > 0
        router = params["layers"][0]["ffn"]["w_router"]
        assert router.grad is not None and router.grad.abs().max() > 0
    _assert_leaves(steps.grads_of(params), _port_tree(jg, cfg),
                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical(arch):
    """Per-block recomputation changes no value: the loss and every
    gradient leaf with and without remat are equal bit for bit."""
    _, cfg, _, params = _reference(arch)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 1).items()}
    out = []
    for remat in (False, True):
        for p in _leaves(params):
            p.grad = None
            p.requires_grad_(True)
        loss, _ = steps.make_loss_fn(cfg, remat=remat)(params, b)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in _leaves(params)]))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)


# --------------------------------------------------------------------------- #
# train steps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch, microbatches, remat):
    """Five steps of make_train_step from the reference's state: loss,
    grad_norm and lr each step, then every param."""
    jcfg, cfg, jst, params = _reference(arch)
    st = steps.TrainState(params, adamw_init(params))
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, JaxAdamWConfig(**OPT_KW), microbatches=microbatches,
        remat=remat))
    pstep = steps.make_train_step(cfg, AdamWConfig(**OPT_KW),
                                  microbatches=microbatches, remat=remat)
    for s in range(5):
        b = _batch(cfg, s)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        st, m = pstep(st, b)
        for k in ("loss", "xent", "grad_norm"):
            rel = (HYBRID_NORM_RTOL if k == "grad_norm"
                   and arch == "recurrentgemma_2b" else 5 * LOSS_RTOL)
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=rel), (
                s, k)
        # the jitted schedule fuses a multiply-add: lr within 2 ulps
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=2.4e-7)
    assert int(st.opt.step) == 5
    assert all(not p.requires_grad and p.grad is None
               for p in _leaves(st.params))
    _assert_leaves(st.params, _port_tree(jst.params, cfg), atol=PARAM_ATOL)


# bfloat16 params: the two backends round every bf16 matmul and norm
# differently, so the loss moves by a few 1e-3 and the clip norm by a few
# 1e-2 over five steps, and an element whose gradient is at that noise
# level can move either way each step: params within the five steps' lr
# sum plus one bf16 ulp at 1
BF16_LOSS_RTOL = 5e-3
BF16_NORM_RTOL = 5e-2
BF16_PARAM_ATOL = 0.0122 + 2.0 ** -7


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_bf16_train_steps_match_reference(arch):
    """Five steps with bfloat16 params and two microbatches from the
    reference's bf16 state: loss, grad_norm and lr each step, then every
    param, within the bf16 tolerances above."""
    jcfg, cfg = _configs(arch)
    jst = jax_steps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     dtype=jnp.bfloat16)
    params = jax.tree.map(lambda t: t.to(torch.bfloat16), _port_tree(
        jax.tree.map(lambda x: x.astype(jnp.float32), jst.params), cfg))
    st = steps.TrainState(params, adamw_init(params))
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, JaxAdamWConfig(**OPT_KW), microbatches=2))
    pstep = steps.make_train_step(cfg, AdamWConfig(**OPT_KW), microbatches=2)
    for s in range(5):
        b = _batch(cfg, s)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        st, m = pstep(st, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=BF16_LOSS_RTOL), s
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=BF16_NORM_RTOL), s
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=2.4e-7)
    assert all(p.dtype == torch.bfloat16 for p in _leaves(st.params))
    want = _port_tree(jax.tree.map(lambda x: x.astype(jnp.float32),
                                   jst.params), cfg)
    for a, b in zip(_leaves(st.params), _leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=0,
                                   atol=BF16_PARAM_ATOL)


def test_bf16_microbatch_grads_sum_in_float32(monkeypatch):
    """With bfloat16 params and two microbatches the step hands AdamW the
    float32 mean of the microbatches' bf16 gradients, added in float32 as
    the reference's scan adds them onto float32 zeros: equal bit for bit
    to ``(float32(g1) + float32(g2)) / 2`` of the port's own gradients."""
    cfg = get_config("llama3_8b").reduced()
    params = jax.tree.map(lambda t: t.to(torch.bfloat16),
                          _reference("llama3_8b")[3])
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    loss_fn = steps.make_loss_fn(cfg)
    want = []
    for i in range(2):
        for p in _leaves(params):
            p.grad = None
            p.requires_grad_(True)
        loss, _ = loss_fn(params, {k: v[2 * i:2 * i + 2]
                                   for k, v in b.items()})
        loss.backward()
        want.append([p.grad.float() for p in _leaves(params)])
    for p in _leaves(params):
        p.grad = None
        p.requires_grad_(False)
    seen, update = [], steps.adamw_update

    def recording_update(grads, *args, **kw):
        seen.append(grads)
        return update(grads, *args, **kw)

    monkeypatch.setattr(steps, "adamw_update", recording_update)
    steps.make_train_step(cfg, AdamWConfig(**OPT_KW), microbatches=2)(
        steps.TrainState(params, adamw_init(params)), b)
    got = _leaves(seen[0])
    assert len(got) == len(want[0])
    for g, g1, g2 in zip(got, *want):
        assert g.dtype == torch.float32
        assert torch.equal(g, (g1 + g2) / 2)


def test_refusals():
    """The data-parallel entry points (ported: tests/test_torch_dp_train.py)
    start from zero float32 residuals and refuse a mesh without a process
    group; unported config fields raise instead of running something
    else."""
    cfg = get_config("llama3_8b").reduced()
    st = steps.init_train_state(cfg, 0, device="cpu", compressed=True,
                                dtype=torch.bfloat16)
    mesh = LogicalMesh(("data", "model"), (1, 1), torch.device("cpu"))
    for res in (st.residuals, steps.dp_residuals_init(st.params, mesh)):
        got, want = flatten(res), flatten(st.params)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.dtype == torch.float32 and v.shape == want[k].shape
            assert not v.any()
    with pytest.raises(ValueError, match="process group"):
        steps.make_dp_train_step(cfg, AdamWConfig(), None)
    with pytest.raises(ValueError, match="process group"):
        steps.make_dp_train_step(cfg, AdamWConfig(), mesh)
    # a sliding window (refused before the hybrid family was ported): the
    # loss equals the reference's
    windowed, jwindowed = (dataclasses.replace(c, window=4) for c in
                           (cfg, jax_get_config("llama3_8b").reduced()))
    jparams = jax_tf.init_params(jwindowed, jax.random.PRNGKey(1),
                                 dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   windowed, device="cpu")
    b = _batch(cfg, 0)
    want, _ = jax_steps.make_loss_fn(jwindowed)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    got, _ = steps.make_loss_fn(windowed)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    unwindowed, _ = steps.make_loss_fn(cfg)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert float(got) != float(unwindowed)
    st = steps.init_train_state(cfg, 0, device="cpu")
    assert st.residuals is None and int(st.opt.step) == 0
    assert all(m.dtype == torch.float32 for m in _leaves(st.opt.mu))


def test_fig1b_ber_checks_pass_on_the_cpu():
    """The ported Fig. 1(b) benchmark: trains, then every check passes."""
    res = fig1b_ber.evaluate(device="cpu")
    assert all(c["ok"] for c in res["checks"]), res["text"]
    assert len(res["rows"]["nll"]) == len(fig1b_ber.BERS)

