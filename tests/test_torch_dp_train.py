"""The port's data-parallel step (``repro_torch.train.steps.
make_dp_train_step``) on 4 gloo ranks against the reference's
``make_dp_train_step`` on 4 forced host devices (``shard_map`` over a
``("data",)`` mesh), on reduced llama3_8b from the same params: a global
batch of 8 rows, with the int8 error-feedback mean and with the plain
mean.

Two comparisons: one step from each of the reference's states (before
steps 0, 1 and 2, carried into each rank by ``train_state_from_reference
(rank=)``), held tightly; and 3 free steps from the same params.  The
reference runs in one subprocess (it needs ``XLA_FLAGS`` before jax
starts), once for the module.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.train import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, \
    train_state_from_reference
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
N = 4
ARCH = "llama3_8b"
STEPS = ranks.DP_STEPS
# a loss: a float32 mean over the rank's rows, averaged over the ranks in
# another order than XLA's
LOSS_RTOL = 1e-5
# one step from the same state, plain mean: gradients a few ulps from the
# reference's (tests/test_torch_train.py) summed over ranks in another
# order; params, moments within PARAM_ATOL (and so after 3 free steps)
PARAM_ATOL = 2e-4
# the compressed mean is the reference's arithmetic bit for bit
# (tests/test_torch_collectives.py), but a gradient an ulp away can round
# to the next int8 step: that element's residual then moves by one step
# (smean) and its mean by smean / n, and AdamW's normalised update of it
# by up to lr.  One step from the same state: at most FLIP_SHARE of each
# mode's elements past the tight tolerances, the params none past lr
# (the largest step lr, 3e-3), the residuals none past RES_FLIP x the
# leaf's largest residual (one step is at most twice the largest
# rounding error of a leaf).  The tight tolerance of a residual is
# RES_RTOL of the leaf's largest: the gradients' float32 sums run in
# another order (the embed's scatter-add moves its residuals by up to
# 8e-5 of their largest)
FLIP_SHARE = ranks.FLIP_SHARE
FLIP_PARAM_ATOL = 3e-3
RES_RTOL = 1e-4
RES_FLIP = 2.5
# 3 free steps: the flips of step 1 move params by up to lr and so every
# gradient of step 2 a little (each flip feeds the next): the losses
# within FREE_LOSS_RTOL, the params within 3 steps of lr
FREE_LOSS_RTOL = 1e-3
FREE_PARAM_ATOL = 3 * 3e-3

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(sys.argv[1], "src"))
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.optim import AdamWConfig, adamw_init
    from repro.train import steps
    from repro.checkpoint.checkpoint import _flatten
    cfg = get_config("llama3_8b").reduced()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    init = steps.init_train_state(cfg, jax.random.PRNGKey(0)).params
    out = {}
    for compress in (True, False):
        params = jax.tree.map(jnp.array, init)
        res = steps.dp_residuals_init(params, mesh) if compress else None
        state = steps.TrainState(params, adamw_init(params), res)
        step = steps.make_dp_train_step(cfg, AdamWConfig(**OPT), mesh,
                                        compress=compress)
        tag = "c" if compress else "p"
        losses = []
        for i in range(STEPS + 1):
            for k, v in _flatten(state).items():
                out[f"{tag}/s{i}/{k}"] = v
            if i == STEPS:
                break
            b = data.batch_at(i)
            state, m = step(state, {"tokens": jnp.asarray(b.tokens),
                                    "labels": jnp.asarray(b.labels)})
            losses.append(float(m["loss"]))
        out[tag + "/losses"] = np.asarray(losses)
    np.savez(sys.argv[2], **out)
""").replace("SEQ", str(ranks.DP_SEQ)).replace(
    "BATCH", str(ranks.DP_BATCH)).replace(
    "STEPS", str(STEPS)).replace("OPT", repr(ranks.DP_OPT))


def _tag(compress):
    return "c" if compress else "p"


def _ref_flat(flat, compress, i):
    """The reference's flat state before step ``i``."""
    pre = f"{_tag(compress)}/s{i}/"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ROOT),
                            str(out)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    cfg = get_config(ARCH).reduced()
    jst = jax_steps.init_train_state(jax_get_config(ARCH).reduced(),
                                     jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jst.params),
                                   cfg, device="cpu")
    free = run_local_ranks(ranks.dp_rank, N, ARCH, {
        k: v.numpy() for k, v in flatten(params).items()}, (True, False),
        backend="gloo", device="cpu", timeout=300)
    log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log[-3000:]
    with np.load(out) as z:
        flat = dict(z)
    forced = run_local_ranks(ranks.dp_rank_from, N, ARCH, {
        c: [_ref_flat(flat, c, i) for i in range(STEPS)]
        for c in (True, False)}, backend="gloo", device="cpu", timeout=300)
    return cfg, free, forced, flat


def _ref_state(flat, compress, i, cfg, rank=0):
    """The reference's state before step ``i`` (``STEPS``: the final one)
    as rank ``rank``'s port state."""
    return train_state_from_reference(_ref_flat(flat, compress, i), cfg,
                                      rank=rank, device="cpu")


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("compress", [True, False])
def test_one_step_from_reference_state(runs, compress, step):
    """One step from the reference's state before ``step``, on every rank:
    the loss, the params and moments, each rank's residuals against the
    reference's slice ``[rank]`` of its ``(n, ...)`` residuals."""
    cfg, _, forced, flat = runs
    want = _ref_state(flat, compress, step + 1, cfg)
    loss = flat[_tag(compress) + "/losses"][step]
    flip = FLIP_PARAM_ATOL if compress else PARAM_ATOL
    for r in range(N):
        rec = forced[r][compress][step]
        np.testing.assert_allclose(rec["losses"], [loss], rtol=LOSS_RTOL)
        assert rec["step"] == step + 1
        ranks.hold(rec["params"], flatten(want.params), PARAM_ATOL, flip,
              ("params", r))
        if compress:
            res = flatten(_ref_state(flat, True, step + 1, cfg,
                                     rank=r).residuals)
            big = lambda w: float(np.abs(w).max())
            ranks.hold(rec["residuals"], res, lambda w: RES_RTOL * big(w),
                  lambda w: RES_FLIP * big(w), ("residuals", r))
        else:
            assert rec["residuals"] is None


@pytest.mark.parametrize("compress", [True, False])
def test_free_run_matches_reference(runs, compress):
    """3 steps from the same params on every rank."""
    cfg, free, _, flat = runs
    want = flat[_tag(compress) + "/losses"]
    params = flatten(_ref_state(flat, compress, STEPS, cfg).params)
    atol = FREE_PARAM_ATOL if compress else PARAM_ATOL
    for r in range(N):
        rec = free[r][compress]
        assert rec["step"] == STEPS
        np.testing.assert_allclose(rec["losses"][0], want[0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            rec["losses"], want,
            rtol=FREE_LOSS_RTOL if compress else LOSS_RTOL)
        for k, v in rec["params"].items():
            np.testing.assert_allclose(v, params[k].numpy(), rtol=0,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("compress", [True, False])
def test_params_replicated_on_every_rank(runs, compress):
    """AdamW makes the same update on every rank: bit-equal params."""
    _, free, forced, _ = runs
    for recs in ([f[compress] for f in free],
                 [f[compress][-1] for f in forced]):
        for rec in recs[1:]:
            for k, v in rec["params"].items():
                np.testing.assert_array_equal(v, recs[0]["params"][k],
                                              err_msg=k)


def test_train_state_from_reference_takes_a_rank():
    """A reference ``TrainState`` (NamedTuples of arrays) with ``(n, ...)``
    residuals: rank r's port state holds slice r; without a rank the
    residuals are refused."""
    cfg = get_config(ARCH).reduced()
    jst = jax_steps.init_train_state(jax_get_config(ARCH).reduced(),
                                     jax.random.PRNGKey(1))
    stacked = jax.tree.map(
        lambda p: np.stack([np.full(p.shape, i, np.float32)
                            for i in range(N)]), jst.params)
    ref = jax.tree.map(np.asarray, jst._replace(residuals=stacked))
    params = params_from_reference(ref.params, cfg, device="cpu")
    for r in range(N):
        st = train_state_from_reference(ref, cfg, rank=r, device="cpu")
        assert int(st.opt.step) == 0
        for k, v in flatten(st.params).items():
            assert v.equal(flatten(params)[k])
        res = flatten(st.residuals)
        assert sorted(res) == sorted(flatten(params))
        assert all(v.dtype == torch.float32 and bool((v == r).all())
                   for v in res.values())
    with pytest.raises(ValueError, match="rank="):
        train_state_from_reference(ref, cfg, device="cpu")
