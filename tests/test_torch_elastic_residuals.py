"""The error-feedback residuals of a compressed data-parallel state
through an elastic re-mesh (ROADMAP C.7): the port's ``reshard_state`` on
4 gloo ranks against the reference's ``reshard_state`` and the next
``make_dp_train_step`` on 4 forced host devices, reduced llama3_8b.

The reference takes one compressed step on a ``(4, 1)`` mesh, re-meshes to
2 and to 1 ranks and steps once more; its step splits the ``(4, ...)``
residuals over the new data axis, so new rank r continues from old rank
``r * 4 // n``.  The port starts each rank from the reference's state
after the first step (``train_state_from_reference(rank=)``).  Re-meshes
that the new size does not divide (4 -> 3, 2 -> 4, 1 -> 2) raise
``ValueError`` in both.  The reference runs in one subprocess (it needs
``XLA_FLAGS`` before jax starts), once for the module.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.tree import flatten
from test_torch_dp_train import (FLIP_PARAM_ATOL, LOSS_RTOL, PARAM_ATOL,
                                 RES_FLIP, RES_RTOL)

ROOT = Path(__file__).resolve().parents[1]
N = 4
ARCH = "llama3_8b"
BATCH = 8
SIZES = (2, 1)
# At one rank the residual is the rounding error of that rank's own int8
# step s alone (at most s / 2), while the gradient it rounds reaches
# 127 s and sums all 8 rows (2 a rank in the data-parallel tests): its
# float noise, RES_RTOL of the leaf's largest |g + r|, is then RES_RTOL
# of at least 2 * 127 times the leaf's largest residual
ONE_RANK_RES = 2 * 127

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(sys.argv[1], "src"))
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.distributed import elastic
    from repro.optim import AdamWConfig, adamw_init
    from repro.train import steps
    from repro.checkpoint.checkpoint import _flatten
    cfg = get_config("llama3_8b").reduced()
    opt = AdamWConfig(**OPT)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1),
                ("data", "model"))
    def batch(i, size=BATCH):
        b = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ,
                        global_batch=size).batch_at(i)
        return {"tokens": jnp.asarray(b.tokens),
                "labels": jnp.asarray(b.labels)}
    params = steps.init_train_state(cfg, jax.random.PRNGKey(0)).params
    state = steps.TrainState(params, adamw_init(params),
                             steps.dp_residuals_init(params, mesh))
    state, _ = steps.make_dp_train_step(cfg, opt, mesh)(state, batch(0))
    start = jax.tree.map(np.asarray, state)
    fresh = lambda: jax.tree.map(jnp.array, start)
    out = {"start/" + k: v for k, v in _flatten(start).items()}
    def remesh(n, size=BATCH, src=None):
        plan = elastic.plan_remesh(mesh, n, global_batch=size)
        new = elastic.make_mesh_from_plan(plan)
        moved = elastic.reshard_state(src or fresh(), cfg, new)
        return steps.make_dp_train_step(cfg, opt, new)(moved, batch(1, size))
    for n in SIZES:
        st, m = remesh(n)
        out.update({f"n{n}/{k}": v for k, v in _flatten(st).items()})
        out[f"n{n}/loss"] = np.asarray(float(m["loss"]))
        if n == 2:
            two = jax.tree.map(np.asarray, st)
    def refused(call):
        try:
            call()
            return "ran"
        except ValueError as e:
            return "ValueError"
    out["refused/4->3"] = np.asarray(refused(lambda: remesh(3, 12)))
    grow = elastic.make_mesh_from_plan(elastic.plan_remesh_shape(
        ("data", "model"), {"data": 2, "model": 1}, 4, global_batch=BATCH))
    out["refused/2->4"] = np.asarray(refused(
        lambda: steps.make_dp_train_step(cfg, opt, grow)(elastic.reshard_state(
            jax.tree.map(jnp.array, two), cfg, grow), batch(2))))
    np.savez(sys.argv[2], **out)
""").replace("SEQ", str(ranks.DP_SEQ)).replace(
    "BATCH", str(BATCH)).replace("OPT", repr(ranks.DP_OPT)).replace(
    "SIZES", repr(SIZES))


def _under(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("remesh") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", REFERENCE, str(ROOT), str(out)],
                   env=env, check=True, capture_output=True, text=True,
                   timeout=300)
    with np.load(out) as z:
        flat = dict(z)
    port = run_local_ranks(ranks.elastic_residuals_rank, N, ARCH,
                           _under(flat, "start/"), BATCH, backend="gloo",
                           device="cpu", timeout=300)
    return get_config(ARCH).reduced(), flat, port


def _ref_state(flat, prefix, cfg, rank):
    return train_state_from_reference(_under(flat, prefix), cfg, rank=rank,
                                      device="cpu")


@pytest.mark.parametrize("n", SIZES)
def test_carried_residuals_are_the_references_row(runs, n):
    """Right after the re-mesh, new rank r holds old rank ``r * 4 // n``'s
    residuals bit for bit (the row the reference's step gives it); ranks
    past the new mesh hold none."""
    cfg, flat, port = runs
    for r in range(N):
        if r >= n:
            assert n not in port[r]
            continue
        want = flatten(_ref_state(flat, "start/", cfg, r * N // n).residuals)
        got = port[r][n]["carried"]
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("n", SIZES)
def test_step_after_remesh_matches_reference(runs, n):
    """The compressed step on the new mesh from the carried state: the
    loss, the params and moments, and each rank's residuals against the
    reference's row r, within the data-parallel tests' tolerances (the
    residuals carried exactly, but a gradient an ulp away can round to
    the next int8 step; at one rank the residuals' tight tolerance is
    taken from the gradient's scale, ONE_RANK_RES)."""
    cfg, flat, port = runs
    big = lambda w: float(np.abs(w).max())
    for r in range(n):
        rec = port[r][n]
        want = _ref_state(flat, f"n{n}/", cfg, r)
        np.testing.assert_allclose(rec["losses"], [flat[f"n{n}/loss"]],
                                   rtol=LOSS_RTOL)
        assert rec["step"] == 2
        ranks.hold(rec["params"], flatten(want.params), PARAM_ATOL,
                   FLIP_PARAM_ATOL, ("params", n, r))
        for m in ("mu", "nu"):
            ranks.hold(rec[m], flatten(getattr(want.opt, m)),
                       lambda w: RES_RTOL * big(w),
                       lambda w: RES_FLIP * big(w), (m, n, r))
        tight = RES_RTOL * (ONE_RANK_RES if n == 1 else 1)
        ranks.hold(rec["residuals"], flatten(want.residuals),
                   lambda w: tight * big(w), lambda w: RES_FLIP * big(w),
                   ("residuals", n, r))


def test_sizes_that_do_not_divide_are_refused(runs):
    """4 -> 3 and 2 -> 4 raise ``ValueError`` in the reference's step; the
    port raises it on every rank in ``reshard_state``, and for 1 -> 2."""
    _, flat, port = runs
    assert str(flat["refused/4->3"]) == "ValueError"
    assert str(flat["refused/2->4"]) == "ValueError"
    for rec in port:
        for name, msg in rec["refused"].items():
            assert msg is not None and "do not split" in msg, name
