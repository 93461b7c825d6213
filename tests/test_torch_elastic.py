"""The elastic re-mesh of a data-parallel job (``repro_torch.distributed.
elastic``): plans against the reference's ``plan_remesh``, from logical
meshes here and from a live 4-rank gloo mesh; the new group over the first
ranks; a train state resharded bit for bit; and the refusals of a model
axis over ranks (its re-mesh, ROADMAP A.8c(b)).  The ranks are spawned
once for the module."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.distributed.elastic import plan_remesh as jax_plan_remesh
from repro.train import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.distributed import elastic
from repro_torch.launch.mesh import LogicalMesh, run_local_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps
from repro_torch.tree import flatten

ARCH = "llama3_8b"
GLOBAL_BATCH = 8


class FakeMesh:
    """The reference tests' duck-typed mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _same_plan(port, ref):
    assert (port.old_shape, port.new_shape, port.axis_names,
            port.microbatches) == (tuple(ref.old_shape),
                                   tuple(ref.new_shape),
                                   tuple(ref.axis_names), ref.microbatches)


CASES = [
    ({"data": 4, "model": 1}, 2, 8, 1),
    ({"data": 4, "model": 1}, 3, 8, 1),
    ({"data": 4, "model": 2}, 4, 8, 1),
    ({"data": 4, "model": 2}, 6, 8, 2),
    ({"data": 2, "model": 1}, 8, 16, 1),
    ({"pod": 2, "data": 4, "model": 2}, 32, 64, 1),
    ({"pod": 2, "data": 4, "model": 2}, 4, 64, 1),
    ({"pod": 2, "data": 2, "model": 1}, 2, 8, 1),
    ({"pod": 2, "data": 2, "model": 1}, 3, 9, 2),
]


@pytest.mark.parametrize("shape,n,batch,micro", CASES)
def test_plan_from_logical_mesh_matches_reference(shape, n, batch, micro):
    mesh = LogicalMesh(tuple(shape), tuple(shape.values()),
                       torch.device("cpu"))
    _same_plan(elastic.plan_remesh(mesh, n, global_batch=batch,
                                   old_microbatches=micro),
               jax_plan_remesh(FakeMesh(shape), n, global_batch=batch,
                               old_microbatches=micro))


def test_plan_refuses_a_count_the_model_axis_does_not_divide():
    mesh = LogicalMesh(("data", "model"), (4, 2), torch.device("cpu"))
    with pytest.raises(ValueError):
        elastic.plan_remesh(mesh, 5, global_batch=8)
    with pytest.raises(ValueError):
        jax_plan_remesh(FakeMesh({"data": 4, "model": 2}), 5, global_batch=8)


def test_model_axis_over_ranks_is_refused_in_process():
    """A plan, a mesh or a step with a model axis above 1 over ranks is
    tensor-parallel placement: each raises before any collective."""
    cfg = get_config(ARCH).reduced()
    plan = elastic.RemeshPlan((4, 1), (2, 2), ("data", "model"), 1)
    with pytest.raises(NotImplementedError, match="A.8c"):
        elastic.make_mesh_from_plan(plan, device="cpu")
    tp = LogicalMesh(("data", "model"), (1, 4), torch.device("cpu"))
    state = steps.init_train_state(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="A.8c"):
        elastic.reshard_state(state, cfg, tp)
    grouped = dataclasses.replace(tp, group=object())
    with pytest.raises(NotImplementedError, match="A.8c"):
        steps.make_dp_train_step(cfg, AdamWConfig(), grouped)
    with pytest.raises(NotImplementedError, match="A.8c"):
        steps.dp_residuals_init(state.params, tp)
    with pytest.raises(ValueError, match="process group"):
        steps.make_dp_train_step(cfg, AdamWConfig(), dataclasses.replace(
            tp, sizes=(1, 1)))


@pytest.fixture(scope="module")
def runs():
    cfg = get_config(ARCH).reduced()
    jst = jax_steps.init_train_state(jax_get_config(ARCH).reduced(),
                                     jax.random.PRNGKey(3))
    params = {k: v.numpy() for k, v in flatten(params_from_reference(
        jax.tree.map(np.asarray, jst.params), cfg, device="cpu")).items()}
    return params, run_local_ranks(ranks.elastic_rank, 4, ARCH, params,
                                   GLOBAL_BATCH, backend="gloo",
                                   device="cpu", timeout=240)


def test_live_mesh_and_its_plans(runs):
    """Under the started group the local mesh is ``(world, 1)``, and
    ``(2, 2)`` with a model axis of 2 (rank r shard r % 2 of replica r //
    2); the plans from the live ``(4, 1)`` mesh and from a live ``(2, 2,
    1)`` pod mesh equal the reference's from the same named shapes."""
    _, out = runs
    for r, rec in enumerate(out):
        assert rec["shape"] == rec["local"] == {"data": 4, "model": 1}
        assert rec["local_tp2"] == ({"data": 2, "model": 2}, r % 2, r // 2)
        _same_plan(rec["plan"], jax_plan_remesh(
            FakeMesh({"data": 4, "model": 1}), 2, global_batch=GLOBAL_BATCH))
        assert rec["pod"] == ({"pod": 2, "data": 2, "model": 1}, 4)
        _same_plan(rec["pod_plan"], jax_plan_remesh(
            FakeMesh({"pod": 2, "data": 2, "model": 1}), 2,
            global_batch=GLOBAL_BATCH))


def test_make_mesh_from_plan_4_to_2(runs):
    _, out = runs
    assert [rec["new"] for rec in out] == [
        ({"data": 2, "model": 1}, 2, 0), ({"data": 2, "model": 1}, 2, 1),
        None, None]


def test_reshard_state_bit_equal(runs):
    """Rank 0's params, moments and step on both ranks of the new mesh,
    bit for bit (each rank started from its own); new rank r's residuals
    are old rank 2r's (ROADMAP C.7: old rank i held i + 1); and back up to
    4 ranks, the residuals of 2 refused, every rank holds rank 0's
    params."""
    params, out = runs
    for r, rec in enumerate(out[:2]):
        moved = rec["moved"]
        assert sorted(moved["params"]) == sorted(params)
        for k, v in moved["params"].items():
            np.testing.assert_array_equal(v, params[k], err_msg=k)
            np.testing.assert_array_equal(moved["mu"][k], 0.0)
            np.testing.assert_array_equal(moved["residuals"][k],
                                          np.float32(2 * r + 1))
        assert moved["step"] == 3
    for rec in out:
        _same_plan(rec["back_plan"], jax_plan_remesh(
            FakeMesh({"data": 2, "model": 1}), 4, global_batch=GLOBAL_BATCH))
        assert "do not split over 4" in rec["back_refused"]
        for k, v in rec["back"].items():
            np.testing.assert_array_equal(v, params[k], err_msg=k)


def test_model_axis_over_live_ranks_raises(runs):
    _, out = runs
    for rec in out:
        for name, msg in rec["refusals"].items():
            assert msg is not None and "A.8c" in msg, name


def test_group_start_refusals(tmp_path):
    """The backend is the caller's choice, and a choice that cannot run
    raises before a group starts (nothing falls back to gloo)."""
    from repro_torch.launch.mesh import init_data_group
    with pytest.raises(ValueError, match="NCCL"):
        init_data_group(str(tmp_path / "s"), 0, 1, backend="nccl",
                        device="cpu")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        init_data_group(str(tmp_path / "s"), 0, 1, backend="mpi",
                        device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 gave up"):
        run_local_ranks(ranks.failing_rank, 2, "rank 1 gave up",
                        backend="gloo", device="cpu", timeout=120)
