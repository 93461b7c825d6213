"""Tensor-parallel training over ranks (``repro_torch.train.steps.
make_train_step(mesh=)``, the reference's ``"train"`` layout over the
ranks of a gloo group on the CPU) against the reference's jitted
single-device ``make_train_step`` on the same params and batches: 2
steps of reduced float32 configs, params drawn from a seed with numpy.

The cases cover every fallback of the train layout for the dense
decoder family:

* llama3_8b at tp = 2 (heads, KV heads, d_ff and vocab all divide: the
  plain layout, row-parallel ``wo`` / ``w_down``);
* llama3_8b at tp = 4 (KV = 2 < 4: contraction-sharded ``wk`` / ``wv``);
* llama3_8b at tp = 4 with ``n_heads`` 6 and ``vocab`` 250 in both
  packages: the head fallback (``wq`` contraction-sharded, ``wo``
  column-sharded), the KV fallback and the vocab fallback (a
  contraction-sharded head);
* llama3_8b at tp = 3: 3 divides none of the reduced widths, so every
  leaf replicates (``param_pspec``'s check) and no collective runs;
* granite_20b at tp = 2 (KV = 1: contraction-sharded ``wk`` / ``wv``;
  layer norms with biases, the plain MLP);
* command_r_plus_104b at tp = 2 (the tied head contracts the sharded
  ``d_model`` of the embedding);
* a ``(2, 2)`` mesh of llama3_8b with 2 microbatches and remat (each
  gradient averaged over the data group);
* a ``(2, 1)`` mesh of llama3_8b: the same step, data-parallel alone.

The 2, 3 and 4 ranks are spawned once each, side by side, while the
reference runs here; their function is
``tests/torch_dist_ranks.py::tp_train_rank``, which imports no jax.  The
2 ranks also run ``launch.train --model-parallel 2`` (its loss against
``--model-parallel 1``'s in this process).  The refusals run in this
process.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shrules
from repro_torch.launch import train
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps
from repro_torch.tree import flatten

from test_torch_mesh_common import ranks_beside
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

B, S, STEPS = 4, 16, 2
CASES = {
    # name: (world, arch, config fields replaced, tp, microbatches, remat)
    "llama_tp2": (2, "llama3_8b", {}, 2, 1, False),
    "granite_tp2": (2, "granite_20b", {}, 2, 1, False),
    "command_r_tp2": (2, "command_r_plus_104b", {}, 2, 1, False),
    "llama_tp3": (3, "llama3_8b", {}, 3, 1, False),
    "llama_tp4": (4, "llama3_8b", {}, 4, 1, False),
    "fallback_tp4": (4, "llama3_8b", {"n_heads": 6, "vocab": 250}, 4, 1,
                     False),
    "mesh_2x2": (4, "llama3_8b", {}, 2, 2, True),
    "data_only": (2, "llama3_8b", {}, 1, 1, False),
}
CLI = ["--arch", "llama3_8b", "--steps", "3", "--batch", "4", "--seq", "16",
       "--device", "cpu"]
# The all-reduces of partial sums and of the gradients' parts add float32
# sums in another order than one device (the reference's docstring says
# so of its own train layout): the loss within a few ulps and the clip
# norm within NORM_RTOL (measured: 2.4e-7 and 1.8e-6 relative at worst,
# the fallback case's second step).
LOSS_RTOL = 2e-6
NORM_RTOL = 1e-5
# after 2 AdamW steps the params within PARAM_ATOL (measured 6.7e-5 at
# worst), and the moments within MOMENT_RTOL of their leaf's largest
# element (measured 3.6e-5).  A near-zero gradient whose sign the
# reordered sum flips moves AdamW's normalised step by up to lr a step:
# at most ranks.FLIP_SHARE of the params may move past PARAM_ATOL, each
# by at most FLIP_ATOL (two steps of lr)
PARAM_ATOL = 2e-4
FLIP_ATOL = 2 * ranks.TP_OPT["lr"]
MOMENT_RTOL = 1e-4
# the CLI's 3 steps over 2 ranks against one process
CLI_LOSS_RTOL = 1e-5
FAKE_MODEL_AXIS = LogicalMesh(("data", "model"), (1, 2), torch.device("cpu"),
                              group="world", model_group="model",
                              data_group="data")


def _configs(arch, replace):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **replace),
            dataclasses.replace(get_config(arch).reduced(), **replace))


def numpy_params(jcfg, seed=0):
    """The reference's param tree of ``jcfg`` drawn with numpy: each
    weight N(0, 1) over the square root of its fan-in (the embedding
    0.02), norm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        x = rng.standard_normal(shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * x
        if name == "bias":
            return 0.1 * x
        if name == "embed":
            return 0.02 * x
        if name in ("wq", "wk", "wv"):
            fan = shape[-3]
        elif name == "wo":
            fan = shape[-3] * shape[-2]
        else:
            fan = shape[-2]
        return x / np.float32(np.sqrt(fan))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def batches(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, vocab, (B, S)).astype(np.int32)
                  for _ in range(2)) for _ in range(STEPS)]


def reference_run(jcfg, cfg, params, data, microbatches, remat):
    """The reference's jitted single-device step on ``data``: the
    metrics of each step and the final params and moments, each as flat
    port-layout numpy arrays."""
    step = jax.jit(jax_steps.make_train_step(
        jcfg, JaxAdamWConfig(**ranks.TP_OPT), microbatches=microbatches,
        remat=remat))
    p = jax.tree.map(jnp.asarray, params)
    state = jax_steps.TrainState(p, jax_adamw_init(p))
    mets = []
    for tokens, labels in data:
        state, m = step(state, {"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(labels)})
        mets.append({k: float(v) for k, v in m.items()})
    port = lambda tree: {k: v.numpy() for k, v in flatten(
        params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                              device="cpu")).items()}
    return {"metrics": mets, "whole": {
        "params": port(state.params), "mu": port(state.opt.mu),
        "nu": port(state.opt.nu)}}


@pytest.fixture(scope="module")
def runs():
    """``(got, want, cli)``: each case's records, one a rank; the
    reference's run of each case (and ``want["cli_one"]``, the CLI's
    losses in this process); each of the 2 ranks' CLI losses and its
    ``--ckpt-dir`` refusal."""
    inputs, jobs = {}, {}
    for name, (world, arch, replace, tp, mb, remat) in CASES.items():
        jcfg, cfg = _configs(arch, replace)
        params = numpy_params(jcfg)
        data = batches(cfg.vocab)
        inputs[name] = (jcfg, cfg, params, data, mb, remat)
        flat = {k: v.numpy() for k, v in flatten(params_from_reference(
            params, cfg, device="cpu")).items()}
        jobs.setdefault(world, []).append(dict(
            name=name, arch=arch, replace=replace, tp=tp, microbatches=mb,
            remat=remat, params=flat, batches=data))
    worlds = sorted(jobs)

    def here():
        want, shared = {}, {}
        for name, (jcfg, cfg, params, data, mb, remat) in inputs.items():
            key = (CASES[name][1], tuple(sorted(CASES[name][2].items())),
                   mb, remat)
            if key not in shared:      # the llama cases share one run
                shared[key] = reference_run(jcfg, cfg, params, data, mb,
                                            remat)
            want[name] = shared[key]
        want["cli_one"] = [h["loss"] for h in train.main(CLI).history]
        return want

    def spawned(rest):
        if not rest:
            return {}, here()
        w = rest[0]
        out, (outs, want) = ranks_beside(
            ranks.tp_train_rank, w, jobs[w], CLI + ["--model-parallel", "2"]
            if w == 2 else None, beside=lambda: spawned(rest[1:]))
        return {w: out, **outs}, want

    outs, want = spawned(worlds)
    got = {name: [r[name] for r in outs[CASES[name][0]]] for name in CASES}
    return got, want, [(r["cli"], r["cli_ckpt"]) for r in outs[2]]


def _contracted(path: str, dim: int, cfg) -> bool:
    """Whether a block of the leaf ``path`` along ``dim`` is contracted by
    its product: the first dim of every layer weight and of the head,
    the ``d_model`` side of a tied embedding's head."""
    if path == "embed":
        return cfg.tie_embeddings and dim == 1
    return dim == 0


def expected_counts(case, rec):
    """The collectives of one step, by kind, from the blocks of ``rec``:
    a forward gathers a column block's output and all-reduces a
    contracted block's partial sums (each layer's again under remat, its
    recompute in the backward, but for ``w_down``'s: the non-reentrant
    checkpoint stops its recompute at the last tensor the backward
    saves, the down product's input), the backward all-reduces the input
    gradient of every product with a block (a lookup has none), the clip
    norm makes one all-reduce, and a data group of more than one rank
    one a leaf and one for the metrics."""
    _, arch, replace, tp, mb, remat = CASES[case]
    cfg = _configs(arch, replace)[1]
    n = dict.fromkeys(("gather", "reduce", "grad_reduce", "grad_mean",
                       "norm"), 0)
    for path, blk in rec["blocks"].items():
        if blk is None:
            continue
        again = remat and path.startswith("layers/") \
            and not path.endswith("w_down")
        runs = mb * (2 if again else 1)
        n["reduce" if _contracted(path, blk[0], cfg) else "gather"] += runs
        if path != "embed" or cfg.tie_embeddings:
            n["grad_reduce"] += mb
        if path == "embed" and cfg.tie_embeddings:
            n["gather"] += mb                   # the lookup, whole rows
    n["norm"] = int(any(rec["blocks"].values()))
    if rec["shape"]["data"] > 1:
        n["grad_mean"] = len(rec["blocks"]) + 1
    return n


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_match_reference(runs, case):
    """Each step's loss, cross-entropy and clip norm on every rank against
    the reference's, and the same on every rank."""
    got, want, _ = runs
    w_mets = want[case]["metrics"]
    for rec in got[case]:
        assert rec["metrics"] == got[case][0]["metrics"]
        assert len(rec["metrics"]) == len(w_mets) == STEPS
        for g, w in zip(rec["metrics"], w_mets):
            for k, rtol in (("loss", LOSS_RTOL), ("xent", LOSS_RTOL),
                            ("grad_norm", NORM_RTOL)):
                assert g[k] == pytest.approx(w[k], rel=rtol), (case, k)


@pytest.mark.parametrize("case", list(CASES))
def test_state_matches_reference(runs, case):
    """The params and both moments after 2 steps, gathered back to whole
    on shard 0 (``gather_train_state``), against the reference's
    (``ranks.hold``); only shard 0 gets them."""
    got, want, _ = runs
    for rec in got[case]:
        assert ("whole" in rec) == (rec["shard"] == 0)
    for rec in got[case]:
        if rec["shard"] != 0:
            continue
        whole, w = rec["whole"], want[case]["whole"]
        ranks.hold(whole["params"], w["params"], PARAM_ATOL, FLIP_ATOL,
                   (case, "params"))
        for part in ("mu", "nu"):
            tol = lambda v: MOMENT_RTOL * np.abs(v).max()
            assert ranks.hold(whole[part], w[part], tol, tol,
                              (case, part)) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_equal_across_ranks(runs, case):
    """Every leaf a rank holds whole (norms; at tp = 3 every leaf) is bit
    for bit the same on every rank after the steps."""
    got, _, _ = runs
    first = got[case][0]["replicated"]
    assert first and len(got[case]) == CASES[case][0]
    for rec in got[case][1:]:
        assert sorted(rec["replicated"]) == sorted(first)
        for k, v in rec["replicated"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=(case, k))


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_follow_the_train_layout(runs, case):
    """The mesh ``make_local_mesh(tp)`` gives over the group, and the
    block each rank holds of each leaf: the train layout's spec
    (``param_specs(layout="train")``), block ``shard`` of ``tp``."""
    got, _, _ = runs
    world, arch, replace, tp, _, _ = CASES[case]
    cfg = _configs(arch, replace)[1]
    whole = steps.init_train_state(cfg, 0, device="cpu").params
    shape = LogicalMesh(("data", "model"), (world // tp, tp),
                        torch.device("cpu"))
    specs = dict(ranks._spec_items(shrules.param_specs(
        whole, cfg, shape, layout="train")))
    for r, rec in enumerate(got[case]):
        assert rec["shape"] == {"data": world // tp, "model": tp}
        assert (rec["replica"], rec["shard"]) == divmod(r, tp)
        assert rec["data_ranks"] == list(range(r % tp, world, tp))
        for path, spec in specs.items():
            dims = [i for i, ax in enumerate(spec) if ax == "model"]
            want = (dims[0], r % tp, tp) if dims else None
            assert rec["blocks"][path] == want, (case, path)
    blocks = got[case][0]["blocks"]
    if case == "llama_tp3":
        assert not any(blocks.values())
    if case == "fallback_tp4":     # heads, KV and vocab fall back
        assert [blocks[f"layers/0/attn/{k}"][0] for k in
                ("wq", "wk", "wv", "wo")] == [0, 0, 0, 2]
        assert blocks["lm_head"][0] == 0
    if case == "command_r_tp2":
        assert "lm_head" not in blocks and blocks["embed"][0] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_by_kind(runs, case):
    """Each step's collectives on every rank, by kind, as the blocks
    predict them (:func:`expected_counts`), with their bytes."""
    got, _, _ = runs
    for rec in got[case]:
        want = expected_counts(case, rec)
        for counts in rec["collectives"]:
            assert {k: v["calls"] for k, v in counts.items()} == want, case
            for v in counts.values():
                assert (v["bytes"] > 0) == (v["calls"] > 0)
                assert v["staged_bytes"] == 0          # CPU tensors


def test_train_cli_over_two_ranks_matches_one_process(runs):
    """``launch.train --model-parallel 2`` under ``run_local_ranks``: both
    ranks' losses within CLI_LOSS_RTOL of ``--model-parallel 1``'s; over
    the ranks, ``--ckpt-dir`` refuses (every rank would write its own)
    naming ROADMAP A.8c(b), with no model axis too."""
    _, want, cli = runs
    assert len(cli) == 2 and len(want["cli_one"]) == 3
    for losses, refused in cli:
        np.testing.assert_allclose(losses, want["cli_one"],
                                   rtol=CLI_LOSS_RTOL)
        assert refused is not None and "A.8c(b)" in refused


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "recurrentgemma_2b",
                                  "rwkv6_3b", "paligemma_3b",
                                  "whisper_large_v3"])
def test_non_dense_families_refuse_a_model_axis(arch):
    """The MoE, hybrid, SSM, VLM and enc-dec families raise under a model
    axis above 1 over ranks, naming ROADMAP A.8c(c), before any
    collective: the step, the state's draw and its cut."""
    cfg = get_config(arch).reduced()
    match = re.escape("A.8c(c)")
    with pytest.raises(NotImplementedError, match=match):
        steps.make_train_step(cfg, AdamWConfig(), mesh=FAKE_MODEL_AXIS)
    with pytest.raises(NotImplementedError, match=match):
        steps.init_train_state(cfg, 0, device="cpu", mesh=FAKE_MODEL_AXIS)
    state = steps.init_train_state(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        steps.shard_train_state(state, cfg, FAKE_MODEL_AXIS)


def test_remesh_and_compressed_steps_refuse_a_model_axis(tmp_path):
    """What stays refused names ROADMAP A.8c(b), the re-mesh of a model
    axis: a checkpoint directory with ``--model-parallel 2``, the
    compressed step and its residuals, and the re-mesh's plan and state;
    ``--model-parallel 2`` in one process names A.8c."""
    cfg = get_config("llama3_8b").reduced()
    b = re.escape("A.8c(b)")
    with pytest.raises(NotImplementedError, match=b):
        train.main(["--model-parallel", "2", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="process group.*A.8c"):
        train.main(["--model-parallel", "2", "--device", "cpu"])
    state = steps.init_train_state(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=b):
        steps.make_dp_train_step(cfg, AdamWConfig(), FAKE_MODEL_AXIS)
    with pytest.raises(NotImplementedError, match=b):
        steps.dp_residuals_init(state.params, FAKE_MODEL_AXIS)
    with pytest.raises(NotImplementedError, match=b):
        steps.init_train_state(cfg, 0, device="cpu", compressed=True,
                               mesh=FAKE_MODEL_AXIS)
    with pytest.raises(NotImplementedError, match=b):
        elastic.make_mesh_from_plan(elastic.RemeshPlan(
            (4, 1), (2, 2), ("data", "model"), 1), device="cpu")
    with pytest.raises(NotImplementedError, match=b):
        elastic.reshard_state(state, cfg, FAKE_MODEL_AXIS)


def test_block_state_helpers_in_one_process():
    """Without a model axis over ranks the cut and the gather give the
    state back as it is; a block tree's moments are blocks of the same
    part, its clip norm refuses to run without the model group, and a
    contracted block stays refused under the serve layout."""
    from repro_torch.optim import adamw_init, global_norm
    cfg = get_config("llama3_8b").reduced()
    state = steps.init_train_state(cfg, 0, device="cpu")
    one = LogicalMesh(("data", "model"), (1, 2), torch.device("cpu"))
    assert steps.shard_train_state(state, cfg, one) is state
    assert steps.gather_tree(state.params, one) is state.params
    blk = shrules.RankBlock(torch.ones(4, 3), 0, 1, 2)
    opt = adamw_init({"w": blk, "b": torch.ones(2)})
    mu = opt.mu["w"]
    assert isinstance(mu, shrules.RankBlock) and (mu.dim, mu.shard, mu.tp) \
        == (0, 1, 2) and mu.data.shape == (4, 3) and not mu.data.any()
    with pytest.raises(ValueError, match="model group"):
        global_norm({"w": blk})
    ranked = dataclasses.replace(one, group="world", rank=1,
                                 model_group="model")
    with shrules.serve_mesh_scope(ranked):
        with pytest.raises(ValueError, match="contracted"):
            shrules.block_product(torch.ones(2, 8), blk,
                                  lambda x, w: x @ w.data, {1: -1}, {0: -1})


def test_activation_constraint_is_set_and_called_at_group_starts(
        monkeypatch):
    """``set_activation_sharding`` keeps a batch spec (and refuses one
    that places more than the batch); ``constrain_activation`` returns its
    argument, called at each layer group's start as the reference's scan
    calls it: every layer of a one-kind pattern, one a period of the
    hybrid's, none in its tail."""
    from repro_torch.models import family
    from repro_torch.models import transformer as tf
    x = torch.ones(2, 3, 4)
    try:
        shrules.set_activation_sharding(("data", None, None))
        assert shrules._ACTIVATION_SHARDING == ("data", None, None)
        assert shrules.constrain_activation(x) is x
        for bad in (("model", None, None), ("data", "model", None),
                    ("data", None)):
            with pytest.raises(ValueError):
                shrules.set_activation_sharding(bad)
    finally:
        shrules.set_activation_sharding(None)
    assert shrules._ACTIVATION_SHARDING is None
    calls = []
    monkeypatch.setattr(shrules, "constrain_activation",
                        lambda x: calls.append(x.shape) or x)
    for arch, n_layers, groups in (("llama3_8b", 2, 2),
                                   ("recurrentgemma_2b", 4, 1)):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  n_layers=n_layers)
        jcfg = jax_get_config(arch).reduced()
        assert groups == n_layers // len(jcfg.block_pattern)
        params = family.init_params(cfg, 0, torch.float32, device="cpu")
        calls.clear()
        tf.forward_logits(params, cfg, torch.zeros((2, 5), dtype=torch.int64))
        assert calls == [(2, 5, cfg.d_model)] * groups, arch
