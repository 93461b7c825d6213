"""``MeshServeEngine`` over the ranks of a gloo group on the CPU: reduced
llama3_8b and deepseek_7b at tp = 4 over 4 ranks (every weight the serve
layout shards cut into 4 column blocks, one a rank) and at tp = 3 over 3
ranks (3 divides none of the reduced widths, so every leaf replicates and
every product runs whole on every rank with all three shards' streams),
greedy and sampled, the fused and the plain route, each rank's tokens
equal to the reference's one-device mesh oracle
(tests/test_torch_mesh_common.py) and to the port's one-device engine; a
``(2, 2)`` mesh whose two replicas agree; the clean and ``runtime=``
routes; the bytes each rank holds, its all-gathers, ``init_mesh_params``'
blocks; and the serving helpers of ``repro_torch.distributed.sharding``
in one process.  qwen3_moe_235b and whisper are
tests/test_torch_mesh_ranks_families.py.

The 4 and the 3 ranks are spawned once each, side by side, beside the
reference's oracles of both worlds, which run here; their function is
``tests/torch_dist_ranks.py::mesh_serve_rank``, which imports no jax.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.distributed import sharding as jax_sharding
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shrules
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models import family
from repro_torch.serve.sharded import MeshServeEngine
from repro_torch.tree import flatten

from test_torch_mesh_common import (model, oracle_tokens, prompts,
                                    ranks_beside, shard_fleets)

ARCHS = ("llama3_8b", "deepseek_7b")
SAMPLED = dict(temperature=0.8, top_k=8)
# greedy through the sampler's top_k: temperature 0 is the exact argmax,
# and the reference's generation compiles once for both modes
GREEDY = dict(temperature=0.0, top_k=8)
F32 = dict(serve_dtype=torch.float32, device="cpu")
BUILD_SEED = 1
WORLD = 4


def runs_of(vocab: int, world: int) -> list:
    """The runs of one world: at tp = world, greedy (seed 0) and sampled
    (seed 3) on both routes; with 4 ranks also the clean and ``runtime=``
    routes and a ``(2, 2)`` mesh, greedy fused and sampled plain."""
    g, s = prompts(vocab, world), prompts(vocab, 7 + world)
    runs = [dict(tp=world, fleet="plain", fused=f, seed=0, prompts=g, n=4,
                 kw=GREEDY) for f in (True, False)]
    runs += [dict(tp=world, fleet="plain", fused=f, seed=3, prompts=s, n=4,
                  kw=SAMPLED) for f in (True, False)]
    if world == 4:
        runs += [dict(tp=4, fleet=None, fused=True, seed=5, prompts=g, n=4),
                 dict(tp=4, fleet="runtime", fused=False, seed=5,
                      prompts=g, n=4),
                 dict(tp=2, fleet="plain", fused=True, seed=0, prompts=g,
                      n=4, kw=GREEDY),
                 dict(tp=2, fleet="plain", fused=False, seed=3, prompts=s,
                      n=4, kw=SAMPLED)]
    return runs


def one_device(cfg, params, run) -> np.ndarray:
    """The port's one-device engine on ``run``."""
    kind = run["fleet"]
    fleet = None if kind in (None, "runtime") else ranks.shard_fleet(
        run["tp"], "cpu")
    runtime = ranks.shard_fleet(1, "cpu").device(0) \
        if kind == "runtime" else None
    eng = MeshServeEngine(cfg, params, tp=run["tp"], fleet=fleet,
                          runtime=runtime, max_len=32, seed=run["seed"],
                          use_fused_kernel=run["fused"], **F32)
    return eng.generate(run["prompts"], run["n"], **run.get("kw", {})).tokens


def serve_worlds(worlds=(4, 3)):
    """The ranks' results of each world's ranks on both archs (with
    ``init_mesh_params`` at tp = world), beside the oracle's tokens and
    the one-device engine's, by arch: ``{world: (models, jobs, out,
    want)}``.  Every world's ranks run at once, while the oracles run
    here."""
    models = {arch: model(arch) for arch in ARCHS}
    jobs = {w: {arch: {"params": {k: v.numpy() for k, v in flatten(
        m[3]).items()}, "runs": runs_of(m[1].vocab, w),
        "build_seed": BUILD_SEED} for arch, m in models.items()}
        for w in worlds}

    def oracle(world):
        want = {}
        for arch, (jcfg, cfg, jp, params) in models.items():
            jf, _ = shard_fleets(world)
            runs = jobs[world][arch]["runs"]
            want[arch, "greedy"] = oracle_tokens(
                jcfg, jp, jf, runs[0]["prompts"], 4, **GREEDY)
            want[arch, "sampled"] = oracle_tokens(
                jcfg, jp, jf, runs[2]["prompts"], 4, seed=3, **SAMPLED)
            want[arch, "one_device"] = [one_device(cfg, params, r)
                                        for r in runs]
        return want

    def spawned(rest):
        """The ranks of ``rest[0]`` in a thread beside the rest's, and
        the oracles once every world is spawned."""
        if not rest:
            return {}, {w: oracle(w) for w in worlds}
        out, (outs, wants) = ranks_beside(
            ranks.mesh_serve_rank, rest[0], jobs[rest[0]],
            beside=lambda: spawned(rest[1:]))
        return {rest[0]: out, **outs}, wants

    outs, wants = spawned(list(worlds))
    return {w: (models, jobs[w], outs[w], wants[w]) for w in worlds}


@pytest.fixture(scope="module")
def worlds():
    return serve_worlds()


@pytest.fixture
def served(worlds):
    return worlds[WORLD]


def check_tokens(served, arch, mode):
    """Every rank's tokens on the fused and the plain route equal the
    reference oracle's and the one-device engine's."""
    _, jobs, out, want = served
    world = len(out)
    first = 0 if mode == "greedy" else 2
    for i in (first, first + 1):
        assert jobs[arch]["runs"][i]["fused"] == (i == first)
        np.testing.assert_array_equal(want[arch, "one_device"][i],
                                      want[arch, mode])
        for r in range(world):
            rec = out[r][arch]["runs"][i]
            assert rec["shape"] == {"data": 1, "model": world}
            assert rec["shard"] == r and rec["replica"] == 0
            np.testing.assert_array_equal(rec["tokens"], want[arch, mode],
                                          err_msg=f"rank {r} run {i}")


def expected_bytes(params, specs, tp: int) -> int:
    """A rank's bytes: each leaf whole, or a tp-th of it where its spec
    splits it over "model"."""
    total = 0
    for path, t in flatten(params).items():
        n = t.numel() * t.element_size()
        total += n // tp if "model" in specs[path] else n
    return total


def check_held_bytes(served, arch):
    """The serve layout's specs on the ranks equal the one-process
    engine's, and each rank holds its blocks and the replicated leaves,
    nothing more."""
    models, _, out, _ = served
    tp = len(out)
    cfg, params = models[arch][1], models[arch][3]
    one = dict(ranks._spec_items(MeshServeEngine(
        cfg, params, tp=tp, **F32).specs))
    for r in range(tp):
        rec = out[r][arch]["runs"][0]
        assert rec["specs"] == one
        assert rec["held_bytes"] == expected_bytes(params, one, tp)
    return one, sum(t.numel() * t.element_size()
                    for t in flatten(params).values())


def check_built_blocks(served):
    """``init_mesh_params`` on each rank keeps its blocks of the draws
    ``family.init_params`` makes from the same seed: the ranks' blocks,
    concatenated along each leaf's split dim, are the whole tree, and a
    replicated leaf is the same on every rank."""
    models, _, out, _ = served
    world = len(out)
    for arch in ARCHS:
        cfg = models[arch][1]
        tree = family.init_params(cfg, BUILD_SEED, torch.float32,
                                  device="cpu")
        whole = flatten(tree)
        specs = dict(ranks._spec_items(MeshServeEngine(
            cfg, tree, tp=world, **F32).specs))
        built = [out[r][arch]["built"] for r in range(world)]
        assert sorted(built[0]) == sorted(whole)
        for path, t in whole.items():
            spec = specs[path]
            if "model" in spec:
                got = np.concatenate([b[path] for b in built],
                                     axis=spec.index("model"))
            else:
                got = built[0][path]
                for b in built[1:]:
                    np.testing.assert_array_equal(b[path], got)
            np.testing.assert_array_equal(got, t.numpy(), err_msg=path)


@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_tokens_match_reference(worlds, arch, mode, world):
    check_tokens(worlds[world], arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_whole_tree_at_tp3(worlds, arch):
    served = worlds[3]
    one, whole = check_held_bytes(served, arch)
    assert all(sp == () for sp in one.values())
    assert served[2][0][arch]["runs"][0]["held_bytes"] == whole
    assert served[2][0][arch]["runs"][0]["gathers"]["calls"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_two_replicas_agree(served, arch):
    """A ``(2, 2)`` mesh over 4 ranks: rank ``r`` is shard ``r % 2`` of
    replica ``r // 2``; the replicas serve the same prompts and all four
    ranks give the one-device engine's tokens at tp = 2, greedy fused and
    sampled plain."""
    _, _, out, want = served
    for i in (6, 7):
        recs = [out[r][arch]["runs"][i] for r in range(4)]
        assert [(x["replica"], x["shard"]) for x in recs] == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        assert recs[0]["shape"] == {"data": 2, "model": 2}
        for x in recs:
            np.testing.assert_array_equal(x["tokens"], recs[0]["tokens"])
            np.testing.assert_array_equal(x["tokens"],
                                          want[arch, "one_device"][i])


@pytest.mark.parametrize("arch", ARCHS)
def test_clean_and_runtime_routes(served, arch):
    """Clean serving (every product a float column block, exact at these
    widths on the CPU) and the ``runtime=`` route (one scalar BER: each
    block takes its words' draws in the whole product) give the
    one-device engine's tokens on every rank."""
    _, _, out, want = served
    for i in (4, 5):
        for r in range(4):
            np.testing.assert_array_equal(out[r][arch]["runs"][i]["tokens"],
                                          want[arch, "one_device"][i])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_blocks(served, arch):
    """At tp = 4 the head, the embedding and every sharded projection a
    quarter a rank; k and v (KV = 2 at reduced widths) and the norms
    whole."""
    one, whole = check_held_bytes(served, arch)
    assert one["embed"] == ("model", None)
    assert one["lm_head"] == (None, "model")
    assert one["layers/0/attn/wk"] == ()
    assert served[2][0][arch]["runs"][0]["held_bytes"] < whole / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_gathers_a_forward(served, arch):
    """One all-gather a sharded weight product (at reduced widths KV = 2
    replicates k and v at tp = 4: 5 a layer; 7 at tp = 2), one for the
    embedding and one for the head, each forward (prefill + 3 decode
    steps); nothing staged through host memory on the CPU."""
    models, _, out, _ = served
    L = models[arch][1].n_layers
    for i, per_layer in ((0, 5), (6, 7)):
        g = out[0][arch]["runs"][i]["gathers"]
        assert g["calls"] == 4 * (per_layer * L + 2)
        assert g["bytes"] > 0 and g["staged_bytes"] == 0


@pytest.mark.parametrize("world", [4, 3])
def test_init_mesh_params_blocks_concatenate(worlds, world):
    check_built_blocks(worlds[world])


class _FakeMesh:
    """A named mesh shape for both packages' rules (``shape``,
    ``axis_names``)."""

    def __init__(self, **shape):
        self.shape, self.axis_names = shape, tuple(shape)


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_out", [1, 6, 8, 12, 1024, 51866])
def test_serve_shard_map_info_is_the_references_rule(tp, n_out):
    """``serve_shard_map_info`` under each package's scope: the same
    verdict (and tp) for every width, and ``None`` outside a scope."""
    mesh = _FakeMesh(data=1, model=tp)
    with shrules.serve_mesh_scope(mesh):
        got = shrules.serve_shard_map_info(n_out)
        assert shrules.serve_mesh_active() is mesh
    with jax_sharding.serve_mesh_scope(mesh):
        want = jax_sharding.serve_shard_map_info(n_out)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[1:] == tuple(want[1:]) == ("model", tp)
    assert shrules.serve_shard_map_info(n_out) is None
    assert shrules.serve_mesh_active() is None


def test_one_process_helpers_are_the_identity():
    """Without a mesh over ranks: ``shard_tree`` returns the whole tree,
    ``lookup_rows`` the embedding's rows, ``block_product`` the product,
    and no leaf is a block."""
    cfg = get_config("llama3_8b").reduced()
    params = family.init_params(cfg, 0, torch.float32, device="cpu")
    mesh = LogicalMesh(("data", "model"), (1, 4), torch.device("cpu"))
    specs = shrules.param_specs(params, cfg, mesh, layout="serve")
    h = torch.randn(2, cfg.d_model)
    for scope in (None, mesh):
        with shrules.serve_mesh_scope(scope):
            assert shrules.shard_tree(params, specs, mesh) is params
            ids = torch.tensor([[0, 5, 255]])
            assert torch.equal(shrules.lookup_rows(params["embed"], ids),
                               params["embed"][ids])
            assert torch.equal(shrules.block_product(
                h, params["lm_head"], lambda x, w: x @ w, {1: -1}),
                h @ params["lm_head"])
    assert not any(isinstance(t, shrules.RankBlock)
                   for t in flatten(params).values())


@pytest.mark.parametrize("ber", [(0.02, 0.05, 0.1, 0.2), 0.05],
                         ids=["shard_bers", "one_ber"])
def test_rank_block_computes_its_columns_and_only_as_a_block(ber):
    """``aged_linear`` on block ``s`` of 4 column blocks (a ``RankBlock``)
    gives columns ``s`` of the whole weight's injected product bit for
    bit: under ``(S,)`` BERs at ``ber[s]`` from shard ``s``'s stream, under
    one BER from the key's draws of the block's words.  The block cannot
    pass for a whole weight: a cast or a fold keeps it a block, a plain
    product of it raises, and ``block_product`` refuses it outside a rank
    mesh of its shard and tp and along a contracted dim."""
    from repro_torch import random as prandom
    from repro_torch.kernels import ops as kops
    S, n = 4, 24
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 64), generator=gen)
    w = torch.randn((64, S * n), generator=gen)
    route = dict(ber=ber, use_kernel=False, fused=False)
    if isinstance(ber, tuple):
        route["seed"] = 7
    else:
        route["key"] = prandom.PRNGKey(11)
    whole = kops.aged_linear(x, w, **route)
    clean = kops.aged_linear(x, w, ber=0.0, use_kernel=False)
    assert not torch.equal(whole, clean)
    for s in range(S):
        blk = shrules.RankBlock(w[:, s * n:(s + 1) * n].clone(), 1, s, S)
        assert blk.shape == w.shape and blk.span == slice(s * n, (s + 1) * n)
        got = kops.aged_linear(x, blk.map(lambda t: t.to(torch.float64))
                               .map(lambda t: t.to(torch.float32)), **route)
        assert torch.equal(got, whole[..., s * n:(s + 1) * n]), s
    wq = torch.randn((64, 2, n), generator=gen)
    folded = shrules.fold(shrules.RankBlock(wq, 1, 1, S), 1)
    assert isinstance(folded, shrules.RankBlock)
    assert (folded.dim, folded.shard, folded.tp) == (1, 1, S)
    assert folded.data.shape == (64, 2 * n)
    with pytest.raises(ValueError, match="not a column block"):
        shrules.fold(shrules.RankBlock(wq, 2, 1, S), 1)
    with pytest.raises(ValueError, match="not a column block"):
        kops.aged_linear(x, shrules.RankBlock(w[:16], 0, 0, S), **route)
    with pytest.raises(TypeError):
        x @ blk
    mesh = LogicalMesh(("data", "model"), (1, S), torch.device("cpu"))
    for scope in (None, mesh):
        with shrules.serve_mesh_scope(scope):
            with pytest.raises(RuntimeError, match="not the whole weight"):
                shrules.block_product(x, blk, lambda x, w: x @ w.data,
                                      {1: -1})
            with pytest.raises(RuntimeError, match="not the whole weight"):
                shrules.lookup_rows(blk, torch.tensor([0, 1]))
    # a rank mesh of the block's shard and tp (no collective is reached)
    ranked = LogicalMesh(("data", "model"), (1, S), torch.device("cpu"),
                         group="group", rank=blk.shard, model_group="group")
    with shrules.serve_mesh_scope(ranked):
        with pytest.raises(ValueError, match="contracted"):
            shrules.block_product(x, blk, lambda x, w: x @ w.data, {0: 0})
