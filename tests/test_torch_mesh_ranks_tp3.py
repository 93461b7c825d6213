"""``MeshServeEngine`` at tp = 3 over 3 gloo ranks on the CPU: reduced
llama3_8b and deepseek_7b, whose widths (4 heads, d 64, d_ff 128, vocab
256) 3 divides nowhere, so every leaf replicates and every product runs
whole on every rank with all three shards' streams, as on one device:
greedy and sampled on both routes equal to the reference's oracle and
the one-device engine, each rank holding the whole tree, no all-gather,
and ``init_mesh_params`` at tp = 3 (set-up and checks shared with
tests/test_torch_mesh_ranks.py)."""
import pytest

from test_torch_mesh_ranks import (ARCHS, check_built_blocks,
                                   check_held_bytes, check_tokens,
                                   serve_world)

WORLD = 3


@pytest.fixture(scope="module")
def served():
    return serve_world(WORLD)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_tokens_match_reference(served, arch, mode):
    check_tokens(served, arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_whole_tree(served, arch):
    one, whole = check_held_bytes(served, arch)
    assert all(sp == () for sp in one.values())
    assert served[2][0][arch]["runs"][0]["held_bytes"] == whole
    assert served[2][0][arch]["runs"][0]["gathers"]["calls"] == 0


def test_init_mesh_params_blocks_concatenate(served):
    check_built_blocks(served)
