"""The int8 GEMM's launch plan (``repro_torch.kernels._cuda.gemm_plan``).

The plan is made on the host, so its promises are checked here on the
CPU: every serve-path shape takes the fast path with at least one CTA per
SM of an H100 (132), ragged shapes take the generic path, the K splits
cover ``[0, K)`` once in whole stages, and adding the int32 partials of
those splits with wraparound gives the reference's accumulator — the
split-K reduction the kernel does with its ticket.  The fleet's lane mode
folds 4 lanes of B = 2 into M = 8 (decode) and 4 x 32 = 128 (prefill)
rows; its plan is the folded M's, its streams the lanes' own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels import ref
from repro_torch.kernels._cuda import FAST_BK, gemm_plan
from repro_torch.kernels.systolic_matmul import systolic_matmul

H100_SMS = 132
MAIN = [(M, K, N) for M in (2, 32)
        for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096))]
EDGES = [(2, 14336, 1024), (16, 4096, 1024), (17, 4096, 1024),
         (65, 4096, 1024), (2, 4112, 1040), (33, 4112, 1040), (1, 16, 16)]
RAGGED = [(33, 96, 130), (7, 5, 3), (300, 257, 513), (2, 4097, 1025),
          (32, 4096, 1025)]
# llama3_8b's weight GEMMs with 4 lanes of B = 2 folded: decode and prefill
LANES = [(M, K, N) for M in (8, 128)
         for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                      (14336, 4096))]

# qwen3_moe_235b's faulted weight GEMMs at its published head_dim 128
# (q, k/v, router at K = d_model; o at K = 64 heads x 128) with 4 lanes of
# B = 2 folded: the MoE fleet's decode and prefill
MOE_LANES = [(M, K, N) for M in (8, 128)
             for K, N in ((4096, 8192), (4096, 512), (4096, 128),
                          (8192, 4096))]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _split_sum(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
    for k0, k1 in plan.k_ranges():
        part = ref.systolic_matmul_ref(a[:, k0:k1], b[k0:k1])
        acc = _wrap32(acc + part.to(torch.int64)).to(torch.int64)
    return acc.to(torch.int32)


@pytest.mark.parametrize("M,K,N", MAIN)
def test_plan_fills_every_sm_on_the_fast_path(M, K, N):
    plan = gemm_plan(M, N, K, H100_SMS)
    assert plan.path == "fast"
    assert plan.ctas >= H100_SMS
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == plan.ctas
    # one M tile: every weight byte is streamed by one CTA only
    assert plan.grid[1] == 1 and plan.bm == (16 if M <= 16 else 32)


# (bm, bn, splits) at M = 128: two 64-row tiles, K split until every SM
# has a CTA (gate/up's 224 tiles need none)
PREFILL_128 = {(4096, 4096): (64, 64, 2), (4096, 1024): (64, 64, 5),
               (4096, 14336): (64, 128, 1), (14336, 4096): (64, 64, 2)}


@pytest.mark.parametrize("M,K,N", LANES)
def test_plan_for_lane_folded_rows(M, K, N):
    """Eight folded decode rows take one lane's plan (the 16-row tile, the
    same grid as M = 2); 128 prefill rows take two 64-row tiles.  Both fill
    every SM, and the workspace holds every split's partial of every
    tile."""
    plan = gemm_plan(M, N, K, H100_SMS)
    assert plan.path == "fast" and plan.ctas >= H100_SMS
    if M == 8:
        one = gemm_plan(2, N, K, H100_SMS)
        assert (plan.bm, plan.bn, plan.splits) == (one.bm, one.bn,
                                                    one.splits) == \
            (16, one.bn, one.splits)
        assert plan.grid == one.grid
    else:
        assert (plan.bm, plan.bn, plan.splits) == PREFILL_128[(K, N)]
        assert plan.grid[1] == 2
    assert plan.workspace_words == (plan.tiles * plan.splits * plan.bm
                                    * plan.bn if plan.splits > 1 else 0)
    assert plan.n_tickets == (plan.tiles if plan.splits > 1 else 0)


@pytest.mark.parametrize("M,K,N", MOE_LANES)
def test_plan_for_moe_lane_folded_rows(M, K, N):
    """The MoE fleet's lane launches take the fast path: eight decode rows
    the 16-row tile and grid of one lane's M = 2, 128 prefill rows two
    64-row tiles; K is split until every SM has a CTA or every split is
    one stage (the router's 128 columns give too few tiles to fill 132
    SMs)."""
    plan = gemm_plan(M, N, K, H100_SMS)
    assert plan.path == "fast"
    kblocks = -(-K // FAST_BK)
    assert plan.ctas >= H100_SMS or plan.splits == kblocks
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == plan.ctas
    if M == 8:
        one = gemm_plan(2, N, K, H100_SMS)
        assert (plan.bm, plan.bn, plan.splits, plan.grid) == \
            (16, one.bn, one.splits, one.grid)
    else:
        assert plan.bm == 64 and plan.grid[1] == 2
    assert plan.workspace_words == (plan.tiles * plan.splits * plan.bm
                                    * plan.bn if plan.splits > 1 else 0)


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_plan_takes_the_generic_path_for_ragged_shapes(M, K, N):
    plan = gemm_plan(M, N, K, H100_SMS)
    assert (plan.path, plan.splits) == ("generic", 1)
    assert plan.k_ranges() == [(0, K)]


def test_plan_takes_the_generic_path_for_misaligned_operands():
    assert gemm_plan(2, 1024, 4096, H100_SMS, aligned=False).path == \
        "generic"


@pytest.mark.parametrize("M,K,N", MAIN + EDGES)
def test_k_splits_cover_k_once_in_whole_stages(M, K, N):
    plan = gemm_plan(M, N, K, H100_SMS)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (k0, k1), (n0, _) in zip(ranges, ranges[1:]):
        assert k1 == n0
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % FAST_BK == 0
        assert k1 % FAST_BK == 0 or k1 == K
    # balanced: the longest split is at most one stage longer than the
    # shortest
    lens = [-(-(k1 - k0) // FAST_BK) for k0, k1 in ranges]
    assert max(lens) - min(lens) <= 1
    assert plan.workspace_words == (plan.tiles * plan.splits * plan.bm
                                    * plan.bn if plan.splits > 1 else 0)


@pytest.mark.parametrize("M,K,N,n_sms", [(2, 1024, 256, 132),
                                         (32, 1280, 64, 132),
                                         (17, 400, 48, 16),
                                         (65, 2048, 128, 132)])
def test_split_k_partials_sum_to_the_reference(M, K, N, n_sms):
    """Per-split int32 partials added with wraparound == the unsplit
    accumulator, port plain version and JAX reference alike."""
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    plan = gemm_plan(M, N, K, n_sms)
    assert plan.path == "fast" and plan.splits > 1
    got = _split_sum(torch.from_numpy(a), torch.from_numpy(b), plan)
    np.testing.assert_array_equal(
        got.numpy(), ref.systolic_matmul_ref(torch.from_numpy(a),
                                             torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.systolic_matmul_ref(jnp.asarray(a),
                                                         jnp.asarray(b))))


def test_split_k_sum_wraps_like_int32():
    """A K long enough to pass 2**31: the split partials, each in range,
    add modulo 2**32 as the kernel's integer adds do (numpy's int32 matmul
    wraps the same way)."""
    M, K, N = 1, 2 ** 17 + 4096, 16
    a = np.full((M, K), -128, dtype=np.int8)
    b = np.full((K, N), -128, dtype=np.int8)
    b[:, 1] = 127
    plan = gemm_plan(M, N, K, H100_SMS)
    assert plan.splits > 1
    got = _split_sum(torch.from_numpy(a), torch.from_numpy(b), plan)
    want = a.astype(np.int32) @ b.astype(np.int32)
    assert want[0, 0] < 0 < K * 128 * 128           # it did wrap
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_k_then_one_epilogue_matches_the_pallas_kernel():
    """The fast path's order — sum every split's partial, then upset and
    dequantise each word once — gives the fused Pallas kernel's output."""
    M, K, N, ber, seed = 32, 512, 128, 1e-2, 11
    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    xs = rng.random((M, 1), dtype=np.float32) + 0.5
    ws = rng.random((1, N), dtype=np.float32) + 0.5
    plan = gemm_plan(M, N, K, H100_SMS)
    assert plan.splits > 1
    acc = _split_sum(torch.from_numpy(a), torch.from_numpy(b), plan)
    bits = pfam.tile_counter_bits(M, N, seed, bm=32, bn=128)
    acc = pfam.upset_words(acc, bits, pfam.upset_probability(ber))
    got = acc.to(torch.float32) * torch.from_numpy(xs) * torch.from_numpy(ws)
    want = np.asarray(jops.fused_aged_matmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(xs), jnp.asarray(ws),
        ber=ber, seed=seed, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_split_k_then_lane_epilogue_matches_vmapped_pallas():
    """The lane mode's order at M = 128 (4 lanes of 32 rows, two 64-row CTA
    tiles, K split): sum the folded rows' split partials, then upset each
    word with its lane's seed and BER over its lane-local row — equal to
    ``jax.vmap`` of the fused Pallas kernel, lane by lane."""
    L, Ml, K, N = 4, 32, 512, 128
    bers = np.asarray([1e-2, 0.0, 3e-2, 1e-3], np.float32)
    seeds = np.asarray([5, -9, 77, 2 ** 30], np.int32)
    rng = np.random.default_rng(12)
    a = rng.integers(-128, 128, (L, Ml, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    xs = rng.random((L, Ml, 1), dtype=np.float32) + 0.5
    ws = rng.random((1, N), dtype=np.float32) + 0.5
    plan = gemm_plan(L * Ml, N, K, H100_SMS)
    assert (plan.bm, plan.grid[1]) == (64, 2) and plan.splits > 1
    acc = _split_sum(torch.from_numpy(a.reshape(L * Ml, K)),
                     torch.from_numpy(b), plan)
    lanes = []
    for l in range(L):
        bits = pfam.tile_counter_bits(Ml, N, int(seeds[l]), bm=32, bn=128)
        up = pfam.upset_words(acc[l * Ml:(l + 1) * Ml], bits,
                              pfam.upset_probability(float(bers[l])))
        lanes.append(up.to(torch.float32) * torch.from_numpy(xs[l])
                     * torch.from_numpy(ws))
    want = np.asarray(jax.vmap(
        lambda a_l, xs_l, ber, seed: jops.fused_aged_matmul(
            a_l, jnp.asarray(b), xs_l, jnp.asarray(ws), ber=ber, seed=seed,
            interpret=True))(jnp.asarray(a), jnp.asarray(xs),
                             jnp.asarray(bers), jnp.asarray(seeds)))
    np.testing.assert_array_equal(torch.stack(lanes).numpy(), want)


def test_cpu_gemm_wrappers_count_no_path():
    """On the CPU the wrappers take their plain versions: no launch, on
    either path."""
    kernels.reset_launch_counts()
    a = torch.ones((2, 32), dtype=torch.int8)
    b = torch.ones((32, 16), dtype=torch.int8)
    systolic_matmul(a, b)
    pfam.fused_aged_matmul(a, b, None, None, 1e-3, 1)
    pfam.fused_aged_matmul_lanes(a, b, None, None, [1e-3, 0.0], [1, 2],
                                 lanes=2)
    assert kernels.launch_counts_by_path() == {
        "fused_aged_matmul": {"fast": 0, "generic": 0},
        "fused_aged_matmul_lanes": {"fast": 0, "generic": 0},
        "systolic_matmul": {"fast": 0, "generic": 0}}
