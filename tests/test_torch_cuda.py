"""Each CUDA kernel of the port vs its plain PyTorch version, on the card.

Marked ``cuda``; every test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither jax nor the reference package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch import random as prandom
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels.bitflip import (bitflip_draw, bitflip_draw_lanes,
                                         bitflip_words)
from repro_torch.kernels.systolic_matmul import systolic_matmul


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# the serve paths' weight GEMMs (B=2: M = 2 decode, 32 prefill): llama3_8b's
# q/o, k/v, gate/up, down; qwen3_moe_235b's at its published head_dim 128
# (q N = 8192, k/v N = 512, o K = 8192) and at the reference config's
# derived head_dim 64 (k/v N = 256; q/o are llama's q/o shape), and its
# router (N = 128 experts)
MAIN = [(M, K, N) for M in (2, 32)
        for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096), (4096, 8192), (4096, 512), (8192, 4096),
                     (4096, 256), (4096, 128))]
# fast path at its boundaries: M tiles of 16/32/64 rows, a long K split over
# a narrow N, K and N just past a multiple of 128 (a short last stage, a
# ragged column tile)
EDGES = [(2, 14336, 1024), (16, 4096, 1024), (17, 4096, 1024),
         (65, 4096, 1024), (2, 4112, 1040), (33, 4112, 1040)]
# generic path: K or N not a multiple of 16
RAGGED = [(33, 96, 130), (7, 5, 3), (300, 257, 513), (2, 4097, 1025),
          (32, 4096, 1025)]


def _operands(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev,
                      generator=g)
    b = torch.randint(-128, 128, (K, N), dtype=torch.int8, device=dev,
                      generator=g)
    xs = torch.rand((M, 1), device=dev, generator=g) + 0.5
    ws = torch.rand((1, N), device=dev, generator=g) + 0.5
    return a, b, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("ber", [1e-3, 0.0])
@pytest.mark.parametrize("M,K,N", MAIN + EDGES + RAGGED)
def test_cuda_gemm_kernels_match_plain(cuda_device, M, K, N, ber):
    """All three modes (plain, upset, upset + dequant): int32 and float32
    outputs bit-exact, one launch per wrapper call."""
    a, b, xs, ws = _operands(cuda_device, M, K, N, M + K + N)
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    kernels.reset_launch_counts()
    assert torch.equal(systolic_matmul(a, b), ref.systolic_matmul_ref(a, b))
    for xs_, ws_ in ((None, None), (xs, ws)):
        got = pfam.fused_aged_matmul(a, b, xs_, ws_, ber, -77, bm=bm, bn=bn)
        want = ref.fused_aged_matmul_ref(a, b, xs_, ws_, ber, -77, bm=bm,
                                         bn=bn)
        assert got.dtype == want.dtype and torch.equal(got, want)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"fused_aged_matmul": 2,
                                       "fused_aged_matmul_lanes": 0,
                                       "fused_aged_matmul_shards": 0,
                                       "bitflip_words": 0,
                                       "bitflip_draw": 0,
                                       "bitflip_draw_lanes": 0,
                                       "counter_upset_shards": 0,
                                       "systolic_matmul": 1}


@pytest.mark.cuda
def test_cuda_gemm_launch_paths_match_shapes(cuda_device):
    """Aligned shapes with K and N multiples of 16 take the fast path, the
    rest (and a misaligned operand) the generic one."""
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kernels.reset_launch_counts()
    want = {"fast": 0, "generic": 0}
    for M, K, N in MAIN + EDGES + RAGGED:
        a, b, _, _ = _operands(cuda_device, M, K, N, 0)
        systolic_matmul(a, b)
        pfam.fused_aged_matmul(a, b, None, None, 1e-3, 1)
        path = "generic" if (M, K, N) in RAGGED else "fast"
        assert _cuda.gemm_plan(M, N, K, n_sms).path == path
        want[path] += 1
    a, b, _, _ = _operands(cuda_device, 2, 4096, 1024, 0)
    shifted = torch.empty(a.numel() + 1, dtype=torch.int8,
                          device=cuda_device)[1:].view(a.shape)
    shifted.copy_(a)
    assert torch.equal(systolic_matmul(shifted, b),
                       ref.systolic_matmul_ref(a, b))
    torch.cuda.synchronize()
    assert kernels.launch_counts_by_path() == {
        "fused_aged_matmul": want,
        "fused_aged_matmul_lanes": {"fast": 0, "generic": 0},
        "fused_aged_matmul_shards": {"fast": 0, "generic": 0},
        "systolic_matmul": {"fast": want["fast"],
                            "generic": want["generic"] + 1}}


@pytest.mark.cuda
def test_cuda_gemm_workspace_reuse_is_repeatable(cuda_device):
    """Split-K calls reuse one workspace and its tickets: the same shape
    three times, with other split shapes between, gives identical outputs
    (a ticket left non-zero would run an epilogue early or never)."""
    shapes = [(32, 4096, 1024), (2, 14336, 4096), (65, 4096, 1024)]
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert all(_cuda.gemm_plan(M, N, K, n_sms).splits > 1
               for M, K, N in shapes)
    for M, K, N in shapes:
        a, b, xs, ws = _operands(cuda_device, M, K, N, 7)
        want = ref.fused_aged_matmul_ref(a, b, xs, ws, 1e-3, 3, bm=256,
                                         bn=256)
        for _ in range(3):
            for other in shapes:
                oa, ob, _, _ = _operands(cuda_device, *other, 8)
                systolic_matmul(oa, ob)
            got = pfam.fused_aged_matmul(a, b, xs, ws, 1e-3, 3)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 1024])
def test_cuda_bitflip_kernel_matches_plain(cuda_device, R):
    g = torch.Generator(device=cuda_device).manual_seed(R)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 128), dtype=torch.int32,
                      device=cuda_device, generator=g)
    u = torch.rand((R, 128), device=cuda_device, generator=g)
    pos = torch.randint(0, 32, (R, 128), dtype=torch.int32,
                        device=cuda_device, generator=g)
    got = bitflip_words(x, u, pos, 0.03)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bitflip_words_ref(x, u, pos, 0.03))
    assert bool((got != x).any())


def _words(dev, n, seed, offset=0):
    """``n`` random int32 words on ``dev``, starting ``offset`` words past a
    fresh allocation (16-byte aligned): offset 1 misaligns the base."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + offset,),
                        dtype=torch.int32, device=dev, generator=g)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("ber", [0.0, 1e-3, 0.3])
@pytest.mark.parametrize("n", [0, 1, 3, 127, 128, 4096, 8192, 16384,
                               32768, 131072, 262144, 2 ** 20 + 5])
def test_cuda_bitflip_draw_matches_plain(cuda_device, n, ber):
    """Draw mode vs its plain version on the card, bit for bit: aligned
    bases (vector words plus a scalar tail) and a base one word past the
    alignment (scalar words only), one launch per call."""
    q = pfam.upset_probability(ber)
    words = ops.flip_key_words(prandom.PRNGKey(n))
    for offset in (0, 1, 4):
        x = _words(cuda_device, n, n + offset, offset)
        kernels.reset_launch_counts()
        got = bitflip_draw(x, words, q)
        want = ref.bitflip_draw_ref(x, words, q)
        torch.cuda.synchronize()
        assert got.shape == x.shape and torch.equal(got, want)
        assert kernels.launch_counts()["bitflip_draw"] == (1 if n else 0)
        if ber == 0.0:
            assert torch.equal(got, x)
        elif n >= 4096:
            assert bool((got != x).any())


@pytest.mark.cuda
def test_cuda_inject_bitflips_is_one_launch(cuda_device):
    """``inject_bitflips`` on the serve path's qkt/sv shapes: one draw-mode
    launch per call and nothing else of the port's kernels, equal to the
    same call on the CPU."""
    shapes = [(2, 8, 4, 1, 64), (2, 8, 4, 1, 128), (2, 8, 4, 16, 16),
              (2, 8, 4, 16, 128),                      # llama3_8b
              (2, 4, 16, 1, 64), (2, 4, 16, 1, 128), (2, 4, 16, 16, 16),
              (2, 4, 16, 16, 64), (2, 4, 16, 16, 128)]  # qwen3_moe_235b
    kernels.reset_launch_counts()
    for i, shape in enumerate(shapes):
        g = torch.Generator().manual_seed(i)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                          generator=g)
        key = prandom.PRNGKey(i)
        got = ops.inject_bitflips(x.to(cuda_device), 1e-3, key)
        assert torch.equal(got.cpu(), ops.inject_bitflips(x, 1e-3, key))
    assert kernels.launch_counts() == {"fused_aged_matmul": 0,
                                       "fused_aged_matmul_lanes": 0,
                                       "fused_aged_matmul_shards": 0,
                                       "bitflip_words": 0,
                                       "bitflip_draw": len(shapes),
                                       "bitflip_draw_lanes": 0,
                                       "counter_upset_shards": 0,
                                       "systolic_matmul": 0}


@pytest.mark.cuda
def test_cuda_inject_and_aged_linear_match_cpu(cuda_device):
    """The three-pass injection and the fused route on the card agree with
    the same calls on the CPU bit for bit: threefry draws are
    device-independent and every float op on the route is one IEEE
    operation."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 33, 96), generator=g)
    w = torch.randn((96, 130), generator=g)
    key = prandom.PRNGKey(5)
    for kw in (dict(use_kernel=True, fused=True, seed=5),
               dict(use_kernel=True, fused=False, key=key)):
        cpu = ops.aged_linear(x, w, ber=1e-3, **kw)
        gpu = ops.aged_linear(x.to(cuda_device), w.to(cuda_device), ber=1e-3,
                              **kw)
        assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_cuda_router_aged_linear_matches_cpu(cuda_device, fused):
    """qwen3_moe_235b's router at its full shape (M = 2 decode tokens,
    K = 4096, N = 128 experts, a bf16 activation times the float32 router
    cast to bf16, as the MoE layer calls it): the card equals the CPU bit
    for bit on both kernel routes."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((2, 4096), generator=g).to(torch.bfloat16)
    w = (torch.randn((4096, 128), generator=g) * 4096 ** -0.5).to(
        torch.bfloat16)
    kw = (dict(seed=-123) if fused
          else dict(key=prandom.PRNGKey(123), fused=False))
    cpu = ops.aged_linear(x, w, ber=1e-3, **kw)
    gpu = ops.aged_linear(x.to(cuda_device), w.to(cuda_device), ber=1e-3,
                          **kw)
    assert gpu.dtype == torch.bfloat16 and torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
def test_cuda_uniform_and_gumbel_draws(cuda_device):
    """The sampler's draws on the card: uniforms on [tiny, 1) equal the
    CPU's bit for bit (integer hashing and one exact multiply-add); the
    Gumbel noise within 2 ulps of max(|g|, 1) (CUDA's and the CPU's log may
    differ in the last bit)."""
    key = prandom.PRNGKey(17)
    tiny = torch.finfo(torch.float32).tiny
    shape = (2, 151936)
    u_gpu = prandom.uniform(key, shape, tiny, 1.0, device=cuda_device)
    assert torch.equal(u_gpu.cpu(), prandom.uniform(key, shape, tiny, 1.0))
    g_gpu = prandom.gumbel(key, shape, device=cuda_device).cpu().double()
    g_cpu = prandom.gumbel(key, shape).double()
    ulp = torch.finfo(torch.float32).eps * torch.clamp_min(g_cpu.abs(), 1.0)
    assert bool(((g_gpu - g_cpu).abs() <= 2 * ulp).all())


# --------------------------------------------------------------------------- #
# lane modes (the fleet's lane-batched forward)
# --------------------------------------------------------------------------- #
LANE_COUNTS = [1, 3, 33]     # 33: more than one launch's worth of lanes


def _lane_params(L, seed):
    """Per-lane BERs (lane 1 at 0) and int32 seeds."""
    g = torch.Generator().manual_seed(seed)
    bers = [0.0 if l == 1 else float(10 ** (-3 + l % 3)) * 1e-1
            for l in range(L)]
    seeds = [int(s) for s in torch.randint(-2 ** 31, 2 ** 31 - 1, (L,),
                                           generator=g)]
    return bers, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("L", LANE_COUNTS)
@pytest.mark.parametrize("Ml,K,N", [(2, 4096, 1024), (32, 4096, 4096),
                                    (2, 96, 130), (5, 256, 512)])
def test_cuda_fused_lanes_match_plain_and_single_lanes(cuda_device, L, Ml,
                                                       K, N):
    """The fused GEMM's lane mode, int32 and dequantised, equals its plain
    lane version and L single-lane launches bit for bit, in
    ceil(L / MAX_LANES) launches (fast path, or the generic one for the
    ragged shape)."""
    a, b, xs, ws = _operands(cuda_device, L * Ml, K, N, L + Ml + K)
    bers, seeds = _lane_params(L, Ml)
    bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
    for xs_, ws_ in ((None, None), (xs, ws)):
        kernels.reset_launch_counts()
        got = pfam.fused_aged_matmul_lanes(a, b, xs_, ws_, bers, seeds,
                                           lanes=L, bm=bm, bn=bn)
        launches = kernels.launch_counts()["fused_aged_matmul_lanes"]
        want = ref.fused_aged_matmul_lanes_ref(a, b, xs_, ws_, bers, seeds,
                                               lanes=L, bm=bm, bn=bn)
        singles = torch.cat([pfam.fused_aged_matmul(
            a[l * Ml:(l + 1) * Ml], b,
            None if xs_ is None else xs_[l * Ml:(l + 1) * Ml], ws_, bers[l],
            seeds[l], bm=bm, bn=bn) for l in range(L)])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, singles)
        assert launches == -(-L // _cuda.MAX_LANES)
    clean = ref.systolic_matmul_ref(a, b)
    up = pfam.fused_aged_matmul_lanes(a, b, None, None, bers, seeds, lanes=L,
                                      bm=bm, bn=bn)
    if L > 1:
        assert torch.equal(up[Ml:2 * Ml], clean[Ml:2 * Ml])   # BER 0


@pytest.mark.cuda
@pytest.mark.parametrize("Ml", [32, 2])
@pytest.mark.parametrize("K,N", [(4096, 128), (4096, 512), (4096, 8192),
                                 (8192, 4096)],
                         ids=["router", "k/v", "q", "o"])
def test_cuda_moe_fleet_lane_gemm_matches_plain(cuda_device, Ml, K, N):
    """The MoE fleet's lane launches: qwen3_moe_235b's router, k/v, q and o
    (head_dim 128) with 4 lanes of B = 2 folded (M = 4 x 32 prefill, 4 x 2
    decode), int32 and dequantised, equal the plain lane version bit for
    bit, each in one launch on the fast path."""
    L = 4
    a, b, xs, ws = _operands(cuda_device, L * Ml, K, N, K + N + Ml)
    bers, seeds = _lane_params(L, Ml + N)
    bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
    for xs_, ws_ in ((None, None), (xs, ws)):
        kernels.reset_launch_counts()
        got = pfam.fused_aged_matmul_lanes(a, b, xs_, ws_, bers, seeds,
                                           lanes=L, bm=bm, bn=bn)
        by_path = kernels.launch_counts_by_path()["fused_aged_matmul_lanes"]
        want = ref.fused_aged_matmul_lanes_ref(a, b, xs_, ws_, bers, seeds,
                                               lanes=L, bm=bm, bn=bn)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert by_path == {"fast": 1, "generic": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("L", LANE_COUNTS)
@pytest.mark.parametrize("n", [1, 7, 4096, 8195])
def test_cuda_draw_lanes_match_plain_and_single_lanes(cuda_device, L, n):
    """The draw mode's lanes: each lane's words drawn from its own keys over
    its own word indices, equal to the plain lane version and to L
    single-lane launches, at aligned and misaligned bases (n = 7 and 8195
    put each lane's 16-byte head elsewhere), in ceil(L / MAX_LANES)
    launches."""
    bers, _ = _lane_params(L, n)
    qs = [pfam.upset_probability(b * 100) for b in bers]
    words = [ops.flip_key_words(k)
             for k in prandom.split(prandom.PRNGKey(n), L)]
    for offset in (0, 1):
        x = _words(cuda_device, L * n, n + offset, offset).reshape(L, n)
        kernels.reset_launch_counts()
        got = bitflip_draw_lanes(x, words, qs)
        launches = kernels.launch_counts()["bitflip_draw_lanes"]
        want = ref.bitflip_draw_lanes_ref(x, words, qs)
        singles = torch.stack([bitflip_draw(x[l].contiguous(), words[l],
                                            qs[l]) for l in range(L)])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, singles)
        assert launches == -(-L // _cuda.MAX_LANES)
        if L > 1:
            assert torch.equal(got[1], x[1])                   # BER 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_cuda_lane_aged_linear_matches_cpu(cuda_device, fused):
    """A lane-folded ``aged_linear`` (3 lanes of 2 x 4 rows) on the card
    equals the CPU bit for bit on both kernel routes, one lane-mode launch
    per call."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 4, 256), generator=g)
    w = torch.randn((256, 384), generator=g)
    bers = [1e-3, 0.0, 3e-3]
    kw = (dict(seed=[4, -5, 6]) if fused else
          dict(key=prandom.split(prandom.PRNGKey(7), 3), fused=False))
    cpu = ops.aged_linear(x, w, ber=bers, lanes=3, **kw)
    kernels.reset_launch_counts()
    gpu = ops.aged_linear(x.to(cuda_device), w.to(cuda_device), ber=bers,
                          lanes=3, **kw)
    counts = kernels.launch_counts()
    assert torch.equal(gpu.cpu(), cpu)
    assert counts["fused_aged_matmul_lanes" if fused
                  else "bitflip_draw_lanes"] == 1
    assert counts["fused_aged_matmul"] == counts["bitflip_draw"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("router,kw", [
    ("wear_level", {}), ("least_aged", {}),
    ("rest_to_recover", {"recovery_dynamics": True, "thermal": True})])
def test_cuda_cosim_matches_cpu(cuda_device, router, kw):
    """The traffic co-simulation on the card against the port on the CPU:
    the same Poisson trace (backend-exact samplers), supplies equal (every
    transcendental, multiply-add and sum is an explicit elementwise step),
    shifts (the monotone state and the effective totals) within 1e-4, the
    thermal node within 1e-5."""
    import numpy as np
    from repro_torch.core.artifacts import load_calibration
    from repro_torch.core.policy import FaultTolerantPolicy
    from repro_torch.core.resilience import OPERATORS
    from repro_torch.core.scenario import Scenario
    from repro_torch.sched import cosimulate, get_workload
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=3 * 365.25 * 24 * 3600.0,
        t_amb=torch.linspace(298.15, 328.15, 4))
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    wl = get_workload("diurnal", n_devices=4, utilization=0.55, n_epochs=96)
    loads = wl.loads(0, device=cuda_device)
    assert torch.equal(loads.cpu(), wl.loads(0, "cpu"))
    runs = [cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads,
                       router=router, n_devices=4, device=d, **kw)
            for d in (cuda_device, "cpu")]
    g, c = runs
    np.testing.assert_array_equal(g.V, c.V)
    for f in ("dv", "dvp", "dvn"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-4,
                                   atol=1e-6)
    if g.t_node is not None:
        np.testing.assert_allclose(g.t_node, c.t_node, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_fmath_pow_and_delay_sum_match_cpu(cuda_device):
    """``fmath.pow`` (glibc's powf from elementwise operations, its double
    multiply-adds exact) and the delay polynomial's explicit sum order give
    the CPU's bits on the card: no operation is contracted or reordered."""
    import numpy as np
    from repro_torch import fmath
    from repro_torch.core.artifacts import load_calibration
    rng = np.random.default_rng(0)
    n = 1 << 20
    x = np.concatenate([rng.uniform(0, 1000, n), 10.0 ** rng.uniform(
        -37, 38, n), rng.uniform(-5, 5, n)]).astype(np.float32)
    y = np.concatenate([rng.uniform(0.05, 20, n), rng.uniform(-4, 4, n),
                        rng.integers(-9, 10, n)]).astype(np.float32)
    sp = torch.tensor([0.0, -0.0, 1.0, -1.0, float("inf"), float("-inf"),
                       float("nan"), 1e-40, 2.5, -3.0])
    sx, sy = torch.meshgrid(sp, sp, indexing="ij")
    xt = torch.cat([torch.from_numpy(x), sx.reshape(-1)])
    yt = torch.cat([torch.from_numpy(y), sy.reshape(-1)])
    cpu = fmath.pow(xt, yt)
    gpu = fmath.pow(xt.to(cuda_device), yt.to(cuda_device)).cpu()
    same = (cpu.view(torch.int32) == gpu.view(torch.int32)) | (
        cpu.isnan() & gpu.isnan())
    assert bool(same.all())
    poly = load_calibration().delay_poly
    dp, dn = (torch.from_numpy(rng.uniform(0, 0.08, (64, 9)).astype(
        np.float32)) for _ in range(2))
    V = torch.from_numpy(rng.uniform(0.8, 1.0, (64, 9)).astype(np.float32))
    want = poly(dp, dn, V)
    got = poly.to(cuda_device)(dp.to(cuda_device), dn.to(cuda_device),
                               V.to(cuda_device)).cpu()
    assert torch.equal(got, want)


def _sweep_losses(dev, chunk, plain=False):
    """One seed of a 40-lane grid (8 BERs x the 5 weight-side domains q, k,
    v, qkt, down) on reduced llama3_8b (float32, seed 0), fused route, on
    ``dev``; ``plain`` swaps the wrappers for their plain versions (on the
    same card tensors)."""
    import numpy as np
    from repro_torch.calibrate import resilience_sweep as rs
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_params
    cfg = get_config("llama3_8b").reduced()
    from repro_torch.tree import tree_map
    params = tree_map(lambda x: x.to(dev), init_params(
        cfg, seed=0, dtype=torch.float32, device="cpu"))
    tokens = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                         global_batch=2).batch_at(0).tokens
    grid = tuple(float(b) for b in np.logspace(-5, -1.5, 8))
    saved = (ops._fused_aged_matmul_kernel, ops.fused_aged_matmul_lanes,
             ops.bitflip_draw, ops.bitflip_draw_lanes)
    if plain:
        (ops._fused_aged_matmul_kernel, ops.fused_aged_matmul_lanes,
         ops.bitflip_draw, ops.bitflip_draw_lanes) = (
            ref.fused_aged_matmul_ref, ref.fused_aged_matmul_lanes_ref,
            ref.bitflip_draw_ref, ref.bitflip_draw_lanes_ref)
    try:
        kernels.reset_launch_counts()
        res = rs.run_sweep(cfg, params, tokens, ber_grid=grid,
                           operators=("q", "k", "v", "qkt", "down"),
                           n_seeds=1, use_kernel=True, fused=True,
                           chunk=chunk, device=dev)
        return res.loss_pct, kernels.launch_counts(), cfg.n_layers
    finally:
        (ops._fused_aged_matmul_kernel, ops.fused_aged_matmul_lanes,
         ops.bitflip_draw, ops.bitflip_draw_lanes) = saved


@pytest.mark.cuda
def test_cuda_sweep_grid_matches_plain(cuda_device):
    """A 40-lane reduced grid on the fused lane kernels equals the same
    sweep through the plain versions on the card; one forward of 40 lanes
    makes two launches a faulted op (the 32-lane split)."""
    got, counts, L = _sweep_losses(cuda_device, 40)
    want, plain_counts, _ = _sweep_losses(cuda_device, 40, plain=True)
    assert (got == want).all()
    assert counts["fused_aged_matmul_lanes"] == 7 * L * 2
    assert counts["bitflip_draw_lanes"] == 2 * L * 2
    assert plain_counts["fused_aged_matmul_lanes"] == 0
    assert ((got >= 0) & (got <= 100)).all() and got.max() > 0


@pytest.mark.cuda
def test_cuda_sweep_chunk_changes_no_loss(cuda_device):
    """The same grid at 8 and at 40 lanes a forward."""
    a, ca, L = _sweep_losses(cuda_device, 8)
    b, cb, _ = _sweep_losses(cuda_device, 40)
    assert (a == b).all()
    assert ca["fused_aged_matmul_lanes"] == 7 * L * 5


@pytest.mark.cuda
def test_cuda_argmax_takes_the_first_maximum(cuda_device):
    """The sweep's predictions: ties and +inf go to the first maximal
    index and NaN counts as the maximum, as ``jnp.argmax`` (numpy's rule)."""
    import numpy as np
    x = np.array([[1.0, 3.0, 3.0, 2.0], [np.inf, 1.0, np.inf, 0.0],
                  [0.0, np.nan, 5.0, np.nan], [-np.inf, -np.inf, -1.0, -1.0],
                  [2.0, 2.0, 2.0, 2.0]], np.float32)
    got = torch.as_tensor(x, device=cuda_device).argmax(dim=-1).cpu()
    assert got.tolist() == np.argmax(x, axis=-1).tolist()


# the shapes the hybrid, SSM, VLM and enc-dec families add, prefill (B = 2
# x 16 tokens) and decode (M 2), with every K-split plan among them (an
# uneven last split at rwkv's K 8,960, paligemma's decode K 16,384 and
# whisper's decode K 1,280 / 5,120): recurrentgemma's MQA k/v (N 256),
# q and rec projections, gate/up (N 7,680) and down (K 7,680, also at its
# 2,064-token prompt); rwkv's up (N 8,960) and down (K 8,960, also at its
# 300-token prompt); paligemma's prefill (M 544 = 2 x (256 + 16)) gate/up
# and down (K 16,384); whisper's encoder (M 3,000 = 2 x 1,500 frames) and
# decoder at K 1,280 / 5,120
FAMILY_SHAPES = [(32, 2560, 256), (2, 2560, 2560), (32, 2560, 7680),
                 (32, 7680, 2560), (2064, 7680, 2560), (32, 2560, 8960),
                 (32, 8960, 2560), (300, 8960, 2560), (544, 2048, 16384),
                 (544, 16384, 2048), (2, 16384, 2048), (3000, 1280, 1280),
                 (3000, 1280, 5120), (3000, 5120, 1280), (2, 1280, 1280),
                 (2, 5120, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", FAMILY_SHAPES)
def test_cuda_fused_gemm_family_shapes(cuda_device, M, K, N):
    """The fused GEMM at the new families' shapes, on the fast path, bit
    for bit against its plain version."""
    a, b, xs, ws = _operands(cuda_device, M, K, N, seed=M + K + N)
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    kernels.reset_launch_counts()
    got = pfam.fused_aged_matmul(a, b, xs, ws, 1e-3, 7, bm=bm, bn=bn)
    assert kernels.launch_counts_by_path()["fused_aged_matmul"] == {
        "fast": 1, "generic": 0}
    want = ref.fused_aged_matmul_ref(a, b, xs, ws, 1e-3, 7, bm=bm, bn=bn)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1280, 1280), (1280, 5120), (5120, 1280)],
                         ids=["q/k/v/o", "up", "down"])
def test_cuda_family_fleet_lane_gemm_matches_plain(cuda_device, K, N):
    """The lane GEMM at whisper's 4-lane fleet encoder (4 lanes of 3,000
    rows), int32 and dequantised, equals the plain lane version and 4
    single-lane launches bit for bit, in one launch on the fast path."""
    L, Ml = 4, 3000
    a, b, xs, ws = _operands(cuda_device, L * Ml, K, N, K + N)
    bers, seeds = _lane_params(L, K * N)
    bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
    for xs_, ws_ in ((None, None), (xs, ws)):
        kernels.reset_launch_counts()
        got = pfam.fused_aged_matmul_lanes(a, b, xs_, ws_, bers, seeds,
                                           lanes=L, bm=bm, bn=bn)
        by_path = kernels.launch_counts_by_path()["fused_aged_matmul_lanes"]
        want = ref.fused_aged_matmul_lanes_ref(a, b, xs_, ws_, bers, seeds,
                                               lanes=L, bm=bm, bn=bn)
        singles = torch.cat([pfam.fused_aged_matmul(
            a[l * Ml:(l + 1) * Ml], b,
            None if xs_ is None else xs_[l * Ml:(l + 1) * Ml], ws_, bers[l],
            seeds[l], bm=bm, bn=bn) for l in range(L)])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, singles)
        assert by_path == {"fast": 1, "generic": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_3b",
                                  "paligemma_3b", "whisper_large_v3"])
def test_cuda_family_generate_matches_cpu(cuda_device, arch):
    """A reduced model of each new family on the card's kernel route gives
    the CPU's greedy tokens at BER 1e-3 on every domain."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import family
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_map

    class Forced:
        age_years = 9.0

        def op_bers(self):
            return dict.fromkeys(("q", "k", "v", "qkt", "sv", "o", "gate",
                                  "up", "down", "r", "g"), 1e-3)

        def total_power(self):
            return 0.0

    cfg = get_config(arch).reduced()
    p_cpu = family.init_params(cfg, seed=1, dtype=torch.float32,
                               device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (2, 10))
    name = family.extra_name(cfg)
    extra = {} if name is None else {name: rng.normal(
        size=(2,) + family.extra_shape(cfg)).astype(np.float32)}
    out = [ServeEngine(cfg, p, runtime=Forced(), max_len=32,
                       use_systolic_kernel=True, seed=4, device=d)
           .generate(prompts, 5, **extra).tokens
           for p, d in ((p_gpu, cuda_device), (p_cpu, "cpu"))]
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"window": 512}, {"prefix_len": 256}],
                         ids=["causal", "window", "prefix"])
def test_cuda_chunked_attention_matches_cpu(cuda_device, kw):
    """ROADMAP C.6: chunked attention (a clean call of 2,064 queries, the
    keys padded to whole chunks) on the card against its CPU result, in
    float32 (TF32 off) and bf16; and the card's own full attention."""
    from repro_torch.models import attention as attn
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(21)
        q = torch.randn((1, 2064, 4, 64), generator=gen) * 2
        k = torch.randn((1, 2064, 2, 64), generator=gen) * 2
        v = torch.randn((1, 2064, 2, 64), generator=gen)
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            args = [x.to(dtype) for x in (q, k, v)]
            want = attn.attention(*args, **kw).float()
            got = attn.attention(*(x.to(cuda_device) for x in args),
                                 **kw).float().cpu()
            assert float((got - want).abs().max()) <= atol
            if dtype == torch.bfloat16:
                assert float((got != want).float().mean()) <= 0.01
        full = attn.full_attention(*(x.to(cuda_device) for x in (q, k, v)),
                                   **kw).cpu()
        assert float((full - attn.chunked_attention(q, k, v, **kw)).abs()
                     .max()) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_cuda_chunked_attention_refuses_tf32(cuda_device):
    from repro_torch.models import attention as attn
    q = torch.zeros((1, 2048, 2, 16), device=cuda_device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(NotImplementedError, match="TF32"):
            attn.attention(q, q[:, :, :1], q[:, :, :1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_cuda_kernel_bench_quick_rows_are_exact(cuda_device):
    """``kernel_bench --quick`` on the card: its GEMM and draw rows equal
    their plain versions, the GEMM on the fast path, each row timed."""
    from repro_torch.benchmarks import kernel_bench
    res = kernel_bench.evaluate(device="cuda", quick=True)
    rows = res["rows"]["rows"]
    assert [r["kernel"] for r in rows] == ["fused_aged_matmul",
                                           "bitflip_draw"]
    assert all(r["exact"] and r["ms"] > 0 for r in rows)
    assert rows[0]["fast_path"] and rows[0]["library_ms"] > 0
    assert all(c["ok"] for c in res["checks"])


# the online slots' GEMMs at llama3_8b's widths: decode M = 8 (8 slots),
# refill M = 128 (8 x 16-token prompts); the fleet's 4 lanes of 4 and of 64
ONLINE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", ONLINE_KN)
@pytest.mark.parametrize("M", [8, 128])
def test_cuda_online_gemm_shapes_match_plain(cuda_device, M, K, N):
    a, b, xs, ws = _operands(cuda_device, M, K, N, M + N)
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    kernels.reset_launch_counts()
    got = pfam.fused_aged_matmul(a, b, xs, ws, 1e-3, 77, bm=bm, bn=bn)
    assert kernels.launch_counts_by_path()["fused_aged_matmul"] == {
        "fast": 1, "generic": 0}
    assert torch.equal(got, ref.fused_aged_matmul_ref(a, b, xs, ws, 1e-3,
                                                      77, bm=bm, bn=bn))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", ONLINE_KN)
@pytest.mark.parametrize("Ml", [4, 64])
def test_cuda_online_fleet_gemm_shapes_match_plain(cuda_device, Ml, K, N):
    L = 4
    a, b, xs, ws = _operands(cuda_device, L * Ml, K, N, Ml + N)
    bers, seeds = [1e-3, 0.0, 3e-3, 1e-2], [11, 12, 13, 14]
    bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
    kw = dict(lanes=L, bm=bm, bn=bn)
    got = pfam.fused_aged_matmul_lanes(a, b, xs, ws, bers, seeds, **kw)
    assert torch.equal(got, ref.fused_aged_matmul_lanes_ref(
        a, b, xs, ws, bers, seeds, **kw))


@pytest.mark.cuda
def test_cuda_online_full_width_short_run(cuda_device):
    """llama3_8b's widths on 2 layers, a 9-year device on the kernel
    route: the no-arrival online run gives ``generate``'s tokens, and a
    schedule with mid-decode arrivals makes 7 fused-GEMM and 2 draw
    launches a layer and forward, on the fast path."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.online import OnlineServeEngine, Request

    class Forced:
        age_years = 9.0

        def total_power(self):
            return 0.0

        def op_bers(self):
            return {op: 1e-3 for op in ("q", "k", "v", "qkt", "sv", "o",
                                        "gate", "up", "down")}

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=2)
    params = init_params(cfg, seed=0, device=cuda_device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32)
    kw = dict(max_len=40, seed=2, use_systolic_kernel=True,
              device=cuda_device)
    want = ServeEngine(cfg, params, runtime=Forced(), **kw).generate(
        prompts, 9, temperature=0.7).tokens
    eng = OnlineServeEngine(cfg, params, runtime=Forced(), n_slots=4,
                            max_new_cap=16, chunk_steps=4, **kw)
    got = eng.serve([Request(id=i, prompt=prompts[i], max_new=9)
                     for i in range(4)], greedy=False, temperature=0.7)
    np.testing.assert_array_equal(
        np.stack([r.tokens for r in sorted(got.completed,
                                           key=lambda r: r.id)]), want)
    kernels.reset_launch_counts()
    res = eng.serve([Request(id=i, prompt=prompts[i % 4], max_new=3 + i,
                             arrival=2 * i) for i in range(6)],
                    greedy=True)
    t = res.timings
    forwards = t["n_refills"] + t["n_chunks"] * eng.chunk_steps
    counts = kernels.launch_counts()
    assert res.n_completed == 6
    assert counts["fused_aged_matmul"] == 7 * 2 * forwards
    assert counts["bitflip_draw"] == 2 * 2 * forwards
    assert kernels.launch_counts_by_path()["fused_aged_matmul"] == {
        "fast": 7 * 2 * forwards, "generic": 0}


# mesh serving (per-shard BERs): llama3_8b's weight GEMMs (q/o, k/v,
# gate/up, down; the unembed's vocab 128,256, whose 4 blocks of 32,064 end
# in a partial 256-column tile) at decode, prefill and M = 544
SHARD_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
            (4096, 128256))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [3, 4, 8])
@pytest.mark.parametrize("M", [2, 32, 544])
def test_cuda_shard_gemm_matches_plain(cuda_device, M, S):
    """The shard mode (one launch for S column blocks, each at its own
    BER and stream over its block-local tiles) bit-exact against its plain
    version, int32 and dequantised, on the fast path; uneven blocks at
    S = 3."""
    bers = tuple(1e-3 * (1 + s) for s in range(S))
    seeds = [ops.fold_seed(-77, s) for s in range(S)]
    for K, N in SHARD_KN:
        if M == 544 and N == 128256:
            continue                     # 0.6 GB of plain-version temporaries
        a, b, xs, ws = _operands(cuda_device, M, K, N, M + S + N)
        kernels.reset_launch_counts()
        for xs_, ws_ in ((None, None), (xs, ws)):
            got = pfam.fused_aged_matmul_shards(a, b, xs_, ws_, bers, seeds)
            want = ref.fused_aged_matmul_shards_ref(
                a, b, xs_, ws_, bers, seeds, pfam.shard_bounds(N, S))
            assert got.dtype == want.dtype and torch.equal(got, want), \
                (M, K, N, S)
        assert kernels.launch_counts()["fused_aged_matmul_shards"] == 2
        assert kernels.launch_counts_by_path()[
            "fused_aged_matmul_shards"]["fast"] == 2


@pytest.mark.cuda
def test_cuda_shard_gemm_generic_path_and_refusals(cuda_device):
    """A ragged shape takes the generic path in shard mode, exact; more
    shards than a launch takes are refused."""
    a, b, xs, ws = _operands(cuda_device, 33, 96, 130, 1)
    bers = (1e-2, 2e-2, 3e-2)
    seeds = [ops.fold_seed(5, s) for s in range(3)]
    got = pfam.fused_aged_matmul_shards(a, b, xs, ws, bers, seeds)
    want = ref.fused_aged_matmul_shards_ref(a, b, xs, ws, bers, seeds,
                                            pfam.shard_bounds(130, 3))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shards"):
        pfam.fused_aged_matmul_shards(a, b, None, None, (0.0,) * 33,
                                      [0] * 33)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [
    ((2, 32, 16, 16), 1), ((2, 32, 1, 17), 1), ((2, 20, 64, 1500), 1),
    ((2, 3, 5, 7), 1), ((2, 32, 1100, 8), 1), ((32, 14336), -1),
    ((2, 128256), -1), ((5, 3), -1)])
@pytest.mark.parametrize("S", [3, 4, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_counter_upset_matches_plain(cuda_device, shape, axis, S,
                                          offset):
    """The counter-upset kernel against its plain version on both splits:
    llama's qkt/sv heads at prefill and decode, whisper-like encoder rows,
    fewer heads than shards, rows past 65,535 (70,400 of 8 words), and
    column splits (uneven, partial tiles, shard bounds off a multiple of 4
    at (32, 14336) over 3); rows of D not a multiple of 4 start off a
    16-byte boundary, and ``offset`` 1 starts the input one word into its
    storage (a contiguous view the output's alignment does not share)."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + S)
    n = math.prod(shape)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + offset,), dtype=torch.int32,
                      device=cuda_device, generator=g)[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    bers = tuple(2e-3 * (1 + s) for s in range(S))
    kernels.reset_launch_counts()
    got = ops.inject_bitflips_sharded(x, bers, seed=-1234, axis=axis,
                                      use_kernel=True)
    want = ops.inject_bitflips_sharded(x, bers, seed=-1234, axis=axis)
    assert torch.equal(got, want)
    assert kernels.launch_counts()["counter_upset_shards"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_cuda_dp_steps_match_cpu(cuda_device, backend, world):
    """``make_dp_train_step`` on the card (one NCCL rank, or two gloo ranks
    sharing it) against the same ranks on the CPU (gloo), reduced
    llama3_8b, 3 steps compressed and plain: the compressed mean's int32
    sums of the same gradients equal; the first loss within 1e-5; the
    plain run's losses within 1e-5 and params within 2e-4 (the training
    tests' tolerances); the compressed run's later losses within 1e-3 and
    params within 3 steps of lr (a gradient an ulp apart can round to the
    next int8 step: tests/test_torch_dp_train.py)."""
    import numpy as np
    import torch_dist_ranks as ranks
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.train.steps import init_train_state
    from repro_torch.tree import flatten
    cfg = get_config("llama3_8b").reduced()
    params = {k: v.numpy() for k, v in flatten(
        init_train_state(cfg, 1, device="cpu").params).items()}
    rng = np.random.default_rng(world)
    grads = {k: rng.standard_normal((world,) + v.shape).astype(np.float32)
             for k, v in params.items()}
    runs = {dev: run_local_ranks(
        ranks.dp_rank, world, "llama3_8b", params, (True, False),
        ranks.DP_STEPS, grads, backend=backend if dev == "cuda" else "gloo",
        device=dev, timeout=300) for dev in ("cuda", "cpu")}
    lr = ranks.DP_OPT["lr"]
    for r in range(world):
        card, cpu = runs["cuda"][r], runs["cpu"][r]
        assert len(card["sums"]) == len(params)
        for a, b in zip(card["sums"], cpu["sums"]):
            np.testing.assert_array_equal(a, b)
        for compress in (True, False):
            got, want = card[compress], cpu[compress]
            np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-3 if compress else 1e-5)
            for k, v in got["params"].items():
                np.testing.assert_allclose(
                    v, want["params"][k], rtol=0,
                    atol=3 * lr if compress else 2e-4, err_msg=k)
            assert got["params"].keys() == runs["cuda"][0][compress][
                "params"].keys()
        for k, v in card[True]["params"].items():      # replicated
            np.testing.assert_array_equal(v, runs["cuda"][0][True]
                                          ["params"][k])


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_cuda_mesh_ranks_match_one_device(cuda_device, backend, world):
    """``MeshServeEngine`` over ``world`` ranks on the card at tp = world
    (one NCCL rank, or two gloo ranks sharing it), reduced llama3_8b in
    float32, a shard fleet, greedy and sampled on the fused and the plain
    route: every rank's tokens equal the one-device engine's on the card
    at the same tp, which equal the CPU's.  On the fused route a rank
    launches one fused GEMM a faulted weight product (on its column
    block at tp = 2, where every reduced width divides; the shard mode
    on its one shard at tp = 1) and one counter-upset kernel a qkt/sv
    injection; two gloo ranks stage their gathers through host memory
    (gloo gathers no CUDA tensor), one rank gathers nothing."""
    import numpy as np
    import torch_dist_ranks as ranks
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.models import family
    from repro_torch.serve.sharded import MeshServeEngine
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3_8b").reduced()
    L, n = cfg.n_layers, 4
    params = family.init_params(cfg, 1, torch.float32, device="cpu")
    p = np.random.default_rng(world).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    runs = [dict(tp=world, fleet="plain", fused=f, seed=seed, prompts=p, n=n,
                 kw=kw) for seed, kw in ((0, {}), (3, dict(temperature=0.8,
                                                          top_k=8)))
            for f in (True, False)]
    jobs = {"llama3_8b": {"params": {k: v.numpy() for k, v in flatten(
        params).items()}, "runs": runs}}
    out = run_local_ranks(ranks.mesh_serve_rank, world, jobs,
                          backend=backend, device="cuda", timeout=300)
    gemm = "fused_aged_matmul" if world > 1 else "fused_aged_matmul_shards"
    for i, run in enumerate(runs):
        want = {}
        for dev in ("cuda", "cpu"):
            eng = MeshServeEngine(
                cfg, params, tp=world, fleet=ranks.shard_fleet(world, dev),
                max_len=32, seed=run["seed"], serve_dtype=torch.float32,
                use_fused_kernel=run["fused"], device=dev)
            want[dev] = eng.generate(p, n, **run["kw"]).tokens
        np.testing.assert_array_equal(want["cuda"], want["cpu"])
        for r in range(world):
            rec = out[r]["llama3_8b"]["runs"][i]
            np.testing.assert_array_equal(rec["tokens"], want["cuda"])
            c = rec["launches"]
            if run["fused"]:
                assert c == {**dict.fromkeys(c, 0), gemm: 7 * L * n,
                             "counter_upset_shards": 2 * L * n}, c
            else:
                assert not any(c.values()), c
            g = rec["gathers"]
            assert g["calls"] == (7 * L + 2) * n * (world > 1)
            assert (g["staged_bytes"] > 0) == (world > 1)
