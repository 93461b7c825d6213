"""Each CUDA kernel of the port vs its plain PyTorch version, on the card.

Marked ``cuda``; every test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither jax nor the reference package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch import random as prandom
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels.bitflip import bitflip_words
from repro_torch.kernels.systolic_matmul import systolic_matmul


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# the serve path's weight GEMMs (llama3_8b, B=2: M = 2 decode, 32 prefill)
MAIN = [(M, K, N) for M in (2, 32)
        for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096))]
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
                                       "bitflip_words": 0,
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
