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
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitflip import bitflip_words
from repro_torch.kernels.systolic_matmul import systolic_matmul


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(2, 4096, 1024), (32, 4096, 14336),
                                   (2, 14336, 4096), (33, 96, 130),
                                   (7, 5, 3), (300, 257, 513)])
def test_cuda_gemm_kernels_match_plain(cuda_device, M, K, N):
    """Main-path decode/prefill shapes and ragged ones, BER 1e-3: int32 and
    float32 outputs bit-exact, one launch per wrapper call."""
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    a = torch.randint(-128, 128, (M, K), dtype=torch.int8,
                      device=cuda_device, generator=g)
    b = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                      device=cuda_device, generator=g)
    xs = torch.rand((M, 1), device=cuda_device, generator=g) + 0.5
    ws = torch.rand((1, N), device=cuda_device, generator=g) + 0.5
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    kernels.reset_launch_counts()
    assert torch.equal(systolic_matmul(a, b), ref.systolic_matmul_ref(a, b))
    for xs_, ws_ in ((None, None), (xs, ws)):
        got = pfam.fused_aged_matmul(a, b, xs_, ws_, 1e-3, -77, bm=bm, bn=bn)
        want = ref.fused_aged_matmul_ref(a, b, xs_, ws_, 1e-3, -77, bm=bm,
                                         bn=bn)
        assert got.dtype == want.dtype and torch.equal(got, want)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"fused_aged_matmul": 2,
                                       "bitflip_words": 0,
                                       "systolic_matmul": 1}


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
