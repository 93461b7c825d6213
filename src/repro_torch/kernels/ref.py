"""Plain PyTorch versions of the three kernels (the ``repro.kernels.ref``
counterparts).

The wrappers take them for CPU tensors; ``chip_smoke.py`` and the
``cuda``-marked tests hold each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from .fused_aged_matmul import tile_counter_bits, upset_probability, upset_words


def systolic_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 matmul.

    Computed as a float64 matmul: every product and partial sum is an
    integer below ``K * 128**2 < 2**53``, so the result is exact in any
    summation order and on any device (CUDA has no int32 matmul).
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def bitflip_words_ref(x: torch.Tensor, u: torch.Tensor, pos: torch.Tensor,
                      q: float) -> torch.Tensor:
    """The bit-flip pass on identical random inputs."""
    mask = torch.ones_like(pos) << pos
    return torch.where(u < q, x ^ mask, x)


def fused_aged_matmul_ref(a: torch.Tensor, b: torch.Tensor, xs, ws, ber,
                          seed, *, bm: int = 256,
                          bn: int = 256) -> torch.Tensor:
    """Counter-stream upsets over the logical ``(bm, bn)`` tiling, then the
    optional ``(acc * xs) * ws`` dequant — any ``(M, N)``."""
    acc = systolic_matmul_ref(a, b)
    M, N = acc.shape
    bits = tile_counter_bits(M, N, seed, bm=bm, bn=bn, device=acc.device)
    acc = upset_words(acc, bits, upset_probability(ber))
    if xs is None:
        return acc
    return acc.to(torch.float32) * xs.to(torch.float32) \
        * ws.to(torch.float32)
