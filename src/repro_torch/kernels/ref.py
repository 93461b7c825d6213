"""Plain PyTorch versions of the kernels (the ``repro.kernels.ref``
counterparts, the bitflip pass's draw mode, and the lane modes: each the
single-lane version applied to every lane's slice).

The wrappers take them for CPU tensors; ``chip_smoke.py`` and the
``cuda``-marked tests hold each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from .. import random as prandom
from ..random import M32
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


def bitflip_draw_ref(x: torch.Tensor, key_words, q: float) -> torch.Tensor:
    """The bit-flip pass drawing its own randoms: word ``i`` of the flat
    ``x`` takes ``u`` from word ``i`` of a uniform draw of the key
    ``key_words[:2]`` and ``pos`` from word ``i`` of a bits draw of the key
    ``key_words[2:]``, ``& 31`` — the words the reference draws for it over
    its padded layout, with no padding."""
    ku0, ku1, kl0, kl1 = (int(k) & M32 for k in key_words)
    index = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    u = prandom.float_from_bits(prandom.bits_at(ku0, ku1, index))
    pos = (prandom.bits_at(kl0, kl1, index) & 31).to(torch.int32)
    return bitflip_words_ref(x.reshape(-1), u, pos, q).reshape(x.shape)


def bitflip_draw_lanes_ref(x: torch.Tensor, key_words, qs) -> torch.Tensor:
    """The single-lane draw on each lane ``x[l]``, with its own key words
    and ``q``."""
    return torch.stack([bitflip_draw_ref(x[l], key_words[l], qs[l])
                        for l in range(x.shape[0])]).reshape(x.shape)


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


def fused_aged_matmul_lanes_ref(a: torch.Tensor, b: torch.Tensor, xs, ws,
                                bers, seeds, *, lanes: int, bm: int = 256,
                                bn: int = 256) -> torch.Tensor:
    """The single-lane plain version on each lane's ``M / lanes`` rows of
    ``a`` (and ``xs``), with the lane's BER and seed."""
    rows = a.shape[0] // lanes
    part = lambda t, l: None if t is None else t[l * rows:(l + 1) * rows]
    return torch.cat([fused_aged_matmul_ref(part(a, l), b, part(xs, l), ws,
                                            bers[l], seeds[l], bm=bm, bn=bn)
                      for l in range(lanes)])
