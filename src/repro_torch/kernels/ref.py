"""Plain PyTorch versions of the kernels (the ``repro.kernels.ref``
counterparts, the bitflip pass's draw mode, the lane modes — each the
single-lane version applied to every lane's slice — the GEMM's shard mode
— the single-device version's upsets on every column block alone — and the
counter-stream upsets under per-shard BERs).

The wrappers take them for CPU tensors; ``chip_smoke.py`` and the
``cuda``-marked tests hold each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from .. import random as prandom
from ..random import M32
from .fused_aged_matmul import (block_tile, counter_bits, tile_counter_bits,
                                upset_probability, upset_words)


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


def bitflip_draw_ref(x: torch.Tensor, key_words, q: float,
                     index: torch.Tensor | None = None) -> torch.Tensor:
    """The bit-flip pass drawing its own randoms: word ``i`` of the flat
    ``x`` takes ``u`` from word ``i`` of a uniform draw of the key
    ``key_words[:2]`` and ``pos`` from word ``i`` of a bits draw of the key
    ``key_words[2:]``, ``& 31`` — the words the reference draws for it over
    its padded layout, with no padding.  ``index`` (int64, ``x``'s shape)
    gives each word's index in a larger tensor ``x`` is a block of, whose
    draws it then takes."""
    ku0, ku1, kl0, kl1 = (int(k) & M32 for k in key_words)
    index = torch.arange(x.numel(), dtype=torch.int64, device=x.device) \
        if index is None else index.reshape(-1)
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


def fused_aged_matmul_shards_ref(a: torch.Tensor, b: torch.Tensor, xs, ws,
                                 bers, seeds, bounds) -> torch.Tensor:
    """The exact int32 product, each column block ``[bounds[s], bounds[s +
    1])`` upset alone as the single-device kernel upsets a ``(M, W_s)``
    product (its own logical tile, ``bers[s]``, ``seeds[s]``), then the
    optional ``(acc * xs) * ws`` dequant."""
    acc = systolic_matmul_ref(a, b)
    M = acc.shape[0]
    blocks = []
    for s in range(len(bers)):
        blk = acc[:, bounds[s]:bounds[s + 1]]
        bm, bn, _ = block_tile(M, blk.shape[1])
        bits = tile_counter_bits(M, blk.shape[1], seeds[s], bm=bm, bn=bn,
                                 device=acc.device)
        blocks.append(upset_words(blk, bits, upset_probability(bers[s])))
    acc = torch.cat(blocks, dim=1)
    if xs is None:
        return acc
    return acc.to(torch.float32) * xs.to(torch.float32) \
        * ws.to(torch.float32)


def counter_upset_shards_ref(x: torch.Tensor, qs, seeds, tables
                             ) -> torch.Tensor:
    """Counter-stream upsets of ``x`` viewed as ``(R, D)`` over the shard
    tables of :func:`repro_torch.kernels.ops.shard_upset_tables`: each
    word's shard, block-local row and column and its block's tile, worked
    out per word as the reference's ``inject_bitflips_sharded`` does."""
    D = x.shape[-1]
    R = x.numel() // D
    dev = x.device
    bounds = torch.as_tensor(tables["bounds"], dtype=torch.int64,
                             device=dev)
    col = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)
    row = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    if tables["by_row"]:
        mid, n_ax = tables["mid"], tables["n_ax"]
        h = (row // mid) % n_ax
        sid = torch.searchsorted(bounds[1:-1], h, right=True)
        widths = bounds[1:] - bounds[:-1]
        lrow = ((row // (mid * n_ax)) * widths[sid] + (h - bounds[sid])) \
            * mid + row % mid
        lcol = c
    else:
        sid = torch.searchsorted(bounds[1:-1], c, right=True)
        lrow, lcol = row, c - bounds[sid]
    bm, bn, grid = (col(tables[k])[sid] for k in ("bms", "bns", "grids"))
    tile = (lrow // bm) * grid + lcol // bn
    offset = (lrow % bm) * bn + lcol % bn
    bits = counter_bits(offset, col([int(v) & M32 for v in seeds])[sid],
                        tile)
    q = torch.as_tensor(list(qs), dtype=torch.float32, device=dev)[sid]
    return upset_words(x.reshape(R, D), bits, q).reshape(x.shape)
