"""Fused int8 matmul + accumulator bit upsets + dequant, on Hopper.

Replaces the Pallas TPU kernel
``repro/kernels/fused_aged_matmul.py::fused_aged_matmul`` (body
``_fused_kernel``, injector ``_inject``): ``a (M, K) int8 @ b (K, N) int8``
into int32, each accumulator word upset at its flush with probability
``q = 1 - (1 - ber)**32`` (one bit, drawn from the counter stream), then
optionally dequantised as ``(float(acc) * xs[r]) * ws[c]``.

The CUDA kernel is ``csrc/aged_kernels.cu`` in modes 1 and 2.  It is
bound by the bytes of ``b`` on the serve path (decode at M = 2 reads the
whole weight to make two rows).  Every serve-path shape takes the fast
path (``int8_gemm_tc_kernel``): K split over all SMs by
:func:`repro_torch.kernels._cuda.gemm_plan`, a ring of asynchronous copies
and int8 tensor cores, with the upset and dequant run once per word after
the last split's partial; other shapes take the generic masked path
(``int8_gemm_kernel``).  ``launches_by_path`` counts both.  The design
note is in the source.  The TPU path's on-core PRNG has no counterpart:
the stream below is the reference's interpret-mode stream, so kernel and
plain version (:func:`repro_torch.kernels.ref.fused_aged_matmul_ref`)
agree bit for bit.  :func:`fused_aged_matmul_lanes` is the lane mode the
fleet serving engine launches: the rows of several devices against one
weight, each lane with its own seed and BER.  :func:`fused_aged_matmul_shards`
is the shard (column-block) mode mesh serving launches: the counterpart of
the Pallas kernel under ``shard_map`` over the output columns, each shard's
block upset at its own BER from its own stream over its block-local tile
grid, in one launch that reads the weight once for every shard.

The stream functions take Python ints and ``int64`` tensors holding uint32
values alike (see :mod:`repro_torch.random` for the masking convention).
"""
from __future__ import annotations

import functools

import torch

from ..random import M32, mul32
from . import _cuda


def fmix32(x):
    """murmur3 finalizer on uint32 — the counter stream's mixing step."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stream_constant(seed, tile_id):
    """Per-(seed, tile) stream id, mixed so nearby seeds never alias."""
    return fmix32(mul32(seed, 0x9E3779B1) ^ mul32(tile_id, 0x7FEB352D))


def counter_bits(offset, seed, tile_id):
    """One uint32 draw per word: hash(word offset, hash(seed, tile))."""
    return fmix32(mul32(offset, 0x9E3779B9) ^ stream_constant(seed, tile_id))


def tile_counter_bits(M: int, N: int, seed: int, *, bm: int, bn: int,
                      device="cpu") -> torch.Tensor:
    """Draws for a live ``(M, N)`` block in the logical ``(bm, bn)`` tiling.

    ``tile_id = (r // bm) * grid_n + c // bn`` with ``grid_n`` counted over
    the padded grid, ``offset = (r % bm) * bn + c % bn`` — what every tile's
    flush computes, without materialising the pad region.
    """
    grid_n = -(-N // bn)
    row = torch.arange(M, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(N, dtype=torch.int64, device=device)[None, :]
    tile_id = (row // bm) * grid_n + col // bn
    offset = (row % bm) * bn + col % bn
    return counter_bits(offset, int(seed) & M32, tile_id)


def ceil_mult(dim: int, base: int = 128) -> int:
    """Requested block ``base``, shrunk to a pow2 >= 8 for small dims (the
    reference wrappers' ``_ceil_mult``)."""
    if dim >= base:
        return base
    return max(8, 1 << (max(dim, 1) - 1).bit_length())


def shard_bounds(n: int, n_shards: int) -> list:
    """``[0, b_1, ..., n]``: shard ``s`` owns ``[s * n // S, (s + 1) * n //
    S)`` (empty blocks when ``n < S``)."""
    return [s * n // n_shards for s in range(n_shards)] + [n]


def block_tile(rows: int, width: int) -> tuple:
    """``(bm, bn, grid)`` of a ``(rows, width)`` block: the logical tile
    the reference's wrapper resolves for it, and its tiles a row (1 for an
    empty block)."""
    bn = ceil_mult(max(width, 1), 256)
    return ceil_mult(max(rows, 1), 256), bn, max(-(-width // bn), 1)


def upset_probability(ber) -> float:
    """``q = 1 - (1 - ber)**32`` in float32, as jnp evaluates it.

    ``x ** 32`` lowers to five float32 squarings (XLA's ``integer_pow``);
    draws compare ``u < q`` at 2**-27 resolution, so the rounding of every
    squaring matters.  Worked out once per distinct BER: every faulted
    matmul of the serve loop asks for it.
    """
    return _upset_probability(float(ber))


@functools.lru_cache(maxsize=1024)
def _upset_probability(ber: float) -> float:
    y = 1.0 - torch.tensor(ber, dtype=torch.float32)
    for _ in range(5):
        y = y * y
    return float(1.0 - y)


def upset_words(acc: torch.Tensor, bits: torch.Tensor, q: float):
    """Flip bit ``bits & 31`` of each int32 word where ``(bits >> 5) * 2**-27
    < q``."""
    pos = (bits & 31).to(torch.int32)
    u = (bits >> 5).to(torch.float32) * 2.0 ** -27
    mask = torch.ones_like(pos) << pos
    return torch.where(u < q, acc ^ mask, acc)


def _check_int8_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) @ b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if max(a.shape + b.shape) >= 2 ** 31:
        raise ValueError("dimensions must fit in int32")


def _check_scales(a, b, xs, ws):
    """Both scales or neither, shaped ``(M, 1)`` / ``(1, N)``, as
    contiguous float32."""
    if (xs is None) != (ws is None):
        raise ValueError("pass both scales or neither")
    if xs is None:
        return None, None
    M, N = a.shape[0], b.shape[1]
    if tuple(xs.shape) != (M, 1) or tuple(ws.shape) != (1, N):
        raise ValueError(f"scales {tuple(xs.shape)}, {tuple(ws.shape)} "
                         f"do not fit ({M}, {N})")
    return (xs.to(torch.float32).contiguous(),
            ws.to(torch.float32).contiguous())


def _launch(counter, a, b, xs, ws, seeds, qs, bm, bn) -> torch.Tensor:
    """The upset GEMM on the card for ``len(seeds)`` lanes of ``a``'s rows,
    :data:`_cuda.MAX_LANES` lanes a launch, each launch counted on
    ``counter``."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    dequant = xs is not None
    M, N = a.shape[0], b.shape[1]
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.float32 if dequant else torch.int32)
    if out.numel() == 0:
        return out
    if dequant and (xs.device != a.device or ws.device != a.device):
        raise ValueError("scales must be on the operands' device")
    rows = M // len(seeds)
    for l0 in range(0, len(seeds), _cuda.MAX_LANES):
        l1 = min(len(seeds), l0 + _cuda.MAX_LANES)
        r = slice(l0 * rows, l1 * rows)
        path = _cuda.launch_gemm(
            a[r], b, out[r],
            mode=_cuda.GEMM_UPSET_DEQUANT if dequant else _cuda.GEMM_UPSET,
            xs=xs[r] if dequant else None, ws=ws, seeds=seeds[l0:l1],
            qs=qs[l0:l1], lbm=bm, lbn=bn, grid_n=-(-N // bn))
        counter.launches += 1
        counter.launches_by_path[path] += 1
    return out


def fused_aged_matmul(a: torch.Tensor, b: torch.Tensor, xs=None, ws=None,
                      ber=0.0, seed=0, *, bm: int = 256,
                      bn: int = 256) -> torch.Tensor:
    """``a @ b`` with accumulator upsets at ``ber``, streams keyed on seed.

    ``(bm, bn)`` is the logical tile that keys the stream (the caller,
    :func:`repro_torch.kernels.ops.fused_aged_matmul`, resolves it); the
    shapes need not be multiples of it.  With ``xs (M, 1)`` / ``ws (1, N)``
    the result is the dequantised float32, else the int32 accumulator.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    from . import ref
    _check_int8_operands(a, b)
    xs, ws = _check_scales(a, b, xs, ws)
    if a.device.type == "cpu":
        return ref.fused_aged_matmul_ref(a, b, xs, ws, ber, seed, bm=bm,
                                         bn=bn)
    return _launch(fused_aged_matmul, a, b, xs, ws, [seed],
                   [upset_probability(ber)], bm, bn)


def fused_aged_matmul_lanes(a: torch.Tensor, b: torch.Tensor, xs=None,
                            ws=None, bers=(), seeds=(), *, lanes: int,
                            bm: int = 256, bn: int = 256) -> torch.Tensor:
    """Lane mode: ``lanes`` independent upset GEMMs against one shared
    ``b``, read once for all of them.

    ``a`` is ``(lanes * M_l, K)``, lane ``l`` owning rows ``[l * M_l,
    (l + 1) * M_l)``; lane ``l`` upsets its words at ``bers[l]`` from the
    stream of ``seeds[l]`` over its lane-local rows, in the logical
    ``(bm, bn)`` tiling resolved for ``M_l`` — what ``jax.vmap`` of the
    Pallas kernel computes lane by lane.  CPU tensors take the plain lane
    version; CUDA tensors launch the kernel once per
    :data:`repro_torch.kernels._cuda.MAX_LANES` lanes.
    """
    from . import ref
    _check_int8_operands(a, b)
    xs, ws = _check_scales(a, b, xs, ws)
    bers, seeds = tuple(bers), tuple(seeds)
    if lanes < 1 or a.shape[0] % lanes or len(bers) != lanes \
            or len(seeds) != lanes:
        raise ValueError(f"{lanes} lanes need a multiple of {lanes} rows "
                         f"and {lanes} BERs and seeds, got {a.shape[0]} "
                         f"rows, {len(bers)} BERs, {len(seeds)} seeds")
    if a.device.type == "cpu":
        return ref.fused_aged_matmul_lanes_ref(a, b, xs, ws, bers, seeds,
                                               lanes=lanes, bm=bm, bn=bn)
    return _launch(fused_aged_matmul_lanes, a, b, xs, ws, seeds,
                   [upset_probability(x) for x in bers], bm, bn)


def fused_aged_matmul_shards(a: torch.Tensor, b: torch.Tensor, xs=None,
                             ws=None, bers=(), seeds=(),
                             bounds=None) -> torch.Tensor:
    """Shard mode: ``a @ b`` with output-column block ``s`` (columns
    ``[bounds[s], bounds[s + 1])``) upset at ``bers[s]`` from the stream of
    ``seeds[s]`` over the block's own tile grid — what the Pallas kernel
    computes run on each block alone (``shard_map``), in one launch that
    reads ``b`` once.  ``bounds`` defaults to :func:`shard_bounds` of the
    columns over ``len(bers)`` shards (at most
    :data:`repro_torch.kernels._cuda.MAX_LANES`).  With ``xs`` / ``ws`` the
    result is the dequantised float32 ``(acc * xs) * ws``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    from . import ref
    _check_int8_operands(a, b)
    xs, ws = _check_scales(a, b, xs, ws)
    bers, seeds = tuple(bers), tuple(seeds)
    M, N = a.shape[0], b.shape[1]
    S = len(bers)
    bounds = shard_bounds(N, S) if bounds is None else \
        [int(v) for v in bounds]
    if not 1 <= S <= _cuda.MAX_LANES or len(seeds) != S \
            or len(bounds) != S + 1 or bounds[0] != 0 or bounds[-1] != N \
            or any(x > y for x, y in zip(bounds, bounds[1:])):
        raise ValueError(f"{S} shards (1 to {_cuda.MAX_LANES}) need as many "
                         f"seeds and {S + 1} ascending bounds from 0 to {N}, "
                         f"got {len(seeds)} seeds, bounds {bounds}")
    if a.device.type == "cpu":
        return ref.fused_aged_matmul_shards_ref(a, b, xs, ws, bers, seeds,
                                                bounds)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    dequant = xs is not None
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.float32 if dequant else torch.int32)
    if out.numel() == 0:
        return out
    if dequant and (xs.device != a.device or ws.device != a.device):
        raise ValueError("scales must be on the operands' device")
    tiles = [block_tile(M, bounds[i + 1] - bounds[i]) for i in range(S)]
    path = _cuda.launch_gemm(
        a, b, out,
        mode=_cuda.GEMM_UPSET_DEQUANT if dequant else _cuda.GEMM_UPSET,
        xs=xs, ws=ws, seeds=seeds, qs=[upset_probability(x) for x in bers],
        lbm=tiles[0][0], shards=(bounds, [t[1] for t in tiles],
                                 [t[2] for t in tiles]))
    fused_aged_matmul_shards.launches += 1
    fused_aged_matmul_shards.launches_by_path[path] += 1
    return out


fused_aged_matmul.launches = 0
fused_aged_matmul.launches_by_path = {_cuda.FAST: 0, _cuda.GENERIC: 0}
fused_aged_matmul_lanes.launches = 0
fused_aged_matmul_lanes.launches_by_path = {_cuda.FAST: 0, _cuda.GENERIC: 0}
fused_aged_matmul_shards.launches = 0
fused_aged_matmul_shards.launches_by_path = {_cuda.FAST: 0, _cuda.GENERIC: 0}
