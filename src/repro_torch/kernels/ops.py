"""Public wrappers around the kernels (``repro.kernels.ops`` counterpart).

* The logical tile :func:`_resolve_blocks` resolves (``_ceil_mult(dim,
  256)``) keys the fused kernel's upset stream, and the injection draws,
  for each live word, the randoms the reference draws for it over its
  padded ``(rows_pad, 128)`` layout; both are reproduced exactly, so every
  route here is bit-exact against its reference counterpart.  The kernels
  mask ragged edges instead of padding.
* :func:`aged_linear` is the model-facing op: int8 quantisation, int32
  systolic accumulation, BER-parameterised accumulator upsets, dequant —
  over the fused kernel, the three-pass kernel route, or the kernel-free
  route.
* Lanes: with ``lanes=L`` the rows of ``L`` devices are folded lane-major
  into one call (the fleet's lane-batched forward), each lane with its own
  BER and seed or key — the reference's ops under ``jax.vmap``.  The lane
  count is an explicit argument, never read from a BER vector's shape.
* Shards: an ``(S,)`` BER vector (mesh serving, one device of S
  tensor-parallel shards) upsets each shard's block of the output columns
  (of the flattened heads, for the qkt/sv accumulators) at its own BER from
  the stream ``fold_seed(seed, s)`` over the block's own tile grid:
  :func:`inject_bitflips_sharded` (the reference's, plain, or one launch of
  the counter-upset kernel) and the shard mode of the fused GEMM, both
  drawing the streams the reference's ``shard_map``-wrapped kernel and its
  kernel-free route draw.  Lanes and shards together are refused, as the
  reference's fleet engine refuses shard-granular fleets.
* Rank blocks: under a serve mesh whose model axis spans ranks, a weight
  that is a rank's column block (a :class:`repro_torch.distributed.
  sharding.RankBlock`) makes :func:`aged_linear` compute only that block,
  exactly columns ``s`` of the one-device result: at ``ber[s]`` from the stream
  ``fold_seed(seed, s)`` over the block's own tile grid (one launch of the
  fused GEMM on the block), or, under one scalar BER, from the key's draws
  of the block's words in the whole product.
"""
from __future__ import annotations

import torch

from .. import random as prandom
from ..device import true_div
from ..distributed import sharding as shrules
from ..random import M32
from . import ref
from .bitflip import bitflip_draw, bitflip_draw_lanes
from .counter_upset import counter_upset_shards
from .fused_aged_matmul import ceil_mult as _ceil_mult
from .fused_aged_matmul import (block_tile, fused_aged_matmul as
                                _fused_aged_matmul_kernel,
                                fused_aged_matmul_lanes,
                                fused_aged_matmul_shards, shard_bounds,
                                stream_constant, tile_counter_bits,
                                upset_probability, upset_words)
from .systolic_matmul import systolic_matmul


def _resolve_blocks(M: int, N: int, K: int, bm: int, bn: int, bk: int):
    """The logical ``(bm, bn, bk)`` tile the reference pads to."""
    return _ceil_mult(M, bm), _ceil_mult(N, bn), _ceil_mult(K, bk)


def quantized_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M,K) @ int8 (K,N) -> int32 (M,N), arbitrary shapes."""
    return systolic_matmul(a.contiguous(), b.contiguous())


def make_flip_randoms(key: torch.Tensor, shape, device="cpu"):
    """Uniforms + bit positions for the explicit-randoms bitflip pass, over
    ``shape`` (the reference draws them over ``(rows_pad, 128)``)."""
    ku, kp = prandom.split(key)
    u = prandom.uniform(ku, shape, device=device)
    pos = prandom.randint(kp, shape, 0, 32, device)
    return u, pos


def flip_key_words(key: torch.Tensor) -> tuple:
    """The four uint32 key words of :func:`make_flip_randoms`' two draws,
    as Python ints (no device work): ``ku, kp = split(key)`` keys the
    uniforms, and ``randint(kp, ..., 0, 32)`` is the bits of ``split(kp)[1]``
    mod 32 (its multiplier ``(2**16 % 32)**2 % 32`` is 0, so the draw of
    ``split(kp)[0]`` drops out)."""
    k0, k1 = (int(v) for v in key.tolist())
    ku = prandom.threefry2x32(k0, k1, 0, 0)
    kp = prandom.threefry2x32(k0, k1, 0, 1)
    return (*ku, *prandom.threefry2x32(*kp, 0, 1))


def lane_values(values, lanes: int, what: str) -> tuple:
    """``values`` as a tuple of one entry per lane (BERs, seeds), checked."""
    values = tuple(values)
    if len(values) != lanes:
        raise ValueError(f"{lanes} lanes need {lanes} {what}, got "
                         f"{len(values)}")
    return values


def _lane_keys(key: torch.Tensor, lanes: int) -> torch.Tensor:
    if tuple(key.shape) != (lanes, 2):
        raise ValueError(f"{lanes} lanes need ({lanes}, 2) keys, got "
                         f"{tuple(key.shape)}")
    return key


def _draw_args(ber, key: torch.Tensor, lanes: int):
    """Each lane's four key words and upset probability."""
    key = _lane_keys(key, lanes)
    return ([flip_key_words(k) for k in key],
            [upset_probability(b) for b in lane_values(ber, lanes, "BERs")])


def inject_bitflips(x: torch.Tensor, ber, key: torch.Tensor, *,
                    lanes: int | None = None) -> torch.Tensor:
    """Flip bits of an int32 tensor at per-bit rate ``ber``: one launch of
    the bitflip pass in draw mode over the live words (its plain version on
    the CPU), bit-exact with the reference's padded kernel pass.

    With ``lanes=L``, ``x`` holds L lanes' words lane-major (its leading
    axis folds the lanes); lane ``l`` is injected at ``ber[l]`` with the
    key ``key[l]`` (``key`` is ``(L, 2)``), over its own word indices: one
    launch of the lane mode."""
    if lanes is None:
        return bitflip_draw(x.contiguous(), flip_key_words(key),
                            upset_probability(ber))
    words, qs = _draw_args(ber, key, lanes)
    out = bitflip_draw_lanes(x.contiguous().reshape(lanes, -1), words, qs)
    return out.reshape(x.shape)


def inject_bitflips_ref(x: torch.Tensor, ber, key: torch.Tensor, *,
                        lanes: int | None = None):
    """Plain injection, bit-exact vs :func:`inject_bitflips`."""
    if lanes is None:
        return ref.bitflip_draw_ref(x, flip_key_words(key),
                                    upset_probability(ber))
    words, qs = _draw_args(ber, key, lanes)
    return ref.bitflip_draw_lanes_ref(x.reshape(lanes, -1), words,
                                      qs).reshape(x.shape)


def fused_aged_matmul(a: torch.Tensor, b: torch.Tensor, xs=None, ws=None, *,
                      ber=0.0, seed=0, bm: int = 256, bn: int = 256,
                      bk: int = 256, lanes: int | None = None
                      ) -> torch.Tensor:
    """Fused int8 matmul + in-accumulator upsets (+ dequant), any shapes.

    With ``lanes=L``, ``a``'s rows are L lanes' lane-major, and ``ber`` and
    ``seed`` hold one value per lane; the logical tile is resolved for one
    lane's rows, as the reference resolves it under ``jax.vmap``."""
    M = a.shape[0] if lanes is None else a.shape[0] // lanes
    bm_, bn_, _ = _resolve_blocks(M, b.shape[1], a.shape[1], bm, bn, bk)
    if lanes is None:
        return _fused_aged_matmul_kernel(a.contiguous(), b.contiguous(), xs,
                                         ws, ber, seed, bm=bm_, bn=bn_)
    return fused_aged_matmul_lanes(
        a.contiguous(), b.contiguous(), xs, ws,
        lane_values(ber, lanes, "BERs"), lane_values(seed, lanes, "seeds"),
        lanes=lanes, bm=bm_, bn=bn_)


def shard_slices(n: int, n_shards: int) -> list:
    """Split points assigning ``n`` columns/heads to shards: shard ``s``
    owns ``[s*n//S, (s+1)*n//S)`` (trailing shards own empty blocks when
    ``n < S``)."""
    return [s * n // n_shards for s in range(1, n_shards)]


def upset_counter_block(acc: torch.Tensor, ber, seed) -> torch.Tensor:
    """Upset one 2-D accumulator block with the fused kernel's counter
    stream over the tile grid the kernel's wrapper resolves for this block
    shape."""
    M, N = acc.shape
    bits = tile_counter_bits(M, N, seed, bm=_ceil_mult(M, 256),
                             bn=_ceil_mult(N, 256), device=acc.device)
    return upset_words(acc, bits, upset_probability(ber))


def shard_upset_tables(shape, n_shards: int, axis: int = -1) -> dict:
    """How :func:`inject_bitflips_sharded` splits an array of ``shape``
    (viewed as ``(R, D)``, its last axis the columns) into ``n_shards``
    blocks along ``axis``: ``by_row`` (a leading axis: the flattened heads),
    ``mid`` (rows an entry of it spans) and ``n_ax`` (its entries), the
    blocks' ``bounds`` on that axis, and each block's logical tile
    ``bms`` x ``bns`` with ``grids`` tiles a row.  A column block is
    ``(R, W_s)``; a leading-axis block is ``(lead, W_s, mid, D)`` flattened
    to ``(lead * W_s * mid, D)``."""
    shape = tuple(shape)
    ax = axis % len(shape)
    n_ax = shape[ax]
    D = shape[-1]
    R = 1
    for d in shape[:-1]:
        R *= d
    bounds = shard_bounds(n_ax, n_shards)
    widths = [b1 - b0 for b0, b1 in zip(bounds, bounds[1:])]
    if ax == len(shape) - 1:
        tiles = [block_tile(R, w) for w in widths]
        mid, by_row = 1, False
    else:
        mid = 1
        for d in shape[ax + 1:-1]:
            mid *= d
        tiles = [block_tile((R // n_ax) * w, D) for w in widths]
        by_row = True
    return {"by_row": by_row, "mid": mid, "n_ax": n_ax, "bounds": bounds,
            "bms": [t[0] for t in tiles], "bns": [t[1] for t in tiles],
            "grids": [t[2] for t in tiles]}


def shard_seeds(seed, n_shards: int) -> list:
    """Each shard's stream seed, ``fold_seed(seed, s)``."""
    return [fold_seed(seed, s) for s in range(n_shards)]


def inject_bitflips_sharded(x: torch.Tensor, bers, key=None, *, seed=None,
                            axis: int = -1,
                            use_kernel: bool = False) -> torch.Tensor:
    """Per-shard accumulator upsets: block ``s`` of ``axis`` flips at
    ``bers[s]`` from the stream ``fold_seed(seed, s)`` (``seed`` hashed from
    ``key`` when only a key is given), drawn by the fused kernel's counter
    stream over the block's own tile grid — what the kernel draws running
    on that block alone.  Rank > 2 inputs collapse their leading dims,
    keeping the last as the columns; ``axis`` other than the last splits a
    leading axis (the qkt/sv flattened heads).  The plain version, as the
    reference's; ``use_kernel`` runs one launch of the counter-upset kernel
    on a CUDA tensor (its plain version on the CPU)."""
    if seed is None:
        seed = seed_from_key(key)
    qs = [upset_probability(float(b)) for b in bers]
    seeds = shard_seeds(seed, len(qs))
    tables = shard_upset_tables(x.shape, len(qs), axis)
    if use_kernel:
        return counter_upset_shards(x, qs, seeds, tables)
    return ref.counter_upset_shards_ref(x, qs, seeds, tables)


def _signed32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def seed_from_key(key: torch.Tensor) -> int:
    """The fused kernel's int32 seed from a threefry key: word 0 of its
    ``bits`` draw, hashed on the host's Python ints."""
    k0, k1 = (int(v) for v in key.tolist())
    return _signed32(prandom.bits_at(k0, k1, 0))


def fold_seed(seed: int, *indices) -> int:
    """Mix indices into an int32 seed with the fused kernel's fmix32 stream
    mix — the per-(operator, layer, step) stream derivation."""
    s = int(seed) & M32
    for idx in indices:
        s = stream_constant(s, int(idx) & M32)
    return _signed32(s)


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row absmax int8 quantisation; returns (q, scale).

    The scale keeps ``x``'s dtype, as in the reference (bf16 activations
    get a bf16 scale).
    """
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = true_div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def aged_linear(x: torch.Tensor, w: torch.Tensor, *, ber=0.0,
                key: torch.Tensor | None = None, seed=None,
                use_kernel: bool = True, fused: bool = True,
                lanes: int | None = None) -> torch.Tensor:
    """``x (.., K) @ w (K, N)`` executed as the paper's systolic array does.

    Injection is requested by passing ``seed`` or ``key``.  Routes, as in
    the reference: ``use_kernel and fused`` is ONE fused kernel (upset +
    dequant at the flush); ``use_kernel`` alone is the three-pass kernel
    route (int8 GEMM -> bitflip pass drawing its threefry randoms);
    otherwise the kernel-free plain route with the same streams.

    ``lanes=L`` serves L devices in one call: ``x``'s leading axis folds
    the lanes (lane-major), ``ber`` and ``seed`` are sequences of L values
    and ``key`` is ``(L, 2)``; the weight is quantised and read once.

    Without ``lanes``, ``ber`` may be an ``(S,)`` per-shard vector (mesh
    serving): output-column block ``s`` (:func:`shard_slices`) flips at
    ``ber[s]`` from the stream ``fold_seed(seed, s)`` (``seed`` hashed from
    ``key`` when only a key is given).  ``use_kernel and fused`` is one
    launch of the fused GEMM's shard mode for every ``N`` (the reference
    runs its kernel per shard under ``shard_map`` when ``S`` divides ``N``
    and the kernel-free route otherwise, with the same streams); else the
    plain int8 product and :func:`inject_bitflips_sharded`.  Both dequantise
    as ``(float(acc) * xs) * ws``.  Lanes and per-shard BERs together are
    refused.

    ``w`` may be a rank's column block ``s`` of ``S`` (a
    :class:`repro_torch.distributed.sharding.RankBlock`, under a serve
    mesh over ranks): the result is then the block's columns of the whole
    product alone (:func:`_rank_block`), which
    :func:`repro_torch.distributed.sharding.block_product` gathers.
    """
    block = None
    if isinstance(w, shrules.RankBlock):
        if w.dim != 1:
            raise ValueError(f"a block along dim {w.dim} of the weight is "
                             "not a column block")
        block, w = (w.shard, w.tp), w.data
    sharded = is_ber_vector(ber) if lanes is None else \
        any(is_ber_vector(b) for b in ber)
    if sharded and lanes is not None:
        raise NotImplementedError("lanes and per-shard BER vectors together "
                                  "are not a route (a fleet of sharded "
                                  "devices is not served)")
    inject = key is not None or seed is not None
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    xq, xs = quantize_int8(x2, axis=-1)
    wq, ws = quantize_int8(w, axis=0)
    N = w.shape[1]
    if block is not None and inject:
        if lanes is not None:
            raise NotImplementedError("lanes of a rank's weight block are "
                                      "not a route")
        out = _rank_block(xq, wq, xs, ws, block, ber, key, seed,
                          use_kernel and fused, use_kernel)
        return out.reshape(*lead, N).to(x.dtype)
    if sharded and inject:
        if seed is None:
            seed = seed_from_key(key)
        if use_kernel and fused:
            out = fused_aged_matmul_shards(
                xq.contiguous(), wq.contiguous(), xs, ws,
                tuple(float(b) for b in ber), shard_seeds(seed, len(ber)))
        else:
            acc = inject_bitflips_sharded(ref.systolic_matmul_ref(xq, wq),
                                          ber, seed=seed)
            out = acc.to(torch.float32) * xs * ws
        return out.reshape(*lead, N).to(x.dtype)
    if sharded:                 # no streams: the clean int8 product
        use_kernel = False
    if use_kernel and fused and inject:
        if seed is None:
            seed = (seed_from_key(key) if lanes is None
                    else [seed_from_key(k) for k in _lane_keys(key, lanes)])
        out = fused_aged_matmul(xq, wq, xs, ws, ber=ber, seed=seed,
                                lanes=lanes)
        return out.reshape(*lead, N).to(x.dtype)
    acc = quantized_matmul(xq, wq) if use_kernel \
        else ref.systolic_matmul_ref(xq, wq)
    if inject:
        if key is None:
            key = (prandom.PRNGKey(seed) if lanes is None else torch.stack(
                [prandom.PRNGKey(s) for s in lane_values(seed, lanes,
                                                         "seeds")]))
        acc = (inject_bitflips(acc, ber, key, lanes=lanes) if use_kernel
               else inject_bitflips_ref(acc, ber, key, lanes=lanes))
    out = acc.to(torch.float32) * xs * ws
    return out.reshape(*lead, N).to(x.dtype)


def _rank_block(xq, wq, xs, ws, block, ber, key, seed, fused: bool,
                use_kernel: bool) -> torch.Tensor:
    """The dequantised float32 columns of rank block ``s`` of ``S``
    (``block``) of the injected product, as the one-device routes compute
    them: under ``(S,)`` BERs, block ``s`` upset at ``ber[s]`` from the
    stream ``fold_seed(seed, s)`` over its own tile grid, by one launch of
    the fused GEMM on the block (``fused``) or the plain product and
    :func:`upset_counter_block`; under one BER, the plain route's draws
    of the block's words in the whole ``(M, S * N)`` product.  The weight
    scales ``ws`` are per column, so the block's are the whole weight's."""
    s, S = block
    M, N = xq.shape[0], wq.shape[1]
    if is_ber_vector(ber):
        if len(ber) != S:
            raise ValueError(f"{len(ber)} shard BERs on a mesh of {S}")
        if seed is None:
            seed = seed_from_key(key)
        seed_s, ber_s = fold_seed(seed, s), float(ber[s])
        if fused:
            return fused_aged_matmul(xq, wq, xs, ws, ber=ber_s, seed=seed_s)
        acc = upset_counter_block(ref.systolic_matmul_ref(xq, wq), ber_s,
                                  seed_s)
        return acc.to(torch.float32) * xs * ws
    if use_kernel:
        raise NotImplementedError(
            "one BER on a rank's weight block takes the plain route (the "
            "mesh engine's runtime= route); the kernel routes draw over the "
            "whole product")
    if key is None:
        key = prandom.PRNGKey(seed)
    dev = xq.device
    index = torch.arange(M, dtype=torch.int64, device=dev)[:, None] * (S * N) \
        + s * N + torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    acc = ref.bitflip_draw_ref(ref.systolic_matmul_ref(xq, wq),
                               flip_key_words(key), upset_probability(ber),
                               index=index)
    return acc.to(torch.float32) * xs * ws


def is_ber_vector(ber) -> bool:
    """Whether ``ber`` is a per-shard vector (a sequence, or a 1-D array
    or tensor) rather than one value."""
    if isinstance(ber, (tuple, list)):
        return True
    return getattr(ber, "ndim", 0) == 1
