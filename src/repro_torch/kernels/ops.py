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
  count is an explicit argument, never read from a BER vector's shape: the
  per-shard ``(S,)`` BER routes of mesh serving, not ported yet, will need
  lanes and shards together.
"""
from __future__ import annotations

import torch

from .. import random as prandom
from ..device import true_div
from ..random import M32
from . import ref
from .bitflip import bitflip_draw, bitflip_draw_lanes
from .fused_aged_matmul import (fused_aged_matmul as _fused_aged_matmul_kernel,
                                fused_aged_matmul_lanes, stream_constant,
                                upset_probability)
from .systolic_matmul import systolic_matmul


def _ceil_mult(dim: int, base: int = 128) -> int:
    """Requested block ``base``, shrunk to a pow2 >= 8 for small dims."""
    if dim >= base:
        return base
    return max(8, 1 << (max(dim, 1) - 1).bit_length())


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
    """
    if lanes is None and torch.as_tensor(ber).dim() != 0:
        raise NotImplementedError("per-shard BER vectors are not ported; "
                                  "pass lanes= for per-device BERs")
    inject = key is not None or seed is not None
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    xq, xs = quantize_int8(x2, axis=-1)
    wq, ws = quantize_int8(w, axis=0)
    N = w.shape[1]
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
