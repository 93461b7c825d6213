"""Threefry-2x32 counterpart of the ``jax.random`` calls on the serve path.

Bit-exact with ``jax.random`` under ``jax_threefry_partitionable=True``
(the default of the jax the reference runs on): ``PRNGKey``, ``split``,
``fold_in``, ``bits`` (uint32), ``uniform`` (float32), ``randint``,
``gumbel``/``categorical`` and the workload samplers ``bernoulli`` and
``poisson`` (their ``log`` and ``lgamma`` are the reference backend's,
:mod:`repro_torch.fmath`).
``tests/test_torch_random.py`` and ``tests/test_torch_sampling.py`` hold
every function against jax.

A key is a CPU ``int64`` tensor of shape ``(2,)`` holding the two uint32
key words, like the raw ``uint32[2]`` keys of ``jax.random.PRNGKey``.  Keys
stay on the host: deriving one is a handful of integer mixes on Python
ints, so the per-layer ``fold_in`` chains of the serve loop cost no device
launch and no synchronisation.  Only bulk draws (``bits``, ``uniform``,
``randint``, ``gumbel``) are materialised, on the device the caller names.

uint32 arithmetic is done in ``int64`` masked to 32 bits (CPU torch has
few ``uint32`` ops).  The hash functions below take Python ints and
``int64`` tensors alike; a 32x32-bit product would overflow ``int64``, so
:func:`mul32` splits it into 16-bit halves.
"""
from __future__ import annotations

import math

import torch

from . import fmath

M32 = 0xFFFFFFFF
_TINY = torch.finfo(torch.float32).tiny
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul32(a, b):
    """``(a * b) mod 2**32`` for values in ``[0, 2**32)``.

    ``a * b = a_lo * b + 2**16 * a_hi * b``; modulo ``2**32`` the second
    term only needs ``a_hi * b_lo mod 2**16``, so no partial product
    exceeds ``2**48``.
    """
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return (a_lo * b + (((a_hi * (b & 0xFFFF)) & 0xFFFF) << 16)) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), as ``jax.random`` runs it."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _words(key: torch.Tensor):
    k0, k1 = key.tolist()
    return int(k0), int(k1)


def _key(w0: int, w1: int) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return _key(0, seed & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key ``i`` hashes the counter ``(0, i)``."""
    k0, k1 = _words(key)
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with ``data`` taken as a uint32."""
    k0, k1 = _words(key)
    return _key(*threefry2x32(k0, k1, 0, int(data) & M32))


def bits_at(k0: int, k1: int, index):
    """Word ``index`` (row-major) of every ``bits`` draw of the key words
    ``(k0, k1)``: the hash of the 64-bit counter ``index`` split into its
    high and low 32-bit halves, as the xor of the two outputs.

    The word does not depend on the draw's shape, so any word can be drawn
    alone.  ``index`` is an ``int64`` tensor or a Python int.
    """
    b0, b1 = threefry2x32(k0, k1, index >> 32, index & M32)
    return b0 ^ b1


def bits(key: torch.Tensor, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an ``int64`` tensor."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2**32 words or more")
    index = torch.arange(n, dtype=torch.int64, device=device)
    return bits_at(k0, k1, index).reshape(shape)


def float_from_bits(b: torch.Tensor) -> torch.Tensor:
    """float32 uniforms on ``[0, 1)`` from uint32 words (``int64``): the top
    23 bits become the mantissa of a float in ``[1, 2)``, from which 1 is
    subtracted, as ``jax.random.uniform`` does."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``max(minval, floats * (maxval - minval) + minval)`` in float32, the
    multiply-add rounded once, as XLA fuses it.  The float64 product of two
    float32 values is exact, so only the sum rounds twice (to float64, then
    float32), which can differ from one rounding only when the first lands
    on a float32 midpoint; for ``[0, 1)`` and ``[tiny, 1)`` every step is
    exact."""
    # filled on the device: a host tensor copied over would make every
    # sampled token wait for the device
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    span = torch.full((), maxval, dtype=torch.float32, device=device) - lo
    floats = float_from_bits(bits(key, shape, device))
    fma = floats.to(torch.float64) * span.to(torch.float64) + lo.to(
        torch.float64)
    return torch.maximum(lo, fma.to(torch.float32))


def gumbel(key: torch.Tensor, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default ``low``
    mode: ``-log(-log(u))`` of a uniform on ``[tiny, 1)``, bit for bit:
    both logs are the reference backend's (:func:`repro_torch.fmath.log`,
    plain float arithmetic), where a library ``log`` differs by an ulp and
    its result depends on the vector code path it takes."""
    u = uniform(key, shape, _TINY, 1.0, device)
    return -fmath.log(-fmath.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    trick, ``argmax(gumbel + logits)`` over the last axis."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``.

    Two draws (from the two halves of ``split(key)``) reduced modulo the
    span with jax's multiplier, so the result is biased exactly as jax's.
    """
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise NotImplementedError("int32 bounds with minval <= maxval only")
    k_hi, k_lo = split(key)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    multiplier = ((2 ** 16 % span) ** 2 & M32) % span     # uint32 product
    offset = bits(k_lo, shape, device) % span
    if multiplier:      # a zero multiplier drops the first draw entirely
        offset = (mul32(bits(k_hi, shape, device) % span, multiplier)
                  + offset) & M32
        offset = offset % span
    out = (offset + minval) & M32
    return (out - ((out >> 31) << 32)).to(torch.int32)


def bernoulli(key: torch.Tensor, p, shape=None, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (its default ``low`` mode):
    ``uniform(key, shape) < p``."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    shape = tuple(p.shape) if shape is None else tuple(shape)
    return uniform(key, shape, device=device) < p


def _poisson_knuth(key, lam, shape, device):
    """Knuth's multiplication method, as ``jax.random``'s: every round
    splits the key, counts the elements still above ``exp(-lam)`` and
    draws a full-shape uniform; the loop ends when no element is."""
    k = torch.zeros(shape, dtype=torch.int32, device=device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=device)
    while bool((log_prod > -lam).any()):
        key, sub = split(key)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + fmath.log(uniform(sub, shape, device=device))
    return k - 1


def _poisson_rejection(key, lam, shape, device):
    """Hormann's transformed rejection, as ``jax.random``'s: every round
    splits the key three ways and draws two full-shape uniforms; an
    element takes the ``k`` of every round that accepts it (a later
    acceptance overwrites an earlier one) and the loop ends when all have
    been accepted."""
    log_lam = fmath.log(lam)
    b = fmath.fma(2.53, torch.sqrt(lam.double()).float(), 0.931)
    a = fmath.fma(0.02483, b, -0.059)
    # a tensor numerator: ``number / tensor`` multiplies by a reciprocal
    c = lambda v: torch.full((), v, dtype=torch.float32, device=device)
    inv_alpha = 1.1239 + c(1.1328) / (b - 3.4)
    v_r = 0.9277 - c(3.6224) / (b - 2.0)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(accepted.all()):
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, shape, device=device) - 0.5
        v = uniform(sub1, shape, device=device)
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor(fmath.fma(2.0 * a / u_shifted + b, u, lam) + 0.43)
        s = fmath.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = fmath.fma(k, log_lam, -lam) - fmath.lgamma(k + 1.0)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int32)


def poisson(key: torch.Tensor, lam, shape=None, device="cpu") -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` as int32 counts, bit for bit:
    Knuth's method where ``lam < 10`` and transformed rejection elsewhere,
    both run over the full shape from the same key and selected per
    element, as jax does.  Each sampler loops until every element is
    done, so the call waits for the device once a round (a sampler's
    loop, never a serving step)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=device)
    shape = tuple(lam.shape) if shape is None else tuple(shape)
    lam = torch.broadcast_to(lam, shape)
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_knuth = torch.where(use_knuth, lam, 0.0)
    lam_rejection = torch.where(use_knuth, 1e5, lam)
    result = torch.where(use_knuth,
                         _poisson_knuth(key, lam_knuth, shape, device),
                         _poisson_rejection(key, lam_rejection, shape,
                                            device))
    return torch.where(lam == 0, 0, result).to(torch.int32)
