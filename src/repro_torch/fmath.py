"""float32 ``log``, ``log1p``, ``sin`` and ``lgamma`` as the reference's
CPU backend evaluates them, in plain tensor operations.

The reference's Poisson sampler accepts or rejects a draw by comparing
``k * log(lam) - lgamma(k + 1)`` against a log-uniform, and that difference
cancels two numbers of ~10^3: one ulp of ``log`` or ``lgamma`` moves it by
~10^-4 and, now and then, flips an acceptance and changes a count.  So the
port evaluates these functions with the reference backend's own
algorithms, operation for operation:

* ``log`` is the Cephes polynomial XLA's CPU backend emits for f32 logs
  (mantissa split at sqrt(1/2), degree-8 polynomial in three parts), every
  multiply and add rounded on its own;
* ``exp`` is its Cephes polynomial as well (reduction by ``ln 2`` in two
  parts, a scale by ``2**n`` in the exponent bits);
* ``log1p`` is XLA's: the Cephes rational approximation below
  ``sqrt(2) - 1`` and ``log(1 + x)`` above;
* ``sin`` is glibc's ``sinf`` (XLA lowers f32 ``sin`` to it): a double
  polynomial after a reduction by pi/2 (a 4/pi bit table past 120);
* ``lgamma`` is XLA's Lanczos expansion (g = 7, 8 coefficients) with the
  reflection below 0.5, as its algebraic simplifier leaves it;
* ``pow`` is glibc's ``powf`` (XLA lowers f32 ``pow`` to it): ``log2(x)``
  from a 16-entry table and a polynomial in double, ``y * log2(x)``, then
  ``exp2`` from a 32-entry table and a polynomial, with the double
  multiply-adds of glibc's FMA build each rounded once.

Each step is an elementwise multiply, add, divide, compare, gather or bit
operation, which every device rounds alike (separate tensor operations are
never contracted into an FMA), so the result is the same on the CPU and on
the card.  ``tests/test_torch_sched.py`` and
``tests/test_torch_cosim_exact.py`` hold each against ``jax.numpy``.
The one exception is ``lgamma`` below 0.5, whose reflection term takes
``torch.sin``/``torch.log`` of the fractional part; the samplers never use
that branch (a negative ``k`` is rejected before its ``lgamma`` counts).
"""
from __future__ import annotations

import torch

_F32, _F64, _I32, _I64 = torch.float32, torch.float64, torch.int32, \
    torch.int64


_FLT_MIN = 2.0 ** -126


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _hexf(s: str) -> float:
    return float.fromhex(s)


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (the backend contracts a multiply
    that feeds one add into an FMA): the f64 product of two f32 values is
    exact, so only the f64 sum rounds before the f32 result."""
    a = a.to(_F64) if isinstance(a, torch.Tensor) else a
    b = b.to(_F64) if isinstance(b, torch.Tensor) else b
    c = c.to(_F64) if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(_F32)


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals as (signed) zero: the backend's CPU threads run with
    denormals-are-zero and flush-to-zero set, so it reads and writes
    them so."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


# --------------------------------------------------------------------------- #
# log (XLA CPU's f32 Cephes polynomial)
# --------------------------------------------------------------------------- #
_SQRTHF = _hexf("0x1.6a09e6p-1")
_LOG_P = [_hexf(h) for h in (
    "0x1.2043760000000p-4", "-0x1.d7a3700000000p-4", "0x1.de4a340000000p-4",
    "-0x1.fcba9e0000000p-4", "0x1.23d37e0000000p-3", "-0x1.555ca00000000p-3",
    "0x1.999d580000000p-3", "-0x1.fffff80000000p-3", "0x1.5555540000000p-2")]
_LOG_Q1 = _hexf("-0x1.bd01060000000p-13")
_LOG_Q2 = _hexf("0x1.6300000000000p-1")


def log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log, bit-exact with the reference backend's (which
    reads subnormal inputs as zero)."""
    x = flush(x.to(_F32))
    c = lambda v: _c(v, x)
    xc = torch.where(c(_FLT_MIN) >= x, c(_FLT_MIN), x)
    xc = torch.where(torch.isnan(x), c(_FLT_MIN), xc)
    bits = xc.view(_I32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & -2139095041) | 1056964608).view(_F32)      # [0.5, 1)
    small = m < _SQRTHF
    zero = c(0.0)
    xm = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, c(1.0), zero)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = fma(xm, p[0], p[1])
    y1 = fma(xm, p[3], p[4])
    y2 = fma(xm, p[6], p[7])
    y = fma(y, xm, p[2])
    y1 = fma(y1, xm, p[5])
    y2 = fma(y2, xm, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    r = fma(e, _LOG_Q2, fma(x2, -0.5, xm) + y)
    r = torch.where(x <= 0.0, c(float("nan")), r)
    r = torch.where(torch.isnan(x), x, r)
    r = torch.where(x == 0.0, c(float("-inf")), r)
    return torch.where(x == float("inf"), x, r)


# --------------------------------------------------------------------------- #
# exp (XLA CPU's f32 Cephes polynomial)
# --------------------------------------------------------------------------- #
_EXP_LO, _EXP_HI = _hexf("-0x1.5f3334p+6"), _hexf("0x1.633334p+6")
_LOG2E = _hexf("0x1.715476p+0")
_EXP_C1, _EXP_C2 = _hexf("0x1.63p-1"), _hexf("-0x1.bd0106p-13")
_EXP_P = [_hexf(h) for h in ("0x1.a0d2cep-13", "0x1.6e879cp-10",
                             "0x1.11121p-7", "0x1.555382p-5",
                             "0x1.555554p-3")]


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp``, bit-exact with the reference backend's: range
    reduction by ``ln 2`` in two parts, a degree-5 polynomial and a scale
    by ``2**n`` built in the exponent bits."""
    x = flush(x.to(_F32))
    c = lambda v: _c(v, x)
    x = torch.where((x >= _EXP_LO) | torch.isnan(x), x, c(_EXP_LO))
    x = torch.where(torch.isnan(x) | (x <= _EXP_HI), x, c(_EXP_HI))
    fx = torch.floor(fma(x, _LOG2E, 0.5))
    fx = torch.clamp(fx, -127.0, 127.0)
    r = fma(fx, _EXP_C2 * -1.0, fma(fx, -_EXP_C1, x))
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for coef in _EXP_P[2:]:
        y = fma(y, r, coef)
    y = fma(y, r, 0.5)
    y = fma(y, r * r, r) + 1.0
    scale = ((fx.to(_I32) + 127) << 23).view(_F32)
    return flush(y * scale)                 # subnormal results flush to 0


# --------------------------------------------------------------------------- #
# log1p (XLA's: Cephes rational below sqrt(2) - 1)
# --------------------------------------------------------------------------- #
_L1P_P = [_hexf(h) for h in (
    "0x1.e2035a0000000p+3", "0x1.4c30b60000000p+6", "0x1.bb865a0000000p+7",
    "0x1.3519460000000p+8", "0x1.b0db140000000p+7", "0x1.e0f3040000000p+5")]
_L1P_Q = [_hexf(h) for h in (
    "0x1.7bc0960000000p-15", "0x1.fe818a0000000p-2", "0x1.a509f40000000p+2",
    "0x1.de97380000000p+4", "0x1.e798ec0000000p+5", "0x1.c8e75a0000000p+5",
    "0x1.40a2020000000p+4")]
_L1P_SMALL = _hexf("0x1.a8279a0000000p-2")


def log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log(1 + x)``, bit-exact with the reference backend's."""
    x = flush(x.to(_F32))
    large = log(x + 1.0)
    x2 = x * x
    x0 = x * 0.0
    num = x0 + 1.0
    for coef in _L1P_P:
        num = fma(num, x, coef)
    den = x0 + _L1P_Q[0]
    for coef in _L1P_Q[1:]:
        den = fma(den, x, coef)
    small = x + fma(x2, -0.5, (x * x2) * (den / num))
    return torch.where(torch.abs(x) < _L1P_SMALL, small, large)


# --------------------------------------------------------------------------- #
# sin (glibc's sinf, which the reference backend calls)
# --------------------------------------------------------------------------- #
def _two_over_pi_bits(nbits: int = 256) -> int:
    """floor(2/pi * 2**nbits), from Machin's formula in integers."""
    g = nbits + 64

    def arctan_inv(k: int) -> int:
        total, term, n, sign = 0, (1 << g) // k, 1, 1
        while term:
            total += sign * (term // n)
            term //= k * k
            n += 2
            sign = -sign
        return total

    pi = 4 * (4 * arctan_inv(5) - arctan_inv(239))          # pi * 2**g
    return ((2 << (2 * g)) // pi) >> (g - nbits)


_TWO_OVER_PI = _two_over_pi_bits()
# the 4/pi table of the large-argument reduction: 32-bit windows 8 bits apart
_INV_PIO4 = [(_TWO_OVER_PI >> (256 - 8 * (i + 1))) & 0xFFFFFFFF
             for i in range(24)]
_HPI_INV = _hexf("0x1.45f306dc9c883p+23")
_HPI = _hexf("0x1.921fb54442d18p+0")
_PI63 = _hexf("0x1.921fb54442d18p-62")
_C = [1.0] + [_hexf(h) for h in (
    "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16")]
_S = [_hexf(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                         "-0x1.994eb3774cf24p-13")]
_M64 = (1 << 64) - 1


def _wrap64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def _sinf_poly(x, x2, n, flip):
    """glibc's ``sinf_poly``: the sine polynomial for even quadrants, the
    cosine one (negated in the second table) for odd."""
    x3 = x * x2
    s = (x + x3 * _S[0]) + (x3 * x2) * (x2 * _S[2] + _S[1])
    sgn = torch.where(flip, -1.0, 1.0).to(_F64)
    c = [_c(v, x) * sgn for v in _C]
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    cos = (c1 + x4 * c[2]) + (x4 * x2) * c2
    return torch.where((n & 1) == 0, s, cos)


def _reduce_large(xi: torch.Tensor):
    """glibc's ``reduce_large`` on the f32 bit patterns ``xi`` (int64):
    the exact 2.62 fixed-point product with 4/pi, in wrapping int64."""
    dev = xi.device
    table = torch.tensor([_wrap64(v) for v in _INV_PIO4], dtype=_I64,
                         device=dev)
    idx = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift
    res0 = (m * table[idx]) & 0xFFFFFFFF
    res1 = m * table[idx + 4]
    res2 = m * table[idx + 8]
    res0 = ((res2 >> 32) & 0xFFFFFFFF) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(_F64) * _PI63, n


def sin(y: torch.Tensor) -> torch.Tensor:
    """f32 sine, bit-exact with glibc's ``sinf`` for finite arguments."""
    y = y.to(_F32)
    x = y.to(_F64)
    ay = torch.abs(y)
    tiny = ay < 2.0 ** -12
    # |y| < pi/4 (compared on the top 12 bits, as glibc does)
    top = (y.view(_I32) >> 20) & 0x7FF
    direct = top < 0x3F4
    mid = top < 0x42F                      # |y| < 120
    r = x * _HPI_INV
    n_mid = ((r.to(_I32) + 0x800000) >> 24).to(_I64)
    x_mid = x - n_mid.to(_F64) * _HPI
    xi = y.view(_I32).to(_I64) & 0xFFFFFFFF
    x_big, n_big = _reduce_large(xi)
    sign = (xi >> 31) & 1
    n = torch.where(direct, 0, torch.where(mid, n_mid, n_big))
    xr = torch.where(direct, x, torch.where(mid, x_mid, x_big))
    quad = torch.where(mid, n, n + sign)
    s = torch.where(((quad & 3) == 1) | ((quad & 3) == 2), -1.0,
                    1.0).to(_F64)
    flip = (quad & 2) != 0
    s = torch.where(direct, 1.0, s).to(_F64)
    flip = flip & ~direct
    out = _sinf_poly(xr * s, xr * xr, n, flip).to(_F32)
    out = torch.where(tiny, y, out)
    return torch.where(torch.isfinite(y), out, y - y)


# --------------------------------------------------------------------------- #
# lgamma (XLA's Lanczos approximation)
# --------------------------------------------------------------------------- #
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=_F32))


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log|Gamma(x)|``, bit-exact with ``jax.lax.lgamma`` on the
    reference's CPU backend for ``x >= 0.5``."""
    x = x.to(_F32)
    c = lambda v: _c(_f32(v), x)
    reflect = x < 0.5
    z = torch.where(reflect, -x, x + -1.0)
    acc = c(_LANCZOS[0]) / (z + 1.0) + 1.0
    for i, coef in enumerate(_LANCZOS[1:], start=2):
        acc = acc + c(coef) / (z + float(i))
    log_t = log1p(z * _f32(1.0 / 7.5)) + _f32(2.0149030205422647)
    log_y = fma((z + 0.5) - (z + 7.5) / log_t, log_t,
                 _f32(0.91893853320467274178))
    log_y = log_y + log(acc)
    ax = torch.abs(x)
    frac = ax - torch.floor(ax)
    frac = torch.where(0.5 < frac, 1.0 - frac, frac)
    denom = torch.log(torch.sin(frac * _f32(3.14159265358979323846)))
    refl = torch.where(torch.isfinite(denom),
                       (c(1.1447298858494002) - denom) - log_y, -denom)
    out = torch.where(reflect, refl, log_y)
    return torch.where(ax == float("inf"), ax, out)


# --------------------------------------------------------------------------- #
# pow (glibc's powf, which the reference backend calls)
# --------------------------------------------------------------------------- #
# The tables and coefficients of glibc 2.36's x86-64 powf (the ARM
# optimized-routines algorithm), read from its libm.so.6 (.rodata, the
# RIP-relative loads of the FMA build __powf_fma): __powf_log2_data.tab
# ({invc, logc} for 16 subintervals of [0x3f330000, 2 * that)),
# __powf_log2_data.poly, __exp2f_data.tab (2**(i/32) bit patterns) and
# __exp2f_data.poly.
_POW_LOG2_TAB = [(_hexf(a), _hexf(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))]
_POW_LOG2_POLY = [_hexf(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
# 2**(i/32) (the table entry plus i << 47, undoing glibc's pre-subtraction)
_EXP2_TAB = [t + (i << 47) for i, t in enumerate((
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540))]
_EXP2_POLY = [_hexf(h) for h in ("0x1.c6af84b912394p-5",
                                 "0x1.ebfce50fac4f3p-3",
                                 "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = _hexf("0x1.8p+47")             # 0x1.8p52 / 32
_POW_OFLOW = _hexf("0x1.fffffffd1d571p+6")
_SPLIT = 134217729.0                          # 2**27 + 1 (Veltkamp)


def _split_f(v: float):
    t = v * _SPLIT
    hi = t - (t - v)
    return hi, v - hi


def _split(a: torch.Tensor):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def fma64(a, b: torch.Tensor, c) -> torch.Tensor:
    """f64 ``a * b + c`` rounded once, from separately rounded operations
    (Dekker's exact product and Knuth's two-sum; ``a`` a tensor or a
    number).  Exact but when the low-order sum rounds onto a midpoint of
    the high-order one, which the polynomials below cannot reach."""
    ah, al = _split_f(a) if isinstance(a, float) else _split(a)
    bh, bl = _split(b)
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return s + (err + e)


_POW_TABLES: dict = {}


def _pow_tables(device):
    """The tables as tensors, made once per device (no host copy in a
    loop): invc split in halves whose products with a float32 are exact."""
    key = str(device)
    if key not in _POW_TABLES:
        invc = [a for a, _ in _POW_LOG2_TAB]
        halves = [_split_f(a) for a in invc]
        f64 = lambda v: torch.tensor(v, dtype=_F64, device=device)
        _POW_TABLES[key] = (
            f64([h for h, _ in halves]), f64([l for _, l in halves]),
            f64([b for _, b in _POW_LOG2_TAB]),
            torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                          for v in _EXP2_TAB], dtype=_I64, device=device))
    return _POW_TABLES[key]


def _odd_int(y: torch.Tensor):
    """(y is an integer, y is an odd integer) for finite f32 ``y``."""
    is_int = torch.floor(y) == y
    return is_int, is_int & (torch.abs(y) < 2.0 ** 24) & \
        (torch.fmod(y, 2.0) != 0.0)


def pow(x, y) -> torch.Tensor:
    """f32 ``x ** y`` as the reference backend evaluates it: glibc's
    ``powf`` (FMA build) bit for bit, on threads that read subnormal inputs
    as zero and flush subnormal results (``x``, ``y`` tensors or numbers,
    broadcast)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full((), float(x), dtype=_F32, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.full((), float(y), dtype=_F32, device=x.device)
    x, y = torch.broadcast_tensors(x.to(_F32), y.to(_F32))
    dev = x.device
    c32 = lambda v: _c(v, x)
    invc_hi, invc_lo, logc, exp2_tab = _pow_tables(dev)
    ax = torch.abs(x)
    is_int, odd = _odd_int(y)
    neg = torch.signbit(x)
    # log2(|x|), the mantissa split at 0x3f330000; glibc's normalisation
    # of a subnormal x (bits of x * 2**23, less 23 << 23) reads x as 0
    # under denormals-are-zero, so such an x is 2**-150 here
    ix = ax.view(_I32).to(_I64)
    ix = torch.where(ix < 0x00800000, torch.full_like(ix, -(23 << 23)), ix)
    tmp = ix - 0x3f330000
    i = (tmp >> 19) & 15
    k = tmp >> 23
    z = (ix - (k << 23)).to(_I32).view(_F32).to(_F64)
    r = (z * invc_hi[i] - 1.0) + z * invc_lo[i]          # fma(z, invc, -1)
    y0 = logc[i] + k.to(_F64)
    A = _POW_LOG2_POLY
    r2 = r * r
    yp = fma64(A[0], r, A[1])
    p = fma64(A[2], r, A[3])
    r4 = r2 * r2
    q = fma64(A[4], r, y0)
    q = fma64(p, r2, q)
    logx = fma64(yp, r4, q)
    ylogx = y.to(_F64) * logx
    # exp2(y * log2(x)) = 2**(k/32) * 2**r
    kd = (ylogx + _EXP2_SHIFT) - _EXP2_SHIFT
    r = ylogx - kd
    kn = (torch.nan_to_num(kd).clamp(-200.0, 200.0) * 32.0).to(_I64)
    s = (exp2_tab[kn & 31] + ((kn >> 5) << 52)).view(_F64)
    C = _EXP2_POLY
    zc = fma64(C[0], r, C[1])
    r2 = r * r
    yv = fma64(C[2], r, 1.0)
    yv = fma64(zc, r2, yv)
    out = flush((yv * s).to(_F32))         # subnormal results flush to 0
    zero, inf = c32(0.0), c32(float("inf"))
    out = torch.where(ylogx > _POW_OFLOW, inf, out)
    out = torch.where(ylogx < -149.0, zero, out)
    # x zero or infinite: x*x, or its inverse for negative y
    x2 = ax * ax
    out = torch.where((ax == 0.0) | (ax == inf),
                      torch.where(y < 0.0, 1.0 / x2, x2), out)
    out = torch.where(neg & odd, -out, out)
    out = torch.where(neg & ~is_int & (ax != inf) & (ax != 0.0),
                      c32(float("nan")), out)
    # y zero or infinite, and NaNs
    yinf = torch.abs(y) == inf
    out = torch.where(yinf, torch.where((ax == 1.0), c32(1.0), torch.where(
        (ax < 1.0) == (y > 0.0), zero, inf)), out)
    out = torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)
    return torch.where((y == 0.0) | (x == 1.0), c32(1.0), out)
