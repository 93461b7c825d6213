"""Critical-path delay (port of ``repro.core.delay``).

The AVS loop evaluates a fitted ternary degree-6 polynomial
``delay(dp, dn, V)`` (:class:`DelayPolynomial`).  Its ground truth is an
alpha-power-law path model (:class:`PathModel`, standing in for the
paper's HSPICE characterisation of the worst timing paths), and
:func:`fit_delay_polynomial` is the paper's least-squares fit of the
polynomial to it over the fitting box — what the physics calibration
(:mod:`repro_torch.core.calibrate`) refits per candidate path model.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict

import numpy as np
import torch

from .. import fmath
from .constants import D_CRIT_NOM, V_NOM

# the fitting box: dVth in [0, 150] mV, V_DD in [0.88, 1.06] V
DP_RANGE = (0.0, 0.150)
DN_RANGE = (0.0, 0.150)
V_RANGE = (0.88, 1.06)
TOTAL_DEGREE = 6


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class PathModel:
    """Alpha-power-law ground-truth model of the worst-path population."""
    alpha: float = 1.30
    vth_p0: float = 0.38
    vth_n0: float = 0.36
    wire_frac: float = 0.30   # fraction of nominal delay that is RC / non-FET
    pn_split: float = 0.50    # PMOS share of the FET-limited delay
    n_paths: int = 100
    spread: float = 0.035     # relative spread of the worst-path population
    seed: int = 20260715

    def stage_delay(self, V, dp, dn) -> torch.Tensor:
        """Normalised (w_i = 1) path delay [s], float32, each operation
        rounded as the reference's eager float32 operations round it (the
        Python constants to float32 first, ``**`` as glibc's ``powf``)."""
        V, dp, dn = _f32(V), _f32(dp), _f32(dn)
        alpha = _f32(self.alpha)
        f_p = V / fmath.pow(torch.clamp_min(V - _f32(self.vth_p0) - dp,
                                            1e-3), alpha)
        f_n = V / fmath.pow(torch.clamp_min(V - _f32(self.vth_n0) - dn,
                                            1e-3), alpha)
        f_p0 = V_NOM / (V_NOM - self.vth_p0) ** self.alpha
        f_n0 = V_NOM / (V_NOM - self.vth_n0) ** self.alpha
        fet = (_f32(self.pn_split) * f_p / _f32(f_p0)
               + _f32(1.0 - self.pn_split) * f_n / _f32(f_n0))
        return _f32(D_CRIT_NOM) * (_f32(self.wire_frac)
                                   + _f32(1.0 - self.wire_frac) * fet)

    def path_weights(self) -> np.ndarray:
        """Per-path scale factors, sorted descending; w_0 = 1 (critical)."""
        rng = np.random.default_rng(self.seed)
        eps = np.abs(rng.normal(0.0, self.spread, self.n_paths - 1))
        return np.concatenate([[1.0], 1.0 - np.sort(eps)])

    def path_delays(self, V, dp, dn) -> torch.Tensor:
        """All worst-path delays [s], ``(n_paths,)`` (+ broadcasts)."""
        return _f32(self.path_weights()) * self.stage_delay(V, dp, dn)

    def critical_delay(self, V, dp, dn) -> torch.Tensor:
        """The critical (w_0 = 1) path's delay, the quantity the AVS loop
        watches and the polynomial is fitted to."""
        return self.stage_delay(V, dp, dn)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PathModel":
        return cls(**d)


def _monomial_exponents(total_degree: int = TOTAL_DEGREE):
    """All (a, b, c) with a + b + c <= total_degree (84 terms for 6)."""
    return [(a, b, c)
            for a, b, c in itertools.product(range(total_degree + 1),
                                             repeat=3)
            if a + b + c <= total_degree]


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` by XLA's square-and-multiply, so every rounding matches
    jnp's ``integer_pow``."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _tree8(v: torch.Tensor) -> torch.Tensor:
    """A reassociated 8-lane ``vector.reduce.fadd`` as x86 lowers it:
    halves added pairwise, (0..3) + (4..7), then (0, 1) + (2, 3), then
    lane 0 + lane 1."""
    v = v[..., :4] + v[..., 4:]
    v = v[..., :2] + v[..., 2:]
    return v[..., 0] + v[..., 1]


def dot_like_xla(terms: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``terms @ coeffs`` over the last axis, summed in the order of the
    reference backend's CPU code for the polynomial's fused dot (its
    optimised LLVM IR): each product fused into its accumulator
    (``fma``), 8-lane vectors with 4 accumulators over the first
    ``32 * (K // 32)`` terms (lane sums ``((a1 + a0) + a2) + a3``, then
    :func:`_tree8`), one 8-lane accumulator seeded with that sum over the
    next multiples of 8 (:func:`_tree8` again), then the rest one by one.
    Explicit elementwise steps, so the card sums in the same order."""
    K = terms.shape[-1]
    k32, k8 = 32 * (K // 32), 8 * (K // 8)
    acc = None
    for k in range(0, k32, 32):
        t, c = terms[..., k:k + 32], coeffs[k:k + 32]
        acc = t * c if acc is None else fmath.fma(t, c, acc)
    lanes = terms.new_zeros(terms.shape[:-1] + (8,))
    if acc is not None:
        a = acc.unflatten(-1, (4, 8))
        s = ((a[..., 1, :] + a[..., 0, :]) + a[..., 2, :]) + a[..., 3, :]
        lanes[..., 0] = _tree8(s)
    for k in range(k32, k8, 8):
        lanes = fmath.fma(terms[..., k:k + 8], coeffs[k:k + 8], lanes)
    out = _tree8(lanes)
    for k in range(k8, K):
        out = fmath.fma(terms[..., k], coeffs[k], out)
    return out


@dataclasses.dataclass
class DelayPolynomial:
    """Ternary degree-6 polynomial ``delay(dp, dn, V)`` in seconds; inputs
    are scaled to [-1, 1] over the fitting box before monomial expansion."""
    coeffs: torch.Tensor             # (n_terms,) float32
    exponents: torch.Tensor          # (n_terms, 3) int64
    centers: torch.Tensor            # (3,) float32
    halfspans: torch.Tensor          # (3,) float32
    rmse: float = 0.0

    def __call__(self, dp, dn, V) -> torch.Tensor:
        dev = self.coeffs.device
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        x = (torch.stack(torch.broadcast_tensors(f32(dp), f32(dn), f32(V)),
                         dim=-1) - self.centers) / self.halfspans
        pows = torch.stack([_integer_pow(x, k)
                            for k in range(TOTAL_DEGREE + 1)], dim=-2)
        e = self.exponents
        terms = (pows[..., e[:, 0], 0] * pows[..., e[:, 1], 1]
                 * pows[..., e[:, 2], 2])
        return dot_like_xla(terms, self.coeffs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "coeffs": self.coeffs.cpu().double().tolist(),
            "exponents": self.exponents.cpu().tolist(),
            "centers": self.centers.cpu().double().tolist(),
            "halfspans": self.halfspans.cpu().double().tolist(),
            "rmse": float(self.rmse),
        }

    def to(self, device) -> "DelayPolynomial":
        return DelayPolynomial(self.coeffs.to(device),
                               self.exponents.to(device),
                               self.centers.to(device),
                               self.halfspans.to(device), self.rmse)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DelayPolynomial":
        f32 = lambda a: torch.tensor(np.asarray(a, np.float64),
                                     dtype=torch.float32)
        return cls(coeffs=f32(d["coeffs"]),
                   exponents=torch.tensor(d["exponents"], dtype=torch.int64),
                   centers=f32(d["centers"]), halfspans=f32(d["halfspans"]),
                   rmse=float(d["rmse"]))


def fit_delay_polynomial(path_model: PathModel, *, grid: int = 13,
                         total_degree: int = TOTAL_DEGREE) -> DelayPolynomial:
    """Least-squares fit of the critical-path delay over the fitting box
    (a ``grid x grid x (grid + 1)`` lattice), in float64 numpy on the path
    model's float32 delays, as the reference fits it."""
    dps = np.linspace(*DP_RANGE, grid)
    dns = np.linspace(*DN_RANGE, grid)
    vs = np.linspace(*V_RANGE, grid + 1)
    DP, DN, VV = np.meshgrid(dps, dns, vs, indexing="ij")
    y = path_model.critical_delay(VV.ravel(), DP.ravel(),
                                  DN.ravel()).numpy().astype(np.float64)
    centers = np.array([np.mean(DP_RANGE), np.mean(DN_RANGE),
                        np.mean(V_RANGE)])
    halfspans = np.array([np.ptp(DP_RANGE) / 2, np.ptp(DN_RANGE) / 2,
                          np.ptp(V_RANGE) / 2])
    X = np.stack([DP.ravel(), DN.ravel(), VV.ravel()], axis=-1)
    Xs = (X - centers) / halfspans
    exps = _monomial_exponents(total_degree)
    basis = np.stack([Xs[:, 0] ** a * Xs[:, 1] ** b * Xs[:, 2] ** c
                      for a, b, c in exps], axis=-1)
    coeffs, *_ = np.linalg.lstsq(basis, y, rcond=None)
    rmse = float(np.sqrt(np.mean((basis @ coeffs - y) ** 2)))
    return DelayPolynomial(
        coeffs=torch.tensor(coeffs, dtype=torch.float32),
        exponents=torch.tensor(np.array(exps), dtype=torch.int64),
        centers=torch.tensor(centers, dtype=torch.float32),
        halfspans=torch.tensor(halfspans, dtype=torch.float32),
        rmse=rmse)
