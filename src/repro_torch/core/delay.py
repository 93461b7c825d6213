"""Critical-path delay: the fitted ternary degree-6 polynomial
``delay(dp, dn, V)`` the AVS loop evaluates.

Port of ``repro.core.delay`` (evaluation and ``from_dict``; the
alpha-power-law ground-truth path model and the least-squares fit stay in
the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import fmath

TOTAL_DEGREE = 6


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
