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
        return terms @ self.coeffs

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
