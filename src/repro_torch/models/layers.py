"""Shared model layers with per-operator fault-injection hooks.

Every matmul flows through :func:`op_linear` / :func:`op_batched_matmul`,
tagged with its operator-domain name (the paper's Table II rows).  With a
:class:`FaultConfig` attached, the op runs the way the paper's accelerator
runs it — int8 systolic matmul plus bit upsets at that operator's admitted
BER; without one it is a clean dense op.  A lane config (one
:class:`FaultConfig` for N devices, the counterpart of the reference's
config with batched leaves under ``jax.vmap``) runs N devices' rows,
folded lane-major into the batch, through one call of each op, each lane at
its own BERs and streams.  A shard config (one device of S mesh shards:
per-operator ``(S,)`` BER vectors) upsets each shard's block of a weight
matmul's output columns, and of the qkt/sv flattened heads, at the shard's
own BER, from counter streams keyed on ``fold_seed(seed_for(op, salt), s)``.

Under a serve mesh over ranks
(:func:`repro_torch.distributed.sharding.serve_mesh_scope`), a weight that
is this rank's block gives this rank's output block, which
:func:`~repro_torch.distributed.sharding.block_product` gathers into the
whole output (the reference's pin at the same op boundaries); a
replicated weight's product, and the qkt/sv products of the gathered
activations, are computed whole on every rank, as on one device.  Under a
train mesh over ranks a block may also lie along a contracted dimension
(the train layout's row-parallel ``wo`` / ``w_down`` and its fallbacks):
its partial products are all-reduced.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import fmath
from .. import random as prandom
from ..device import true_div
from ..distributed import sharding as shrules
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-operator error-injection config for serving-time evaluation.

    ``bers`` maps operator -> BER (a Python float), ``key`` is the base
    threefry key (:mod:`repro_torch.random`), ``seeds`` the per-operator
    int32 stream bases of :meth:`with_seeds`, ``step`` the decode step
    folded into every stream.  The fused kernel route takes seeds
    (:meth:`seed_for`); the three-pass and activation routes take keys
    (:meth:`key_for`) — the same derivations as the reference.

    A lane config serves N devices: ``key`` is ``(N, 2)``, ``bers`` maps
    operator -> N floats and ``seeds`` operator -> N ints, and
    :meth:`key_for` / :meth:`seed_for` give one key or seed per lane, each
    derived exactly as the reference derives it for that lane alone.
    :meth:`lane` slices one lane's single-device config out.  A shard
    config is a single-device one (``key`` ``(2,)``) whose ``bers`` map
    operators to S floats, one per mesh shard (:meth:`shards`).
    """
    bers: Dict[str, float]
    key: torch.Tensor
    seeds: Optional[Dict[str, int]] = None
    step: int = 0
    use_systolic_kernel: bool = True
    fused: bool = True

    @property
    def lanes(self) -> Optional[int]:
        """Number of lanes of a lane config; ``None`` for one device."""
        return self.key.shape[0] if self.key.dim() == 2 else None

    def ber_for(self, op: str):
        """The op's BER: a float, a tuple of one per lane, or (a shard
        config's) a tuple of one per shard."""
        if self.lanes is None:
            return self.bers.get(op, 0.0)
        return tuple(self.bers.get(op, (0.0,) * self.lanes))

    def shards(self, op: str) -> Optional[tuple]:
        """The op's per-shard BERs of a shard config, else None."""
        ber = self.ber_for(op)
        if self.lanes is not None or not kops.is_ber_vector(ber):
            return None
        return tuple(float(b) for b in ber)

    def for_step(self, step: int) -> "FaultConfig":
        return dataclasses.replace(self, step=int(step))

    def _lane_keys(self):
        return [self.key] if self.lanes is None else list(self.key)

    def _per_lane(self, values: list):
        return values[0] if self.lanes is None else tuple(values)

    def with_seeds(self) -> "FaultConfig":
        """Precompute the per-operator int32 stream bases."""
        seeds = {op: self._per_lane([
            kops.seed_from_key(prandom.fold_in(k, _op_salt(op)))
            for k in self._lane_keys()]) for op in self.bers}
        return dataclasses.replace(self, seeds=seeds)

    def key_for(self, op: str, salt) -> torch.Tensor:
        """The op's key at ``salt`` and this step: ``(2,)``, or ``(N, 2)``
        for a lane config."""
        keys = []
        for k in self._lane_keys():
            k = prandom.fold_in(k, _op_salt(op))
            k = prandom.fold_in(k, salt)
            keys.append(prandom.fold_in(k, self.step))
        return keys[0] if self.lanes is None else torch.stack(keys)

    def seed_for(self, op: str, salt):
        """int32 seed for the fused kernel's per-tile streams (a tuple of
        one per lane for a lane config)."""
        bases = (self.seeds or {}).get(op)
        if bases is None:
            bases = self._per_lane([
                kops.seed_from_key(prandom.fold_in(k, _op_salt(op)))
                for k in self._lane_keys()])
        if self.lanes is None:
            return kops.fold_seed(bases, salt, self.step)
        return tuple(kops.fold_seed(b, salt, self.step) for b in bases)

    def lane(self, i: int) -> "FaultConfig":
        """Lane ``i``'s single-device config (the reference's
        ``jax.tree.map(lambda x: x[i], fi)``)."""
        if self.lanes is None:
            raise ValueError("not a lane config")
        pick = lambda d: None if d is None else {
            op: v[i] for op, v in d.items()}
        return dataclasses.replace(self, bers=pick(self.bers),
                                   key=self.key[i], seeds=pick(self.seeds))


_OP_IDS = {op: i for i, op in enumerate(
    ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "router",
     "embed", "head", "r", "g", "w", "conv"))}


def _op_salt(op: str) -> int:
    return _OP_IDS.get(op, 31)


def op_linear(x: torch.Tensor, w: torch.Tensor, op: str,
              fi: Optional[FaultConfig] = None, salt=0) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` through the operator domain ``op``.

    Per-shard BERs flip each output-column block at its own shard's rate,
    streams keyed on ``seed_for(op, salt)`` on every route: one launch of
    the fused GEMM's shard mode on the fused kernel route, the plain
    product and :func:`repro_torch.kernels.ops.inject_bitflips_sharded`
    otherwise (the same draws).  A rank's column block of ``w`` (a serve
    mesh over ranks) computes its columns, gathered
    (:func:`repro_torch.distributed.sharding.block_product`)."""
    return shrules.block_product(
        x, w, lambda x, w: _linear(x, w, op, fi, salt), {1: -1}, {0: -1})


def _linear(x, w, op, fi, salt):
    if fi is None:
        return x @ shrules.held(w)
    shard_bers = fi.shards(op)
    if shard_bers is not None:
        return kops.aged_linear(x, w, ber=shard_bers,
                                seed=fi.seed_for(op, salt),
                                use_kernel=fi.use_systolic_kernel,
                                fused=fi.fused)
    ber = fi.ber_for(op)
    if fi.fused and fi.use_systolic_kernel:
        return kops.aged_linear(x, w, ber=ber, seed=fi.seed_for(op, salt),
                                use_kernel=True, fused=True, lanes=fi.lanes)
    return kops.aged_linear(x, w, ber=ber, key=fi.key_for(op, salt),
                            use_kernel=fi.use_systolic_kernel, fused=False,
                            lanes=fi.lanes)


def op_einsum(spec: str, x: torch.Tensor, w: torch.Tensor, op: str,
              fi: Optional[FaultConfig] = None, salt=0) -> torch.Tensor:
    """Einsum for fused head layouts; the faulted path flattens both sides
    to one 2-D systolic matmul (contraction letters must be a suffix of x's
    spec and a prefix of w's: "bsd,dhk->bshk", "bshk,hkd->bsd")."""
    ins, out_spec = spec.split("->")
    x_spec, w_spec = ins.split(",")
    if fi is None:
        return shrules.block_product(
            x, w, lambda x, w: torch.einsum(spec, x, shrules.held(w)),
            {i: out_spec.index(c) for i, c in enumerate(w_spec)
             if c in out_spec},
            {i: x_spec.index(c) for i, c in enumerate(w_spec)
             if c in x_spec})
    contract = [c for c in x_spec if c in w_spec]
    nc = len(contract)
    if not x_spec[-nc:] == w_spec[:nc] == "".join(contract):
        raise ValueError(f"unsupported einsum for the faulted path: {spec}")
    k = 1
    for d in w.shape[:nc]:
        k *= d
    x2 = x.reshape(*x.shape[:x.dim() - nc], k)
    out = op_linear(x2, shrules.fold(w, nc), op, fi, salt)
    return out.reshape(*x.shape[:x.dim() - nc], *w.shape[nc:])


def _exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched int8 x int8 -> int32 product, exact on any device.

    CUDA has no int32 matmul; a float64 matmul of int8 values is exact
    (every partial sum is an integer below ``K * 128**2 < 2**53``) and,
    unlike float32, does not depend on the TF32 switches.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def op_batched_matmul(a: torch.Tensor, b: torch.Tensor, op: str,
                      fi: Optional[FaultConfig] = None,
                      salt=0) -> torch.Tensor:
    """Activation x activation matmul (QK^T / SV domains) over leading batch
    dims, int8-quantised with accumulator upsets when faulted: the bitflip
    kernel pass on the kernel route, its plain version otherwise.  Under a
    lane config the leading axis folds the lanes, so each lane's words are
    contiguous, lane-major, as the lane-mode injection takes them.  Under
    per-shard BERs the heads flatten to ``(B, H, M, N)`` and shard ``s``
    owns heads ``[s*H//S, (s+1)*H//S)`` (the heads whose projections it
    owns), upset from counter streams (one launch of the counter-upset
    kernel on the kernel route, its plain version otherwise)."""
    if fi is None:
        return a @ b
    aq, ascale = kops.quantize_int8(a, axis=-1)
    bq, bscale = kops.quantize_int8(b, axis=-2)
    acc = _exact_int_matmul(aq, bq)
    shard_bers = fi.shards(op)
    if shard_bers is not None:
        flat = acc.reshape(acc.shape[0], -1, *acc.shape[-2:])
        acc = kops.inject_bitflips_sharded(
            flat, shard_bers, seed=fi.seed_for(op, salt), axis=1,
            use_kernel=fi.use_systolic_kernel).reshape(acc.shape)
    else:
        inject = (kops.inject_bitflips if fi.use_systolic_kernel
                  else kops.inject_bitflips_ref)
        acc = inject(acc, fi.ber_for(op), fi.key_for(op, salt),
                     lanes=fi.lanes)
    return (acc.to(torch.float32) * ascale * bscale).to(a.dtype)


# --------------------------------------------------------------------------- #
def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis, accumulated in float64.

    CUDA's reduce kernels choose their summation order by the number of
    rows, so a float32 sum could round differently for a row served alone
    and the same row in a lane-batched forward; summed in float64, its
    float32 rounding no longer depends on the order (nor on the device).
    A sum beyond float32's range is +-inf, as the reference's float32 sum
    is (ROADMAP C.5: accumulator upsets can push a row there).
    """
    s = x.to(torch.float64).sum(dim=-1, keepdim=True)
    s32 = s.to(torch.float32)
    return torch.where(torch.isinf(s32), s32,
                       (s / x.shape[-1]).to(torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = _row_mean(xf.square())
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = _row_mean(xf)
    var = _row_mean((xf - mu).square())                   # jnp.var's order
    out = (xf - mu) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def norm(x: torch.Tensor, p: Dict, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p.get("bias"))


def init_norm(kind: str, d: int, dtype, device) -> Dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# --------------------------------------------------------------------------- #
def rope_frequencies(hd: int, theta: float, device) -> torch.Tensor:
    half = hd // 2
    return theta ** true_div(-torch.arange(0, half, dtype=torch.float32,
                                           device=device), half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d: int, device) -> torch.Tensor:
    """(seq, d) float32 sinusoidal positions, ``[sin(ang), cos(ang)]`` with
    ``ang = pos / 10000 ** (i / (d // 2))``.  The power and the sine are
    :mod:`repro_torch.fmath`'s, bit-equal to the reference's on every
    device; the cosine is ``torch.cos`` (within an ulp of it)."""
    half = d // 2
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    ang = pos / fmath.pow(10000.0, true_div(dim, half))
    return torch.cat([fmath.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------- #
def mlp_apply(x: torch.Tensor, p: Dict, variant: str,
              fi: Optional[FaultConfig] = None, salt=0) -> torch.Tensor:
    """SwiGLU ``down(silu(gate(x)) * up(x))`` (``gated``) or
    ``down(gelu(up(x)))`` (``plain``).  ``jax.nn.gelu`` defaults to the
    tanh approximation, so this GELU does too."""
    if variant == "gated":
        g = op_linear(x, p["w_gate"], "gate", fi, salt)
        u = op_linear(x, p["w_up"], "up", fi, salt)
        h = F.silu(g) * u
    else:
        h = F.gelu(op_linear(x, p["w_up"], "up", fi, salt),
                   approximate="tanh")
    return op_linear(h, p["w_down"], "down", fi, salt)


def _normal(shape, scale: float, dtype, device, gen) -> torch.Tensor:
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=gen) * scale


def mlp_init(d: int, f: int, variant: str, dtype, device, gen) -> Dict:
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {}
    if variant == "gated":
        p["w_gate"] = _normal((d, f), s_in, dtype, device, gen)
    p["w_up"] = _normal((d, f), s_in, dtype, device, gen)
    p["w_down"] = _normal((f, d), s_out, dtype, device, gen)
    return p
