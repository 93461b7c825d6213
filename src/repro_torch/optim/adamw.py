"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
``repro.optim.adamw``), on plain dicts of tensors.

Moments are float32 whatever the param dtype; the update is computed in
float32 and cast back.  ``torch.optim.AdamW`` is not used: it places
``eps`` and applies the decay differently.  The step counter stays a
device tensor, so an update makes no host-device synchronisation, and
the update overwrites params and moments in place (the returned trees
are the ones passed in), so a step holds no second copy of either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch

from .. import fmath
from ..tree import leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor            # int32, 0-d, on the params' device


def ref_order_groups(tree, period: int = 1
                     ) -> Iterator[List[torch.Tensor]]:
    """The leaves in the reference's flattening order, one group per
    reference leaf: dict keys sorted, and a per-layer list folded as the
    reference stacks it.  ``enc_layers`` / ``dec_layers`` stack every
    layer (one group per in-layer path).  A decoder's ``layers`` stand for
    the reference's ``groups`` and ``tail``: with a block pattern of
    ``period`` kinds, ``groups["b{i}_{kind}"]`` stacks the layers at
    pattern position ``i`` of the first ``n // period`` periods, and each
    tail layer is a leaf group of its own, at the ``tail`` key's sorted
    place."""
    items = []
    for k, v in tree.items():
        if k == "layers":
            n = len(v) // period * period
            items += [("groups", [v[i:n:period] for i in sorted(
                range(period if n else 0), key=lambda i: f"b{i}_")]),
                      ("tail", [[layer] for layer in v[n:]])]
        elif k in ("enc_layers", "dec_layers"):
            items.append((k, [v]))
        else:
            items.append((k, v))
    for k, v in sorted(items, key=lambda kv: kv[0]):
        if isinstance(v, list):
            for stack in v:                    # layers stacked into leaves
                for p in _paths(stack[0]):
                    yield [_get(layer, p) for layer in stack]
        elif isinstance(v, dict):
            yield from ref_order_groups(v)
        else:
            yield [v]


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
    dev = leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=_F32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``min_lr_frac * lr``."""
    step = step.to(_F32)
    c = lambda v: _scalar(v, step)
    warm = step / c(max(cfg.warmup_steps, 1))
    prog = (step - cfg.warmup_steps) / c(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = torch.clamp(prog, 0.0, 1.0)
    # f32 cos as the reference backend's (glibc cosf) rounds it
    cos = torch.cos((c(torch.pi) * prog).double()).to(_F32)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + cos)
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, period: int = 1) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the per-leaf
    sums added in the reference's flattening order (``period``: the
    model's block-pattern length, see :func:`ref_order_groups`)."""
    total = None
    for group in ref_order_groups(tree, period):
        s = None
        for g in group:
            g = g.to(_F32)
            part = torch.sum(g * g)
            s = part if s is None else s + part
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, cfg: AdamWConfig, *,
                 period: int = 1
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns ``(params, opt, metrics)`` with params and
    moments updated in place.  ``period`` orders the clip norm's sum
    (:func:`global_norm`)."""
    step = opt.step + 1
    gnorm = global_norm(grads, period)
    scale = torch.clamp(_scalar(cfg.clip_norm, gnorm)
                        / torch.clamp_min(gnorm, 1e-9), max=1.0)
    stepf = step.to(_F32)
    bc1 = 1 - fmath.pow(cfg.b1, stepf)
    bc2 = 1 - fmath.pow(cfg.b2, stepf)
    lr = cosine_schedule(cfg, step)

    def upd(p, g, m, v):
        g = g.to(_F32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * g) * (1 - cfg.b2))
        pf = p.to(_F32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, opt.mu, opt.nu)
    return params, OptState(opt.mu, opt.nu, step), {"grad_norm": gnorm,
                                                     "lr": lr}
