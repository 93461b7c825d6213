"""Carry a reference (JAX) param tree, given as numpy arrays, into the
port's tree.

The reference stacks a decoder's layers: ``groups`` holds one period of
``cfg.block_pattern`` under keys ``b{i}_{kind}``, each leaf with a
leading group axis, and ``tail`` the layers past the last full period;
the port keeps one dict per layer in ``params["layers"]``, in layer order
(group ``g``'s block ``i`` is layer ``g * period + i``, tail block ``t``
is layer ``n_groups * period + t``).  An enc-dec tree's stacked
``enc_layers`` / ``dec_layers`` become lists the same way.  Leaf layouts
are unchanged (``wq (d, H, hd)``, ``wo (H, hd, d)``, ``w_gate (d, f)``,
experts ``(E, d, f)``, ...), so the port's public functions see the
reference's layouts.  Every leaf takes ``dtype`` except those the
reference keeps in float32 (:data:`FLOAT32_LEAVES`); a tied-embedding
tree has no ``lm_head``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs import ModelConfig
from .device import resolve_device
from .tree import map_with_path, nest


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), dtype=dtype,
                           device=device)


def _map(tree, fn):
    """``fn(leaf, name)`` over a reference subtree, ``name`` the leaf's
    own key."""
    return map_with_path(lambda path, x: fn(x, path.rsplit("/", 1)[-1]),
                         tree)


# the MoE router, the RG-LRU's lam, RWKV's decay base and bonus
FLOAT32_LEAVES = ("w_router", "lam", "decay_base", "bonus_u")


def _unstack(stacked, n: int, leaf) -> list:
    """The ``n`` slices of a stacked subtree along its leading axis."""
    return [_map(stacked, lambda x, name, g=g: leaf(np.asarray(x)[g], name))
            for g in range(n)]


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig, *,
                          dtype=torch.float32, device="cuda") -> Dict:
    """Reference tree (``jax.tree.map(np.asarray, params)``) -> port tree."""
    device = resolve_device(device)

    def leaf(x, name):
        return _tensor(x, torch.float32 if name in FLOAT32_LEAVES else dtype,
                       device)

    top = ("embed", "final_norm", "lm_head", "prefix_proj", "dec_pos",
           "enc_final")
    out = {k: _map(np_params[k], leaf) for k in top if k in np_params}
    if "enc_layers" in np_params:
        out["enc_layers"] = _unstack(np_params["enc_layers"],
                                     cfg.n_encoder_layers, leaf)
        out["dec_layers"] = _unstack(np_params["dec_layers"], cfg.n_layers,
                                     leaf)
        return out
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    layers = [None] * (n_groups * len(pat))
    for i, kind in enumerate(pat):
        if n_groups:
            blocks = _unstack(np_params["groups"][f"b{i}_{kind}"], n_groups,
                              leaf)
            layers[i::len(pat)] = blocks
    for t in np_params.get("tail", []):
        (key,) = t.keys()
        layers.append(_map(t[key], leaf))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    out["layers"] = layers
    return out


def train_state_from_reference(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                               *, dtype=torch.float32, device="cuda"):
    """A reference train-state checkpoint (the flat arrays
    :func:`repro_torch.checkpoint.load_checkpoint` returns without a
    template) -> the port's :class:`~repro_torch.train.steps.TrainState`:
    params in ``dtype``, float32 moments, the int32 step."""
    from .optim import OptState
    from .train.steps import TrainState
    device = resolve_device(device)
    tree = nest(flat)
    moments = lambda t: params_from_reference(t, cfg, dtype=torch.float32,
                                              device=device)
    opt = tree["opt"]
    step = torch.as_tensor(np.asarray(opt["step"]), dtype=torch.int32,
                           device=device)
    return TrainState(
        params=params_from_reference(tree["params"], cfg, dtype=dtype,
                                     device=device),
        opt=OptState(mu=moments(opt["mu"]), nu=moments(opt["nu"]), step=step))
