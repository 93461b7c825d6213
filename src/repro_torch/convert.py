"""Carry a reference (JAX) param tree, given as numpy arrays, into the
port's tree.

The reference stacks a decoder's layers on a leading ``groups`` axis
under the key ``b0_attn`` and scans over it; the port keeps one dict per
layer in ``params["layers"]``.  Leaf layouts are unchanged (``wq (d, H,
hd)``, ``wo (H, hd, d)``, ``w_gate (d, f)``, experts ``(E, d, f)``, ...),
so the port's public functions see the reference's layouts.  Every leaf
takes ``dtype`` except the MoE router ``w_router``, which stays float32 as
in the reference; a tied-embedding tree has no ``lm_head``.
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


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig, *,
                          dtype=torch.float32, device="cuda") -> Dict:
    """Reference tree (``jax.tree.map(np.asarray, params)``) -> port tree."""
    device = resolve_device(device)

    def leaf(x, name):
        return _tensor(x, torch.float32 if name == "w_router" else dtype,
                       device)

    out = {k: _map(np_params[k], leaf)
           for k in ("embed", "final_norm", "lm_head") if k in np_params}
    groups = np_params["groups"]["b0_attn"]
    layers = [_map(groups, lambda x, name, g=g: leaf(np.asarray(x)[g], name))
              for g in range(int(np.shape(groups["norm1"]["scale"])[0]))]
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
