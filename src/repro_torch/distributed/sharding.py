"""Name-based sharding rules: parameter path -> partition spec (port of
``repro.distributed.sharding``'s rules, as pure functions).

A spec is a tuple with one entry per tensor dimension: the mesh axis name
(or tuple of names) the dimension is split over, or ``None``; ``()`` is a
replicated leaf.  A mesh is anything with a ``shape`` mapping of axis name
-> size and ``axis_names`` (:class:`repro_torch.launch.mesh.LogicalMesh`,
or the reference tests' ``FakeMesh``).  Mesh layout: ``("data",
"model")``, or ``("pod", "data", "model")`` multi-pod; the batch shards
over every axis but ``"model"``, weights over ``"model"``.

Two layouts share the rules (``layout=`` of :func:`param_pspec`):

* ``"train"`` — the Megatron-style rules (row-parallel ``wo`` /
  ``w_down`` contract a sharded dimension), with divisibility fallbacks:
  heads not dividing tp shard the ``d_model`` contraction side, GQA ``KV <
  tp`` shards the decode cache's sequence axis, a vocab not dividing tp
  gives a contraction-sharded head;
* ``"serve"`` — the exact tensor-parallel layout of mesh serving: weights
  shard only on output dimensions (the head axis of ``wq / wk / wv``,
  ``d_model`` of ``wo`` / ``w_down``, the vocab of the head, the expert
  axis), and every fallback replicates.  Each shard then computes whole
  column slices of every matmul, so the sharded result equals the
  single-device one; it is also the layout that assigns each shard the
  output columns (heads) whose upsets it owns
  (:func:`repro_torch.kernels.ops.shard_slices`).

The port's trees keep one dict per layer (``layers`` / ``enc_layers`` /
``dec_layers`` are lists, :mod:`repro_torch.convert`), so no leaf carries
the reference's stacked layer axis: a port leaf's spec is the reference's
spec of the stacked leaf without its leading stack entries.  Placing
tensors by these specs over several processes (the reference's
``shard_tree``, the activation constraints and the ``shard_map`` route)
is ROADMAP A.8c; on one device, :class:`repro_torch.serve.sharded.
MeshServeEngine` runs every shard.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..configs import ModelConfig
from ..tree import map_with_path

MODEL_AXIS = "model"


def _spec(*entries) -> tuple:
    """A spec tuple, a one-name axis group written as the name (as the
    reference's ``PartitionSpec`` normalises it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch shards over (everything except "model")."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def _tp(mesh) -> int:
    return mesh.shape[MODEL_AXIS] if MODEL_AXIS in mesh.axis_names else 1


def _dp(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))


def _base_spec(name: str, base_ndim: int, cfg: ModelConfig, tp: int):
    """Train-layout base spec of one named parameter (``None``:
    replicate)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    head_ok = H > 0 and H % tp == 0
    kv_ok = KV > 0 and KV % tp == 0
    vocab_ok = cfg.vocab % tp == 0
    if name == "wq":
        return (None, MODEL_AXIS, None) if head_ok else (MODEL_AXIS, None, None)
    if name in ("wk", "wv"):
        # KV < tp keeps KV whole and shards the d_model contraction side
        return (None, MODEL_AXIS, None) if kv_ok else (MODEL_AXIS, None, None)
    if name == "wo":
        return (MODEL_AXIS, None, None) if head_ok else (None, None, MODEL_AXIS)
    if name in ("w_gate", "w_up"):
        if base_ndim == 3:                       # MoE expert-stacked (E, d, f)
            return (MODEL_AXIS, None, None)
        return (None, MODEL_AXIS)                # dense (d, f)
    if name == "w_down":
        if base_ndim == 3:                       # (E, f, d)
            return (MODEL_AXIS, None, None)
        return (MODEL_AXIS, None)                # (f, d)
    if name == "w_in":                            # rwkv channel-mix (d, f)
        return (None, MODEL_AXIS)
    if name == "w_out":
        # rwkv cm (f, d) and the rglru out (d, d): both contract a sharded dim
        return (MODEL_AXIS, None)
    if name in ("w_x", "w_a", "w_i", "w_r", "w_k", "w_v", "w_g"):
        return (None, MODEL_AXIS)                # (d, d) column-parallel
    if name == "w_o":                             # rwkv out proj (d, d)
        return (MODEL_AXIS, None)
    if name == "w_router":
        return (None, None)
    if name == "embed":
        return (None, MODEL_AXIS)
    if name == "lm_head":
        return (None, MODEL_AXIS) if vocab_ok else (MODEL_AXIS, None)
    if name in ("prefix_proj", "dec_pos"):
        return (None, MODEL_AXIS)
    return None                                   # norms, vectors, ...


def _serve_base_spec(name: str, base_ndim: int, cfg: ModelConfig, tp: int):
    """Serve-layout base spec: output dimensions only, replicated
    fallbacks (``None``: replicate; :func:`param_pspec` re-checks the
    divisibility of the chosen dimension)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    head_ok = H > 0 and H % tp == 0
    kv_ok = KV > 0 and KV % tp == 0
    vocab_ok = cfg.vocab % tp == 0
    if name == "wq":
        return (None, MODEL_AXIS, None) if head_ok else None
    if name in ("wk", "wv"):
        return (None, MODEL_AXIS, None) if kv_ok else None
    if name == "wo":                              # (H, hd, d): output d
        return (None, None, MODEL_AXIS)
    if name in ("w_gate", "w_up"):
        if base_ndim == 3:                        # MoE (E, d, f): experts
            return (MODEL_AXIS, None, None)
        return (None, MODEL_AXIS)
    if name == "w_down":
        if base_ndim == 3:                        # (E, f, d)
            return (MODEL_AXIS, None, None)
        return (None, MODEL_AXIS)                 # (f, d): output d
    if name in ("w_in", "w_x", "w_a", "w_i", "w_r", "w_k", "w_v", "w_g",
                "w_out", "w_o"):
        return (None, MODEL_AXIS)                 # all column-parallel
    if name == "embed":
        # vocab-sharded when it divides; else d-sharded lookup, or
        # replicated when tied (the tied head would contract the sharded d)
        if vocab_ok:
            return (MODEL_AXIS, None)
        return None if cfg.tie_embeddings else (None, MODEL_AXIS)
    if name == "lm_head":
        return (None, MODEL_AXIS) if vocab_ok else None
    if name in ("prefix_proj", "dec_pos"):
        return (None, MODEL_AXIS)
    return None                                   # norms, router, ...


def param_pspec(path: str, leaf, cfg: ModelConfig, mesh, *,
                fsdp: bool = False, layout: str = "train") -> tuple:
    """Spec of one parameter leaf (``path`` its ``/``-joined tree path),
    by name and rank.

    ``fsdp=True`` also shards every >= 2-D weight over the data axes: the
    first replicated dimension they all divide.  ``layout="serve"`` takes
    the exact tensor-parallel rules.  A dimension the chosen axis does not
    divide replicates the whole leaf.
    """
    tp = _tp(mesh)
    if tp == 1 and not fsdp:
        return ()
    names = path.split("/")
    name = names[-1]
    if name in ("int8_q", "int8_s") and len(names) >= 2:
        name = names[-2]        # a quantised leaf inherits its weight's rule
    shape = tuple(leaf.shape)
    ndim = len(shape)
    rule = _serve_base_spec if layout == "serve" else _base_spec
    base = rule(name, ndim, cfg, tp) if tp > 1 else None
    if base is None or len(base) != ndim:
        base = (None,) * ndim
    spec = list(base)
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % tp != 0:
            spec = [None] * ndim
            break
    if fsdp and ndim >= 2:
        daxes = data_axes(mesh)
        dp = _dp(mesh)
        if dp > 1:
            for i in range(ndim):
                if spec[i] is None and shape[i] % dp == 0:
                    spec[i] = daxes if len(daxes) > 1 else daxes[0]
                    break
    if all(ax is None for ax in spec):
        return ()
    return tuple(spec)


def param_specs(params, cfg: ModelConfig, mesh, *, fsdp: bool = False,
                layout: str = "train"):
    """The spec tree of a parameter tree (leaves need only ``shape``)."""
    return map_with_path(
        lambda path, leaf: param_pspec(path, leaf, cfg, mesh, fsdp=fsdp,
                                       layout=layout), params)


def state_specs(state, cfg: ModelConfig, mesh, *, fsdp: bool = False):
    """Train-state specs: the params' and the optimizer moments' by name,
    scalars replicated."""
    def one(path, leaf):
        if len(tuple(leaf.shape)) == 0:
            return ()
        return param_pspec(path, leaf, cfg, mesh, fsdp=fsdp)
    return map_with_path(one, state)


def batch_spec(global_batch: int, mesh):
    """Largest prefix of the data axes that divides the global batch (a
    tuple of axis names, or ``None``)."""
    axes = []
    prod = 1
    for a in data_axes(mesh):
        if global_batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
        else:
            break
    return tuple(axes) if axes else None


def input_shardings(cfg: ModelConfig, mesh, global_batch: int,
                    kind: str) -> Dict[str, tuple]:
    """The spec of every model input of a step kind."""
    b = batch_spec(global_batch, mesh)
    out = {"tokens": _spec(b, None)}
    if kind == "train":
        out["labels"] = _spec(b, None)
    if cfg.prefix_tokens:
        out["prefix_embeds"] = _spec(b, None, None)
    if cfg.n_encoder_layers:
        out["frames"] = _spec(b, None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int) -> Dict[str, Any]:
    """Specs of the decode cache in the reference's stacked layout
    (``groups`` of the block pattern, stacked leaves first; ``tail``).

    Attention caches shard the batch over the data axes and the KV heads
    over "model" when they divide, else the sequence axis; recurrent states
    shard their feature axis over "model" when it divides."""
    tp = _tp(mesh)
    b = batch_spec(batch, mesh)
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp == 0 and tp > 1

    def attn_spec(lead):
        if tp == 1:
            sp = (b, None, None, None)
        elif kv_ok:
            sp = (b, None, MODEL_AXIS, None)
        else:
            sp = (b, MODEL_AXIS, None, None)      # sequence-sharded cache
        return {"k": _spec(*lead, *sp), "v": _spec(*lead, *sp)}

    def rec_spec(lead):
        ax = MODEL_AXIS if cfg.d_model % tp == 0 and tp > 1 else None
        return {"conv": _spec(*lead, b, None, ax), "h": _spec(*lead, b, ax)}

    def rwkv_spec(lead):
        H = cfg.d_model // cfg.rwkv_head_dim
        ax = MODEL_AXIS if H % tp == 0 and tp > 1 else None
        dax = MODEL_AXIS if cfg.d_model % tp == 0 and tp > 1 else None
        return {"tm": {"shift": _spec(*lead, b, dax),
                       "wkv": _spec(*lead, b, ax, None, None)},
                "cm_shift": _spec(*lead, b, dax)}

    kinds = {"attn": attn_spec, "rec": rec_spec, "rwkv": rwkv_spec}
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    layer_kinds = [pat[i % len(pat)] for i in range(cfg.n_layers)]
    tail = layer_kinds[n_groups * len(pat):]
    out: Dict[str, Any] = {}
    if n_groups:
        out["groups"] = {f"b{i}_{k}": kinds[k]((None,))
                         for i, k in enumerate(pat)}
    if tail:
        out["tail"] = [{f"b0_{k}": kinds[k](())} for k in tail]
    return out


def encdec_cache_spec(cfg: ModelConfig, mesh, batch: int) -> Dict[str, tuple]:
    """The enc-dec decoder's self-attention cache (L, B, S, KV, hd)."""
    tp = _tp(mesh)
    b = batch_spec(batch, mesh)
    if tp == 1:
        sp = (None, b, None, None, None)
    elif cfg.n_kv_heads % tp == 0:
        sp = (None, b, None, MODEL_AXIS, None)
    else:
        sp = (None, b, MODEL_AXIS, None, None)
    return {"k": _spec(*sp), "v": _spec(*sp)}

