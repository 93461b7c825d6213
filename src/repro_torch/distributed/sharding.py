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
spec of the stacked leaf without its leading stack entries.

Serving over ranks (the serve layout placed over a
:func:`repro_torch.launch.mesh.make_serve_mesh` mesh whose model axis spans
the ranks of a process group): :func:`shard_tree` keeps each rank's block
of every sharded leaf as a :class:`RankBlock`; :func:`serve_mesh_scope`
puts the mesh in scope around a generation, and there the model's op
boundaries turn each rank's output block into the whole tensor
(:func:`block_product`, :func:`lookup_rows`) by an all-gather, where the
reference pins them replicated and GSPMD gathers.
Every such combine is pure data movement, so the tokens equal one
device's.  In one process (a mesh without ``model_group``) every shard
runs on the one device: :func:`shard_tree` keeps the whole tree and the
hooks are the identity.

Training over ranks (the train layout placed over a
:func:`repro_torch.launch.mesh.make_local_mesh` mesh whose model axis
spans ranks): :func:`shard_tree` cuts the train layout's specs the same
way, a block along a contracted dimension included, and
:func:`train_mesh_scope` puts the mesh in scope around the step's
forward.  There :func:`block_product` gives a column block's output
through :func:`~repro_torch.distributed.collectives.gather_from_model`
and a contracted block's through the product of the matching slice of
the input and an all-reduce of the partial sums
(:func:`~repro_torch.distributed.collectives.reduce_from_model`), each
input through :func:`~repro_torch.distributed.collectives.copy_to_model`,
so autograd differentiates through every collective.  Activations stay
whole at every op boundary, as on the serve path: the attention runs
all heads on every rank.  The all-reduces reorder float sums, as the
reference says of its own train layout.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ModelConfig
from ..tree import map_with_path
from .collectives import copy_to_model, gather_from_model, reduce_from_model

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


# --------------------------------------------------------------------------- #
# serving over ranks: placement and the op-boundary gathers
# --------------------------------------------------------------------------- #
def _spec_at(specs, path: str) -> tuple:
    node = specs
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """A rank's block of a whole parameter leaf, as :func:`shard_tree`
    keeps it: ``data`` is block ``shard`` of ``tp`` equal blocks of the
    leaf along ``dim``.  It is not a tensor, so no product can take it for
    a whole weight: the model's op boundaries compute with it only through
    :func:`block_product` and :func:`lookup_rows` (and
    :func:`repro_torch.kernels.ops.aged_linear` inside them), and a cast
    or a move goes through :meth:`map`.  ``shape`` is the whole leaf's,
    which the spec rules read; ``dtype`` and ``device`` are the data's."""
    data: torch.Tensor
    dim: int
    shard: int
    tp: int

    @property
    def shape(self) -> torch.Size:
        shape = list(self.data.shape)
        shape[self.dim] *= self.tp
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def span(self) -> slice:
        """The part of the whole leaf's ``dim`` that the block covers."""
        n = self.data.shape[self.dim]
        return slice(self.shard * n, (self.shard + 1) * n)

    def map(self, fn) -> "RankBlock":
        """The same block of ``fn(data)`` (a cast, a move, a reshape that
        keeps ``dim``)."""
        return dataclasses.replace(self, data=fn(self.data))


def held(w) -> torch.Tensor:
    """The tensor this rank holds of the leaf ``w``: a block's data, else
    ``w``.  For the product functions of :func:`block_product`."""
    return w.data if isinstance(w, RankBlock) else w


def span(w) -> slice:
    """The part of ``w``'s block dim that this rank holds: a block's
    span, else all of it."""
    return w.span if isinstance(w, RankBlock) else slice(None)


def fold(w, nc: int):
    """``w`` as a 2-D weight, its first ``nc`` dims folded into the rows
    and the rest into the columns.  A block along dim ``nc`` (the first
    output dim) stays a block, of the folded columns; a block along any
    other dim is refused."""
    if not isinstance(w, RankBlock):
        return w.reshape(int(np.prod(w.shape[:nc])), -1)
    if w.dim != nc:
        raise ValueError(f"a block along dim {w.dim} of a weight whose "
                         f"first {nc} dims contract is not a column block")
    k = int(np.prod(w.data.shape[:nc]))
    return RankBlock(w.data.reshape(k, -1), 1, w.shard, w.tp)


def shard_tree(tree, specs, mesh):
    """``tree`` as this rank holds it under ``mesh`` by ``specs`` (a
    layout's :func:`param_specs` without ``fsdp``: the serve layout's for
    serving, the train layout's, whose blocks may lie along a contracted
    dim, for training): a leaf split over ``"model"`` is
    cut into ``tp`` equal blocks along that dim, and this rank keeps block
    ``mesh.shard`` as a :class:`RankBlock` of a copy of its own (so the
    whole leaf can be freed); every other leaf stays whole.  The blocks
    are the spec's: ``param_pspec`` already replicates a leaf whose dim
    ``tp`` does not divide.  A leaf that is this rank's block already
    stays as it is.  On a one-process mesh every shard runs on the one
    device, and the tree comes back as it is."""
    if getattr(mesh, "model_group", None) is None:
        return tree
    tp, s = _tp(mesh), mesh.shard

    def one(path, x):
        spec = _spec_at(specs, path)
        dims = [i for i, ax in enumerate(spec) if ax == MODEL_AXIS]
        if any(ax not in (None, MODEL_AXIS) for ax in spec) or len(dims) > 1:
            raise ValueError(f"{path}: spec {spec} is not a rank-block "
                             "spec (one model-axis dim, no data axes)")
        if isinstance(x, RankBlock):
            if dims != [x.dim] or (x.shard, x.tp) != (s, tp):
                raise ValueError(f"{path}: block {x.shard} of {x.tp} along "
                                 f"dim {x.dim}, where this rank holds block "
                                 f"{s} of {tp} by the spec {spec}")
            return x
        if not dims:
            return x
        n = x.shape[dims[0]] // tp
        return RankBlock(x.narrow(dims[0], s * n, n).clone(), dims[0], s, tp)

    return map_with_path(one, tree)


_MESH = None
_LAYOUT = "serve"


def serve_mesh_active():
    """The mesh of the enclosing :func:`serve_mesh_scope`, if any."""
    return _MESH if _LAYOUT == "serve" else None


@contextlib.contextmanager
def _mesh_scope(mesh, layout: str):
    global _MESH, _LAYOUT
    prev = _MESH, _LAYOUT
    _MESH, _LAYOUT = mesh, layout
    try:
        yield
    finally:
        _MESH, _LAYOUT = prev


def serve_mesh_scope(mesh):
    """Put ``mesh`` in scope for the serve layout's op-boundary hooks (the
    mesh engine enters it around a generation)."""
    return _mesh_scope(mesh, "serve")


def train_mesh_scope(mesh):
    """Put ``mesh`` in scope for the train layout's op-boundary hooks (the
    train step enters it around its forward and backward): there a
    block along a contracted dimension is computed, its partial sums
    all-reduced."""
    return _mesh_scope(mesh, "train")


def _rank_mesh():
    """The mesh in scope when its model axis spans ranks, else ``None``."""
    mesh = _MESH
    return mesh if getattr(mesh, "model_group", None) is not None else None


def _block_mesh(w: RankBlock):
    """The rank mesh in scope; raise unless ``w`` is a block of it."""
    mesh = _rank_mesh()
    if mesh is None or (mesh.shard, _tp(mesh)) != (w.shard, w.tp):
        where = "no rank mesh" if mesh is None else \
            f"shard {mesh.shard} of {_tp(mesh)}"
        raise RuntimeError(f"block {w.shard} of {w.tp} computed under "
                           f"{where}: it is not the whole weight")
    return mesh


def block_product(x, w, product, out_dims: Dict[int, int],
                  in_dims: Optional[Dict[int, int]] = None) -> torch.Tensor:
    """``product(x, w)`` as the whole output, for a weight leaf ``w``.

    The one place where a rank's block meets the model: for a
    :class:`RankBlock` ``w`` (under the rank mesh it is a block of),
    ``product(x, w)`` is this rank's block of the output along
    ``out_dims[w.dim]`` (the output dim that ``w``'s block dim becomes),
    gathered over the mesh's model group in shard order.  Under the
    train layout's scope (:func:`train_mesh_scope`) a block along a
    contracted dim (``in_dims[w.dim]``: the dim of ``x`` it contracts
    with) takes the matching slice of ``x``, and the ranks' partial
    products are all-reduced.  ``x`` enters through
    :func:`~repro_torch.distributed.collectives.copy_to_model`, so the
    backward sums the ranks' parts of its gradient.  Under the serve
    layout a contracted block is refused: its output is not a block of
    the whole.  ``product`` reads the block's tensor through
    :func:`held`, or hands the block to
    :func:`repro_torch.kernels.ops.aged_linear`, which computes the
    block's columns at its own shard's BER and stream."""
    if not isinstance(w, RankBlock):
        return product(x, w)
    group = _block_mesh(w).model_group
    if w.dim in out_dims:
        return gather_from_model(product(copy_to_model(x, group), w),
                                 out_dims[w.dim], group)
    if _LAYOUT != "train" or w.dim not in (in_dims or {}):
        raise ValueError(f"a block along dim {w.dim} is contracted by this "
                         "product: its output is not a block of the whole")
    part = copy_to_model(x, group).narrow(
        in_dims[w.dim], w.span.start, w.span.stop - w.span.start)
    return reduce_from_model(product(part, w), group)


def lookup_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``table``'s rows ``ids``, whole.  A rank's column block of the
    table gives the rows' columns, gathered along the last dim; a row
    (vocab) block looks up the ids it owns, the ranks' lookups are
    gathered, and each id takes its owner's row — pure data movement,
    where the reference adds the non-owners' zeros.  Both gathers pass
    the gradient of the rank's part back to its block."""
    if not isinstance(table, RankBlock):
        return F.embedding(ids, table)
    group = _block_mesh(table).model_group
    if table.dim == 1:
        return gather_from_model(F.embedding(ids, table.data), -1, group)
    n = table.data.shape[0]
    local = ids - table.span.start
    own = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(own, local, 0), table.data)
    every = gather_from_model(rows[None], 0, group)      # (tp, ..., d)
    owner = torch.div(ids, n, rounding_mode="floor").to(torch.int64)
    return torch.take_along_dim(every, owner[None, ..., None], dim=0)[0]


# the reference's activation constraint (its ``set_activation_sharding``):
# a spec of (B, S, d) activations, or None
_ACTIVATION_SHARDING = None


def set_activation_sharding(spec) -> None:
    """Set the constraint :func:`constrain_activation` applies at each
    layer group's start: ``None``, or a spec of ``(B, S, d)`` activations
    whose batch entry names the data axes (the reference's
    ``NamedSharding(mesh, P(batch, None, None))``).  Its reader is the
    hill-climb tool (ROADMAP A.10 item 3)."""
    global _ACTIVATION_SHARDING
    if spec is not None and (len(spec) != 3 or any(
            e is not None for e in spec[1:]) or MODEL_AXIS in (
            spec[0] if isinstance(spec[0], tuple) else (spec[0],))):
        raise ValueError(f"activation spec {spec}: (B, S, d) with only the "
                         "batch over the data axes")
    _ACTIVATION_SHARDING = spec


def constrain_activation(x: torch.Tensor) -> torch.Tensor:
    """``x`` pinned to the set activation spec, called where the
    reference calls it (each layer group's start).  The reference pins the
    batch axis of a carry GSPMD may have replicated; over ranks each data
    replica already holds only its own rows of the batch, and on one
    device there is nothing to place, so the constraint is the identity on
    values: ``x`` comes back as it is."""
    return x


def serve_shard_map_info(n_out: int) -> Optional[Tuple[Any, str, int]]:
    """``(mesh, "model", tp)`` when the serve mesh in scope has tensor
    parallelism and ``n_out`` output columns split evenly over it (each
    shard's column block is then the block
    :func:`repro_torch.kernels.ops.shard_slices` assigns), else ``None`` —
    the reference's rule for its ``shard_map`` kernel route."""
    mesh = serve_mesh_active()
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return None
    tp = _tp(mesh)
    if tp <= 1 or n_out % tp != 0:
        return None
    return mesh, MODEL_AXIS, tp
