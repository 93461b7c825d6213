"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's ``PartitionSpec``s on the CPU: ``param_specs``
(serve and train layouts, with and without fsdp) over the whole zoo at
full size x tp in {2, 4, 8, 16}, ``state_specs``, ``batch_spec``,
``input_shardings``, ``cache_specs`` and ``encdec_cache_spec``, under the
reference tests' duck-typed ``FakeMesh``; and the logical meshes of
``repro_torch.launch.mesh``.

The port keeps one dict per layer, so a port leaf's spec is the
reference's spec of the stacked leaf without its leading stack entries;
the full-size trees are the reference's ``eval_shape`` trees unstacked as
:mod:`repro_torch.convert` unstacks real ones (checked against the
port's own reduced trees)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models import encdec as jax_encdec
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as pmesh
from repro_torch.models import family
from repro_torch.tree import items

TPS = (2, 4, 8, 16)
STACKS = ("groups", "enc_layers", "dec_layers")


class FakeMesh:
    """Duck-typed mesh: shape mapping + axis_names (no devices needed)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


@dataclasses.dataclass
class Leaf:
    shape: tuple


def _abstract(cfg):
    init = jax_encdec.init_params if cfg.n_encoder_layers \
        else jax_tf.init_params
    return jax.eval_shape(lambda k: init(cfg, k, jnp.bfloat16),
                          jax.random.PRNGKey(0))


def _path(kp) -> tuple:
    out = []
    for e in kp:
        if isinstance(e, jax.tree_util.DictKey):
            out.append(str(e.key))
        elif isinstance(e, jax.tree_util.SequenceKey):
            out.append(e.idx)
        else:
            out.append(str(e))
    return tuple(out)


def _unstacked(jtree, cfg) -> dict:
    """``{port path: (shape, reference path, stacked axes)}`` of every
    leaf, in the port's layout (one entry per layer)."""
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        p = _path(kp)
        shape = tuple(leaf.shape)
        if p[0] in ("enc_layers", "dec_layers"):
            for g in range(shape[0]):
                out["/".join(map(str, (p[0], g) + p[1:]))] = (
                    shape[1:], p, 1)
        elif p[0] == "groups":
            i = int(p[1].split("_")[0][1:])
            for g in range(n_groups):
                out["/".join(map(str, ("layers", g * len(pat) + i)
                                 + p[2:]))] = (shape[1:], p, 1)
        elif p[0] == "tail":
            layer = n_groups * len(pat) + p[1]
            out["/".join(map(str, ("layers", layer) + p[3:]))] = (
                shape, p, 0)
        else:
            out["/".join(map(str, p))] = (shape, p, 0)
    return out


def _norm(spec, n_stack: int = 0) -> tuple:
    """A reference spec as the port writes it: the entries of the
    unstacked dims, ``()`` when replicated."""
    t = tuple(spec)[n_stack:] if len(tuple(spec)) else ()
    return () if all(a is None for a in t) else t


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_over_the_zoo(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jtree = _abstract(jcfg)
    leaves = _unstacked(jtree, jcfg)
    tree = {}
    for path, (shape, _, _) in leaves.items():
        tree[path] = Leaf(shape)
    for tp in TPS:
        for mesh in (FakeMesh({"data": 4, "model": tp}),
                     FakeMesh({"pod": 2, "data": 2, "model": tp})):
            for layout in ("serve", "train"):
                for fsdp in (False, True):
                    jspecs = jsh.param_specs(jtree, jcfg, mesh, fsdp=fsdp,
                                             layout=layout)
                    flat = {
                        _path(kp): s for kp, s in
                        jax.tree_util.tree_flatten_with_path(
                            jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
                    for path, (shape, jpath, n_stack) in leaves.items():
                        got = sh.param_pspec(path, Leaf(shape), cfg, mesh,
                                             fsdp=fsdp, layout=layout)
                        want = _norm(flat[jpath], n_stack)
                        assert got == want, (arch, tp, layout, fsdp, path)


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_moe_235b",
                                  "whisper_large_v3", "rwkv6_3b",
                                  "recurrentgemma_2b", "paligemma_3b"])
def test_port_trees_are_the_unstacked_reference_trees(arch):
    """The port's own (reduced) parameter tree has exactly the unstacked
    paths and shapes the spec comparison walks, and ``param_specs`` maps
    it leaf for leaf (state specs too)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params = family.init_params(cfg, 0, torch.float32, device="cpu")
    got = {p: tuple(x.shape) for p, x in items(params)}
    want = {p: v[0] for p, v in _unstacked(_abstract(jcfg), jcfg).items()}
    assert got == want
    mesh = FakeMesh({"data": 2, "model": 4})
    specs = sh.param_specs(params, cfg, mesh, layout="serve")
    for p, x in items(params):
        node = specs
        for k in p.split("/"):
            node = node[int(k) if isinstance(node, list) else k]
        assert node == sh.param_pspec(p, x, cfg, mesh, layout="serve")
    state = {"params": params, "step": torch.zeros(())}
    st = sh.state_specs(state, cfg, mesh, fsdp=True)
    assert st["step"] == ()
    assert st["params"]["embed"] == sh.param_pspec(
        "params/embed", params["embed"], cfg, mesh, fsdp=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_input_and_cache_specs_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for tp in (1,) + TPS:
        for shape in ({"data": 4, "model": tp},
                      {"pod": 2, "data": 2, "model": tp}):
            mesh = FakeMesh(shape)
            for batch in (1, 2, 3, 4, 8, 256):
                assert sh.batch_spec(batch, mesh) == jsh.batch_spec(batch,
                                                                    mesh)
                for kind in ("train", "serve"):
                    got = sh.input_shardings(cfg, mesh, batch, kind)
                    want = _input_specs(jcfg, mesh, batch, kind)
                    assert got == want
                if cfg.n_encoder_layers:
                    got = sh.encdec_cache_spec(cfg, mesh, batch)
                    want = jsh.encdec_cache_spec(jcfg, mesh, batch)
                    assert got == {k: tuple(v) for k, v in want.items()}
                else:
                    got = sh.cache_specs(cfg, mesh, batch)
                    want = jax.tree.map(tuple, jsh.cache_specs(
                        jcfg, mesh, batch), is_leaf=lambda x: isinstance(
                            x, P))
                    assert got == want
    assert sh.data_axes(FakeMesh({"pod": 2, "data": 2, "model": 4})) == \
        ("pod", "data")


def _input_specs(jcfg, mesh, batch, kind):
    """The reference's input_shardings as specs (it builds NamedShardings
    over a real mesh, so its rule is restated on the fake one)."""
    b = jsh.batch_spec(batch, mesh)
    out = {"tokens": tuple(P(b, None))}
    if kind == "train":
        out["labels"] = tuple(P(b, None))
    if jcfg.prefix_tokens:
        out["prefix_embeds"] = tuple(P(b, None, None))
    if jcfg.n_encoder_layers:
        out["frames"] = tuple(P(b, None, None))
    return out


def test_logical_meshes():
    m = pmesh.make_serve_mesh(4, device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 1,
                                                             "model": 4}
    assert m.size == 4 and sh._tp(m) == 4 and sh._dp(m) == 1
    assert pmesh.make_serve_mesh(device="cpu").shape["model"] == 1
    p = pmesh.make_production_mesh(device="cpu")
    assert p.shape == {"data": 16, "model": 16}
    mp = pmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    # the rules read a logical mesh as they read the reference's
    cfg, jcfg = get_config("llama3_8b"), jax_get_config("llama3_8b")
    fake = FakeMesh({"data": 16, "model": 16})
    assert sh.cache_specs(cfg, p, 8) == jax.tree.map(
        tuple, jsh.cache_specs(jcfg, fake, 8),
        is_leaf=lambda x: isinstance(x, P))
    assert pmesh.make_local_mesh(device="cpu").shape == {"data": 1,
                                                         "model": 1}
    with pytest.raises(ValueError, match="model=2"):
        pmesh.make_local_mesh(2, device="cpu")
