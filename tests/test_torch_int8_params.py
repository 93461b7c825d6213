"""The int8 weight tree (repro_torch.models.transformer.quantize_params /
dequant_tree) against the reference's on the CPU, bit for bit: the
port's quantisation of a carried-across tree equals the reference's
int8 tree carried across, for every family's reduced config, including
a recurrentgemma of 4 layers whose tail layer keeps its 1-D leaves
unquantised; the per-layer dequantisation and the embedding rows equal
the reference's bf16 values; the refusals (enc-dec, training, the rank
mesh)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_tf
from repro_torch.convert import params_from_reference
from repro_torch.models import transformer as tf
from repro_torch.tree import items
from torch_int8_common import (DECODER_ARCHS, configs, int8_pair,
                               reference_params, to_numpy)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)


def _same(got, want):
    """Two port trees equal leaf for leaf: paths, dtypes and bits."""
    g, w = dict(items(got)), dict(items(want))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,kw", [(a, {}) for a in DECODER_ARCHS]
                         + [("recurrentgemma_2b", {"n_layers": 4}),
                            ("whisper_large_v3", {})],
                         ids=list(DECODER_ARCHS)
                         + ["recurrentgemma_2b-tail", "whisper_large_v3"])
def test_quantize_params_bit_exact(arch, kw, dtype):
    cfg_j, cfg = configs(arch, **kw)
    params_j = reference_params(cfg_j, seed=3, dtype=getattr(jnp, dtype))
    want = params_from_reference(to_numpy(jax_tf.quantize_params(params_j)),
                                 cfg, dtype=getattr(torch, dtype),
                                 device="cpu")
    params = params_from_reference(to_numpy(params_j), cfg,
                                   dtype=getattr(torch, dtype), device="cpu")
    _same(tf.quantize_params(params, cfg), want)


def test_tail_layer_keeps_its_vectors():
    """recurrentgemma at 4 layers over its 3-block pattern: layers 0-2 are
    the reference's stacked group (a norm scale is quantised, one scale a
    layer), layer 3 its tail (the same leaf stays bf16), and the top-level
    final norm stays bf16."""
    _, cfg, _, q = int8_pair("recurrentgemma_2b", n_layers=4)
    assert tf.is_qleaf(q["layers"][0]["norm1"]["scale"])
    assert q["layers"][0]["norm1"]["scale"]["int8_s"].shape == (1,)
    assert tf.is_qleaf(q["layers"][0]["rglru"]["lam"])
    assert not tf.is_qleaf(q["layers"][3]["norm1"]["scale"])
    assert q["layers"][3]["norm1"]["scale"].dtype == torch.bfloat16
    assert tf.is_qleaf(q["layers"][3]["ffn"]["w_up"])
    assert not tf.is_qleaf(q["final_norm"]["scale"])


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_3b"])
def test_dequant_and_embed_rows_bit_exact(arch):
    """Each layer's bf16 dequantisation and the embedding rows (gathered
    int8, dequantised in bf16) equal the reference's."""
    cfg_j, cfg, q_j, q = int8_pair(arch)
    want = params_from_reference(
        to_numpy(jax_tf.dequant_tree(q_j, jnp.bfloat16)), cfg,
        dtype=torch.bfloat16, device="cpu")
    got = dict(items(tf.dequant_tree(q, torch.bfloat16)))
    for path, w in items(want):      # convert keeps FLOAT32_LEAVES float32
        torch.testing.assert_close(got[path].to(w.dtype), w, rtol=0, atol=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5))
    e_j = np.asarray(jax_tf.embed_tokens(q_j, cfg_j, jnp.asarray(toks))
                     .astype(jnp.float32))
    e = tf.embed_tokens(q, cfg, torch.as_tensor(toks))
    assert e.dtype == torch.bfloat16
    np.testing.assert_array_equal(e.to(torch.float32).numpy(), e_j)


def test_int8_tree_halves_the_bytes():
    """The int8 tree's bytes are ~half the bf16 tree's (a float32 scale a
    row beside the int8 values)."""
    _, cfg = configs("llama3_8b")
    p = tf.init_params(cfg, 0, device="cpu")
    nbytes = lambda t: sum(x.numel() * x.element_size()
                           for _, x in items(t))
    ratio = nbytes(tf.quantize_params(p, cfg)) / nbytes(p)
    assert 0.5 < ratio < 0.6


def test_refusals():
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import MeshServeEngine
    from repro_torch.train.steps import TrainState, make_train_step
    _, cfg_w, _, q_w = int8_pair("whisper_large_v3")
    frames = torch.zeros((1, cfg_w.encoder_seq, cfg_w.d_model))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        encdec.encode(q_w, cfg_w, frames)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        ServeEngine(cfg_w, q_w, device="cpu")
    _, cfg, _, q = int8_pair("llama3_8b")
    with pytest.raises(NotImplementedError, match="A.10"):
        MeshServeEngine(cfg, q, tp=1, device="cpu")
    step = make_train_step(cfg, AdamWConfig())
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="training"):
        step(TrainState(q, adamw_init(tf.dequant_tree(q))),
             {"tokens": toks, "labels": toks})
