"""The port's kernels (repro_torch.kernels) vs the JAX reference.

On the CPU each wrapper runs its plain version; those are held bit-exact
against the Pallas kernels in interpret mode, including odd shapes that
the reference pads.  The CUDA kernels themselves are held against
the plain versions on the card by ``test_torch_cuda.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitflip import bitflip_words as jbitflip
from repro.kernels.systolic_matmul import systolic_matmul as jsystolic
from repro_torch import kernels
from repro_torch import random as prandom
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitflip import bitflip_draw, bitflip_words
from repro_torch.kernels.systolic_matmul import systolic_matmul


# the package rebinds the submodule's name to the ops-level function
jfam = importlib.import_module("repro.kernels.fused_aged_matmul")


def _int8(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k), dtype=np.int8),
            rng.integers(-128, 128, (k, n), dtype=np.int8))


T = torch.from_numpy


# --------------------------------------------------------------------------- #
# counter streams
# --------------------------------------------------------------------------- #
def test_stream_functions_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    z = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    tx, ty, tz = (T(v.astype(np.int64)) for v in (x, y, z))
    u = lambda a: np.asarray(a).astype(np.int64)
    np.testing.assert_array_equal(u(jfam.fmix32(jnp.asarray(x))),
                                  pfam.fmix32(tx).numpy())
    np.testing.assert_array_equal(
        u(jfam.stream_constant(jnp.asarray(x), jnp.asarray(y))),
        pfam.stream_constant(tx, ty).numpy())
    np.testing.assert_array_equal(
        u(jfam.counter_bits(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))),
        pfam.counter_bits(tx, ty, tz).numpy())


@pytest.mark.parametrize("M,N,bm,bn,seed", [(33, 130, 64, 256, 12345),
                                            (256, 512, 256, 256, -7),
                                            (2, 14, 8, 16, 2 ** 31 - 1)])
def test_tile_counter_bits_bit_exact(M, N, bm, bn, seed):
    np.testing.assert_array_equal(
        np.asarray(jfam.tile_counter_bits(M, N, seed, bm=bm, bn=bn))
        .astype(np.int64),
        pfam.tile_counter_bits(M, N, seed, bm=bm, bn=bn).numpy())


def test_fold_seed_and_seed_from_key_bit_exact():
    for s, idx in [(5, (3, 0)), (-123456, (31, 7)), (2 ** 31 - 1, (0,)),
                   (0, (1, 2, 3))]:
        assert int(jops.fold_seed(jnp.int32(s), *idx)) == \
            ops.fold_seed(s, *idx)
    for k in (0, 3, 99):
        assert int(jops.seed_from_key(jax.random.PRNGKey(k))) == \
            ops.seed_from_key(prandom.PRNGKey(k))


@pytest.mark.parametrize("ber", [0.0, 1e-9, 1e-7, 3.3e-5, 1e-3, 0.01, 0.3])
def test_upset_probability_matches_jnp_float32(ber):
    q = 1.0 - (1.0 - jnp.asarray(ber, jnp.float32)) ** 32
    assert float(q) == pfam.upset_probability(ber)


# --------------------------------------------------------------------------- #
# plain kernels vs Pallas interpret
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (33, 96, 130), (7, 5, 3)])
def test_systolic_plain_matches_pallas(m, k, n):
    a, b = _int8(m, k, n, m + k + n)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    np.testing.assert_array_equal(systolic_matmul(T(a), T(b)).numpy(), want)
    if (m, k, n) == (256, 512, 256):        # the unpadded kernel itself
        np.testing.assert_array_equal(
            np.asarray(jsystolic(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)), want)


def test_systolic_accumulator_width():
    K = 2048
    a = torch.full((8, K), 127, dtype=torch.int8)
    b = torch.full((K, 8), 127, dtype=torch.int8)
    assert int(ops.quantized_matmul(a, b)[0, 0]) == 127 * 127 * K


@pytest.mark.parametrize("m,k,n,ber,seed", [(256, 512, 256, 1e-3, 42),
                                            (33, 96, 130, 1e-3, 8),
                                            (7, 5, 3, 1e-2, -8),
                                            (32, 300, 64, 1e-3, 99)])
def test_fused_plain_matches_pallas(m, k, n, ber, seed):
    """int32 and dequantised float32 outputs, odd shapes included (the
    reference pads, the port masks; live words draw the same bits)."""
    a, b = _int8(m, k, n, seed & 0xFF)
    rng = np.random.default_rng(3)
    xs = (rng.random((m, 1), dtype=np.float32) + 0.5)
    ws = (rng.random((1, n), dtype=np.float32) + 0.5)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = np.asarray(jops.fused_aged_matmul(ja, jb, ber=ber, seed=seed,
                                             interpret=True))
    got = ops.fused_aged_matmul(T(a), T(b), ber=ber, seed=seed).numpy()
    np.testing.assert_array_equal(got, want)
    clean = np.asarray(jref.systolic_matmul_ref(ja, jb))
    assert (want != clean).any() or m * n < 100
    want = np.asarray(jops.fused_aged_matmul(ja, jb, jnp.asarray(xs),
                                             jnp.asarray(ws), ber=ber,
                                             seed=seed, interpret=True))
    got = ops.fused_aged_matmul(T(a), T(b), T(xs), T(ws), ber=ber,
                                seed=seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bitflip_plain_matches_pallas():
    rng = np.random.default_rng(5)
    x = rng.integers(-2 ** 31, 2 ** 31, (512, 128), dtype=np.int64) \
        .astype(np.int32)
    u = rng.random((512, 128), dtype=np.float32)
    pos = rng.integers(0, 32, (512, 128), dtype=np.int32)
    q = 0.05
    want = np.asarray(jbitflip(jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(pos), jnp.float32([q]),
                               interpret=True))
    got = bitflip_words(T(x), T(u), T(pos), q).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any()


@pytest.mark.parametrize("shape", [(33, 130), (2, 8, 4, 1, 64)])
def test_inject_bitflips_matches_reference(shape):
    """Kernel pass and plain pass (the draw mode over the live words) vs
    the reference's passes over its padded (rows_pad, 128) draws."""
    rng = np.random.default_rng(6)
    x = rng.integers(-2 ** 30, 2 ** 30, shape, dtype=np.int64) \
        .astype(np.int32)
    jkey, pkey = jax.random.PRNGKey(4), prandom.PRNGKey(4)
    want = np.asarray(jops.inject_bitflips(jnp.asarray(x), 1e-2, jkey,
                                           interpret=True))
    np.testing.assert_array_equal(
        ops.inject_bitflips(T(x), 1e-2, pkey).numpy(), want)
    np.testing.assert_array_equal(
        ops.inject_bitflips_ref(T(x), 1e-2, pkey).numpy(),
        np.asarray(jops.inject_bitflips_ref(jnp.asarray(x), 1e-2, jkey)))
    assert (want != x).any()


# the serve path's qkt/sv words (llama3_8b, B=2, prompt 16, max_len 64:
# decode qkt, prefill qkt, prefill sv), ragged word counts, and counts on
# either side of a rows_pad boundary (256 rows of 128 words)
DRAW_SHAPES = [(2, 8, 4, 1, 64), (2, 8, 4, 16, 16), (2, 8, 4, 16, 128),
               (3, 5, 7), (1,), (256, 128), (256 * 128 + 1,)]


@pytest.mark.parametrize("ber", [1e-2, 0.3])
@pytest.mark.parametrize("shape", DRAW_SHAPES)
def test_inject_bitflips_draw_matches_reference(shape, ber):
    """The draw-mode pass over the live words (plain version, and the CPU
    ``inject_bitflips`` that takes it) equals the reference's padded kernel
    pass in interpret mode and its plain pass, bit for bit."""
    rng = np.random.default_rng(9)
    x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)
    jkey, pkey = jax.random.PRNGKey(11), prandom.PRNGKey(11)
    want = np.asarray(jops.inject_bitflips(jnp.asarray(x), ber, jkey,
                                           interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jops.inject_bitflips_ref(jnp.asarray(x), ber, jkey)), want)
    q = pfam.upset_probability(ber)
    got = ref.bitflip_draw_ref(T(x), ops.flip_key_words(pkey), q).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.inject_bitflips(T(x), ber, pkey).numpy(), want)
    np.testing.assert_array_equal(
        ops.inject_bitflips_ref(T(x), ber, pkey).numpy(), want)
    if x.size >= 100:
        assert (want != x).any()


@pytest.mark.parametrize("rows,bigger", [(256, 512), (1024, 2048),
                                         (256, 1024)])
def test_flip_draws_do_not_depend_on_shape(rows, bigger):
    """The premise of the draw mode: the reference's randoms over
    ``(rows_pad, 128)`` are the first words of a larger draw's, and so of a
    flat draw over any word count."""
    key = jax.random.PRNGKey(3)
    u, pos = jops.make_flip_randoms(key, (rows, 128))
    ub, posb = jops.make_flip_randoms(key, (bigger, 128))
    uf, posf = jops.make_flip_randoms(key, (rows * 128 + 5,))
    for small, big in ((u, ub), (pos, posb)):
        np.testing.assert_array_equal(np.asarray(small),
                                      np.asarray(big)[:rows])
    np.testing.assert_array_equal(np.asarray(u).reshape(-1),
                                  np.asarray(uf)[:rows * 128])
    np.testing.assert_array_equal(np.asarray(pos).reshape(-1),
                                  np.asarray(posf)[:rows * 128])


@pytest.mark.parametrize("seed", [0, 4, 2 ** 31 - 1])
def test_flip_key_words_are_split_twice(seed):
    """``(ku, split(kp)[1])`` with ``ku, kp = split(key)``, against the
    port's and jax's ``split``; and the explicit randoms the reference
    passes drawn from them."""
    pkey = prandom.PRNGKey(seed)
    ku, kp = prandom.split(pkey)
    _, kl = prandom.split(kp)
    words = ops.flip_key_words(pkey)
    assert words == (*ku.tolist(), *kl.tolist())
    jku, jkp = jax.random.split(jax.random.PRNGKey(seed))
    _, jkl = jax.random.split(jkp)
    assert words == tuple(int(v) for v in np.concatenate(
        [np.asarray(jku), np.asarray(jkl)]))
    u, pos = ops.make_flip_randoms(pkey, (2, 128))
    index = torch.arange(256)
    assert torch.equal(u.reshape(-1), prandom.float_from_bits(
        prandom.bits_at(words[0], words[1], index)))
    assert torch.equal(pos.reshape(-1), (prandom.bits_at(
        words[2], words[3], index) & 31).to(torch.int32))


def test_bitflip_draw_equals_explicit_pass_over_padding():
    """The port's old three-step flow (pad to ``(rows_pad, 128)``, draw,
    explicit-randoms pass, slice) and the draw mode agree."""
    rng = np.random.default_rng(12)
    x = T(rng.integers(-2 ** 31, 2 ** 31, (300, 7), dtype=np.int64)
          .astype(np.int32))
    key, q = prandom.PRNGKey(8), pfam.upset_probability(0.05)
    xf = torch.nn.functional.pad(x.reshape(-1), (0, 256 * 128 - x.numel()))
    u, pos = ops.make_flip_randoms(key, (256, 128))
    old = bitflip_words(xf.reshape(256, 128), u, pos, q)
    old = old.reshape(-1)[:x.numel()].reshape(x.shape)
    assert torch.equal(bitflip_draw(x, ops.flip_key_words(key), q), old)
    assert bool((old != x).any())


def test_bitflip_draw_checks_operands():
    words = ops.flip_key_words(prandom.PRNGKey(0))
    with pytest.raises(TypeError):
        bitflip_draw(torch.zeros(8, dtype=torch.int64), words, 0.1)
    with pytest.raises(ValueError):
        bitflip_draw(torch.zeros(8, dtype=torch.int32), words[:3], 0.1)
    with pytest.raises(ValueError):            # no kernel, no fallback
        bitflip_draw(torch.zeros(8, dtype=torch.int32, device="meta"),
                     words, 0.1)


@pytest.mark.parametrize("route", ["fused", "three_pass", "kernel_free"])
def test_aged_linear_routes_bit_exact(route):
    """All three scalar-BER routes in float32 at BER 1e-3."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 33, 96)).astype(np.float32)
    w = rng.standard_normal((96, 130)).astype(np.float32)
    kw = {"fused": dict(use_kernel=True, fused=True),
          "three_pass": dict(use_kernel=True, fused=False),
          "kernel_free": dict(use_kernel=False, fused=False)}[route]
    if route == "fused":
        want = jops.aged_linear(jnp.asarray(x), jnp.asarray(w), ber=1e-3,
                                seed=5, interpret=True, **kw)
        got = ops.aged_linear(T(x), T(w), ber=1e-3, seed=5, **kw)
    else:
        want = jops.aged_linear(jnp.asarray(x), jnp.asarray(w), ber=1e-3,
                                key=jax.random.PRNGKey(5), interpret=True,
                                **kw)
        got = ops.aged_linear(T(x), T(w), ber=1e-3, key=prandom.PRNGKey(5),
                              **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    for axis in (-1, 0):
        jq, js = jops.quantize_int8(jnp.asarray(x), axis=axis)
        pq, ps = ops.quantize_int8(T(x), axis=axis)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    a, b = _int8(8, 16, 8, 0)
    ops.fused_aged_matmul(T(a), T(b), ber=1e-3, seed=1)
    ops.quantized_matmul(T(a), T(b))
    ops.inject_bitflips(torch.zeros((4, 4), dtype=torch.int32), 1e-3,
                        prandom.PRNGKey(0))
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNEL_NAMES}


def test_wrappers_check_operands():
    a, b = _int8(8, 16, 8, 0)
    with pytest.raises(TypeError):
        systolic_matmul(T(a).float(), T(b))
    with pytest.raises(ValueError):
        systolic_matmul(T(a), T(b)[:5])
    with pytest.raises(ValueError):
        bitflip_words(torch.zeros((100, 128), dtype=torch.int32),
                      torch.zeros((100, 128)),
                      torch.zeros((100, 128), dtype=torch.int32), 0.1)
    with pytest.raises(ValueError):            # no kernel, no fallback
        systolic_matmul(T(a).to("meta"), T(b).to("meta"))
