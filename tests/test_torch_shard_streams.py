"""Per-shard upset streams of the port against the reference on the CPU:
``shard_slices``, ``fold_seed``, ``upset_counter_block``,
``inject_bitflips_sharded`` (both splits, empty and uneven blocks), the
plain shard mode of the fused GEMM against the reference's kernel-free
oracle of its ``shard_map``-wrapped kernel, and ``aged_linear`` /
``op_linear`` / ``op_batched_matmul`` with ``(S,)`` BERs on both routes.
Every int32 word and every output is held exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch import random as prandom
from repro_torch.kernels import fused_aged_matmul as pfam
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

SHARDS = (1, 3, 4, 8)


def _words(rng, shape):
    return rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                        dtype=np.int64).astype(np.int32)


def _bers(rng, S):
    return rng.uniform(0.0, 0.05, S).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 3, 7, 32, 4096, 32064, 51866])
def test_shard_slices_and_fold_seed_match_reference(n):
    for S in SHARDS:
        assert ops.shard_slices(n, S) == jops.shard_slices(n, S)
        assert pfam.shard_bounds(n, S) == [0] + jops.shard_slices(n, S) \
            + [n]
    for seed in (0, 1, -1, 2 ** 31 - 1, -2 ** 31, 123456789):
        for s in range(8):
            assert ops.fold_seed(seed, s) == int(jops.fold_seed(
                jnp.int32(seed), jnp.uint32(s)))


@pytest.mark.parametrize("M,N", [(1, 1), (37, 300)])
def test_upset_counter_block_matches_reference(M, N):
    rng = np.random.default_rng(M * 1000 + N)
    acc = _words(rng, (M, N))
    got = ops.upset_counter_block(torch.from_numpy(acc), 0.03, -77)
    want = jops.upset_counter_block(jnp.asarray(acc), jnp.float32(0.03),
                                    jnp.int32(-77))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("shape,axis", [
    ((2, 5, 37), -1), ((3, 3), -1), ((2, 6, 5, 9), 1), ((2, 2, 4, 3), 1),
    ((2, 5, 300, 17), 1), ((4, 7), 0)],
    ids=["cols", "cols_fewer_than_S", "heads", "heads_fewer_than_S",
         "heads_tall", "rows_2d"])
def test_inject_bitflips_sharded_matches_reference(shape, axis, S):
    """Both splits, bit for bit, with empty blocks where the split axis is
    shorter than S and uneven ones where S does not divide it; the plain
    pass and the counter-upset kernel's wrapper (its plain version here)
    agree."""
    rng = np.random.default_rng(hash((shape, axis, S)) % 2 ** 32)
    x = _words(rng, shape)
    bers = _bers(rng, S)
    want = np.asarray(jops.inject_bitflips_sharded(
        jnp.asarray(x), jnp.asarray(bers), seed=jnp.int32(-1234),
        axis=axis))
    pbers = tuple(float(b) for b in bers)
    for use_kernel in (False, True):
        got = ops.inject_bitflips_sharded(torch.from_numpy(x), pbers,
                                          seed=-1234, axis=axis,
                                          use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want != x).any() or x.size < 16


def test_inject_bitflips_sharded_from_a_key_matches_reference():
    import jax
    rng = np.random.default_rng(5)
    x = _words(rng, (16, 40))
    bers = _bers(rng, 4)
    want = jops.inject_bitflips_sharded(jnp.asarray(x), jnp.asarray(bers),
                                        jax.random.PRNGKey(9))
    got = ops.inject_bitflips_sharded(torch.from_numpy(x),
                                      tuple(float(b) for b in bers),
                                      prandom.PRNGKey(9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", (3, 4, 8))
@pytest.mark.parametrize("M,K,N", [(5, 32, 50), (33, 16, 7),
                                   (300, 48, 600), (2, 32, 1000)])
def test_shard_mode_gemm_matches_reference_oracle(M, K, N, S):
    """The plain shard mode (each column block upset alone) equals the
    reference's kernel-free oracle of ``_fused_aged_matmul_sharded``: the
    exact product and ``inject_bitflips_sharded``; dequantised too."""
    rng = np.random.default_rng(M * K + N + S)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    bers = _bers(rng, S)
    acc = jops.inject_bitflips_sharded(
        jref.systolic_matmul_ref(jnp.asarray(a), jnp.asarray(b)),
        jnp.asarray(bers), seed=jnp.int32(77))
    seeds = [ops.fold_seed(77, s) for s in range(S)]
    pbers = tuple(float(x) for x in bers)
    got = pfam.fused_aged_matmul_shards(torch.from_numpy(a),
                                        torch.from_numpy(b), None, None,
                                        pbers, seeds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (1, N)).astype(np.float32)
    deq = pfam.fused_aged_matmul_shards(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(xs),
        torch.from_numpy(ws), pbers, seeds)
    want = np.asarray(acc.astype(jnp.float32) * jnp.asarray(xs)
                      * jnp.asarray(ws))
    np.testing.assert_array_equal(deq.numpy(), want)
    # the plain version's tables equal the kernel's own bounds
    assert ref.fused_aged_matmul_shards_ref(
        torch.from_numpy(a), torch.from_numpy(b), None, None, pbers, seeds,
        pfam.shard_bounds(N, S)).equal(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,N", [(4, 96), (3, 100), (4, 6), (8, 520)])
def test_aged_linear_with_shard_bers_matches_reference(S, N, dtype):
    """``aged_linear`` with ``(S,)`` BERs on the fused route (the shard
    mode) and the kernel-free route against the reference's (which runs
    kernel-free off a mesh): exact, in float32 and bf16."""
    rng = np.random.default_rng(S * N)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, N)).astype(np.float32)
    bers = rng.uniform(0.0, 0.05, S).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jops.aged_linear(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), ber=jnp.asarray(bers),
        seed=jnp.int32(-5)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    for use_kernel, fused in ((True, True), (False, False), (True, False)):
        got = ops.aged_linear(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt),
                              ber=tuple(float(b) for b in bers), seed=-5,
                              use_kernel=use_kernel, fused=fused)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_aged_linear_refuses_lanes_with_shard_bers():
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(NotImplementedError, match="lanes and per-shard"):
        ops.aged_linear(x, w, ber=((0.1, 0.2), (0.1, 0.2)), seed=(1, 2),
                        lanes=2)


@pytest.mark.parametrize("fused", [True, False])
def test_op_linear_and_batched_matmul_with_shard_bers(fused):
    """The model-facing ops under a shard config: the weight matmul on the
    shard mode or the plain route, the qkt heads on the counter-upset
    kernel's wrapper or the plain pass, both against the reference's
    FaultConfig of ``(S,)`` vectors (seeds from ``seed_for`` on both
    routes)."""
    import jax
    rng = np.random.default_rng(11)
    bers = np.asarray([1e-2, 2e-2, 3e-2, 4e-2], np.float32)
    jfi = jlayers.FaultConfig(bers={"q": jnp.asarray(bers),
                                    "qkt": jnp.asarray(bers)},
                              key=jax.random.PRNGKey(3), step=jnp.int32(2),
                              use_systolic_kernel=fused,
                              fused=fused).with_seeds()
    pfi = layers.FaultConfig(bers={"q": tuple(float(b) for b in bers),
                                   "qkt": tuple(float(b) for b in bers)},
                             key=prandom.PRNGKey(3), step=2,
                             use_systolic_kernel=fused,
                             fused=fused).with_seeds()
    assert pfi.shards("q") == tuple(float(b) for b in bers)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    want = jlayers.op_linear(jnp.asarray(x), jnp.asarray(w), "q", jfi, 5)
    got = layers.op_linear(torch.from_numpy(x), torch.from_numpy(w), "q",
                           pfi, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # (B, KV, G, S, T) scores: 8 heads over 4 shards, and 6 over 4
    for kv, g in ((4, 2), (3, 2)):
        q = rng.standard_normal((2, kv, g, 8, 16)).astype(np.float32)
        k = rng.standard_normal((2, kv, 1, 16, 8)).astype(np.float32)
        want = jlayers.op_batched_matmul(jnp.asarray(q), jnp.asarray(k),
                                         "qkt", jfi, 1)
        got = layers.op_batched_matmul(torch.from_numpy(q),
                                       torch.from_numpy(k), "qkt", pfi, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
