"""The port's threefry (repro_torch.random) vs jax.random, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as prandom

SHAPES = [(), (7,), (3, 5, 2), (256, 128)]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, -5, 2 ** 31 - 1, 123456789])
def test_prngkey(seed):
    np.testing.assert_array_equal(_np(jax.random.PRNGKey(seed)),
                                  prandom.PRNGKey(seed).numpy())


@pytest.mark.parametrize("num", [1, 2, 5])
def test_split(num):
    for seed in (0, 7):
        np.testing.assert_array_equal(
            _np(jax.random.split(jax.random.PRNGKey(seed), num)),
            prandom.split(prandom.PRNGKey(seed), num).numpy())


@pytest.mark.parametrize("data", [0, 3, 31, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_in(data):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    pkey = prandom.fold_in(prandom.PRNGKey(11), 4)
    np.testing.assert_array_equal(
        _np(jax.random.fold_in(key, np.uint32(data))),
        prandom.fold_in(pkey, data).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(shape):
    out = prandom.bits(prandom.PRNGKey(7), shape)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(
        _np(jax.random.bits(jax.random.PRNGKey(7), shape, jnp.uint32)),
        out.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape):
    out = prandom.uniform(prandom.PRNGKey(9), shape)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jax.random.PRNGKey(9), shape,
                                      jnp.float32)), out.numpy())


@pytest.mark.parametrize("lo,hi", [(0, 32), (0, 100), (-128, 128),
                                   (-2 ** 30, 2 ** 30), (5, 5), (3, 70000),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(), (256, 128)])
def test_randint(shape, lo, hi):
    """Includes spans whose jax multiplier wraps in uint32 (2**31 - 1) and
    ones that need both draws (100, 70000)."""
    out = prandom.randint(prandom.PRNGKey(3), shape, lo, hi)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jax.random.PRNGKey(3), shape, lo, hi,
                                      jnp.int32)), out.numpy())


def test_mul32_low_word_exact_on_int64_tensors():
    """The 16-bit split keeps every partial product below 2**48, so the
    masked low word of a 32x32-bit product is exact in int64."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    a[:3] = b[:3] = 2 ** 32 - 1
    want = np.array([(int(x) * int(y)) % 2 ** 32 for x, y in zip(a, b)],
                    np.int64)
    got = prandom.mul32(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert prandom.mul32(int(a[5]), int(b[5])) == want[5]


def test_keys_live_on_host_draws_on_requested_device():
    key = prandom.PRNGKey(1)
    assert key.device.type == "cpu" and key.dtype == torch.int64
    assert prandom.uniform(key, (4,), device="cpu").device.type == "cpu"
