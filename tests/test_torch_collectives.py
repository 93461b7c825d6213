"""The port's int8 error-feedback gradient mean
(``repro_torch.distributed.collectives``) over gloo groups of 1, 2 and 4
ranks against the reference's ``psum_compressed_leaf`` under
``jax.vmap(axis_name="data")``: the same numpy gradients and residuals,
row ``r`` on rank ``r``.

A port tree keeps a decoder's layers as a list; the reference stacks
them, so ``layers/i/w`` is slice ``i`` of the reference's leaf
``layers_w`` and shares its scale.  The ranks are spawned once for the
module (4 ranks; groups of the first 1 and 2 ranks made from them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.distributed.collectives import (psum_compressed_leaf,
                                           quantize_int8_global, tree_psum)
from repro_torch.distributed import collectives as col
from repro_torch.launch.mesh import run_local_ranks

SIZES = (1, 2, 4)
EF_STEPS = 40
BF16 = ("c",)
# the port's arithmetic is the reference's, step for step; where XLA may
# fuse ``gf - q * smean`` into one rounding (a fused multiply-add) or add
# the ranks' scales in another order (smean an ulp off, n = 4), the mean
# and the residual stay within 2 float32 ulps of the leaf's largest |g + r|
ULPS = 2 * 2.0 ** -23
# the plain mean sums in the leaf's dtype in another order than XLA's: n
# ulps of the largest |g|, bf16 ulps (2^-8) for the bf16 leaf
BF16_ULP = 2.0 ** -8


def _inputs(n):
    """Port-layout trees of ``(n, ...)`` gradients and residuals: leaves
    of several scales a rank, a bf16 leaf, an all-zero leaf and two layers
    of different scales (one stacked reference leaf)."""
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal((n,) + s).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, (n, 1, 1)).astype(np.float32)
    c = torch.tensor(f(16, 8)).to(torch.bfloat16).float().numpy()
    grads = {"a": f(64, 32) * scale, "b": f(3), "c": c,
             "z": np.zeros((n, 8), np.float32),
             "layers": [{"w": f(16, 8)}, {"w": f(16, 8) * 5}]}
    res = {k: (f(*v.shape[1:]) * 0.01 if k != "z" else np.zeros_like(v))
           for k, v in grads.items() if k != "layers"}
    res["layers"] = [{"w": f(16, 8) * 0.01}, {"w": f(16, 8) * 0.01}]
    return grads, res


def _reference_leaves(tree):
    """Reference leaves by name: the layers stacked on axis 1 (after the
    rank axis) into ``layers_w``."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers_w"] = np.stack([l["w"] for l in tree["layers"]], axis=1)
    return out


def _port_view(ref, path):
    """The part of reference leaf array ``ref`` (rank axis first) that
    port path ``path`` holds."""
    if path.startswith("layers/"):
        return ref[:, int(path.split("/")[1])]
    return ref


PATHS = ("a", "b", "c", "z", "layers/0/w", "layers/1/w")


def _ref_name(path):
    return "layers_w" if path.startswith("layers/") else path


def _reference_rank(g, r, n):
    """One rank's reference results for every leaf (under ``vmap``)."""
    out = {}
    for k in g:
        mean, res = psum_compressed_leaf(g[k], r[k], "data", n)
        gr = g[k].astype(jnp.float32) + r[k]
        q, s = quantize_int8_global(gr)
        out[k] = {"mean": mean.astype(jnp.float32), "res": res, "q": q,
                  "smean": jax.lax.psum(s, "data") / n, "gr": gr,
                  "plain": tree_psum({"g": g[k]}, "data",
                                     n)["g"].astype(jnp.float32)}
    return out


@pytest.fixture(scope="module")
def runs():
    inputs = {n: _inputs(n) for n in SIZES}
    port = run_local_ranks(
        ranks.collectives_rank, max(SIZES),
        {n: g for n, (g, _) in inputs.items()},
        {n: r for n, (_, r) in inputs.items()}, BF16, EF_STEPS,
        backend="gloo", device="cpu", timeout=240)
    ref = {}
    for n, (g, r) in inputs.items():
        gl, rl = _reference_leaves(g), _reference_leaves(r)
        gj = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in BF16
                                       else jnp.float32)
              for k, v in gl.items()}
        out = jax.jit(jax.vmap(lambda a, b: _reference_rank(a, b, n),
                               axis_name="data"))(gj, rl)
        ref[n] = {k: dict(jax.tree.map(np.asarray, v),
                          qsum=np.asarray(v["q"]).astype(np.int32).sum(0),
                          dtype=str(gj[k].dtype))
                  for k, v in out.items()}
    g4 = jnp.asarray(inputs[max(SIZES)][0]["a"])
    # op by op: a compiled step may fuse ``gf - q * smean`` into one
    # rounding, and over 40 steps an ulp of the residual tips a rounding
    step = jax.vmap(lambda a, b: psum_compressed_leaf(a, b, "data", 4),
                    axis_name="data")
    r4, traj = jnp.zeros_like(g4), []
    for _ in range(EF_STEPS):
        mean, r4 = step(g4, r4)
        traj.append(np.asarray(mean[0]))
    plain = np.asarray(g4).mean(0, dtype=np.float64).astype(np.float32)
    return port, ref, np.stack(traj), plain, np.asarray(g4)


def _ulps(rec, path):
    return ULPS * float(np.abs(_port_view(rec["gr"], path)).max())


@pytest.mark.parametrize("n", SIZES)
def test_quantize_exact(runs, n):
    """Every rank's int8 ``q`` of ``g + r`` (a leaf alone, as
    ``quantize_int8_global`` sees it) equals the reference's."""
    port, ref, *_ = runs
    for r in range(n):
        for path in ("a", "b", "c", "z"):
            np.testing.assert_array_equal(port[r][n]["q"][path],
                                          ref[n][path]["q"][r], err_msg=path)
            assert port[r][n]["q"][path].dtype == np.int8


@pytest.mark.parametrize("n", SIZES)
def test_int32_sums_exact(runs, n):
    """The int32 sums of every tensor, a stacked layer's against its slice
    of the reference's stacked sum, on every rank."""
    port, ref, *_ = runs
    for r in range(n):
        sums = port[r][n]["sums"]
        assert sorted(sums) == sorted(PATHS)
        for path in PATHS:
            want = _port_view(ref[n][_ref_name(path)]["qsum"][None],
                              path)[0]
            assert sums[path].dtype == np.int32
            np.testing.assert_array_equal(sums[path], want, err_msg=path)


@pytest.mark.parametrize("n", SIZES)
def test_scale_mean_within_one_ulp(runs, n):
    port, ref, *_ = runs
    for r in range(n):
        for path in ("a", "b", "c", "z"):
            got = np.float32(port[r][n]["smean"][path])
            want = np.float32(ref[n][path]["smean"][r])
            assert abs(got - want) <= np.spacing(want), (path, got, want)


@pytest.mark.parametrize("n", SIZES)
def test_mean_and_residual(runs, n):
    port, ref, *_ = runs
    for r in range(n):
        for path in PATHS:
            want = ref[n][_ref_name(path)]
            tol = _ulps(want, path)
            for key, got in (("mean", port[r][n]["mean"][path]),
                             ("res", port[r][n]["res"][path])):
                exp = _port_view(want[key], path)[r]
                np.testing.assert_allclose(got, exp, rtol=0, atol=tol,
                                           err_msg=f"{key} {path}")


@pytest.mark.parametrize("n", SIZES)
def test_bucketed_equals_per_leaf(runs, n):
    """1 KiB buckets (a leaf over several all_reduces) equal the default
    buckets bit for bit, and so does ``psum_compressed_leaf`` a leaf."""
    port, *_ = runs
    for r in range(n):
        rec = port[r][n]
        assert rec["bucketed_equal"]
        for path, (mean, res) in rec["leaf"].items():
            np.testing.assert_array_equal(mean, rec["mean"][path])
            np.testing.assert_array_equal(res, rec["res"][path])


@pytest.mark.parametrize("n", SIZES)
def test_dtype_and_structure_kept(runs, n):
    port, ref, *_ = runs
    rec = port[0][n]
    assert rec["keys"] == (["a", "b", "c", "layers", "z"], 2)
    assert rec["dtype"]["c"] == "torch.bfloat16" == \
        "torch." + ref[n]["c"]["dtype"]
    assert all(rec["dtype"][p] == "torch.float32" for p in PATHS
               if p != "c")
    assert all(v.dtype == np.float32 for v in rec["res"].values())
    np.testing.assert_array_equal(rec["mean"]["z"], 0.0)


@pytest.mark.parametrize("n", SIZES)
def test_plain_mean(runs, n):
    port, ref, *_ = runs
    for r in range(n):
        for path in PATHS:
            want = ref[n][_ref_name(path)]
            exp = _port_view(want["plain"], path)[r]
            ulp = BF16_ULP if path in BF16 else ULPS
            tol = ulp * n * float(np.abs(_port_view(want["gr"], path)).max())
            np.testing.assert_allclose(port[r][n]["plain"][path], exp,
                                       rtol=0, atol=tol, err_msg=path)


def test_one_rank_conserves(runs):
    """With one rank the compressed mean is conservative: mean + new
    residual == g + old residual (the reference's own invariant)."""
    port, ref, *_ = runs
    rec = port[0][1]
    for path in ("a", "b", "z"):
        gr = ref[1][path]["gr"][0]
        np.testing.assert_allclose(rec["mean"][path] + rec["res"][path],
                                   gr, rtol=0, atol=1e-6)


def test_error_feedback_converges(runs):
    """40 steps of the same gradient on 4 ranks: each step's mean equals
    the reference's, and the running average closes on the plain mean as
    the reference's test asserts (last error < half the first, < 2 % of
    the gradient's largest element)."""
    port, _, traj, plain, g4 = runs
    got = port[0][4]["ef_means"]
    tol = ULPS * float(np.abs(g4).max())
    np.testing.assert_allclose(got, traj, rtol=0, atol=tol)
    for r in range(1, 4):
        np.testing.assert_array_equal(port[r][4]["ef_means"], got)
    avg = np.cumsum(got.astype(np.float64), axis=0) / np.arange(
        1, EF_STEPS + 1)[:, None, None]
    errs = np.abs(avg - plain).max(axis=(1, 2))
    assert errs[-1] < 0.5 * errs[0]
    assert errs[-1] < 0.02 * float(np.abs(g4).max())


@pytest.mark.parametrize("bucket", [1, 7, 64, 10 ** 6])
def test_buckets_cover_every_element_once(bucket):
    sizes = [5, 0, 64, 3, 200]
    buckets = col._buckets(sizes, bucket)
    seen = [(i, s, e) for b in buckets for (i, s, e) in b]
    assert all(sum(e - s for _, s, e in b) <= bucket for b in buckets)
    assert all(e > s for _, s, e in seen)
    for i, n in enumerate(sizes):
        parts = [(s, e) for j, s, e in seen if j == i]
        assert sum(e - s for s, e in parts) == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


def test_bucket_plan_counts_reference_leaves():
    tree = {"a": torch.zeros(10, 4), "layers": [{"w": torch.zeros(6)},
                                                {"w": torch.zeros(6)}]}
    plan = col.bucket_plan(tree, bucket_bytes=4 * 16)
    assert plan == {"leaves": 2, "buckets": 4, "collectives": 5,
                    "payload_bytes": 4 * 52, "scale_bytes": 8}
    res = col.zeros_residuals({"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert res["w"].dtype == torch.float32
