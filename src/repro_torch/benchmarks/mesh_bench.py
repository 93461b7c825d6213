"""Benchmark: mesh serving — one model over ``tp`` shards, each aged on
its own (port of the reference's ``benchmarks/mesh_bench.py``).

On reduced deepseek_7b with ``tp = 8`` shards (the reference's eight
faked host devices; here every shard runs on the one torch device):

* **sharded against single-device generation** on the same cast params:
  the first call, the warm whole-call wall and tokens/s of each, and
  whether the tokens are equal (the serve layout's contract, on the clean
  graph);
* **per-shard aging in one dispatch**: a shard-granular
  :class:`~repro_torch.core.fleet.FleetRuntime` (``n_shards = 8``) with
  staggered shard ages served by
  :class:`~repro_torch.serve.sharded.MeshServeEngine` on the fused route
  (the shard-mode GEMM and the counter-upset kernel) and the plain route:
  both give the same tokens before and after one shard ages a year, the
  served per-shard BERs differ, and the served BER table follows the age
  change.  The reference's zero-retrace guard has no counterpart (the port
  traces nothing); on a card, one faulted forward's launches are checked
  instead: one shard-mode launch a faulted weight matmul and one
  counter-upset launch a qkt/sv injection.
* the analytic HBM bytes a decode token of the two vector-BER routes, as
  the reference reckons them (its fused route returns the int32
  accumulator for an outside dequant; the port's shard mode dequantises in
  the kernel, so its fused route moves fewer bytes than this).

The record goes to ``--out`` (default ``build/bench_torch/mesh.json``,
git-ignored).

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.mesh_bench
      [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .. import kernels
from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..data import SyntheticLM
from ..device import resolve_device
from ..kernels.ops import _ceil_mult
from ..launch.serve import served_params
from ..serve.engine import ServeEngine
from ..serve.sharded import MeshServeEngine
from .common import report, table

ARCH = "deepseek_7b"
TP = 8
OUT = Path(__file__).resolve().parents[3] / "build" / "bench_torch" / \
    "mesh.json"


def _timed(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _setup(batch: int, prompt_len: int, dev):
    cfg = get_config(ARCH).reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=prompt_len,
                       global_batch=batch)
    return cfg, served_params(cfg, dev), data.batch_at(0).tokens


def bench_sharded_dispatch(dev, quick: bool):
    B, S = 2, 8
    n_steps = 4 if quick else 12
    reps = 2
    cfg, params, prompts = _setup(B, S, dev)
    max_len = S + n_steps + 1
    eng = MeshServeEngine(cfg, params, tp=TP, max_len=max_len, seed=0,
                          device=dev)
    t0 = time.perf_counter()
    a = eng.generate(prompts, n_steps)
    first_sharded = time.perf_counter() - t0
    t_sharded = _timed(lambda: eng.generate(prompts, n_steps), reps)
    single = ServeEngine(cfg, eng.params, max_len=max_len, seed=0,
                         device=dev)
    t0 = time.perf_counter()
    b = single.generate(prompts, n_steps)
    first_single = time.perf_counter() - t0
    t_single = _timed(lambda: single.generate(prompts, n_steps), reps)
    exact = bool(np.array_equal(a.tokens, b.tokens))
    total = B * n_steps
    txt = table(f"Mesh serving on {dev} (clean graph, B={B}, {n_steps} "
                f"steps, tp={TP} on one device)",
                ["path", "first call", "wall", "tok/s"],
                [["single device", f"{first_single:.2f}s",
                  f"{t_single * 1e3:.0f}ms", f"{total / t_single:.0f}"],
                 [f"mesh tp={TP}", f"{first_sharded:.2f}s",
                  f"{t_sharded * 1e3:.0f}ms", f"{total / t_sharded:.0f}"]])
    return txt, {"tp": TP, "first_call_sharded_s": first_sharded,
                 "first_call_single_s": first_single,
                 "sharded_tok_s": total / t_sharded,
                 "single_tok_s": total / t_single, "bit_exact": exact}


def _decode_weight_matmul_shapes(cfg, B: int) -> list:
    """(M, K, N) of every weight matmul a faulted decode token runs (the
    ``op_linear`` domains and the unembed)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = [(B, d, cfg.n_heads * hd), (B, d, cfg.n_kv_heads * hd),
                 (B, d, cfg.n_kv_heads * hd), (B, cfg.n_heads * hd, d),
                 (B, d, cfg.d_ff), (B, d, cfg.d_ff), (B, cfg.d_ff, d)]
    return per_layer * cfg.n_layers + [(B, d, cfg.vocab)]


def _hbm_bytes(M, K, N, bm, bn, *, fused: bool):
    """The reference's analytic HBM bytes of one faulted, dequantised
    matmul: block revisits (``a`` once per N tile, ``b`` once per M tile)
    and what follows the flush — the float output alone when fused; the
    int32 round trip, the padded ``(rows, 128)`` randoms and the flip pass
    otherwise."""
    gm, gn = M // bm, N // bn
    matmul_reads = M * K * gn + K * N * gm
    scales = 4 * (M + N)
    out_f32 = 4 * M * N
    if fused:
        return matmul_reads + scales + out_f32
    words = M * N
    rows = -(-words // 128)
    wpad = -(-rows // 256) * 256 * 128
    return (matmul_reads + 4 * words + 8 * wpad + (4 + 8) * wpad + 4 * wpad
            + 4 * words + scales + out_f32)


def _route_bytes_per_token(cfg, B: int, tp: int) -> dict:
    """Analytic HBM bytes a decode token of the two vector-BER routes, as
    the reference reckons them: its fused route runs the kernel on each
    shard's ``(M, N / tp)`` block and returns the int32 accumulator for the
    shared dequant (one more int32 round trip a word); an output dimension
    ``tp`` does not divide stays three-pass in both columns.  Shapes are
    padded to their resolved blocks."""
    def one(M, K, N, fused):
        bm, bn, bk = (_ceil_mult(M, 256), _ceil_mult(N, 256),
                      _ceil_mult(K, 256))
        Mp, Np = -(-M // bm) * bm, -(-N // bn) * bn
        b = _hbm_bytes(Mp, -(-K // bk) * bk, Np, bm, bn, fused=fused)
        return b + 8 * Mp * Np if fused else b

    three_pass = fused = 0
    for M, K, N in _decode_weight_matmul_shapes(cfg, B):
        three_pass += one(M, K, N, False)
        fused += tp * one(M, K, N // tp, True) if N % tp == 0 \
            else one(M, K, N, False)
    return {"bytes_per_token_three_pass": three_pass,
            "bytes_per_token_fused": fused,
            "bytes_saved_ratio": three_pass / max(fused, 1)}


def bench_per_shard_aging(dev, quick: bool):
    B, S = 2, 8
    n_steps = 3 if quick else 8
    cfg, params, prompts = _setup(B, S, dev)
    max_len = S + n_steps + 1
    fleet = FleetRuntime(n_devices=1, n_shards=TP, device=dev)
    for s in range(TP):
        fleet.set_age(years=9.0 * (s + 1) / TP, shard=s)
    engines = {route: MeshServeEngine(cfg, params, fleet=fleet, tp=TP,
                                      max_len=max_len, seed=0,
                                      use_fused_kernel=(route == "fused"),
                                      device=dev)
               for route in ("fused", "kernel_free")}
    res, r1, r2, rows = {}, {}, {}, []
    for route, eng in engines.items():
        t0 = time.perf_counter()
        r1[route] = eng.generate(prompts, n_steps)
        first_s = time.perf_counter() - t0
        fleet.advance(3.15e7, shard=1)           # one shard ages a year
        r2[route] = eng.generate(prompts, n_steps)
        fleet.advance(-3.15e7, shard=1)          # rewind: same ages for both
        t_warm = _timed(lambda: eng.generate(prompts, n_steps), 2)
        res[route] = {"first_call_s": first_s,
                      "warm_tok_s": B * n_steps / t_warm,
                      "ber_table_followed": bool(
                          r2[route].bers[1, 0] != r1[route].bers[1, 0])}
        rows.append([f"{route} tp={TP}", f"{first_s:.2f}s",
                     f"{t_warm * 1e3:.0f}ms", f"{B * n_steps / t_warm:.0f}"])
    parity = bool(np.array_equal(r1["fused"].tokens,
                                 r1["kernel_free"].tokens)
                  and np.array_equal(r2["fused"].tokens,
                                     r2["kernel_free"].tokens))
    bq = r1["fused"].bers[:, 0]
    differ = bool(len(np.unique(bq)) > 1)
    followed = all(r["ber_table_followed"] for r in res.values())
    launches = None
    if dev.type == "cuda":
        kernels.reset_launch_counts()
        engines["fused"].generate(prompts, 1)
        c = kernels.launch_counts()
        launches = {"shard_gemm": c["fused_aged_matmul_shards"],
                    "counter_upset": c["counter_upset_shards"],
                    "want_shard_gemm": 7 * cfg.n_layers,
                    "want_counter_upset": 2 * cfg.n_layers,
                    "other": sum(v for k, v in c.items() if k not in (
                        "fused_aged_matmul_shards", "counter_upset_shards"))}
    bytes_ = _route_bytes_per_token(cfg, B, TP)
    txt = table(f"Per-shard aging in one dispatch on {dev} (fused shard "
                "kernels against the plain route)",
                ["route", "first call", "wall", "tok/s"], rows)
    checks = [
        ("fused and plain routes give the same tokens (before and after "
         "aging)", parity, ""),
        ("served per-shard BERs differ across the shards", differ,
         f"BER(q) {bq.min():.1e} -> {bq.max():.1e}"),
        ("an age change reaches the served BER table (both routes)",
         followed, ""),
        ("the fused route saves analytic HBM bytes a decode token",
         bytes_["bytes_saved_ratio"] > 1.0,
         f"{bytes_['bytes_per_token_three_pass'] / 2**20:.2f} MiB -> "
         f"{bytes_['bytes_per_token_fused'] / 2**20:.2f} MiB "
         f"({bytes_['bytes_saved_ratio']:.2f}x)")]
    if launches is not None:
        checks.append((
            "one shard-mode launch a faulted weight matmul and one "
            "counter-upset launch a qkt/sv injection",
            launches["shard_gemm"] == launches["want_shard_gemm"]
            and launches["counter_upset"] == launches["want_counter_upset"]
            and launches["other"] == 0, json.dumps(launches)))
    return txt, checks, {
        "first_call_s": res["fused"]["first_call_s"],
        "warm_tok_s": res["fused"]["warm_tok_s"],
        "kernel_free_first_call_s": res["kernel_free"]["first_call_s"],
        "kernel_free_warm_tok_s": res["kernel_free"]["warm_tok_s"],
        "routes_bit_exact": parity, **bytes_,
        "shard_bers_differ": differ, "ber_table_followed": followed,
        "ber_q_per_shard": bq.tolist(), "launches": launches,
        "tokens_changed_after_aging": bool(not np.array_equal(
            r1["fused"].tokens, r2["fused"].tokens))}


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    txt1, disp = bench_sharded_dispatch(dev, quick)
    txt2, checks, aging = bench_per_shard_aging(dev, quick)
    checks = [("sharded generation equals the single device (clean)",
               disp["bit_exact"], "")] + checks
    rows = {"arch": ARCH, "mode": "quick" if quick else "full",
            "device": str(dev), "tp": TP, "dispatch": disp,
            "per_shard_aging": aging}
    return report("\n".join([txt1, txt2]), rows, checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (default cuda)")
    ap.add_argument("--quick", action="store_true", help="the small variant")
    ap.add_argument("--out", default=str(OUT),
                    help="write the record here as JSON (default "
                         "build/bench_torch/mesh.json)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = evaluate(device=args.device, quick=args.quick)
    print(res["text"])
    print(f"({time.perf_counter() - t0:.2f} s on {args.device})")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"rows": res["rows"], "checks": res["checks"]},
                              indent=1) + "\n")
    print(f"[recorded] {out}")
    return 0 if all(c["ok"] for c in res["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
