"""Benchmark: the resilience sweep's grid, batched against lane by lane
(port of the reference's ``benchmarks/resilience_bench.py``).

The sweep (:mod:`repro_torch.calibrate.resilience_sweep`) folds a chunk of
fault lanes into the batch of one forward.  This bench times that grid
against the same lanes run one forward each, on reduced llama3_8b (random
init from seed 0) on the fused-kernel route, and checks:

* the batched and the looped grids give equal losses;
* on the card, the batched grid makes ``ceil(chunk / 32)`` launches of the
  lane GEMM per faulted weight GEMM and forward (and as many of the lane
  draw per qkt/sv), not one per lane.

The reference's tracing guards have no counterpart: the port traces
nothing.  The record goes to ``--out`` (JSON) when given.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.resilience_bench
      [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from .. import kernels
from .. import random as prandom
from ..calibrate import resilience_sweep as rs
from ..configs import get_config
from ..core.resilience import operators_for
from ..data import SyntheticLM
from ..device import resolve_device
from ..models.transformer import init_params
from .common import report, table

ARCH = "llama3_8b"


def _timed(fn, reps: int, dev) -> float:
    best = math.inf
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    B, S = (2, 16) if quick else (4, 32)
    n_bers = 3 if quick else 5
    reps = 2 if quick else 3
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    tokens = torch.as_tensor(SyntheticLM(vocab=cfg.vocab, seq_len=S,
                                         global_batch=B).batch_at(0).tokens,
                             dtype=torch.int64, device=dev)
    ber_grid = tuple(float(b) for b in np.logspace(-6, -2, n_bers))
    ops = operators_for(cfg.family)
    lanes = n_bers * len(ops)
    route = dict(use_kernel=True, fused=True)
    key = prandom.PRNGKey(0)
    ref_pred = rs.predict(params, cfg, tokens, rs._reference_fault_config(
        ops, key, **route)).cpu().numpy()
    fi = rs.grid_fault_config(ops, ber_grid, key, **route)
    chunk = rs.default_chunk(cfg, tokens.numel(), lanes, dev)

    batched = lambda: rs.grid_losses(params, cfg, tokens, ref_pred, fi, chunk)
    looped = lambda: rs.grid_losses(params, cfg, tokens, ref_pred, fi, 1)
    kernels.reset_launch_counts()
    loss_batched = batched()
    counts = kernels.launch_counts()
    loss_looped = looped()
    t_batched = _timed(batched, reps, dev)
    t_looped = _timed(looped, reps, dev)

    speedup = t_looped / t_batched
    rows = {"arch": ARCH, "device": str(dev), "quick": quick, "lanes": lanes,
            "chunk": chunk, "batch": [B, S], "batched_s": t_batched,
            "looped_s": t_looped,
            "batched_points_per_s": lanes / t_batched,
            "looped_points_per_s": lanes / t_looped,
            "batched_vs_looped_speedup": speedup,
            "launches_batched_grid": counts,
            "loss_pct": loss_batched.tolist()}
    txt = table(f"Resilience sweep on {dev}: {lanes} fault lanes ({n_bers} "
                f"BERs x {len(ops)} operators, B={B}, S={S}, fused route, "
                f"{chunk} lanes a forward)",
                ["path", "wall", "grid points/s"],
                [[f"looped ({lanes} forwards)", f"{t_looped * 1e3:.0f} ms",
                  f"{lanes / t_looped:.1f}"],
                 [f"batched ({-(-lanes // chunk)} forwards)",
                  f"{t_batched * 1e3:.0f} ms", f"{lanes / t_batched:.1f}"]])
    txt += f"\nbatched / looped: {speedup:.2f}x faster"
    checks = [("batched and looped grids give equal losses",
               bool(np.array_equal(loss_batched, loss_looped)), "")]
    if dev.type == "cuda":
        per = [-(-min(chunk, lanes - l0) // 32)
               for l0 in range(0, lanes, chunk)]
        want_gemm, want_draw = (7 * cfg.n_layers * sum(per),
                                2 * cfg.n_layers * sum(per))
        checks.append((
            "the batched grid makes ceil(chunk/32) lane launches per faulted "
            "op and forward", counts["fused_aged_matmul_lanes"] == want_gemm
            and counts["bitflip_draw_lanes"] == want_draw
            and counts["fused_aged_matmul"] == 0,
            f"{counts['fused_aged_matmul_lanes']} GEMM / "
            f"{counts['bitflip_draw_lanes']} draw launches, want "
            f"{want_gemm} / {want_draw}"))
    return report(txt, rows, checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the sweep runs (default cuda)")
    ap.add_argument("--quick", action="store_true", help="a smaller grid")
    ap.add_argument("--out", default=None,
                    help="write the record here as JSON")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = evaluate(device=args.device, quick=args.quick)
    print(res["text"])
    print(f"({time.perf_counter() - t0:.2f} s on {args.device})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": res["rows"], "checks": res["checks"]}, f,
                      indent=1)
    return 0 if all(c["ok"] for c in res["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
