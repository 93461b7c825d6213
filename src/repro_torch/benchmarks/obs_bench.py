"""Benchmark: what the telemetry taps cost and what they promise (port of
the reference's ``benchmarks/obs_bench.py``), on reduced deepseek_7b.

* **Taps overhead** — the host-clock time of ``ServeEngine.generate`` and
  of an online serve with the taps enabled against disabled.  The forward
  computes the taps either way (the toggle decides only the host copy and
  the registry recording), so the ratio is the host cost of reading them;
  it must stay at most 1.10x.  The host clock spreads, so on and off run
  interleaved (off, on, on, off, ...) and each side is the median of its
  repeats (at least 5).
* **Structural** — tokens bit-exact with taps on and off; toggling the
  taps adds no served-shape key (the reference: re-traces nothing); the
  Prometheus export round-trips the samples this run produced
  (:mod:`repro_torch.obs.export`).

``--quick`` is the small variant.  The record goes to ``--out`` (JSON)
when given (``benchmarks.run`` writes it under ``build/bench_torch/``).

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.obs_bench
      [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..launch.serve import served_params
from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs.taps import enable_taps
from ..serve.engine import ServeEngine
from ..serve.online import OnlineServeEngine, Request
from .common import report, table

ARCH = "deepseek_7b"
OVERHEAD_LIMIT = 1.10


def _sizes(quick: bool):
    if quick:
        return {"batch": 2, "prompt_len": 8, "gen_len": 8, "reps": 5,
                "n_slots": 2, "chunk_steps": 4, "max_new": 6, "n_reqs": 4}
    return {"batch": 4, "prompt_len": 16, "gen_len": 24, "reps": 15,
            "n_slots": 3, "chunk_steps": 8, "max_new": 12, "n_reqs": 8}


def _interleaved_medians(fn, reps: int, dev):
    """Median seconds of ``fn()`` with taps off and on, the repeats in turns
    (off, on, on, off, ...) after one warm call of each."""
    def once(on: bool) -> float:
        with enable_taps(on):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0
    once(False)
    once(True)
    off, on = [], []
    for i in range(reps):
        order = (False, True) if i % 2 == 0 else (True, False)
        for flag in order:
            (on if flag else off).append(once(flag))
    return float(np.median(off)), float(np.median(on))


def bench_overhead(cfg, params, dev, quick: bool):
    """Host time, taps off vs on: the generate call and the online loop."""
    sz = _sizes(quick)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (sz["batch"], sz["prompt_len"])).astype(np.int32)
    max_len = sz["prompt_len"] + sz["gen_len"] + 1
    eng = ServeEngine(cfg, params, max_len=max_len, seed=7, device=dev)
    t_off, t_on = _interleaved_medians(
        lambda: eng.generate(prompts, sz["gen_len"], temperature=0.7),
        sz["reps"], dev)
    serve_ratio = t_on / t_off

    def online():
        e = OnlineServeEngine(cfg, params, n_slots=sz["n_slots"],
                              max_len=max_len, max_new_cap=sz["max_new"],
                              chunk_steps=sz["chunk_steps"], seed=7,
                              device=dev)
        e.serve([Request(id=i, prompt=prompts[i % sz["batch"]],
                         max_new=sz["max_new"], arrival=i)
                 for i in range(sz["n_reqs"])], greedy=True)
    o_off, o_on = _interleaved_medians(online, max(sz["reps"] // 3, 5),
                                       dev)
    online_ratio = o_on / o_off
    rows = [["serve generate", f"{t_off * 1e3:.1f}", f"{t_on * 1e3:.1f}",
             f"{serve_ratio:.3f}"],
            ["online chunk loop", f"{o_off * 1e3:.1f}",
             f"{o_on * 1e3:.1f}", f"{online_ratio:.3f}"]]
    txt = table(f"Telemetry taps overhead on {dev} (median of interleaved "
                f"repeats)", ["path", "off [ms]", "on [ms]", "ratio"], rows)
    check = (f"taps overhead <= {OVERHEAD_LIMIT:.2f}x on both paths",
             serve_ratio <= OVERHEAD_LIMIT and online_ratio <= OVERHEAD_LIMIT,
             f"serve {serve_ratio:.3f}x, online {online_ratio:.3f}x")
    return txt, {"serve_off_s": t_off, "serve_on_s": t_on,
                 "serve_ratio": serve_ratio, "online_off_s": o_off,
                 "online_on_s": o_on, "online_ratio": online_ratio,
                 "limit": OVERHEAD_LIMIT}, check


def _served_keys() -> dict:
    return {n: s["currsize"] for n, s in obs_metrics.cache_stats().items()}


def structural_checks(cfg, params, dev, quick: bool):
    sz = _sizes(quick)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab,
                           (sz["batch"], sz["prompt_len"])).astype(np.int32)
    max_len = sz["prompt_len"] + sz["gen_len"] + 1
    mk = lambda: ServeEngine(cfg, params, max_len=max_len, seed=5,
                             device=dev)

    # bit-exact: same engine seed, taps off vs on
    off = mk().generate(prompts, sz["gen_len"], temperature=0.7)
    with enable_taps():
        on = mk().generate(prompts, sz["gen_len"], temperature=0.7)
    bit_exact = bool(np.array_equal(off.tokens, on.tokens))
    has_taps = on.telemetry is not None and off.telemetry is None

    # toggling the taps adds no served-shape key
    eng = mk()
    eng.generate(prompts, sz["gen_len"])
    before = _served_keys()
    with enable_taps():
        eng.generate(prompts, sz["gen_len"])
    eng.generate(prompts, sz["gen_len"])
    no_new_keys = _served_keys() == before

    # export round-trip on the samples this very run produced
    samples = obs_metrics.REGISTRY.collect()
    back = obs_export.parse_prometheus(obs_export.prometheus_text(samples))
    round_trip = [(s.name, tuple(sorted(s.labels)), s.value)
                  for s in samples] \
        == [(s.name, s.labels, s.value) for s in back]
    checks = [("tokens bit-exact with taps enabled (the same forward)",
               bit_exact and has_taps, ""),
              ("toggling taps adds no served-shape key (the reference: "
               "re-traces nothing)", no_new_keys, ""),
              (f"Prometheus export round-trips {len(samples)} live samples",
               round_trip and len(samples) > 0, "")]
    return {"bit_exact": bit_exact, "no_new_served_shapes": no_new_keys,
            "export_round_trip": round_trip,
            "n_samples": len(samples)}, checks


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    cfg = get_config(ARCH).reduced()
    params = served_params(cfg, dev)
    txt, overhead, check = bench_overhead(cfg, params, dev, quick)
    struct, checks = structural_checks(cfg, params, dev, quick)
    rows = {"arch": ARCH, "mode": "quick" if quick else "full",
            "device": str(dev), "overhead": overhead, "structural": struct}
    return report(txt, rows, [check] + checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (default cuda)")
    ap.add_argument("--quick", action="store_true", help="the small variant")
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
