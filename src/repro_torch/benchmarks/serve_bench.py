"""Benchmark: the serving stack on reduced deepseek_7b (port of the
reference's ``benchmarks/serve_bench.py``).

* **TTFT**: one prefill + first sample, warm, best of a few calls.
* **Marginal decode rate**: two warm whole-generation calls at ``n_lo``
  and ``n_hi`` steps, ``B * (n_hi - n_lo) / (t_hi - t_lo)``; prefill and
  the fixed per-call costs cancel.
* **Fleet**: a heterogeneous-age ``FleetRuntime`` served by one
  :class:`~repro_torch.serve.engine.FleetServeEngine` (one lane-batched
  forward a step, the kernel route) against the same lanes served one
  after another by single-device engines.

The reference's eager-against-scanned split and its zero-retrace check
have no counterpart: the port has one per-token loop and traces nothing.
Its structural guards instead, on a card only (a CPU run says they were
not run):

* a decode step makes no host-device synchronisation (``generate`` makes
  as many at 8 tokens as at 2);
* the fleet's kernel launches a forward equal one device's (each faulted
  op one launch for all lanes).

``--quick`` is the small variant.  The record goes to ``--out`` (JSON)
when given; nothing else is written.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench
      [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import kernels
from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..data import SyntheticLM
from ..device import resolve_device
from ..launch.serve import served_params
from ..serve.engine import FleetServeEngine, ServeEngine
from .common import report, table
from .sched_bench import host_syncs

ARCH = "deepseek_7b"


def _timed(fn, reps: int) -> float:
    """Best host-clock time of ``fn()`` (a generate call, which returns
    host tokens, so the device has finished)."""
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


def bench_decode(dev, quick: bool):
    """TTFT and the marginal decode rate on the clean graph."""
    B, S = (2, 8) if quick else (4, 16)
    n_lo, n_hi = (4, 12) if quick else (8, 40)
    reps = 2 if quick else 3
    cfg, params, prompts = _setup(B, S, dev)
    eng = ServeEngine(cfg, params, max_len=S + n_hi + 1, seed=0,
                      device=dev)
    t0 = time.perf_counter()
    eng.generate(prompts, n_hi)                      # first call: warm-up
    first_s = time.perf_counter() - t0
    ttft = _timed(lambda: eng.generate(prompts, 1), reps)
    t_lo = _timed(lambda: eng.generate(prompts, n_lo), reps)
    t_hi = _timed(lambda: eng.generate(prompts, n_hi), reps)
    tok_s = B * (n_hi - n_lo) / max(t_hi - t_lo, 1e-9)
    res = {"batch": B, "prompt": S, "n_lo": n_lo, "n_hi": n_hi,
           "first_call_s": first_s, "ttft_s": ttft, "t_lo_s": t_lo,
           "t_hi_s": t_hi, "decode_tok_s": tok_s}
    txt = table(f"Serving on {dev} (clean graph, B={B}, decode "
                f"{n_lo}->{n_hi} steps)",
                ["first call", "TTFT", f"t({n_lo})", f"t({n_hi})",
                 "decode tok/s"],
                [[f"{first_s:.2f}s", f"{ttft * 1e3:.1f}ms",
                  f"{t_lo * 1e3:.0f}ms", f"{t_hi * 1e3:.0f}ms",
                  f"{tok_s:.0f}"]])
    return txt, res, (eng, prompts)


def bench_fleet(dev, quick: bool):
    """One lane-batched fleet against the lanes one by one."""
    N = 2 if quick else 4
    B, S = 2, 8
    n_steps = 3 if quick else 8
    reps = 2
    cfg, params, prompts = _setup(B, S, dev)
    max_len = S + n_steps + 1
    fleet = FleetRuntime(n_devices=N, device=dev)
    for i in range(N):
        fleet.set_age(years=9.0 * (i + 1) / N, device=i)
    lane_prompts = np.stack([prompts] * N)
    fe = FleetServeEngine(cfg, params, fleet, max_len=max_len, seed=0,
                          use_systolic_kernel=True, device=dev)
    fe.generate(lane_prompts, n_steps)                    # warm-up
    t_fleet = _timed(lambda: fe.generate(lane_prompts, n_steps), reps)
    lanes = [ServeEngine(cfg, params, runtime=fleet, runtime_device=i,
                         max_len=max_len, seed=0, use_systolic_kernel=True,
                         device=dev) for i in range(N)]

    def sequential():
        for eng in lanes:
            eng.generate(prompts, n_steps)
    sequential()                                          # warm-up
    t_seq = _timed(sequential, reps)
    total = N * B * n_steps
    launches = None
    if dev.type == "cuda":
        kernels.reset_launch_counts()
        fe.generate(lane_prompts, n_steps)
        fleet_n = sum(kernels.launch_counts().values())
        kernels.reset_launch_counts()
        lanes[0].generate(prompts, n_steps)
        launches = {"fleet": fleet_n,
                    "one_device": sum(kernels.launch_counts().values())}
    txt = table(f"Fleet serving on {dev}: {N} aged lanes x B={B} x "
                f"{n_steps} steps (kernel route)",
                ["path", "wall", "total tok/s"],
                [["lanes one by one", f"{t_seq * 1e3:.0f}ms",
                  f"{total / t_seq:.0f}"],
                 ["one fleet engine", f"{t_fleet * 1e3:.0f}ms",
                  f"{total / t_fleet:.0f}"]])
    return txt, {"n_devices": N, "fleet_tok_s": total / t_fleet,
                 "sequential_tok_s": total / t_seq,
                 "launches": launches}


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    txt1, decode, (eng, prompts) = bench_decode(dev, quick)
    txt2, fleet = bench_fleet(dev, quick)
    checks = []
    if dev.type == "cuda":
        syncs = {n: host_syncs(lambda: eng.generate(prompts, n), dev)
                 for n in (2, 8)}
        fleet["host_syncs"] = syncs
        checks.append(("no host sync in a decode step", syncs[2] == syncs[8],
                       f"syncs of generate at 2 / 8 tokens: {syncs[2]} / "
                       f"{syncs[8]}"))
        ln = fleet["launches"]
        checks.append(("the fleet launches as many kernels a forward as one "
                       "device", ln["fleet"] == ln["one_device"] > 0,
                       f"{ln['fleet']} / {ln['one_device']}"))
        guards = ""
    else:
        guards = ("\nstructural guards (decode-step host syncs, fleet "
                  "launches) not run: they need a card")
    rows = {"arch": ARCH, "mode": "quick" if quick else "full",
            "device": str(dev), "decode": decode, "fleet": fleet}
    return report("\n".join([txt1, txt2]) + guards, rows, checks)


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
