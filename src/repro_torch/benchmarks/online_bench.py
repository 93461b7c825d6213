"""Benchmark: continuous-batching online serving under live traffic (port of
the reference's ``benchmarks/online_bench.py``), on reduced deepseek_7b.

* **Workload sweep** — tok/s, p50/p99 request latency (decode-step clock)
  and admission-drop rate under ``poisson``, ``diurnal`` and flash-crowd
  (``bursty``) arrival traces, served on fixed slots with bounded-queue
  admission control.
* **Fleet + aging replay** — the router-dispatched
  :class:`~repro_torch.serve.online.OnlineFleetEngine` serves a diurnal
  trace across aged lanes, then the *measured* per-lane occupancy is
  replayed into :meth:`repro_torch.core.fleet.FleetRuntime.apply_load`.
* **Structural guards** — the chunked online path gives the tokens of
  ``ServeEngine.generate`` when no mid-decode arrivals occur.  The
  reference's "re-traces nothing" guard has no counterpart (the port
  traces nothing); in its place, a second serve with another request
  schedule adds no served-shape key (the ``online_*`` counters), and, on a
  card, every forward of a faulted serve on the kernel route makes the
  same kernel launches whatever the refill pattern: 7 fused-GEMM and 2
  draw-bitflip launches a layer for each refill and each decode step.

``--quick`` is the small variant.  The record goes to ``--out`` (JSON)
when given (``benchmarks.run`` writes it under ``build/bench_torch/``);
nothing else is written.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.online_bench
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
from ..device import resolve_device
from ..launch.serve import served_params
from ..sched.workload import get_workload
from ..serve import online
from ..serve.engine import ServeEngine
from ..serve.online import (OnlineFleetEngine, OnlineServeEngine, Request,
                            requests_from_workload)
from .common import report, table

ARCH = "deepseek_7b"
YEAR_S = 365.25 * 24 * 3600.0


def _setup(dev):
    cfg = get_config(ARCH).reduced()
    return cfg, served_params(cfg, dev)


def _sizes(quick: bool):
    if quick:
        return dict(n_slots=2, chunk_steps=4, prompt_len=8, max_new=8,
                    n_epochs=4, steps_per_epoch=24, max_queue=8)
    return dict(n_slots=4, chunk_steps=8, prompt_len=16, max_new=16,
                n_epochs=10, steps_per_epoch=64, max_queue=16)


def _workload(name: str, n_devices: int, sz: dict):
    kw = {"n_devices": n_devices, "n_epochs": sz["n_epochs"],
          "utilization": 0.6}
    if name == "bursty":        # flash crowds the admission bound feels
        kw.update(burst_prob=0.3, burst_gain=4.0)
    return get_workload(name, **kw)


def bench_workloads(cfg, params, dev, quick: bool):
    """tok/s + latency percentiles + drop rate per arrival shape."""
    sz = _sizes(quick)
    max_len = sz["prompt_len"] + sz["max_new"] + 1
    horizon = sz["n_epochs"] * sz["steps_per_epoch"]
    rows, res = [], {}
    for name in ("poisson", "diurnal", "bursty"):
        reqs = requests_from_workload(
            _workload(name, 1, sz), n_slots=sz["n_slots"],
            steps_per_epoch=sz["steps_per_epoch"], max_new=sz["max_new"],
            prompt_len=sz["prompt_len"], vocab=cfg.vocab, seed=3)
        eng = OnlineServeEngine(
            cfg, params, n_slots=sz["n_slots"], max_len=max_len,
            max_new_cap=sz["max_new"], chunk_steps=sz["chunk_steps"],
            max_queue=sz["max_queue"], seed=0, device=dev)
        r = eng.serve(reqs, greedy=False, temperature=0.8,
                      max_steps=4 * horizon)
        s = r.summary()
        res[name] = s
        rows.append([name, r.n_arrived, r.n_completed,
                     f"{r.drop_rate:.3f}", f"{r.tok_per_s:.1f}",
                     f"{r.p50:.0f}", f"{r.p99:.0f}",
                     f"{s['mean_occupancy']:.2f}"])
    txt = table(
        f"Online serving on {dev} (slots={sz['n_slots']}, chunk="
        f"{sz['chunk_steps']}, queue<={sz['max_queue']}, "
        f"{sz['n_epochs']}x{sz['steps_per_epoch']}-step epochs)",
        ["workload", "arrived", "done", "drop", "tok/s", "p50", "p99",
         "occ"], rows)
    drained = all(res[n]["n_completed"] + res[n]["n_dropped"]
                  == res[n]["n_arrived"] for n in res)
    return txt, res, drained


def bench_fleet_replay(cfg, params, dev, quick: bool):
    """Fleet lanes + measured occupancy replayed into the aging co-sim."""
    sz = _sizes(quick)
    N = 2 if quick else 4
    max_len = sz["prompt_len"] + sz["max_new"] + 1
    horizon = sz["n_epochs"] * sz["steps_per_epoch"]
    fleet = FleetRuntime(n_devices=N, device=dev)
    for i in range(N):
        fleet.set_age(years=6.0 * (i + 1) / N, device=i)
    reqs = requests_from_workload(
        _workload("diurnal", N, sz), n_slots=sz["n_slots"],
        steps_per_epoch=sz["steps_per_epoch"], max_new=sz["max_new"],
        prompt_len=sz["prompt_len"], vocab=cfg.vocab, n_devices=N, seed=3)
    eng = OnlineFleetEngine(
        cfg, params, fleet, n_slots=sz["n_slots"], max_len=max_len,
        max_new_cap=sz["max_new"], chunk_steps=sz["chunk_steps"],
        max_queue=4 * sz["max_queue"], router="wear_level", seed=0,
        device=dev)
    r = eng.serve(reqs, greedy=False, temperature=0.8,
                  max_steps=4 * horizon)
    s = r.summary()
    util = r.lane_utilization(max(sz["n_epochs"], 2))      # (E, N) measured
    cos = fleet.apply_load(util_trace=util, horizon_s=YEAR_S)
    wear = cos.device_wear()[-1]
    s.update(n_devices=N, mean_util=float(util.mean()),
             replay_max_dvp_mv=float(wear.max()),
             replay_spread_mv=float(wear.max() - wear.min()))
    rows = [[f"fleet x{N} (wear_level)", r.n_arrived, r.n_completed,
             f"{r.drop_rate:.3f}", f"{r.tok_per_s:.1f}",
             f"{r.p50:.0f}", f"{r.p99:.0f}", f"{util.mean():.2f}"]]
    txt = table("Fleet online serving (diurnal) + occupancy -> aging "
                "replay", ["mode", "arrived", "done", "drop", "tok/s",
                           "p50", "p99", "duty"], rows)
    ok = bool(np.isfinite(wear).all() and wear.max() > 0.0)
    detail = (f"1y at duty {util.mean():.2f} -> max ΔVth "
              f"{wear.max():.1f} mV")
    return txt, s, (ok, detail)


def _served_keys() -> int:
    return sum(c.stats()["currsize"] for c in (
        online.ONLINE_PREFILL, online.ONLINE_CHUNK,
        online.ONLINE_FLEET_PREFILL, online.ONLINE_FLEET_CHUNK))


def _launches_a_forward(eng, reqs, n_layers: int) -> dict:
    """A faulted serve's kernel launches against one device's forwards
    (every refill and every decode step is one forward of 7 fused-GEMM
    and 2 draw-bitflip launches a layer)."""
    kernels.reset_launch_counts()
    r = eng.serve(reqs, greedy=True)
    counts = kernels.launch_counts()
    forwards = r.timings["n_refills"] + r.timings["n_chunks"] \
        * eng.chunk_steps
    return {"forwards": forwards, "fused": counts["fused_aged_matmul"],
            "draw": counts["bitflip_draw"],
            "ok": counts["fused_aged_matmul"] == 7 * n_layers * forwards
            and counts["bitflip_draw"] == 2 * n_layers * forwards}


def structural_checks(cfg, params, dev, quick: bool):
    sz = _sizes(quick)
    max_len = sz["prompt_len"] + sz["max_new"] + 1
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (3, sz["prompt_len"])).astype(np.int32)

    # chunked online vs one-shot generate: bit-exact with no arrivals
    n_steps = sz["max_new"] // 2 + 1
    ref = ServeEngine(cfg, params, max_len=max_len, seed=11,
                      device=dev).generate(prompts, n_steps,
                                           temperature=0.7).tokens
    eng = OnlineServeEngine(cfg, params, n_slots=3, max_len=max_len,
                            max_new_cap=sz["max_new"],
                            chunk_steps=sz["chunk_steps"], seed=11,
                            device=dev)
    r = eng.serve([Request(id=i, prompt=prompts[i], max_new=n_steps)
                   for i in range(3)],
                  greedy=False, temperature=0.7, eos_id=-1)
    got = np.stack([q.tokens for q in
                    sorted(r.completed, key=lambda q: q.id)])
    bit_exact = bool(np.array_equal(ref, got))

    # another request schedule adds no served-shape key
    sched_a = [Request(id=i, prompt=prompts[i % 3], max_new=4,
                       arrival=2 * i) for i in range(5)]
    sched_b = [Request(id=i, prompt=prompts[(i + 1) % 3], max_new=3,
                       arrival=3 * i) for i in range(6)]
    eng.serve(sched_a, greedy=True)
    before = _served_keys()
    eng.serve(sched_b, greedy=True)
    no_new_keys = _served_keys() == before
    out = {"no_arrival_bit_exact": bit_exact,
           "no_new_served_shapes": no_new_keys}
    checks = [("chunked online decode bit-exact with one-shot generate "
               "(no mid-decode arrivals)", bit_exact, ""),
              ("a different request schedule adds no served-shape key (the "
               "reference: re-traces nothing)", no_new_keys, "")]
    if dev.type == "cuda":
        rt = FleetRuntime(n_devices=1, device=dev)
        rt.set_age(years=9.0)
        faulted = OnlineServeEngine(
            cfg, params, runtime=rt, n_slots=3, max_len=max_len,
            max_new_cap=sz["max_new"], chunk_steps=sz["chunk_steps"],
            seed=11, use_systolic_kernel=True, device=dev)
        la = _launches_a_forward(faulted, sched_a, cfg.n_layers)
        lb = _launches_a_forward(faulted, sched_b, cfg.n_layers)
        out["launches"] = {"schedule_a": la, "schedule_b": lb}
        checks.append(("7 fused-GEMM + 2 draw launches a layer and forward "
                       "whatever the refill pattern", la["ok"] and lb["ok"],
                       f"{la['fused']}/{la['draw']} over {la['forwards']} "
                       f"forwards, {lb['fused']}/{lb['draw']} over "
                       f"{lb['forwards']}"))
    return out, checks


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    cfg, params = _setup(dev)
    txt1, workloads, drained = bench_workloads(cfg, params, dev, quick)
    txt2, fleet, (replay_ok, replay_detail) = bench_fleet_replay(
        cfg, params, dev, quick)
    struct, checks = structural_checks(cfg, params, dev, quick)
    checks = [("every workload drains within the step budget", drained,
               ""),
              ("measured occupancy replays into the aging recursion "
               "(finite, loaded-lane wear)", replay_ok, replay_detail)] \
        + checks
    text = "\n".join([txt1, txt2])
    if dev.type != "cuda":
        text += ("\nlaunch-count guard (kernel launches a forward whatever "
                 "the refill pattern) not run: it needs a card")
    rows = {"arch": ARCH, "mode": "quick" if quick else "full",
            "device": str(dev), "workloads": workloads,
            "fleet_replay": fleet, "structural": struct}
    return report(text, rows, checks)


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
                      indent=1, default=str)
    return 0 if all(c["ok"] for c in res["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
