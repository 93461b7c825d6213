"""Resilience-calibration launcher: measure the zoo, fit, close the loop
(port of ``repro.launch.calibrate_resilience``).

``python -m repro_torch.launch.calibrate_resilience [--archs all|id,...]
[--quick] [--seeds N] [--train-steps N] [--use-kernel] [--fused]
[--out PATH] [--report] [--device cpu]``

For every requested config (reduced, briefly trained on the synthetic LM
task through :func:`repro_torch.train.steps.make_train_step`) this runs
the batched fault-injection sweep
(:mod:`repro_torch.calibrate.resilience_sweep`), fits the per-operator
logistic curves and merges them into the artifact at ``--out`` (default:
the port's ``core/resilience_calibrated.json``).  ``policy="measured"``
then serves from those curves.  ``--report`` re-runs the Table II policy
evaluation with each characterised model's measured curves against the
published ones.  ``--quick`` is the small variant: one config, the coarse
BER grid, one seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..calibrate.resilience_sweep import (DEFAULT_BER_GRID, QUICK_BER_GRID,
                                          empirical_resilience,
                                          write_artifact)
from ..configs import ARCH_IDS, get_config
from ..core.artifacts import load_calibration
from ..core.policy import (FaultTolerantPolicy, MeasuredResiliencePolicy,
                           evaluate_policy)
from ..core.resilience import DEFAULT_BER50, MEASURED_PATH, load_measured
from ..core.scenario import Scenario
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamWConfig
from ..train.steps import init_train_state, make_train_step


def _train_params(cfg, data, steps: int, device):
    """Briefly train the reduced config so its logits carry structure the
    injection can disrupt; ``steps=0`` keeps the random init."""
    state = init_train_state(cfg, 0, device=device)
    if steps <= 0:
        return state.params
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, total_steps=steps,
                                            warmup_steps=5))
    for i in range(steps):
        tb = data.batch_at(i)
        state, _ = step(state, {"tokens": tb.tokens, "labels": tb.labels})
    return state.params


def characterise(arch: str, *, ber_grid, n_seeds: int, train_steps: int,
                 batch: int, seq_len: int, use_kernel: bool, fused: bool,
                 device="cuda"):
    """Train, sweep and fit one config; returns ``(result, curves)``."""
    device = resolve_device(device)
    cfg = get_config(arch).reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch)
    params = _train_params(cfg, data, train_steps, device)
    tokens = data.batch_at(10_000).tokens          # held-out step
    t0 = time.time()
    curves, res = empirical_resilience(
        cfg, params, tokens, ber_grid=ber_grid, n_seeds=n_seeds,
        use_kernel=use_kernel, fused=fused, model=cfg.name, device=device)
    dt = time.time() - t0
    lanes = len(ber_grid) * len(res.operators)
    print(f"[calibrate] {arch}: {lanes} fault lanes x {n_seeds} seed(s) "
          f"in {dt:.1f}s ({lanes * n_seeds / dt:.1f} grid points/s)")
    for op in res.operators:
        d50 = DEFAULT_BER50.get(op, float("nan"))
        print(f"    {op:>6}: measured BER50 {curves[op].ber50:.2e} "
              f"(published {d50:.2e}), knee steepness "
              f"{curves[op].steepness:.1f}/decade")
    return res, curves


def report(path: str | None = None, device="cuda") -> dict:
    """Measured-against-published Table II: the policy evaluation re-run
    with each characterised model's measured curves, and the change in the
    average lifetime power saving."""
    device = resolve_device(device)
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg)
    pub = evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber),
                          cal.aging, cal.delay_poly, cal.power, scn,
                          device=device)
    print(f"[report] published curves: avg lifetime power saving "
          f"{pub['avg_power_saving_pct']:.1f}%")
    out = {"published_avg_saving_pct": pub["avg_power_saving_pct"],
           "models": {}}
    blob = load_measured(path or MEASURED_PATH)
    for arch in sorted(blob.get("models", {})):
        pol = MeasuredResiliencePolicy(ber_model=cal.ber, model=arch,
                                       artifact_path=path)
        res = evaluate_policy(pol, cal.aging, cal.delay_poly, cal.power,
                              scn, device=device)
        delta = res["avg_power_saving_pct"] - pub["avg_power_saving_pct"]
        print(f"[report] {arch:>18}: avg saving "
              f"{res['avg_power_saving_pct']:+.1f}% "
              f"(delta vs published {delta:+.1f} pts); per-op V_final: "
              + ", ".join(f"{op}={res[op]['v_final']:.2f}"
                          for op in ("q", "k", "o", "down")))
        out["models"][arch] = {
            "avg_saving_pct": res["avg_power_saving_pct"],
            "delta_vs_published_pts": delta}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch ids, or 'all' (default: all;"
                         " with --quick: llama3_8b)")
    ap.add_argument("--quick", action="store_true",
                    help="small variant: one config, coarse grid, 1 seed")
    ap.add_argument("--ber-grid", default=None,
                    help="comma-separated BERs (default: log grid)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="seed repeats averaged per grid point")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="training steps before measuring (0: random init)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--use-kernel", action="store_true",
                    help="weight matmuls on the kernels (with --fused: the "
                         "fused GEMM of the serving path)")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--out", default=MEASURED_PATH,
                    help="artifact to merge into (default: the port's "
                         "core/resilience_calibrated.json)")
    ap.add_argument("--report", action="store_true",
                    help="measure nothing; the measured-vs-published "
                         "Table II from the artifact")
    ap.add_argument("--device", default="cuda",
                    help="where the models train and the sweep runs")
    args = ap.parse_args(argv)

    if args.report:
        return report(args.out if args.out != MEASURED_PATH else None,
                      device=args.device)

    if args.archs:
        archs = list(ARCH_IDS) if args.archs == "all" \
            else [a.strip().replace("-", "_")
                  for a in args.archs.split(",") if a.strip()]
    else:
        archs = ["llama3_8b"] if args.quick else list(ARCH_IDS)
    if args.ber_grid:
        grid = tuple(float(b) for b in args.ber_grid.split(","))
    else:
        grid = QUICK_BER_GRID if args.quick else DEFAULT_BER_GRID
    n_seeds = args.seeds if args.seeds is not None else (1 if args.quick
                                                        else 2)
    train_steps = args.train_steps if args.train_steps is not None \
        else (8 if args.quick else 40)
    batch = args.batch or (4 if args.quick else 8)
    seq_len = args.seq_len or (32 if args.quick else 64)

    entries = {}
    for arch in archs:
        entries[arch] = characterise(
            arch, ber_grid=grid, n_seeds=n_seeds, train_steps=train_steps,
            batch=batch, seq_len=seq_len, use_kernel=args.use_kernel,
            fused=args.fused, device=args.device)
    meta = {"mode": "quick" if args.quick else "full",
            "ber_grid": [float(b) for b in np.asarray(grid, np.float64)],
            "n_seeds": n_seeds, "train_steps": train_steps,
            "batch": [batch, seq_len],
            "backend": resolve_device(args.device).type,
            "kernel": "fused" if (args.use_kernel and args.fused)
            else ("systolic" if args.use_kernel else "plain")}
    write_artifact(entries, meta, path=args.out)
    print(f"[calibrate] wrote {args.out} ({len(entries)} model(s))")
    return entries


if __name__ == "__main__":
    main()
