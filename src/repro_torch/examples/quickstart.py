"""Quickstart: the paper's pipeline on the port (port of the reference's
``examples/quickstart.py``).

1. Load the calibrated aging framework (BTI/HCI compact models, fitted
   delay polynomial, BER curve, power model).
2. Simulate a 10-year AVS lifetime for the classical policy and for the
   paper's fault-tolerant policy.
3. Serve a (reduced) LLaMA-class model on a simulated 9-year-old device:
   every matmul runs at the BER its voltage domain admits.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu]      (the card by default)
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..core.artifacts import load_calibration
from ..core.fleet import FleetRuntime
from ..core.policy import FaultTolerantPolicy, evaluate_policy
from ..data import SyntheticLM
from ..device import resolve_device
from ..launch.serve import served_params
from ..serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. calibrated physics core -----------------------------------
    cal = load_calibration()
    print(f"nominal critical path: "
          f"{float(cal.delay_poly(0, 0, 0.9)) * 1e9:.3f} ns @ 0.90 V "
          f"(paper: 1.542 ns)")

    # --- 2. lifetime policies ------------------------------------------
    res = evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber),
                          cal.aging, cal.delay_poly, cal.power,
                          cal.lifetime_cfg, device=dev)
    b = res["baseline"]
    print(f"classical AVS : V 0.90->{b['v_final']:.2f} V, "
          f"ΔVth,p {b['dvp_final']:.1f} mV, P_avg {b['p_avg']:.2f} W")
    q = res["q"]
    print(f"fault-tolerant (Q domain): V stays {q['v_final']:.2f} V, "
          f"ΔVth,p {q['dvp_final']:.1f} mV, saves "
          f"{q['power_saving_pct']:.1f}% power")
    print(f"average lifetime power saving: "
          f"{res['avg_power_saving_pct']:.1f}% (paper: 14.0%)")

    # --- 3. aging-aware serving ----------------------------------------
    cfg = get_config("llama3_8b").reduced()
    params = served_params(cfg, dev)
    runtime = FleetRuntime(n_devices=1, policy="fault_tolerant", device=dev)
    runtime.set_age(years=9.0)
    engine = ServeEngine(cfg, params, runtime=runtime, max_len=64,
                         device=dev)

    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                          global_batch=2).batch_at(0).tokens
    out = engine.generate(prompts, 8)
    print(f"\nserved at age {out.age_years:.1f}y on {dev}; per-op "
          f"admitted BER:")
    for op, ber in sorted(out.bers.items()):
        print(f"  {op:5s} {ber:.2e}")
    print(f"generated tokens:\n{out.tokens}")
    return {"policy": res, "serve": out}


if __name__ == "__main__":
    main()
