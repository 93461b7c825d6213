"""Aging-aware serving scenario: a fleet of accelerators, ten years, two
policies (port of the reference's ``examples/aging_aware_serving.py``).

Trains a reduced llama3_8b briefly, then builds one :class:`FleetRuntime`
per policy holding four devices aged 0/3/6/9.5 years and scores the model
on every device under classical AVS and under the fault-tolerant policy
(supply, admitted BER, power, NLL with real bit-error injection).  Serves
the whole fault-tolerant fleet with one :class:`FleetServeEngine` (the
four lanes folded into one forward per step, each at its own device's
BERs), then measures THIS model's per-operator resilience with the
batched fault-injection sweep (:func:`recalibrate_for_deployment`), and
closes with wear-levelling: the next three years of diurnal traffic
routed by ``round_robin`` and by ``wear_level``.

Run:  PYTHONPATH=src python -m repro_torch.examples.aging_aware_serving
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamWConfig
from ..serve.engine import FleetServeEngine, ServeEngine
from ..train.steps import init_train_state, make_train_step

AGES = (0.0, 3.0, 6.0, 9.5)


def recalibrate_for_deployment(cfg, params, tokens, *,
                               ber_grid=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2),
                               n_seeds=1, device="cuda"):
    """Measure this deployment's resilience curves and compare the knees
    with the published defaults the policy ships with: one batched
    fault-injection sweep over the BER x operator grid, a logistic fit per
    operator.  The fitted curves drive the same policy as
    ``policy="measured"`` once persisted with
    ``python -m repro_torch.launch.calibrate_resilience``."""
    from ..calibrate import empirical_resilience
    from ..core.resilience import DEFAULT_BER50

    curves, _ = empirical_resilience(cfg, params, tokens, ber_grid=ber_grid,
                                     n_seeds=n_seeds, device=device)
    print("\nmeasured resilience of this deployment (vs published "
          "defaults):")
    for op in ("q", "k", "o", "down"):
        print(f"  {op:>4}: measured BER50 {curves[op].ber50:.1e} "
              f"(published {DEFAULT_BER50[op]:.1e})")
    print("The measured knees differ from the published curves in both "
          "directions, so a policy tuned on the published curves is "
          "mis-tuned for this deployment.  Persist the fit with "
          "repro_torch.launch.calibrate_resilience and serve with "
          "policy='measured' to close the loop.")
    return curves


def quick_train(cfg, data, steps=60, device="cuda"):
    """``steps`` AdamW steps from seed 0; returns ``(params, last loss)``."""
    state = init_train_state(cfg, 0, device=device)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, total_steps=steps,
                                            warmup_steps=5))
    for i in range(steps):
        tb = data.batch_at(i)
        state, m = step(state, {"tokens": tb.tokens, "labels": tb.labels})
    return state.params, float(m["loss"])


def _fleet(policy: str, device) -> FleetRuntime:
    fleet = FleetRuntime(n_devices=len(AGES), policy=policy, device=device)
    for i, years in enumerate(AGES):
        fleet.set_age(years=max(years, 1e-3), device=i)
    return fleet


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and serves (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()

    cfg = get_config("llama3_8b").reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=16)
    params, loss = quick_train(cfg, data, device=device)
    print(f"[serve] trained reduced model to loss {loss:.3f} "
          f"(uniform {data.uniform_nll():.3f}) on {device}\n")

    fleets = {name: _fleet(pol, device) for name, pol in (
        ("baseline", "baseline"), ("fault-tolerant", "fault_tolerant"))}
    eval_toks = data.batch_at(999).tokens
    hdr = (f"{'age':>5} | {'policy':^15} | {'V(q)':>5} {'V(o)':>5} | "
           f"{'BER(q)':>8} {'BER(o)':>8} | {'P [W]':>6} | {'NLL':>6}")
    print(hdr + "\n" + "-" * len(hdr))
    scores = {}
    for i, years in enumerate(AGES):
        for name, fleet in fleets.items():
            dev = fleet.device(i)
            eng = ServeEngine(cfg, params, runtime=dev, max_len=128,
                              device=device)
            nll = eng.score(eval_toks)
            scores[(years, name)] = nll
            q, o = dev.domain_state("q"), dev.domain_state("o")
            print(f"{years:5.1f} | {name:^15}"
                  f" | {q.v_dd:5.2f} {o.v_dd:5.2f} | {q.ber:8.1e} "
                  f"{o.ber:8.1e} | {dev.total_power():6.2f} | {nll:6.3f}")

    ft, bl = fleets["fault-tolerant"], fleets["baseline"]
    saved = 100 * (1 - ft.fleet_power().sum() / bl.fleet_power().sum())
    print(f"\nfleet array power (all {len(AGES)} devices): "
          f"fault-tolerant {ft.fleet_power().sum():.2f} W vs baseline "
          f"{bl.fleet_power().sum():.2f} W ({saved:.1f}% saved)")

    # the whole staggered fleet in one lane-batched forward per step
    n_steps, B = 12, 4
    prompts = data.batch_at(0).tokens[:B, :24]
    engine = FleetServeEngine(cfg, params, ft, max_len=64, device=device)
    lanes = np.stack([prompts] * len(AGES))
    engine.generate(lanes, n_steps)                  # warm-up
    t0 = time.perf_counter()
    res = engine.generate(lanes, n_steps)
    dt = time.perf_counter() - t0
    total = len(AGES) * B * n_steps
    print(f"\nfleet-batched generation: {res.tokens.shape} tokens "
          f"(lanes x batch x steps), one forward per step for all lanes — "
          f"{total / dt:.0f} tok/s warm")
    q = res.operators.index("q")
    for i in range(len(AGES)):
        print(f"  dev{i} ({res.ages_years[i]:4.1f}y, "
              f"BER(q)={res.bers[i, q]:.1e}): "
              f"{res.tokens[i, 0][:10].tolist()}")
    print("Lanes share prompts but diverge with age: older devices admit "
          "higher BER, so their upsets perturb the continuations.  The "
          "fault-tolerant policy holds tolerant domains (q) at 0.90 V, "
          "admitting bounded BER instead of boosting.")

    # close the loop: measure this model's curves (not just cite them)
    curves = recalibrate_for_deployment(cfg, params, eval_toks,
                                        ber_grid=(1e-5, 1e-4, 1e-3),
                                        n_seeds=1, device=device)

    # closing act: route the next years of traffic to slow aging down
    print("\nwear-leveling the staggered fleet's next 3 years of diurnal "
          "traffic (one co-sim per router):")
    finals = {}
    for router in ("round_robin", "wear_level"):
        fl = _fleet("fault_tolerant", device)
        cos = fl.apply_load(workload="diurnal", router=router,
                            n_epochs=144, utilization=0.55,
                            horizon_s=3 * 365.25 * 24 * 3600.0)
        wear = cos.device_wear()[-1]
        worst = int(wear.argmax())
        finals[router] = wear
        print(f"  {router:>12}: fleet-max ΔVth {wear.max():6.2f} mV "
              f"(spread {wear.max() - wear.min():5.2f} mV), worst-device "
              f"BER {fl.op_ber_array()[worst].max():.1e}")
    cut = 100 * (1 - finals["wear_level"].max()
                 / finals["round_robin"].max())
    print(f"Routing alone removed {cut:.1f}% of the fleet's worst-case "
          "degradation: wear_level starves the 9.5-year device while the "
          "young devices absorb the diurnal peaks.")
    seconds = time.perf_counter() - t_start
    print(f"[serve] done in {seconds:.1f} s")
    return {"train_loss": loss, "power_saved_pct": float(saved),
            "fleet_tokens_per_s": total / dt, "wear_cut_pct": float(cut),
            "ber50": {op: c.ber50 for op, c in curves.items()},
            "scores": {f"{a:g}y {n}": v for (a, n), v in scores.items()},
            "seconds": seconds}


if __name__ == "__main__":
    main()
