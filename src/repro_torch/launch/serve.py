"""Serving launcher (port of ``repro.launch.serve``):
``python -m repro_torch.launch.serve --arch <id> [...] [--torch-device
cpu]``.

Runs the aging-aware engine end to end on a reduced config: params from
seed 0, a :class:`repro_torch.core.fleet.FleetRuntime` of ``--n-devices``
simulated accelerators of staggered age, and batched generation under the
per-operator BERs the policy admits at each device's age.

With ``--n-devices > 1`` the whole fleet serves in one lane-batched
forward a step (:class:`~repro_torch.serve.engine.FleetServeEngine`);
``--device <i>`` narrows to lane ``i`` alone on a
:class:`~repro_torch.serve.engine.ServeEngine`.  ``--router`` (default
``round_robin``) first ages the fleet under routed ``--workload`` traffic
over ``--horizon-years``; ``static`` keeps the fixed-profile aging.

The flags are the reference's, letter for letter, so ``--device`` is the
fleet lane; the torch device is ``--torch-device`` (default ``cuda``,
which raises where no card is present).  The port has one per-token loop,
so ``--eager`` changes nothing on one device (and is refused for a fleet,
as in the reference).  ``--online`` hands the other arguments to
:mod:`repro_torch.launch.online` (continuous batching), ``--torch-device``
as its ``--device``.  ``--mesh`` serves one device of ``--tp`` mesh
shards aged on their own (staggered ``--age-years * (s+1)/tp``) through
:class:`~repro_torch.serve.sharded.MeshServeEngine`, on the fused
shard-mode kernels (``--fused``, the default) or the plain route
(``--no-fused``); ``--tp`` defaults to the visible devices.  Inside a
started process group, ``--mesh`` places the shards over its ranks, as the
reference's spans its devices (``--tp`` defaults to the world; rank 0
prints): :func:`rank_main` is the function to hand
:func:`repro_torch.launch.mesh.run_local_ranks` with the argument list,
e.g. ``run_local_ranks(rank_main, 4, ["--arch", "llama3_8b", "--mesh",
"--torch-device", "cpu"], backend="gloo", device="cpu")``.  Not ported:
``--stats`` (the reference's compiled-function caches; the port compiles
nothing), which raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..data import SyntheticLM
from ..device import resolve_device
from ..sched.router import ROUTER_REGISTRY
from ..sched.workload import WORKLOADS
from ..serve.engine import FleetServeEngine, ServeEngine
from ..train.steps import init_train_state
from ..tree import tree_map

YEAR_S = 365.25 * 24 * 3600.0


def served_params(cfg, device):
    """``init_train_state``'s float32 params from seed 0, drawn on the CPU
    and moved to ``device``: a card serves the CPU's weights."""
    params = init_train_state(cfg, 0, device="cpu").params
    return tree_map(lambda x: x.to(device), params)


def extra_inputs(cfg, batch: int) -> dict:
    """A VLM's zero prefix embeddings or an enc-dec model's zero frames,
    as the reference's launchers feed them."""
    extra = {}
    if cfg.prefix_tokens:
        extra["prefix_embeds"] = np.zeros(
            (batch, cfg.prefix_tokens, cfg.d_model), np.float32)
    if cfg.n_encoder_layers:
        extra["frames"] = np.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), np.float32)
    return extra


def make_policy(name, arch: str):
    """``--policy``: a registered name, or the measured policy on this
    arch's curves."""
    if name != "measured":
        return name
    from ..core.artifacts import load_calibration
    from ..core.policy import MeasuredResiliencePolicy
    return MeasuredResiliencePolicy(ber_model=load_calibration().ber,
                                    model=arch)


def main(argv=None):
    argv_list = list(sys.argv[1:] if argv is None else argv)
    if "--online" in argv_list:
        # continuous-batching mode: delegate to the online launcher (live
        # request queue, slot refills, occupancy-driven aging), whose
        # torch device flag is --device
        from . import online
        argv_list.remove("--online")
        if any(a == "--device" or a.startswith("--device=")
               for a in argv_list):
            raise SystemExit("serve --online: --device is a fleet lane, "
                             "which the online launcher does not take; "
                             "pass --torch-device for the torch device")
        return online.main([
            "--device" + a[len("--torch-device"):]
            if a.startswith("--torch-device") else a for a in argv_list])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--online", action="store_true",
                    help="serve a live request queue with continuous "
                         "batching instead of a static prompt batch (the "
                         "other arguments go to repro_torch.launch.online,"
                         " --torch-device as its --device)")
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--age-years", type=float, default=5.0)
    ap.add_argument("--n-devices", type=int, default=1,
                    help="fleet size; device i serves at age-years * "
                         "(i+1)/n (a staggered-deployment fleet)")
    ap.add_argument("--device", type=int, default=None,
                    help="serve ONE fleet lane instead of the whole fleet")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--budget", type=float, default=0.5,
                    help="accuracy budget [%% loss] of the policy")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts per device")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples softmax(logits/T)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="restrict sampling to the k highest logits")
    ap.add_argument("--router", default="round_robin",
                    choices=tuple(sorted(ROUTER_REGISTRY)) + ("static",),
                    help="age the fleet under routed traffic before "
                         "serving; 'static' keeps the fixed-profile aging")
    ap.add_argument("--workload", default="diurnal",
                    choices=sorted(WORKLOADS),
                    help="request-arrival model fed to --router")
    ap.add_argument("--utilization", type=float, default=0.55,
                    help="mean offered load / fleet capacity")
    ap.add_argument("--horizon-years", type=float, default=2.0,
                    help="service horizon the --router traffic spans")
    ap.add_argument("--policy", default=None,
                    choices=("fault_tolerant", "baseline", "measured"),
                    help="AVS policy; 'measured' uses this arch's curves "
                         "from the port's resilience_calibrated.json")
    ap.add_argument("--baseline-avs", action="store_true",
                    help="legacy alias for --policy baseline")
    ap.add_argument("--mesh", action="store_true",
                    help="serve one device of --tp mesh shards, each aged "
                         "on its own, in one sharded dispatch")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel shards of --mesh (default: the "
                         "visible devices)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the faulted matmuls on the kernel route "
                         "(the fused aged-matmul and draw-bitflip kernels "
                         "on a card, their plain versions on the CPU)")
    ap.add_argument("--fused", dest="fused", action="store_true",
                    default=None,
                    help="--mesh: the shard-mode fused GEMM and the "
                         "counter-upset kernel (the default)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="--mesh: the plain product and injection, with "
                         "the same tokens")
    ap.add_argument("--eager", action="store_true",
                    help="single-device only; the port's one per-token "
                         "loop either way")
    ap.add_argument("--stats", action="store_true",
                    help="not ported: the port has no compiled-function "
                         "caches")
    args = ap.parse_args(argv_list)
    if args.stats:
        raise NotImplementedError(
            "--stats reports the reference's compiled-function caches; the "
            "port compiles nothing")
    fleet_mode = args.n_devices > 1 and args.device is None
    if args.eager and fleet_mode:
        ap.error("--eager is single-device only: pass --device <i> to "
                 "pick a lane (the fleet path has no per-token loop)")
    dev = resolve_device(args.torch_device)

    cfg = get_config(args.arch).reduced()
    params = served_params(cfg, dev)
    pol = make_policy(args.policy or ("baseline" if args.baseline_avs
                                      else "fault_tolerant"), args.arch)
    if args.mesh:
        return _run_mesh(args, cfg, params, pol, dev)
    fleet = FleetRuntime(n_devices=args.n_devices, policy=pol,
                         max_loss_pct=args.budget, device=dev)
    for i in range(args.n_devices):
        fleet.set_age(years=args.age_years * (i + 1) / args.n_devices,
                      device=i)
    if args.router != "static":
        cos = fleet.apply_load(workload=args.workload, router=args.router,
                               utilization=args.utilization,
                               horizon_s=args.horizon_years * YEAR_S)
        wear = cos.device_wear()[-1]
        print(f"[serve] routed {args.horizon_years:g}y of "
              f"{args.workload} traffic ({cos.n_epochs} epochs) via "
              f"{args.router}: fleet-max ΔVth {wear.max():.1f} mV "
              f"(spread {wear.max() - wear.min():.1f} mV), mean util "
              f"{np.asarray(cos.util).mean():.2f}")

    max_len = args.prompt_len + args.gen_len + 1
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len,
                          global_batch=args.batch).batch_at(0).tokens
    extra = extra_inputs(cfg, args.batch)
    pol_name = getattr(fleet.policy, "name", "fault_tolerant")
    if fleet_mode:
        engine = FleetServeEngine(cfg, params, fleet, max_len=max_len,
                                  use_systolic_kernel=args.use_kernel,
                                  device=dev)
        tile = lambda x: np.broadcast_to(
            x, (args.n_devices,) + x.shape).copy()
        res = engine.generate(tile(prompts), args.gen_len,
                              temperature=args.temperature,
                              top_k=args.top_k,
                              **{k: tile(v) for k, v in extra.items()})
        ages = ", ".join(f"{a:.1f}y" for a in res.ages_years)
        pw = ", ".join(f"{p:.2f}W" for p in res.power_w)
        print(f"[serve] arch={cfg.name} fleet={args.n_devices} "
              f"policy={pol_name} budget={args.budget}% on {dev} — one "
              f"lane-batched forward a step for the whole fleet")
        print(f"[serve] fleet ages: [{ages}]  power: [{pw}] "
              f"(total {res.power_w.sum():.2f} W)")
        q = res.operators.index("q")
        bq = ", ".join(f"{b:.1e}" for b in res.bers[:, q])
        print(f"[serve] per-lane BER(q): [{bq}]")
        print(f"[serve] generated {res.tokens.shape} tokens "
              "(lanes x batch x steps); lane rows: ")
        for i in range(args.n_devices):
            print(f"    dev{i} ({res.ages_years[i]:.1f}y): "
                  f"{res.tokens[i, 0][:12].tolist()}")
        return res

    engine = ServeEngine(cfg, params, runtime=fleet,
                         runtime_device=args.device or 0, max_len=max_len,
                         use_systolic_kernel=args.use_kernel, device=dev)
    res = engine.generate(prompts, args.gen_len,
                          temperature=args.temperature, top_k=args.top_k,
                          **extra)
    print(f"[serve] arch={cfg.name} fleet={args.n_devices} "
          f"dev={args.device or 0} age={res.age_years:.1f}y "
          f"policy={pol_name} budget={args.budget}% on {dev}")
    print("[serve] per-op BER: " + ", ".join(
        f"{k}={v:.1e}" for k, v in sorted(res.bers.items())))
    print(f"[serve] est. array power: {res.power_w:.2f} W "
          f"(x{len(res.bers)} domains)")
    print(f"[serve] generated {res.tokens.shape} tokens; "
          f"first row: {res.tokens[0][:12].tolist()}")
    return res



def rank_main(mesh, argv):
    """:func:`main` on one rank of a started process group (the signature
    :func:`repro_torch.launch.mesh.run_local_ranks` calls): ``--mesh``
    then places the shards over the group's ranks."""
    return main(argv)


def _run_mesh(args, cfg, params, pol, dev):
    """One device of ``tp`` mesh shards, each aged on its own, served in
    one sharded dispatch; inside a started process group, the shards
    placed over its ranks (every rank serves, rank 0 prints)."""
    from ..serve.sharded import MeshServeEngine, default_serve_mesh

    mesh = default_serve_mesh(args.tp, device=dev)
    tp = mesh.shape["model"]
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    fleet = FleetRuntime(n_devices=1, n_shards=tp, policy=pol,
                         max_loss_pct=args.budget, device=dev)
    for s in range(tp):
        # staggered shard ages: a device rebuilt from spares of mixed age
        fleet.set_age(years=args.age_years * (s + 1) / tp, shard=s)
    if args.router != "static":
        cos = fleet.apply_load(workload=args.workload, router=args.router,
                               utilization=args.utilization,
                               horizon_s=args.horizon_years * YEAR_S)
        wear = cos.device_wear()[-1]
        say(f"[serve] routed {args.horizon_years:g}y of {args.workload} "
            f"traffic over the {tp} shards via {args.router}: max ΔVth "
            f"{wear.max():.1f} mV (spread "
            f"{wear.max() - wear.min():.1f} mV)")

    max_len = args.prompt_len + args.gen_len + 1
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len,
                          global_batch=args.batch).batch_at(0).tokens
    # --fused / --no-fused; unset is the engine's fused route
    engine = MeshServeEngine(cfg, params, mesh=mesh, fleet=fleet,
                             max_len=max_len,
                             use_fused_kernel=(args.fused
                                               if args.fused is not None
                                               else True), device=dev)
    res = engine.generate(prompts, args.gen_len,
                          temperature=args.temperature, top_k=args.top_k,
                          **extra_inputs(cfg, args.batch))
    pol_name = getattr(fleet.policy, "name", "fault_tolerant")
    ages = ", ".join(f"{a:.1f}y" for a in res.ages_years)
    where = (f"{mesh.size} ranks, mesh {mesh.shape}" if mesh.group
             is not None else "one sharded dispatch")
    say(f"[serve] arch={cfg.name} mesh tp={tp} policy={pol_name} "
        f"budget={args.budget}% on {dev} — {where}, per-shard aging")
    say(f"[serve] shard ages: [{ages}]  device power: {res.power_w:.2f} W")
    say("[serve] per-shard BER table (rows=shards):")
    say("         " + " ".join(f"{op:>8s}" for op in res.operators))
    for s in range(res.bers.shape[0]):
        say(f"  shard{s} " + " ".join(f"{b:8.1e}" for b in res.bers[s]))
    say(f"[serve] generated {res.tokens.shape} tokens; "
        f"first row: {res.tokens[0][:12].tolist()}")
    return res


if __name__ == "__main__":
    main()
