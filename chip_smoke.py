#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py [--layers 32] [--three-pass-layers 4]

Phases (any failure exits non-zero):

1. the card: ``torch.cuda.is_available()``, ``nvidia-smi`` name and power
   limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time and each kernel's ptxas registers,
   spills and shared memory;
3. hold each kernel against its plain PyTorch version at the serve path's
   shapes (llama3_8b, B=2, prompt 16: M = 32 prefill / 2 decode) with
   BER 1e-3 so flips occur — int32 and float32 outputs bit-exact, in all
   three GEMM modes, every launch on the fast path — and time kernel, plain
   version and, for the int8 GEMMs, ``torch._int_mm``: ``ms`` with CUDA
   events through the wrapper (its host cost included), ``dev_ms`` with
   ``torch.profiler`` on the device, rotating copies of ``b`` so the weight
   is read from device memory as in serving, beside the bytes/operations
   bound;
4. the main path: ``evaluate_policy`` (Table I/II), a ``FleetRuntime``
   aged 9 years, and ``ServeEngine(llama3_8b full width, bf16 random
   params, use_systolic_kernel=True).generate`` of 8 tokens for B=2 on the
   fused-kernel route, with launch counts (and the fast path for every
   GEMM) checked against the model's operator count; plus a reduced-model generation held against the same
   port on the CPU (plain versions);
   ``torch.profiler`` over one more prefill + decode step gives the
   device busy share and the ops that take the device time;
5. a short three-pass generation (``use_fused_kernel=False``) that must
   launch ``systolic_matmul`` on its fast path;
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
   line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.  The port never calls
``torch._int_mm``; it is timed here only as a yardstick.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
TABLE2 = {                     # paper Table II: op -> (V_final, dvp, dvn, saving %)
    "q": (0.90, 73.1, 46.1, 17.0), "k": (0.94, 79.0, 52.1, 14.3),
    "v": (0.90, 73.1, 46.1, 17.0), "qkt": (0.90, 73.1, 46.1, 17.0),
    "sv": (0.90, 73.1, 46.1, 17.0), "o": (1.01, 99.7, 77.8, 3.1),
    "gate": (0.90, 73.1, 46.1, 17.0), "up": (0.90, 73.1, 46.1, 17.0),
    "down": (0.99, 90.8, 66.7, 7.8),
}
JAX_KERNELS = {
    "fused_aged_matmul": "src/repro/kernels/fused_aged_matmul.py:208",
    "bitflip_words": "src/repro/kernels/bitflip.py:49",
    "systolic_matmul": "src/repro/kernels/systolic_matmul.py:64",
}
SOURCE = "src/repro_torch/kernels/csrc/aged_kernels.cu"


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn()`` over ``iters`` back-to-back calls
    (CUDA events): the device time, or the caller's host cost where that is
    longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int = 20, match: str | None = None) -> tuple:
    """``torch.profiler`` device time per call of ``fn()``: the self time
    of the CUDA kernels it launched (those whose name holds ``match``, if
    given) over ``iters`` calls.  Returns ``(ms, kernels per call)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and (match is None or match in e.key)]
    return (sum(_dev_us(e) for e in evs) / 1e3 / iters,
            sum(e.count for e in evs) / iters)


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(x, y) -> float:
    import torch
    if x.dtype == torch.int32:
        return float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
    return float((x - y).abs().max())


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each kernel in
    nvcc's ``-Xptxas -v`` log, with a readable kernel name."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("int8_gemm_tc_kernel", "int8_gemm_kernel",
                                     "bitflip_kernel") if k in mangled),
                        mangled)
            # template arguments: the integers up to the first "EEv"
            args = re.findall(r"Li(\d+)E", mangled.split(name, 1)[-1]
                              .split("EEv")[0] + "E")
            if args:
                name += "<" + ",".join(args) + ">"
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
            if m:
                cur["registers"] = int(m.group(1))
                cur["static_smem"] = int(m.group(2) or 0)
    return out


# --------------------------------------------------------------------------- #
def kernel_checks(dev, cfg) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.bitflip import bitflip_words
    from repro_torch.kernels.fused_aged_matmul import (fused_aged_matmul,
                                                       upset_probability)
    from repro_torch.kernels.systolic_matmul import systolic_matmul

    gen = torch.Generator(device=dev).manual_seed(1234)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    gemm_kn = [(d, cfg.n_heads * cfg.hd, "q/o"), (d, kvd, "k/v"),
               (d, f, "gate/up"), (f, d, "down")]
    ber, q = 1e-3, upset_probability(1e-3)
    rows = {"fused_aged_matmul": [], "systolic_matmul": [],
            "bitflip_words": []}
    for M in (32, 2):
        for K, N, what in gemm_kn:
            a = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                              device=dev, generator=gen)
            b = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen)
            xs = torch.rand((M, 1), device=dev, generator=gen) * 0.01 + 1e-3
            ws = torch.rand((1, N), device=dev, generator=gen) * 0.01 + 1e-3
            seed = int(torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                                     generator=gen, device=dev))
            bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
            plan = _cuda.gemm_plan(M, N, K, n_sms)
            shape = {"M": M, "K": K, "N": N, "op": what,
                     "plan": {"path": plan.path, "bm": plan.bm,
                              "bn": plan.bn, "splits": plan.splits,
                              "ctas": plan.ctas}}
            # copies of b, more bytes than the 50 MB L2 holds, taken in
            # turn by the timed calls: serving reads every weight cold
            bs = itertools.cycle([b] + [b.clone() for _ in range(
                -(-120_000_000 // b.numel()) - 1)])
            nb = lambda: next(bs)

            kernels.reset_launch_counts()
            out, exp = (fused_aged_matmul(a, b, xs, ws, ber, seed, bm=bm,
                                          bn=bn),
                        ref.fused_aged_matmul_ref(a, b, xs, ws, ber, seed,
                                                  bm=bm, bn=bn))
            up, up_exp = (fused_aged_matmul(a, b, None, None, ber, seed,
                                            bm=bm, bn=bn),
                          ref.fused_aged_matmul_ref(a, b, None, None, ber,
                                                    seed, bm=bm, bn=bn))
            clean, clean_exp = systolic_matmul(a, b), \
                ref.systolic_matmul_ref(a, b)
            torch.cuda.synchronize()
            err = max(max_abs_err(out, exp), max_abs_err(up, up_exp))
            check(err == 0.0 and torch.equal(out, exp)
                  and torch.equal(up, up_exp),
                  f"fused_aged_matmul {shape}: max |err| {err}")
            flips = int((up != clean_exp).sum())
            check(flips > 0 or M * N < 1e4, f"no upsets drawn at {shape}")
            sys_err = max_abs_err(clean, clean_exp)
            check(sys_err == 0.0 and torch.equal(clean, clean_exp),
                  f"systolic_matmul {shape}: max |err| {sys_err}")
            by_path = kernels.launch_counts_by_path()
            check(by_path == {"fused_aged_matmul": {"fast": 2, "generic": 0},
                              "systolic_matmul": {"fast": 1, "generic": 0}},
                  f"GEMM launches off the fast path at {shape}: {by_path}")

            fk = lambda: fused_aged_matmul(a, nb(), xs, ws, ber, seed, bm=bm,
                                           bn=bn)
            fk1 = lambda: fused_aged_matmul(a, nb(), None, None, ber, seed,
                                            bm=bm, bn=bn)
            fr = lambda: ref.fused_aged_matmul_ref(a, b, xs, ws, ber, seed,
                                                   bm=bm, bn=bn)
            sk = lambda: systolic_matmul(a, nb())
            sr = lambda: ref.systolic_matmul_ref(a, b)
            lib = lib_dev = None
            if M > 16:        # torch._int_mm needs more than 16 rows
                lk = lambda: torch._int_mm(a, nb())
                lib = cuda_time_ms(lk)
                lib_dev = device_ms(lk)[0]
            dev_ms, per_call = device_ms(fk, match="int8_gemm")
            check(per_call == 1, f"fused GEMM kernels per call {per_call}")
            t_b, by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                            2.0 * M * K * N)
            # no one PyTorch call upsets and dequantises; _int_mm times the
            # GEMM part alone, as a yardstick
            rows["fused_aged_matmul"].append(dict(
                shape, flips=flips, max_abs_err=err, ms=cuda_time_ms(fk),
                dev_ms=dev_ms,
                dev_ms_mode1=device_ms(fk1, match="int8_gemm")[0],
                plain_ms=cuda_time_ms(fr, iters=3, warmup=1),
                bound_ms=t_b, bound_by=by, library_ms=None, int_mm_ms=lib,
                int_mm_dev_ms=lib_dev))
            t_b, by = bound(M * K + K * N + 4 * M * N, 2.0 * M * K * N)
            rows["systolic_matmul"].append(dict(
                shape, max_abs_err=sys_err, ms=cuda_time_ms(sk),
                dev_ms=device_ms(sk, match="int8_gemm")[0],
                plain_ms=cuda_time_ms(sr, iters=3, warmup=1),
                bound_ms=t_b, bound_by=by, library_ms=lib,
                library_dev_ms=lib_dev))
    # qkt/sv words of prefill and decode, padded to (R, 128), R % 256 == 0
    for R, what in ((256, "qkt prefill / qkt,sv decode"), (1024,
                                                           "sv prefill")):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 128), dtype=torch.int32,
                          device=dev, generator=gen)
        u = torch.rand((R, 128), device=dev, generator=gen)
        pos = torch.randint(0, 32, (R, 128), dtype=torch.int32, device=dev,
                            generator=gen)
        bk = lambda: bitflip_words(x, u, pos, q)
        br = lambda: ref.bitflip_words_ref(x, u, pos, q)
        out, exp = bk(), br()
        torch.cuda.synchronize()
        err = max_abs_err(out, exp)
        check(err == 0.0 and torch.equal(out, exp),
              f"bitflip_words R={R}: max |err| {err}")
        check(bool((out != x).any()), f"bitflip_words R={R}: no flips")
        t_b, by = bound(16 * R * 128, 0.0)
        rows["bitflip_words"].append(dict(
            R=R, op=what, max_abs_err=err, ms=cuda_time_ms(bk),
            dev_ms=device_ms(bk, match="bitflip")[0],
            plain_ms=cuda_time_ms(br), bound_ms=t_b, bound_by=by,
            library_ms=None))
    return rows


def table_checks(res) -> None:
    for op, (vf, dvp, dvn, saving) in TABLE2.items():
        r = res[op]
        check(abs(r["v_final"] - vf) <= 0.015, f"Table II V_final {op}")
        check(abs(r["dvp_final"] / dvp - 1) <= 0.05, f"Table II dvp {op}")
        check(abs(r["dvn_final"] / dvn - 1) <= 0.13, f"Table II dvn {op}")
        check(abs(r["power_saving_pct"] - saving) <= 2.5,
              f"Table II power saving {op}")
    check(abs(res["avg_power_saving_pct"] - 14.0) <= 2.0,
          "Table II average power saving")
    check(abs(res["baseline"]["v_final"] - 1.02) <= 0.005,
          "Table I AVS final voltage")


def weight_quant_ms(params, layers) -> float:
    """Device time of the per-call weight quantisation of one forward pass
    (``quantize_int8(w, axis=0)`` of every weight matmul of every layer)."""
    import torch
    from repro_torch.kernels.ops import quantize_int8

    def once():
        for lp in params["layers"][:layers]:
            a, m = lp["attn"], lp["ffn"]
            # the 2-D views op_einsum hands to aged_linear
            for w in (a["wq"].reshape(a["wq"].shape[0], -1),
                      a["wk"].reshape(a["wk"].shape[0], -1),
                      a["wv"].reshape(a["wv"].shape[0], -1),
                      a["wo"].reshape(-1, a["wo"].shape[-1]),
                      m["w_gate"], m["w_up"], m["w_down"]):
                quantize_int8(w, axis=0)
    return cuda_time_ms(once, iters=3, warmup=1)


def profile_generate(engine, prompts, want_gemm: int) -> dict:
    """``torch.profiler`` over prefill + one decode step.

    Device busy time is the sum of the CUDA kernels' self times (one
    stream, so they do not overlap); the share divides it by the host
    clock of the same call run without the profiler, whose own host cost
    would otherwise dilute it.  A trace that holds fewer than the
    ``want_gemm`` GEMM launches the step makes has dropped records; it is
    taken once more, and ``complete`` says whether the kept one is whole.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompts, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(prompts, 2)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        gemm = [e for e in kernels if "int8_gemm" in e.key]
        if sum(e.count for e in gemm) == want_gemm:
            break
    busy = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    ours = {e.key: {"device_ms_per_launch": _dev_us(e) / 1e3 / e.count,
                    "launches": e.count}
            for e in kernels if "int8_gemm" in e.key
            or "bitflip_kernel" in e.key}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "n_kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:120], "device_ms": _dev_us(e) / 1e3,
                     "calls": e.count} for e in top],
            "port_kernels": ours,
            "gemm_launches": sum(e.count for e in gemm),
            "gemm_device_ms": sum(_dev_us(e) for e in gemm) / 1e3,
            "attempts": attempt,
            "complete": sum(e.count for e in gemm) == want_gemm}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=32,
                   help="decoder depth of the full-width serve run")
    p.add_argument("--three-pass-layers", type=int, default=4)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.artifacts import load_calibration
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.core.policy import FaultTolerantPolicy, evaluate_policy
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _cuda
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda", 0)
    # the float32 checks below assume full-precision matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"argv": sys.argv[1:]}

    # 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    report["card"] = smi_line
    report["torch"] = torch.__version__
    print(f"[1] card: {smi_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # 2. build -------------------------------------------------------------
    info = _cuda.build()
    _cuda.library()
    ptxas = ptxas_report(info["log"])
    report["build_s"] = info["seconds"]
    report["ptxas"] = ptxas
    print(f"[2] built {info['path']} in {info['seconds']:.1f} s", flush=True)
    for k in ptxas:
        print(f"    {k['kernel']:34s} {k.get('registers')} registers, "
              f"spills {k.get('spill_stores')}/{k.get('spill_loads')} B "
              f"(store/load), {k.get('static_smem')} bytes static smem")

    cfg = get_config("llama3_8b")
    # 3. kernels vs plain versions -----------------------------------------
    t0 = time.perf_counter()
    rows = kernel_checks(dev, cfg)
    report["kernel_checks"] = rows
    print(f"[3] kernels bit-exact vs plain versions at main-path shapes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
    for name, rs in rows.items():
        for r in rs:
            yard = r.get("int_mm_ms", r["library_ms"])
            yard_dev = r.get("int_mm_dev_ms", r.get("library_dev_ms"))
            where = r.get("op")
            dims = (f"M={r['M']} K={r['K']} N={r['N']}" if "M" in r
                    else f"R={r['R']}")
            mode1 = (f" (mode 1 {r['dev_ms_mode1']:.4f})"
                     if "dev_ms_mode1" in r else "")
            print(f"    {name:18s} {dims:24s} {where:28s} "
                  f"kernel {r['ms']:.4f} ms, dev {r['dev_ms']:.4f}{mode1}  "
                  f"plain {r['plain_ms']:.4f}  bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})  _int_mm {fmt(yard)}, dev "
                  f"{fmt(yard_dev)}")
    for r in rows["fused_aged_matmul"]:
        p = r["plan"]
        print(f"    plan M={r['M']} {r['op']:8s}: {p['path']} path, "
              f"{p['bm']}x{p['bn']} tile, {p['splits']} K splits, "
              f"{p['ctas']} CTAs", flush=True)

    # 4. main path ---------------------------------------------------------
    cal = load_calibration()
    t0 = time.perf_counter()
    res = evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber), cal.aging,
                          cal.delay_poly, cal.power, cal.lifetime_cfg,
                          device=dev)
    torch.cuda.synchronize()
    policy_s = time.perf_counter() - t0
    table_checks(res)
    b = res["baseline"]
    print(f"[4] evaluate_policy on the card in {policy_s:.2f} s: classical "
          f"AVS V 0.90->{b['v_final']:.2f} V, dVth,p {b['dvp_final']:.1f} "
          f"mV, P_avg {b['p_avg']:.3f} W; average saving "
          f"{res['avg_power_saving_pct']:.2f}% (paper 14.0%)", flush=True)
    for op in TABLE2:
        r = res[op]
        print(f"    {op:5s} V_final {r['v_final']:.2f}  dVth,p "
              f"{r['dvp_final']:.1f}  dVth,n {r['dvn_final']:.1f}  saving "
              f"{r['power_saving_pct']:.1f}%")
    report["table2"] = {op: {k: res[op][k] for k in
                             ("v_final", "dvp_final", "dvn_final",
                              "power_saving_pct")} for op in TABLE2}
    report["policy_s"] = policy_s

    runtime = FleetRuntime(n_devices=1, policy="fault_tolerant", device=dev)
    runtime.set_age(years=9.0)
    bers = runtime.op_bers()
    check(all(math.isfinite(v) and v > 0 for v in bers.values()),
          f"admitted BERs {bers}")
    print("    age 9 y admitted BER: " + ", ".join(
        f"{op} {v:.2e}" for op, v in bers.items()), flush=True)
    report["bers_age9"] = bers

    L = args.layers
    cfg_run = dataclasses.replace(cfg, n_layers=L)
    t0 = time.perf_counter()
    params = init_params(cfg_run, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"    llama3_8b full width, {L} layers, {n_params / 1e9:.2f} B bf16 "
          f"params initialised in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                          global_batch=2).batch_at(0).tokens
    # warm-up on a separate engine (cuBLAS handles, library load)
    ServeEngine(cfg_run, params, runtime=runtime, max_len=64,
                use_systolic_kernel=True, device=dev).generate(prompts, 2)
    engine = ServeEngine(cfg_run, params, runtime=runtime, max_len=64,
                         use_systolic_kernel=True, device=dev)
    n_steps = 8
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_steps)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    peak = torch.cuda.max_memory_allocated(dev)
    tok = out.tokens
    check(tok.shape == (2, n_steps), f"tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "token ids")
    check(all(np.isfinite(v).all() for v in out.telemetry.values()),
          "logit taps not finite")
    want_fused = 7 * L * n_steps
    want_flip = 2 * L * n_steps
    check(counts["fused_aged_matmul"] == want_fused,
          f"fused_aged_matmul launches {counts} != {want_fused}")
    check(counts["bitflip_words"] == want_flip,
          f"bitflip_words launches {counts} != {want_flip}")
    check(counts["systolic_matmul"] == 0, f"systolic launches {counts}")
    check(by_path["fused_aged_matmul"] == {"fast": want_fused, "generic": 0},
          f"main-path GEMM launches off the fast path: {by_path}")
    pf, dc = out.timings["prefill_s"], out.timings["decode_s"]
    per_tok = dc / (n_steps - 1)
    serve = {"layers": L, "batch": 2, "prompt": 16, "n_steps": n_steps,
             "generate_s": gen_s, "prefill_s": pf,
             "decode_s_per_token": per_tok,
             "tokens_per_s": 2 * n_steps / gen_s,
             "max_memory_allocated_gb": peak / 1e9, "launches": counts,
             "launches_by_path": by_path,
             "tokens": tok.tolist()}
    serve["weight_quant_ms_per_forward"] = weight_quant_ms(params, L)
    report["serve"] = serve
    print(f"    generate: prefill {pf * 1e3:.1f} ms, decode "
          f"{per_tok * 1e3:.1f} ms/token, {serve['tokens_per_s']:.2f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB; weight "
          f"quantisation {serve['weight_quant_ms_per_forward']:.1f} ms per "
          f"forward", flush=True)
    print(f"    launches: {counts}; tokens {tok.tolist()}", flush=True)
    main_counts = counts
    report["profile"] = profile_generate(engine, prompts, 7 * L * 2)
    prof = report["profile"]
    print(f"    prefill + 1 decode step: {prof['wall_ms']:.1f} ms, device "
          f"busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f}%) over "
          f"{prof['n_kernel_launches']} kernel launches; top kernels: "
          + ", ".join(f"{o['name'][:48]} {o['device_ms']:.1f} ms"
                      for o in prof["top"][:5]), flush=True)
    print(f"    int8 GEMM (fused) device time in that profile: "
          f"{prof['gemm_device_ms']:.2f} ms over {prof['gemm_launches']} of "
          f"{7 * L * 2} launches (profile "
          f"{'complete' if prof['complete'] else 'INCOMPLETE'}, attempt "
          f"{prof['attempts']})", flush=True)
    del engine, params
    torch.cuda.empty_cache()

    # reduced model: the card's kernel route vs the port on the CPU
    small = cfg.reduced()
    p_cpu = init_params(small, seed=1, dtype=torch.float32, device="cpu")
    p_gpu = _map(p_cpu, lambda t: t.to(dev))
    small_prompts = SyntheticLM(vocab=small.vocab, seq_len=12,
                                global_batch=2).batch_at(0).tokens
    outs = {}
    for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        outs[name] = ServeEngine(small, p, runtime=_Forced(1e-3),
                                 max_len=32, use_systolic_kernel=True,
                                 seed=5, device=d).generate(small_prompts,
                                                            6)
    same = np.array_equal(outs["cuda"].tokens, outs["cpu"].tokens)
    report["reduced_vs_cpu"] = {"cuda": outs["cuda"].tokens.tolist(),
                                "cpu": outs["cpu"].tokens.tolist()}
    check(same, f"reduced model: card tokens {outs['cuda'].tokens.tolist()} "
          f"!= CPU tokens {outs['cpu'].tokens.tolist()}")
    print("    reduced llama3_8b at BER 1e-3: card kernel route == CPU plain "
          "route tokens", flush=True)

    # 5. three-pass route --------------------------------------------------
    L3 = args.three_pass_layers
    cfg3 = dataclasses.replace(cfg, n_layers=L3)
    params3 = init_params(cfg3, seed=0, dtype=torch.bfloat16, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out3 = ServeEngine(cfg3, params3, runtime=runtime, max_len=64,
                       use_systolic_kernel=True, use_fused_kernel=False,
                       device=dev).generate(prompts, 2)
    counts3 = kernels.launch_counts()
    by_path3 = kernels.launch_counts_by_path()
    check(out3.tokens.shape == (2, 2), "three-pass tokens shape")
    check(counts3["systolic_matmul"] == 7 * L3 * 2,
          f"systolic_matmul launches {counts3}")
    check(counts3["bitflip_words"] == 9 * L3 * 2,
          f"three-pass bitflip launches {counts3}")
    check(counts3["fused_aged_matmul"] == 0, f"fused launches {counts3}")
    check(by_path3["systolic_matmul"] == {"fast": 7 * L3 * 2, "generic": 0},
          f"three-pass GEMM launches off the fast path: {by_path3}")
    report["three_pass"] = {"layers": L3, "launches": counts3,
                            "generate_s": time.perf_counter() - t0}
    print(f"[5] three-pass route, {L3} layers, 2 tokens: launches "
          f"{counts3}", flush=True)
    del params3

    # 6. summary ----------------------------------------------------------
    launches = {"fused_aged_matmul": main_counts["fused_aged_matmul"],
                "bitflip_words": main_counts["bitflip_words"],
                "systolic_matmul": counts3["systolic_matmul"]}
    # the representative shape of each kernel: the decode weight matmul
    # that dominates the fused route (gate/up, M = 2), the prefill gate/up
    # GEMM (M = 32, where torch._int_mm computes the same function) and
    # the prefill sv words
    pick = {"fused_aged_matmul": lambda r: r["M"] == 2
            and r["op"] == "gate/up",
            "systolic_matmul": lambda r: r["M"] == 32
            and r["op"] == "gate/up",
            "bitflip_words": lambda r: r["R"] == 1024}
    line = []
    for name in ("fused_aged_matmul", "bitflip_words", "systolic_matmul"):
        r = next(r for r in rows[name] if pick[name](r))
        line.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": JAX_KERNELS[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dev_ms": r["dev_ms"],
            "ok": True,
            "shape": {k: r[k] for k in ("M", "K", "N", "R") if k in r}})
    report["kernels"] = line
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": line}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class _Forced:
    """A runtime that admits one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber: float):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in TABLE2}

    def total_power(self) -> float:
        return 0.0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
