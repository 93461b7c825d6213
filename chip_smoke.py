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
3. hold each kernel against its plain PyTorch version at the serve paths'
   shapes (llama3_8b and qwen3_moe_235b at head_dim 128, B=2, prompt 16:
   M = 32 prefill /
   2 decode; the qkt/sv words of prefill and decode) with BER 1e-3 so
   flips occur — int32 and float32 outputs bit-exact, in all three GEMM
   modes, every launch on the fast path, both bitflip modes — and time
   kernel, plain version and, for the int8 GEMMs, ``torch._int_mm``:
   ``ms`` with CUDA events through the wrapper (its host cost included),
   ``dev_ms`` with ``torch.profiler`` on the device, rotating copies of
   ``b`` so the weight is read from device memory as in serving, beside
   the bound (bytes, int8 tensor-core operations or INT32 instructions);
   the bitflip draw mode also beside the flow it replaced (pad, threefry
   draws, explicit pass); then both lane modes at the fleet's shapes (4
   lanes: every llama3_8b weight GEMM at M = 4 x 32 and 4 x 2, the qkt/sv
   words x 4) at per-lane BERs with one lane at 0, bit-exact against their
   plain lane versions and against 4 single-lane launches, and the same
   for qwen3_moe_235b's q/k/v/o/router GEMMs and qkt/sv words;
4. the main path: ``evaluate_policy`` (Table I/II), a ``FleetRuntime``
   aged 9 years, and ``ServeEngine(llama3_8b full width, bf16 random
   params, use_systolic_kernel=True).generate`` of 8 tokens for B=2 on the
   fused-kernel route, with launch counts (the fast path for every GEMM,
   one draw-mode bitflip launch per qkt/sv injection) checked against the
   model's operator count; plus a reduced-model generation held against
   the same port on the CPU (plain versions); ``torch.profiler`` over one
   more prefill + decode step gives the device busy share, the launches,
   the ops that take the device time, and shows no int64 threefry chain;
   PyTorch's sync debug mode shows that a decode step makes no
   host-device synchronisation;
5. a short three-pass generation (``use_fused_kernel=False``) that must
   launch ``systolic_matmul`` on its fast path and one draw-mode bitflip
   per faulted matmul;
6. the fleet path on [4]'s params: ``FleetServeEngine`` over a
   ``FleetRuntime`` of 4 devices aged 0/3/6/9.5 years (floored at 1e-3)
   serving ``(4, 2, 16)`` prompts, 8 greedy tokens, in one lane-batched
   forward per step: exactly 7 lane-mode GEMM and 2 lane-mode draw
   launches per layer and forward (not 4x), every lane's tokens equal to
   its single-lane replay (timed: the lane loop), prefill logits within
   one bf16 ulp of the replay's, no host-device synchronisation in a
   decode step, a profiled step, timings beside [4]'s, and a reduced
   llama3_8b fleet on the card against the CPU;
6b. traffic-driven aging on [4]'s params: ``FleetRuntime.apply_load`` of
   the [6] fleet under 3 years of diurnal traffic at 55 % (144 epochs) for
   ``round_robin`` and ``wear_level``, and ``rest_to_recover`` with the
   recovery pool and thermal feedback at 480 epochs, each on the card
   against the same call on the CPU (supplies equal, no (device, op)
   moved; shifts within 1e-4, and whether they are bit-equal),
   wear_level's fleet-max ΔVth below round_robin's, the co-sim's wall
   times and its launches per epoch; ``FleetServeEngine(router="wear_level", ...)``
   serving ``(4, 2, 16)`` prompts for 8 greedy tokens at full width at the
   traffic-aged BERs (which must differ from [6]'s), with 7 + 2 lane
   launches per layer and forward, every lane equal to its replay and no
   sync in a decode step, timed in turns against the same fleet at [6]'s
   static BERs; the ``state_dict`` round trip, ``resize`` +
   ``apply_load`` bit-exact against the undisturbed run, ``health()``; and
   ``repro_torch.benchmarks.sched_bench`` / ``disruption_bench`` on the
   card at 48 epochs, one timed repetition (any FAIL fails);
7. the MoE path: qwen3_moe_235b at its published widths (head_dim 128,
   which the reference config leaves to derive as d_model // n_heads =
   64; 12 of 94 layers, bf16 random params) on ``FleetRuntime.for_model``
   aged 9 years (10 operator domains, the router's included), ``generate``
   of 8 tokens at T=0.8, top_k=50 with exact launch counts (the fused
   kernel on q/k/v/o/router, the draw-mode bitflip on qkt/sv; the expert
   FFNs are clean batched matmuls, as in the reference), no host-device
   synchronisation in a sampled decode step, the peak memory (under
   76 GB), the sampler's kernels (its Gumbel draw is int64 threefry tensor
   ops), a profiled prefill + decode step, and ``score`` of the prompts
   plus the generated tokens; then reduced qwen3_moe_235b and
   arctic_480b sampled (T=0.8, top_k=8) at BER 1e-3 on the card's kernel
   route against the port on the CPU (after [8], which shares [7]'s params);
8. the MoE fleet on [7]'s params: ``FleetServeEngine`` over
   ``FleetRuntime.for_model(n_devices=4)`` aged 0/3/6/9.5 years serving
   ``(4, 2, 16)`` prompts, 8 tokens at T=0.8, top_k=50, in one
   lane-batched forward per step (the lane-aware expert dispatch): exactly
   5 lane-mode GEMM and 2 lane-mode draw launches per layer and forward,
   as many ``aten::bmm`` calls a step as one device (the expert weights
   read once a forward for all lanes), every lane's tokens equal to its
   single-lane replay unless the expert ``bmm`` rounding probe shows
   cuBLAS rounding a row by the batch's row count, peak memory under
   76 GB, no host-device synchronisation in a decode step, the expert
   ``bmm`` chain's device time beside [7]'s, the lanes' sampler cost, and
   reduced qwen3_moe_235b / arctic_480b fleets on the card against the
   CPU;
9. the paper's tables on the card: ``repro_torch.benchmarks``'
   ``table1_aging``, ``table2_policy`` and ``fig5_curves`` with every
   PASS/FAIL check, and ``repro_torch.examples.lifetime_study``'s sweep,
   each timed;
10. training: llama3_8b at its published widths, 8 of 32 layers, float32
   params and AdamW moments, ``make_train_step(microbatches=2,
   remat=True)`` under ``TrainLoop`` for 6 steps of B=4, S=256
   ``SyntheticLM`` batches (the loss must fall, the peak stay under
   76 GB), ms a step, tokens/s and the device busy share of one profiled
   step; the trained params scored by ``ServeEngine.score`` on a fresh
   device and one aged 9 years on the fused GEMM and the draw bitflip
   (launches counted), the first layer's 7 GEMM and 2 draw launches of
   each score held bit for bit against their plain versions on the same
   inputs (the score's M = B * (S - 1) rows and its tile plan); reduced llama3_8b trained 3 steps on the card
   against the CPU (the CPU parity tests' tolerances) and once more on the
   card (determinism); an async checkpoint and its restore bit for bit and
   a run interrupted at step 3 and resumed equal to the uninterrupted one;
   and ``repro_torch.benchmarks.fig1b_ber`` with its checks;
10b. measured resilience on [10]'s trained params: ``empirical_resilience``
   at the reference CLI's full setting (``DEFAULT_BER_GRID`` x the 9
   operator domains = 108 fault lanes, 2 seeds, ``SyntheticLM`` B=8, S=64,
   on the fused lane kernels, 32 lanes = 16,384 rows a forward) with wall
   time, grid points/s, peak memory, the busy share of one profiled chunk
   forward and exactly 7 lane GEMM (fast path) + 2 lane draw launches a
   layer and chunk forward; losses in [0, 100] and every knee the grid
   brackets fitted inside it; layer 0's 9 launches of one chunk forward
   replayed through the plain versions bit for bit (upsets present), each
   GEMM shape timed beside its bound and ``torch._int_mm``; one BER row as
   part of a 32-lane chunk, a 9-lane chunk and 9 single forwards (equal
   predictions but for near ties within one float32 ulp); reduced
   llama3_8b over ``QUICK_BER_GRID`` (45 lanes in one forward: two launches
   a faulted op) on the fused and the three-pass route against the CPU; the
   fit written to ``chiprun_out/resilience_measured.json``, the measured
   policy's Table II saving and a 4-lane fleet served under it (every lane
   == its replay); ``cosim_taps`` of [6b]'s wear_level co-sim card == CPU,
   a tapped fleet call and the registry exported (JSONL, Prometheus) and
   parsed back equal; ``python -m repro_torch.examples.aging_aware_serving``
   on the card; ``calibrate_aging`` and ``verify_table1`` on the card
   against the checked-in calibration (Table I within 1 %) and the
   checked-in path model's polynomial refitted (within 1e-6 relative of
   the checked-in one: the host's least squares);
12. the hybrid, SSM, VLM and enc-dec families, each at its full published
   config with bf16 random params (prefix / frame embeddings from numpy):
   recurrentgemma_2b, rwkv6_3b, paligemma_3b (256 prefix embeddings) and
   whisper_large_v3 (``(2, 1500, 1280)`` frames) served B=2, prompt 16, 8
   greedy tokens on a ``FleetRuntime.for_model`` device aged 9 years on the
   fused route, with the fused-GEMM and draw launches equal to the counts
   read from the models' code (``FAMILY_LAUNCHES``), every GEMM on the fast
   path, peak memory under 20 GB, no host-device synchronisation in a
   decode step, a profiled prefill + decode step and ``score``;
   recurrentgemma also at B=1 with a 2,064-token prompt (past its 2,048
   window: the mask, the prefill roll and the decode ring wrap) and rwkv
   with a 300-token prompt (three WKV chunks); a 4-lane
   ``FleetServeEngine`` each (ages 0/3/6/9.5 y, one device's launches,
   every lane == its single-lane replay); the reduced models (single
   device and 3 lanes) and, for paligemma and whisper, a reduced-grid
   ``run_sweep`` with extras on the card against the CPU; and the GEMM
   and draw at the shapes these models add, bit-exact against their plain
   versions, beside their bounds and ``torch._int_mm`` on a column-major
   ``b``;
11. a ``{"kernels": [...]}`` line (launches summed over the runs of [4],
   [5], [6], [6b], [7], [8], [10], [10b] and [12]), the ``nvidia-smi``
   line, and as the last line ``{"ok": true, "device": {...}}``.

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
INT32_LANES_PER_SM = 64        # Hopper: INT32 instructions per SM per clock
THREEFRY_INT_OPS = 73          # one threefry-2x32 hash: 2 + 20 * 3 + 5 * 2 + 1
MOE_PEAK_LIMIT = 76e9         # bytes: the MoE phase must leave 4 GB of the card
# qwen3_moe_235b's depth in [6]: one layer is ~5 GB of bf16 weights (its
# 128 experts ~4.83 GB), so 12 of 94 layers plus embed/lm_head (~62 GB)
# is the most that leaves the card headroom under MOE_PEAK_LIMIT
MOE_LAYERS = 12
# the fleet of [6]: the serving example's ages (years), floored at 1e-3
FLEET_AGES = (1e-3, 3.0, 6.0, 9.5)
# per-lane BERs of the lane-mode checks in [3]: one lane at 0
LANE_BERS = (1e-3, 0.0, 3e-3, 1e-2)
TABLE2 = {                     # paper Table II: op -> (V_final, dvp, dvn, saving %)
    "q": (0.90, 73.1, 46.1, 17.0), "k": (0.94, 79.0, 52.1, 14.3),
    "v": (0.90, 73.1, 46.1, 17.0), "qkt": (0.90, 73.1, 46.1, 17.0),
    "sv": (0.90, 73.1, 46.1, 17.0), "o": (1.01, 99.7, 77.8, 3.1),
    "gate": (0.90, 73.1, 46.1, 17.0), "up": (0.90, 73.1, 46.1, 17.0),
    "down": (0.99, 90.8, 66.7, 7.8),
}
JAX_KERNELS = {
    "fused_aged_matmul": "src/repro/kernels/fused_aged_matmul.py:208",
    "fused_aged_matmul_lanes": "src/repro/kernels/fused_aged_matmul.py:208",
    "bitflip_words": "src/repro/kernels/bitflip.py:49",
    "bitflip_draw": "src/repro/kernels/bitflip.py:49",
    "bitflip_draw_lanes": "src/repro/kernels/bitflip.py:49",
    "systolic_matmul": "src/repro/kernels/systolic_matmul.py:64",
}
SOURCE = "src/repro_torch/kernels/csrc/aged_kernels.cu"


class PhaseError(RuntimeError):
    pass


# objects a later phase reads from an earlier one (not in the report)
KEPT = {}


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
    given) over ``iters`` calls.  Returns ``(ms, kernels per call)``.

    The profiler now and then drops kernel records, some or all of a
    trace's; a trace with no kernel, or with a count that is not a whole
    number per call, has, and is taken again (up to five times, the last
    kept as it is)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and (match is None or match in e.key)]
        n = sum(e.count for e in evs)
        if n > 0 and n % iters == 0:
            break
    return sum(_dev_us(e) for e in evs) / 1e3 / iters, n / iters


def int32_issue_per_s(dev) -> float:
    """INT32 instructions per second of the whole card: SMs x 64 lanes x
    the SM clock (device properties; nvidia-smi's maximum SM clock where
    this torch does not report it)."""
    import torch
    props = torch.cuda.get_device_properties(dev)
    khz = getattr(props, "clock_rate", 0)
    if not khz:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits", "-i",
                              str(dev.index or 0)], capture_output=True,
                             text=True, timeout=60)
        khz = float(smi.stdout.split()[0]) * 1e3
    return props.multi_processor_count * INT32_LANES_PER_SM * khz * 1e3


def bound(bytes_moved: float, tc_ops: float = 0.0, int_ops: float = 0.0,
          int_rate: float = 1.0) -> tuple:
    """Least time (ms) for the work and what binds it: the bytes over the
    memory rate, int8 tensor-core operations over their peak, or INT32
    ALU instructions (``int_ops``) over ``int_rate`` per second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(tc_ops / INT8_OPS_PER_S, int_ops / int_rate) * 1e3
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
                                     "bitflip_draw_kernel", "bitflip_kernel")
                         if k in mangled), mangled)
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
def llama_gemm_shapes(cfg) -> list:
    """``(model, K, N, op)`` of llama3_8b's faulted weight matmuls: q/o,
    k/v, gate/up and down."""
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    return [("llama3_8b", d, cfg.n_heads * cfg.hd, "q/o"),
            ("llama3_8b", d, kvd, "k/v"), ("llama3_8b", d, f, "gate/up"),
            ("llama3_8b", f, d, "down")]


def gemm_shapes(cfg, moe_cfg) -> list:
    """``(model, K, N, op)`` of every faulted weight matmul of the two serve
    paths: llama3_8b's q/o, k/v, gate/up and down; qwen3_moe_235b's q,
    k/v, o and router (its expert FFNs are clean)."""
    md, mq = moe_cfg.d_model, moe_cfg.n_heads * moe_cfg.hd
    return (llama_gemm_shapes(cfg) if cfg is not None else []) + [
            ("qwen3_moe_235b", md, mq, "q"),
            ("qwen3_moe_235b", md, moe_cfg.n_kv_heads * moe_cfg.hd, "k/v"),
            ("qwen3_moe_235b", mq, md, "o"),
            ("qwen3_moe_235b", md, moe_cfg.moe.n_experts, "router")]


def attention_shapes(cfg, B: int = 2, S: int = 16, max_len: int = 64):
    """The int32 score / output shapes the qkt and sv injections see:
    ``(B, KV, G, Sq, Sk)`` and ``(B, KV, G, Sq, hd)`` at prefill (Sq = Sk
    = S) and decode (Sq = 1 against the ``max_len`` cache)."""
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    return [((B, KV, G, S, S), "qkt prefill"), ((B, KV, G, S, hd),
                                                  "sv prefill"),
            ((B, KV, G, 1, max_len), "qkt decode"),
            ((B, KV, G, 1, hd), "sv decode")]


def kernel_checks(dev, cfg, moe_cfg) -> dict:
    """Each kernel vs its plain version at the main paths' shapes."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch import random as prandom
    from repro_torch.kernels.bitflip import bitflip_draw, bitflip_words
    from repro_torch.kernels.fused_aged_matmul import (fused_aged_matmul,
                                                       upset_probability)
    from repro_torch.kernels.systolic_matmul import systolic_matmul

    gen = torch.Generator(device=dev).manual_seed(1234)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ber, q = 1e-3, upset_probability(1e-3)
    rows = {"fused_aged_matmul": [], "systolic_matmul": [],
            "bitflip_words": [], "bitflip_draw": []}
    for M in (32, 2):
        for model, K, N, what in gemm_shapes(cfg, moe_cfg):
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
            shape = {"M": M, "K": K, "N": N, "op": what, "model": model,
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
                              "fused_aged_matmul_lanes": {"fast": 0,
                                                          "generic": 0},
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
    # the draw mode at the qkt/sv words of prefill and decode, against its
    # plain version and the flow it replaced: pad to (rows_pad, 128), draw
    # u and pos with threefry int64 tensor ops, explicit-randoms pass, slice
    int_rate = int32_issue_per_s(dev)

    def old_flow(x, key):
        n = x.numel()
        rows_pad = -(-n // (128 * 256)) * 256
        xf = torch.nn.functional.pad(x.reshape(-1), (0, rows_pad * 128 - n))
        u, pos = ops.make_flip_randoms(key, (rows_pad, 128), x.device)
        out = bitflip_words(xf.reshape(rows_pad, 128), u, pos, q)
        return out.reshape(-1)[:n].reshape(x.shape)

    for model, (shape, what) in itertools.chain(
            (("llama3_8b", a) for a in attention_shapes(cfg)),
            (("qwen3_moe_235b", a) for a in attention_shapes(moe_cfg))):
        n = math.prod(shape)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                          device=dev, generator=gen)
        key = prandom.PRNGKey(n)
        words = ops.flip_key_words(key)
        kernels.reset_launch_counts()
        out = bitflip_draw(x, words, q)
        exp = ref.bitflip_draw_ref(x, words, q)
        served = ops.inject_bitflips(x, ber, key)
        old = old_flow(x, key)
        torch.cuda.synchronize()
        err = max_abs_err(out, exp)
        check(err == 0.0 and torch.equal(out, exp) and torch.equal(served, out)
              and torch.equal(old, out),
              f"bitflip_draw {shape}: max |err| {err} (served == kernel "
              f"{torch.equal(served, out)}, old flow == kernel "
              f"{torch.equal(old, out)})")
        flips = int((out != x).sum())
        check(flips > 0, f"bitflip_draw {shape}: no flips")
        check(kernels.launch_counts()["bitflip_draw"] == 2,
              f"bitflip_draw launches {kernels.launch_counts()}")
        bk = lambda: bitflip_draw(x, words, q)
        dev_ms, per_call = device_ms(bk, match="bitflip_draw")
        check(per_call == 1, f"bitflip_draw kernels per call {per_call}")
        # bytes: each word read and written once; instructions: the uniform's
        # hash for every word, the position's for every flipped word
        int_ops = THREEFRY_INT_OPS * (n + flips)
        t_b, by = bound(8 * n, int_ops=int_ops, int_rate=int_rate)
        old_dev, old_kernels = device_ms(lambda: old_flow(x, key), iters=5)
        rows["bitflip_draw"].append(dict(
            n=n, shape=list(shape), op=what, model=model, flips=flips,
            max_abs_err=err,
            ms=cuda_time_ms(bk), dev_ms=dev_ms,
            inject_ms=cuda_time_ms(lambda: ops.inject_bitflips(x, ber, key)),
            plain_ms=cuda_time_ms(lambda: ref.bitflip_draw_ref(x, words, q),
                                  iters=5, warmup=1),
            old_flow_ms=cuda_time_ms(lambda: old_flow(x, key), iters=5,
                                     warmup=1),
            old_flow_dev_ms=old_dev, old_flow_kernels=old_kernels,
            bound_ms=t_b, bound_by=by,
            bytes_bound_ms=8 * n / HBM_BYTES_PER_S * 1e3,
            int_bound_ms=int_ops / int_rate * 1e3, int32_issue_per_s=int_rate,
            library_ms=None))
    return rows


def moe_gemm_shapes(moe_cfg) -> list:
    """``(model, K, N, op)`` of qwen3_moe_235b's faulted weight matmuls: q,
    k/v, o and the router."""
    return [row for row in gemm_shapes(None, moe_cfg)
            if row[0] == "qwen3_moe_235b"]


def lane_kernel_checks(dev, cfg, moe_cfg) -> dict:
    """Both lane modes at the two fleets' shapes: every llama3_8b and
    qwen3_moe_235b weight GEMM with 4 lanes of B = 2 folded (M = 4 x 32
    prefill, 4 x 2 decode rows) and the qkt/sv words of 4 lanes, at
    per-lane BERs with one lane at 0; bit-exact against the plain lane
    version and against 4 single-lane launches, timed beside the bound and
    the 4 single-lane launches."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitflip import bitflip_draw, bitflip_draw_lanes
    from repro_torch.kernels.fused_aged_matmul import (
        fused_aged_matmul, fused_aged_matmul_lanes, upset_probability)

    L = len(LANE_BERS)
    int_rate = int32_issue_per_s(dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = {"fused_aged_matmul_lanes": [], "bitflip_draw_lanes": []}
    for Ml in (32, 2):
        for model, K, N, what in (llama_gemm_shapes(cfg)
                                  + moe_gemm_shapes(moe_cfg)):
            M = L * Ml
            a = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                              device=dev, generator=gen)
            b = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              device=dev, generator=gen)
            xs = torch.rand((M, 1), device=dev, generator=gen) * 0.01 + 1e-3
            ws = torch.rand((1, N), device=dev, generator=gen) * 0.01 + 1e-3
            seeds = [int(v) for v in torch.randint(
                -2 ** 31, 2 ** 31 - 1, (L,), generator=gen, device=dev)]
            bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
            bs = itertools.cycle([b] + [b.clone() for _ in range(
                -(-120_000_000 // b.numel()) - 1)])
            nb = lambda: next(bs)
            part = lambda t, l: t[l * Ml:(l + 1) * Ml]
            lanes = lambda b_, xs_, ws_: fused_aged_matmul_lanes(
                a, b_, xs_, ws_, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn)
            singles = lambda b_, xs_, ws_: [fused_aged_matmul(
                part(a, l), b_, None if xs_ is None else part(xs_, l), ws_,
                LANE_BERS[l], seeds[l], bm=bm, bn=bn) for l in range(L)]
            kernels.reset_launch_counts()
            got = {"float32": lanes(b, xs, ws), "int32": lanes(b, None, None)}
            counts = kernels.launch_counts_by_path()["fused_aged_matmul_lanes"]
            err = 0.0
            for kind, (xs_, ws_) in (("float32", (xs, ws)),
                                     ("int32", (None, None))):
                plain = ref.fused_aged_matmul_lanes_ref(
                    a, b, xs_, ws_, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn)
                one = torch.cat(singles(b, xs_, ws_))
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got[kind], plain))
                check(torch.equal(got[kind], plain)
                      and torch.equal(got[kind], one),
                      f"fused_aged_matmul_lanes M={Ml}x{L} K={K} N={N} "
                      f"{kind}: max |err| {max_abs_err(got[kind], plain)}, "
                      f"== single-lane launches "
                      f"{torch.equal(got[kind], one)}")
            check(counts == {"fast": 2, "generic": 0},
                  f"lane GEMM launches off the fast path: {counts}")
            clean = ref.systolic_matmul_ref(a, b)
            check(torch.equal(part(got["int32"], 1), part(clean, 1)),
                  "the BER-0 lane was upset")
            flips = int((got["int32"] != clean).sum())
            check(flips > 0 or M * N < 1e4, f"no lane upsets at M={M} N={N}")
            fk = lambda: lanes(nb(), xs, ws)
            f4 = lambda: singles(nb(), xs, ws)
            dev_ms, per_call = device_ms(fk, match="int8_gemm")
            check(per_call == 1, f"lane GEMM kernels per call {per_call}")
            t_b, by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                            2.0 * M * K * N)
            rows["fused_aged_matmul_lanes"].append(dict(
                M=M, lanes=L, M_lane=Ml, K=K, N=N, op=what, model=model,
                bers=list(LANE_BERS), flips=flips, max_abs_err=err,
                ms=cuda_time_ms(fk), dev_ms=dev_ms,
                singles_dev_ms=device_ms(f4, match="int8_gemm")[0],
                plain_ms=cuda_time_ms(lambda: ref.fused_aged_matmul_lanes_ref(
                    a, b, xs, ws, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn),
                    iters=3, warmup=1),
                bound_ms=t_b, bound_by=by, library_ms=None))
    qs = [upset_probability(x) for x in LANE_BERS]
    for model, (shape, what) in itertools.chain(
            (("llama3_8b", a) for a in attention_shapes(cfg)),
            (("qwen3_moe_235b", a) for a in attention_shapes(moe_cfg))):
        n = math.prod(shape)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (L,) + shape,
                          dtype=torch.int32, device=dev, generator=gen)
        words = [ops.flip_key_words(k)
                 for k in prandom.split(prandom.PRNGKey(n), L)]
        kernels.reset_launch_counts()
        out = bitflip_draw_lanes(x, words, qs)
        launches = kernels.launch_counts()["bitflip_draw_lanes"]
        plain = ref.bitflip_draw_lanes_ref(x, words, qs)
        one = torch.stack([bitflip_draw(x[l], words[l], qs[l])
                           for l in range(L)])
        torch.cuda.synchronize()
        err = max_abs_err(out, plain)
        check(torch.equal(out, plain) and torch.equal(out, one),
              f"bitflip_draw_lanes {shape} x {L}: max |err| {err}, == "
              f"single-lane launches {torch.equal(out, one)}")
        check(launches == 1, f"bitflip_draw_lanes launches {launches}")
        check(torch.equal(out[1], x[1]), "the BER-0 lane was flipped")
        flips = int((out != x).sum())
        check(flips > 0, f"bitflip_draw_lanes {shape}: no flips")
        bk = lambda: bitflip_draw_lanes(x, words, qs)
        dev_ms, per_call = device_ms(bk, match="bitflip_draw")
        check(per_call == 1, f"bitflip_draw_lanes kernels per call "
              f"{per_call}")
        int_ops = THREEFRY_INT_OPS * (L * n + flips)
        t_b, by = bound(8 * L * n, int_ops=int_ops, int_rate=int_rate)
        rows["bitflip_draw_lanes"].append(dict(
            n=L * n, lanes=L, n_lane=n, shape=list(shape), op=what,
            model=model, flips=flips, max_abs_err=err,
            ms=cuda_time_ms(bk), dev_ms=dev_ms,
            singles_dev_ms=device_ms(lambda: [bitflip_draw(
                x[l], words[l], qs[l]) for l in range(L)],
                match="bitflip_draw")[0],
            plain_ms=cuda_time_ms(lambda: ref.bitflip_draw_lanes_ref(
                x, words, qs), iters=3, warmup=1),
            bound_ms=t_b, bound_by=by, library_ms=None))
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


def profile_generate(engine, prompts, want_gemm: int, **gen_kw) -> dict:
    """``torch.profiler`` over prefill + one decode step (``generate`` of 2
    tokens with ``gen_kw``).

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
    engine.generate(prompts, 2, **gen_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(prompts, 2, **gen_kw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        gemm = [e for e in kernels if "int8_gemm" in e.key]
        if sum(e.count for e in gemm) == want_gemm:
            break
    bmm_calls = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::bmm")
    busy = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    ours = {e.key: {"device_ms_per_launch": _dev_us(e) / 1e3 / e.count,
                    "launches": e.count}
            for e in kernels if "int8_gemm" in e.key or "bitflip" in e.key}
    # what is left of the threefry chains: int64 bitwise/shift elementwise
    # kernels (the in-kernel draws leave none on the serve path)
    chain = [e for e in kernels
             if re.search(r"(?i)bitwise|shift", e.key)
             and re.search(r"long|int64", e.key)]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "n_kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:120], "device_ms": _dev_us(e) / 1e3,
                     "calls": e.count} for e in top],
            "port_kernels": ours,
            "threefry_chain_launches": sum(e.count for e in chain),
            "threefry_chain_kernels": [e.key[:160] for e in chain],
            "gemm_launches": sum(e.count for e in gemm),
            "gemm_device_ms": sum(_dev_us(e) for e in gemm) / 1e3,
            "bmm_calls": bmm_calls, "attempts": attempt,
            "complete": sum(e.count for e in gemm) == want_gemm}


def reduced_vs_cpu(small, dev, **gen_kw) -> dict:
    """Tokens of the reduced model ``small`` on the card's kernel route
    against the port on the CPU (plain versions), at BER 1e-3 on every
    operator domain; fails unless they are equal."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_map
    p_cpu = init_params(small, seed=1, dtype=torch.float32, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    prompts = SyntheticLM(vocab=small.vocab, seq_len=12,
                          global_batch=2).batch_at(0).tokens
    outs = {}
    for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        outs[name] = ServeEngine(small, p, runtime=_Forced(1e-3),
                                 max_len=32, use_systolic_kernel=True,
                                 seed=5, device=d).generate(prompts, 6,
                                                            **gen_kw)
    got, want = outs["cuda"].tokens.tolist(), outs["cpu"].tokens.tolist()
    check(np.array_equal(outs["cuda"].tokens, outs["cpu"].tokens),
          f"reduced {small.name} {gen_kw}: card tokens {got} != CPU tokens "
          f"{want}")
    return {"cuda": got, "cpu": want}


def host_syncs(fn) -> int:
    """Host-device synchronisations made by ``fn()``, as counted by
    PyTorch's sync debug mode (one warning per synchronising call)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def decode_syncs(engine, prompts, **gen_kw) -> dict:
    """Host syncs of ``generate`` at 2 and 8 tokens; fails unless they are
    equal, i.e. unless a decode step makes none (``generate`` synchronises
    only at its phase ends)."""
    n = {k: host_syncs(lambda: engine.generate(prompts, k, **gen_kw))
         for k in (2, 8)}
    check(n[2] == n[8], f"decode steps synchronise with the host: host "
          f"syncs of generate at 2 / 8 tokens {n[2]} / {n[8]}")
    return {"generate_2_tokens": n[2], "generate_8_tokens": n[8]}


class _ForcedFleet:
    """A fleet whose lanes admit one BER each on every operator domain."""

    def __init__(self, bers, operators=tuple(TABLE2)):
        self.operators = tuple(operators)
        self.n_devices = len(bers)
        self._bers = bers
        self.ages_years = [9.0] * len(bers)

    def op_ber_array(self):
        import numpy as np
        return np.repeat(np.asarray(self._bers, np.float32)[:, None],
                         len(self.operators), axis=1)

    def fleet_power(self):
        import numpy as np
        return np.zeros(self.n_devices)


def reduced_fleet_vs_cpu(small, dev, **gen_kw) -> dict:
    """Tokens of a 3-lane reduced-model fleet (BERs 1e-3 / 0 / 3e-3 on
    every domain, an MoE router's included) on the card's kernel route
    against the port on the CPU (plain versions), generated with
    ``gen_kw``; fails unless they are equal."""
    from repro_torch.core.resilience import operators_for
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import FleetServeEngine
    from repro_torch.tree import tree_map
    p_cpu = init_params(small, seed=1, dtype=torch.float32, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    prompts = SyntheticLM(vocab=small.vocab, seq_len=12,
                          global_batch=6).batch_at(0).tokens
    fleet = _ForcedFleet([1e-3, 0.0, 3e-3], operators_for(small.family))
    outs = {name: FleetServeEngine(small, p, fleet, max_len=32,
                                   use_systolic_kernel=True, seed=5,
                                   device=d).generate(prompts, 6,
                                                      **gen_kw).tokens
            for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, "cpu"))}
    check(np.array_equal(outs["cuda"], outs["cpu"]),
          f"reduced {small.name} fleet: card tokens {outs['cuda'].tolist()} "
          f"!= CPU tokens {outs['cpu'].tolist()}")
    return {k: v.tolist() for k, v in outs.items()}


def row_mean_rounding(dev, d: int) -> dict:
    """Rows of a float32 mean of squares (the RMS norm's statistic) that
    round differently when the same rows are reduced 2, 8 or 32 at a time
    than 128 at a time, for a plain float32 reduction and for the norms'
    float64-accumulated one (``models/layers.py::_row_mean``, which must
    give none: the fleet's folded rows rely on it)."""
    import torch
    from repro_torch.models.layers import _row_mean
    x = torch.randn((128, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11))
    sq = x.square()
    count = {}
    for name, fn in (("float32", lambda t: t.mean(dim=-1, keepdim=True)),
                     ("float64", _row_mean)):
        full = fn(sq)
        count[name] = sum(int((fn(sq[:k]) != full[:k]).sum())
                          for k in (2, 8, 32))
    check(count["float64"] == 0, f"float64-accumulated row means depend on "
          f"the row count: {count['float64']} rows differ")
    return {"rows_compared": 2 + 8 + 32,
            "float32_rows_differing": count["float32"],
            "float64_rows_differing": count["float64"]}


def lane_replay(engine, params, cfg, prompts, dev, tokens, n_steps,
                want_fused, **gen_kw) -> dict:
    """Each lane of ``engine``'s first ``generate`` (tokens ``(N, B,
    n_steps)`` of ``(N, B, S)`` prompts) replayed alone: the engine's key
    schedule, sliced (``FaultConfig.lane(i)``, the lane's sampling key),
    through the single-device path, timed as the lane loop (which must
    make ``N * want_fused`` fused launches); and the prefill logits of the
    folded forward against the lanes' own."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.serve import steps
    N, B, S = prompts.shape
    _, call_key = prandom.split(prandom.PRNGKey(0))
    fi = engine._fleet_fault_config(call_key)
    keys = prandom.split(prandom.fold_in(call_key, 1), N)
    lane_prompts = [torch.as_tensor(prompts[i], device=dev) for i in range(N)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay = [steps.generate(params, cfg, lane_prompts[i], fi.lane(i),
                             keys[i], max_len=64, n_steps=n_steps,
                             **gen_kw)[0] for i in range(N)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = kernels.launch_counts()
    check(loop_counts["fused_aged_matmul"] == N * want_fused,
          f"replay launches {loop_counts}")
    # prefill logits, fleet against replay: every faulted op is exact per
    # lane; the clean bf16 unembed matmul (transformer.unembed) may round
    # differently at 4 x 2 rows than at 2, by at most one bf16 ulp of the
    # logit (2**-7 relative to its magnitude)
    folded = torch.as_tensor(prompts.reshape(N * B, S), device=dev)
    lf = steps.prefill(params, cfg, folded, fi.with_seeds(), 64)[0]
    lr = torch.cat([steps.prefill(params, cfg, lane_prompts[i],
                                  fi.lane(i).with_seeds(), 64)[0]
                    for i in range(N)])
    d = (lf - lr).abs()
    diverged = [(i, b, t) for i in range(N) for b in range(B)
                for t in range(n_steps) if tokens[i, b, t] != replay[i][b, t]]
    return {"fi": fi, "replay": replay, "loop_s": loop_s,
            "loop_counts": loop_counts,
            "logit_diff": float(d.max()),
            "within": bool((d <= 2.0 ** -7
                            * torch.maximum(lf.abs(), lr.abs())).all()),
            "diverged": diverged,
            "first": diverged[0] if diverged else None}


def fleet_phase(dev, cfg, params, single) -> dict:
    """[6] ``FleetServeEngine`` over a 4-device fleet aged ``FLEET_AGES``,
    at [4]'s full width and depth on [4]'s params: one lane-batched
    forward per step, held against each lane's single-lane replay; then a
    reduced llama3_8b fleet on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.obs.taps import enable_taps
    from repro_torch import kernels
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import FleetServeEngine

    N, B, S, n_steps = len(FLEET_AGES), 2, 16, 8
    L = cfg.n_layers
    fleet = FleetRuntime(n_devices=N, device=dev)
    for i, age in enumerate(FLEET_AGES):
        fleet.set_age(years=age, device=i)
    bers = fleet.op_ber_array()
    check(bool(np.isfinite(bers).all() and (bers >= 0).all()
               and (bers[1:] > 0).all()), f"fleet BERs {bers}")
    print(f"[6] fleet of {N} llama3_8b devices aged "
          f"{', '.join(f'{a:g}' for a in FLEET_AGES)} y: admitted BER "
          f"(q / o / down per lane) " + "; ".join(
              f"{bers[i, 0]:.2e} / {bers[i, 5]:.2e} / {bers[i, 8]:.2e}"
              for i in range(N)), flush=True)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=N * B).batch_at(0).tokens.reshape(
                              N, B, S)
    make = lambda: FleetServeEngine(cfg, params, fleet, max_len=64,
                                    use_systolic_kernel=True, device=dev)
    make().generate(prompts, 2)                 # warm-up of the fleet shapes
    engine = make()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with enable_taps():             # the checks below read the taps
        out = engine.generate(prompts, n_steps)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    tok = out.tokens
    check(tok.shape == (N, B, n_steps), f"fleet tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "fleet token ids")
    check(all(v.shape == (N, n_steps) and np.isfinite(v).all()
              for v in out.telemetry.values()), "fleet logit taps")
    want_fused, want_flip = 7 * L * n_steps, 2 * L * n_steps
    check(counts["fused_aged_matmul_lanes"] == want_fused
          and by_path["fused_aged_matmul_lanes"] == {"fast": want_fused,
                                                     "generic": 0},
          f"fleet lane GEMM launches {by_path} != {want_fused} fast")
    check(counts["bitflip_draw_lanes"] == want_flip,
          f"fleet lane draw launches {counts} != {want_flip}")
    check(all(counts[k] == 0 for k in ("fused_aged_matmul", "bitflip_draw",
                                       "bitflip_words", "systolic_matmul")),
          f"the fleet launched a single-lane or three-pass kernel: {counts}")

    rp = lane_replay(engine, params, cfg, prompts, dev, tok, n_steps,
                     want_fused)
    loop_s, loop_counts, first = rp["loop_s"], rp["loop_counts"], rp["first"]
    logit_diff, within, fi = rp["logit_diff"], rp["within"], rp["fi"]
    check(first is None, f"fleet lane {first and first[0]} row "
          f"{first and first[1]} diverges from its single-lane replay at "
          f"token {first and first[2]}; prefill logits differ by up to "
          f"{logit_diff:.3g} (within one bf16 ulp: {within})")
    check(within, f"fleet prefill logits differ from the replay's by "
          f"{logit_diff:.3g}, more than one bf16 ulp")
    pf, dc = out.timings["prefill_s"], out.timings["decode_s"]
    per_tok = dc / (n_steps - 1)
    res = {"lanes": N, "ages_years": list(FLEET_AGES), "layers": L,
           "batch_per_lane": B, "prompt": S, "n_steps": n_steps,
           "bers": bers.tolist(), "operators": list(fleet.operators),
           "generate_s": gen_s, "prefill_s": pf,
           "decode_s_per_token": per_tok,
           "tokens_per_s": N * B * n_steps / gen_s,
           "replay_loop_s": loop_s,
           "replay_tokens_per_s": N * B * n_steps / loop_s,
           "single": {k: single[k] for k in ("prefill_s",
                                             "decode_s_per_token",
                                             "tokens_per_s", "generate_s")},
           "launches": counts, "launches_by_path": by_path,
           "replay_launches": loop_counts, "tokens": tok.tolist(),
           "prefill_logit_max_abs_diff": logit_diff,
           "power_w": out.power_w.tolist()}
    print(f"    fleet generate ({N} lanes x B={B}, 8 greedy tokens): prefill "
          f"{pf * 1e3:.1f} ms, decode {per_tok * 1e3:.1f} ms/token, "
          f"{res['tokens_per_s']:.2f} tokens/s; single device [4]: prefill "
          f"{single['prefill_s'] * 1e3:.1f} ms, decode "
          f"{single['decode_s_per_token'] * 1e3:.1f} ms/token, "
          f"{single['tokens_per_s']:.2f} tokens/s; replay loop of {N} "
          f"single-lane generates {loop_s:.2f} s ({gen_s:.2f} s fleet)",
          flush=True)
    print(f"    launches per forward: {counts['fused_aged_matmul_lanes'] // n_steps}"
          f" lane GEMM (fast path), {counts['bitflip_draw_lanes'] // n_steps}"
          f" lane draw; every lane == its single-lane replay; prefill "
          f"logits within {logit_diff:.3g}", flush=True)
    res["profile"] = profile_generate(engine, prompts, 7 * L * 2)
    prof = res["profile"]
    check(prof["threefry_chain_launches"] == 0,
          f"threefry elementwise kernels in the fleet step: "
          f"{prof['threefry_chain_kernels']}")
    print(f"    prefill + 1 decode step: {prof['wall_ms']:.1f} ms, device "
          f"busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f}%) over "
          f"{prof['n_kernel_launches']} kernel launches; lane GEMM "
          f"{prof['gemm_device_ms']:.2f} ms over {prof['gemm_launches']}",
          flush=True)
    res["host_syncs"] = decode_syncs(engine, prompts)
    print(f"    host syncs of fleet generate at 2 / 8 tokens: "
          f"{res['host_syncs']['generate_2_tokens']} / "
          f"{res['host_syncs']['generate_8_tokens']} (none in a decode "
          f"step)", flush=True)
    # host cost of the lanes' key and seed derivation in one forward: the
    # folds FaultConfig makes for every faulted op of every layer
    t0 = time.perf_counter()
    fs = fi.with_seeds().for_step(1)
    for salt in range(L):
        for op in ("q", "k", "v", "o", "gate", "up", "down"):
            fs.seed_for(op, salt)
        for op in ("qkt", "sv"):
            [ops.flip_key_words(k) for k in fs.key_for(op, salt)]
    res["lane_key_derivation_ms_per_forward"] = \
        (time.perf_counter() - t0) * 1e3
    res["row_means"] = row_mean_rounding(dev, cfg.d_model)
    print(f"    row means of d_model = {cfg.d_model}: float32 reductions "
          f"round {res['row_means']['float32_rows_differing']} of "
          f"{res['row_means']['rows_compared']} rows differently beside "
          f"other row counts; the norms' float64-accumulated means "
          f"{res['row_means']['float64_rows_differing']}", flush=True)
    res["reduced_vs_cpu"] = reduced_fleet_vs_cpu(cfg.reduced(), dev)
    print(f"    lane seed/key derivation {res['lane_key_derivation_ms_per_forward']:.1f}"
          f" ms of host time a forward; reduced llama3_8b fleet (3 lanes, "
          f"BER 1e-3 / 0 / 3e-3): card kernel route == CPU plain route "
          f"tokens", flush=True)
    return res


YEAR_S = 365.25 * 24 * 3600.0
# [6b]'s traffic: the reference serving example's settings (3 years of
# diurnal traffic at 55 % utilization over 144 epochs)
LOAD_KW = {"workload": "diurnal", "utilization": 0.55, "n_epochs": 144,
           "horizon_s": 3 * YEAR_S}
SHIFT_RTOL = 1e-4              # card against CPU, co-sim shifts
# the scheduler benchmarks' horizon in [6b]: half their 96-epoch default,
# one timed repetition (their checks are per epoch; the smoke's time went
# to [10b])
BENCH_EPOCHS = 48


def _aged_fleet(dev):
    from repro_torch.core.fleet import FleetRuntime
    fleet = FleetRuntime(n_devices=len(FLEET_AGES), device=dev)
    for i, age in enumerate(FLEET_AGES):
        fleet.set_age(years=age, device=i)
    return fleet


def cosim_card_vs_cpu(dev, router, **kw) -> dict:
    """``apply_load`` of a fleet aged ``FLEET_AGES`` on the card and the
    same call on the CPU: the supplies equal (no (device, op) moved: the
    transcendentals, the multiply-adds and the polynomial's sum run as
    explicit elementwise steps on both) and the shifts within
    ``SHIFT_RTOL``; ``exact`` says whether every shift is bit-equal."""
    import numpy as np
    import torch
    runs = {}
    for where in (dev, "cpu"):
        fleet = _aged_fleet(where)
        fleet.trap_state()                # the static lifetime, not timed
        if where != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        cos = fleet.apply_load(router=router, **kw)
        runs["cpu" if where == "cpu" else "cuda"] = (
            cos, time.perf_counter() - t0)
    (g, g_s), (c, c_s) = runs["cuda"], runs["cpu"]
    diff = np.nonzero(g.V != c.V)
    moved = sorted({(int(d), int(o)) for d, o in zip(diff[1], diff[2])})
    step = float(np.max(np.abs(g.V - c.V))) if diff[0].size else 0.0
    check(not moved,
          f"{router} co-sim: supplies differ card vs CPU at (device, op) "
          f"{moved}, by up to {step:.4f} V (first at epoch "
          f"{int(diff[0][0]) if diff[0].size else None})")
    rel = {}
    # the shifts: the monotone state and the effective totals (dv - rec);
    # the relaxed pool alone is a small difference of large terms
    for f in ("dv", "dvp", "dvn"):
        a, b = getattr(g, f).astype(np.float64), getattr(c, f)
        rel[f] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
        check(np.allclose(a, b, rtol=SHIFT_RTOL, atol=1e-6),
              f"{router} co-sim {f}: card vs CPU differ by {rel[f]:.3g} "
              f"relative (> {SHIFT_RTOL})")
    exact = all(np.array_equal(getattr(g, f), getattr(c, f))
                for f in ("dv", "dvp", "dvn", "util", "delay"))
    return {"cos": g, "cos_cpu": c, "card_s": g_s, "cpu_s": c_s,
            "moved": moved,
            "max_shift_rel": rel, "epochs": g.n_epochs, "exact": exact}


def cosim_launches(dev, epochs: int = 24) -> dict:
    """Kernel launches per epoch of the routed co-sim (wear_level, the
    aged fleet, ``epochs`` epochs), from ``torch.profiler``; loads and
    the starting state are made before the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sched import cosimulate, get_workload
    fleet = _aged_fleet(dev)
    st = fleet.trap_state()
    dmax = fleet.policy.thresholds(fleet.scenario, fleet.operators)
    loads = get_workload("diurnal", n_devices=fleet.n_devices,
                         utilization=0.55, n_epochs=epochs).loads(
                             0, device=dev)
    run = lambda: cosimulate(fleet.cal.aging, fleet.cal.delay_poly,
                             fleet.scenario, dmax, loads, "wear_level",
                             n_devices=fleet.n_devices,
                             epoch_s=3 * YEAR_S / 144, dv0=st["dv"],
                             v0=st["v"], device=dev)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) == DeviceType.CUDA]
    n = sum(e.count for e in ev)
    busy = sum(_dev_us(e) for e in ev) / 1e3
    return {"epochs": epochs, "launches": n, "launches_per_epoch": n / epochs,
            "device_busy_ms": busy}


def fleet_load_phase(dev, cfg, params, static) -> dict:
    """[6b] Traffic-driven fleet aging on the card: the routed co-sim
    (round_robin, wear_level; rest_to_recover with recovery and thermal
    feedback) against the port on the CPU, then ``FleetServeEngine(router=
    "wear_level")`` at [6]'s width and depth on [4]'s params serving the
    traffic-aged BERs, the aging state's round trips, and the scheduler
    benchmarks."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.benchmarks import disruption_bench, sched_bench
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.serve.engine import FleetServeEngine

    res = {"load_kw": dict(LOAD_KW)}
    cos = {}
    for router, kw in (("round_robin", LOAD_KW), ("wear_level", LOAD_KW),
                       ("rest_to_recover", dict(LOAD_KW, n_epochs=480,
                                                recovery=True,
                                                thermal=True))):
        r = cosim_card_vs_cpu(dev, router, **kw)
        cos[router] = r
        res[router] = {k: r[k] for k in ("card_s", "cpu_s", "moved",
                                         "max_shift_rel", "epochs", "exact")}
        res[router]["fleet_max_dvp_mv"] = float(
            r["cos"].device_wear()[-1].max())
        print(f"[6b] {router} co-sim, {r['epochs']} epochs x "
              f"{len(FLEET_AGES)} devices: card {r['card_s']:.2f} s, CPU "
              f"{r['cpu_s']:.2f} s; supplies == CPU except at "
              f"{len(r['moved'])} (device, op); shifts within "
              f"{max(r['max_shift_rel'].values()):.2g} relative "
              f"({'bit-equal' if r['exact'] else 'not bit-equal'}); "
              f"fleet-max dVth,p {res[router]['fleet_max_dvp_mv']:.2f} mV",
              flush=True)
    # [10b] reads the wear_level co-sim's taps on both devices
    KEPT["wear_level_cosims"] = (cos["wear_level"]["cos"],
                                 cos["wear_level"]["cos_cpu"])
    rr = res["round_robin"]["fleet_max_dvp_mv"]
    wl = res["wear_level"]["fleet_max_dvp_mv"]
    check(wl < rr, f"wear_level fleet-max dVth,p {wl:.3f} mV not below "
          f"round_robin's {rr:.3f} mV")
    res["wear_level_saving_pct"] = 100.0 * (1.0 - wl / rr)
    res["cosim_profile"] = cosim_launches(dev)
    cp = res["cosim_profile"]
    print(f"    wear_level cuts the fleet-max dVth,p by "
          f"{res['wear_level_saving_pct']:.2f} % against round_robin; the "
          f"routed co-sim makes {cp['launches_per_epoch']:.0f} kernel "
          f"launches an epoch (device busy {cp['device_busy_ms']:.1f} ms "
          f"over {cp['epochs']} epochs)", flush=True)

    # serving at the traffic-aged BERs, full width
    N, B, S, n_steps = len(FLEET_AGES), 2, 16, 8
    L = cfg.n_layers
    fleet = _aged_fleet(dev)
    t0 = time.perf_counter()
    engine = FleetServeEngine(cfg, params, fleet, max_len=64,
                              use_systolic_kernel=True, router="wear_level",
                              workload="diurnal",
                              apply_load_kw={k: v for k, v in LOAD_KW.items()
                                             if k != "workload"},
                              device=dev)
    res["apply_load_s"] = time.perf_counter() - t0
    check(getattr(fleet, "last_cosim", None) is not None
          and fleet.last_cosim.n_epochs == LOAD_KW["n_epochs"],
          "FleetServeEngine(router=) did not age the fleet")
    check(np.array_equal(fleet.last_cosim.V, cos["wear_level"]["cos"].V),
          "the engine's co-sim differs from the same call made alone")
    bers = fleet.op_ber_array()
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=N * B).batch_at(0).tokens.reshape(
                              N, B, S)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_steps)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    tok = out.tokens
    check(tok.shape == (N, B, n_steps), f"[6b] tokens shape {tok.shape}")
    want_fused, want_flip = 7 * L * n_steps, 2 * L * n_steps
    check(counts["fused_aged_matmul_lanes"] == want_fused
          and by_path["fused_aged_matmul_lanes"] == {"fast": want_fused,
                                                     "generic": 0},
          f"[6b] lane GEMM launches {by_path} != {want_fused} fast")
    check(counts["bitflip_draw_lanes"] == want_flip,
          f"[6b] lane draw launches {counts} != {want_flip}")
    check(all(counts[k] == 0 for k in ("fused_aged_matmul", "bitflip_draw",
                                       "bitflip_words", "systolic_matmul")),
          f"[6b] launched a single-lane or three-pass kernel: {counts}")
    check(np.array_equal(out.bers, bers), f"[6b] served BERs {out.bers} != "
          f"the fleet's after apply_load {bers}")
    static_bers = np.asarray(static["bers"])
    check(not np.array_equal(out.bers, static_bers),
          "[6b] traffic-aged BERs equal [6]'s static ones")
    rp = lane_replay(engine, params, cfg, prompts, dev, tok, n_steps,
                     want_fused)
    first = rp["first"]
    check(first is None, f"[6b] lane {first and first[0]} row "
          f"{first and first[1]} diverges from its single-lane replay at "
          f"token {first and first[2]}")
    check(rp["within"], f"[6b] prefill logits differ from the replay's by "
          f"{rp['logit_diff']:.3g}, more than one bf16 ulp")
    pf, dc = out.timings["prefill_s"], out.timings["decode_s"]
    per_tok = dc / (n_steps - 1)
    res["serve"] = {"lanes": N, "layers": L, "n_steps": n_steps,
                    "bers": out.bers.tolist(),
                    "static_bers": static_bers.tolist(),
                    "generate_s": gen_s, "prefill_s": pf,
                    "decode_s_per_token": per_tok,
                    "tokens_per_s": N * B * n_steps / gen_s,
                    "launches": counts, "launches_by_path": by_path,
                    "tokens": tok.tolist(),
                    "prefill_logit_max_abs_diff": rp["logit_diff"]}
    print(f"    FleetServeEngine(router=wear_level) aged the fleet in "
          f"{res['apply_load_s']:.2f} s; admitted BER q / o / down per lane"
          f", traffic-aged: " + "; ".join(
              f"{out.bers[i, 0]:.2e} / {out.bers[i, 5]:.2e} / "
              f"{out.bers[i, 8]:.2e}" for i in range(N)), flush=True)
    print(f"    [6]'s static (ages {', '.join(f'{a:g}' for a in FLEET_AGES)}"
          f" y): " + "; ".join(
              f"{static_bers[i, 0]:.2e} / {static_bers[i, 5]:.2e} / "
              f"{static_bers[i, 8]:.2e}" for i in range(N)), flush=True)
    print(f"    generate: prefill {pf * 1e3:.1f} ms, decode "
          f"{per_tok * 1e3:.1f} ms/token, {res['serve']['tokens_per_s']:.2f}"
          f" tokens/s ([6]: prefill {static['prefill_s'] * 1e3:.1f} ms, "
          f"decode {static['decode_s_per_token'] * 1e3:.1f} ms/token, "
          f"{static['tokens_per_s']:.2f} tokens/s); launches per forward "
          f"{counts['fused_aged_matmul_lanes'] // n_steps} lane GEMM, "
          f"{counts['bitflip_draw_lanes'] // n_steps} lane draw; every lane "
          f"== its single-lane replay", flush=True)
    res["host_syncs"] = decode_syncs(engine, prompts)
    print(f"    host syncs of generate at 2 / 8 tokens: "
          f"{res['host_syncs']['generate_2_tokens']} / "
          f"{res['host_syncs']['generate_8_tokens']} (none in a decode "
          f"step)", flush=True)
    # the same work at the static and at the traffic-aged BERs, in turns
    # (one generate is too short to compare across phases: the host clock
    # spreads by tens of percent between calls)
    static_engine = FleetServeEngine(cfg, params, _aged_fleet(dev),
                                     max_len=64, use_systolic_kernel=True,
                                     device=dev)
    turns = {"static": [], "traffic": []}
    for _ in range(3):
        for name, eng in (("static", static_engine), ("traffic", engine)):
            torch.cuda.synchronize()
            t = eng.generate(prompts, n_steps).timings
            turns[name].append((t["prefill_s"],
                                t["decode_s"] / (n_steps - 1)))
    med = {k: [float(np.median([x[i] for x in v])) for i in (0, 1)]
           for k, v in turns.items()}
    res["turns"] = {"runs": turns, "median_prefill_decode_s": med}
    print(f"    3 turns each, medians: static BERs prefill "
          f"{med['static'][0] * 1e3:.1f} ms, decode "
          f"{med['static'][1] * 1e3:.1f} ms/token; traffic-aged prefill "
          f"{med['traffic'][0] * 1e3:.1f} ms, decode "
          f"{med['traffic'][1] * 1e3:.1f} ms/token", flush=True)
    del engine, static_engine

    # the aging state on the card: round trip, resize, health
    sd = fleet.state_dict()
    back = FleetRuntime(n_devices=N, device=dev)
    back.load_state_dict(json.loads(json.dumps(sd)))
    a, b = fleet.trap_state(), back.trap_state()
    check(all(np.array_equal(a[k], b[k]) for k in a),
          "state_dict -> load_state_dict does not round-trip")
    E, e, keep = 64, 32, [0, 2, 3]
    U = np.random.default_rng(7).uniform(0.0, 1.0, (E, N)).astype(np.float32)
    H = 2.0 * YEAR_S
    full = FleetRuntime(n_devices=N, device=dev).apply_load(
        util_trace=U, horizon_s=H, recovery=True)
    cut = FleetRuntime(n_devices=N, device=dev)
    cut.apply_load(util_trace=U[:e], horizon_s=H * e / E, recovery=True)
    cut2 = cut.resize(keep, n_fresh=1)
    U2 = np.concatenate([U[e:][:, keep], U[e:][:, :1]], axis=1)
    after = cut2.apply_load(util_trace=U2, horizon_s=H * (E - e) / E,
                            recovery=True)
    ref = lambda x: x[e:][:, keep]
    check(all(np.array_equal(getattr(after, f)[:, :len(keep)],
                             ref(getattr(full, f)))
              for f in ("dv", "rec", "V")),
          "resize + apply_load: survivors differ from the undisturbed run")
    text = cut2.health().render()
    check("aging odometer" in text and len(text.splitlines()) >= 3 + N,
          f"health() rendered {text!r}")
    res["state"] = {"round_trip": True, "resize_bit_exact": True,
                    "health": text}
    print("    state_dict round-trips on the card; resize(keep=[0, 2, 3], "
          "n_fresh=1) + apply_load gives the survivors the undisturbed "
          "run's trajectory bit for bit; health():", flush=True)
    for ln in text.splitlines()[1:3 + len(keep) + 1]:
        print(f"      {ln}", flush=True)

    for name, mod in (("sched_bench", sched_bench),
                      ("disruption_bench", disruption_bench)):
        t0 = time.perf_counter()
        bench = mod.evaluate(device=dev, epochs=BENCH_EPOCHS, reps=1)
        secs = time.perf_counter() - t0
        res[name] = {"seconds": secs, "checks": bench["checks"],
                     "rows": bench["rows"]}
        print(f"[6b] {name} on the card in {secs:.2f} s:", flush=True)
        for ln in bench["text"].splitlines():
            if ln.startswith(("[PASS]", "[FAIL]", "one call")):
                print(f"    {ln}", flush=True)
        failed = [c["name"] for c in bench["checks"] if not c["ok"]]
        check(not failed, f"{name} checks failed: {failed}")
    res["launches"] = counts
    return res


def moe_phase(dev, cfg) -> tuple:
    """[7] The MoE serve path at published widths, ``MOE_LAYERS`` deep.
    Returns ``(results, params, the served config)``: [8] serves the same
    params as a fleet before they are freed."""
    import numpy as np
    import torch
    from repro_torch.obs.taps import enable_taps
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import steps
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import leaves

    sample = {"temperature": 0.8, "top_k": 50}
    runtime = FleetRuntime.for_model(cfg, device=dev)
    runtime.set_age(years=9.0)
    bers = runtime.op_bers()
    check(len(bers) == 10 and "router" in bers
          and all(math.isfinite(v) and v > 0 for v in bers.values()),
          f"MoE fleet's admitted BERs {bers}")
    print("[7] MoE fleet (FleetRuntime.for_model), age 9 y admitted BER: "
          + ", ".join(f"{op} {v:.2e}" for op, v in bers.items()), flush=True)

    L = MOE_LAYERS
    cfg_run = dataclasses.replace(cfg, n_layers=L)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg_run, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    param_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    print(f"    qwen3_moe_235b published widths (head_dim {cfg.hd}), {L} of "
          f"{cfg.n_layers} layers, "
          f"{n_params / 1e9:.2f} B params ({param_gb:.2f} GB, bf16 with a "
          f"float32 router) initialised in {init_s:.1f} s", flush=True)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=16,
                          global_batch=2).batch_at(0).tokens
    ServeEngine(cfg_run, params, runtime=runtime, max_len=64,
                use_systolic_kernel=True, device=dev).generate(prompts, 2,
                                                               **sample)
    engine = ServeEngine(cfg_run, params, runtime=runtime, max_len=64,
                         use_systolic_kernel=True, device=dev)
    n_steps = 8
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with enable_taps():             # the checks below read the taps
        out = engine.generate(prompts, n_steps, **sample)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    tok = out.tokens
    check(tok.shape == (2, n_steps), f"MoE tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "MoE token ids")
    check(all(np.isfinite(v).all() for v in out.telemetry.values()),
          "MoE logit taps not finite")
    want_fused = 5 * L * n_steps       # q, k, v, o, router
    want_flip = 2 * L * n_steps        # qkt, sv
    check(counts["fused_aged_matmul"] == want_fused
          and by_path["fused_aged_matmul"] == {"fast": want_fused,
                                               "generic": 0},
          f"MoE fused_aged_matmul launches {by_path} != {want_fused} fast")
    check(counts["bitflip_draw"] == want_flip,
          f"MoE bitflip_draw launches {counts} != {want_flip}")
    check(counts["systolic_matmul"] == 0 and counts["bitflip_words"] == 0,
          f"MoE path launched a three-pass kernel: {counts}")
    full = np.concatenate([prompts, tok], axis=1)
    score_s, nlls = [], []
    for _ in range(2):          # the first call meets these shapes first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nlls.append(engine.score(full))
        torch.cuda.synchronize()
        score_s.append(time.perf_counter() - t0)
    nll = nlls[0]
    check(all(math.isfinite(v) and v > 0 for v in nlls), f"MoE score {nlls}")
    peak = torch.cuda.max_memory_allocated(dev)
    check(peak < MOE_PEAK_LIMIT, f"MoE peak memory {peak / 1e9:.2f} GB")
    pf, dc = out.timings["prefill_s"], out.timings["decode_s"]
    per_tok = dc / (n_steps - 1)
    res = {"layers": L, "batch": 2, "prompt": 16, "n_steps": n_steps,
           "temperature": sample["temperature"], "top_k": sample["top_k"],
           "params_b": n_params / 1e9, "param_gb": param_gb,
           "init_s": init_s, "bers_age9": bers, "generate_s": gen_s,
           "prefill_s": pf, "decode_s_per_token": per_tok,
           "tokens_per_s": 2 * n_steps / gen_s,
           "max_memory_allocated_gb": peak / 1e9, "launches": counts,
           "launches_by_path": by_path, "tokens": tok.tolist(),
           "score_nll": nlls, "score_tokens": list(full.shape),
           "score_ms": [t * 1e3 for t in score_s]}
    print(f"    generate (T=0.8, top_k=50): prefill {pf * 1e3:.1f} ms, decode "
          f"{per_tok * 1e3:.1f} ms/token, {res['tokens_per_s']:.2f} tokens/s,"
          f" peak memory {peak / 1e9:.2f} GB; launches {counts}", flush=True)
    print(f"    score of {full.shape[0]}x{full.shape[1]} tokens: NLL "
          f"{nll:.4f} in {score_s[0] * 1e3:.1f} ms (again: {nlls[1]:.4f} in "
          f"{score_s[1] * 1e3:.1f} ms)", flush=True)

    # the sampler alone on this vocab: its Gumbel draw is int64 threefry
    # tensor ops, as the reference draws it with XLA's
    logits = torch.randn((2, cfg.vocab), device=dev, generator=torch.Generator(
        device=dev).manual_seed(7)) * 3.0
    key = prandom.PRNGKey(3)
    draw = lambda: steps.sample_token(logits, key, 0.8, 50)
    samp_dev, samp_kernels = device_ms(draw, iters=5)
    res["sampler"] = {"ms": cuda_time_ms(draw, iters=5, warmup=1),
                      "dev_ms": samp_dev, "kernels_per_token": samp_kernels}
    res["profile"] = profile_generate(engine, prompts, 5 * L * 2, **sample)
    prof = res["profile"]
    print(f"    sample_token (B=2, vocab {cfg.vocab}): {samp_kernels:.0f} "
          f"kernels, {samp_dev:.3f} ms of device time, "
          f"{res['sampler']['ms']:.3f} ms a call; prefill + 1 decode step: "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f}"
          f" ms ({100 * prof['device_busy_share']:.1f}%) over "
          f"{prof['n_kernel_launches']} kernel launches "
          f"({prof['threefry_chain_launches']} int64 threefry); top: "
          + ", ".join(f"{o['name'][:40]} {o['device_ms']:.1f} ms"
                      for o in prof["top"][:5]), flush=True)
    res["host_syncs"] = decode_syncs(engine, prompts, **sample)
    print(f"    host syncs of sampled generate at 2 / 8 tokens: "
          f"{res['host_syncs']['generate_2_tokens']} / "
          f"{res['host_syncs']['generate_8_tokens']} (none in a decode "
          f"step)", flush=True)
    res["expert_bmm"] = expert_bmm_ms(params, cfg_run, dev, lanes=1)
    print(f"    expert bmm chain (gate, up, down) of {L} layers at (E, C, d) "
          f"= ({cfg.moe.n_experts}, {res['expert_bmm']['rows']}, "
          f"{cfg.d_model}): {res['expert_bmm']['dev_ms']:.2f} ms of device "
          f"time a forward", flush=True)
    return res, params, cfg_run


def moe_reduced_vs_cpu(dev) -> dict:
    """[7]'s last check: reduced qwen3_moe_235b and arctic_480b sampled at
    BER 1e-3 on the card against the CPU."""
    from repro_torch.configs import get_config
    out = {arch: reduced_vs_cpu(get_config(arch).reduced(), dev,
                                temperature=0.8, top_k=8)
           for arch in ("qwen3_moe_235b", "arctic_480b")}
    print("    reduced qwen3_moe_235b and arctic_480b at BER 1e-3, T=0.8, "
          "top_k=8: card kernel route == CPU plain route tokens", flush=True)
    return out


def expert_bmm_ms(params, cfg, dev, lanes: int) -> dict:
    """Device time (profiler) of the clean expert FFN of every layer, the
    ``bmm`` chain ``moe_apply`` runs, at one forward's rows: ``lanes``
    lanes of ``C = _capacity(B * S)`` rows each (B = 2, prompt 16; decode's
    ``C`` is the same minimum of 8), side by side as ``(E, lanes * C,
    d)``.  Each layer's weights are read from device memory once a call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.moe import _capacity
    C = _capacity(2 * 16, cfg.moe)
    E, d = cfg.moe.n_experts, cfg.d_model
    buf = torch.randn((E, lanes * C, d), dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))

    def chain():
        for lp in params["layers"]:
            p = lp["ffn"]
            h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
            torch.bmm(h, p["w_down"])
    ms, kernels = device_ms(chain, iters=3)
    weight_bytes = sum(lp["ffn"][k].numel() * lp["ffn"][k].element_size()
                       for lp in params["layers"]
                       for k in ("w_gate", "w_up", "w_down"))
    return {"lanes": lanes, "rows": lanes * C, "dev_ms": ms,
            "kernels": kernels, "weight_gb": weight_bytes / 1e9,
            "tb_per_s": weight_bytes / (ms * 1e-3) / 1e12}


def bmm_rounding_probe(params, cfg, dev, lanes: int) -> dict:
    """Max |diff| between each lane's expert rows run alone, ``(E, C, d)``,
    and the same rows inside the fleet's ``(E, lanes * C, d)`` batch, for
    each ``bmm`` of layer 0's expert chain and for its output: non-zero
    would mean cuBLAS rounds a row differently by the batch's row count,
    and a lane could part from its single-lane replay there."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.moe import _capacity
    C = _capacity(2 * 16, cfg.moe)
    E, d = cfg.moe.n_experts, cfg.d_model
    p = params["layers"][0]["ffn"]
    g = torch.Generator(device=dev).manual_seed(6)
    bufs = [torch.randn((E, C, d), dtype=torch.bfloat16, device=dev,
                        generator=g) for _ in range(lanes)]

    def run(buf):
        gate, up = torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"])
        h = F.silu(gate) * up
        return {"gate": gate, "up": up, "down": torch.bmm(h, p["w_down"])}
    folded = run(torch.cat(bufs, dim=1))
    diff = {k: 0.0 for k in folded}
    rows = 0
    for i, buf in enumerate(bufs):
        alone = run(buf)
        for k, v in alone.items():
            part = folded[k][:, i * C:(i + 1) * C]
            diff[k] = max(diff[k], float((part.float() - v.float()).abs()
                                         .max()))
            if k == "down":
                rows += int((part != v).any(dim=-1).sum())
    return {"lanes": lanes, "rows_per_lane": C,
            "max_abs_diff": diff, "down_rows_differing": rows,
            "down_rows": lanes * E * C}


def moe_fleet_phase(dev, cfg, params, single) -> dict:
    """[8] The MoE fleet: ``FleetServeEngine`` over
    ``FleetRuntime.for_model(n_devices=4)`` aged ``FLEET_AGES`` on [7]'s
    model and params, sampled; held against each lane's single-lane
    replay, timed beside [7]'s single device; then reduced qwen3_moe_235b
    and arctic_480b fleets on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.obs.taps import enable_taps
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import steps
    from repro_torch.serve.engine import FleetServeEngine

    sample = {"temperature": 0.8, "top_k": 50}
    N, B, S, n_steps = len(FLEET_AGES), 2, 16, 8
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats(dev)
    fleet = FleetRuntime.for_model(cfg, n_devices=N, device=dev)
    for i, age in enumerate(FLEET_AGES):
        fleet.set_age(years=age, device=i)
    bers = fleet.op_ber_array()
    check(len(fleet.operators) == 10 and "router" in fleet.operators
          and bool(np.isfinite(bers).all() and (bers >= 0).all()
                   and (bers[1:] > 0).all()), f"MoE fleet BERs {bers}")
    r = fleet.op_index("router")
    print(f"[8] MoE fleet of {N} qwen3_moe_235b devices aged "
          f"{', '.join(f'{a:g}' for a in FLEET_AGES)} y "
          f"({len(fleet.operators)} domains): admitted BER (q / o / router "
          f"per lane) " + "; ".join(
              f"{bers[i, 0]:.2e} / {bers[i, 5]:.2e} / {bers[i, r]:.2e}"
              for i in range(N)), flush=True)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=N * B).batch_at(0).tokens.reshape(
                              N, B, S)
    make = lambda: FleetServeEngine(cfg, params, fleet, max_len=64,
                                    use_systolic_kernel=True, device=dev)
    make().generate(prompts, 2, **sample)       # warm-up of the fleet shapes
    engine = make()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with enable_taps():             # the checks below read the taps
        out = engine.generate(prompts, n_steps, **sample)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    tok = out.tokens
    check(tok.shape == (N, B, n_steps), f"MoE fleet tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "MoE fleet token ids")
    check(all(v.shape == (N, n_steps) and np.isfinite(v).all()
              for v in out.telemetry.values()), "MoE fleet logit taps")
    want_fused, want_flip = 5 * L * n_steps, 2 * L * n_steps
    check(counts["fused_aged_matmul_lanes"] == want_fused
          and by_path["fused_aged_matmul_lanes"] == {"fast": want_fused,
                                                     "generic": 0},
          f"MoE fleet lane GEMM launches {by_path} != {want_fused} fast")
    check(counts["bitflip_draw_lanes"] == want_flip,
          f"MoE fleet lane draw launches {counts} != {want_flip}")
    check(all(counts[k] == 0 for k in ("fused_aged_matmul", "bitflip_draw",
                                       "bitflip_words", "systolic_matmul")),
          f"the MoE fleet launched a single-lane or three-pass kernel: "
          f"{counts}")
    check(single["launches"]["fused_aged_matmul"] == want_fused
          and single["launches"]["bitflip_draw"] == want_flip,
          f"[7]'s launches {single['launches']} differ from the fleet's")

    rp = lane_replay(engine, params, cfg, prompts, dev, tok, n_steps,
                     want_fused, **sample)
    loop_s, loop_counts, first = rp["loop_s"], rp["loop_counts"], rp["first"]
    logit_diff, within, diverged = rp["logit_diff"], rp["within"], \
        rp["diverged"]
    probe = bmm_rounding_probe(params, cfg, dev, N)
    rounding = max(probe["max_abs_diff"].values())
    # a lane may part from its replay only where cuBLAS rounds the expert
    # rows by the batch's row count, which the probe then shows
    check(first is None or rounding > 0,
          f"MoE fleet lane {first and first[0]} row {first and first[1]} "
          f"diverges from its single-lane replay at token "
          f"{first and first[2]} although the expert bmm rounds alike")
    check(within or rounding > 0,
          f"MoE fleet prefill logits differ from the replay's by "
          f"{logit_diff:.3g}, more than one bf16 ulp")
    peak = torch.cuda.max_memory_allocated(dev)
    check(peak < MOE_PEAK_LIMIT, f"MoE fleet peak memory {peak / 1e9:.2f} GB")
    pf, dc = out.timings["prefill_s"], out.timings["decode_s"]
    per_tok = dc / (n_steps - 1)
    res = {"lanes": N, "ages_years": list(FLEET_AGES), "layers": L,
           "batch_per_lane": B, "prompt": S, "n_steps": n_steps,
           "temperature": sample["temperature"], "top_k": sample["top_k"],
           "bers": bers.tolist(), "operators": list(fleet.operators),
           "generate_s": gen_s, "prefill_s": pf,
           "decode_s_per_token": per_tok,
           "tokens_per_s": N * B * n_steps / gen_s,
           "replay_loop_s": loop_s,
           "replay_tokens_per_s": N * B * n_steps / loop_s,
           "single": {k: single[k] for k in ("prefill_s",
                                             "decode_s_per_token",
                                             "tokens_per_s", "generate_s")},
           "launches": counts, "launches_by_path": by_path,
           "replay_launches": loop_counts, "tokens": tok.tolist(),
           "replay_tokens": [t.tolist() for t in rp["replay"]],
           "first_divergence": first, "n_diverged": len(diverged),
           "bmm_rounding_probe": probe,
           "prefill_logit_max_abs_diff": logit_diff,
           "prefill_logits_within_bf16_ulp": within,
           "max_memory_allocated_gb": peak / 1e9,
           "power_w": out.power_w.tolist()}
    print(f"    fleet generate ({N} lanes x B={B}, 8 tokens at T=0.8, "
          f"top_k=50): prefill {pf * 1e3:.1f} ms, decode "
          f"{per_tok * 1e3:.1f} ms/token, {res['tokens_per_s']:.2f} "
          f"tokens/s, peak {peak / 1e9:.2f} GB; single device [7]: prefill "
          f"{single['prefill_s'] * 1e3:.1f} ms, decode "
          f"{single['decode_s_per_token'] * 1e3:.1f} ms/token, "
          f"{single['tokens_per_s']:.2f} tokens/s; replay loop of {N} "
          f"single-lane generates {loop_s:.2f} s ({gen_s:.2f} s fleet)",
          flush=True)
    print(f"    launches per forward: {counts['fused_aged_matmul_lanes'] // n_steps}"
          f" lane GEMM (fast path), {counts['bitflip_draw_lanes'] // n_steps}"
          f" lane draw; lanes == their single-lane replays: "
          f"{first is None} ({len(diverged)} of {N * B * n_steps} tokens "
          f"differ, first {first}); prefill logits within {logit_diff:.3g}"
          f"; expert bmm rows alone vs in the {N}-lane batch: max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in
                      probe["max_abs_diff"].items()), flush=True)
    res["expert_bmm"] = expert_bmm_ms(params, cfg, dev, lanes=N)
    res["profile"] = profile_generate(engine, prompts, 5 * L * 2, **sample)
    prof = res["profile"]
    print(f"    expert bmm chain of {L} layers at (E, {N} x C, d): "
          f"{res['expert_bmm']['dev_ms']:.2f} ms a forward ([7]: "
          f"{single['expert_bmm']['dev_ms']:.2f} ms at (E, C, d)), "
          f"{res['expert_bmm']['tb_per_s']:.2f} TB/s over "
          f"{res['expert_bmm']['weight_gb']:.1f} GB; aten::bmm calls a "
          f"prefill + decode step {prof['bmm_calls']}; prefill + 1 decode "
          f"step: {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f}%) over "
          f"{prof['n_kernel_launches']} kernel launches; lane GEMM "
          f"{prof['gemm_device_ms']:.2f} ms over {prof['gemm_launches']}",
          flush=True)
    res["host_syncs"] = decode_syncs(engine, prompts, **sample)
    # the sampler of a fleet token: one Gumbel chain per lane on the host
    logits = torch.randn((N * B, cfg.vocab), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    lane_keys = prandom.split(prandom.PRNGKey(3), N)
    draw = lambda: steps.sample_token(logits * 3.0, lane_keys, 0.8, 50,
                                      lanes=N)
    draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        draw()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    samp_dev, samp_kernels = device_ms(draw, iters=5)
    res["sampler"] = {"host_ms": host_ms, "dev_ms": samp_dev,
                      "kernels_per_token": samp_kernels,
                      "ms": cuda_time_ms(draw, iters=5, warmup=1)}
    print(f"    host syncs of sampled fleet generate at 2 / 8 tokens: "
          f"{res['host_syncs']['generate_2_tokens']} / "
          f"{res['host_syncs']['generate_8_tokens']}; the {N}-lane sampler: "
          f"{host_ms:.2f} ms of host time and {samp_kernels:.0f} kernels "
          f"({samp_dev:.3f} ms of device time) a token", flush=True)
    del engine
    return res


def moe_fleet_reduced_vs_cpu(dev) -> dict:
    """[8]'s last check: reduced qwen3_moe_235b and arctic_480b fleets (3
    lanes) sampled on the card against the CPU."""
    from repro_torch.configs import get_config
    out = {arch: reduced_fleet_vs_cpu(get_config(arch).reduced(), dev,
                                      temperature=0.8, top_k=8)
           for arch in ("qwen3_moe_235b", "arctic_480b")}
    print("    reduced qwen3_moe_235b and arctic_480b fleets (3 lanes, BER "
          "1e-3 / 0 / 3e-3, T=0.8, top_k=8): card kernel route == CPU "
          "plain route tokens", flush=True)
    return out


def paper_tables_phase(dev) -> dict:
    """[9] The paper's Table I / II and Fig. 5 benchmarks and the lifetime
    study on the card, each with its checks and its seconds."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import fig5_curves, table1_aging, \
        table2_policy
    from repro_torch.core.resilience import OPERATORS
    from repro_torch.examples import lifetime_study
    res = {}
    for name, mod in (("table1_aging", table1_aging),
                      ("table2_policy", table2_policy),
                      ("fig5_curves", fig5_curves)):
        t0 = time.perf_counter()
        out = mod.evaluate(device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res[name] = {"seconds": secs, "checks": out["checks"],
                     "rows": out["rows"]}
        print(f"[9] {name} on the card in {secs:.2f} s:", flush=True)
        for ln in out["text"].splitlines():
            if ln.startswith("[PASS]") or ln.startswith("[FAIL]"):
                print(f"    {ln}", flush=True)
        failed = [c["name"] for c in out["checks"] if not c["ok"]]
        check(not failed, f"{name} checks failed: {failed}")
    t0 = time.perf_counter()
    study = lifetime_study.study(device=dev)
    secs = time.perf_counter() - t0
    sav = study["saving"]
    shape = (len(lifetime_study.BUDGETS), len(lifetime_study.DUTIES),
             len(OPERATORS))
    check(study["traj"].batch_shape == shape and sav.shape == shape
          and bool(np.isfinite(sav).all()),
          f"lifetime study grid {study['traj'].batch_shape}")
    # the (0.5 % budget, duty 0.5) cell is Table II's scenario
    cell = float(sav[lifetime_study.BUDGETS.index(0.5),
                     lifetime_study.DUTIES.index(0.5)].mean())
    avg = res["table2_policy"]["rows"]["avg_power_saving_pct"]
    check(abs(cell - avg) < 1e-3, f"lifetime study cell (0.5 %, 0.5) "
          f"saving {cell:.4f} % != Table II average {avg:.4f} %")
    res["lifetime_study"] = {"seconds": secs, "sweep_s": study["sweep_s"],
                             "saving_pct": sav.mean(axis=-1).tolist(),
                             "table2_cell_saving_pct": cell}
    print(f"[9] lifetime_study on the card in {secs:.2f} s: "
          f"{np.prod(shape)} lifetimes in one batched sweep "
          f"({study['sweep_s']:.2f} s with the baseline's); the (0.5 %, "
          f"0.5) cell saves {cell:.2f} % = Table II's average", flush=True)
    return res


# [10]'s training cell: llama3_8b at its published widths, 8 of 32 layers
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 256, 6
TRAIN_PEAK_LIMIT = 76e9        # bytes: params, grads and moments ~45 GB
# card against CPU on reduced llama3_8b: the CPU parity tests' tolerances
# (tests/test_torch_train.py: 5 x LOSS_RTOL on the loss, PARAM_ATOL)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 2e-4


def _state_to(state, dev):
    """A copy of a TrainState on ``dev``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: None if x is None else x.to(dev, copy=True),
                    state)


def _state_diff(a, b) -> float:
    """Largest |a - b| over every leaf of two TrainStates (0 == bit-equal
    floats and equal steps)."""
    from repro_torch.tree import flatten
    fa, fb = flatten(a), flatten(b)
    return max(float((fa[k].double().cpu() - fb[k].double().cpu()).abs()
                     .max()) for k in fa)


def train_full_width(dev, cfg) -> tuple:
    """``TrainLoop`` over ``make_train_step(microbatches=2, remat=True)`` on
    llama3_8b at full width, ``TRAIN_LAYERS`` layers, float32 AdamW; one
    more step under ``torch.profiler`` for the device busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.tree import leaves
    cfg8 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS + 1)
    step = make_train_step(cfg8, opt, microbatches=2, remat=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg8, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    logs = []
    loop = TrainLoop(step, data, log_fn=logs.append,
                     cfg=LoopConfig(total_steps=TRAIN_STEPS, log_every=1))
    state = loop.run(lambda: state)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in loop.history]
    times = [h["time"] for h in loop.history]
    step_s = float(np.median(times[-4:]))
    tb = data.batch_at(TRAIN_STEPS)
    batch = {"tokens": tb.tokens, "labels": tb.labels}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        prof_wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kern) / 1e3
    top = sorted(kern, key=_dev_us, reverse=True)[:8]
    res = {"layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": 2, "remat": True, "params_b": n_params / 1e9,
           "init_s": init_s, "losses": losses, "step_s": times,
           "step_ms_median_last4": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_gb": peak / 1e9, "device_busy_ms": busy,
           "device_busy_share": busy / (step_s * 1e3),
           "profiled_step_wall_ms": prof_wall * 1e3,
           "launches_per_step": sum(e.count for e in kern),
           "top": [{"name": e.key[:100], "device_ms": _dev_us(e) / 1e3,
                    "calls": e.count} for e in top]}
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(peak < TRAIN_PEAK_LIMIT, f"training peak {peak / 1e9:.2f} GB")
    return res, cfg8, state, data


def train_card_vs_cpu(dev, cfg) -> dict:
    """Reduced llama3_8b, 3 steps of ``microbatches=2, remat=True`` from
    one CPU-made state, on the card and on the CPU; then the same card run
    again (is the card's training deterministic?)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.tree import leaves
    small = cfg.reduced()
    data = SyntheticLM(vocab=small.vocab, seq_len=16, global_batch=4)
    step = make_train_step(small, AdamWConfig(lr=3e-3, warmup_steps=2,
                                              total_steps=10),
                           microbatches=2, remat=True)
    runs = {}
    for name, where in (("card", dev), ("card_again", dev), ("cpu", "cpu")):
        st = _state_to(init_train_state(small, 1, device="cpu"), where)
        losses = []
        for i in range(3):
            tb = data.batch_at(i)
            st, m = step(st, {"tokens": tb.tokens, "labels": tb.labels})
            losses.append(float(m["loss"]))
        runs[name] = (st, losses)
    (g, gl), (g2, _), (c, cl) = runs["card"], runs["card_again"], runs["cpu"]
    param_diff = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(leaves(g.params), leaves(c.params)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"card vs CPU losses {gl} / {cl}")
    check(param_diff <= TRAIN_PARAM_ATOL,
          f"card vs CPU params differ by {param_diff:.3g}")
    return {"losses_card": gl, "losses_cpu": cl, "loss_rel": loss_rel,
            "param_max_abs_diff": param_diff,
            "deterministic": _state_diff(g, g2) == 0.0}


def train_checkpoint_roundtrip(dev, cfg, deterministic: bool) -> dict:
    """On the card: an async save and a restore give the state bit for
    bit; a 6-step TrainLoop interrupted after step 3 and resumed from its
    checkpoint ends where the uninterrupted run ends (bit for bit when the
    card's training is deterministic, else within TRAIN_PARAM_ATOL)."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.steps import init_train_state, make_train_step
    small = cfg.reduced()
    data = SyntheticLM(vocab=small.vocab, seq_len=16, global_batch=4)
    step = make_train_step(small, AdamWConfig(lr=3e-3, warmup_steps=2,
                                              total_steps=10),
                           microbatches=2, remat=True)
    base = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    init = lambda: _state_to(init_train_state(small, 2, device="cpu"), dev)
    st = init()
    for i in range(2):
        tb = data.batch_at(i)
        st, _ = step(st, {"tokens": tb.tokens, "labels": tb.labels})
    mgr = CheckpointManager(str(base / "async"), keep=2, save_every=1)
    mgr.save(2, st, blocking=False)
    before = _state_to(st, "cpu")
    tb = data.batch_at(2)
    step(st, {"tokens": tb.tokens, "labels": tb.labels})  # in place
    mgr.wait()
    restored, _ = load_checkpoint(str(base / "async"), 2, init())
    async_diff = _state_diff(restored, before)
    check(async_diff == 0.0, f"async save + restore differs by {async_diff}")
    run = lambda total, d: TrainLoop(
        step, data, ckpt_dir=d, log_fn=lambda _: None,
        cfg=LoopConfig(total_steps=total, log_every=1, ckpt_every=3)).run(
            init)
    full = run(6, None)
    run(3, str(base / "loop"))
    resumed = run(6, str(base / "loop"))
    resume_diff = _state_diff(resumed, full)
    shutil.rmtree(base, ignore_errors=True)
    check(resume_diff == 0.0 if deterministic
          else resume_diff <= TRAIN_PARAM_ATOL,
          f"resumed run differs from the uninterrupted one by {resume_diff}")
    return {"async_restore_max_diff": async_diff,
            "resume_max_diff": resume_diff, "exact": resume_diff == 0.0}


class _Recorder:
    """Stands in for a kernel wrapper: calls it, and keeps copies of the
    arguments and result of its first ``keep`` calls."""

    def __init__(self, fn, keep: int):
        self.fn, self.keep, self.n, self.calls = fn, keep, 0, []

    def __call__(self, *args, **kw):
        import torch
        out = self.fn(*args, **kw)
        self.n += 1
        if len(self.calls) < self.keep:
            cp = lambda v: v.clone() if isinstance(v, torch.Tensor) else v
            self.calls.append(([cp(v) for v in args],
                               {k: cp(v) for k, v in kw.items()}, cp(out)))
        return out


def recorded_score(eng, tokens, layers: int, dev) -> tuple:
    """``eng.score(tokens)`` with the first layer's launches of the fused
    GEMM (7) and the draw bitflip (2) recorded, then each held against its
    plain version on the same inputs: the NLL, one row per launch
    (shape, logical tile, CTA plan, upsets, max |err|) and the replay's
    seconds.  Fails unless every launch is bit for bit its plain
    version's and the score made 7 and 2 a layer."""
    import torch
    from repro_torch.kernels import _cuda, ops, ref
    gemm = _Recorder(ops._fused_aged_matmul_kernel, 7)
    draw = _Recorder(ops.bitflip_draw, 2)
    ops._fused_aged_matmul_kernel, ops.bitflip_draw = gemm, draw
    try:
        nll = eng.score(tokens)
    finally:
        ops._fused_aged_matmul_kernel, ops.bitflip_draw = gemm.fn, draw.fn
    check(gemm.n == 7 * layers and draw.n == 2 * layers,
          f"score wrapper calls: {gemm.n} GEMM, {draw.n} draw")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    rows = []
    for (a, b, xs, ws, ber, seed), kw, out in gemm.calls:
        exp = ref.fused_aged_matmul_ref(a, b, xs, ws, ber, seed, **kw)
        clean = ref.fused_aged_matmul_ref(a, b, xs, ws, 0.0, seed, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(out, exp)
        plan = _cuda.gemm_plan(a.shape[0], b.shape[1], a.shape[1], n_sms)
        rows.append({"kernel": "fused_aged_matmul", "M": a.shape[0],
                     "K": a.shape[1], "N": b.shape[1], "ber": float(ber),
                     "tile": [kw["bm"], kw["bn"]],
                     "plan": {"path": plan.path, "bm": plan.bm,
                              "bn": plan.bn, "splits": plan.splits},
                     "upset_outputs": int((exp != clean).sum()),
                     "max_abs_err": err})
        check(err == 0.0 and torch.equal(out, exp),
              f"score GEMM vs plain {rows[-1]}")
    for (x, words, q), _, out in draw.calls:
        exp = ref.bitflip_draw_ref(x, words, q)
        torch.cuda.synchronize()
        err = max_abs_err(out, exp)
        rows.append({"kernel": "bitflip_draw", "shape": list(x.shape),
                     "q": float(q), "flips": int((exp != x).sum()),
                     "max_abs_err": err})
        check(err == 0.0 and torch.equal(out, exp),
              f"score draw vs plain {rows[-1]}")
    return nll, rows, time.perf_counter() - t0


def train_phase(dev, cfg) -> dict:
    """[10] Training: the full-width cell, the trained model scored on the
    kernel route at 0 and 9 years, card against CPU, the checkpoint round
    trips, and ``repro_torch.benchmarks.fig1b_ber`` on the card."""
    import torch
    from repro_torch import kernels
    from repro_torch.benchmarks import fig1b_ber
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.serve.engine import ServeEngine
    res, cfg8, state, data = train_full_width(dev, cfg)
    print(f"[10] llama3_8b full width, {cfg8.n_layers} of 32 layers, "
          f"{res['params_b']:.2f} B float32 params, AdamW, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}, 2 microbatches, remat: losses "
          + ", ".join(f"{x:.4f}" for x in res["losses"])
          + f"; {res['step_ms_median_last4']:.1f} ms a step (median of the "
          f"last 4), {res['tokens_per_s']:.0f} tokens/s, peak "
          f"{res['peak_gb']:.2f} GB, device busy "
          f"{100 * res['device_busy_share']:.1f}% of a step over "
          f"{res['launches_per_step']} launches", flush=True)
    # the trained model, scored on the fused GEMM and the draw bitflip
    params = state.params
    del state
    torch.cuda.empty_cache()
    tokens = data.batch_at(1000).tokens
    scores, counts = {}, {k: 0 for k in kernels.KERNEL_NAMES}
    for age in (0.0, 9.0):
        rt = FleetRuntime(n_devices=1, policy="fault_tolerant", device=dev)
        rt.set_age(years=age)
        eng = ServeEngine(cfg8, params, runtime=rt, max_len=TRAIN_SEQ,
                          use_systolic_kernel=True, device=dev)
        kernels.reset_launch_counts()
        nll, replay, replay_s = recorded_score(eng, tokens, cfg8.n_layers, dev)
        c = kernels.launch_counts()
        check(math.isfinite(nll), f"score at {age} y: {nll}")
        check(c["fused_aged_matmul"] == 7 * cfg8.n_layers
              and c["bitflip_draw"] == 2 * cfg8.n_layers,
              f"score launches at {age} y: {c}")
        for k in counts:
            counts[k] += c[k]
        scores[f"{age:g}y"] = {"nll": nll, "bers": rt.op_bers(),
                               "layer0_vs_plain": replay,
                               "replay_s": replay_s}
    res["scores"], res["launches"] = scores, counts
    print(f"     trained model scored on the kernel route (fused GEMM + "
          f"draw bitflip): NLL fresh {scores['0y']['nll']:.4f}, aged 9 y "
          f"{scores['9y']['nll']:.4f} (uniform {data.uniform_nll():.4f}); "
          f"launches {counts}", flush=True)
    for age, sc in scores.items():
        r = sc["layer0_vs_plain"]
        print(f"     score at {age}, layer 0 vs plain, bit for bit (replayed "
              f"in {sc['replay_s']:.1f} s): GEMMs "
              + ", ".join(f"{x['M']}x{x['K']}x{x['N']} plan "
                          f"{x['plan']['bm']}x{x['plan']['bn']}"
                          f"/{x['plan']['splits']} "
                          f"({x['upset_outputs']} upset)"
                          for x in r if x["kernel"] == "fused_aged_matmul")
              + "; draws " + ", ".join(
                  f"{tuple(x['shape'])} ({x['flips']} flips)"
                  for x in r if x["kernel"] == "bitflip_draw"), flush=True)
    del eng
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(dev, cfg)
    cv = res["card_vs_cpu"]
    print(f"     reduced llama3_8b, 3 steps: card vs CPU losses within "
          f"{cv['loss_rel']:.2g} relative, params within "
          f"{cv['param_max_abs_diff']:.2g}; the card's training is "
          f"{'' if cv['deterministic'] else 'NOT '}deterministic",
          flush=True)
    res["checkpoint"] = train_checkpoint_roundtrip(dev, cfg,
                                                   cv["deterministic"])
    ck = res["checkpoint"]
    print(f"     checkpoints on the card: async save + restore bit-exact; "
          f"resumed at step 3 == uninterrupted 6 steps "
          f"({'bit for bit' if ck['exact'] else ck['resume_max_diff']})",
          flush=True)
    t0 = time.perf_counter()
    fb = fig1b_ber.evaluate(device=dev)
    res["fig1b_ber"] = {"rows": fb["rows"], "checks": fb["checks"],
                        "seconds": time.perf_counter() - t0}
    fails = [c["name"] for c in fb["checks"] if not c["ok"]]
    print(f"     fig1b_ber on the card ({res['fig1b_ber']['seconds']:.1f} "
          f"s): NLL " + ", ".join(f"{b:g}: {n:.3f}" for b, n in zip(
              fb["rows"]["bers"], fb["rows"]["nll"]))
          + f"; {len(fb['checks']) - len(fails)} / {len(fb['checks'])} "
          f"checks pass", flush=True)
    check(not fails, f"fig1b_ber checks failed: {fails}")
    return res, params, cfg8


# [10b]'s refit of the checked-in delay polynomial on this machine's numpy
POLY_RTOL = 1e-6
# [10b]'s sweep: the reference CLI's full setting on [10]'s trained model
SWEEP_BATCH, SWEEP_SEQ, SWEEP_SEEDS = 8, 64, 2
SWEEP_ROW = 6                  # step 3's BER row (1e-4: losses mid-range)


def lane_top2(params, cfg, tokens, fi):
    """Top-1 predictions and top1 - top2 logit gaps of every lane of
    ``fi`` in one forward (``(lanes, B, S)`` each, host numpy), and each
    position's top-1 logit."""
    import torch
    from repro_torch.models import transformer as tf
    lanes = fi.lanes or 1             # a single-device config: one lane
    with torch.no_grad():
        logits, _, _ = tf.forward_logits(params, cfg,
                                         tokens.repeat(lanes, 1),
                                         fi=fi.with_seeds())
        top = torch.topk(logits, 2, dim=-1)
        pred = logits.argmax(dim=-1)
        del logits
    shape = (lanes,) + tuple(tokens.shape)
    val = top.values.cpu().numpy()
    check(bool((pred == top.indices[..., 0]).all()),
          "argmax and topk disagree on the first maximal index")
    return (pred.cpu().numpy().reshape(shape),
            (val[..., 0] - val[..., 1]).reshape(shape),
            val[..., 0].reshape(shape))


def near_ties(a, b) -> dict:
    """Positions where two runs' predictions differ, and whether each is a
    near tie: a top-2 gap (of either run) within one float32 ulp of the
    top logit.  ``a``/``b`` are :func:`lane_top2` triples."""
    import numpy as np
    (pa, ga, ta), (pb, gb, tb) = a, b
    where = np.argwhere(pa != pb)
    rows = []
    for idx in map(tuple, where):
        gap = float(min(ga[idx], gb[idx]))
        ulp = float(np.spacing(np.float32(max(abs(ta[idx]), abs(tb[idx])))))
        rows.append({"at": [int(i) for i in idx], "gap": gap, "ulp": ulp,
                     "tie": gap <= ulp})
    return {"differ": len(rows), "rows": rows[:20],
            "ok": all(r["tie"] for r in rows)}


def sweep_vs(dev, cfg, params_by_dev, tokens, ber_grid, route, chunk):
    """One seed of the sweep on the card (``chunk`` lanes a forward) and
    on the CPU, lane by lane: the reference predictions and every lane's
    predictions compared with the near-tie rule, and the loss surfaces
    (``run_sweep``) compared, differences allowed only where a prediction
    differs at a near tie.  Returns the launches of the card's sweep."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.calibrate import resilience_sweep as rs
    from repro_torch.core.resilience import operators_for
    ops = operators_for(cfg.family)
    key = prandom.PRNGKey(0)
    fi = rs.grid_fault_config(ops, ber_grid, prandom.fold_in(key, 0),
                              **route)
    ref_fi = rs._reference_fault_config(ops, key, **route)
    tops = {}
    for where in (dev, "cpu"):
        tk = torch.as_tensor(tokens, dtype=torch.int64, device=where)
        p = params_by_dev[where if where == "cpu" else "cuda"]
        ref = lane_top2(p, cfg, tk, ref_fi)
        parts = [lane_top2(p, cfg, tk, rs.chunk_of(fi, l0, min(
            fi.lanes, l0 + chunk))) for l0 in range(0, fi.lanes, chunk)]
        tops[where if where == "cpu" else "cuda"] = (ref, tuple(
            np.concatenate([x[i] for x in parts]) for i in range(3)))
    ref_cmp = near_ties(tops["cuda"][0], tops["cpu"][0])
    lane_cmp = near_ties(tops["cuda"][1], tops["cpu"][1])
    kernels.reset_launch_counts()
    card = rs.run_sweep(cfg, params_by_dev["cuda"], tokens,
                        ber_grid=ber_grid, n_seeds=1, chunk=chunk,
                        device=dev, **route)
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    cpu = rs.run_sweep(cfg, params_by_dev["cpu"], tokens, ber_grid=ber_grid,
                       n_seeds=1, device="cpu", **route)
    same = bool(np.array_equal(card.loss_pct, cpu.loss_pct))
    check(ref_cmp["ok"] and lane_cmp["ok"],
          f"sweep {route} card vs CPU: predictions differ beyond a near "
          f"tie: reference {ref_cmp}, lanes {lane_cmp}")
    check(same or ref_cmp["differ"] + lane_cmp["differ"] > 0,
          "sweep losses differ card vs CPU with equal predictions")
    return {"route": route, "lanes": fi.lanes, "chunk": chunk,
            "losses_equal": same, "reference_preds": ref_cmp,
            "lane_preds": lane_cmp, "launches": counts,
            "launches_by_path": by_path,
            "max_loss_diff": float(np.abs(card.loss_pct
                                          - cpu.loss_pct).max())}


def timed_once(fn, wrapper: str | None, match: str | None) -> dict:
    """``fn`` (one call of a kernel wrapper, counted under ``wrapper``)
    checked to launch once, then timed: ``ms`` with CUDA events over
    back-to-back calls, ``dev_ms`` from ``torch.profiler`` (``None`` where
    the profiler dropped the kernels' records on every try)."""
    import torch
    from repro_torch import kernels
    if wrapper is not None:
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = kernels.launch_counts()[wrapper]
        check(n == 1, f"{wrapper}: {n} launches a call")
    dev_ms, per_call = device_ms(fn, iters=5, match=match)
    return {"ms": cuda_time_ms(fn, iters=5, warmup=1),
            "dev_ms": dev_ms if per_call >= 1 else None}


def resilience_phase(dev, cfg, params) -> dict:
    """[10b] The measured-resilience path on [10]'s trained llama3_8b
    (published widths, 8 layers, float32): the reference CLI's full sweep
    (108 lanes x 2 seeds, B=8, S=64) on the fused lane kernels, its first
    layer's launches against the plain versions, chunk invariance, a
    reduced grid on the card against the CPU on two routes, the fit, the
    artifact, the measured policy serving a fleet, the telemetry taps and
    export, and the serving example."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.calibrate import resilience_sweep as rs
    from repro_torch.core.artifacts import load_calibration
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.core.policy import (MeasuredResiliencePolicy,
                                         evaluate_policy)
    from repro_torch.core.resilience import DEFAULT_BER50, OPERATORS
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.bitflip import bitflip_draw_lanes
    from repro_torch.kernels.fused_aged_matmul import fused_aged_matmul_lanes
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import export, metrics
    from repro_torch.obs.taps import cosim_taps, enable_taps
    from repro_torch.serve.engine import FleetServeEngine
    from repro_torch.tree import tree_map

    L = cfg.n_layers
    res = {"layers": L, "batch": SWEEP_BATCH, "seq": SWEEP_SEQ,
           "seeds": SWEEP_SEEDS}
    grid = rs.DEFAULT_BER_GRID
    n_ops = len(OPERATORS)
    n_lanes = len(grid) * n_ops
    tokens = SyntheticLM(vocab=cfg.vocab, seq_len=SWEEP_SEQ,
                         global_batch=SWEEP_BATCH).batch_at(10_000).tokens
    rows = SWEEP_BATCH * SWEEP_SEQ
    chunk = rs.default_chunk(cfg, rows, n_lanes, dev)
    check(chunk == _cuda.MAX_LANES, f"default chunk {chunk} at {rows} rows")
    n_fwd = SWEEP_SEEDS * -(-n_lanes // chunk)

    # 1. the sweep --------------------------------------------------------
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curves, sweep = rs.empirical_resilience(
        cfg, params, tokens, ber_grid=grid, n_seeds=SWEEP_SEEDS,
        use_kernel=True, fused=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    peak = torch.cuda.max_memory_allocated(dev)
    check(counts["fused_aged_matmul_lanes"] == 7 * L * n_fwd
          and by_path["fused_aged_matmul_lanes"] == {"fast": 7 * L * n_fwd,
                                                     "generic": 0},
          f"sweep lane GEMM launches {by_path}, want {7 * L * n_fwd} fast "
          f"(7 a layer and chunk forward)")
    check(counts["bitflip_draw_lanes"] == 2 * L * n_fwd,
          f"sweep lane draw launches {counts}, want {2 * L * n_fwd}")
    check(counts["fused_aged_matmul"] == 7 * L
          and counts["bitflip_draw"] == 2 * L
          and counts["systolic_matmul"] == 0,
          f"sweep reference-forward launches {counts}")
    loss = sweep.loss_pct
    check(bool(np.isfinite(loss).all() and (loss >= 0).all()
               and (loss <= 100).all()), f"losses outside [0, 100]: {loss}")
    knees = {op: c.ber50 for op, c in curves.items()}
    # a knee the grid brackets (the surface crosses half of l_max inside
    # it) must be fitted inside the grid; an operator whose loss stays
    # below half at the grid's top BER is reported, its knee above the grid
    half = 0.5 * curves[OPERATORS[0]].l_max
    crosses = {op: bool(loss[:, j].min() < half <= loss[:, j].max())
               for j, op in enumerate(OPERATORS)}
    outside = {op: v for op, v in knees.items()
               if not grid[0] <= v <= grid[-1]}
    check(not any(crosses[op] for op in outside),
          f"fitted knees outside the grid [{grid[0]:.2g}, {grid[-1]:.2g}] "
          f"where the surface crosses {half:g} % inside it: {outside}; "
          f"losses {loss.tolist()}")
    print("    loss surface [%] (rows: BER): " + "; ".join(
        f"{b:.1e}: " + " ".join(f"{x:.1f}" for x in loss[i])
        for i, b in enumerate(grid)), flush=True)
    res["sweep"] = {"lanes": n_lanes, "chunk": chunk, "chunk_forwards": n_fwd,
                    "wall_s": wall,
                    "grid_points_per_s": n_lanes * SWEEP_SEEDS / wall,
                    "peak_gb": peak / 1e9, "launches": counts,
                    "launches_by_path": by_path,
                    "loss_pct": loss.tolist(), "ber50": knees,
                    "knee_above_grid": sorted(
                        op for op in outside if knees[op] > grid[-1]),
                    "steepness": {op: c.steepness
                                  for op, c in curves.items()}}
    print(f"[10b] measured resilience of [10]'s llama3_8b ({L} layers, "
          f"float32): {n_lanes} lanes ({len(grid)} BERs x {n_ops} ops) x "
          f"{SWEEP_SEEDS} seeds, B={SWEEP_BATCH} S={SWEEP_SEQ}, {chunk} lanes "
          f"a forward ({rows * chunk} rows): {wall:.2f} s, "
          f"{n_lanes * SWEEP_SEEDS / wall:.1f} grid points/s, peak "
          f"{peak / 1e9:.2f} GB; launches {counts} (7 lane GEMM + 2 lane "
          f"draw a layer and chunk forward, all GEMMs fast)", flush=True)
    print("    BER50 measured (published): " + ", ".join(
        f"{op} {knees[op]:.2e} ({DEFAULT_BER50[op]:.1e})"
        for op in OPERATORS), flush=True)

    # host cost of the 108 lanes' key and seed derivation, one forward
    key = prandom.PRNGKey(0)
    t0 = time.perf_counter()
    fi_all = rs.grid_fault_config(OPERATORS, grid, prandom.fold_in(key, 0),
                                  use_kernel=True, fused=True).with_seeds()
    for salt in range(L):
        for op in ("q", "k", "v", "o", "gate", "up", "down"):
            fi_all.seed_for(op, salt)
        for op in ("qkt", "sv"):
            [ops.flip_key_words(k) for k in fi_all.key_for(op, salt)]
    res["key_derivation_ms_108_lanes"] = (time.perf_counter() - t0) * 1e3

    # one chunk forward under the profiler: the device busy share
    tk = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    ref_pred = rs.predict(params, cfg, tk, rs._reference_fault_config(
        OPERATORS, key, use_kernel=True, fused=True)).cpu().numpy()
    fi = rs.grid_fault_config(OPERATORS, grid, prandom.fold_in(key, 0),
                              use_kernel=True, fused=True)
    part = rs.chunk_of(fi, 32, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs.lane_losses(params, cfg, tk, ref_pred, part)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kern) / 1e3
    top = sorted(kern, key=_dev_us, reverse=True)[:6]
    res["chunk_profile"] = {
        "wall_ms": prof_wall * 1e3, "device_busy_ms": busy,
        "device_busy_share": busy / (prof_wall * 1e3),
        "launches": sum(e.count for e in kern),
        "top": [{"name": e.key[:100], "device_ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top]}
    cp = res["chunk_profile"]
    print(f"    one {chunk}-lane chunk forward: {cp['wall_ms']:.1f} ms, "
          f"device busy {cp['device_busy_ms']:.1f} ms "
          f"({100 * cp['device_busy_share']:.1f}%) over {cp['launches']} "
          f"launches; top: " + ", ".join(
              f"{o['name'][:40]} {o['device_ms']:.1f} ms"
              for o in cp["top"][:4])
          + f"; lanes' key derivation "
          f"{res['key_derivation_ms_108_lanes']:.1f} ms a forward at "
          f"{n_lanes} lanes", flush=True)

    # 2. layer 0's launches of one chunk forward against the plain versions
    gemm = _Recorder(ops.fused_aged_matmul_lanes, 7)
    draw = _Recorder(ops.bitflip_draw_lanes, 2)
    ops.fused_aged_matmul_lanes, ops.bitflip_draw_lanes = gemm, draw
    try:
        rs.lane_losses(params, cfg, tk, ref_pred, part)
    finally:
        ops.fused_aged_matmul_lanes, ops.bitflip_draw_lanes = gemm.fn, draw.fn
    check(gemm.n == 7 * L and draw.n == 2 * L,
          f"chunk forward wrapper calls: {gemm.n} GEMM, {draw.n} draw")
    int_rate = int32_issue_per_s(dev)
    names = ("q", "k", "v", "o", "gate", "up", "down")
    replay, timed = [], set()
    for name, ((a, b, xs, ws, bers, seeds), kw, out) in zip(names,
                                                            gemm.calls):
        exp = ref.fused_aged_matmul_lanes_ref(a, b, xs, ws, bers, seeds, **kw)
        clean = ref.fused_aged_matmul_lanes_ref(
            a, b, xs, ws, (0.0,) * len(bers), seeds, **kw)
        torch.cuda.synchronize()
        M, K, N = a.shape[0], a.shape[1], b.shape[1]
        row = {"kernel": "fused_aged_matmul_lanes", "op": name,
               "lanes": kw["lanes"], "M": M, "K": K, "N": N,
               "upset_outputs": int((exp != clean).sum()),
               "max_abs_err": max_abs_err(out, exp)}
        check(torch.equal(out, exp), f"chunk GEMM vs plain {row}")
        del clean
        if (K, N) not in timed:
            timed.add((K, N))
            fk = lambda: fused_aged_matmul_lanes(a, b, xs, ws, bers, seeds,
                                                 **kw)
            t = timed_once(fk, "fused_aged_matmul_lanes", "int8_gemm")
            lib = timed_once(lambda: torch._int_mm(a, b), None, None)
            # the same product with b stored column-major, the layout
            # cuBLAS's int8 kernels read (the port keeps weights row-major)
            bt = b.t().contiguous().t()
            lib_cm = timed_once(lambda: torch._int_mm(a, bt), None, None)
            check(torch.equal(torch._int_mm(a, bt), torch._int_mm(a, b)),
                  "_int_mm differs by the layout of b")
            del bt
            t_b, by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                            2.0 * M * K * N)
            plan = _cuda.gemm_plan(M, N, K, torch.cuda.
                                   get_device_properties(dev)
                                   .multi_processor_count)
            row.update(ms=t["ms"], dev_ms=t["dev_ms"],
                       bound_ms=t_b, bound_by=by,
                       library_ms=lib["ms"], library_dev_ms=lib["dev_ms"],
                       library_colmajor_b_ms=lib_cm["ms"],
                       plain_ms=cuda_time_ms(lambda: ref.
                                             fused_aged_matmul_lanes_ref(
                                                 a, b, xs, ws, bers, seeds,
                                                 **kw), iters=1, warmup=0),
                       plan={"path": plan.path, "bm": plan.bm, "bn": plan.bn,
                             "splits": plan.splits})
        replay.append(row)
    for name, ((x, words, qs), _, out) in zip(("qkt", "sv"), draw.calls):
        exp = ref.bitflip_draw_lanes_ref(x, words, qs)
        torch.cuda.synchronize()
        flips = int((exp != x).sum())
        n = x.numel()
        row = {"kernel": "bitflip_draw_lanes", "op": name,
               "lanes": x.shape[0], "n": n, "n_lane": n // x.shape[0],
               "flips": flips, "max_abs_err": max_abs_err(out, exp)}
        check(torch.equal(out, exp), f"chunk draw vs plain {row}")
        t = timed_once(lambda: bitflip_draw_lanes(x, words, qs),
                       "bitflip_draw_lanes", "bitflip_draw")
        t_b, by = bound(8 * n, int_ops=THREEFRY_INT_OPS * (n + flips),
                        int_rate=int_rate)
        row.update(ms=t["ms"], dev_ms=t["dev_ms"],
                   bound_ms=t_b, bound_by=by, library_ms=None,
                   plain_ms=cuda_time_ms(lambda: ref.bitflip_draw_lanes_ref(
                       x, words, qs), iters=1, warmup=0))
        replay.append(row)
    del gemm, draw
    torch.cuda.empty_cache()
    upset = sum(r.get("upset_outputs", 0) + r.get("flips", 0)
                for r in replay)
    check(upset > 0, "no upsets in layer 0 of the chunk forward")
    res["layer0_vs_plain"] = replay
    for r in replay:
        dims = (f"M={r['lanes']}x{r['M'] // r['lanes']} K={r['K']} "
                f"N={r['N']}" if "M" in r else
                f"n={r['lanes']}x{r['n_lane']}")
        fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
        extra = (f", _int_mm {r['library_ms']:.3f} ms (dev "
                 f"{fmt(r['library_dev_ms'])}; b column-major "
                 f"{r['library_colmajor_b_ms']:.3f} ms), plan "
                 f"{r['plan']['bm']}x"
                 f"{r['plan']['bn']}/{r['plan']['splits']}"
                 if r.get("library_ms") else "")
        timing = (f": dev {fmt(r['dev_ms'])}, wrapper {r['ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.1f} ms{extra}" if "ms" in r else "")
        print(f"    layer 0 {r['kernel']} {r['op']:5s} {dims}: == plain "
              f"({r.get('upset_outputs', r.get('flips'))} "
              f"{'upset' if 'M' in r else 'flips'}){timing}", flush=True)

    # 3. chunk invariance: one BER row as part of a 32-lane chunk, as a
    # 9-lane chunk and as 9 single-lane forwards
    b0 = SWEEP_ROW * n_ops
    check(32 <= b0 and b0 + n_ops <= 64, "the row must lie in lanes 32-63")
    in32 = tuple(x[b0 - 32:b0 - 32 + n_ops]
                 for x in lane_top2(params, cfg, tk, part))
    in9 = lane_top2(params, cfg, tk, rs.chunk_of(fi, b0, b0 + n_ops))
    singles = [lane_top2(params, cfg, tk, rs.chunk_of(fi, b0 + j, b0 + j + 1))
               for j in range(n_ops)]
    in1 = tuple(np.concatenate([s[i] for s in singles]) for i in range(3))
    inv = {"row_ber": grid[SWEEP_ROW], "9_vs_32": near_ties(in9, in32),
           "1_vs_32": near_ties(in1, in32), "1_vs_9": near_ties(in1, in9)}
    lossof = lambda t: [float(100 * (1 - np.mean(t[0][j] == ref_pred)))
                        for j in range(n_ops)]
    inv["losses"] = {"32": lossof(in32), "9": lossof(in9), "1": lossof(in1)}
    for k in ("9_vs_32", "1_vs_32", "1_vs_9"):
        check(inv[k]["ok"], f"chunk invariance {k}: predictions differ "
              f"beyond a near tie: {inv[k]}")
    res["chunk_invariance"] = inv
    n_tie = sum(inv[k]["differ"] for k in ("9_vs_32", "1_vs_32", "1_vs_9"))
    print(f"    chunk invariance at BER {grid[SWEEP_ROW]:.1e} (9 lanes): "
          f"losses in a 32-lane chunk / a 9-lane chunk / 9 single forwards "
          f"{'equal' if inv['losses']['32'] == inv['losses']['9'] == inv['losses']['1'] else 'differ'}"
          f"; {n_tie} predictions differ, all near ties (gaps "
          + ", ".join(f"{r['gap']:.3g}" for k in ("9_vs_32", "1_vs_32",
                                                   "1_vs_9")
                      for r in inv[k]["rows"]) + ")", flush=True)
    del in32, in9, in1, singles

    # 4. reduced llama3_8b: the card against the CPU on two routes
    small = cfg.reduced()
    small_cpu = init_params(small, seed=0, dtype=torch.float32, device="cpu")
    by_dev = {"cpu": small_cpu,
              "cuda": tree_map(lambda x: x.to(dev), small_cpu)}
    stoks = SyntheticLM(vocab=small.vocab, seq_len=16,
                        global_batch=2).batch_at(0).tokens
    red = {}
    for name, route in (("fused", dict(use_kernel=True, fused=True)),
                        ("three_pass", dict(use_kernel=True, fused=False))):
        red[name] = sweep_vs(dev, small, by_dev, stoks, rs.QUICK_BER_GRID,
                             route, chunk=45)
    Ls = small.n_layers
    fc, tc = red["fused"]["launches"], red["three_pass"]["launches"]
    check(fc["fused_aged_matmul_lanes"] == 7 * Ls * 2
          and fc["bitflip_draw_lanes"] == 2 * Ls * 2,
          f"reduced fused sweep at 45 lanes: launches {fc}, want "
          f"{14 * Ls} lane GEMM and {4 * Ls} lane draw (two a faulted op)")
    check(tc["systolic_matmul"] == 7 * Ls * 2
          and tc["bitflip_draw_lanes"] == 9 * Ls * 2
          and tc["fused_aged_matmul_lanes"] == 0,
          f"reduced three-pass sweep launches {tc}")
    res["reduced_vs_cpu"] = red
    print(f"    reduced llama3_8b, QUICK grid (45 lanes in one forward, two "
          f"launches a faulted op): card == CPU on the fused route (losses "
          f"{'equal' if red['fused']['losses_equal'] else 'differ at near ties'}"
          f", {red['fused']['lane_preds']['differ']} near-tie predictions) "
          f"and the three-pass route ("
          f"{'equal' if red['three_pass']['losses_equal'] else 'near ties'}"
          f", {red['three_pass']['lane_preds']['differ']}); launches fused "
          f"{fc['fused_aged_matmul_lanes']} GEMM / {fc['bitflip_draw_lanes']}"
          f" draw, three-pass {tc['systolic_matmul']} systolic / "
          f"{tc['bitflip_draw_lanes']} draw", flush=True)
    del by_dev, small_cpu

    # 5. close the loop: fit, artifact, measured policy, serving ----------
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "resilience_measured.json")
    rs.write_artifact({"llama3_8b": (sweep, rs.fit_sweep(sweep))},
                      {"mode": "chip_smoke", "ber_grid": list(grid),
                       "n_seeds": SWEEP_SEEDS,
                       "batch": [SWEEP_BATCH, SWEEP_SEQ], "backend": "cuda",
                       "kernel": "fused", "layers": L}, path=path)
    cal = load_calibration()
    pol = MeasuredResiliencePolicy(ber_model=cal.ber, model="llama3_8b",
                                   artifact_path=path)
    ev = evaluate_policy(pol, cal.aging, cal.delay_poly, cal.power,
                         cal.lifetime_cfg, device=dev)
    N, B, S, n_steps = len(FLEET_AGES), 2, 16, 8
    mfleet = FleetRuntime(operators=OPERATORS, policy=pol, n_devices=N,
                          device=dev)
    ftfleet = _aged_fleet(dev)
    for i, age in enumerate(FLEET_AGES):
        mfleet.set_age(years=age, device=i)
    mb, fb = mfleet.op_ber_array(), ftfleet.op_ber_array()
    check(bool(np.isfinite(mb).all() and (mb >= 0).all()),
          f"measured-policy BERs {mb}")
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=N * B).batch_at(0).tokens.reshape(
                              N, B, S)
    engine = FleetServeEngine(cfg, params, mfleet, max_len=64,
                              use_systolic_kernel=True, device=dev)
    kernels.reset_launch_counts()
    served = engine.generate(prompts, n_steps)
    serve_counts = kernels.launch_counts()
    check(served.tokens.shape == (N, B, n_steps)
          and np.array_equal(served.bers, mb),
          f"measured fleet served {served.tokens.shape}, BERs "
          f"{served.bers} != {mb}")
    check(serve_counts["fused_aged_matmul_lanes"] == 7 * L * n_steps
          and serve_counts["bitflip_draw_lanes"] == 2 * L * n_steps,
          f"measured fleet launches {serve_counts}")
    rp = lane_replay(engine, params, cfg, prompts, dev, served.tokens,
                     n_steps, 7 * L * n_steps)
    check(rp["first"] is None, f"measured fleet lane diverges from its "
          f"single-lane replay at {rp['first']}")
    res["measured_policy"] = {
        "artifact": "chiprun_out/resilience_measured.json",
        "avg_power_saving_pct": ev["avg_power_saving_pct"],
        "published_pct": 14.0,
        "v_final": {op: ev[op]["v_final"] for op in OPERATORS},
        "bers": mb.tolist(), "fault_tolerant_bers": fb.tolist(),
        "tokens": served.tokens.tolist(), "launches": serve_counts}
    print(f"    measured policy from {path.split('/')[-1]}: average lifetime "
          f"power saving {ev['avg_power_saving_pct']:.2f}% (published curves"
          f" 14.0%, Table II); V_final " + ", ".join(
              f"{op} {ev[op]['v_final']:.2f}" for op in ("q", "k", "o",
                                                         "down")), flush=True)
    print("    served BERs at 0/3/6/9.5 y, measured (fault-tolerant), q / o "
          "/ down: " + "; ".join(
              f"{mb[i, 0]:.1e} / {mb[i, 5]:.1e} / {mb[i, 8]:.1e} "
              f"({fb[i, 0]:.1e} / {fb[i, 5]:.1e} / {fb[i, 8]:.1e})"
              for i in range(N)) + "; every lane == its single-lane replay",
          flush=True)

    # 6. telemetry on the card --------------------------------------------
    g_cos, c_cos = KEPT.pop("wear_level_cosims")
    tg = cosim_taps(g_cos, _aged_fleet(dev).unit_scenario)
    tc_ = cosim_taps(c_cos, _aged_fleet("cpu").unit_scenario)
    check(set(tg.keys()) == set(tc_.keys())
          and all(np.array_equal(tg[k], tc_[k]) for k in tg.keys()),
          "cosim_taps of the wear_level co-sim: card != CPU")
    ftengine = FleetServeEngine(cfg, params, ftfleet, max_len=64,
                                use_systolic_kernel=True, device=dev)
    calls = lambda: getattr(metrics.REGISTRY.get("fleet_generate_calls"),
                            "value", 0.0)
    calls0 = calls()
    with enable_taps():
        tapped = ftengine.generate(prompts, 4)
    check(tapped.telemetry is not None and all(
        v.shape == (N, 4) and np.isfinite(v).all()
        for v in tapped.telemetry.values()), "fleet taps under enable_taps")
    check(calls() == calls0 + 1, "the tapped fleet call was not recorded")
    samples = metrics.REGISTRY.collect()
    jsonl, prom = out_dir / "telemetry.jsonl", out_dir / "metrics.prom"
    export.write_jsonl(jsonl, samples, manifest=export.run_manifest(
        "chip_smoke"), events=[{"phase": "10b"}])
    text = export.prometheus_text(samples)
    prom.write_text(text)
    _, back, _ = export.read_jsonl(jsonl)
    same = lambda xs: [(s.name, s.labels, s.kind,
                        None if math.isnan(s.value) else s.value) for s in xs]
    check(same(back) == same(samples), "JSONL export did not round-trip")
    check(same(export.parse_prometheus(prom.read_text())) == same(samples),
          "Prometheus text did not round-trip")
    res["telemetry"] = {"cosim_taps_series": sorted(tg.keys()),
                        "samples": len(samples),
                        "fleet_logit_max": tapped.telemetry[
                            "logit_max"].tolist()}
    print(f"    telemetry: cosim_taps of [6b]'s wear_level co-sim card == "
          f"CPU ({', '.join(sorted(tg.keys()))}); a tapped fleet call "
          f"recorded; {len(samples)} registry samples exported to "
          f"chiprun_out/telemetry.jsonl and metrics.prom and parsed back "
          f"equal", flush=True)
    del engine, ftengine

    # 7. the serving example ------------------------------------------------
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable, "-m",
                         "repro_torch.examples.aging_aware_serving"],
                        cwd=str(ROOT), capture_output=True, text=True,
                        timeout=300, env={**__import__("os").environ,
                                          "PYTHONPATH": str(ROOT / "src")})
    ex_s = time.perf_counter() - t0
    (out_dir / "aging_aware_serving.log").write_text(ex.stdout + ex.stderr)
    check(ex.returncode == 0, f"the serving example failed "
          f"({ex.returncode}): {ex.stderr[-2000:]}")
    res["serving_example"] = {"seconds": ex_s,
                              "tail": ex.stdout.splitlines()[-3:]}
    print(f"    python -m repro_torch.examples.aging_aware_serving on the "
          f"card: {ex_s:.1f} s (log in chiprun_out/aging_aware_serving.log)"
          f"; ends: {ex.stdout.splitlines()[-2][:110]}", flush=True)

    # 8. the physics calibration on the card -------------------------------
    from repro_torch.core import calibrate as pcal
    from repro_torch.core.delay import PathModel, fit_delay_polynomial
    t0 = time.perf_counter()
    aged = pcal.calibrate_aging(device=dev)
    same = {f: bool(np.array_equal(getattr(aged, f).cpu().numpy(),
                                   np.asarray(cal.raw["aging"][f],
                                              np.float32)))
            for f in ("A", "B", "Ea", "n", "chi")}
    check(all(same.values()), f"calibrate_aging on the card != the "
          f"checked-in parameters: {same}")
    rows = pcal.verify_table1(aged, cal.delay_poly, cal.lifetime_cfg,
                              device=dev)
    targets = {"nom_norec": dict(pmos_total=82.0, nmos=50.5, pmos_hci=19.8,
                                 pmos_bti=62.2),
               "nom_rec": dict(pmos_total=73.1, nmos=46.1),
               "vmax_norec": dict(pmos_total=130.7, nmos=105.2,
                                  pmos_hci=27.3, pmos_bti=103.4)}
    off = {(r, k): rows[r][k] for r, vals in targets.items()
           for k, v in vals.items() if abs(rows[r][k] / v - 1) > 0.01}
    check(not off, f"Table I rows off the paper's by more than 1 %: {off}")
    drift = max(abs(rows[r][k] - v) / max(abs(v), 1e-6)
                for r, vals in cal.raw["table1_check"].items()
                for k, v in vals.items())
    check(drift <= 1e-4, f"Table I on the card vs the checked-in rows: "
          f"{drift:.3g} relative")
    # the fit is a float64 LAPACK least squares on the host: this
    # machine's numpy may round it otherwise than the one that wrote the
    # artifact, so the refit is held to the checked-in coefficients within
    # POLY_RTOL of the largest, and its delays over the fitting box to
    # the checked-in polynomial's within POLY_RTOL (float32 delays)
    poly = fit_delay_polynomial(PathModel.from_dict(cal.raw["path_model"]))
    want = np.asarray(cal.raw["delay_poly"]["coeffs"])
    got = np.asarray(poly.to_dict()["coeffs"])
    coef_rel = float(np.abs(got - want).max() / np.abs(want).max())
    g = torch.Generator().manual_seed(7)
    box = [torch.rand(4096, generator=g) * 0.15,
           torch.rand(4096, generator=g) * 0.15,
           0.88 + torch.rand(4096, generator=g) * 0.18]
    d_got, d_want = poly(*box), cal.delay_poly(*box)
    delay_rel = float(((d_got - d_want).abs() / d_want.abs()).max())
    check(coef_rel <= POLY_RTOL and delay_rel <= POLY_RTOL,
          f"fit_delay_polynomial vs the checked-in polynomial: coefficients "
          f"{coef_rel:.3g}, delays {delay_rel:.3g} relative")
    res["calibration"] = {"seconds": time.perf_counter() - t0,
                          "table1": rows, "max_rel_vs_checked_in": drift,
                          "poly_bit_equal": bool(np.array_equal(got, want)),
                          "poly_coeff_rel": coef_rel,
                          "poly_delay_rel": delay_rel}
    print(f"    physics calibration on the card ({res['calibration']['seconds']:.1f}"
          f" s): calibrate_aging == the checked-in parameters; Table I "
          + ", ".join(f"{r} {rows[r]['pmos_total']:.1f}/{rows[r]['nmos']:.1f}"
                      for r in rows)
          + f" mV (p/n; within 1 % of the paper, {drift:.2g} of the "
          f"checked-in rows); the checked-in path model refitted: "
          + ("bit for bit" if res["calibration"]["poly_bit_equal"] else
             f"coefficients within {coef_rel:.2g}, delays within "
             f"{delay_rel:.2g} relative"), flush=True)

    launches = {k: counts[k] + serve_counts[k] + fc[k] + tc[k]
                for k in kernels.KERNEL_NAMES}
    res["launches"] = launches
    return res


# --------------------------------------------------------------------------- #
# [12] the hybrid, SSM, VLM and enc-dec families
# --------------------------------------------------------------------------- #
FAMILY_ARCHS = ("recurrentgemma_2b", "rwkv6_3b", "paligemma_3b",
                "whisper_large_v3")
# (fused GEMM, draw) launches a forward, counted from the models' code:
# recurrentgemma 18 rec layers x 8 (g, v, r, k, o, gate, up, down) + 8
# attention layers x 7, 2 draws an attention layer; rwkv 32 x (5 time-mix
# + 2 channel-mix), no attention; paligemma 18 x 7 (prefix_proj clean);
# whisper's prefill encoder 32 x 6, cross k/v 32 x 2, decoder 32 x 8 and
# its decode step the decoder alone, 2 draws an encoder layer and 4 a
# decoder layer (self + cross) at prefill, 4 a decoder layer a step
FAMILY_LAUNCHES = {
    "recurrentgemma_2b": {"prefill": (200, 16), "decode": (200, 16)},
    "rwkv6_3b": {"prefill": (224, 0), "decode": (224, 0)},
    "paligemma_3b": {"prefill": (126, 36), "decode": (126, 36)},
    "whisper_large_v3": {"prefill": (512, 192), "decode": (256, 128)},
}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 2, 16, 8
FAMILY_PEAK_LIMIT = 20e9       # bytes: each model alone (~6 GB of bf16 weights)


def family_extras(cfg, lead: tuple, seed: int) -> dict:
    """The family's extra input (frames for enc-dec, prefix embeddings
    for a VLM, nothing otherwise) of shape ``lead + extra_shape``, drawn
    with numpy from ``seed``."""
    import numpy as np
    from repro_torch.models import family
    name = family.extra_name(cfg)
    if name is None:
        return {}
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=lead + family.extra_shape(cfg)).astype(
        np.float32)}


def family_reduced_vs_cpu(arch, dev) -> dict:
    """Greedy tokens of the reduced model on the card's kernel route
    against the port on the CPU, single device and a 3-lane fleet, at BER
    1e-3 (fleet lanes 1e-3 / 0 / 3e-3) on every domain of the family."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.resilience import operators_for
    from repro_torch.data import SyntheticLM
    from repro_torch.models import family
    from repro_torch.serve.engine import FleetServeEngine, ServeEngine
    from repro_torch.tree import tree_map
    small = get_config(arch).reduced()
    ops = operators_for(small.family)
    p_cpu = family.init_params(small, 1, __import__("torch").float32, "cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    prompts = SyntheticLM(vocab=small.vocab, seq_len=12,
                          global_batch=6).batch_at(0).tokens
    ex = family_extras(small, (6,), 3)
    out = {}
    for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        single = ServeEngine(small, p, runtime=_Forced(1e-3, ops),
                             max_len=32, use_systolic_kernel=True, seed=5,
                             device=d).generate(
            prompts[:2], 6, **{k: v[:2] for k, v in ex.items()}).tokens
        fleet = FleetServeEngine(
            small, p, _ForcedFleet([1e-3, 0.0, 3e-3], ops), max_len=32,
            use_systolic_kernel=True, seed=5, device=d).generate(
            prompts, 6, **ex).tokens
        out[name] = (single, fleet)
    for i, what in enumerate(("single", "3-lane fleet")):
        check(np.array_equal(out["cuda"][i], out["cpu"][i]),
              f"reduced {arch} {what}: card tokens {out['cuda'][i].tolist()}"
              f" != CPU tokens {out['cpu'][i].tolist()}")
    return {"single": out["cuda"][0].tolist(),
            "fleet": out["cuda"][1].tolist(), "equal_to_cpu": True}


def family_sweep_vs_cpu(arch, dev) -> dict:
    """``run_sweep`` of the reduced model with its extra input over
    ``QUICK_BER_GRID`` x the family's domains on the fused route: the
    card's loss surface equals the CPU's."""
    import numpy as np
    import torch
    from repro_torch.calibrate import resilience_sweep as rs
    from repro_torch.configs import get_config
    from repro_torch.models import family
    from repro_torch.tree import tree_map
    small = get_config(arch).reduced()
    p_cpu = family.init_params(small, 2, torch.float32, "cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = np.random.default_rng(4).integers(0, small.vocab, (2, 12))
    extras = tuple(family_extras(small, (2,), 5).values())
    t0 = time.perf_counter()
    surf = {name: rs.run_sweep(small, p, tokens, ber_grid=rs.QUICK_BER_GRID,
                               n_seeds=1, extras=extras, use_kernel=True,
                               fused=True, device=d).loss_pct
            for name, p, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, "cpu"))}
    check(np.array_equal(surf["cuda"], surf["cpu"]),
          f"{arch} sweep with extras: card {surf['cuda'].tolist()} != CPU "
          f"{surf['cpu'].tolist()}")
    return {"lanes": int(surf["cuda"].size), "seconds":
            time.perf_counter() - t0, "loss_pct": surf["cuda"].tolist()}


def family_fleet(dev, cfg, params, max_len: int, single_counts) -> dict:
    """A 4-lane ``FleetServeEngine`` (``FleetRuntime.for_model`` aged
    ``FLEET_AGES``) at full width: lane-mode launches a forward equal to
    one device's, every lane equal to its single-lane replay."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import steps
    from repro_torch.serve.engine import FleetServeEngine
    N, B, S, T = len(FLEET_AGES), FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS
    fleet = FleetRuntime.for_model(cfg, n_devices=N, device=dev)
    for i, age in enumerate(FLEET_AGES):
        fleet.set_age(years=age, device=i)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=N * B).batch_at(1).tokens \
        .reshape(N, B, S)
    ex = family_extras(cfg, (N, B), 11)
    make = lambda: FleetServeEngine(cfg, params, fleet, max_len=max_len,
                                    use_systolic_kernel=True, device=dev)
    make().generate(prompts, 2, **ex)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = make()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, T, **ex)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(counts["fused_aged_matmul_lanes"] == single_counts[
        "fused_aged_matmul"] and counts["bitflip_draw_lanes"]
        == single_counts["bitflip_draw"] and counts["fused_aged_matmul"]
        == 0 and counts["bitflip_draw"] == 0,
        f"{cfg.name} fleet launches {counts} != one device's "
        f"{single_counts}")
    _, call_key = prandom.split(prandom.PRNGKey(0))
    fi = eng._fleet_fault_config(call_key)
    keys = prandom.split(prandom.fold_in(call_key, 1), N)
    diverged = []
    for i in range(N):
        lane_ex = {k: torch.as_tensor(v[i], device=dev)
                   for k, v in ex.items()}
        toks = steps.generate(params, cfg, torch.as_tensor(
            prompts[i], device=dev), fi.lane(i), keys[i], max_len=max_len,
            n_steps=T, **lane_ex)[0]
        diverged += [(i, b, t) for b in range(B) for t in range(T)
                     if toks[b, t] != res.tokens[i, b, t]]
    check(not diverged, f"{cfg.name} fleet lanes != single-lane replay at "
          f"(lane, row, step) {diverged[:8]}")
    return {"ages": list(FLEET_AGES), "generate_s": gen_s,
            "prefill_s": res.timings["prefill_s"],
            "decode_s_per_token": res.timings["decode_s"] / (T - 1),
            "tokens_per_s": N * B * T / gen_s, "peak_gb": peak / 1e9,
            "launches": counts, "lanes_equal_replay": True,
            "tokens": res.tokens.tolist()}


def family_run(dev, arch) -> dict:
    """One family at its full published config: B = 2, prompt 16, 8
    greedy tokens on a device aged 9 years (fused route), launches, host
    syncs, a profiled prefill + decode step, ``score``, the family's long
    prompt, a 4-lane fleet; then the reduced model on the card against
    the CPU."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.fleet import FleetRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.models import family
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    B, S, T = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS
    max_len = cfg.prefix_tokens + S + T + 8
    t0 = time.perf_counter()
    params = family.init_params(cfg, 0, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init_s = time.perf_counter() - t0
    rt = FleetRuntime.for_model(cfg, n_devices=1, device=dev)
    rt.set_age(years=9.0)
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=S,
                          global_batch=B).batch_at(0).tokens
    ex = family_extras(cfg, (B,), 7)
    make = lambda: ServeEngine(cfg, params, runtime=rt, max_len=max_len,
                               use_systolic_kernel=True, device=dev)
    make().generate(prompts, 2, **ex)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = make()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, T, **ex)
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_path = kernels.launch_counts_by_path()
    peak = torch.cuda.max_memory_allocated(dev)
    per = FAMILY_LAUNCHES[arch]
    want = tuple(per["prefill"][j] + (T - 1) * per["decode"][j]
                 for j in (0, 1))
    tok = out.tokens
    check(tok.shape == (B, T) and bool(((tok >= 0) & (tok < cfg.vocab))
                                       .all()), f"{arch} tokens {tok}")
    check((counts["fused_aged_matmul"], counts["bitflip_draw"]) == want,
          f"{arch} launches {counts} != counted (fused, draw) {want}")
    check(by_path["fused_aged_matmul"] == {"fast": want[0], "generic": 0},
          f"{arch} GEMM launches off the fast path: {by_path}")
    check(peak < FAMILY_PEAK_LIMIT, f"{arch} peak {peak / 1e9:.2f} GB")
    run = {"params_b": n_params / 1e9, "init_s": init_s, "batch": B,
           "prompt": S, "n_steps": T, "max_len": max_len,
           "generate_s": gen_s, "prefill_s": out.timings["prefill_s"],
           "decode_s_per_token": out.timings["decode_s"] / (T - 1),
           "tokens_per_s": B * T / gen_s, "peak_gb": peak / 1e9,
           "launches": counts, "launches_per_forward": per,
           "tokens": tok.tolist()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nll = eng.score(np.concatenate([prompts, tok], axis=1), **ex)
    run["score_s"] = time.perf_counter() - t0
    run["score_nll"] = nll
    score_counts = kernels.launch_counts()
    check(math.isfinite(nll) and nll > 0, f"{arch} score {nll}")
    check((score_counts["fused_aged_matmul"], score_counts["bitflip_draw"])
          == per["prefill"], f"{arch} score launches {score_counts}")
    run["host_syncs"] = decode_syncs(eng, prompts, **ex)
    want_gemm = per["prefill"][0] + per["decode"][0]
    prof = profile_generate(eng, prompts, want_gemm, **ex)
    prof["other_device_ms"] = prof["device_busy_ms"] - prof["gemm_device_ms"]
    run["profile"] = prof
    # the family's long prompt
    long = {"recurrentgemma_2b": (1, 2064), "rwkv6_3b": (B, 300)}.get(arch)
    if long is not None:
        lb, ls = long
        lp = np.random.default_rng(8).integers(0, cfg.vocab, (lb, ls))
        leng = ServeEngine(cfg, params, runtime=rt, max_len=ls + T,
                           use_systolic_kernel=True, device=dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lo = leng.generate(lp, T)
        lc = kernels.launch_counts()
        check(lc["fused_aged_matmul"] == want[0] and lc["bitflip_draw"]
              == want[1], f"{arch} long-prompt launches {lc}")
        check(lo.tokens.shape == (lb, T), f"{arch} long tokens")
        run["long_prompt"] = {
            "batch": lb, "prompt": ls, "generate_s": time.perf_counter() - t0,
            "prefill_s": lo.timings["prefill_s"],
            "decode_s_per_token": lo.timings["decode_s"] / (T - 1),
            "tokens": lo.tokens.tolist(), "launches": lc}
        if cfg.window:
            run["long_prompt"]["window"] = cfg.window
            run["long_prompt"]["ring_wraps"] = ls + T - 1 >= cfg.window
        del leng
    run["fleet"] = family_fleet(dev, cfg, params, max_len, counts)
    del eng, params
    torch.cuda.empty_cache()
    run["reduced_vs_cpu"] = family_reduced_vs_cpu(arch, dev)
    return run


def launch_dev_ms(fn, match, iters: int = 20):
    """Device time of one kernel launch of ``fn()`` (those whose name holds
    ``match``; every kernel with ``None``), averaged over the launches the
    profiler recorded in ``iters`` calls (it drops some in a long run);
    ``None`` if it recorded none."""
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
    n = sum(e.count for e in evs)
    return sum(_dev_us(e) for e in evs) / 1e3 / n if n else None


def recurrence_ms(dev) -> dict:
    """Device time (CUDA events) of the two recurrences, plain PyTorch as
    in the reference, at the full-width shapes [12] runs: the RG-LRU scan
    over (B, S, 2560) at the prompt of 16 (B=2) and 2,064 (B=1) tokens, and
    the WKV chunk loop over (2, S, 40, 64) at 16 and 300 tokens (zero-padded
    to one and three 128-token chunks)."""
    import torch
    from repro_torch.models import rglru, rwkv6
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.rand(shape, device=dev, generator=gen)
    out = {}
    for B, S in ((2, 16), (1, 2064)):
        a, x, h0 = rnd(B, S, 2560) * 0.5 + 0.5, rnd(B, S, 2560), rnd(B, 2560)
        out[f"rglru_scan_B{B}_S{S}"] = cuda_time_ms(
            lambda: rglru._rglru_scan(x, a, h0), iters=10)
    for S in (16, 300):
        Sp = -(-S // 128) * 128
        r, k, v = (rnd(2, Sp, 40, 64) for _ in range(3))
        w = -(rnd(2, Sp, 40, 64) * 0.25)
        u, s0 = rnd(40, 64) * 0.1, rnd(2, 40, 64, 64)
        out[f"chunked_wkv_S{S}"] = cuda_time_ms(
            lambda: rwkv6._chunked_wkv(r, k, v, w, u, 128, s0), iters=10)
    return out


def family_kernel_rows(dev) -> dict:
    """The kernels at the shapes this phase's models add: the fused GEMM
    at every family's projections, prefill and decode, each K-split plan
    among them (recurrentgemma and rwkv at K 2,560 / 7,680 / 8,960 with
    N 256 to 8,960, the long prompts' 2,064 and 300 rows, paligemma's
    prefill M = 544 and its K 16,384 down projection, whisper's encoder
    M = 3,000 and its decoder at K 1,280 / 5,120); its lane mode at
    whisper's 4-lane encoder (4 x 3,000 rows, K 1,280 and 5,120); the
    draw over whisper's encoder qkt words (2 x 20 x 1,500^2 = 90 M).
    Each bit-exact against its plain version (the lane mode also against
    4 single-lane launches), on the fast path, timed beside its bound and
    ``torch._int_mm`` on a column-major ``b``."""
    import torch
    from repro_torch import kernels
    from repro_torch import random as prandom
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.bitflip import bitflip_draw
    from repro_torch.kernels.fused_aged_matmul import (
        fused_aged_matmul, fused_aged_matmul_lanes, upset_probability)
    gen = torch.Generator(device=dev).manual_seed(2024)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ber, q = 1e-3, upset_probability(1e-3)
    rows = {"fused_aged_matmul": [], "bitflip_draw": []}
    for model, M, K, N, what in (
            ("recurrentgemma_2b", 32, 2560, 256, "k/v (MQA)"),
            ("recurrentgemma_2b", 32, 2560, 2560, "q, rec g/v/r/k/o"),
            ("recurrentgemma_2b", 32, 2560, 7680, "gate/up"),
            ("recurrentgemma_2b", 32, 7680, 2560, "down"),
            ("recurrentgemma_2b", 2064, 7680, 2560, "down, long prompt"),
            ("rwkv6_3b", 32, 2560, 8960, "up"),
            ("rwkv6_3b", 32, 8960, 2560, "down"),
            ("rwkv6_3b", 300, 8960, 2560, "down, 300-token prompt"),
            ("paligemma_3b", 544, 2048, 16384, "gate/up prefill"),
            ("paligemma_3b", 544, 16384, 2048, "down prefill"),
            ("paligemma_3b", 2, 16384, 2048, "down decode"),
            ("whisper_large_v3", 3000, 1280, 1280, "encoder q/k/v/o"),
            ("whisper_large_v3", 3000, 1280, 5120, "encoder up"),
            ("whisper_large_v3", 3000, 5120, 1280, "encoder down"),
            ("whisper_large_v3", 2, 1280, 1280, "decoder q/k/v/o decode"),
            ("whisper_large_v3", 2, 5120, 1280, "decoder down decode")):
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                          generator=gen)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                          generator=gen)
        xs = torch.rand((M, 1), device=dev, generator=gen) * 0.01 + 1e-3
        ws = torch.rand((1, N), device=dev, generator=gen) * 0.01 + 1e-3
        bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
        plan = _cuda.gemm_plan(M, N, K, n_sms)
        kernels.reset_launch_counts()
        out = fused_aged_matmul(a, b, xs, ws, ber, 77, bm=bm, bn=bn)
        exp = ref.fused_aged_matmul_ref(a, b, xs, ws, ber, 77, bm=bm, bn=bn)
        torch.cuda.synchronize()
        err = max_abs_err(out, exp)
        check(torch.equal(out, exp), f"fused_aged_matmul M={M} K={K} N={N}:"
              f" max |err| {err}")
        by_path = kernels.launch_counts_by_path()["fused_aged_matmul"]
        check(by_path == {"fast": 1, "generic": 0},
              f"GEMM M={M} K={K} N={N} off the fast path: {by_path}")
        bs = itertools.cycle([b] + [b.clone() for _ in range(
            -(-120_000_000 // b.numel()) - 1)])
        fk = lambda: fused_aged_matmul(a, next(bs), xs, ws, ber, 77, bm=bm,
                                       bn=bn)
        b_cm = b.t().contiguous().t()              # column-major b
        lk = lambda: torch._int_mm(a, b_cm)
        int_mm = M > 16                  # _int_mm takes more than 16 rows
        dev_ms = launch_dev_ms(fk, "int8_gemm")
        t_b, by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                        2.0 * M * K * N)
        rows["fused_aged_matmul"].append(dict(
            model=model, op=what, M=M, K=K, N=N, max_abs_err=err,
            plan={"path": plan.path, "bm": plan.bm, "bn": plan.bn,
                  "splits": plan.splits, "ctas": plan.ctas},
            ms=cuda_time_ms(fk), dev_ms=dev_ms,
            plain_ms=cuda_time_ms(lambda: ref.fused_aged_matmul_ref(
                a, b, xs, ws, ber, 77, bm=bm, bn=bn), iters=3, warmup=1),
            bound_ms=t_b, bound_by=by, library_ms=None,
            int_mm_colmajor_ms=cuda_time_ms(lk) if int_mm else None,
            int_mm_colmajor_dev_ms=launch_dev_ms(lk, None) if int_mm
            else None))
    rows["fused_aged_matmul_lanes"] = []
    L, Ml = len(LANE_BERS), 3000
    for K, N, what in ((1280, 1280, "encoder q/k/v/o"),
                       (1280, 5120, "encoder up"),
                       (5120, 1280, "encoder down")):
        M = L * Ml
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                          generator=gen)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                          generator=gen)
        xs = torch.rand((M, 1), device=dev, generator=gen) * 0.01 + 1e-3
        ws = torch.rand((1, N), device=dev, generator=gen) * 0.01 + 1e-3
        seeds = [int(v) for v in torch.randint(
            -2 ** 31, 2 ** 31 - 1, (L,), generator=gen, device=dev)]
        bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
        lanes = lambda xs_, ws_: fused_aged_matmul_lanes(
            a, b, xs_, ws_, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn)
        err = 0.0
        for kind, (xs_, ws_) in (("float32", (xs, ws)),
                                 ("int32", (None, None))):
            kernels.reset_launch_counts()
            got = lanes(xs_, ws_)
            counts = kernels.launch_counts_by_path()[
                "fused_aged_matmul_lanes"]
            plain = ref.fused_aged_matmul_lanes_ref(
                a, b, xs_, ws_, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn)
            one = torch.cat([fused_aged_matmul(
                a[l * Ml:(l + 1) * Ml], b,
                None if xs_ is None else xs_[l * Ml:(l + 1) * Ml], ws_,
                LANE_BERS[l], seeds[l], bm=bm, bn=bn) for l in range(L)])
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, plain))
            check(torch.equal(got, plain) and torch.equal(got, one),
                  f"fused_aged_matmul_lanes M={L}x{Ml} K={K} N={N} {kind}: "
                  f"max |err| {max_abs_err(got, plain)}, == single-lane "
                  f"launches {torch.equal(got, one)}")
            check(counts == {"fast": 1, "generic": 0},
                  f"lane GEMM M={L}x{Ml} K={K} N={N} off the fast path: "
                  f"{counts}")
            del plain, one
        fk = lambda: lanes(xs, ws)
        t_b, by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                        2.0 * M * K * N)
        rows["fused_aged_matmul_lanes"].append(dict(
            model="whisper_large_v3", op=what, M=M, lanes=L, M_lane=Ml, K=K,
            N=N, max_abs_err=err, ms=cuda_time_ms(fk),
            dev_ms=launch_dev_ms(fk, "int8_gemm"),
            plain_ms=cuda_time_ms(lambda: ref.fused_aged_matmul_lanes_ref(
                a, b, xs, ws, LANE_BERS, seeds, lanes=L, bm=bm, bn=bn),
                iters=2, warmup=1),
            bound_ms=t_b, bound_by=by, library_ms=None))
        del a, b, xs, ws
    int_rate = int32_issue_per_s(dev)
    shape = (2, 20, 1, 1500, 1500)
    n = math.prod(shape)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                      device=dev, generator=gen)
    words = ops.flip_key_words(prandom.PRNGKey(n))
    out = bitflip_draw(x, words, q)
    exp = ref.bitflip_draw_ref(x, words, q)
    torch.cuda.synchronize()
    err = max_abs_err(out, exp)
    check(torch.equal(out, exp), f"bitflip_draw n={n}: max |err| {err}")
    flips = int((out != x).sum())
    del exp
    bk = lambda: bitflip_draw(x, words, q)
    dev_ms = launch_dev_ms(bk, "bitflip_draw", iters=5)
    int_ops = THREEFRY_INT_OPS * (n + flips)
    t_b, by = bound(8 * n, int_ops=int_ops, int_rate=int_rate)
    rows["bitflip_draw"].append(dict(
        model="whisper_large_v3", op="encoder qkt", n=n, shape=list(shape),
        flips=flips, max_abs_err=err, ms=cuda_time_ms(bk, iters=5),
        dev_ms=dev_ms, plain_ms=cuda_time_ms(
            lambda: ref.bitflip_draw_ref(x, words, q), iters=2, warmup=1),
        bound_ms=t_b, bound_by=by, library_ms=None))
    del x, out
    torch.cuda.empty_cache()
    return rows


def families_phase(dev) -> dict:
    """[12] the four families at their full published configs, then the
    reduced sweeps with extras, then the kernels at the new shapes."""
    import torch
    from repro_torch import kernels
    t_phase = time.perf_counter()
    res = {"runs": {}}
    totals = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        run = family_run(dev, arch)
        run["phase_s"] = time.perf_counter() - t0
        res["runs"][arch] = run
        for part in (run["launches"], run["fleet"]["launches"]):
            for k in totals:
                totals[k] += part[k]
        prof = run["profile"]
        print(f"[12] {arch} full config ({run['params_b']:.2f} B bf16 "
              f"params, init {run['init_s']:.1f} s), age 9 y, B=2, prompt "
              f"16, 8 tokens: launches {run['launches']['fused_aged_matmul']}"
              f" fused + {run['launches']['bitflip_draw']} draw (as counted:"
              f" {run['launches_per_forward']}); tokens {run['tokens']}",
              flush=True)
        print(f"    {arch} prefill {run['prefill_s'] * 1e3:.1f} ms, decode "
              f"{run['decode_s_per_token'] * 1e3:.1f} ms/token, "
              f"{run['tokens_per_s']:.2f} tokens/s, peak "
              f"{run['peak_gb']:.2f} GB, busy "
              f"{100 * prof['device_busy_share']:.1f}% over "
              f"{prof['n_kernel_launches']} launches a prefill + decode "
              f"step (int8 GEMM {prof['gemm_device_ms']:.2f} ms, the rest "
              f"{prof['other_device_ms']:.2f} ms), score "
              f"{run['score_nll']:.4f} in {run['score_s'] * 1e3:.1f} ms, "
              f"host syncs 2 / 8 tokens "
              f"{run['host_syncs']['generate_2_tokens']} / "
              f"{run['host_syncs']['generate_8_tokens']}", flush=True)
        if "long_prompt" in run:
            lp = run["long_prompt"]
            ring = (f" (window {lp['window']}, ring wraps)"
                    if lp.get("window") else "")
            print(f"    {arch} long prompt B={lp['batch']} S={lp['prompt']}"
                  f"{ring}:"
                  f" prefill {lp['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{lp['decode_s_per_token'] * 1e3:.1f} ms/token",
                  flush=True)
        fl = run["fleet"]
        print(f"    {arch} 4-lane fleet (ages {fl['ages']}): lanes == "
              f"replay, launches {fl['launches']['fused_aged_matmul_lanes']}"
              f" lane GEMM + {fl['launches']['bitflip_draw_lanes']} lane "
              f"draw (one device's), prefill {fl['prefill_s'] * 1e3:.1f} "
              f"ms, decode {fl['decode_s_per_token'] * 1e3:.1f} ms/token, "
              f"{fl['tokens_per_s']:.2f} tokens/s, peak {fl['peak_gb']:.2f}"
              f" GB; reduced model card == CPU (single and 3 lanes); "
              f"{run['phase_s']:.1f} s", flush=True)
    for arch in ("paligemma_3b", "whisper_large_v3"):
        sw = family_sweep_vs_cpu(arch, dev)
        res["runs"][arch]["sweep_vs_cpu"] = sw
        print(f"    {arch} reduced run_sweep with extras ({sw['lanes']} "
              f"lanes, fused route): card == CPU ({sw['seconds']:.1f} s)",
              flush=True)
    res["recurrence_ms"] = recurrence_ms(dev)
    print("    recurrences a layer (plain PyTorch, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in res["recurrence_ms"].items()),
        flush=True)
    res["kernel_rows"] = family_kernel_rows(dev)
    us = lambda v: "n/a" if v is None else f"{v * 1e3:.1f}"
    for r in res["kernel_rows"]["fused_aged_matmul"]:
        print(f"    fused_aged_matmul M={r['M']} K={r['K']} N={r['N']} "
              f"{r['model'][:11]} {r['op']}: {r['ms'] * 1e3:.1f} us a call "
              f"(dev {us(r['dev_ms'])} us), bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), _int_mm "
              f"(column-major b) {us(r['int_mm_colmajor_ms'])} us "
              f"(dev {us(r['int_mm_colmajor_dev_ms'])}), plain "
              f"{r['plain_ms']:.3f} ms; plan {r['plan']}", flush=True)
    for r in res["kernel_rows"]["fused_aged_matmul_lanes"]:
        print(f"    fused_aged_matmul_lanes M={r['lanes']}x{r['M_lane']} "
              f"K={r['K']} N={r['N']} ({r['op']}): {r['ms'] * 1e3:.1f} us a "
              f"call (dev {us(r['dev_ms'])} us), bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms", flush=True)
    for r in res["kernel_rows"]["bitflip_draw"]:
        dev_us = ("n/a" if r["dev_ms"] is None
                  else f"{r['dev_ms'] * 1e3:.1f}")
        print(f"    bitflip_draw n={r['n']} ({r['op']}): "
              f"{r['ms'] * 1e3:.1f} us a call (dev {dev_us}"
              f" us), bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), "
              f"plain {r['plain_ms']:.1f} ms", flush=True)
    res["launches"] = totals
    res["seconds"] = time.perf_counter() - t_phase
    print(f"    [12] done in {res['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return res


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
    from repro_torch.obs.taps import enable_taps
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import leaves

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
    # qwen3_moe_235b at its published widths: the reference config leaves
    # head_dim unset (d_model // n_heads = 64); the released model's is 128
    moe_cfg = dataclasses.replace(get_config("qwen3_moe_235b"), head_dim=128)
    # 3. kernels vs plain versions -----------------------------------------
    t0 = time.perf_counter()
    rows = kernel_checks(dev, cfg, moe_cfg)
    rows.update(lane_kernel_checks(dev, cfg, moe_cfg))
    report["kernel_checks"] = rows
    print(f"[3] kernels bit-exact vs plain versions at main-path shapes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
    for name, rs in rows.items():
        if name.endswith("_lanes"):
            continue                 # printed below, beside 4 single lanes
        for r in rs:
            yard = r.get("int_mm_ms", r["library_ms"])
            yard_dev = r.get("int_mm_dev_ms", r.get("library_dev_ms"))
            where = f"{r.get('model', '')[:5]} {r.get('op')}"
            dims = (f"M={r['M']} K={r['K']} N={r['N']}" if "M" in r
                    else f"R={r['R']}" if "R" in r else f"n={r['n']}")
            mode1 = (f" (mode 1 {r['dev_ms_mode1']:.4f})"
                     if "dev_ms_mode1" in r else "")
            print(f"    {name:18s} {dims:24s} {where:28s} "
                  f"kernel {r['ms']:.4f} ms, dev {r['dev_ms']:.4f}{mode1}  "
                  f"plain {r['plain_ms']:.4f}  bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})  _int_mm {fmt(yard)}, dev "
                  f"{fmt(yard_dev)}")
    for name in ("fused_aged_matmul_lanes", "bitflip_draw_lanes"):
        for r in rows[name]:
            dims = (f"M={r['lanes']}x{r['M_lane']} K={r['K']} N={r['N']}"
                    if "M" in r else f"n={r['lanes']}x{r['n_lane']}")
            print(f"    {name:23s} {dims:24s} {r['model'][:5]} "
                  f"{r['op']:12s} dev "
                  f"{r['dev_ms'] * 1e3:.2f} us (4 single-lane launches "
                  f"{r['singles_dev_ms'] * 1e3:.2f} us) bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); wrapper "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms",
                  flush=True)
    for r in rows["bitflip_draw"]:
        print(f"    bitflip_draw n={r['n']:<7d} {r['op']:12s} inject_bitflips "
              f"{r['inject_ms']:.4f} ms; dev {r['dev_ms'] * 1e3:.2f} us vs "
              f"bound {r['bytes_bound_ms'] * 1e3:.2f} us bytes / "
              f"{r['int_bound_ms'] * 1e3:.2f} us INT32 issue; old flow "
              f"{r['old_flow_ms']:.4f} ms, dev {r['old_flow_dev_ms']:.4f} ms "
              f"over {r['old_flow_kernels']:.0f} kernels", flush=True)
    for r in rows["fused_aged_matmul"]:
        p = r["plan"]
        print(f"    plan M={r['M']} {r['model'][:5]} {r['op']:8s}: "
              f"{p['path']} path, "
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
    n_params = sum(t.numel() for t in leaves(params))
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
    with enable_taps():             # the checks below read the taps
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
    want_flip = 2 * L * n_steps      # qkt and sv of every layer and forward
    check(counts["fused_aged_matmul"] == want_fused,
          f"fused_aged_matmul launches {counts} != {want_fused}")
    check(counts["bitflip_draw"] == want_flip,
          f"bitflip_draw launches {counts} != {want_flip}")
    check(counts["bitflip_words"] == 0, f"bitflip_words launches {counts}")
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
    check(prof["threefry_chain_launches"] == 0,
          f"threefry elementwise kernels in the step: "
          f"{prof['threefry_chain_kernels']}")
    print(f"    launches per prefill + decode step {prof['n_kernel_launches']}"
          f" ({counts['bitflip_draw'] // n_steps} bitflip_draw per forward); "
          f"device busy {100 * prof['device_busy_share']:.1f}%; decode "
          f"{per_tok * 1e3:.1f} ms/token; no threefry elementwise kernel",
          flush=True)
    print(f"    int8 GEMM (fused) device time in that profile: "
          f"{prof['gemm_device_ms']:.2f} ms over {prof['gemm_launches']} of "
          f"{7 * L * 2} launches (profile "
          f"{'complete' if prof['complete'] else 'INCOMPLETE'}, attempt "
          f"{prof['attempts']})", flush=True)
    report["host_syncs"] = decode_syncs(engine, prompts)
    print(f"    host syncs of generate at 2 / 8 tokens: "
          f"{report['host_syncs']['generate_2_tokens']} / "
          f"{report['host_syncs']['generate_8_tokens']} (none in a decode "
          f"step)", flush=True)
    del engine

    # reduced model: the card's kernel route vs the port on the CPU
    report["reduced_vs_cpu"] = reduced_vs_cpu(cfg.reduced(), dev)
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
    check(counts3["bitflip_draw"] == 9 * L3 * 2
          and counts3["bitflip_words"] == 0,
          f"three-pass bitflip launches {counts3}")
    check(counts3["fused_aged_matmul"] == 0, f"fused launches {counts3}")
    check(by_path3["systolic_matmul"] == {"fast": 7 * L3 * 2, "generic": 0},
          f"three-pass GEMM launches off the fast path: {by_path3}")
    report["three_pass"] = {"layers": L3, "launches": counts3,
                            "generate_s": time.perf_counter() - t0}
    print(f"[5] three-pass route, {L3} layers, 2 tokens: launches "
          f"{counts3}", flush=True)
    del params3
    torch.cuda.empty_cache()

    # 6. fleet path, on [4]'s params ----------------------------------------
    report["fleet"] = fleet_phase(dev, cfg_run, params, serve)
    fleet_counts = report["fleet"]["launches"]

    # 6b. traffic-aged fleet, still on [4]'s params ---------------------------
    report["fleet_load"] = fleet_load_phase(dev, cfg_run, params,
                                            report["fleet"])
    load_counts = report["fleet_load"]["launches"]
    del params
    torch.cuda.empty_cache()

    # 7. MoE path ------------------------------------------------------------
    report["moe"], moe_params, moe_run = moe_phase(dev, moe_cfg)
    moe_counts = report["moe"]["launches"]

    # 8. MoE fleet, on [7]'s params -------------------------------------------
    report["moe_fleet"] = moe_fleet_phase(dev, moe_run, moe_params,
                                          report["moe"])
    moe_fleet_counts = report["moe_fleet"]["launches"]
    check(report["moe_fleet"]["profile"]["bmm_calls"]
          == report["moe"]["profile"]["bmm_calls"],
          f"aten::bmm calls a fleet step "
          f"{report['moe_fleet']['profile']['bmm_calls']} != one device's "
          f"{report['moe']['profile']['bmm_calls']}")
    del moe_params
    torch.cuda.empty_cache()
    report["moe"]["reduced_vs_cpu"] = moe_reduced_vs_cpu(dev)
    report["moe_fleet"]["reduced_vs_cpu"] = moe_fleet_reduced_vs_cpu(dev)

    # 9. the paper's tables ---------------------------------------------------
    report["paper_tables"] = paper_tables_phase(dev)

    # 10. training, after every earlier phase's params are freed -------------
    report["train"], trained, cfg8 = train_phase(dev, cfg)
    train_counts = report["train"]["launches"]

    # 10b. measured resilience on [10]'s trained params --------------------
    report["resilience"] = resilience_phase(dev, cfg8, trained)
    resilience_counts = report["resilience"]["launches"]
    del trained
    torch.cuda.empty_cache()

    # 12. the hybrid, SSM, VLM and enc-dec families ----------------------
    report["families"] = families_phase(dev)
    family_counts = report["families"]["launches"]

    # 11. summary ---------------------------------------------------------
    # launches summed over the eight paths' runs, each counted from 0; the
    # explicit-randoms bitflip_words is on no path any more: it stays the
    # Pallas kernel's counterpart signature for signature, held against
    # its plain version in [3], with 0 launches on the paths
    launches = {name: main_counts[name] + counts3[name] + fleet_counts[name]
                + load_counts[name] + moe_counts[name]
                + moe_fleet_counts[name] + train_counts[name]
                + resilience_counts[name] + family_counts[name]
                for name in kernels.KERNEL_NAMES}
    # the representative shape of each kernel: the decode weight matmul
    # that dominates the fused route (gate/up, M = 2; 4 x 2 in lane mode),
    # the prefill gate/up GEMM (M = 32, where torch._int_mm computes the
    # same function) and the prefill sv words (x 4 in lane mode)
    pick = {"fused_aged_matmul": lambda r: r["M"] == 2
            and r["op"] == "gate/up" and r["model"] == "llama3_8b",
            "fused_aged_matmul_lanes": lambda r: r["M"] == 8
            and r["op"] == "gate/up",
            "systolic_matmul": lambda r: r["M"] == 32
            and r["op"] == "gate/up" and r["model"] == "llama3_8b",
            "bitflip_draw": lambda r: r["n"] == 131072,
            "bitflip_draw_lanes": lambda r: r["n"] == 4 * 131072,
            "bitflip_words": lambda r: r["R"] == 1024}
    line = []
    for name in ("fused_aged_matmul", "fused_aged_matmul_lanes",
                 "bitflip_draw", "bitflip_draw_lanes", "bitflip_words",
                 "systolic_matmul"):
        r = next(r for r in rows[name] if pick[name](r))
        line.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": JAX_KERNELS[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dev_ms": r["dev_ms"],
            "on_main_path": name != "bitflip_words", "ok": True,
            "shape": {k: r[k] for k in ("M", "K", "N", "R", "n") if k in r}})
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
    """A runtime that admits one BER on every operator domain (the MoE
    router's included, unless ``operators`` names others)."""
    age_years = 9.0

    def __init__(self, ber: float, operators=(*TABLE2, "router")):
        self.ber, self.operators = ber, tuple(operators)

    def op_bers(self):
        return {op: self.ber for op in self.operators}

    def total_power(self) -> float:
        return 0.0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
