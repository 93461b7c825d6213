"""Benchmark: the port's CUDA kernels at the serving paths' shapes (the
counterpart of the reference's ``benchmarks/kernel_bench.py``, which
reports Pallas BlockSpec structure; that has no meaning on a GPU).

For each shape of a fixed list, one row:

* the launch plan of :func:`repro_torch.kernels._cuda.gemm_plan` (path,
  CTA tile, K splits, CTAs);
* the bound: the larger of the bytes the call must move (each input read
  once, each output written once) over 3.35 TB/s and its operations over
  their peak (int8 tensor cores 1,979 TOP/s; the draw's threefry hashes
  as INT32 instructions, 64 a clock on each SM);
* on a card, the time through the wrapper (CUDA events over back-to-back
  calls that read the weight cold, host cost included) and the device
  time (CUDA events over back-to-back calls queued behind a spin kernel,
  so the host's launch cost is hidden);
* ``torch._int_mm`` on a column-major ``b`` where M > 16 (the GEMM alone,
  the nearest single PyTorch call; no PyTorch call upsets accumulators);
* a bit-for-bit check against the kernel's plain version, and the plain
  version's time (CUDA events, that one call).

The list: the fused GEMM (mode 2: upsets + dequant) at every weight
matmul shape of llama3_8b, qwen3_moe_235b (head_dim 128) and the hybrid,
SSM, VLM and enc-dec models (recurrentgemma_2b, rwkv6_3b, paligemma_3b,
whisper_large_v3) at M = 2, 8, 32, 128, 544 and 3,000 rows (8 and 128:
the online slots' decode and refill, 8 slots of 16-token prompts); its
lane mode at 4 lanes of 2, 4, 32 and 64 rows on llama3_8b's shapes (4 and
64: the online fleet's, 4 slots a lane); the draw-mode bitflip
at the qkt/sv word counts of those paths (and its lane mode at 4 and 32
lanes); and, at one shape, the fused kernel against the three-pass route
it replaces (``systolic_matmul``, then ``bitflip_draw``, then dequant),
both measured.  ``--quick`` runs one GEMM shape and one draw size.

On ``--device cpu`` nothing is timed: the plans (for an H100's 132 SMs),
the bounds, and the wrappers' plain path against the plain versions on
the rows small enough for the CPU.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench
      [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import torch

from .. import kernels
from .. import random as prandom
from ..device import resolve_device
from ..kernels import _cuda, ops, ref
from ..kernels.bitflip import bitflip_draw, bitflip_draw_lanes
from ..kernels.fused_aged_matmul import (fused_aged_matmul,
                                         fused_aged_matmul_lanes,
                                         upset_probability)
from ..kernels.systolic_matmul import systolic_matmul
from .common import report, table

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
INT32_LANES_PER_SM = 64        # Hopper: INT32 instructions per SM per clock
THREEFRY_INT_OPS = 73          # one threefry-2x32 hash: 2 + 20 * 3 + 5 * 2 + 1
H100_SMS = 132                 # the SM count a CPU run plans for
COLD_BYTES = 120_000_000       # weight copies cycled by the timed calls:
#                                more than the 50 MB L2, as serving reads
SPIN_MS = 10.0                 # the spin that hides the host's launch cost
BER = 1e-3
LANE_BERS = (1e-3, 0.0, 3e-3, 1e-2)

# (models, op, K, N) of every faulted weight matmul on the serving paths
GEMM_SHAPES = (
    ("llama3_8b", "q/o", 4096, 4096), ("llama3_8b", "k/v", 4096, 1024),
    ("llama3_8b", "gate/up", 4096, 14336), ("llama3_8b", "down", 14336, 4096),
    ("qwen3_moe_235b", "q", 4096, 8192), ("qwen3_moe_235b", "k/v", 4096, 512),
    ("qwen3_moe_235b", "o", 8192, 4096),
    ("qwen3_moe_235b", "router", 4096, 128),
    ("recurrentgemma_2b", "k/v", 2560, 256),
    ("recurrentgemma_2b, rwkv6_3b", "q, rec / r/k/v/o", 2560, 2560),
    ("recurrentgemma_2b", "gate/up", 2560, 7680),
    ("recurrentgemma_2b", "down", 7680, 2560),
    ("rwkv6_3b", "up", 2560, 8960), ("rwkv6_3b", "down", 8960, 2560),
    ("paligemma_3b", "q/o", 2048, 2048), ("paligemma_3b", "k/v", 2048, 256),
    ("paligemma_3b", "gate/up", 2048, 16384),
    ("paligemma_3b", "down", 16384, 2048),
    ("whisper_large_v3", "q/k/v/o", 1280, 1280),
    ("whisper_large_v3", "up", 1280, 5120),
    ("whisper_large_v3", "down", 5120, 1280),
)
GEMM_MS = (2, 8, 32, 128, 544, 3000)
LANE_MS = (2, 4, 32, 64)       # rows a lane; 4 lanes (the fleets')
# (what, words) of the draw: qkt/sv words of a prefill or decode
DRAW_SIZES = (
    ("llama3_8b qkt decode (2, 8, 4, 1, 64)", 4096),
    ("llama3_8b sv prefill (2, 8, 4, 16, 128)", 131072),
    ("qwen3_moe_235b sv prefill (2, 4, 16, 16, 128)", 262144),
    ("whisper_large_v3 encoder qkt (2, 20, 1500, 1500)", 90_000_000),
)
# (what, lanes, words a lane) of the lane-mode draw
LANE_DRAWS = (("fleet sv prefill", 4, 131072),
              ("fleet qwen3 sv prefill", 4, 262144),
              ("resilience sweep qkt", 32, 1_048_576))
QUICK_GEMM = ("llama3_8b", "gate/up", 4096, 14336)
QUICK_M = 32
# what the CPU checks against the plain versions (the rest on a card)
CPU_PARITY_WORK = 2 ** 28      # M * K * N, or words of a draw


def bound(bytes_moved: float, tc_ops: float = 0.0, int_ops: float = 0.0,
          int_rate: float = 1.0) -> tuple:
    """Least time (ms) for the work and what binds it: the bytes over the
    memory rate, int8 tensor-core operations over their peak, or INT32
    instructions over ``int_rate`` a second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(tc_ops / INT8_OPS_PER_S, int_ops / int_rate) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock_hz(dev) -> float:
    """The card's maximum SM clock (device properties, else nvidia-smi);
    on the CPU an H100 SXM's 1.98 GHz."""
    if dev.type != "cuda":
        return 1.98e9
    import subprocess
    khz = getattr(torch.cuda.get_device_properties(dev), "clock_rate", 0)
    if not khz:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits", "-i",
                              str(dev.index or 0)], capture_output=True,
                             text=True, timeout=60)
        khz = float(smi.stdout.split()[0]) * 1e3
    return khz * 1e3


def int32_issue_per_s(dev) -> float:
    """INT32 instructions a second of the whole card (SMs x 64 x the SM
    clock); on the CPU an H100 SXM's 132 SMs."""
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    return sms * INT32_LANES_PER_SM * sm_clock_hz(dev)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time a call of ``fn()`` over ``iters`` back-to-back calls (CUDA
    events): the device time, or the host cost where that is longer."""
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


def device_ms(fn, clock_hz: float, iters: int = 5):
    """Device time a call of ``fn()``: CUDA events around ``iters``
    back-to-back calls, queued while a spin kernel of SPIN_MS keeps the
    stream busy, so no launch waits for the host.  ``None`` ("not
    measured") when the host took longer to queue them than the spin
    lasted."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_MS * 1e-3 * clock_hz))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if queued_ms < SPIN_MS else None


def _plain(fn, clock):
    """``fn()`` (a plain version) and the ms of that one call by CUDA
    events, or None on the CPU (``clock`` None)."""
    if clock is None:
        return fn(), None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _cold(b: torch.Tensor):
    """A callable handing out ``b`` and copies of it in turn, more bytes
    than the L2 holds."""
    n = max(1, -(-COLD_BYTES // max(b.numel() * b.element_size(), 1)))
    it = itertools.cycle([b] + [b.clone() for _ in range(n - 1)])
    return lambda: next(it)


def _plan(M: int, K: int, N: int, dev) -> dict:
    n_sms = (torch.cuda.get_device_properties(dev).multi_processor_count
             if dev.type == "cuda" else H100_SMS)
    p = _cuda.gemm_plan(M, N, K, n_sms)
    return {"path": p.path, "bm": p.bm, "bn": p.bn, "splits": p.splits,
            "ctas": p.ctas, "sms": n_sms}


def _gemm_operands(M, K, N, dev, gen):
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                      generator=gen)
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                      generator=gen)
    xs = torch.rand((M, 1), device=dev, generator=gen) * 0.01 + 1e-3
    ws = torch.rand((1, N), device=dev, generator=gen) * 0.01 + 1e-3
    return a, b, xs, ws


def _gemm_row(model, op, M, K, N, dev, gen, clock) -> dict:
    """One fused-GEMM row; ``clock`` (the SM clock) is None on the CPU,
    where nothing is timed."""
    row = {"kernel": "fused_aged_matmul", "model": model, "op": op, "M": M,
           "K": K, "N": N, "plan": _plan(M, K, N, dev)}
    row["bound_ms"], row["bound_by"] = bound(
        M * K + K * N + 4 * (M + N) + 4 * M * N, 2.0 * M * K * N)
    if clock is None and M * K * N > CPU_PARITY_WORK:
        return row
    a, b, xs, ws = _gemm_operands(M, K, N, dev, gen)
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    seed = M * 7919 + K * 31 + N
    kernels.reset_launch_counts()
    got = fused_aged_matmul(a, b, xs, ws, BER, seed, bm=bm, bn=bn)
    want, row["plain_ms"] = _plain(lambda: ref.fused_aged_matmul_ref(
        a, b, xs, ws, BER, seed, bm=bm, bn=bn), clock)
    row["exact"] = bool(torch.equal(got, want))
    if clock is None:
        return row
    row["fast_path"] = kernels.launch_counts_by_path()[
        "fused_aged_matmul"] == {"fast": 1, "generic": 0}
    nb = _cold(b)
    call = lambda: fused_aged_matmul(a, nb(), xs, ws, BER, seed, bm=bm,
                                     bn=bn)
    row["ms"] = cuda_time_ms(call)
    row["dev_ms"] = device_ms(call, clock)
    row["library_ms"] = None
    if M > 16:                # torch._int_mm needs more than 16 rows
        nbc = _cold(b.t().contiguous().t())
        row["library_ms"] = cuda_time_ms(lambda: torch._int_mm(a, nbc()))
    return row


def _lane_gemm_row(Ml, model, op, K, N, dev, gen, clock) -> dict:
    L = len(LANE_BERS)
    M = L * Ml
    row = {"kernel": "fused_aged_matmul_lanes", "model": model, "op": op,
           "lanes": L, "M": M, "K": K, "N": N, "plan": _plan(M, K, N, dev)}
    row["bound_ms"], row["bound_by"] = bound(
        M * K + K * N + 4 * (M + N) + 4 * M * N, 2.0 * M * K * N)
    if clock is None and M * K * N > CPU_PARITY_WORK:
        return row
    a, b, xs, ws = _gemm_operands(M, K, N, dev, gen)
    seeds = [Ml * 101 + l for l in range(L)]
    bm, bn, _ = ops._resolve_blocks(Ml, N, K, 256, 256, 256)
    kw = dict(lanes=L, bm=bm, bn=bn)
    got = fused_aged_matmul_lanes(a, b, xs, ws, LANE_BERS, seeds, **kw)
    want, row["plain_ms"] = _plain(lambda: ref.fused_aged_matmul_lanes_ref(
        a, b, xs, ws, LANE_BERS, seeds, **kw), clock)
    row["exact"] = bool(torch.equal(got, want))
    if clock is None:
        return row
    nb = _cold(b)
    call = lambda: fused_aged_matmul_lanes(a, nb(), xs, ws, LANE_BERS,
                                           seeds, **kw)
    row["ms"] = cuda_time_ms(call)
    row["dev_ms"] = device_ms(call, clock)
    row["library_ms"] = None
    if M > 16:
        nbc = _cold(b.t().contiguous().t())
        row["library_ms"] = cuda_time_ms(lambda: torch._int_mm(a, nbc()))
    return row


def _draw_row(what, lanes, n, dev, gen, int_rate, clock) -> dict:
    """One draw-mode bitflip row (``lanes`` None: the single-lane mode)."""
    words = n * (lanes or 1)
    name = "bitflip_draw" if lanes is None else "bitflip_draw_lanes"
    row = {"kernel": name, "op": what, "lanes": lanes, "n": words}
    q = upset_probability(BER)
    expected_flips = q * words
    # bytes: each word read and written once; instructions: the uniform's
    # hash for every word, the position's for every flipped word
    row["bound_ms"], row["bound_by"] = bound(
        8 * words, int_ops=THREEFRY_INT_OPS * (words + expected_flips),
        int_rate=int_rate)
    if clock is None and words > CPU_PARITY_WORK // 64:
        return row
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (lanes or 1, n),
                      dtype=torch.int32, device=dev, generator=gen)
    if lanes is None:
        x = x[0]
        key_words = ops.flip_key_words(prandom.PRNGKey(n))
        got = bitflip_draw(x, key_words, q)
        want, row["plain_ms"] = _plain(
            lambda: ref.bitflip_draw_ref(x, key_words, q), clock)
        call = lambda: bitflip_draw(x, key_words, q)
    else:
        key_words = [ops.flip_key_words(prandom.PRNGKey(n + l))
                     for l in range(lanes)]
        qs = [upset_probability(LANE_BERS[l % len(LANE_BERS)])
              for l in range(lanes)]
        got = bitflip_draw_lanes(x, key_words, qs)
        want, row["plain_ms"] = _plain(
            lambda: ref.bitflip_draw_lanes_ref(x, key_words, qs), clock)
        call = lambda: bitflip_draw_lanes(x, key_words, qs)
    row["exact"] = bool(torch.equal(got, want))
    row["flips"] = int((got != x).sum())
    del want
    if clock is None:
        return row
    # the bound on this run's draw: the positions hashed are the flips
    row["bound_ms"], row["bound_by"] = bound(
        8 * words, int_ops=THREEFRY_INT_OPS * (words + row["flips"]),
        int_rate=int_rate)
    row["ms"] = cuda_time_ms(call)
    row["dev_ms"] = device_ms(call, clock)
    row["library_ms"] = None
    return row


def _fused_vs_three_pass(dev, gen, M=32, K=4096, N=14336) -> dict:
    """The fused kernel against the three passes it replaces, at one
    shape: ``systolic_matmul`` -> ``bitflip_draw`` -> dequant."""
    a, b, xs, ws = _gemm_operands(M, K, N, dev, gen)
    bm, bn, _ = ops._resolve_blocks(M, N, K, 256, 256, 256)
    key = prandom.PRNGKey(5)
    nb = _cold(b)

    def three_pass():
        acc = systolic_matmul(a, nb())
        acc = ops.inject_bitflips(acc, BER, key)
        return acc.to(torch.float32) * xs * ws

    fused = lambda: fused_aged_matmul(a, nb(), xs, ws, BER, 5, bm=bm, bn=bn)
    acc = systolic_matmul(a, b)
    exact = bool(torch.equal(acc, ref.systolic_matmul_ref(a, b))) and bool(
        torch.equal(ops.inject_bitflips(acc, BER, key),
                    ops.inject_bitflips_ref(acc, BER, key)))
    # in turns: three-pass, fused, fused, three-pass
    t3a, tfa, tfb, t3b = (cuda_time_ms(f) for f in (three_pass, fused,
                                                    fused, three_pass))
    return {"M": M, "K": K, "N": N, "fused_ms": [tfa, tfb],
            "three_pass_ms": [t3a, t3b], "three_pass_exact": exact}


def evaluate(device="cuda", quick: bool = False) -> dict:
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    clock = sm_clock_hz(dev) if timed else None
    gen = torch.Generator(device=dev).manual_seed(2024)
    int_rate = int32_issue_per_s(dev)
    rows = []
    if quick:
        model, op, K, N = QUICK_GEMM
        rows.append(_gemm_row(model, op, QUICK_M, K, N, dev, gen, clock))
        rows.append(_draw_row(DRAW_SIZES[1][0], None, DRAW_SIZES[1][1], dev,
                              gen, int_rate, clock))
    else:
        for M in GEMM_MS:
            for model, op, K, N in GEMM_SHAPES:
                rows.append(_gemm_row(model, op, M, K, N, dev, gen, clock))
        for Ml in LANE_MS:
            for model, op, K, N in GEMM_SHAPES[:4]:
                rows.append(_lane_gemm_row(Ml, model, op, K, N, dev, gen,
                                           clock))
        for what, n in DRAW_SIZES:
            rows.append(_draw_row(what, None, n, dev, gen, int_rate, clock))
        for what, lanes, n in LANE_DRAWS:
            rows.append(_draw_row(what, lanes, n, dev, gen, int_rate, clock))
    extra = {}
    if timed and not quick:
        extra["fused_vs_three_pass"] = _fused_vs_three_pass(dev, gen)

    def fmt(v, scale=1e3):
        return "-" if v is None else f"{v * scale:.1f}"

    lines = []
    for r in rows:
        p = r.get("plan")
        dims = (f"M={r['M']} K={r['K']} N={r['N']}" if "K" in r
                else f"n={r['n']}")
        plan = (f"{p['path']} {p['bm']}x{p['bn']} x{p['splits']} "
                f"({p['ctas']} CTAs)" if p else "-")
        exact = {True: "exact", False: "MISMATCH"}.get(r.get("exact"),
                                                       "card only")
        where = f"{r.get('model', '')} {r['op']}".strip()
        lines.append([r["kernel"], where, dims,
                      plan, f"{r['bound_ms'] * 1e3:.1f} ({r['bound_by']})",
                      fmt(r.get("ms")), fmt(r.get("dev_ms")),
                      fmt(r.get("library_ms")), fmt(r.get("plain_ms")),
                      exact])
    txt = table(f"Kernels on {dev} (µs; bound: bytes / 3.35 TB/s or ops / "
                f"peak)", ["kernel", "where", "shape", "plan", "bound",
                           "wrapper", "device", "_int_mm", "plain",
                           "parity"], lines)
    if not timed:
        txt += ("\nnothing timed: a CPU run checks plans, bounds and the "
                "plain path; timings and the rows marked 'card only' need a "
                "card")
    fv = extra.get("fused_vs_three_pass")
    if fv:
        txt += (f"\nfused vs three-pass at M={fv['M']} K={fv['K']} "
                f"N={fv['N']} (wrapper µs, in turns): fused "
                + " / ".join(f"{t * 1e3:.1f}" for t in fv["fused_ms"])
                + ", three-pass "
                + " / ".join(f"{t * 1e3:.1f}" for t in fv["three_pass_ms"]))
    checked = [r for r in rows if "exact" in r]
    checks = [("every kernel equals its plain version bit for bit",
               all(r["exact"] for r in checked) and bool(checked),
               f"{len(checked)} of {len(rows)} rows checked")]
    if timed:
        gemms = [r for r in rows if r["kernel"] == "fused_aged_matmul"]
        checks.append(("every single-lane GEMM on the fast path",
                       all(r["fast_path"] for r in gemms), ""))
        if fv:
            checks.append(("the three-pass route's kernels equal their "
                           "plain versions", fv["three_pass_exact"], ""))
    return report(txt, {"device": str(dev), "rows": rows, **extra}, checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (default cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="one GEMM shape and one draw size")
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
