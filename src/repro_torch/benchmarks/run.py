"""Benchmark driver (port of the reference's ``benchmarks/run.py``): one
section per ported benchmark.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only table1,...]
        [--device cpu] [--quick] [--out-dir DIR]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --summary

Each section's record (its rows and PASS/FAIL checks) goes to
``<out-dir>/<section>.json`` (default ``build/bench_torch/``, git-ignored),
and ``summary.json`` there merges every record in the directory;
``--summary`` only merges.  Nothing is written anywhere else (the
reference's ``BENCH_*.json`` at the repository root are its own).
The one section not ported, ``roofline`` (ROADMAP A.10), raises
``NotImplementedError`` when asked for by ``--only``.
Exits 1 when a section fails or a check FAILs.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

# section -> (module, takes quick=)
SECTIONS = {
    "table1": ("table1_aging", False), "table2": ("table2_policy", False),
    "fig5": ("fig5_curves", False), "scenarios": ("scenario_bench", False),
    "sched": ("sched_bench", False), "disruption": ("disruption_bench",
                                                    False),
    "kernels": ("kernel_bench", True), "serve": ("serve_bench", True),
    "resilience": ("resilience_bench", True), "fig1b": ("fig1b_ber", False),
    "online": ("online_bench", True), "obs": ("obs_bench", True),
    "mesh": ("mesh_bench", True),
}
UNPORTED = {"roofline": "A.10"}
OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "bench_torch"


def write_summary(out_dir=OUT_DIR) -> str:
    """Merge every section record in ``out_dir`` into its
    ``summary.json``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    merged = {}
    for path in sorted(out_dir.glob("*.json")):
        if path.name == "summary.json":
            continue
        try:
            merged[path.stem] = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            merged[path.stem] = {"error": f"unreadable: {e}"}
    out = out_dir / "summary.json"
    out.write_text(json.dumps({"sections": sorted(merged),
                               "records": merged}, indent=2) + "\n")
    return (f"[recorded] {out} ({len(merged)} sections: "
            f"{', '.join(sorted(merged))})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {tuple(SECTIONS)}")
    ap.add_argument("--summary", action="store_true",
                    help="merge the records of --out-dir into its "
                         "summary.json (no benchmarks are run)")
    ap.add_argument("--device", default="cuda",
                    help="where the benchmarks run (default cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="the small variant of the sections that have one")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the records go (default build/bench_torch)")
    args = ap.parse_args(argv)
    if args.summary:
        print(write_summary(args.out_dir))
        return 0
    want = args.only.split(",") if args.only else list(SECTIONS)
    for name in want:
        if name in UNPORTED:
            raise NotImplementedError(
                f"benchmark section {name!r} is not ported: ROADMAP "
                f"{UNPORTED[name]}")
        if name not in SECTIONS:
            ap.error(f"unknown section {name!r}")
    if not args.only:
        print("not ported: " + ", ".join(
            f"{n} ({item})" for n, item in UNPORTED.items()))
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failed = []
    for name in want:
        module, has_quick = SECTIONS[name]
        mod = importlib.import_module(f"{__package__}.{module}")
        kw = {"quick": args.quick} if has_quick else {}
        t0 = time.perf_counter()
        print(f"\n{'#' * 72}\n# benchmark: {name}\n{'#' * 72}")
        res = mod.evaluate(device=args.device, **kw)
        seconds = time.perf_counter() - t0
        print(res["text"])
        print(f"# ({name} took {seconds:.1f}s on {args.device})")
        (out_dir / f"{name}.json").write_text(json.dumps(
            {"device": args.device, "seconds": seconds,
             "rows": res["rows"], "checks": res["checks"]},
            indent=1, default=str) + "\n")
        if not all(c["ok"] for c in res["checks"]):
            failed.append(name)
    print("\n" + write_summary(out_dir))
    if failed:
        print(f"FAILED sections: {failed}")
        return 1
    print("All benchmark sections completed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
