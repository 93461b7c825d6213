"""Shared benchmark output helpers and the command-line entry."""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterable, List, Sequence, Tuple


def table(title: str, header: Sequence[str], rows: Iterable[Sequence]) -> str:
    rows = [[str(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]

    def fmt(cells):
        return " | ".join(c.ljust(w) for c, w in zip(cells, widths))
    lines = [f"== {title} ==", fmt(header),
             "-+-".join("-" * w for w in widths)]
    lines += [fmt(r) for r in rows]
    return "\n".join(lines)


def check(name: str, ok: bool, detail: str = "") -> str:
    mark = "PASS" if ok else "FAIL"
    return f"[{mark}] {name}" + (f" — {detail}" if detail else "")


def report(text: str, rows: Dict, checks: List[Tuple[str, bool, str]]
           ) -> Dict:
    """A benchmark's result: its ``rows``, its ``checks`` as dicts
    (``name``, ``ok``, ``detail``) and the printed ``text``."""
    checks = [{"name": n, "ok": bool(ok), "detail": d}
              for n, ok, d in checks]
    lines = [check(c["name"], c["ok"], c["detail"]) for c in checks]
    return {"rows": rows, "checks": checks,
            "text": text + "\n" + "\n".join(lines)}


def main(evaluate: Callable[..., Dict], doc: str, argv=None) -> int:
    """Parse ``--device``, run ``evaluate(device)``, print its text and
    its seconds; exit status 1 when a check fails."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (default cuda)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = evaluate(device=args.device)
    print(res["text"])
    print(f"({time.perf_counter() - t0:.2f} s on {args.device})")
    return 0 if all(c["ok"] for c in res["checks"]) else 1
