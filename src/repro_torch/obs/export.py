"""Telemetry export: a JSONL event log and the Prometheus text exposition
(port of ``repro.obs.export``).

Two sinks over one source, the :class:`~repro_torch.obs.metrics.Sample`
rows of :meth:`repro_torch.obs.metrics.MetricsRegistry.collect`:

* **JSONL** (:func:`write_jsonl` / :func:`read_jsonl`): the first row is a
  run manifest (schema version, run name, environment); every following
  row is a typed event: ``metric`` rows carry one sample each, ``health``
  rows a :meth:`repro_torch.obs.health.FleetHealth.to_dict` snapshot,
  ``event`` rows freeform markers.
* **Prometheus text exposition** (:func:`prometheus_text` /
  :func:`parse_prometheus`): ``# HELP`` / ``# TYPE`` /
  ``name{label="v"} value`` lines, one scrape of the registry.

Both directions round-trip: ``parse_prometheus(prometheus_text(s))`` and
``read_jsonl`` of :func:`write_jsonl` give the samples back exactly.  The
text is the reference's for the same samples.
"""
from __future__ import annotations

import json
import math
import platform
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .metrics import REGISTRY, MetricsRegistry, Sample

__all__ = [
    "run_manifest", "write_jsonl", "read_jsonl",
    "prometheus_text", "parse_prometheus",
]

SCHEMA_VERSION = 1


def run_manifest(run: str = "run", **extra) -> Dict:
    """Export-header metadata: schema version and the environment (torch's
    version and the device in place of the reference's jax fields)."""
    import torch
    man = {
        "schema": SCHEMA_VERSION,
        "run": str(run),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
    }
    man.update(extra)
    return man


def _sample_row(s: Sample) -> Dict:
    return {"type": "metric", "name": s.name, "labels": dict(s.labels),
            "value": None if math.isnan(s.value) else s.value,
            "kind": s.kind}


def write_jsonl(path, samples: Optional[Sequence[Sample]] = None, *,
                manifest: Optional[Dict] = None,
                health: Optional[Dict] = None,
                events: Iterable[Dict] = (),
                registry: MetricsRegistry = REGISTRY) -> int:
    """Write one telemetry event log; returns the number of rows written.

    ``samples`` defaults to a fresh ``registry.collect()`` scrape;
    ``health`` is a :meth:`repro_torch.obs.health.FleetHealth.to_dict`
    dict;
    ``events`` are freeform dicts logged as ``{"type": "event", ...}``.
    """
    rows: List[Dict] = [{"type": "manifest",
                         **(manifest or run_manifest())}]
    if health is not None:
        rows.append({"type": "health", **health})
    for ev in events:
        rows.append({"type": "event", **ev})
    for s in (registry.collect() if samples is None else samples):
        rows.append(_sample_row(s))
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
    return len(rows)


def read_jsonl(path) -> Tuple[Dict, List[Sample], List[Dict]]:
    """Parse an event log back: ``(manifest, samples, other_rows)``.

    ``samples`` reconstructs each ``metric`` row as a
    :class:`~repro_torch.obs.metrics.Sample` (labels sorted, NaN restored);
    ``other_rows`` keeps ``health`` / ``event`` rows verbatim.
    """
    manifest: Dict = {}
    samples: List[Sample] = []
    other: List[Dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.pop("type", "event")
            if kind == "manifest":
                manifest = row
            elif kind == "metric":
                value = row["value"]
                samples.append(Sample(
                    name=row["name"],
                    labels=tuple(sorted(row.get("labels", {}).items())),
                    value=math.nan if value is None else float(value),
                    kind=row.get("kind", "gauge")))
            else:
                other.append({"type": kind, **row})
    return manifest, samples, other


# --------------------------------------------------------------------------- #
# Prometheus text exposition
# --------------------------------------------------------------------------- #
def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _unescape(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(v[i + 1],
                                                            v[i + 1]))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def prometheus_text(samples: Optional[Sequence[Sample]] = None, *,
                    registry: MetricsRegistry = REGISTRY) -> str:
    """Render samples in the Prometheus text exposition format."""
    if samples is None:
        samples = registry.collect()
    lines: List[str] = []
    seen_meta = set()
    for s in samples:
        if s.name not in seen_meta:
            seen_meta.add(s.name)
            if s.help:
                lines.append(f"# HELP {s.name} {s.help}")
            lines.append(f"# TYPE {s.name} {s.kind}")
        if s.labels:
            lab = ",".join(f'{k}="{_escape(str(v))}"' for k, v in s.labels)
            lines.append(f"{s.name}{{{lab}}} {s.value:.17g}")
        else:
            lines.append(f"{s.name} {s.value:.17g}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> List[Sample]:
    """Parse a text exposition back into :class:`Sample` rows.

    Covers what :func:`prometheus_text` emits (single-line samples,
    escaped label values); ``# TYPE`` lines restore each sample's kind.
    """
    kinds: Dict[str, str] = {}
    samples: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            lab_str, value = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(lab_str):
                k, v = item.split("=", 1)
                labels.append((k, _unescape(v.strip('"'))))
            labels = tuple(sorted(labels))
        else:
            name, value = line.rsplit(None, 1)
            labels = ()
        samples.append(Sample(name=name, labels=labels,
                              value=float(value),
                              kind=kinds.get(name, "gauge")))
    return samples


def _split_labels(lab_str: str) -> List[str]:
    """Split ``k1="v1",k2="v2"`` at commas outside quoted values."""
    items, buf, in_q, esc = [], [], False, False
    for ch in lab_str:
        if esc:
            buf.append(ch)
            esc = False
        elif ch == "\\":
            buf.append(ch)
            esc = True
        elif ch == '"':
            buf.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        items.append("".join(buf))
    return items
