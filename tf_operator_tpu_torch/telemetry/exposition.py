"""Parse and validate Prometheus text exposition pages: the port's copy
of tf_operator_tpu/telemetry/exposition.py. The decode server's
/metrics page (serve/server.py) must be one a real scraper accepts. The
validator enforces:

- every sample belongs to a family that declared # HELP and # TYPE
  (histogram samples attach to their family via the _bucket/_sum/
  _count suffixes);
- a family is declared once per page (duplicates are a scrape error);
- histogram buckets are cumulative-monotone and end with le="+Inf",
  whose count equals the family's _count, and _sum/_count are present
  for every label set that has buckets.

parse_text() is deliberately small — the subset of the 0.0.4 format
this repo emits (no exemplars, no timestamps) — but strict inside it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .registry import histogram_quantile

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class ExpositionError(ValueError):
    """The page would not survive a real Prometheus scrape."""


class Family:
    def __init__(self, name: str):
        self.name = name
        self.help: Optional[str] = None
        self.type: Optional[str] = None
        # (sample_name, labels dict, value) in page order
        self.samples: List[Tuple[str, Dict[str, str], float]] = []


def _family_for(sample_name: str, families: Dict[str, Family]) -> Optional[str]:
    if sample_name in families:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families and families[base].type == "histogram":
                return base
    return None


def parse_text(text: str) -> Dict[str, Family]:
    families: Dict[str, Family] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ExpositionError(f"line {lineno}: malformed HELP")
            name = parts[2]
            fam = families.setdefault(name, Family(name))
            if fam.help is not None:
                raise ExpositionError(
                    f"line {lineno}: duplicate HELP for {name}"
                )
            fam.help = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ExpositionError(f"line {lineno}: malformed TYPE")
            name, kind = parts[2], parts[3]
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ExpositionError(
                    f"line {lineno}: unknown type {kind!r}"
                )
            fam = families.setdefault(name, Family(name))
            if fam.type is not None:
                raise ExpositionError(
                    f"line {lineno}: duplicate TYPE for {name}"
                )
            if fam.samples:
                raise ExpositionError(
                    f"line {lineno}: TYPE for {name} after its samples"
                )
            fam.type = kind
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(f"line {lineno}: unparseable sample {line!r}")
        sample_name = m.group("name")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw):
                labels[lm.group(1)] = lm.group(2)
                consumed += 1
            if consumed != len([p for p in raw.split(",") if p.strip()]):
                raise ExpositionError(
                    f"line {lineno}: malformed labels {raw!r}"
                )
        if m.group("value") == "+Inf":
            value = float("inf")
        else:
            try:
                value = float(m.group("value"))
            except ValueError:
                raise ExpositionError(
                    f"line {lineno}: bad value {m.group('value')!r}"
                ) from None
        base = _family_for(sample_name, families)
        if base is None:
            raise ExpositionError(
                f"line {lineno}: sample {sample_name} has no preceding "
                "# TYPE declaration"
            )
        families[base].samples.append((sample_name, labels, value))
    return families


def _hist_groups(fam: Family):
    """Group a histogram family's samples by their non-le label set."""
    groups: Dict[Tuple[Tuple[str, str], ...], Dict[str, list]] = {}
    for sample_name, labels, value in fam.samples:
        key = tuple(sorted(
            (k, v) for k, v in labels.items() if k != "le"
        ))
        group = groups.setdefault(
            key, {"bucket": [], "sum": [], "count": []}
        )
        if sample_name == fam.name + "_bucket":
            if "le" not in labels:
                raise ExpositionError(
                    f"{fam.name}: _bucket sample missing le label"
                )
            le = (
                float("inf") if labels["le"] == "+Inf"
                else float(labels["le"])
            )
            group["bucket"].append((le, value))
        elif sample_name == fam.name + "_sum":
            group["sum"].append(value)
        elif sample_name == fam.name + "_count":
            group["count"].append(value)
        else:
            raise ExpositionError(
                f"{fam.name}: unexpected histogram sample {sample_name}"
            )
    return groups


def validate_text(text: str) -> Dict[str, Family]:
    """parse_text plus the format rules; raises ExpositionError."""
    families = parse_text(text)
    for fam in families.values():
        if fam.type is None:
            raise ExpositionError(f"{fam.name}: missing # TYPE")
        if fam.help is None:
            raise ExpositionError(f"{fam.name}: missing # HELP")
        if fam.type != "histogram":
            continue
        for key, group in _hist_groups(fam).items():
            where = f"{fam.name}{dict(key) if key else ''}"
            buckets = group["bucket"]
            if not buckets:
                raise ExpositionError(f"{where}: histogram with no buckets")
            les = [le for le, _ in buckets]
            if les != sorted(les):
                raise ExpositionError(f"{where}: bucket bounds not sorted")
            if len(set(les)) != len(les):
                raise ExpositionError(f"{where}: duplicate bucket bounds")
            if les[-1] != float("inf"):
                raise ExpositionError(f"{where}: buckets must end at +Inf")
            counts = [c for _, c in buckets]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ExpositionError(
                    f"{where}: bucket counts not cumulative-monotone"
                )
            if len(group["sum"]) != 1 or len(group["count"]) != 1:
                raise ExpositionError(
                    f"{where}: need exactly one _sum and one _count"
                )
            if group["count"][0] != counts[-1]:
                raise ExpositionError(
                    f"{where}: _count {group['count'][0]} != +Inf bucket "
                    f"{counts[-1]}"
                )
            if group["count"][0] > 0 and group["sum"][0] < 0 and all(
                le >= 0 for le in les[:-1]
            ):
                raise ExpositionError(
                    f"{where}: negative _sum with non-negative buckets"
                )
    return families


def bucket_pairs(
    flat: Dict[str, float], family: str
) -> List[Tuple[float, float]]:
    """Extract cumulative (le, count) pairs for `family` from a flat
    {exposition_sample_name: value} dict (serve/client.py
    DecodeClient.metrics() shape). Unlabeled histograms only."""
    prefix = family + "_bucket{le=\""
    out = []
    for name, value in flat.items():
        if name.startswith(prefix) and name.endswith("\"}"):
            raw = name[len(prefix):-2]
            le = float("inf") if raw == "+Inf" else float(raw)
            out.append((le, value))
    return sorted(out)


def quantile_from_flat(
    flat: Dict[str, float], family: str, q: float
) -> Optional[float]:
    """Estimated quantile for an unlabeled histogram family scraped
    into a flat metrics dict; None when absent or empty."""
    return histogram_quantile(q, bucket_pairs(flat, family))
