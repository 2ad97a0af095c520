"""Prometheus text-format exposition (version 0.0.4) for the telemetry
tier, plus the one format validator shared by tests and `chip_smoke.py`,
(INTERNALS §14.3). The port of the JAX package's ``obs/prom.py``, without
its HTTP scrape endpoint, which comes with the service tier.

No prometheus_client dependency: the container doesn't carry it, and the
text format is a page of spec. Families are built as plain tuples

    (name, type, help, samples)         # samples: [(labels_dict, value)]

and rendered by :func:`expose`. :func:`telemetry_families` maps a
:class:`~.telemetry.Telemetry` store onto three families:

- ``<prefix>_events_total{cat,name}``        counter (exact totals)
- ``<prefix>_span_seconds{cat,name}``        histogram (log buckets,
  cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)
- one gauge family per distinct gauge name, ``<prefix>_<gauge name>``

:func:`validate_prom` parses an exposition page back: every sample must
belong to a ``# TYPE``-declared family, histogram buckets must be
cumulative with ascending ``le`` and a ``+Inf`` bucket equal to
``_count`` — so a malformed page fails in a test, not in a Prometheus
server's scrape log.
"""

from __future__ import annotations

import re

from .telemetry import N_BUCKETS, Telemetry, bucket_le_ns

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_METRIC_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    # label block: quoted values may contain anything (incl. '}'), so the
    # block is matched label-by-label, not with a naive [^}]* scan
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?\s+'
    r"([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|[+-]?Inf|NaN)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def sanitize(name: str) -> str:
    """A metric/label-safe name: anything outside [a-zA-Z0-9_:] -> _."""
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        if v != int(v):
            return repr(v)
    return str(int(v))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{sanitize(str(k))}="{_escape(str(v))}"'
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def expose(families) -> str:
    """Render families to one exposition page (ends with a newline)."""
    lines = []
    for name, ftype, help_text, samples in families:
        name = sanitize(name)
        lines.append(f"# HELP {name} {_escape(help_text)}")
        lines.append(f"# TYPE {name} {ftype}")
        for labels, value in samples:
            suffix = ""
            if isinstance(labels, tuple):      # (suffix, labels) histogram
                suffix, labels = labels
            lines.append(f"{name}{suffix}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def telemetry_families(tel: Telemetry, prefix: str = "amtpu") -> list:
    """Map a Telemetry store onto exposition families (see module doc)."""
    prefix = sanitize(prefix)
    fams = []
    counters = tel.counters()
    if counters:
        fams.append((
            f"{prefix}_events_total", "counter",
            "Exact event/counter totals per (cat, name), fed at emit "
            "time (wraparound-proof).",
            [({"cat": c, "name": n}, v)
             for (c, n), v in sorted(counters.items())]))
    hists, aggs = tel.span_view()
    if hists:
        samples = []
        for (c, n) in sorted(hists):
            buckets = hists[(c, n)]
            agg = aggs.get((c, n), {"count": 0, "total_ns": 0})
            cum = 0
            for i in range(N_BUCKETS + 1):
                cum += buckets[i]
                le = bucket_le_ns(i) / 1e9
                samples.append(((
                    "_bucket",
                    {"cat": c, "name": n,
                     "le": "+Inf" if le == float("inf") else repr(le)}),
                    cum))
            samples.append((("_sum", {"cat": c, "name": n}),
                            agg["total_ns"] / 1e9))
            samples.append((("_count", {"cat": c, "name": n}),
                            agg["count"]))
        fams.append((
            f"{prefix}_span_seconds", "histogram",
            "Span durations per (cat, name): log2 buckets fed at emit "
            "time, exact independent of trace-ring retention.",
            samples))
    gauges: dict = {}
    for (name, labels), value in tel.gauges().items():
        gauges.setdefault(name, []).append((dict(labels), value))
    for name in sorted(gauges):
        fams.append((f"{prefix}_{sanitize(name)}", "gauge",
                     f"Last observed value of {name}.",
                     sorted(gauges[name], key=lambda s: sorted(
                         s[0].items()))))
    return fams


class PromValidationError(ValueError):
    """The exposition page violates the text format / histogram
    contract."""


def validate_prom(text: str) -> dict:
    """Validate one exposition page; raises :class:`PromValidationError`,
    returns {"families": n, "samples": n} on success.

    Checks: every non-comment line parses as a sample; every sample's
    family (modulo the histogram ``_bucket``/``_sum``/``_count``
    suffixes) was declared by a preceding ``# TYPE``; histogram buckets
    are cumulative (non-decreasing) in ascending ``le`` order, end with
    ``le="+Inf"``, and the +Inf bucket equals ``_count``."""
    if not isinstance(text, str) or not text.strip():
        raise PromValidationError("empty exposition page")
    types: dict = {}
    n_samples = 0
    hist_buckets: dict = {}   # (family, labels-sans-le) -> [(le, v)]
    hist_counts: dict = {}    # (family, labels) -> _count value
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise PromValidationError(
                    f"line {lineno}: malformed TYPE line: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _METRIC_RE.match(line)
        if m is None:
            raise PromValidationError(
                f"line {lineno}: unparsable sample: {line!r}")
        name, labels_raw, value = m.group(1), m.group(2) or "", m.group(3)
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family = base
                break
        if family not in types:
            raise PromValidationError(
                f"line {lineno}: sample {name!r} has no preceding "
                f"# TYPE declaration")
        labels = dict(_LABEL_RE.findall(labels_raw))
        if types[family] == "histogram":
            key_labels = tuple(sorted((k, v) for k, v in labels.items()
                                      if k != "le"))
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise PromValidationError(
                        f"line {lineno}: histogram bucket without le")
                le = (float("inf") if labels["le"] == "+Inf"
                      else float(labels["le"]))
                hist_buckets.setdefault((family, key_labels), []).append(
                    (le, float(value)))
            elif name.endswith("_count"):
                hist_counts[(family, key_labels)] = float(value)
        n_samples += 1
    for (family, key_labels), buckets in hist_buckets.items():
        les = [le for le, _ in buckets]
        if les != sorted(les):
            raise PromValidationError(
                f"{family}: bucket le values not ascending")
        if not les or les[-1] != float("inf"):
            raise PromValidationError(f"{family}: missing +Inf bucket")
        values = [v for _, v in buckets]
        if any(b > a for a, b in zip(values[1:], values)):
            raise PromValidationError(
                f"{family}: bucket counts not cumulative")
        count = hist_counts.get((family, key_labels))
        if count is not None and values[-1] != count:
            raise PromValidationError(
                f"{family}: +Inf bucket {values[-1]} != _count {count}")
    if n_samples == 0:
        raise PromValidationError("page declares types but has no samples")
    return {"families": len(types), "samples": n_samples}
