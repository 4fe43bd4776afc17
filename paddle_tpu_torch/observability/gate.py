"""Perf-regression gate: compare benchmark results against a stored
baseline with a noise tolerance (counterpart:
``paddle_tpu/observability/gate.py``, the port's own copy: the same
records in give the same report out).

A single lucky run is not perf evidence; :func:`compare` is the
CI-usable check.

Result records are the run_all.py JSON lines::

    {"metric": "resnet50_train_img_per_s_per_chip", "value": 123.4,
     "unit": "img/s", "backend": "cpu", ...}

Direction is inferred from the unit: time-like units (ms/s/ns) regress
upward, everything else (img/s, tokens/s, GB/s, speedup "x", MFU)
regresses downward. A metric present in the baseline but missing or
errored in the current run FAILS the gate — silently dropped coverage is
how regressions hide.

Baselines are pinned on the hardware that matters; a CPU smoke
host can't reproduce those numbers, so when the baseline and current
record carry different ``backend`` tags the gate checks METRIC PRESENCE
only (status PRESENT): the bench still ran and produced a usable value,
but the value is not compared. A baseline record may also pin ``"gate":
"presence"`` explicitly for metrics whose absolute value is known-noisy
(loopback TCP, host-simulated dryruns) — presence-only on any host.
"""
import json

__all__ = ["load_results", "compare", "format_report", "write_baseline",
           "higher_is_better", "DEFAULT_TOLERANCE"]

DEFAULT_TOLERANCE = 0.10  # fractional noise allowance

# time-like units and resource-footprint units both regress UPWARD
_LOWER_BETTER_UNITS = {"ms", "s", "ns", "us", "MB", "MiB", "GB", "bytes"}

# metric-name suffixes whose direction is part of the metric's meaning,
# pinned here so every producer agrees without repeating "direction" in
# each record: overlap efficiency (hidden/total) can only improve
# upward; exposed collective fraction only downward. An explicit
# per-record "direction" still outranks these.
_HIGHER_BETTER_SUFFIXES = ("_overlap_efficiency", "_schedulable_overlap")
_LOWER_BETTER_SUFFIXES = ("_exposed_collective_frac",)


def higher_is_better(record):
    """Regression direction of one record: an explicit ``"direction":
    "lower"|"higher"`` pin wins (the memory rows pin ``lower`` — more
    resident bytes is a regression even though "MB" is not a time
    unit); then the metric-name suffix pins
    (``*_overlap_efficiency`` up, ``*_exposed_collective_frac`` down);
    otherwise inferred from the unit — time-like and byte-footprint
    units regress upward, rates/ratios downward."""
    direction = record.get("direction")
    if direction in ("lower", "higher"):
        return direction == "higher"
    name = record.get("metric", "")
    if name.endswith(_HIGHER_BETTER_SUFFIXES):
        return True
    if name.endswith(_LOWER_BETTER_SUFFIXES):
        return False
    return record.get("unit", "") not in _LOWER_BETTER_UNITS


def _records_from(obj):
    if isinstance(obj, dict):
        if "results" in obj and isinstance(obj["results"], list):
            return obj["results"]
        if "metric" in obj:
            return [obj]
        raise ValueError("baseline dict has neither 'results' nor 'metric'")
    if isinstance(obj, list):
        return obj
    raise ValueError(f"unsupported results JSON shape: {type(obj)}")


def load_results(path):
    """Load a results file: a JSON array, a ``{"results": [...]}`` object,
    or run_all.py's one-JSON-object-per-line output. Returns
    ``{metric: record}``."""
    with open(path) as f:
        text = f.read()
    try:
        records = _records_from(json.loads(text))
    except json.JSONDecodeError:
        records = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                records.append(json.loads(line))
    out = {}
    for r in records:
        if "metric" in r:
            out[r["metric"]] = r
    return out


def _usable(record):
    return (record is not None and "error" not in record
            and isinstance(record.get("value"), (int, float))
            and record["value"] >= 0)


def compare(baseline, current, tolerance=DEFAULT_TOLERANCE):
    """Compare ``{metric: record}`` maps. Returns ``(ok, report)`` where
    report is a list of per-metric dicts (status OK/IMPROVED/REGRESSION/
    MISSING/SKIP). Gate passes only if no REGRESSION and no MISSING."""
    report = []
    ok = True
    for name in sorted(baseline):
        base = baseline[name]
        cur = current.get(name)
        if not _usable(base):
            # baseline itself carries no number (errored when recorded,
            # or a note-only entry): nothing to gate on
            report.append({"metric": name, "status": "SKIP",
                           "note": "baseline has no usable value"})
            continue
        if not _usable(cur):
            ok = False
            report.append({
                "metric": name, "status": "MISSING",
                "baseline": base["value"],
                "note": ("metric errored or absent in current run: "
                         + str((cur or {}).get("error", "not present"))[:200])})
            continue
        base_be, cur_be = base.get("backend"), cur.get("backend")
        if (base.get("gate") == "presence"
                or (base_be and cur_be and base_be != cur_be)):
            report.append({
                "metric": name, "status": "PRESENT",
                "baseline": base["value"], "current": cur["value"],
                "unit": base.get("unit", ""),
                "note": (f"value not compared (baseline backend="
                         f"{base_be or '?'}, current={cur_be or '?'}"
                         + (", pinned presence-only"
                            if base.get("gate") == "presence" else "")
                         + ")")})
            continue
        bv, cv = float(base["value"]), float(cur["value"])
        hib = higher_is_better(base)
        if bv == 0:
            ratio = float("inf") if cv > 0 else 1.0
        else:
            ratio = cv / bv
        # normalized so >1 is always better
        norm = ratio if hib else (1.0 / ratio if ratio else float("inf"))
        entry = {"metric": name, "baseline": bv, "current": cv,
                 "unit": base.get("unit", ""), "ratio": round(norm, 4),
                 "tolerance": tolerance}
        if norm < 1.0 - tolerance:
            entry["status"] = "REGRESSION"
            ok = False
        elif norm > 1.0 + tolerance:
            entry["status"] = "IMPROVED"
        else:
            entry["status"] = "OK"
        report.append(entry)
    for name in sorted(set(current) - set(baseline)):
        if _usable(current[name]):
            report.append({"metric": name, "status": "NEW",
                           "current": current[name]["value"],
                           "unit": current[name].get("unit", "")})
    return ok, report


def format_report(report):
    lines = []
    for e in report:
        status = e["status"]
        if status in ("OK", "IMPROVED", "REGRESSION"):
            arrow = "better" if e["ratio"] >= 1 else "worse"
            lines.append(
                f"[{status:>10}] {e['metric']}: {e['current']:g} vs "
                f"baseline {e['baseline']:g} {e['unit']} "
                f"({(e['ratio'] - 1) * 100:+.1f}% {arrow}, "
                f"tol ±{e['tolerance'] * 100:.0f}%)")
        elif status == "PRESENT":
            lines.append(
                f"[{status:>10}] {e['metric']}: {e['current']:g} "
                f"{e['unit']} — {e['note']}")
        elif status == "MISSING":
            lines.append(f"[{status:>10}] {e['metric']}: {e['note']}")
        elif status == "NEW":
            lines.append(f"[{status:>10}] {e['metric']}: "
                         f"{e['current']:g} {e['unit']} (not in baseline)")
        else:
            lines.append(f"[{status:>10}] {e['metric']}: {e['note']}")
    return "\n".join(lines)


def write_baseline(records, path):
    """Persist a results list as a gate baseline. Errored/valueless
    records are dropped LOUDLY: pinning them would make compare() SKIP
    that metric forever (a permanently ungated bench) — re-pin after the
    bench is fixed instead."""
    import sys
    usable = [r for r in records if "metric" in r and _usable(r)]
    skipped = [r["metric"] for r in records
               if "metric" in r and not _usable(r)]
    if skipped:
        print(f"write_baseline: dropping {len(skipped)} errored/valueless "
              f"metrics (NOT gated until re-pinned): {skipped}",
              file=sys.stderr)
    data = {"results": usable}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return len(usable)
