"""Reporter CLI: render a run summary from any telemetry JSONL file (port of
``repro/obs/report.py``; both packages write the same records).

``python -m repro_torch.obs.report run.jsonl`` reads the record stream any
instrumented path writes (trainer loops, ServeEngine, robust decode — all
through the same ``{"t", "kind", "step", ...}`` format) and prints:

* loss curve stats (first/last/min/mean) from train/streaming records,
* the ejection timeline — every step where a worker or replica flipped
  between active and ejected, reconstructed from consecutive ``active``
  masks,
* suspicion heat by worker (mean score, so a slowburn attacker's slow
  drift is visible even when it never crosses the ejection threshold),
* span latency stats (count / mean / p50 / p99 per span path — exact
  quantiles, since span records carry raw milliseconds),
* q̂ trajectory and close-time counter values (``metric`` records).

Pure-stdlib summary: it reads the JSONL of a run of either package.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Optional, Sequence


def _finite(values) -> List[float]:
    out = []
    for v in values:
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and math.isfinite(v):
            out.append(float(v))
    return out


def _stats(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    return {"first": values[0], "last": values[-1], "min": min(values),
            "max": max(values), "mean": sum(values) / len(values),
            "n": len(values)}


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(math.ceil(q * len(sorted_vals))) - 1)
    return sorted_vals[max(0, idx)]


def _mask_transitions(records, label: str, timeline: List[dict]) -> None:
    """Append ejection/readmission events by diffing consecutive
    ``active`` masks within one record family."""
    prev = None
    for rec in records:
        active = rec.get("active")
        if not isinstance(active, (list, tuple)):
            continue
        if prev is not None and len(prev) == len(active):
            for i, (was, now) in enumerate(zip(prev, active)):
                if bool(was) != bool(now):
                    timeline.append({
                        "step": rec.get("step", -1), "who": i,
                        "stream": label,
                        "event": "ejected" if was else "readmitted"})
        prev = list(active)


def summarize(records: Sequence[dict]) -> dict:
    """Structured summary of one run's record stream."""
    by_kind: Dict[str, List[dict]] = {}
    for rec in records:
        by_kind.setdefault(rec.get("kind", "?"), []).append(rec)

    train = by_kind.get("train", []) + by_kind.get("streaming", [])
    train.sort(key=lambda r: r.get("step", 0))
    loss = _stats(_finite(r.get("loss") for r in train))

    timeline: List[dict] = []
    for label in ("train", "async", "robust_decode"):
        _mask_transitions(
            sorted(by_kind.get(label, []), key=lambda r: r.get("step", 0)),
            label, timeline)
    timeline.sort(key=lambda e: e["step"])

    # Suspicion heat: mean score per worker across defended records.
    sus_sum: Dict[int, float] = {}
    sus_n: Dict[int, int] = {}
    for rec in by_kind.get("train", []) + by_kind.get("async", []):
        scores = rec.get("suspicion")
        if isinstance(scores, (list, tuple)):
            for i, s in enumerate(scores):
                if isinstance(s, (int, float)) and math.isfinite(s):
                    sus_sum[i] = sus_sum.get(i, 0.0) + float(s)
                    sus_n[i] = sus_n.get(i, 0) + 1
    suspicion = {i: sus_sum[i] / sus_n[i] for i in sorted(sus_sum)}

    # Span latency: exact quantiles from the raw per-span milliseconds.
    span_ms: Dict[str, List[float]] = {}
    for rec in by_kind.get("span", []):
        ms = rec.get("ms")
        if isinstance(ms, (int, float)) and math.isfinite(ms):
            span_ms.setdefault(str(rec.get("name", "?")), []).append(
                float(ms))
    spans = {}
    for name, vals in sorted(span_ms.items()):
        vals.sort()
        spans[name] = {"n": len(vals), "mean": sum(vals) / len(vals),
                       "p50": _quantile(vals, 0.50),
                       "p99": _quantile(vals, 0.99)}

    q_hat = _stats(_finite(r.get("q_hat") for r in train
                           if r.get("q_hat") is not None))

    counters = {}
    for rec in by_kind.get("metric", []):
        if rec.get("type") == "counter":
            key = str(rec.get("name"))
            labels = rec.get("labels") or {}
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v
                                      in sorted(labels.items())) + "}"
            counters[key] = rec.get("value")

    serve = by_kind.get("serve", [])
    produced = _finite(r.get("produced") for r in serve)

    return {
        "kinds": {k: len(v) for k, v in sorted(by_kind.items())},
        "loss": loss,
        "q_hat": q_hat,
        "ejections": timeline,
        "suspicion_by_worker": suspicion,
        "spans": spans,
        "counters": counters,
        "serve_tokens": sum(produced) if produced else None,
    }


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def render(summary: dict) -> str:
    """Human-readable report for one summarize() result."""
    out: List[str] = []
    kinds = ", ".join(f"{k}={n}" for k, n in summary["kinds"].items())
    out.append(f"records: {kinds}")

    loss = summary["loss"]
    if loss:
        out.append(f"loss: first={_fmt(loss['first'])} "
                   f"last={_fmt(loss['last'])} min={_fmt(loss['min'])} "
                   f"mean={_fmt(loss['mean'])} (n={loss['n']})")
    q_hat = summary["q_hat"]
    if q_hat:
        out.append(f"q_hat: first={_fmt(q_hat['first'])} "
                   f"last={_fmt(q_hat['last'])} max={_fmt(q_hat['max'])}")

    if summary["ejections"]:
        out.append("ejection timeline:")
        for e in summary["ejections"]:
            out.append(f"  step {e['step']:>6}: worker {e['who']} "
                       f"{e['event']} ({e['stream']})")
    else:
        out.append("ejection timeline: none")

    if summary["suspicion_by_worker"]:
        out.append("suspicion heat (mean score by worker):")
        peak = max(summary["suspicion_by_worker"].values()) or 1.0
        for i, s in summary["suspicion_by_worker"].items():
            bar = "#" * int(round(20 * s / peak)) if peak > 0 else ""
            out.append(f"  worker {i:>3}: {_fmt(s):>10} {bar}")

    if summary["spans"]:
        out.append("span latency (ms):")
        out.append(f"  {'span':<32} {'n':>6} {'mean':>10} {'p50':>10} "
                   f"{'p99':>10}")
        for name, s in summary["spans"].items():
            out.append(f"  {name:<32} {s['n']:>6} {_fmt(s['mean']):>10} "
                       f"{_fmt(s['p50']):>10} {_fmt(s['p99']):>10}")

    if summary["counters"]:
        out.append("counters:")
        for name, v in sorted(summary["counters"].items()):
            out.append(f"  {name} = {_fmt(v)}")

    if summary["serve_tokens"] is not None:
        out.append(f"serve: {int(summary['serve_tokens'])} tokens produced")

    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run summary from a telemetry JSONL file.")
    parser.add_argument("jsonl", help="telemetry file written with "
                        "--telemetry / --metrics")
    parser.add_argument("--kind", default=None,
                        help="only summarize records of this kind")
    args = parser.parse_args(argv)

    from repro_torch.defense.telemetry import read_jsonl
    records = read_jsonl(args.jsonl)
    if args.kind:
        records = [r for r in records if r.get("kind") == args.kind]
    if not records:
        print(f"no records in {args.jsonl}", file=sys.stderr)
        return 1
    print(render(summarize(records)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
