"""Text summaries over canonical trace events (port of ``repro.obs.report``).

Works from the event list alone (JSONL or Perfetto file via
``export.read_events``) — no live tracer needed, so perf regressions can
be diagnosed from committed artifacts.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List

__all__ = ["summarize"]


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:9.3f}s"
    return f"{v * 1e3:8.2f}ms"


def _stage_breakdown(spans: List[Dict[str, Any]], lines: List[str]) -> None:
    agg: Dict[str, List[float]] = defaultdict(list)
    # top-level spans only: children are counted inside their parents
    for sp in spans:
        if sp["parent"] == -1:
            agg[sp["name"]].append(sp["dur"])
    if not agg:
        return
    total = sum(sum(v) for v in agg.values())
    lines.append("stage time breakdown (top-level spans):")
    lines.append(f"  {'stage':<24}{'count':>7}{'total':>12}{'mean':>12}{'share':>8}")
    for name, durs in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        t = sum(durs)
        share = 100.0 * t / total if total else 0.0
        lines.append(f"  {name:<24}{len(durs):>7}{_fmt_s(t):>12}"
                     f"{_fmt_s(t / len(durs)):>12}{share:>7.1f}%")
    lines.append("")


def _cache_rates(counters: Dict[str, float], lines: List[str]) -> None:
    groups: Dict[str, Dict[str, float]] = defaultdict(dict)
    for name, v in counters.items():
        if name.endswith(("/hits", "/misses")):
            prefix, _, leaf = name.rpartition("/")
            groups[prefix][leaf] = v
    rows = []
    for prefix, g in sorted(groups.items()):
        hits = g.get("hits", 0.0)
        misses = g.get("misses", 0.0)
        total = hits + misses
        if total:
            rows.append((prefix, hits, misses, 100.0 * hits / total))
    if not rows:
        return
    lines.append("cache hit rates:")
    lines.append(f"  {'cache':<28}{'hits':>10}{'misses':>10}{'rate':>8}")
    for prefix, hits, misses, rate in rows:
        lines.append(f"  {prefix:<28}{int(hits):>10}{int(misses):>10}{rate:>7.1f}%")
    lines.append("")


def _rung_funnel(spans: List[Dict[str, Any]], lines: List[str]) -> None:
    rungs = [sp for sp in spans if sp["name"] == "rung_eval"]
    if not rungs:
        return
    lines.append("rung survival funnel:")
    lines.append(f"  {'bracket':>8}{'rung':>6}{'delta':>8}{'n':>6}{'ok':>6}"
                 f"{'promoted':>10}{'cost':>12}")
    for sp in rungs:
        a = sp["args"]
        cost = a.get("cost", 0.0)
        lines.append(
            f"  {a.get('s', '?'):>8}{a.get('rung', '?'):>6}"
            f"{a.get('delta', 0.0):>8.3f}{a.get('n', 0):>6}"
            f"{a.get('ok', 0):>6}{a.get('survivors', 0):>10}"
            f"{cost:>11.1f}s")
    lines.append("")


def _budget_attribution(counters: Dict[str, float], lines: List[str]) -> None:
    full = counters.get("budget/full_fidelity_s", 0.0)
    low = counters.get("budget/low_fidelity_s", 0.0)
    per = {name[len("budget/fidelity@"):-2]: v
           for name, v in counters.items()
           if name.startswith("budget/fidelity@") and name.endswith("_s")}
    if not (full or low or per):
        return
    total = full + low
    lines.append("budget attribution (virtual seconds charged):")
    if total:
        lines.append(f"  full fidelity : {full:>12.1f}s ({100.0 * full / total:5.1f}%)")
        lines.append(f"  low fidelity  : {low:>12.1f}s ({100.0 * low / total:5.1f}%)")
    for d, v in sorted(per.items(), key=lambda kv: float(kv[0])):
        lines.append(f"    delta={d:<8}: {v:>12.1f}s")
    lines.append("")


def _eval_outcomes(counters: Dict[str, float], lines: List[str]) -> None:
    rows = [(name, v) for name, v in sorted(counters.items())
            if name.startswith(("workload/", "eval/"))
            and not name.endswith("_s")]
    if not rows:
        return
    lines.append("evaluation outcomes:")
    for name, v in rows:
        lines.append(f"  {name:<32}{int(v) if float(v).is_integer() else v:>10}")
    lines.append("")


def _histograms(hists: List[Dict[str, Any]], lines: List[str]) -> None:
    shown = [h for h in hists if h.get("n", 0) > 0]
    if not shown:
        return
    lines.append("histograms:")
    for h in shown:
        mean = h["total"] / h["n"]
        lines.append(f"  {h['name']:<28} n={h['n']:<7} mean={mean:<12.4g}"
                     f" min={h['min']:<12.4g} max={h['max']:.4g}")
    lines.append("")


def summarize(events: List[Dict[str, Any]]) -> str:
    """Render a text report: stage breakdown, cache hit rates, rung
    funnel, budget attribution, evaluation outcomes, histogram digests."""
    spans = [e for e in events if e["type"] == "span"]
    metas = [e for e in events if e["type"] == "meta"]
    # last snapshot wins per (scope, name); global scope preferred for the
    # roll-ups, per-run scopes listed separately below.
    counters: Dict[str, float] = {}
    scoped: Dict[str, Dict[str, float]] = defaultdict(dict)
    hists: List[Dict[str, Any]] = []
    for e in events:
        if e["type"] in ("counter", "gauge"):
            if e.get("scope", "global") == "global":
                counters[e["name"]] = e["value"]
            else:
                scoped[e["scope"]][e["name"]] = e["value"]
        elif e["type"] == "histogram":
            hists.append(e)
    # fold per-run scopes into the roll-up where a name is absent globally
    merged: Dict[str, float] = defaultdict(float)
    for scope_vals in scoped.values():
        for name, v in scope_vals.items():
            merged[name] += v
    for name, v in merged.items():
        counters.setdefault(name, v)

    lines: List[str] = []
    if metas:
        m = metas[0]
        lines.append(f"trace: {m.get('name', '?')}  "
                     f"(events={len(events)}, spans={len(spans)}, "
                     f"dropped={m.get('dropped', 0)})")
        lines.append("")
    _stage_breakdown(spans, lines)
    _cache_rates(counters, lines)
    _rung_funnel(spans, lines)
    _budget_attribution(counters, lines)
    _eval_outcomes(counters, lines)
    _histograms(hists, lines)
    if scoped:
        lines.append(f"scopes: {', '.join(sorted(scoped))}")
    return "\n".join(lines).rstrip() + "\n"
