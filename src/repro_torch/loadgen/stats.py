"""Latency statistics for trace replays: TTFT / inter-token latency
percentiles and goodput-under-SLO.

Percentiles come in the two conventions that actually disagree on
small samples (tests pin both against hand-computed fixtures):

  nearest_rank   classic ceil(q/100 * n)-th order statistic — always an
                 observed value, the convention most serving papers
                 report (and the BENCH headline here).
  linear         numpy-default interpolation between closest ranks.

Goodput is the paper-adjacent serving metric: tokens/s counting ONLY
requests that met their SLO class's targets (TTFT <= ttft_target and
p95 inter-token latency <= itl_target) — throughput you could sell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = ["RequestRecord", "itls", "percentile", "summarize", "ttft"]


def percentile(xs: Sequence[float], q: float,
               method: str = "nearest_rank") -> float:
    """q-th percentile (0 <= q <= 100) of ``xs``.

    Raises on an empty sample (a silent 0.0 would fabricate a latency);
    a one-sample list is its own percentile under both methods.
    """
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    s = sorted(float(x) for x in xs)
    n = len(s)
    if n == 0:
        raise ValueError("percentile of an empty sample")
    if n == 1:
        return s[0]
    if method == "nearest_rank":
        rank = max(1, math.ceil(q / 100.0 * n))   # 1-indexed
        return s[min(rank, n) - 1]
    if method == "linear":
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        if lo >= n - 1:
            return s[-1]
        frac = pos - lo
        return s[lo] + frac * (s[lo + 1] - s[lo])
    raise ValueError(f"unknown percentile method {method!r}")


@dataclass
class RequestRecord:
    """One request's replay timeline: when it arrived, when each token
    materialized on the virtual clock, and what the loop did to it."""

    rid: int
    slo_class: str
    tenant: str = ""
    arrival_s: float = 0.0
    token_times: List[float] = field(default_factory=list)
    rejected: bool = False
    preemptions: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.token_times)

    @property
    def first_token_s(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    @property
    def finish_s(self) -> Optional[float]:
        return self.token_times[-1] if self.token_times else None


def ttft(rec: RequestRecord) -> Optional[float]:
    """Time-to-first-token: queue wait + (re)prefill, arrival-relative."""
    if rec.first_token_s is None:
        return None
    return rec.first_token_s - rec.arrival_s


def itls(rec: RequestRecord) -> List[float]:
    """Inter-token latencies (gaps between consecutive emissions).
    Tokens decoded in the same parallel step share a timestamp, so a
    gap of 0.0 is real parallelism, not an artifact."""
    t = rec.token_times
    return [t[i + 1] - t[i] for i in range(len(t) - 1)]


def _met_slo(rec: RequestRecord, slo) -> bool:
    t = ttft(rec)
    if t is None or t > slo.ttft_target_s:
        return False
    gaps = itls(rec)
    if not gaps:                       # single-token stream: TTFT is all
        return True
    return percentile(gaps, 95) <= slo.itl_target_s


def _group(records: Sequence[RequestRecord], classes,
           makespan_s: float) -> Dict:
    done = [r for r in records if not r.rejected and r.token_times]
    out: Dict = {
        "requests": len(records),
        "completed": len(done),
        "rejected": sum(r.rejected for r in records),
        "preemptions": sum(r.preemptions for r in records),
        "tokens": sum(r.n_tokens for r in done),
    }
    span = max(makespan_s, 1e-12)
    out["throughput_tok_s"] = out["tokens"] / span
    if not done:
        out.update({"slo_attainment": None, "goodput_tok_s": 0.0})
        return out
    ttfts = [ttft(r) for r in done]
    gaps = [g for r in done for g in itls(r)]
    for q in (50, 95, 99):
        out[f"ttft_p{q}_s"] = percentile(ttfts, q)
    out["ttft_mean_s"] = sum(ttfts) / len(ttfts)
    for q in (50, 95, 99):
        out[f"itl_p{q}_s"] = percentile(gaps, q) if gaps else None
    met = [r for r in done if _met_slo(r, classes[r.slo_class])]
    out["slo_attainment"] = len(met) / len(done)
    out["goodput_tok_s"] = sum(r.n_tokens for r in met) / span
    return out


def summarize(records: Sequence[RequestRecord], classes,
              makespan_s: float) -> Dict:
    """Overall + per-SLO-class latency/goodput summary.

    ``classes`` maps class name -> ``serving.SLOClass``;
    ``makespan_s`` is the replay's total virtual time (throughput and
    goodput denominators)."""
    out = _group(records, classes, makespan_s)
    out["makespan_s"] = makespan_s
    per = {}
    for name in sorted({r.slo_class for r in records}):
        sub = [r for r in records if r.slo_class == name]
        per[name] = _group(sub, classes, makespan_s)
    out["per_class"] = per
    return out
