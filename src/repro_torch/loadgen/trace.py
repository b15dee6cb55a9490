"""Seeded, deterministic production-shaped traces.

A trace is a list of ``TraceRequest`` rows (arrival time, prompt
tokens, output length, tenant, SLO class) generated from a
``TraceSpec`` by ONE ``np.random.default_rng(seed)`` stream, so the
same spec always yields the byte-identical trace (the property tests
lock this down, and ``Trace.fingerprint`` pins it in BENCH artifacts).

Production shape, not microbenchmark shape:

  arrivals   Poisson (memoryless, the classic open-loop model) or a
             2-state MMPP (Markov-modulated Poisson: calm/burst rates
             with switch probabilities) for the bursty traffic that
             actually stresses admission control and preemption.
  lengths    heavy-tail mixes — bounded Pareto (tail index ``alpha``)
             or clamped lognormal — because production prompt/output
             lengths are famously not uniform: a fat tail of long
             requests is what fragments the KV pool.
  tenants    weighted multi-tenant mix; each tenant carries an SLO
             class (``repro_torch.serving.DEFAULT_SLO_CLASSES`` names) and
             optionally a SHARED PREFIX: a per-tenant system-prompt
             token block reused (with probability ``share_prob``) at
             the head of its requests, so replays exercise the paged
             engine's prefix cache the way fleet traffic does.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ArrivalSpec", "LengthSpec", "TenantSpec", "Trace",
           "TraceRequest", "TraceSpec", "generate_trace", "pinned_spec"]


@dataclass(frozen=True)
class ArrivalSpec:
    """Arrival process: ``poisson`` (rate_rps) or 2-state ``mmpp``
    (calm ``rate_rps`` / ``burst_rate_rps``, per-arrival switch
    probabilities)."""

    kind: str = "poisson"
    rate_rps: float = 8.0
    burst_rate_rps: float = 40.0
    p_enter_burst: float = 0.1
    p_exit_burst: float = 0.3


@dataclass(frozen=True)
class LengthSpec:
    """Token-length distribution clamped to [lo, hi]: ``pareto``
    (bounded, tail index ``alpha``), ``lognormal`` (``mu``/``sigma`` in
    log-token space), or ``fixed`` (always ``lo``)."""

    dist: str = "pareto"
    lo: int = 4
    hi: int = 64
    alpha: float = 1.2
    mu: float = 2.0
    sigma: float = 0.6


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: selection ``weight``, SLO class, and an optional
    shared prefix of ``shared_prefix_len`` tokens prepended (with
    probability ``share_prob``) to its prompts."""

    name: str
    slo_class: str = "default"
    weight: float = 1.0
    shared_prefix_len: int = 0
    share_prob: float = 1.0


@dataclass(frozen=True)
class TraceRequest:
    """One traced request; ``rid`` is the arrival index."""

    rid: int
    arrival_s: float
    prompt: Tuple[int, ...]
    max_tokens: int
    tenant: str
    slo_class: str


@dataclass(frozen=True)
class TraceSpec:
    seed: int = 0
    n_requests: int = 32
    vocab_size: int = 1024
    arrivals: ArrivalSpec = field(default_factory=ArrivalSpec)
    prompt_lens: LengthSpec = field(default_factory=LengthSpec)
    output_lens: LengthSpec = field(
        default_factory=lambda: LengthSpec(dist="lognormal", lo=2, hi=32))
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)


@dataclass(frozen=True)
class Trace:
    spec: TraceSpec
    requests: Tuple[TraceRequest, ...]

    def to_json(self) -> str:
        """Canonical JSON (sorted keys, no whitespace variance) — the
        byte string ``fingerprint`` hashes."""
        return json.dumps(asdict(self), sort_keys=True,
                          separators=(",", ":"))

    @staticmethod
    def from_json(text: str) -> "Trace":
        d = json.loads(text)
        s = d["spec"]
        spec = TraceSpec(
            seed=s["seed"], n_requests=s["n_requests"],
            vocab_size=s["vocab_size"],
            arrivals=ArrivalSpec(**s["arrivals"]),
            prompt_lens=LengthSpec(**s["prompt_lens"]),
            output_lens=LengthSpec(**s["output_lens"]),
            tenants=tuple(TenantSpec(**t) for t in s["tenants"]))
        reqs = tuple(TraceRequest(
            rid=r["rid"], arrival_s=r["arrival_s"],
            prompt=tuple(r["prompt"]), max_tokens=r["max_tokens"],
            tenant=r["tenant"], slo_class=r["slo_class"])
            for r in d["requests"])
        return Trace(spec, reqs)

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


# ----------------------------------------------------------------------
def _sample_gap(rng: np.random.Generator, spec: ArrivalSpec,
                state: List[bool]) -> float:
    """One inter-arrival gap; ``state`` is the MMPP burst flag (boxed
    so the caller's state threads through)."""
    if spec.kind == "poisson":
        return float(rng.exponential(1.0 / spec.rate_rps))
    if spec.kind != "mmpp":
        raise ValueError(f"unknown arrival kind {spec.kind!r}")
    rate = spec.burst_rate_rps if state[0] else spec.rate_rps
    gap = float(rng.exponential(1.0 / rate))
    flip = float(rng.random())
    if state[0]:
        state[0] = flip >= spec.p_exit_burst
    else:
        state[0] = flip < spec.p_enter_burst
    return gap


def _sample_len(rng: np.random.Generator, spec: LengthSpec) -> int:
    lo, hi = int(spec.lo), int(spec.hi)
    if lo > hi:
        raise ValueError(f"LengthSpec lo={lo} > hi={hi}")
    if spec.dist == "fixed" or lo == hi:
        return lo
    if spec.dist == "pareto":
        # bounded-Pareto inverse CDF on [lo, hi], tail index alpha
        u = float(rng.random())
        a = float(spec.alpha)
        ratio = (lo / hi) ** a
        x = lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / a)
    elif spec.dist == "lognormal":
        x = float(rng.lognormal(spec.mu, spec.sigma))
    else:
        raise ValueError(f"unknown length dist {spec.dist!r}")
    return int(min(hi, max(lo, round(x))))


def generate_trace(spec: TraceSpec) -> Trace:
    """Materialize ``spec`` with one seeded RNG stream (fully
    deterministic: same spec -> byte-identical trace)."""
    if not spec.tenants:
        raise ValueError("TraceSpec needs at least one tenant")
    rng = np.random.default_rng(spec.seed)
    # per-tenant shared prefixes, drawn up front in declaration order
    prefixes: Dict[str, np.ndarray] = {}
    for t in spec.tenants:
        if t.shared_prefix_len > 0:
            prefixes[t.name] = rng.integers(
                0, spec.vocab_size, size=t.shared_prefix_len)
    weights = np.asarray([t.weight for t in spec.tenants], float)
    if weights.sum() <= 0:
        raise ValueError("tenant weights must sum > 0")
    weights = weights / weights.sum()
    burst = [False]
    now = 0.0
    requests = []
    for rid in range(spec.n_requests):
        now += _sample_gap(rng, spec.arrivals, burst)
        tenant = spec.tenants[int(rng.choice(len(spec.tenants), p=weights))]
        p_len = _sample_len(rng, spec.prompt_lens)
        n_out = _sample_len(rng, spec.output_lens)
        prefix = prefixes.get(tenant.name)
        share = prefix is not None and float(rng.random()) < tenant.share_prob
        if share and p_len > len(prefix):
            # shared head + a unique tail (>= 1 token, so streams and
            # prefix-cache suffixes still differ per request)
            tail = rng.integers(0, spec.vocab_size,
                                size=p_len - len(prefix))
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, spec.vocab_size, size=p_len)
        requests.append(TraceRequest(
            rid=rid, arrival_s=round(now, 9),
            prompt=tuple(int(x) for x in prompt),
            max_tokens=n_out, tenant=tenant.name,
            slo_class=tenant.slo_class))
    return Trace(spec, tuple(requests))


def pinned_spec(seed: int = 20260808, n_requests: int = 32,
                vocab_size: int = 1024,
                max_prompt: int = 48, max_output: int = 16,
                rate_rps: float = 60.0) -> TraceSpec:
    """The pinned BENCH trace shape: bursty MMPP arrivals, heavy-tail
    lengths, an interactive tenant, a shared-prefix fleet tenant (its
    16-token prefix fills a whole block_size=16 KV block, so replays
    hit the prefix cache), and a batch tenant that preemption can
    victimize.  The spec is the reference's, byte for byte (its rates
    were set near the reference's simulated service rate so bursts
    build queue pressure); ``launch.serve --trace pinned`` replays it
    through ``PINNED_STACK``."""
    return TraceSpec(
        seed=seed, n_requests=n_requests, vocab_size=vocab_size,
        arrivals=ArrivalSpec(kind="mmpp", rate_rps=rate_rps,
                             burst_rate_rps=4 * rate_rps,
                             p_enter_burst=0.2, p_exit_burst=0.3),
        prompt_lens=LengthSpec(dist="pareto", lo=6, hi=max_prompt,
                               alpha=1.2),
        output_lens=LengthSpec(dist="lognormal", lo=2, hi=max_output,
                               mu=1.8, sigma=0.5),
        tenants=(
            TenantSpec("chat", slo_class="interactive", weight=3.0),
            TenantSpec("fleet", slo_class="default", weight=4.0,
                       shared_prefix_len=16, share_prob=0.9),
            TenantSpec("offline", slo_class="batch", weight=2.0),
        ))
