"""NFP measurement protocol (paper App. C.1.2-C.1.3).

Works on any latency source: torch work timed by ``time_callable`` (CUDA
events on the card, the host clock on the CPU), the roofline simulator
(``core.simulate``), or recorded curves.  The curve, knee and staircase
code is a copy of the reference's framework-free ``core.measure``.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEFAULT_EPS = 0.2


@dataclass
class LatencyCurve:
    ns: List[int]
    times: List[float]
    baseline_n: int = 1
    # optional per-sample relative spread (max-min over round medians,
    # normalized by the median) from ``time_callable`` — the noise floor
    # the autotune controller's variance gate reuses.  Empty for
    # simulated / recorded curves (deterministic sources).
    spreads: List[float] = field(default_factory=list)

    @property
    def baseline_time(self) -> float:
        if self.baseline_n not in self.ns:
            raise ValueError(
                f"baseline_n={self.baseline_n} was not sampled: the curve "
                f"covers N in {sorted(self.ns)}.  Add the baseline to the "
                "sweep (for balanced MoE use balanced_moe_baseline_n).")
        return self.times[self.ns.index(self.baseline_n)]

    @property
    def max_spread(self) -> float:
        """Largest relative per-round spread across the sweep — a single
        scalar noise floor for tolerance gating (0 when unknown)."""
        return max(self.spreads, default=0.0)

    def as_dict(self) -> Dict[int, float]:
        return dict(zip(self.ns, self.times))


def extract_nmax(curve: LatencyCurve, eps: float = DEFAULT_EPS,
                 contiguous: bool = False) -> int:
    """Eq. 4 / Eq. 24: largest sampled N with T(N) <= (1+eps)*T(baseline).

    ``contiguous=True`` stops at the FIRST above-tolerance N past the
    baseline instead of taking the global max, so a single lucky sample
    beyond the knee of a noisy wall-clock curve cannot inflate N_max."""
    t0 = curve.baseline_time
    best = curve.baseline_n
    for n, t in sorted(zip(curve.ns, curve.times)):
        if n < curve.baseline_n:
            continue
        if t <= (1.0 + eps) * t0:
            best = max(best, n)
        elif contiguous:
            break
    return best


def balanced_moe_baseline_n(n_experts: int, b: int, k: int) -> int:
    """Eq. 26: N_bal0 = ceil(E / (b*k)) — smallest N activating all experts."""
    return math.ceil(n_experts / (b * k))


def sensitivity_sweep(curve: LatencyCurve,
                      eps_values: Sequence[float] = (0.05, 0.10, 0.15, 0.20, 0.30),
                      ) -> Dict[float, int]:
    """App. I tolerance sweep."""
    return {eps: extract_nmax(curve, eps) for eps in eps_values}


# ---------------------------------------------------------------------------
# Timing: warmup, then R rounds x I iterations, median of per-round medians
# ---------------------------------------------------------------------------

def time_callable(fn: Callable[[], object], warmup: int = 3, rounds: int = 5,
                  iters: int = 10,
                  device: Optional[torch.device] = None
                  ) -> Tuple[float, float]:
    """Returns ``(median, spread)`` in seconds: the median of per-round
    medians and the relative per-round spread ``(max - min) / median`` —
    the measured noise floor the controller's variance gate reads.

    On a CUDA ``device`` every call is bracketed by CUDA events recorded
    on the current stream, read after one synchronize per round, so a
    sample is the device time from the call's first enqueued work to its
    last (host gaps between the calls of a round are not in it).  On the
    CPU (``device`` None or cpu) the host clock times each call."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    round_medians = []
    for _ in range(rounds):
        samples = []
        if cuda:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(iters)]
            for start, end in events:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize(device)
            samples = [start.elapsed_time(end) * 1e-3
                       for start, end in events]
        else:
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                samples.append(time.perf_counter() - t0)
        round_medians.append(statistics.median(samples))
    med = statistics.median(round_medians)
    spread = ((max(round_medians) - min(round_medians)) / med
              if med > 0 else 0.0)
    return med, spread


def sweep_callable(make_fn: Callable[[int], Callable[[], object]],
                   n_values: Sequence[int], baseline_n: int = 1,
                   warmup: int = 3, rounds: int = 5, iters: int = 10,
                   device: Optional[torch.device] = None) -> LatencyCurve:
    """Measure T(N) over a sweep.  ``make_fn(n)`` returns a zero-arg callable
    executing one decode forward with n positions (built outside the timed
    region, matching App. C.1.3's pre-allocation discipline)."""
    ns, times, spreads = [], [], []
    for n in n_values:
        fn = make_fn(int(n))
        med, spread = time_callable(fn, warmup, rounds, iters, device)
        times.append(med)
        spreads.append(spread)
        ns.append(int(n))
    return LatencyCurve(ns, times, baseline_n, spreads)


def staircase_boundaries(ns: Sequence[int], values: Sequence[float],
                         rel_jump: float = 0.05) -> List[int]:
    """Detect discrete staircase steps in a metric (runtime FLOPs / AI):
    the paper's RQ3 signature of granularity-governed execution."""
    steps = []
    for i in range(1, len(ns)):
        if values[i - 1] > 0 and (values[i] - values[i - 1]) / values[i - 1] > rel_jump:
            steps.append(int(ns[i]))
    return steps
