"""Order statistics over all of a window's samples (a copy of the
port's ``loadgen.stats.percentile``, nearest-rank convention)."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """The ceil(q/100 * n)-th smallest of ``xs`` (an observed value)."""
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    s = sorted(float(x) for x in xs)
    if not s:
        raise ValueError("percentile of an empty sample")
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]
