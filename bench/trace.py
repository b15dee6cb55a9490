"""Reading one profiled stretch of a run (``torch.profiler``, CPU and CUDA
activity): the device's busy time as the union of the intervals of its
operations (kernels, copies, sets), time by operation name, and the idle
gaps between device operations named by what the host was doing.

The harness wraps its calls into the port in ``record_function`` spans
named ``bench.<what>``; a gap is named by the innermost such span that
covers its midpoint and the innermost host operation inside it, or
``(python)`` where the host ran no recorded operation.
"""
from __future__ import annotations

import heapq
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

Interval = Tuple[str, int, int]        # (name, start ns, end ns)


def _ns(evt, what: str) -> int:
    try:
        return int(getattr(evt, f"{what}_ns")())
    except AttributeError:
        return int(getattr(evt, f"{what}_us")() * 1000)


def _annotation(evt) -> bool:
    """A ``record_function`` span (on the host, or its mirror on the
    device's timeline): no device operation."""
    marked = getattr(evt, "is_user_annotation", None)
    return bool(marked()) if marked is not None else evt.name().startswith(
        "bench.")


def split_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host events) of a finished profile; the
    device's copies of the harness's spans are neither."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() != DeviceType.CUDA:
            host.append((e.name(), start, end))
        elif not _annotation(e):
            device.append((e.name(), start, end))
    return device, host


def merged(device: List[Interval]) -> List[Tuple[int, int]]:
    """The union of the device intervals, as disjoint sorted intervals."""
    out: List[List[int]] = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(active: List[Tuple[int, int, str]]) -> str:
    spans = [a for a in active if a[2].startswith("bench.")]
    ops = [a for a in active if not a[2].startswith("bench.")]
    span = max(spans)[2] if spans else "(outside bench spans)"
    op = max(ops)[2] if ops else "(python)"
    return f"{span}/{op}"


def idle_gaps(busy: List[Tuple[int, int]], host: List[Interval],
              lo: int, hi: int) -> Dict[str, float]:
    """Idle seconds between ``lo`` and ``hi`` by host label: for each gap
    between device intervals, the host events covering its midpoint."""
    gaps = []
    prev = lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    order = sorted(host, key=lambda x: x[1])
    out: Dict[str, float] = {}
    active: List[Tuple[int, int, str]] = []     # heap by end
    i = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (s + e) // 2
        while i < len(order) and order[i][1] <= mid:
            name, hs, he = order[i]
            heapq.heappush(active, (he, hs, name))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        # innermost = latest start among the events covering mid
        cover = [(hs, he, name) for he, hs, name in active]
        label = _label(cover)
        out[label] = out.get(label, 0.0) + (e - s) / 1e9
    return out


@dataclass
class Stretch:
    """The reduced profile of one stretch."""

    window_s: float
    busy_s: float
    ops: Dict[str, float]          # device seconds by operation name
    gaps: Dict[str, float]         # idle seconds by host label

    def op_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(v for k, v in self.ops.items() if rx.search(k))

    def top(self, table: Dict[str, float], n: int = 10) -> List[List]:
        return [[k[:160], v] for k, v in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def reduce(prof, window_s: float) -> Stretch:
    """The stretch ``prof`` traced, whose host-clock length was
    ``window_s`` (started after, and stopped after, a synchronize)."""
    device, host = split_events(prof)
    busy = merged(device)
    ops: Dict[str, float] = {}
    for name, s, e in device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    stamps = [s for _, s, _ in host + device] + [e for _, _, e in
                                                 host + device]
    lo, hi = (min(stamps), max(stamps)) if stamps else (0, 0)
    return Stretch(window_s, sum(e - s for s, e in busy) / 1e9, ops,
                   idle_gaps(busy, host, lo, hi))
