"""Host time of one serving call, split at its phase boundaries.

A span is one call of the serving loop (``serve.step``: a decode step,
``serve.admit``: an admission), and its phases are the stretches between
boundaries the code marks as it goes: ``time.perf_counter`` is read once
at each boundary, and the time since the last reading goes to the phase
that was running.  The phases of a call therefore sum to the whole call.
A phase may run several times in one call (a diffusion step's several
forwards); its seconds add up.

The phases' names are this module's constants, and every boundary is
marked with one of them.  One ``Phases`` belongs to an engine and times
whichever call is open on it.  A boundary of the other call's phases, or
one marked while no span is open, changes nothing: the captured graphs
mark the launch of every forward they replay, which only the decode
step's span splits off.  A name that is no phase raises.

A call that began while a profiler ran, or after one ran on the engine's
calls, is marked ``profiled`` in its log entry: its times hold the
profiler's cost.  That cost outlasts the profiler: once ``torch.profiler``
has traced the card, every CUDA graph launch of the process stays slower
(an H100's decode replay call 0.11 ms before, 8.6 ms under the profiler,
1.4 ms after it stopped), so only the calls before the first profiled
one time the program alone.

While a profiler runs (``torch.autograd._profiler_enabled()``, checked
once a call), the span and each phase also open a
``torch.profiler.record_function`` range named ``<span>.<phase>`` nested
in ``<span>``, so the phases sit on the profiler's timeline beside the
device's work.  With no profiler running no range is made: a
``record_function`` costs about as much as the rest of a span.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["ADMIT_PHASES", "BEGIN", "COMMIT", "LAUNCH", "PLAN", "PREFILL",
           "Phases", "SCATTER", "SELECT", "STEP_PHASES", "UPLOAD", "WAIT",
           "untimed"]

PLAN, UPLOAD, LAUNCH, WAIT, COMMIT = (
    "plan", "upload", "launch", "wait", "commit")
SELECT, PREFILL, SCATTER, BEGIN = "select", "prefill", "scatter", "begin"
#: the decode step's phases, in order (``ServingLoop.step``)
STEP_PHASES = (PLAN, UPLOAD, LAUNCH, WAIT, COMMIT)
#: an admission's phases, in order (``ServingLoop.admit``); it waits on
#: the device in its scatter's index upload and its first tokens' readback
ADMIT_PHASES = (SELECT, PREFILL, SCATTER, WAIT, BEGIN)
_NAMES = frozenset(STEP_PHASES + ADMIT_PHASES)


def untimed(log: Sequence[Dict]) -> List[Dict]:
    """A ``step_log`` or ``prefill_log`` without what the spans add to
    its entries (``host_*_s``, ``graph_device_s``, ``profiled``,
    ``rids``): the fields the reference's loop logs too."""
    return [{k: v for k, v in e.items()
             if not (k.startswith("host_") and k.endswith("_s"))
             and k not in ("graph_device_s", "profiled", "rids")}
            for e in log]


class Phases:
    """The phase clock of one engine's serving calls (module docstring)."""

    def __init__(self):
        self.span: Optional[str] = None      # the open call's name
        self.seconds: Dict[str, float] = {}
        self._phase = ""
        self._t0 = self._t = 0.0
        self._ranges: Optional[List] = None  # open ranges, under a profiler
        self._profiled = False

    def start(self, span: str, phases: Sequence[str]) -> float:
        """Open ``span`` in its first phase; returns the clock reading."""
        self._close_ranges()                 # a call that raised left them
        self.span = span
        self.seconds = dict.fromkeys(phases, 0.0)
        self._phase = phases[0]
        on = torch.autograd._profiler_enabled()
        self._profiled = self._profiled or on
        if on:
            self._ranges = [self._enter(span), self._enter(
                f"{span}.{self._phase}")]
        self._t0 = self._t = time.perf_counter()
        return self._t0

    def mark(self, phase: str) -> float:
        """A boundary: the time since the last reading goes to the running
        phase, and ``phase`` runs from here (the same phase again just
        takes a reading).  Returns the reading."""
        t = time.perf_counter()
        if phase not in self.seconds:
            if phase not in _NAMES:
                raise ValueError(f"{phase!r} is no phase of a serving "
                                 f"call: {sorted(_NAMES)}")
            return t
        self.seconds[self._phase] += t - self._t
        self._t = t
        if phase != self._phase:
            self._phase = phase
            if self._ranges is not None:
                self._exit(self._ranges.pop())
                self._ranges.append(self._enter(f"{self.span}.{phase}"))
        return t

    def stop(self, entry: Optional[Dict] = None) -> None:
        """Close the span, and write its seconds into ``entry`` (None
        drops them): ``host_<call>_s`` for the whole call (``serve.step``
        gives ``host_step_s``) and ``host_<phase>_s`` for each phase, and
        ``profiled`` if a profiler ran when the call or an earlier one
        began (module docstring)."""
        t = time.perf_counter()
        self.seconds[self._phase] += t - self._t
        self._close_ranges()
        if entry is not None:
            entry[f"host_{self.span.rsplit('.', 1)[-1]}_s"] = t - self._t0
            entry.update((f"host_{k}_s", v) for k, v in self.seconds.items())
            if self._profiled:
                entry["profiled"] = True
        self.span, self.seconds = None, {}

    def _close_ranges(self) -> None:
        if self._ranges is not None:
            while self._ranges:
                self._exit(self._ranges.pop())
            self._ranges = None

    @staticmethod
    def _enter(name: str):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        return rf

    @staticmethod
    def _exit(rf) -> None:
        rf.__exit__(None, None, None)
