"""Online adaptive budget control for the serving loop.

``BudgetController`` is what ``ServingLoop`` consults instead of the
raw analytic ``engine.nfp_budget``: it owns a per-context-bucket
near-free WIDTH (decode positions per slot row) and adapts it AIMD-
style against the latency the loop actually observes:

  baseline   an EMA of per-forward latency at width 1 — the user-
             visible cost of one token, the denominator of the paper's
             Eq. 4 tolerance.  Seeded from a ``CalibrationTable`` when
             one is loaded; learned online otherwise (the loop serves
             width-1 steps until a baseline exists).
  shrink     multiplicative decrease when the observed latency ratio
             exceeds (1+eps)*(1+noise) for ``patience`` consecutive
             steps (the variance gate: one noisy spike is not evidence
             the knee moved — ``noise`` is the calibration sweep's own
             measured per-round spread, so the gate reuses the
             measurement path instead of re-deriving a noise model).
  probe      additive increase after a clean step, never within the
             ``cooldown`` window after a shrink, and never past the
             cap.

The width is clamped to ``[1, cap]`` where cap is the analytic budget
per active row — and, when a calibration table is loaded, additionally
the table's calibrated knee: probing past a boundary that was actually
measured would deliberately re-enter the region calibration proved
slow.  With a table, the controller therefore NEVER schedules a width
the calibration curve marked above-tolerance; without one, it is a
slow-start AIMD that converges onto the live knee from below.

Currency note: the controller thinks in width (positions per row); the
scheduler spends a TOTAL position budget.  ``budget()`` converts —
``width * n_active``, floored at one position per active request and
capped by the analytic total — so ``SlotAdapter.width(n_active,
budget)`` recovers exactly the controller's width.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.autotune.calibrate import CONTEXT_LADDER
from repro_torch.autotune.store import CalibrationTable

__all__ = ["ControllerConfig", "BudgetController"]


@dataclass
class ControllerConfig:
    eps: float = 0.2             # latency tolerance (the Eq. 4 eps)
    baseline_alpha: float = 0.25  # EMA weight of new width-1 samples
    shrink: float = 0.5          # multiplicative decrease factor
    probe: int = 1               # additive increase step
    cooldown: int = 8            # steps after a shrink before probing up
    patience: int = 2            # consecutive violations before a shrink
    noise_floor: float = 0.0     # minimum relative noise allowance
    baseline_grace: int = 4      # width>1 steps without a baseline before
    #                              falling back to the capped static budget


@dataclass
class _BucketState:
    width: int                   # current near-free width for this bucket
    cap: int                     # last effective cap (table & analytic)
    table_cap: Optional[int]     # calibrated knee (None without a table)
    baseline: Optional[float] = None   # EMA width-1 per-forward latency
    noise: float = 0.0           # relative noise allowance (variance gate)
    cooldown: int = 0
    violations: int = 0          # consecutive above-tolerance steps
    baseline_misses: int = 0     # width>1 observations with no baseline
    ratio_ema: Optional[float] = None
    shrinks: int = 0
    probes: int = 0
    gated: int = 0               # noisy steps the variance gate absorbed


class BudgetController:
    """AIMD near-free budget controller (see module docstring).

    ``mode`` / ``use_kernel`` select the calibration-table rows; the
    ``ServingLoop`` fills them in via ``bind`` when the controller is
    attached, so a freshly constructed ``BudgetController(table)`` is
    enough at the call site.
    """

    def __init__(self, table: Optional[CalibrationTable] = None,
                 config: Optional[ControllerConfig] = None,
                 mode: Optional[str] = None,
                 use_kernel: Optional[bool] = None):
        if config is None:
            config = ControllerConfig(eps=table.eps if table else 0.2)
        self.table = table
        self.config = config
        self.mode = mode
        self.use_kernel = use_kernel
        self._seed_baseline = True
        self._states: Dict[int, _BucketState] = {}

    # ------------------------------------------------------------------
    def bind(self, mode: str, use_kernel: bool,
             clocked: bool = False) -> None:
        """Attach-time defaults (explicit constructor args win).

        ``clocked`` says the loop feeds model-clock latencies rather
        than wall clock.  A table baseline only seeds the EMA when it
        comes from the SAME latency source as the observations —
        simulator seconds against wall-clock seconds would make every
        ratio garbage; when sources differ, the caps and noise floor
        still apply and the baseline is learned online."""
        if self.mode is None:
            self.mode = mode
        if self.use_kernel is None:
            self.use_kernel = bool(use_kernel)
        if self.table is not None:
            self._seed_baseline = clocked == (self.table.backend
                                              == "simulator")

    def _bucket(self, ell: int) -> int:
        """Smallest known bucket >= ell (conservative), else the largest
        — the table's own lookup rule when one is loaded."""
        if self.table is not None:
            entry = self.table.lookup(self.mode, ell, self.use_kernel)
            if entry is not None:
                return entry.ell
        above = [b for b in CONTEXT_LADDER if b >= ell]
        return min(above) if above else max(CONTEXT_LADDER)

    def _state(self, ell: int) -> _BucketState:
        b = self._bucket(ell)
        st = self._states.get(b)
        if st is None:
            table_cap = baseline = None
            noise = self.config.noise_floor
            if self.table is not None:
                entry = self.table.lookup(self.mode, b, self.use_kernel)
                if entry is not None:
                    table_cap = entry.calibrated_budget
                    if self._seed_baseline:
                        baseline = entry.baseline_time
                    noise = max(noise, entry.noise)
            # with a table: start AT the calibrated knee (it was measured
            # safe); without: slow-start from 1 and probe up
            st = _BucketState(width=table_cap if table_cap else 1,
                              cap=table_cap if table_cap else 1,
                              table_cap=table_cap, baseline=baseline,
                              noise=noise)
            self._states[b] = st
        return st

    # ------------------------------------------------------------------
    def budget(self, ell: int, n_active: int, analytic: int) -> int:
        """Total position budget for the next step, in the scheduler's
        currency.  Always in [1, max(analytic, n_active)]: the analytic
        budget is the hard cap, but every active request keeps its
        one-position floor (the scheduler's existing admission
        contract)."""
        st = self._state(ell)
        n_active = max(1, int(n_active))
        cap = max(1, int(analytic) // n_active)
        if st.table_cap is not None:
            cap = min(cap, st.table_cap)
        st.cap = cap
        if st.baseline is None:
            if st.baseline_misses < self.config.baseline_grace:
                # no baseline yet: serve width 1 until one exists —
                # these steps ARE the baseline measurement
                return n_active
            # the adapter never runs width-1 forwards (e.g. diffusion
            # with a fixed block size), so no baseline can ever form:
            # fall back to the capped static budget instead of
            # pretending to control
            return min(cap * n_active, max(int(analytic), n_active))
        w = max(1, min(st.width, cap))
        return min(w * n_active, max(int(analytic), n_active))

    def table_budget(self, ell: int, n_active: int,
                     analytic: int) -> Optional[int]:
        """What a STATIC calibrated budget would spend this step (total
        currency, same clamps as ``budget()`` minus the adaptation) —
        the telemetry midpoint between analytic and applied."""
        if self.table is None:
            return None
        w = self.table.budget(self.mode, self._bucket(ell), self.use_kernel)
        if w is None:
            return None
        n_active = max(1, int(n_active))
        return min(w * n_active, max(int(analytic), n_active))

    # ------------------------------------------------------------------
    def observe(self, ell: int, width: int, latency: float
                ) -> Optional[float]:
        """Feed one step's per-forward latency; returns the latency
        ratio vs the width-1 baseline (None when the step itself is a
        baseline sample or no baseline exists yet)."""
        st = self._state(ell)
        cfg = self.config
        latency = float(latency)
        if latency <= 0.0 or not math.isfinite(latency):
            return None
        if width <= 1:
            a = cfg.baseline_alpha
            st.baseline = (latency if st.baseline is None
                           else (1.0 - a) * st.baseline + a * latency)
            st.baseline_misses = 0
            st.violations = 0
            st.cooldown = max(0, st.cooldown - 1)
            self._maybe_probe(st)
            return None
        if st.baseline is None:
            st.baseline_misses += 1
            return None
        ratio = latency / st.baseline
        a = cfg.baseline_alpha
        st.ratio_ema = (ratio if st.ratio_ema is None
                        else (1.0 - a) * st.ratio_ema + a * ratio)
        threshold = (1.0 + cfg.eps) * (1.0 + max(st.noise, cfg.noise_floor))
        if ratio > threshold:
            st.violations += 1
            if st.violations >= cfg.patience:
                st.width = max(1, int(st.width * cfg.shrink))
                st.cooldown = cfg.cooldown
                st.shrinks += 1
                st.violations = 0
            else:
                st.gated += 1         # variance gate: wait for evidence
        else:
            st.violations = 0
            st.cooldown = max(0, st.cooldown - 1)
            self._maybe_probe(st)
        return ratio

    def _maybe_probe(self, st: _BucketState) -> None:
        if st.cooldown == 0 and st.width < st.cap:
            st.width = min(st.width + self.config.probe, st.cap)
            st.probes += 1

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        out = {"shrinks": 0, "probes": 0, "gated": 0, "buckets": {}}
        for b, st in sorted(self._states.items()):
            out["shrinks"] += st.shrinks
            out["probes"] += st.probes
            out["gated"] += st.gated
            out["buckets"][b] = {
                "width": st.width, "cap": st.cap,
                "table_cap": st.table_cap, "baseline_s": st.baseline,
                "noise": st.noise, "ratio_ema": st.ratio_ema,
                "shrinks": st.shrinks, "probes": st.probes,
                "gated": st.gated,
            }
        return out
