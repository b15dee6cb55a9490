"""Calibration artifact schema + persistence.

A ``CalibrationTable`` is the durable product of one calibration run
(``autotune.calibrate``): per (serve mode, context-length bucket,
kernel on/off) it records the measured T(N) curve, the empirical knee,
and the analytic prediction it refines.  Tables round-trip through JSON
so a calibration run on real hardware can be shipped with a deployment
and loaded at serve time (``launch.serve --calibration load``).

Artifacts are keyed by a fingerprint of everything the curve depends
on: the architecture config, the hardware spec, the granularity spec,
the kernel flags the sweep covered, the batch (slot count), and the
tolerance eps.  Loading an artifact whose key does not match the
current engine REFUSES with a clear error instead of silently applying
budgets calibrated for a different model/hardware — a stale budget that
over-spends positions is exactly the failure mode calibration exists to
remove.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

__all__ = ["SCHEMA_VERSION", "CalibrationEntry", "CalibrationTable",
           "CalibrationMismatchError", "spec_fingerprint", "save_table",
           "load_table"]


class CalibrationMismatchError(ValueError):
    """A calibration artifact does not match the current engine spec."""


def spec_fingerprint(cfg, hw, gran, kernel_flags, batch: int,
                     eps: float) -> str:
    """Stable hash of everything a calibration curve depends on.

    ``cfg`` / ``hw`` / ``gran`` are the (frozen) ArchConfig /
    HardwareSpec / GranularitySpec dataclasses; ``kernel_flags`` the
    kernel settings the sweep covered.  Any change to any field — a new
    head count, a different HBM bandwidth, a different KV page size —
    changes the key, so stale artifacts cannot load.
    """
    payload = {
        "schema": SCHEMA_VERSION,
        "arch": dataclasses.asdict(cfg),
        "hardware": dataclasses.asdict(hw),
        "granularity": dataclasses.asdict(gran),
        "kernel_flags": sorted({bool(k) for k in kernel_flags}),
        "batch": int(batch),
        "eps": round(float(eps), 6),
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class CalibrationEntry:
    """One calibrated (mode, context bucket, kernel) cell.

    ``measured_nmax`` and ``analytic_nmax`` are both in WIDTH currency:
    decode positions per slot row of one (batch, N)-shaped forward —
    the same N the paper's Eq. 4 extracts and ``parallelism_budget``
    predicts at this batch.
    """

    mode: str                   # serve mode the entry was swept for
    ell: int                    # context-length bucket (positions)
    use_kernel: bool            # hand-written kernels on/off
    eps: float                  # tolerance the knee was extracted at
    ns: List[int]               # sampled widths
    times: List[float]          # T(N) seconds per forward
    spreads: List[float]        # relative per-round spread (0 = exact)
    baseline_time: float        # T(1) — the width-1 serving baseline
    noise: float                # max relative spread (variance-gate floor)
    measured_nmax: int          # empirical knee (contiguous extraction)
    analytic_nmax: int          # core.nfp.parallelism_budget at this bucket
    n_idle: float               # pure idle-compute intuition (Table 24)
    limiting: str               # predict_model's limiting term

    @property
    def calibrated_budget(self) -> int:
        """Calibration refines the analytic budget DOWNWARD only: the
        measured knee is trusted when it is earlier than the analytic
        boundary (the paper's over-prediction finding), but a knee
        sampled PAST the analytic boundary never raises the budget —
        the analytic min already encodes granularity facts a coarse
        sweep can miss between samples."""
        return max(1, min(self.measured_nmax, self.analytic_nmax))

    @property
    def overprediction(self) -> float:
        """How far the analytic budget over-predicts the deployable one
        (>= 1 by construction of ``calibrated_budget``)."""
        return self.analytic_nmax / self.calibrated_budget

    @property
    def idle_overprediction(self) -> float:
        """The paper's Table 24 ratio: idle-compute intuition vs the
        calibrated boundary (up to ~23x)."""
        if not (self.n_idle == self.n_idle):          # NaN guard
            return float("inf")
        return self.n_idle / self.calibrated_budget


@dataclass
class CalibrationTable:
    """All calibration entries for one (arch, hardware, batch, eps)."""

    key: str
    arch: str
    hardware: str
    batch: int
    eps: float
    backend: str                # "simulator" | "wallclock"
    entries: List[CalibrationEntry] = field(default_factory=list)

    # ------------------------------------------------------------------
    def _candidates(self, mode: Optional[str],
                    use_kernel: Optional[bool]) -> List[CalibrationEntry]:
        es = [e for e in self.entries
              if use_kernel is None or e.use_kernel == bool(use_kernel)]
        exact = [e for e in es if mode is None or e.mode == mode]
        # the decode forward is mode-independent, so a table calibrated
        # for other modes is still a valid latency model — fall back
        # rather than flying blind
        return exact or es

    def lookup(self, mode: Optional[str], ell: int,
               use_kernel: Optional[bool] = None
               ) -> Optional[CalibrationEntry]:
        """Entry for the smallest bucket >= ell (conservative: boundaries
        shrink as context grows), else the largest bucket."""
        cands = self._candidates(mode, use_kernel)
        if not cands:
            return None
        above = [e for e in cands if e.ell >= ell]
        pool = above or cands
        return min(pool, key=lambda e: (e.ell if above else -e.ell))

    def budget(self, mode: Optional[str], ell: int,
               use_kernel: Optional[bool] = None) -> Optional[int]:
        e = self.lookup(mode, ell, use_kernel)
        return e.calibrated_budget if e is not None else None

    def baseline(self, mode: Optional[str], ell: int,
                 use_kernel: Optional[bool] = None
                 ) -> Optional[Tuple[float, float]]:
        """(width-1 latency, noise floor) for seeding the controller."""
        e = self.lookup(mode, ell, use_kernel)
        return (e.baseline_time, e.noise) if e is not None else None

    def buckets(self) -> List[int]:
        return sorted({e.ell for e in self.entries})

    # ------------------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "schema": SCHEMA_VERSION,
            "key": self.key,
            "arch": self.arch,
            "hardware": self.hardware,
            "batch": self.batch,
            "eps": self.eps,
            "backend": self.backend,
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }

    @classmethod
    def from_json(cls, data: Dict) -> "CalibrationTable":
        return cls(
            key=data["key"], arch=data["arch"], hardware=data["hardware"],
            batch=int(data["batch"]), eps=float(data["eps"]),
            backend=data.get("backend", "unknown"),
            entries=[CalibrationEntry(**e) for e in data["entries"]],
        )


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def save_table(table: CalibrationTable, path: str) -> None:
    with open(path, "w") as f:
        json.dump(table.to_json(), f, indent=1, sort_keys=True)


def load_table(path: str, expect_key: Optional[str] = None
               ) -> CalibrationTable:
    """Load an artifact, refusing schema/key mismatches loudly."""
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA_VERSION:
        raise CalibrationMismatchError(
            f"calibration artifact {path} has schema version "
            f"{data.get('schema')!r}, this build reads {SCHEMA_VERSION}; "
            "re-run with --calibration run to refresh it")
    table = CalibrationTable.from_json(data)
    if expect_key is not None and table.key != expect_key:
        raise CalibrationMismatchError(
            f"stale calibration artifact {path}: calibrated under key "
            f"{table.key} (arch={table.arch}, hardware={table.hardware}, "
            f"batch={table.batch}, eps={table.eps}) but the current engine "
            f"spec hashes to {expect_key}.  The arch config, hardware "
            "spec, granularity (incl. KV page size), kernel flags, slot "
            "count, or eps changed since calibration — re-run with "
            "--calibration run")
    return table
