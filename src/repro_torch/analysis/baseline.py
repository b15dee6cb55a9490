"""Baseline store: suppress KNOWN findings, fail on NEW ones (the
reference's ``analysis/baseline.py`` mechanics).

The port's baseline is ``analysis-baseline.json`` beside this module (the
reference's file at the repository root is the reference's own) and holds

  suppressions          {fingerprint: {count, checker, rule, path,
                        symbol, message}} — the accepted debt.  The
                        fingerprint excludes line numbers (see
                        ``findings``), so unrelated edits don't churn
                        it; a count>1 covers duplicated snippets.
  granularity_contract  the pinned tile sizes the drift checker
                        compares against (never suppressible).

``--check-baseline`` exits non-zero iff a finding's fingerprint count
exceeds its suppressed count.  STALE suppressions (debt that got fixed)
are reported informationally — regenerate with ``--write-baseline`` to
drop them.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_NAME = "analysis-baseline.json"
BASELINE_PATH = Path(__file__).resolve().with_name(BASELINE_NAME)
VERSION = 1

# drift findings can only be cleared by updating the pinned contract
NEVER_SUPPRESS = {"granularity-drift"}


def load_baseline(path: Path) -> Dict:
    path = Path(path)
    if not path.exists():
        return {"version": VERSION, "suppressions": {},
                "granularity_contract": {}}
    data = json.loads(path.read_text())
    data.setdefault("suppressions", {})
    data.setdefault("granularity_contract", {})
    return data


def write_baseline(path: Path, findings: List[Finding],
                   contract: Optional[Dict[str, int]] = None) -> Dict:
    sup: Dict[str, Dict] = {}
    for f in findings:
        if f.checker in NEVER_SUPPRESS:
            continue
        entry = sup.setdefault(f.fingerprint, {
            "count": 0, "checker": f.checker, "rule": f.rule,
            "path": f.path, "symbol": f.symbol, "message": f.message,
        })
        entry["count"] += 1
    data = {
        "version": VERSION,
        "_comment": ("Known findings of `python -m repro_torch.analysis` — "
                     "suppressed debt, not a license. New findings fail "
                     "--check-baseline; regenerate ONLY via "
                     "--write-baseline so review sees the diff."),
        "granularity_contract": dict(sorted((contract or {}).items())),
        "suppressions": dict(sorted(sup.items())),
    }
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=False)
                          + "\n")
    return data


def diff_against_baseline(findings: List[Finding], baseline: Dict
                          ) -> Tuple[List[Finding], List[Finding],
                                     List[Dict]]:
    """(new, suppressed, stale): findings beyond the baselined count,
    findings the baseline absorbs, and baseline entries with no match
    left in the tree."""
    sup = baseline.get("suppressions", {})
    seen: Counter = Counter()
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        fp = f.fingerprint
        seen[fp] += 1
        allowed = 0 if f.checker in NEVER_SUPPRESS else \
            int(sup.get(fp, {}).get("count", 0))
        (suppressed if seen[fp] <= allowed else new).append(f)
    stale = [dict(entry, fingerprint=fp) for fp, entry in sup.items()
             if seen.get(fp, 0) < int(entry.get("count", 0))]
    return new, suppressed, stale
