"""Numbers and limits to ``correct``: the one rule by which the program's
run, and the control put in its place, are judged.

A cell's limits file (``limits/<cell>.json``) gives each compared number
its limit.  A run is correct where every number the file names was read
and lies at or under its limit, and every count in ``at_least`` reaches
its floor (a check that compared nothing is not a pass).  A number the
file does not name is read, not compared.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float],
          at_least: Optional[Dict[str, Tuple[float, float]]] = None
          ) -> Tuple[Dict[str, Dict], bool]:
    """(checks, correct): each compared number beside its limit, and
    whether all of them hold.  ``at_least`` maps a name to (count,
    floor)."""
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    for k, (value, floor) in (at_least or {}).items():
        checks[k] = {"value": value, "limit": floor}
        ok = ok and value >= floor
    return checks, bool(ok)
