"""Finding records + inline suppression pragmas (a copy of the reference's
``analysis/findings.py``).

A finding's FINGERPRINT deliberately excludes the line number: baselines
must survive unrelated edits shifting code up or down, so identity is
(checker, rule, file, enclosing symbol, normalized source snippet).  Two
identical snippets in the same symbol collapse to one fingerprint; the
baseline stores a count so a second occurrence still surfaces as new.

Inline pragmas mark SANCTIONED syncs (e.g. the one (batch, width) i32
token transfer every serving loop fundamentally needs)::

    preds = greedy_tokens(logits).cpu().numpy()  # analysis: allow-host-sync

``allow-<checker>`` suppresses any rule of that checker on the lines the
flagged expression spans; ``allow-<rule>`` (e.g. ``allow-hs002``) only
that rule.  Pragma suppressions are invisible in default output (they
are design decisions, not debt) — ``--show-suppressed`` lists them.
"""
from __future__ import annotations

import ast
import hashlib
import re
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Set

PRAGMA_RE = re.compile(r"#\s*analysis:\s*allow-([a-z0-9_-]+)")


@dataclass(frozen=True)
class Finding:
    checker: str          # "host-sync" | "recapture-hazard" | ...
    rule: str             # "HS001", ...
    path: str             # repo-relative posix path
    line: int
    symbol: str           # enclosing function qualname (or module)
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        basis = "|".join([self.checker, self.rule, self.path, self.symbol,
                          " ".join(self.snippet.split())])
        return hashlib.sha256(basis.encode()).hexdigest()[:16]

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        head = f"{self.path}:{self.line}: [{self.checker}/{self.rule}]"
        src = f"\n      {self.snippet}" if self.snippet else ""
        return f"{head} {self.symbol}: {self.message}{src}"


def scan_pragmas(source: str) -> Dict[int, Set[str]]:
    """{1-based line: set of allow-tokens} for one file's source."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        toks = {m.lower() for m in PRAGMA_RE.findall(text)}
        if toks:
            out[i] = toks
    return out


def pragma_allows(pragmas: Dict[int, Set[str]], node: ast.AST,
                  checker: str, rule: str) -> bool:
    """True when an ``# analysis: allow-...`` pragma covers ``node``."""
    lo = getattr(node, "lineno", None)
    if lo is None:
        return False
    hi = getattr(node, "end_lineno", lo) or lo
    want = {checker.lower(), rule.lower()}
    for ln in range(lo, hi + 1):
        if pragmas.get(ln, set()) & want:
            return True
    return False


def snippet_of(source: str, node: ast.AST, limit: int = 160) -> str:
    seg: Optional[str] = None
    try:
        seg = ast.get_source_segment(source, node)
    except Exception:
        seg = None
    if not seg:
        return ""
    seg = " ".join(seg.split())
    return seg if len(seg) <= limit else seg[:limit - 3] + "..."


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings,
                  key=lambda f: (f.checker, f.path, f.line, f.rule))
