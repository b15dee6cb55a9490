"""CLI: ``python -m repro_torch.analysis [--check-baseline|--write-baseline]``.

Exit codes: 0 clean (or informational run), 1 usage/internal error,
2 NEW findings under ``--check-baseline`` (the gate).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import (granularity_drift, host_sync,
                                  kernel_contracts, recapture)
from repro_torch.analysis.callgraph import PACKAGE, Project
from repro_torch.analysis.findings import Finding, sort_findings

CHECKERS = ("host-sync", "recapture-hazard", "kernel-contract",
            "granularity-drift")
BASELINE_REL = Path("src") / PACKAGE / "analysis" / baseline_mod.BASELINE_NAME


def find_repo_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor holding ``src/repro_torch``; falls back to this
    package's own checkout."""
    probes = []
    if start is not None:
        probes.append(Path(start).resolve())
    probes.append(Path.cwd())
    probes.append(Path(__file__).resolve().parents[3])
    for probe in probes:
        for cand in (probe, *probe.parents):
            if (cand / "src" / PACKAGE).is_dir():
                return cand
    return Path(__file__).resolve().parents[3]


def run_checkers(src_dir: Path, checkers: Sequence[str] = CHECKERS,
                 roots: Sequence[str] = host_sync.DEFAULT_ROOTS,
                 rel_to: Optional[Path] = None,
                 contract: Optional[Dict[str, int]] = None,
                 records=None) -> List[Finding]:
    """Run the named checkers: the AST ones over ``src_dir/repro_torch``,
    the launch ones over the importable package's kernels, at
    ``records`` (by default the twelve configs' launches)."""
    findings: List[Finding] = []
    need_ast = {"host-sync", "recapture-hazard"} & set(checkers)
    project = Project(src_dir, rel_to=rel_to) if need_ast else None
    if "host-sync" in checkers:
        findings += host_sync.check(project, roots=roots)
    if "recapture-hazard" in checkers:
        findings += recapture.check(project)
    need_launches = {"kernel-contract", "granularity-drift"} & set(checkers)
    if need_launches and records is None:
        records = kernel_contracts.config_launches()
    if "kernel-contract" in checkers:
        findings += kernel_contracts.check(records=records)
    if "granularity-drift" in checkers:
        findings += granularity_drift.check(records=records,
                                            contract=contract)
    return sort_findings(findings)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Hot-path static analysis of the port: host syncs, "
                    "recapture hazards, CUDA launch contracts, tile drift.")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--checkers", default=",".join(CHECKERS),
                    help="comma-separated subset of: " + ", ".join(CHECKERS))
    ap.add_argument("--roots", default=",".join(host_sync.DEFAULT_ROOTS),
                    help="hot-path entry points for host-sync reachability")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline path (default <root>/{BASELINE_REL})")
    ap.add_argument("--check-baseline", action="store_true",
                    help="exit 2 if any finding is not in the baseline "
                         "(the gate)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline (suppressions + pinned "
                         "granularity contract) from the current tree")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list baseline-suppressed findings")
    args = ap.parse_args(argv)

    root = find_repo_root(args.root)
    src_dir = root / "src"
    if not (src_dir / PACKAGE).is_dir():
        print(f"error: no src/{PACKAGE} under {root}", file=sys.stderr)
        return 1
    checkers = [c.strip() for c in args.checkers.split(",") if c.strip()]
    bad = [c for c in checkers if c not in CHECKERS]
    if bad:
        print(f"error: unknown checkers {bad}; valid: {list(CHECKERS)}",
              file=sys.stderr)
        return 1
    roots = [r.strip() for r in args.roots.split(",") if r.strip()]
    bl_path = args.baseline or root / BASELINE_REL
    bl = baseline_mod.load_baseline(bl_path)

    findings = run_checkers(src_dir, checkers, roots=roots, rel_to=root,
                            contract=bl.get("granularity_contract"))

    if args.write_baseline:
        contract = granularity_drift.declared_tiles()
        data = baseline_mod.write_baseline(bl_path, findings, contract)
        n = sum(e["count"] for e in data["suppressions"].values())
        print(f"wrote {bl_path}: {n} suppressed finding(s), contract "
              f"{contract}")
        return 0

    new, suppressed, stale = baseline_mod.diff_against_baseline(findings, bl)
    shown = new if args.check_baseline else findings

    if args.as_json:
        print(json.dumps({
            "findings": [f.as_dict() for f in shown],
            "suppressed": [f.as_dict() for f in suppressed],
            "stale_suppressions": stale,
            "checkers": checkers,
        }, indent=2))
    else:
        for f in shown:
            print(f.render())
        if args.show_suppressed:
            for f in suppressed:
                print(f"[baseline] {f.render()}")
        summary = (f"{len(findings)} finding(s): {len(new)} new, "
                   f"{len(suppressed)} baselined")
        if stale:
            summary += (f"; {len(stale)} stale baseline entr"
                        f"{'y' if len(stale) == 1 else 'ies'} "
                        "(fixed debt — regenerate with --write-baseline)")
        print(summary)

    if args.check_baseline and new:
        if not args.as_json:
            print(f"FAIL: {len(new)} new finding(s) not in "
                  f"{bl_path.name}", file=sys.stderr)
        return 2
    return 0
