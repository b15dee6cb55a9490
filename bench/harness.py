"""Finding a cell's pieces by name, running its driver, and printing the
result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``configs/<config>.json``, the file its ``configs`` entry
names) under a traffic mix or job (``traffic/<traffic>.json``, whose
``driver`` key names ``drivers/<driver>.py``), with the limits of its
output check in ``limits/<cell>.json``.  A driver's ``run(job)`` returns a
record; each metric the cell reports is ``read(record)`` of
``metrics/<metric>.py``, and a reader that finds nothing to read returns
None, which leaves the metric out of the line.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent
#: top-level module names the benchmark's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def entry(items: List[Dict], name: str, what: str) -> Dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}")


def cell_metrics(spec: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (an entry with ``workloads`` only in the
    cells it lists)."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict           # configs/<config>.json
    traffic: Dict          # traffic/<traffic>.json
    limits: Dict           # limits/<cell>.json
    metrics: List[Dict]    # the metric entries this run reports


def load_cell(root: Path, workload: str, trace: bool,
              bench_dir: Path = BENCH) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    w = entry(spec["workloads"], workload, "workload")
    c = entry(spec["configs"], w["config"], "configuration")
    return Cell(workload, int(w["chips"]), load_json(root / c["file"]),
                traffic(w["traffic"], bench_dir),
                load_json(bench_dir / "limits" / f"{workload}.json"),
                cell_metrics(spec, workload, trace))


def traffic(name: str, bench_dir: Path = BENCH) -> Dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: Path = BENCH):
    return _module(bench_dir / "drivers" / f"{name}.py",
                   f"bench_driver_{name}")


def reader(name: str, bench_dir: Path = BENCH) -> Callable:
    """``read(record) -> value or None`` of ``metrics/<name>.py``."""
    mod = _module(bench_dir / "metrics" / f"{name}.py",
                  "bench_metric_" + name.replace(".", "_"))
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, the device, and
    ``hooks`` (by name: tests plant faults or swap the program for the
    control through them; a benchmark run has none)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    hooks: Dict = field(default_factory=dict)


def execute(run: Run, bench_dir: Path = BENCH) -> Dict:
    """Run the cell's driver and assemble the result (every key but
    ``device``'s platform, kind and count)."""
    rec = driver(run.cell.traffic["driver"], bench_dir).run(run)
    metrics = {}
    for m in run.cell.metrics:
        value = reader(m["name"], bench_dir)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(rec["correct"]), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": dict(rec["device"])}
    if run.trace and rec.get("breakdown"):
        out["breakdown"] = rec["breakdown"]
    if "readings" in rec:
        out["readings"] = rec["readings"]
    out["checks"] = rec["checks"]
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float) -> int:
    import torch
    cell = load_cell(root, workload, trace)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the port on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = execute(Run(cell, seed, seconds, trace, t_start))
    found = forbidden_modules()
    if found:
        print(f"the process loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, **result["device"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
