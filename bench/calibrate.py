"""Readings for a cell's output-check limit: the program's and the
control's numbers over many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control] [--fault <name>] [--out <file>]

Each seed is a whole run of the cell (set-up, a window of ``seconds``,
the check) with the reference's readings kept: a serving cell's widest
served-token gap per compared request, the program's and with
``--control`` the fp8 control's (``reference.check``); a training
cell's numbers, the program's and the control's (``drivers/train.py``).
Each side's ``correct`` is the verdict of ``verdict.judge`` against the
cell's limits.  ``--fault`` plants one of ``faults.py``'s faults.  A
serving line also gives the positions the active rows held, on average
over the window's decode steps, and every request's time to first token
in the order of admission.  One JSON line per seed goes to standard
output and to ``--out``.  The benchmark's own runs never run
the control; this is how the limits in ``limits/<cell>.json`` were
read.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(set(faults.SERVING)
                                              | set(faults.TRAINING)),
                    help="plant a fault under the timed path (faults.py)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    cell = harness.load_cell(ROOT, args.workload, False)
    drive = harness.driver(cell.traffic["driver"])
    readers = {m["name"]: harness.reader(m["name"]) for m in cell.metrics}
    out = open(args.out, "a") if args.out else None
    t_start = T_START
    for seed in args.seeds:
        hooks = {"control": args.control}
        if args.fault:
            kind = cell.traffic["driver"]
            table = faults.TRAINING if kind == "train" else faults.SERVING
            hooks["step_fn" if kind == "train" else "engine"] = \
                table[args.fault]
        run = harness.Run(cell, seed, args.seconds, False, t_start,
                          hooks=hooks)
        rec = drive.run(run)
        line = {"workload": args.workload, "seed": seed,
                "correct": rec["correct"], "checks": rec["checks"],
                "control_correct": rec.get("control_correct"),
                "control_checks": rec.get("control_checks"),
                "gaps": rec.get("gaps"), "control": rec.get("control"),
                "held_kv_positions": rec.get("held_kv_positions"),
                "ttft_ms": [1e3 * x for x in rec.get("ttft_s", [])],
                "readings": rec.get("readings"), "fault": args.fault,
                "device": rec["device"],
                "metrics": {k: r(rec) for k, r in readers.items()},
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
