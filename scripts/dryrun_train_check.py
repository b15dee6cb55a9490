"""Holds the dry run's train records against rank 0's whole train step.

    PYTHONPATH=src python scripts/dryrun_train_check.py [--arch ID ...] \
        [--mesh single|multi|both] [--out DIR]

The dry run (``repro_torch.launch.dryrun``) records every ``train_4k``
cell counted per micro-batch and per layer (``dryrun.train_counts``).
This script counts each named arch's cell that way and also runs rank 0's
whole step on the fake 512-rank group, with no time limit, and holds the
first against the second: FLOPs and collective bytes within 0.1 %,
collective counts equal, peak within 2 %.  It prints one line per arch
and mesh, writes ``<out>/<arch>__train_4k__<mesh>__check.json`` and exits
1 when a number is out of tolerance.  By default it checks the five archs
whose whole step runs in about a minute on one CPU core.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.arch import LM_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.specs import build_cell, rank_local_cell

ARCHS = ("stablelm_3b", "wedlm8b_like", "starcoder2_3b", "phi3_vision_4p2b",
         "whisper_tiny")
TOL = {"flops": 1e-3, "collective_bytes": 1e-3, "peak_bytes": 0.02}


def _rel(a, b) -> float:
    return 0.0 if a == b else abs(a - b) / max(abs(b), 1)


def check(arch: str, mesh_name: str, mesh, out_dir: str) -> bool:
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.mode == "train")
    n_micro = dryrun.arch_n_micro(arch)
    t0 = time.time()
    ext, method = dryrun.train_counts(cfg, shape, mesh, n_micro)
    t_ext = time.time() - t0
    fn, local, _ = rank_local_cell(
        cfg, shape, mesh, build_cell(cfg, shape, mesh, n_micro=n_micro))
    t0 = time.time()
    whole = dryrun.track_run(fn, local)
    t_whole = time.time() - t0
    diffs = {"flops": _rel(ext["flops"], whole["flops"]),
             "collective_bytes": max(_rel(ext["collective_bytes"][k],
                                          whole["collective_bytes"][k])
                                     for k in dryrun.KINDS),
             "peak_bytes": _rel(ext["peak_bytes"], whole["peak_bytes"])}
    counts_equal = ext["collective_counts"] == whole["collective_counts"]
    ok = counts_equal and all(diffs[k] <= t for k, t in TOL.items())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape.name}__{mesh_name}"
                                    f"__check.json"), "w") as f:
        json.dump({"arch": arch, "mesh": mesh_name, "extrapolated": ext,
                   "whole": whole, "relative_difference": diffs,
                   "counts_equal": counts_equal, "ok": ok,
                   "extrapolated_s": round(t_ext, 1),
                   "whole_s": round(t_whole, 1), "method": method}, f,
                  indent=1)
    print(f"[{'ok' if ok else 'FAIL'}] {arch} {shape.name} {mesh_name}: "
          f"relative FLOPs {diffs['flops']:.2e}, collective bytes "
          f"{diffs['collective_bytes']:.2e}, peak "
          f"{diffs['peak_bytes']:.2e}; counts "
          f"{'equal' if counts_equal else 'differ'}; extrapolated "
          f"{t_ext:.1f} s, whole {t_whole:.1f} s", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS),
                    choices=ARCH_IDS)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun_train_check")
    args = ap.parse_args(argv)
    names = {"single": ["singlepod"], "multi": ["multipod"],
             "both": ["singlepod", "multipod"]}[args.mesh]
    meshes = dryrun.fake_meshes()
    try:
        oks = [check(arch, name, meshes[name], args.out)
               for arch in args.arch for name in names]
    finally:
        dist.destroy_process_group()
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
