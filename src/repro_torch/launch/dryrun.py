"""The placement-and-memory dry run: every (arch x shape x mesh) cell at
production size, with no device — the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all] \
        [--shape NAME|all] [--mesh single|multi|both] [--out DIR] \
        [--force] [--decode-positions N] [--variant baseline|opt]

One JSON record per cell, ``<out>/<arch>__<shape>__<singlepod|multipod>
[__opt].json``, under the reference's cell ids and record keys; a cell
whose record says "ok" is skipped unless ``--force``, and a shape the
architecture does not take (``shape_applicable``) is recorded "skipped".

The process joins a FAKE process group of 512 ranks (rank 0; no
communication happens) and builds the production meshes on it: the
multi-pod (2, 16, 16) mesh, and the single-pod (16, 16) mesh as its
("data", "model") sub-mesh.  Per cell:

  placements  the cell's specs as DTensor placements on the mesh, each
              checked: sharded dims divisible, no axis used twice.
  memory      ``argument_bytes`` and ``output_bytes`` per device, exact,
              from the local shard shapes (an output spec of ``None`` is
              replicated).  ``temp_bytes`` and ``peak_bytes`` are null: no
              compiler reckons them here.
  cost        ``flops`` of the cell's function run ONCE under
              ``FakeTensorMode`` on the global shapes (no DTensor), counted
              by ``FlopCounterMode``: the whole step's, not per device.  A
              run past ``FLOP_LIMIT_S`` seconds records null and the reason
              (the plain SSM scans step per position, so SSM / hybrid
              prefill and train cells get there).
  collective_counts / collective_bytes
              the collectives the placements imply, per kind: for each
              parameter leaf, one layer's slice takes part in a DTensor
              probe (``x @ w``, ``x * w`` for a vector, the embedding lookup
              for a table, with ``x`` batch-sharded as the cell's tokens),
              and what it launches (partial sums resolved) is multiplied by
              the leaf's uses per step: layers x micro-batches, x 3 in a
              train cell.  Bytes are the collectives' input bytes per
              device.  XLA picks its own collectives, so these numbers are
              NOT comparable with the reference's HLO counts.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import time
import traceback
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.arch import LM_SHAPES, shape_applicable
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.dist.sharding import (P, is_spec, leaf_name,
                                       local_shape, placements_for,
                                       placements_from_pspecs, shard_bytes)
from repro_torch.launch.mesh import MULTI_POD_AXES, MULTI_POD_SHAPE
from repro_torch.launch.specs import (abstract, build_cell, fake_mode,
                                      output_abstract)

FLOP_LIMIT_S = 60.0
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_FUNCOL = {"all_reduce": "all_reduce",
           "all_gather_into_tensor": "all_gather",
           "reduce_scatter_tensor": "reduce_scatter",
           "all_to_all_single": "all_to_all"}


def arch_n_micro(arch: str) -> int:
    # larger accumulation for the biggest models bounds live activations
    return {"mixtral_8x22b": 8, "phi3_medium_14b": 8}.get(arch, 4)


# ---------------------------------------------------------------------------
# The fake process group and the production meshes
# ---------------------------------------------------------------------------

def fake_meshes() -> Dict[str, object]:
    """{"singlepod", "multipod"}: the production ``DeviceMesh``es on a
    fake 512-rank process group, which this call joins unless a default
    group exists already (it must then be that fake group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(MULTI_POD_SHAPE))
    # multi-axis shards gather axis by axis; DTensor warns on each
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    multi = init_device_mesh("cpu", MULTI_POD_SHAPE,
                             mesh_dim_names=MULTI_POD_AXES)
    return {"singlepod": multi["data", "model"], "multipod": multi}


# ---------------------------------------------------------------------------
# FLOPs under fake tensors, with a time limit
# ---------------------------------------------------------------------------

class FlopLimit(Exception):
    pass


@contextmanager
def _time_limit(seconds: float):
    def _raise(signum, frame):
        raise FlopLimit(f"the fake-tensor run passed {seconds:.0f} s")
    old = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def count_flops(fn, args):
    """(FLOPs of ``fn(*args)`` under the fake mode, its outputs); FlopLimit
    past ``FLOP_LIMIT_S`` seconds."""
    from torch.utils.flop_counter import FlopCounterMode
    with _time_limit(FLOP_LIMIT_S), fake_mode(), \
            FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return counter.get_total_flops(), out


def _same_abstract(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Collective probes
# ---------------------------------------------------------------------------

class _CollectiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Input bytes of every functional collective dispatched inside."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented       # let DTensor desugar into comms first
        kind = _FUNCOL.get(func._overloadpacket.__name__)
        if func.namespace == "_c10d_functional" and kind is not None:
            t = args[0]
            self.bytes[kind] += t.numel() * t.element_size()
        return func(*args, **(kwargs or {}))


def _dtensor(shape, dtype, spec, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        abstract(local_shape(shape, spec, mesh), dtype), mesh,
        placements_for(spec, mesh), run_check=False, shape=tuple(shape),
        stride=abstract(shape, dtype).stride())


def probe_leaf(name: str, shape, dtype, spec, mesh, tokens: int,
               bdim) -> Dict[str, Dict[str, int]]:
    """The collectives one use of a (per-layer) weight of ``shape`` under
    ``spec`` launches: ``x @ w`` (a matrix), ``x * w`` (a vector) or the
    embedding lookup (a ``table``), ``x`` (``tokens``, ·) with its rows
    sharded by ``bdim``.  A partial result is reduced (redistributed to
    replicated on those mesh dims).  {"counts", "bytes"} per kind."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    with fake_mode():
        w = _dtensor(shape, dtype, spec, mesh)
        if "table" in name and len(shape) == 2:
            x = _dtensor((tokens,), torch.int64, P(bdim), mesh)
        else:
            x = _dtensor((tokens, shape[0]), dtype, P(bdim, None), mesh)
        nbytes = _CollectiveBytes()
        with CommDebugMode() as comm, nbytes:
            if "table" in name and len(shape) == 2:
                y = F.embedding(x, w)
            elif len(shape) == 2:
                y = x @ w
            else:
                y = x * w
            y.redistribute(placements=[Replicate() if p.is_partial() else p
                                       for p in y.placements])
    counts = dict.fromkeys(KINDS, 0)
    for op, n in comm.get_comm_counts().items():
        kind = _FUNCOL.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if kind is not None:
            counts[kind] += n
    return {"counts": counts, "bytes": nbytes.bytes}


def _stacked(path) -> bool:
    """Whether a param leaf carries a leading layer axis."""
    return "segments" in path or path[:2] == ("encoder", "layers")


def probe_collectives(params, p_ps, mesh, *, tokens: int, bdim,
                      n_micro: int, train: bool):
    """(counts, bytes) per kind over every parameter leaf's uses in one
    step (see the module docstring)."""
    counts = dict.fromkeys(KINDS, 0)
    nbytes = dict.fromkeys(KINDS, 0)
    specs = [s for _, s in leaves_with_paths(p_ps, (), is_spec)]
    for (path, leaf), spec in zip(leaves_with_paths(params), specs):
        shape = tuple(leaf.shape)
        spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
        uses = n_micro * (3 if train else 1)
        if _stacked(path):
            uses *= shape[0]
            shape, spec = shape[1:], spec[1:]
        if len(shape) > 2:              # experts: one (d, f) table each
            uses *= math.prod(shape[:-2])
            shape, spec = shape[-2:], spec[-2:]
        if not shape:
            continue
        r = probe_leaf(leaf_name(path), shape, leaf.dtype, P(*spec), mesh,
                       tokens, bdim)
        for k in KINDS:
            counts[k] += r["counts"][k] * uses
            nbytes[k] += r["bytes"][k] * uses
    return counts, nbytes


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape, multi_pod: bool, out_dir: str,
             decode_positions: int = 1, force: bool = False,
             n_micro_override=None, tag: str = "", variant: str = "baseline",
             meshes: Optional[Dict] = None, flops_memo: Optional[Dict] = None):
    mesh_name = "multipod" if multi_pod else "singlepod"
    if variant != "baseline" and not tag:
        tag = f"__{variant}"
    cell_id = f"{arch}__{shape.name}__{mesh_name}{tag}"
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            print(f"[skip] {cell_id} (cached)")
            return rec
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "mode": shape.mode}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(path, rec)
        print(f"[skip] {cell_id}: {why}")
        return rec
    t0 = time.time()
    try:
        mesh = (meshes or fake_meshes())[mesh_name]
        n_micro = n_micro_override or arch_n_micro(arch)
        fn, args, in_ps, out_ps = build_cell(
            cfg, shape, mesh, n_micro=n_micro,
            decode_positions=decode_positions, variant=variant)
        outs = output_abstract(cfg, args, shape.mode)
        # shard_bytes checks every leaf's spec (divisible, no axis twice);
        # the placements check the axes' order on the mesh
        arg_bytes = shard_bytes(args, in_ps, mesh)
        out_bytes = shard_bytes(outs, out_ps, mesh)
        placements_from_pspecs((in_ps, out_ps), mesh)
        train = shape.mode == "train"
        tok_spec = in_ps[2 if train else 1]["tokens"]
        tok = args[2 if train else 1]["tokens"]
        cell_micro = tok.shape[0] if train and tok.ndim == 3 else 1
        coll, coll_bytes = probe_collectives(
            args[0], in_ps[0], mesh, tokens=tok.shape[-2] * tok.shape[-1],
            bdim=tok_spec[-2], n_micro=cell_micro, train=train)
        t_lower = time.time() - t0
        key = (arch, shape.name, variant, decode_positions, n_micro)
        memo = {} if flops_memo is None else flops_memo
        if key not in memo:
            try:
                flops, got = count_flops(fn, args)
                if not _same_abstract(got, outs):
                    raise AssertionError(f"{cell_id}: outputs differ from "
                                         "output_abstract")
                memo[key] = (flops, None)
            except FlopLimit as e:
                memo[key] = (None, str(e))
        flops, flops_reason = memo[key]
        t_flops = time.time() - t0 - t_lower
        rec.update(
            status="ok",
            variant=variant,
            decode_positions=decode_positions,
            n_micro=n_micro,
            n_devices=mesh.size(),
            lower_s=round(t_lower, 1),
            compile_s=round(t_flops, 1),
            memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": None, "peak_bytes": None},
            cost={"flops": flops, "bytes_accessed": None,
                  "transcendentals": None},
            collective_bytes=coll_bytes,
            collective_counts=coll,
            params=cfg.param_count(),
            params_active=cfg.param_count(active_only=True),
            notes={"lower_s": "build the cell, check its placements, run "
                              "the collective probes",
                   "compile_s": "the fake-tensor FLOP run (0 when the "
                                "other mesh's run is reused)",
                   "memory": "per device, from the local shard shapes; "
                             "no compiler reckons temp / peak",
                   "flops": "global (the whole step on every shard), "
                            "FlopCounterMode under FakeTensorMode",
                   "collectives": "DTensor probes per parameter leaf x "
                                  "uses; not comparable with HLO counts"},
        )
        if flops_reason:
            rec["cost"]["flops_reason"] = flops_reason
        print(f"[ok]   {cell_id}  args={arg_bytes / 1e9:.3f} GB/device "
              f"flops={flops if flops is None else f'{flops:.3g}'} "
              f"flop_run={t_flops:.0f}s")
    except Exception as e:                                  # noqa: BLE001
        rec.update(status="error", error=str(e)[:2000],
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {cell_id}: {e}")
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--decode-positions", type=int, default=1)
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"])
    return ap


def main(argv=None) -> int:
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = (LM_SHAPES if args.shape == "all"
              else [s for s in LM_SHAPES if s.name == args.shape])
    multis = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    meshes = fake_meshes()
    memo: Dict = {}
    n_ok = n_fail = n_skip = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in multis:
                    rec = run_cell(arch, shape, mp, args.out,
                                   decode_positions=args.decode_positions,
                                   force=args.force, variant=args.variant,
                                   meshes=meshes, flops_memo=memo)
                    s = rec["status"]
                    n_ok += s == "ok"
                    n_fail += s == "error"
                    n_skip += s == "skipped"
    finally:
        dist.destroy_process_group()
    print(f"\ndone: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
