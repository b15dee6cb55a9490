"""The placement-and-memory dry run: every (arch x shape x mesh) cell at
production size, with no device — the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all] \
        [--shape NAME|all] [--mesh single|multi|both] [--out DIR] \
        [--force] [--decode-positions N] [--variant baseline|opt]

One JSON record per cell, ``<out>/<arch>__<shape>__<singlepod|multipod>
[__opt].json``, under the reference's cell ids and record keys; a cell
whose record says "ok" is skipped unless ``--force``, and a shape the
architecture does not take (``shape_applicable``) is recorded "skipped".

The process joins a FAKE process group of 512 ranks (no communication
happens) and builds the production meshes on it: the multi-pod (2, 16,
16) mesh, and the single-pod (16, 16) mesh as its ("data", "model")
sub-mesh.  Each cell runs ONCE, as rank 0: on rank 0's shards of the
params, the optimizer state, the batch and the cache (fake tensors shaped
by the cell's placements), through what a rank runs
(``specs.rank_local_cell``): the sharded train step on local tensors, or
``forward`` on the model axis's shards (``dist.tensor_parallel``;
``tp_plan``'s blocks are recorded), each layer's params gathered as it
runs (``dist.layer_gather``).  A ``head``-mode cache is read in place
where its heads split as the plan splits them; a ``seq``-mode cache (the
``opt`` decode variant), and any other leaf laid out otherwise, is
all-gathered over the model axis once per layer, and only the positions
the forward wrote are exchanged afterwards.  Per cell:

  placements  the cell's specs as DTensor placements on the mesh, each
              checked: sharded dims divisible, no axis used twice.
  memory      ``argument_bytes`` and ``output_bytes`` per device, exact,
              from the local shard shapes (an output spec of ``None`` is
              replicated; rank 0's shards must hold ``argument_bytes``);
              ``peak_bytes``: the peak ``MemTracker`` follows over rank
              0's run, its arguments tracked from the start;
              ``temp_bytes`` = peak - argument - output, floored at 0.
  cost        ``flops`` per device, counted by ``FlopCounterMode`` over
              rank 0's run (an SPMD module's cost analysis is per device
              too).
  collective_counts / collective_bytes
              what rank 0's run launched, per kind (``torch.distributed``
              calls and functional collectives): how many, and their
              input bytes per device.

A train cell is counted per micro-batch and per layer, as the
reference's XLA dry run counts a scan body once and scales it by its trip
count (``train_counts``): rank 0's step on the cell's full shapes at
n_micro 1 and 2 and with the layer pattern's unit repeated at two
depths (``depth_repeats``), extrapolated affinely to the cell's micro-batches
and layers; the method goes into the record's notes.  Prefill and decode
cells run whole.  Every run counts the plain Mamba scans as one operation
a call (``core.scan_op.whole_scans``: the loops' FLOPs and saved bytes).
A cell whose runs pass ``FLOP_LIMIT_S`` seconds records null FLOPs,
collectives and peak, and the reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback
from fractions import Fraction
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.arch import LM_SHAPES, shape_applicable
from repro_torch.core.scan_op import whole_scans
from repro_torch.core.tree import leaves
from repro_torch.dist.sharding import placements_from_pspecs, shard_bytes
from repro_torch.dist.tensor_parallel import tp_plan
from repro_torch.launch.mesh import MULTI_POD_AXES, MULTI_POD_SHAPE
from repro_torch.launch.specs import (build_cell, fake_mode, output_abstract,
                                      rank_local_cell)

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


class FlopLimit(Exception):
    pass


# ---------------------------------------------------------------------------
# The rank-local run: FLOPs, collectives and peak memory
# ---------------------------------------------------------------------------

# c10d ops (``torch.distributed``'s calls) and functional collectives
_C10D = {"allreduce_": "all_reduce", "allgather_": "all_gather",
         "_allgather_base_": "all_gather",
         "allgather_into_tensor_coalesced_": "all_gather",
         "reduce_scatter_": "reduce_scatter",
         "_reduce_scatter_base_": "reduce_scatter",
         "alltoall_": "all_to_all", "alltoall_base_": "all_to_all"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _tracker_class():
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import flop_registry

    class CellTracker(MemTracker):
        """``MemTracker`` (the memory the run holds, its peak) that in the
        same dispatch counts FLOPs by ``FlopCounterMode``'s formulas and
        logs every collective as (kind, input bytes per device): one
        Python hop per op instead of three."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = super().__torch_dispatch__(func, types, args, kwargs)
            if res is NotImplemented:
                return res
            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += formula(*args, **(kwargs or {}), out_val=res)
            kind = None
            if func.namespace == "c10d":
                kind = _C10D.get(packet.__name__)
                # all but allreduce_ take (outputs, inputs, group, ...)
                src = args[0] if packet.__name__ == "allreduce_" else args[1]
            elif func.namespace == "_c10d_functional":
                kind = _FUNCOL.get(packet.__name__)
                src = args[0]
            if kind is not None:
                self.records.append((kind, sum(
                    t.numel() * t.element_size() for t in _tensors(src))))
            return res
    return CellTracker


def collective_bytes(records):
    """(bytes, counts) per kind of a tracker's collective records: the
    collectives' input bytes per device, and how many were launched."""
    nbytes = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for kind, n in records:
        nbytes[kind] += n
        counts[kind] += 1
    return nbytes, counts


def track_run(fn, args):
    """``measure``'s numbers of ``fn(*args)``, run in this process with no
    time limit; the plain scans run as one operation a call
    (``core.scan_op.whole_scans``)."""
    tracker = _tracker_class()()
    tracker.track_external(*leaves(args))
    with fake_mode(), tracker, whole_scans():
        fn(*args)
    nbytes, counts = collective_bytes(tracker.records)
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    return {"flops": int(tracker.flops), "collective_bytes": nbytes,
            "collective_counts": counts, "peak_bytes": int(peak)}


def _child(jobs, conn) -> None:
    try:
        conn.send([track_run(fn, args) for fn, args in jobs])
    except Exception:                                       # noqa: BLE001
        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()
        os._exit(0)


def measure_all(jobs, limit: Optional[float] = None):
    """``measure`` of each (fn, args) of ``jobs``, one after another in
    one forked child (which pays the fake mode's first-run warm-up once,
    about a second); FlopLimit when all of them pass ``limit`` seconds
    (``FLOP_LIMIT_S`` when None)."""
    import multiprocessing
    limit = FLOP_LIMIT_S if limit is None else limit
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=_child, args=(jobs, send))
    child.start()
    send.close()
    try:
        if not recv.poll(max(limit, 0.0)):
            raise FlopLimit(f"the fake-tensor run passed {limit:.0f} s")
        got = recv.recv()
    finally:
        child.kill()
        child.join()
        recv.close()
    if "error" in got:
        raise RuntimeError(f"rank 0's run failed:\n{got['error']}")
    return got


def measure(fn, args):
    """{"flops", "collective_bytes", "collective_counts", "peak_bytes"}
    of ``fn(*args)`` run once under the fake mode as this rank, with its
    arguments tracked from the start; FlopLimit past ``FLOP_LIMIT_S``
    seconds.  The run is a forked child (the fake tensors and the fake
    group are inherited; nothing runs on the idle thread pools, as with a
    forked DataLoader worker), killed at the limit: an exception cannot
    stop it, since one raised while saved-tensor hooks are pushed (a
    checkpointed layer) or in some ops' autograd wrappers aborts the
    process instead of unwinding."""
    return measure_all([(fn, args)])[0]


# ---------------------------------------------------------------------------
# Train cells: counted per micro-batch and per layer
# ---------------------------------------------------------------------------

def pattern_period(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(unit, repeats, tail): the config's layer pattern as its shortest
    repeating unit, how many whole times it repeats, and the rest (a
    prefix of the unit).  All-attention: ((attn,), n_layers, ()); zamba2:
    ((ssm x5, hybrid), 6, (ssm, ssm))."""
    pattern = cfg.pattern()
    for p in range(1, len(pattern) + 1):
        if all(kind == pattern[i % p] for i, kind in enumerate(pattern)):
            return pattern[:p], len(pattern) // p, pattern[
                len(pattern) // p * p:]
    raise AssertionError("unreachable")


def depth_repeats(cfg, remat) -> Tuple[int, int]:
    """The two repeat counts of the pattern's unit a train cell is
    counted at: 1 and 2 for a unit of several segments (zamba2's); for a
    one-kind pattern (the unit one layer, the repeats one segment) two
    and three times the fewest layers of which ``remat`` recomputes a
    whole number.  A one-layer run's peak is not yet on the per-layer
    slope: phi3_vision's rises 310 MB from one layer to two, then 108.6
    MB a layer."""
    unit, _, _ = pattern_period(cfg)
    if len(set(unit)) > 1:
        return 1, 2
    r = 1
    if not isinstance(remat, bool):
        r = Fraction(remat).limit_denominator(64).denominator
    return 2 * r, 3 * r


def with_repeats(cfg, repeats: int):
    """``cfg`` with its pattern's unit repeated ``repeats`` times, then
    its tail."""
    unit, _, tail = pattern_period(cfg)
    pattern = unit * repeats + tail
    return dataclasses.replace(
        cfg, n_layers=len(pattern),
        layer_pattern=None if cfg.layer_pattern is None else pattern)


def _numbers(got) -> Dict[str, float]:
    """A run's FLOPs, collective bytes and counts and peak, flat."""
    out = {"flops": got["flops"], "peak": got["peak_bytes"]}
    for kind in KINDS:
        out["bytes/" + kind] = got["collective_bytes"][kind]
        out["count/" + kind] = got["collective_counts"][kind]
    return out


def _batch_bytes(local) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(local[2]))


def train_counts(cfg, shape, mesh, n_micro: int, variant: str = "baseline"):
    """(numbers, method) of a train cell, counted per micro-batch and per
    layer as the reference's XLA dry run counts a scan body once and
    scales it by its trip count.  Rank 0's step runs on the cell's full
    shapes at n_micro 1 and 2 (the same micro-batch) and with the layer
    pattern's unit repeated ``depth_repeats`` times (segments kept in the
    pattern: a hybrid's Mamba2 runs and shared-attention layers);
    FLOPs, collective counts and bytes are affine in the micro-batches,
    in the repeats and in their product, and are extrapolated to the
    cell's; the peak is the 2-micro-batch runs' (the gradient
    accumulator exists from the second on), affine in the repeats, plus
    the cell's further micro-batches' input bytes.  FlopLimit when all
    the runs pass ``FLOP_LIMIT_S`` seconds."""
    t0 = time.time()
    full_cell = build_cell(cfg, shape, mesh, n_micro=n_micro,
                           variant=variant)
    n_micro = full_cell[0].keywords["n_micro"]      # dp_only: 1
    mb = shape.global_batch // n_micro
    ns = (1, 2) if n_micro > 1 else (1,)
    reps = depth_repeats(cfg, full_cell[0].keywords["remat"])
    jobs, batch = {}, {}
    for r in reps:
        sub = with_repeats(cfg, r)
        for n in ns:
            sub_shape = dataclasses.replace(shape, global_batch=mb * n)
            cell = build_cell(sub, sub_shape, mesh, n_micro=n,
                              variant=variant)
            fn, local, _ = rank_local_cell(sub, sub_shape, mesh, cell,
                                           variant=variant)
            jobs[r, n] = (fn, local)
            batch[n] = _batch_bytes(local)
    try:
        runs = measure_all(list(jobs.values()),
                           FLOP_LIMIT_S - (time.time() - t0))
    except FlopLimit:
        raise FlopLimit(f"the fake-tensor runs passed {FLOP_LIMIT_S:.0f} s")
    got = {key: _numbers(run) for key, run in zip(jobs, runs)}
    full_batch = _batch_bytes(rank_local_cell(cfg, shape, mesh, full_cell,
                                              variant=variant)[1])

    def at(r):
        one, last = got[r, 1], got[r, ns[-1]]
        vals = {k: one[k] + (n_micro - 1) * (last[k] - one[k]) for k in one}
        vals["peak"] = last["peak"]
        return vals
    lo, hi = at(reps[0]), at(reps[1])
    repeats = pattern_period(cfg)[1]
    out = {k: lo[k] + (repeats - reps[0]) / (reps[1] - reps[0])
           * (hi[k] - lo[k]) for k in lo}
    out["peak"] += full_batch - batch[ns[-1]]
    unit, _, tail = pattern_period(cfg)
    method = (f"rank 0's step at n_micro {' and '.join(map(str, ns))} "
              f"(micro-batch {mb}) with the layer pattern's unit "
              f"({len(unit)} layer{'s' * (len(unit) > 1)}) repeated "
              f"{reps[0]} and {reps[1]} times"
              f"{f' plus its {len(tail)}-layer tail' if tail else ''}, "
              f"extrapolated to n_micro {n_micro} and {repeats} repeats: "
              f"FLOPs and collectives affine in micro-batches, repeats and "
              f"their product; the peak the {ns[-1]}-micro-batch runs', "
              f"affine in repeats, plus the further micro-batches' input "
              f"bytes")
    numbers = {
        "flops": int(round(out["flops"])),
        "collective_bytes": {k: int(round(out["bytes/" + k]))
                             for k in KINDS},
        "collective_counts": {k: int(round(out["count/" + k]))
                              for k in KINDS},
        "peak_bytes": int(round(out["peak"]))}
    return numbers, method


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape, multi_pod: bool, out_dir: str,
             decode_positions: int = 1, force: bool = False,
             n_micro_override=None, tag: str = "", variant: str = "baseline",
             meshes: Optional[Dict] = None):
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
        cell = build_cell(cfg, shape, mesh, n_micro=n_micro,
                          decode_positions=decode_positions, variant=variant)
        _, args, in_ps, out_ps = cell
        outs = output_abstract(cfg, args, shape.mode)
        # shard_bytes checks every leaf's spec (divisible, no axis twice);
        # the placements check the axes' order on the mesh
        arg_bytes = shard_bytes(args, in_ps, mesh)
        out_bytes = shard_bytes(outs, out_ps, mesh)
        placements_from_pspecs((in_ps, out_ps), mesh)
        fn, local, tp_size = rank_local_cell(cfg, shape, mesh, cell,
                                             variant=variant)
        local_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(local))
        if local_bytes != arg_bytes:
            raise AssertionError(f"{cell_id}: rank 0's shards hold "
                                 f"{local_bytes} bytes, the specs "
                                 f"{arg_bytes}")
        t_lower = time.time() - t0
        method = None
        try:
            if shape.mode == "train":
                got, method = train_counts(cfg, shape, mesh, n_micro,
                                           variant=variant)
            else:
                got = measure(fn, local)
            reason = None
        except FlopLimit as e:
            got, reason = dict.fromkeys(
                ("flops", "collective_bytes", "collective_counts",
                 "peak_bytes")), str(e)
        peak = got["peak_bytes"]
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
                    "temp_bytes": (None if peak is None else
                                   max(peak - arg_bytes - out_bytes, 0)),
                    "peak_bytes": peak},
            cost={"flops": got["flops"], "bytes_accessed": None,
                  "transcendentals": None},
            collective_bytes=got["collective_bytes"],
            collective_counts=got["collective_counts"],
            tp_plan=tp_plan(cfg, tp_size),
            params=cfg.param_count(),
            params_active=cfg.param_count(active_only=True),
            notes={"lower_s": "build the cell, check its placements, "
                              "build rank 0's shards",
                   "compile_s": "rank 0's run under the fake mode",
                   "memory": "per device: argument / output bytes from "
                             "the placements; peak from MemTracker over "
                             "rank 0's run (arguments included), temp = "
                             "peak - argument - output (floored at 0)",
                   "flops": "per device: FlopCounterMode over rank 0's "
                            "run on its shards",
                   "collectives": "what rank 0's run launched, per kind: "
                                  "count and input bytes per device",
                   "scans": "the plain Mamba scans count as one operation "
                            "a call (core.scan_op), with the loops' FLOPs "
                            "and saved bytes"},
        )
        if method:
            rec["notes"]["train"] = method
        if reason:
            rec["cost"]["flops_reason"] = reason
        print(f"[ok]   {cell_id}  args={arg_bytes / 1e9:.3f} GB/device "
              f"flops={_g(got['flops'])} peak={_g(peak)} "
              f"run={t_flops:.0f}s")
    except Exception as e:                                  # noqa: BLE001
        rec.update(status="error", error=str(e)[:2000],
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {cell_id}: {e}")
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(path, rec)
    return rec


def _g(x) -> str:
    return "null" if x is None else f"{x:.3g}"


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
    n_ok = n_fail = n_skip = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in multis:
                    rec = run_cell(arch, shape, mp, args.out,
                                   decode_positions=args.decode_positions,
                                   force=args.force, variant=args.variant,
                                   meshes=meshes)
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
