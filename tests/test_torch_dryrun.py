"""The placement-and-memory dry run against the reference's cells.

Per-device argument bytes: for stablelm_3b, granite_moe_3b_a800m,
zamba2_1p2b and whisper_tiny, every shape, both production meshes, the
baseline and opt variants, the port's ``build_cell`` args and specs give
the bytes reckoned from the reference's ``build_cell`` args
(``jax.eval_shape``, no compile) and specs on the duck-typed meshes.

In one subprocess with the fake 512-rank process group: the CLI writes
the reference's record keys, skips ``long_500k`` where the reference
does, and its argument bytes are the ones reckoned here; full-size
stablelm_3b ``train_4k`` on the single-pod mesh runs as rank 0 (its
per-device FLOPs x 256 are the whole step's, ``wo``'s row-parallel
all-reduce comes once per layer per micro-batch forward, the fsdp
data-axis all-gather of a layer's leaf each time the layer runs, and its
gradient's reduce-scatter once per micro-batch); falcon_mamba_7b's
``decode_32k`` cell stays within the reference's temp bytes; every
single-pod cell of stablelm_3b, granite_moe_3b_a800m, zamba2_1p2b and
whisper_tiny records a peak that covers its arguments (three train cells
that run longer than a third of the 20 s limit here may record it hit
instead); the same stablelm cell counted per micro-batch and per layer,
as every train record is, equals the whole run; with the plain Mamba
scans as one operation (``core.scan_op``), reduced falcon and zamba2
count what their loops count; DTensor's blocks for a dim sharded by
("pod", "data") are JAX's (pod the major digit).  The one-operation
scans give the loops' values on real tensors, and their saved bytes and
FLOPs on fake ones.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.arch import LM_SHAPES as REF_SHAPES  # noqa: E402
from repro.core.arch import shape_applicable as ref_applicable  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.arch import LM_SHAPES, shape_applicable  # noqa: E402
from repro_torch.dist.sharding import shard_bytes  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm_3b", "granite_moe_3b_a800m", "zamba2_1p2b",
         "whisper_tiny")


class FakeMesh:
    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.shape = dict(shape_map)


MESHES = {"singlepod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}
N_MICRO = 4                                 # dryrun.arch_n_micro here


def _ref_bytes(args, in_ps, mesh) -> int:
    """Per-device bytes of the reference's abstract args under its specs:
    each dim divided by the product of its axes' sizes."""
    specs = jax.tree_util.tree_leaves(
        in_ps, is_leaf=lambda x: isinstance(x, JP) or x is None)
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(args), specs):
        shape = list(leaf.shape)
        for i, entry in enumerate(tuple(spec or ())):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n = math.prod(mesh.shape[a] for a in axes)
            assert shape[i] % n == 0
            shape[i] //= n
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def cached_ref_params():
    """The reference's ``params_abstract`` once per config (an
    ``eval_shape`` of the full-size init)."""
    cache = {}
    real = ref_specs.params_abstract

    def cached(cfg):
        if cfg.name not in cache:
            cache[cfg.name] = real(cfg)
        return cache[cfg.name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_specs, "params_abstract", cached)
        yield


def port_argument_bytes(arch, shape_name, mesh_name, variant):
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    mesh = MESHES[mesh_name]
    _, args, in_ps, _ = build_cell(get_config(arch), shape, mesh,
                                   n_micro=N_MICRO, variant=variant)
    return shard_bytes(args, in_ps, mesh)


@pytest.mark.parametrize("variant", ("baseline", "opt"))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in REF_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_cells(cached_ref_params, arch,
                                                  shape, mesh, variant):
    ref_shape = next(s for s in REF_SHAPES if s.name == shape)
    cfg = ref_config(arch)
    ok, _ = ref_applicable(cfg, ref_shape)
    port_shape = next(s for s in LM_SHAPES if s.name == shape)
    assert shape_applicable(get_config(arch), port_shape)[0] == ok
    if not ok:
        return
    _, args, in_ps, _ = ref_specs.build_cell(
        cfg, ref_shape, MESHES[mesh], n_micro=N_MICRO, variant=variant)
    want = _ref_bytes(args, in_ps, MESHES[mesh])
    assert port_argument_bytes(arch, shape, mesh, variant) == want


# ---------------------------------------------------------------------------
# the CLI and the probes, on the fake process group (a subprocess)
# ---------------------------------------------------------------------------

SCRIPT = r"""
import collections, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.core.arch import LM_SHAPES
from repro_torch.core.tree import leaves
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import P, is_spec, param_pspecs, spec_axes
from repro_torch.launch import dryrun
from repro_torch.dist.sharding import shard_bytes
from repro_torch.launch.specs import (build_cell, params_abstract,
                                      rank_local_cell)
out = sys.argv[1]
assert dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                    "--mesh", "both", "--out", out]) == 0
assert dryrun.main(["--arch", "stablelm_3b", "--shape", "long_500k",
                    "--mesh", "single", "--out", out]) == 0
res = {}
meshes = dryrun.fake_meshes()
single = meshes["singlepod"]
# full-size stablelm_3b train_4k as rank 0, with no time limit in its way:
# who calls reduce_from_model, and over which axis each all-gather runs
callers = collections.Counter()
real_reduce = tp.reduce_from_model


def reduce_from_model(x):
    callers[sys._getframe(1).f_code.co_name] += 1
    return real_reduce(x)


gathers = collections.Counter()
data_shapes = collections.Counter()
real_gather = tp.all_gather
names = {id(single.get_group(a)): a for a in ("data", "model")}


def all_gather(t, dim, group, size):
    axis = names.get(id(group), "other")
    gathers[axis] += 1
    if axis == "data":
        data_shapes[str(tuple(t.shape))] += 1
    return real_gather(t, dim, group, size)


tp.reduce_from_model, tp.all_gather = reduce_from_model, all_gather
cfg = get_config("stablelm_3b")
shape = next(s for s in LM_SHAPES if s.name == "train_4k")
cell = build_cell(cfg, shape, single, n_micro=dryrun.arch_n_micro(cfg.name))
fn, local, tp_size = rank_local_cell(cfg, shape, single, cell)
got = dryrun.track_run(fn, local)      # here, so the recorders see it
tp.reduce_from_model, tp.all_gather = real_reduce, real_gather
specs = param_pspecs(params_abstract(cfg), single)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.dist.sharding import local_shape
layer_shapes = collections.Counter()
other_shapes = collections.Counter()
for (path, leaf), spec in zip(leaves_with_paths(params_abstract(cfg)),
                              leaves(specs, is_spec)):
    if any("data" in spec_axes(e) for e in spec):
        local = local_shape(leaf.shape, spec, single)
        if path[0] == "segments":
            layer_shapes[str(local[1:])] += 1
        else:
            other_shapes[str(local)] += 1
# the same cell counted per micro-batch and per layer, as every train
# cell is recorded
res["extrapolated"] = dryrun.train_counts(cfg, shape, single,
                                          dryrun.arch_n_micro(cfg.name))[0]
res["train"] = {"got": got, "tp_plan": tp.tp_plan(cfg, tp_size),
                "argument_bytes": shard_bytes(cell[1], cell[2], single),
                "callers": dict(callers),
                "gathers": dict(gathers),
                "data_shapes": dict(data_shapes),
                "layer_shapes": dict(layer_shapes),
                "other_shapes": dict(other_shapes),
                "data_sharded_leaves": sum(
                    any("data" in spec_axes(e) for e in spec)
                    for spec in leaves(specs, is_spec))}
# reduced falcon and zamba2 at s 32, a train step and a prefill, with the
# plain scans as their loops and as one operation a call
import contextlib
from repro_torch.core.arch import ShapeSpec
scans = {}
for arch in ("falcon_mamba_7b", "zamba2_1p2b"):
    rcfg = get_config(arch, reduced=True)
    for rshape in (ShapeSpec("train_s32", 32, 32, "train"),
                   ShapeSpec("prefill_s32", 32, 16, "prefill")):
        for name, ctx in (("loop", contextlib.nullcontext),
                          ("one_op", dryrun.whole_scans)):
            real_ctx, dryrun.whole_scans = dryrun.whole_scans, ctx
            cell = build_cell(rcfg, rshape, single, n_micro=2)
            rfn, rlocal, _ = rank_local_cell(rcfg, rshape, single, cell)
            scans[f"{arch}/{rshape.mode}/{name}"] = dryrun.track_run(
                rfn, rlocal)
            dryrun.whole_scans = real_ctx
res["scans"] = scans
# every single-pod cell of four archs, under a shorter limit (main()
# leaves no process group behind), and falcon's decode cell
dryrun.FLOP_LIMIT_S = 20
assert dryrun.main(["--arch", "falcon_mamba_7b", "--shape", "decode_32k",
                    "--mesh", "single", "--out", out]) == 0
for arch in ("stablelm_3b", "granite_moe_3b_a800m", "zamba2_1p2b",
             "whisper_tiny"):
    assert dryrun.main(["--arch", arch, "--mesh", "single", "--out",
                        out]) == 0
# DTensor's blocks for a dim sharded by ("pod", "data"), rank by rank
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.dist.sharding import placements_for
blocks = {}
for rank in (0, 17, 255, 256, 300, 511):
    torch.distributed.init_process_group("fake", store=FakeStore(),
                                         rank=rank, world_size=512)
    multi = dryrun.fake_meshes()["multipod"]
    spec = P(("pod", "data"), "model")
    shape, offset = compute_local_shape_and_global_offset(
        (1024, 64), multi, placements_for(spec, multi))
    # JAX's block of dim 0 for P(("pod", "data")): pod the major digit
    pod, data, model = multi.get_coordinate()
    rows = 1024 // 32
    want = [[(pod * 16 + data) * rows, (pod * 16 + data + 1) * rows],
            [model * 4, (model + 1) * 4]]
    blocks[rank] = [list(offset), list(shape), want]
    torch.distributed.destroy_process_group()
res["blocks"] = blocks
print("RESULT::" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def fake_group_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("RESULT::")][0]
    return out, json.loads(line[len("RESULT::"):])


REF_RECORD_KEYS = {"arch", "shape", "mesh", "seq_len", "global_batch",
                   "mode", "status", "variant", "decode_positions",
                   "n_micro", "n_devices", "lower_s", "compile_s", "memory",
                   "cost", "collective_bytes", "collective_counts", "params",
                   "params_active", "wall_s"}


@pytest.mark.parametrize("mesh", ("singlepod", "multipod"))
def test_cli_writes_the_reference_record(fake_group_run, mesh):
    out, _ = fake_group_run
    rec = json.loads((out / f"whisper_tiny__decode_32k__{mesh}.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert REF_RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == max(mem["peak_bytes"] - mem["argument_bytes"]
                                    - mem["output_bytes"], 0)
    assert set(rec["cost"]) >= {"flops", "bytes_accessed", "transcendentals"}
    assert rec["cost"]["flops"] > 0
    assert rec["n_devices"] == (256 if mesh == "singlepod" else 512)
    assert rec["memory"]["argument_bytes"] == port_argument_bytes(
        "whisper_tiny", "decode_32k", mesh, "baseline")
    assert rec["memory"]["output_bytes"] > 0
    assert set(rec["collective_counts"]) == {"all_reduce", "all_gather",
                                             "reduce_scatter", "all_to_all"}
    # whisper's 6 heads do not split over 16 ranks: its attention runs
    # whole, its FFNs (d_ff 1536) on their shards
    assert rec["tp_plan"]["attn"] == "gathered"
    assert rec["tp_plan"]["ffn"] == "tp"
    # one decode position per row: each rank's FLOPs are half as many on
    # the multi-pod mesh, whose data axes split the batch twice as finely
    other = json.loads((out / "whisper_tiny__decode_32k__singlepod.json")
                       .read_text())
    assert rec["cost"]["flops"] * (2 if mesh == "multipod" else 1) == \
        other["cost"]["flops"]


def test_cli_skips_long_500k_where_the_reference_does(fake_group_run):
    out, _ = fake_group_run
    rec = json.loads((out / "stablelm_3b__long_500k__singlepod.json")
                     .read_text())
    ok, why = ref_applicable(ref_config("stablelm_3b"), REF_SHAPES[-1])
    assert not ok and rec["status"] == "skipped" and rec["reason"] == why


N_LAYERS = 32                       # stablelm_3b


def test_probe_row_parallel_wo_all_reduces_once(fake_group_run):
    """Rank 0's train step on the fake group: ``wo``'s row-parallel
    all-reduce (``reduce_from_model`` at the end of ``attention``) comes
    once per layer per micro-batch forward; the train cell remats every
    layer, so each micro-batch runs the forward twice (the step's and the
    backward's recompute).  The FFN's comes once per layer per micro-batch:
    the recompute stops before it, no saved tensor needing its output."""
    _, res = fake_group_run
    r = res["train"]
    assert r["tp_plan"] == {"embed": "tp", "head": "tp", "attn": "tp",
                            "ffn": "tp"}
    assert r["callers"]["attention"] == N_LAYERS * N_MICRO * 2
    assert r["callers"]["_mlp_block"] == N_LAYERS * N_MICRO
    assert r["callers"]["embed"] == N_MICRO
    # besides: each micro-batch's loss (sum of exps, gold logit), the
    # gradient copies, the mean over the data axis and the norm
    assert r["got"]["collective_counts"]["all_reduce"] > sum(
        r["callers"].values())


def test_probe_fsdp_wq_all_gathers_once(fake_group_run):
    """The fsdp data-axis all-gather of a layer's leaf (``wq`` one of
    them): once each time the layer runs, the forward's and remat's
    recompute, per micro-batch, never the whole stack; each such leaf's
    gradient reduce-scattered once per micro-batch, as each leaf's
    outside the layers.  Nothing is gathered over the model axis (the
    sliced ``lm_head`` is narrowed, its gradient summed)."""
    _, res = fake_group_run
    r = res["train"]
    layer, other = r["layer_shapes"], r["other_shapes"]
    assert sum(layer.values()) + sum(other.values()) == \
        r["data_sharded_leaves"] > 0
    assert "(160, 160)" in layer                  # wq's layer slice
    assert set(r["data_shapes"]) == set(layer) | set(other)
    for shape, got in r["data_shapes"].items():
        want = layer.get(shape, 0) * N_LAYERS * N_MICRO * 2 + \
            other.get(shape, 0) * N_MICRO
        # a leaf outside the layers is gathered again where the backward
        # unpacks it
        assert got == want if shape not in other else got >= want, shape
    assert r["gathers"].get("model", 0) == 0
    assert r["got"]["collective_counts"]["all_gather"] == \
        r["gathers"]["data"]
    assert r["got"]["collective_counts"]["reduce_scatter"] == N_MICRO * (
        N_LAYERS * sum(layer.values()) + sum(other.values()))


def test_falcon_decode_gathers_one_layer_at_a_time(fake_group_run):
    """falcon_mamba_7b ``decode_32k`` on the single-pod mesh: its Mamba
    blocks run whole, gathered over both axes one layer at a time, so a
    device's temp bytes stay within the reference's dry run's 1.12e9
    (XLA on the CPU, 256 host devices) where gathering the whole tree
    first held all 7e9 parameters (18.06e9)."""
    out, _ = fake_group_run
    rec = json.loads((out / "falcon_mamba_7b__decode_32k__singlepod.json")
                     .read_text())
    assert rec["status"] == "ok"
    mem = rec["memory"]
    assert mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] <= 1.12e9
    assert rec["collective_counts"]["all_gather"] > 64


def test_train_flops_per_device_are_the_global_steps_share(fake_group_run):
    """Per-device FLOPs x 256 within 5 % of the whole step's 2.65e16 (the
    global fake-tensor count recorded for this cell before the step ran
    on its shards); its peak covers its arguments."""
    _, res = fake_group_run
    got = res["train"]["got"]
    assert abs(got["flops"] * 256 / 2.65e16 - 1) <= 0.05
    assert got["peak_bytes"] >= res["train"]["argument_bytes"]


def test_extrapolated_train_cell_equals_the_whole_run(fake_group_run):
    """Full-size stablelm_3b ``train_4k`` on the single-pod mesh counted
    as every train record is (``dryrun.train_counts``: n_micro 1 and 2,
    one and two layers, extrapolated) against the whole run: FLOPs and
    collective bytes within 0.1 %, collective counts equal, peak within
    2 %."""
    _, res = fake_group_run
    got, whole = res["extrapolated"], res["train"]["got"]
    assert abs(got["flops"] / whole["flops"] - 1) <= 1e-3
    assert got["collective_counts"] == whole["collective_counts"]
    for kind, n in whole["collective_bytes"].items():
        assert abs(got["collective_bytes"][kind] - n) <= 1e-3 * n, kind
    assert abs(got["peak_bytes"] / whole["peak_bytes"] - 1) <= 0.02


@pytest.mark.parametrize("mode", ("train", "prefill"))
@pytest.mark.parametrize("arch", ("falcon_mamba_7b", "zamba2_1p2b"))
def test_one_op_scans_count_what_the_loops_count(fake_group_run, arch,
                                                 mode):
    """Reduced falcon (Mamba1) and zamba2 (Mamba2) at s 32 as rank 0 of
    the single-pod mesh: with each plain scan one operation
    (``core.scan_op``) the run's FLOPs and collectives equal the loops',
    its peak within 2 %."""
    _, res = fake_group_run
    loop = res["scans"][f"{arch}/{mode}/loop"]
    one = res["scans"][f"{arch}/{mode}/one_op"]
    assert one["flops"] == loop["flops"] > 0
    assert one["collective_counts"] == loop["collective_counts"]
    assert one["collective_bytes"] == loop["collective_bytes"]
    assert abs(one["peak_bytes"] / loop["peak_bytes"] - 1) <= 0.02


# single-pod cells of ARCHS whose runs alone take more than a third of
# the fixture's 20 s limit on one CPU core, and which may record null
# there: granite's train cell (6.3-7.2 s), whisper's (12-13 s; its
# encoder runs in each of the four sub-runs) and zamba2's (~32 s)
MAY_PASS_THE_LIMIT = {("granite_moe_3b_a800m", "train_4k"),
                      ("whisper_tiny", "train_4k"),
                      ("zamba2_1p2b", "train_4k")}


@pytest.mark.parametrize("arch", ARCHS)
def test_peak_covers_the_arguments_on_every_ok_cell(fake_group_run, arch):
    """Every single-pod cell the arch takes is ok; each records a peak of
    at least its argument bytes and temp = peak - argument - output
    (floored at 0).  Only a cell of ``MAY_PASS_THE_LIMIT`` may instead
    record null and the time limit it hit (20 s here)."""
    out, _ = fake_group_run
    recs = [json.loads(p.read_text())
            for p in out.glob(f"{arch}__*__singlepod.json")]
    assert len(recs) == len(LM_SHAPES)
    for rec in recs:
        if rec["status"] == "skipped":
            continue
        assert rec["status"] == "ok", rec.get("error")
        mem = rec["memory"]
        if mem["peak_bytes"] is None:
            assert (arch, rec["shape"]) in MAY_PASS_THE_LIMIT, rec["shape"]
            assert mem["temp_bytes"] is None
            assert "passed 20 s" in rec["cost"]["flops_reason"]
            continue
        assert mem["peak_bytes"] >= mem["argument_bytes"], rec["shape"]
        assert mem["temp_bytes"] == max(mem["peak_bytes"]
                                        - mem["argument_bytes"]
                                        - mem["output_bytes"], 0)
        assert rec["cost"]["flops"] > 0


def test_dtensor_blocks_are_jax_order(fake_group_run):
    _, res = fake_group_run
    for rank, (offset, shape, want) in res["blocks"].items():
        assert [[o, o + n] for o, n in zip(offset, shape)] == want, rank
    assert res["blocks"]["300"][2][0] == [(300 // 16) * 32,
                                          (300 // 16) * 32 + 32]


# ---------------------------------------------------------------------------
# the one-operation scans against the loops, call by call
# ---------------------------------------------------------------------------

def _scan_inputs(kind):
    rng = np.random.default_rng(3)
    b, s, ds = 2, 7, 4
    if kind == "mamba1":
        di = 8
        arrays = [rng.standard_normal((b, s, di)), rng.random((b, s, di)),
                  rng.standard_normal((b, s, ds)),
                  rng.standard_normal((b, s, ds)), -rng.random((di, ds)),
                  rng.standard_normal((b, di, ds))]
    else:
        nh, dh = 3, 6
        arrays = [rng.standard_normal((b, s, nh, dh)), rng.random((b, s, nh)),
                  rng.standard_normal((b, s, nh, ds)),
                  rng.standard_normal((b, s, nh, ds)),
                  rng.standard_normal((b, nh, dh, ds))]
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize("c_grad", [True, False], ids=["C_grad", "no_C_grad"])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_one_op_scans_equal_the_loops(kind, c_grad):
    """Inside ``whole_scans()`` a scan is one operation forward and one
    backward.  On real tensors its values are the loop's, bitwise, and its
    backward refuses to run (the dry run's fake tensors alone reach it).
    On fake tensors its saved tensors hold the loop's bytes and its FLOPs
    are the loop's count forward and backward (one product fewer without
    C's gradient)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import scan_op
    from repro_torch.models.mamba import _mamba1_scan, _mamba2_scan
    fn = _mamba1_scan if kind == "mamba1" else _mamba2_scan
    arrays = _scan_inputs(kind)
    real = [torch.tensor(a, requires_grad=c_grad or i != 3)
            for i, a in enumerate(arrays)]
    y0, h0 = fn(*real)
    with scan_op.whole_scans():
        y1, h1 = fn(*real)
    assert torch.equal(y1, y0) and torch.equal(h1, h0)
    with pytest.raises(NotImplementedError, match="fake tensors"):
        (y1.square().sum() + h1.square().sum()).backward()
    counts = {}
    with FakeTensorMode() as mode:
        for name in ("loop", "one_op"):
            args = [mode.from_tensor(torch.tensor(a)).requires_grad_(
                c_grad or i != 3) for i, a in enumerate(arrays)]
            inputs = {a.untyped_storage()._cdata for a in args}
            saved = {}

            def pack(t):
                st = t.untyped_storage()
                saved[st._cdata] = st.nbytes()
                return t
            ctx = (scan_op.whole_scans() if name == "one_op"
                   else contextlib.nullcontext())
            with FlopCounterMode(display=False) as fc:
                with ctx, torch.autograd.graph.saved_tensors_hooks(
                        pack, lambda t: t):
                    y, h = fn(*args)
                fwd = fc.get_total_flops()
                (y.square().sum() + h.square().sum()).backward()
            assert all(a.grad is not None for a in args if a.requires_grad)
            counts[name] = (fwd, fc.get_total_flops() - fwd,
                            sum(n for p, n in saved.items()
                                if p not in inputs))
    (f0, b0, s0), (f1, b1, s1) = counts["loop"], counts["one_op"]
    assert (f1, b1, s1) == (f0, b0, s0) and b0 == f0 * (2 if c_grad else 1)
    assert s0 > 0
