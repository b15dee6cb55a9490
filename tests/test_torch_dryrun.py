"""The placement-and-memory dry run against the reference's cells.

Per-device argument bytes: for stablelm_3b, granite_moe_3b_a800m,
zamba2_1p2b and whisper_tiny, every shape, both production meshes, the
baseline and opt variants, the port's ``build_cell`` args and specs give
the bytes reckoned from the reference's ``build_cell`` args
(``jax.eval_shape``, no compile) and specs on the duck-typed meshes.

In one subprocess with the fake 512-rank process group: the CLI writes
the reference's record keys, skips ``long_500k`` where the reference
does, and its argument bytes are the ones reckoned here; two probe
counts checked by hand (a ``tp_only`` row-parallel ``wo`` gives one
all-reduce per use, an ``fsdp`` ``wq`` one all-gather); DTensor's blocks
for a dim sharded by ("pod", "data") are JAX's (pod the major digit).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.dist.sharding import P, param_pspecs
from repro_torch.launch import dryrun
from repro_torch.launch.specs import params_abstract
out = sys.argv[1]
assert dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                    "--mesh", "both", "--out", out]) == 0
assert dryrun.main(["--arch", "stablelm_3b", "--shape", "long_500k",
                    "--mesh", "single", "--out", out]) == 0
res = {}
meshes = dryrun.fake_meshes()
single = meshes["singlepod"]
params = params_abstract(get_config("stablelm_3b"))
for policy, leaf in (("tp_only", "wo"), ("fsdp", "wq")):
    spec = param_pspecs(params, single, policy)["segments"][0]["attn"][leaf]
    w = params["segments"][0]["attn"][leaf]
    res[f"{policy}_{leaf}"] = dryrun.probe_leaf(
        leaf, w.shape[1:], w.dtype, P(*spec[1:]), single, 64 * 128, "data")
    tree = {"segments": [{"attn": {leaf: w}}]}
    ps = {"segments": [{"attn": {leaf: spec}}]}
    res[f"{policy}_{leaf}_train_step"] = dryrun.probe_collectives(
        tree, ps, single, tokens=64 * 128, bdim="data", n_micro=4,
        train=True)[0]
    res[f"{policy}_{leaf}_layers"] = w.shape[0]
torch.distributed.destroy_process_group()
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
                       capture_output=True, text=True, timeout=300,
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
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_bytes"] is None
    assert set(rec["cost"]) >= {"flops", "bytes_accessed", "transcendentals"}
    assert rec["cost"]["flops"] > 0
    assert rec["n_devices"] == (256 if mesh == "singlepod" else 512)
    assert rec["memory"]["argument_bytes"] == port_argument_bytes(
        "whisper_tiny", "decode_32k", mesh, "baseline")
    assert rec["memory"]["output_bytes"] > 0
    assert set(rec["collective_counts"]) == {"all_reduce", "all_gather",
                                             "reduce_scatter", "all_to_all"}


def test_cli_skips_long_500k_where_the_reference_does(fake_group_run):
    out, _ = fake_group_run
    rec = json.loads((out / "stablelm_3b__long_500k__singlepod.json")
                     .read_text())
    ok, why = ref_applicable(ref_config("stablelm_3b"), REF_SHAPES[-1])
    assert not ok and rec["status"] == "skipped" and rec["reason"] == why


def test_probe_row_parallel_wo_all_reduces_once(fake_group_run):
    _, res = fake_group_run
    r = res["tp_only_wo"]
    assert r["counts"] == {"all_reduce": 1, "all_gather": 0,
                           "reduce_scatter": 0, "all_to_all": 0}
    # the (64 x 128 / 16 rows, 2560) bf16 partial output of one data shard
    assert r["bytes"]["all_reduce"] == 64 * 128 // 16 * 2560 * 2
    # per step: layers x 4 micro-batches x 3 products
    assert res["tp_only_wo_train_step"]["all_reduce"] == \
        res["tp_only_wo_layers"] * 4 * 3


def test_probe_fsdp_wq_all_gathers_once(fake_group_run):
    _, res = fake_group_run
    r = res["fsdp_wq"]
    assert r["counts"] == {"all_reduce": 0, "all_gather": 1,
                           "reduce_scatter": 0, "all_to_all": 0}
    # its (2560 / 16, 2560 / 16) bf16 shard
    assert r["bytes"]["all_gather"] == 160 * 160 * 2


def test_dtensor_blocks_are_jax_order(fake_group_run):
    _, res = fake_group_run
    for rank, (offset, shape, want) in res["blocks"].items():
        assert [[o, o + n] for o, n in zip(offset, shape)] == want, rank
    assert res["blocks"]["300"][2][0] == [(300 // 16) * 32,
                                          (300 // 16) * 32 + 32]
