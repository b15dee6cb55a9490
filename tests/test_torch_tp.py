"""Tensor-parallel training on the model axis against one process.

Six tiny configs, f32, three steps of the sharded step under ``fsdp`` on
gloo ranks (separate processes, ``file://`` rendezvous, one launch per
mesh, all at once): world 2 on a (data 1, model 2) mesh and world 4 on a
(data 2, model 2) mesh, and stablelm_3b and falcon_mamba_7b on a (data 2,
model 1) mesh too, each against one process from the same init and
batches.  Each layer's params are gathered as it runs
(``dist.layer_gather``), and each gradient comes back at its storage
shard's shape.  stablelm_3b is aligned MHA, wedlm8b_like GQA with g 2,
granite_moe_3b_a800m MoE with a tied table, minicpm3_4b MLA,
starcoder2_3b one kv head (the gathered-kv path), falcon_mamba_7b the
gathered Mamba blocks.  On the world-4 runs the model-axis all-gathers
are held to the leaves ``tp_plan`` uses whole, and the logits each rank
makes are at most V / 2 wide.  On the (2, 1) mesh a 4-layer stablelm's
high-water mark of gathered param bytes stays within one layer's
gather (twice) above its shards and the leaves outside the layers, with
and without remat.  A decode layer over a cache split on dh gathers the
cache once (a fake process group).  ``tp_plan`` of every full-size config at
tp 16 is pinned.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths, path_key  # noqa: E402
from repro_torch.dist import tensor_parallel as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m",
         "minicpm3_4b", "starcoder2_3b", "falcon_mamba_7b")
STEPS, SEQ, BATCH, N_MICRO = 3, 16, 4, 2
# the (data 2, model 1) mesh: fsdp alone
FSDP_ARCHS = ("stablelm_3b", "falcon_mamba_7b")
# mesh tag (the tests' id) -> ((data, model), the archs trained on it)
MESHES = {"2": ((1, 2), ARCHS), "4": ((2, 2), ARCHS),
          "2x1": ((2, 1), FSDP_ARCHS)}
CASES = [(a, m) for a in ARCHS for m in ("2", "4")] + \
    [(a, "2x1") for a in FSDP_ARCHS]
# prefill + decode under the model group, the cache in both layouts
FWD_ARCHS = ("stablelm_3b", "granite_moe_3b_a800m", "minicpm3_4b",
             "starcoder2_3b", "falcon_mamba_7b", "zamba2_1p2b")
FWD_MODES = ("head", "seq", "seq_whole")
TOL = 1e-5

WORKER = r"""
import os, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, leaves_with_paths, path_key
from repro_torch.dist import sharded_train as st
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharded_train import (gather, make_sharded_train_step,
                                            state_placements)
from repro_torch.dist.sharding import shard_tree
import importlib
ts = importlib.import_module("repro_torch.training.train_step")
rdzv, out, archs, data, model, tag = sys.argv[1], sys.argv[2], \
    sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, model), mesh_dim_names=("data",
                                                              "model"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tp_common import batches, fresh_state, opt_config
model_group = mesh.get_group("model")
gathers = []
real_gather = tp.all_gather


def counting_gather(t, dim, group, size):
    gathers.append((group is model_group, tuple(t.shape)))
    return real_gather(t, dim, group, size)


tp.all_gather = counting_gather
acc_shapes = []
real_accum = st.grad_accum_fn


def recording_accum(params, *a, **k):
    out_ = real_accum(params, *a, **k)
    acc_shapes.append([(tuple(g.shape), tuple(p.shape)) for g, p in
                       zip(leaves(out_[0]), leaves(params))])
    return out_


st.grad_accum_fn = recording_accum
widths = []
real_forward = ts.forward


def recording_forward(*a, **k):
    out_ = real_forward(*a, **k)
    widths.append(out_[0].shape[-1])
    return out_


ts.forward = recording_forward
for arch in archs.split(","):
    cfg = get_config(arch, reduced=True)
    state = fresh_state(cfg)
    placements = state_placements(state, mesh, "fsdp")
    state = shard_tree(state, placements, mesh)
    step = make_sharded_train_step(cfg, opt_config(), mesh, placements,
                                   %(batch)d, "fsdp", n_micro=%(n_micro)d,
                                   remat=True, params=state["params"])
    losses, norms, per_step = [], [], []
    del acc_shapes[:]
    for b in batches(cfg):
        del gathers[:]
        with CommDebugMode() as comm:
            state["params"], state["opt"], m = step(state["params"],
                                                    state["opt"], b)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        per_step.append({"model": [s for on, s in gathers if on],
                         "data": sum(not on for on, _ in gathers),
                         "comm_all_gather": counts.get(
                             "c10d._allgather_base_", 0),
                         "comm_all_reduce": counts.get("c10d.allreduce_", 0),
                         "comm_reduce_scatter": counts.get(
                             "c10d._reduce_scatter_base_", 0)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    roles = [(path_key(path), r.role, str(t.placements),
              tuple(t.to_local().shape), tuple(t.shape)) for (path, t), r
             in zip(leaves_with_paths(state["params"]),
                    leaves(step.keywords["layout"].roles))]
    full = gather(state)
    if rank == 0:
        torch.save({"losses": losses, "norms": norms, "state": full,
                    "steps": per_step, "widths": sorted(set(widths)),
                    "roles": roles, "acc_shapes": acc_shapes[0]},
                   os.path.join(out, "%%s_%%s.pt" %% (arch, tag)))
    del widths[:]
if tag == "2x1":
    from tp_common import high_water
    from tp_common import whole_stack
    got = {remat: high_water(mesh, remat) for remat in (True, False)}
    got["whole_stack"] = whole_stack(mesh)
    if rank == 0:
        torch.save(got, os.path.join(out, "high_water.pt"))
if tag == "2":
    from tp_common import forward_check
    for arch in %(fwd_archs)r:
        for mode in %(fwd_modes)r:
            got = forward_check(arch, mode, mesh, rank)
            if rank == 0:
                torch.save(got, os.path.join(out, "fwd_%%s_%%s.pt"
                                             %% (arch, mode)))
dist.destroy_process_group()
""" % {"batch": BATCH, "n_micro": N_MICRO, "fwd_archs": FWD_ARCHS,
       "fwd_modes": FWD_MODES}

COMMON = r"""
import torch
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.models import forward, init_cache, init_model
from repro_torch.core.tree import leaves
from repro_torch.training import AdamWConfig, init_opt_state
STEPS, SEQ, BATCH = %d, %d, %d


def opt_config():
    return AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)


def fresh_state(cfg):
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    return {"params": params, "opt": init_opt_state(params)}


def batches(cfg):
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH))
    return [{"tokens": torch.as_tensor(next(data)["tokens"])}
            for _ in range(STEPS)]


def high_water(mesh, remat):
    # one sharded step of a 4-layer reduced stablelm under fsdp: the most
    # gathered param bytes alive at once, the bound on it, and its loss
    # and grad norm against one process's
    import dataclasses, math
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.dist import layer_gather as lg
    from repro_torch.dist.sharded_train import (make_sharded_train_step,
                                                state_placements)
    from repro_torch.dist.sharding import block_of, shard_tree
    from repro_torch.training import make_train_step
    cfg = dataclasses.replace(get_config("stablelm_3b", reduced=True),
                              n_layers=4)
    b = batches(cfg)[0]
    one = fresh_state(cfg)
    _, _, want = make_train_step(cfg, opt_config(), n_micro=2,
                                 remat=remat)(one["params"], one["opt"], b)
    state = fresh_state(cfg)
    placements = state_placements(state, mesh, "fsdp")
    state = shard_tree(state, placements, mesh)
    step = make_sharded_train_step(cfg, opt_config(), mesh, placements,
                                   BATCH, "fsdp", n_micro=2, remat=remat,
                                   params=state["params"])
    layout = step.keywords["layout"]
    work = tree_map(lambda t, s, pl: math.prod(block_of(s, mesh, pl)[0])
                    * t.element_size(), state["params"], layout.shapes,
                    layout.work)
    layer = outside = 0
    for path, n in leaves_with_paths(work):
        if path[0] == "segments":
            layer += n // cfg.n_layers
        else:
            outside += n
    stored = sum(t.to_local().numel() * t.element_size()
                 for _, t in leaves_with_paths(state["params"]))
    lg.reset_peak()
    _, _, got = step(state["params"], state["opt"], b)
    return {"mark": stored + lg.gathered_bytes()["peak"],
            "bound": stored + outside + 2 * layer,
            "whole": sum(leaves(work)), "stored": stored,
            "loss": (float(got["loss"]), float(want["loss"])),
            "norm": (float(got["grad_norm"]), float(want["grad_norm"]))}


def whole_stack(mesh):
    # a 66-layer reduced stablelm (d 64): the fsdp rule shards the layer
    # dim of its stacked leaves over the data axis, so they are gathered
    # whole once per forward; one step without remat (the saved-tensor
    # hooks) against one process
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist import layer_gather as lg
    from repro_torch.dist.sharded_train import (make_sharded_train_step,
                                                state_placements)
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.training import make_train_step
    cfg = dataclasses.replace(get_config("stablelm_3b", reduced=True),
                              n_layers=66)
    b = batches(cfg)[0]
    one = fresh_state(cfg)
    _, _, want = make_train_step(cfg, opt_config(), n_micro=2,
                                 remat=False)(one["params"], one["opt"], b)
    state = fresh_state(cfg)
    placements = state_placements(state, mesh, "fsdp")
    state = shard_tree(state, placements, mesh)
    step = make_sharded_train_step(cfg, opt_config(), mesh, placements,
                                   BATCH, "fsdp", n_micro=2, remat=False,
                                   params=state["params"])
    _, _, got = step(state["params"], state["opt"], b)
    whole = [p.name for p in lg.plan_leaves(step.keywords["plan"])
             if p is not None and p.whole]
    return {"whole": whole,
            "loss": (float(got["loss"]), float(want["loss"])),
            "norm": (float(got["grad_norm"]), float(want["grad_norm"]))}


def serve_inputs(cfg):
    g = torch.Generator().manual_seed(5)
    return [torch.randint(0, cfg.vocab_size, (2, n), generator=g)
            for n in (12, 1, 3)]


def forward_steps(params, cfg, cache):
    # a 12-token prefill, then decodes of 1 and 3 positions
    out, at = [], 0
    for i, toks in enumerate(serve_inputs(cfg)):
        lg, cache, _, _ = forward(params, cfg, {"tokens": toks},
                                  mode="prefill" if i == 0 else "decode",
                                  cache=cache, cache_len=at)
        out.append(lg)
        at += toks.shape[1]
    return out, cache


def forward_check(arch, mode, mesh, rank):
    # the forward under the model group, the cache laid out by
    # cache_pspecs(mode), against one process: (logits, cache) errors;
    # "seq_whole": dp_only's replicated params over a seq-sharded cache
    whole = mode == "seq_whole"
    mode = "seq" if whole else mode
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.dist import sharded_train as st
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.sharding import (block_of, cache_pspecs,
                                           param_pspecs,
                                           placements_from_pspecs)
    from repro_torch.launch.specs import _model_dims
    cfg = get_config(arch, reduced=True)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    want, want_cache = forward_steps(params, cfg,
                                     init_cache(cfg, 2, 32, torch.float32, "cpu"))
    pl = placements_from_pspecs(param_pspecs(
        params, mesh, "dp_only" if whole else "fsdp"), mesh)

    def block(t, p):
        shape, off = block_of(tuple(t.shape), mesh, p)
        return t[tuple(slice(o, o + n) for o, n in zip(off, shape))].clone()
    layout = st.step_layout(params, {"params": pl, "opt": {"master": pl}},
                            mesh, cfg, 1 if whole else 2)
    work = tree_map(lambda t, p, s, a, b: st.relayout(block(t, p), mesh, s,
                                                      a, b),
                    params, pl, layout.shapes, layout.params, layout.work)
    cache = init_cache(cfg, 2, 32, torch.float32, "cpu")
    c_ps = cache_pspecs(cache, mesh, 2, mode)
    c_pl = placements_from_pspecs(c_ps, mesh)
    local = tree_map(block, cache, c_pl)
    group = mesh.get_group("model")
    with tp.model_group(group, 2, rank, whole=whole,
                        cache_dims=_model_dims(c_ps, cache, mesh)):
        got, got_cache = forward_steps(work, cfg, local)
    if not whole:
        got = [tp.all_gather(g, -1, group, 2) for g in got]
    errs = {"logits": max(float((g - w).abs().max())
                          for g, w in zip(got, want))}
    errs["cache"] = max(float((block(w, p) - g).abs().max()) for w, g, p in
                        zip(leaves(want_cache), leaves(got_cache),
                            leaves(c_pl, lambda x: isinstance(x, list)
                                   and not isinstance(x[0], (list, dict)))))
    errs["sharded_cache_leaves"] = sum(
        any(q.is_shard() for q in p[1:]) for p in leaves(
            c_pl, lambda x: isinstance(x, list)
            and not isinstance(x[0], (list, dict))))
    return errs
""" % (STEPS, SEQ, BATCH)


def _launch(tmp: Path, tag: str):
    rdzv = tmp / f"rdzv{tag}"
    (data, model), archs = MESHES[tag]
    world = data * model
    env = {**os.environ, "OMP_NUM_THREADS": "1", "WORLD_SIZE": str(world),
           "PYTHONPATH": str(ROOT / "src")}
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(rdzv), str(tmp),
         ",".join(archs), str(data), str(model), tag],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _load_common(tmp: Path):
    sys.path.insert(0, str(tmp))
    try:
        import tp_common
    finally:
        sys.path.remove(str(tmp))
    return tp_common


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """{(arch, mesh tag): rank 0's losses, grad norms, gathered final
    state, gathers per step, logits widths, leaf roles and accumulator
    shapes} of the gloo runs (the launches at once), with the forward
    checks and the (2, 1) mesh's high-water marks, and {arch: the
    one-process run}."""
    from repro_torch.training import make_train_step
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "worker.py").write_text(WORKER)
    (tmp / "tp_common.py").write_text(COMMON)
    procs = {m: _launch(tmp, m) for m in MESHES}
    common = _load_common(tmp)
    single = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        state = common.fresh_state(cfg)
        step = make_train_step(cfg, common.opt_config(), n_micro=N_MICRO,
                               remat=True)
        losses, norms = [], []
        for b in common.batches(cfg):
            state["params"], state["opt"], m = step(state["params"],
                                                    state["opt"], b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        single[arch] = {"losses": losses, "norms": norms, "state": state}
    for world, ps in procs.items():
        outs = []
        try:
            for p in ps:
                outs.append(p.communicate(timeout=400)[0])
        finally:
            for p in ps:
                p.kill()
        for r, (p, out) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"world {world} rank {r}:\n{out[-3000:]}"
    runs = {(a, m): torch.load(tmp / f"{a}_{m}.pt", weights_only=False)
            for a, m in CASES}
    runs["high_water"] = torch.load(tmp / "high_water.pt")
    runs.update({(a, m): torch.load(tmp / f"fwd_{a}_{m}.pt")
                 for a in FWD_ARCHS for m in FWD_MODES})
    return runs, single


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch,world", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_tensor_parallel_training_equals_one_process(tp_runs, arch, world):
    """Losses, grad norms and every final param and AdamW leaf within
    1e-5 relative of one process (f32; the row-parallel sums, the
    vocabulary's reductions and the gradients' reduce-scatters add in
    another order).  ``world``: the mesh's tag, 2 (data 1, model 2), 4
    (2, 2) or 2x1 (2, 1)."""
    runs, single = tp_runs
    run, one = runs[arch, world], single[arch]
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=TOL)
    np.testing.assert_allclose(run["norms"], one["norms"], rtol=TOL)
    for (path, a), b in zip(leaves_with_paths(run["state"]),
                            leaves(one["state"])):
        assert _rel(a.numpy(), b.numpy()) <= TOL, path_key(path)


def test_a_leaf_sharded_on_the_layer_dim_is_gathered_whole(tp_runs):
    """A 66-layer stablelm of width 64 on the (2, 1) mesh: fsdp shards the
    layer dim of its stacked leaves (the largest), so each is gathered
    whole once per forward before the layers take their views; one step
    without remat within 1e-5 of one process."""
    runs, _ = tp_runs
    r = runs["high_water"]["whole_stack"]
    assert "segments/[0]/ln1/scale" in r["whole"], r["whole"]
    np.testing.assert_allclose(*r["loss"], rtol=TOL)
    np.testing.assert_allclose(*r["norm"], rtol=TOL)


def _model_gather_bounds(roles):
    """{input shape: (least, most) model-axis all-gathers a step makes of
    it}: a param the model axis shards but the plan uses whole (``full``
    / ``partial``) is gathered where it is used, a layer's leaves twice
    per micro-batch (the forward and remat's recompute), a leaf outside
    the layers at least once per micro-batch (and again where the
    backward unpacks it); nothing else is gathered over the model axis."""
    bounds = {}
    for path, role, placements, local, shape in roles:
        if role not in (tp.FULL, tp.PARTIAL) or \
                "Shard" not in placements.split(",")[-1]:
            continue
        layered = path.startswith("segments/") and local[0] == shape[0]
        use = local[1:] if layered else local
        lo, hi = bounds.get(use, (0, 0))
        if layered:
            n = 2 * N_MICRO * shape[0]
            bounds[use] = (lo + n, hi + n)
        else:
            bounds[use] = (lo + N_MICRO, float("inf"))
    return bounds


def _check_model_gathers(steps, roles):
    bounds = _model_gather_bounds(roles)
    for s in steps:
        got = {}
        for shape in s["model"]:
            got[tuple(shape)] = got.get(tuple(shape), 0) + 1
        assert set(got) <= set(bounds), (got, bounds)
        for shape, (lo, hi) in bounds.items():
            assert lo <= got.get(shape, 0) <= hi, (shape, got, bounds)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_model_axis_gather_of_a_local_leaf(tp_runs, arch):
    """World 4 (data 2 x model 2): every step's model-axis all-gathers
    are those of the leaves the plan uses whole, where they are used
    (``_model_gather_bounds``), none of a leaf it keeps local (a sliced
    head's gradient is summed, not gathered); the data axis gathers each
    layer's sharded leaves and reduce-scatters their gradients;
    CommDebugMode sees every gather; no rank's logits are wider than
    V / 2."""
    runs, _ = tp_runs
    run = runs[arch, "4"]
    cfg = get_config(arch, reduced=True)
    local = sum(r[1] == tp.LOCAL for r in run["roles"])
    assert local > 0
    _check_model_gathers(run["steps"], run["roles"])
    for s in run["steps"]:
        assert s["comm_all_gather"] == len(s["model"]) + s["data"]
        assert s["data"] > 0 and s["comm_reduce_scatter"] > 0
    assert max(run["widths"]) <= cfg.vocab_size // 2


def test_world_two_gathers_nothing_over_data(tp_runs):
    """On the (1, 2) mesh nothing is data-sharded: the only gathers are the
    plan's model-axis ones."""
    runs, _ = tp_runs
    for arch in ARCHS:
        for s in runs[arch, "2"]["steps"]:
            assert s["data"] == 0, arch
        _check_model_gathers(runs[arch, "2"]["steps"],
                             runs[arch, "2"]["roles"])


@pytest.mark.parametrize("world", ("4", "2x1"))
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_accumulator_leaves_have_their_local_shapes(tp_runs, arch, world):
    """The f32 gradient accumulator of ``grad_accum_fn`` holds each leaf
    at its storage shard's shape (the backward reduce-scatters each
    gathered leaf's gradient), smaller than the leaf where the data axis
    shards it."""
    runs, _ = tp_runs
    run = runs[arch, world]
    shapes = run["acc_shapes"]
    assert len(shapes) == len(run["roles"])
    for (acc, local), role in zip(shapes, run["roles"]):
        assert acc == local == role[3], role
    assert sum(r[3] != r[4] for r in run["roles"]) > 0


@pytest.mark.parametrize("remat", (True, False))
def test_gathered_bytes_stay_within_a_layer(tp_runs, remat):
    """A 4-layer stablelm on the (2, 1) mesh: the storage shard plus the
    most gathered param bytes alive at once stays within the shard, the
    leaves outside the layers and twice the largest layer's gathered
    bytes, and strictly below the whole tree; with remat (gathered again
    in the recompute) and without (saved as local slices, gathered again
    on unpack), the step's loss and grad norm within 1e-5 of one
    process's."""
    runs, _ = tp_runs
    r = runs["high_water"][remat]
    assert r["stored"] < r["mark"] <= r["bound"], r
    assert r["mark"] < r["whole"], r
    np.testing.assert_allclose(*r["loss"], rtol=TOL)
    np.testing.assert_allclose(*r["norm"], rtol=TOL)


PLAN_16 = {
    "stablelm_3b": dict(embed="tp", head="tp", attn="tp", ffn="tp"),
    "wedlm8b_like": dict(embed="tp", head="tp", attn="tp_kv_gathered",
                         ffn="tp"),
    "granite_moe_3b_a800m": dict(embed="gathered", head="gathered",
                                 attn="gathered", ffn="tp"),
    "llada_mini_like": dict(embed="tp", head="tp", attn="tp_kv_gathered",
                            ffn="tp"),
    "falcon_mamba_7b": dict(embed="tp", head="tp", ssm="gathered"),
    "minicpm3_4b": dict(embed="gathered", head="gathered", attn="gathered",
                        ffn="tp"),
    "mixtral_8x22b": dict(embed="tp", head="tp", attn="tp_kv_gathered",
                          ffn="tp"),
    "starcoder2_3b": dict(embed="tp", head="tp", attn="gathered", ffn="tp"),
    "phi3_medium_14b": dict(embed="tp", head="tp", attn="gathered",
                            ffn="tp"),
    "phi3_vision_4p2b": dict(embed="tp", head="tp", attn="tp", ffn="tp"),
    "zamba2_1p2b": dict(embed="tp", head="tp", ssm="gathered",
                        shared_attn="tp", shared_ffn="tp"),
    "whisper_tiny": dict(embed="gathered", head="gathered", attn="gathered",
                         ffn="tp", cross="gathered",
                         encoder_attn="gathered", encoder_ffn="tp"),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_plan_at_the_production_model_axis(arch):
    """``tp_plan`` of the full-size configs at tp 16, pinned: kv heads
    below 16 with each rank's q heads in one group gather ``wk`` / ``wv``
    (wedlm, llada, mixtral); q or MLA heads that 16 does not divide
    (granite 24, starcoder2 24, phi3_medium 40, minicpm3 40, whisper 6),
    the SSM blocks and a vocabulary of 49155 / 73448 / 51865 run whole."""
    assert tp.tp_plan(get_config(arch), 16) == PLAN_16[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_plan_of_one_rank_splits_nothing_but_ssm(arch):
    """At tp 1 every attention, FFN and vocabulary block is ``tp`` (a
    split into one part) and the step enters no model group."""
    plan = tp.tp_plan(get_config(arch), 1)
    assert {k for k, v in plan.items() if v != tp.TP} <= {"ssm"}


def test_operations_are_the_identity_outside_a_model_group():
    x = torch.randn(3, 4, requires_grad=True)
    assert tp.current() is None
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    with tp.model_group(None, 4, 0):
        assert tp.current() is None
    assert tp.mode(get_config("stablelm_3b"), "attn") is None


def test_local_attention_takes_the_kv_head_of_its_q_heads():
    """starcoder2 at tp 2 (4 q heads, 1 kv head): both ranks read kv head
    0; mixtral full size at tp 16 (48 / 8): rank r reads head 3r // 6."""
    a = get_config("starcoder2_3b", reduced=True).attention
    w = {"wq": torch.zeros(64, 32), "wo": torch.zeros(32, 64),
         "wk": torch.arange(16.)[None].expand(64, 16),
         "wv": torch.arange(16.)[None].expand(64, 16)}
    for rank in (0, 1):
        la, p, kv0 = tp.local_attention(a, w, tp.TP_KV, 2, rank)
        assert (la.n_heads, la.n_kv_heads, kv0) == (2, 1, 0)
        assert torch.equal(p["wk"], w["wk"])
    m = get_config("mixtral_8x22b").attention
    dh = m.head_dim
    wk = torch.arange(8 * dh, dtype=torch.float32)[None]
    for rank in range(16):
        la, p, kv0 = tp.local_attention(m, {"wk": wk, "wv": wk}, tp.TP_KV,
                                        16, rank)
        assert (la.n_heads, la.n_kv_heads, kv0) == (3, 1, 3 * rank // 6)
        assert torch.equal(p["wk"][0], wk[0, kv0 * dh:(kv0 + 1) * dh])


@pytest.mark.parametrize("mode", FWD_MODES)
@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_forward_with_a_sharded_cache_equals_one_process(tp_runs, arch,
                                                         mode):
    """Prefill then two decodes under the model group of the (1, 2) mesh,
    the cache laid out by ``cache_pspecs(mode)`` (the dry run's cells):
    the logits (each rank's vocabulary block, gathered) and every cache
    leaf's block within 1e-5 of one process.  Heads split as the plan
    splits them are read in place; a cache sharded otherwise (the ``seq``
    mode, starcoder2's one kv head split on dh, MLA's latent, SSM states)
    is gathered per layer and this rank's block written back.
    ``seq_whole``: replicated params (``dp_only``) over the ``seq`` cache,
    every block whole (the ``opt`` decode cells of zamba2 and whisper)."""
    runs, _ = tp_runs
    r = runs[arch, mode]
    assert r["sharded_cache_leaves"] > 0
    assert r["logits"] <= TOL and r["cache"] <= TOL, r

CACHE_ONCE = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist import sharded_train as st
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import (block_of, cache_pspecs, param_pspecs,
                                       placements_from_pspecs)
from repro_torch.launch.specs import _model_dims
from repro_torch.models import forward, init_cache, init_model
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
cfg = get_config("starcoder2_3b", reduced=True)
params = init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                    torch.float32)
pl = placements_from_pspecs(param_pspecs(params, mesh, "fsdp"), mesh)
layout = st.step_layout(params, {"params": pl, "opt": {"master": pl}}, mesh,
                        cfg, 2)


def block(t, p):
    shape, off = block_of(tuple(t.shape), mesh, p)
    return t[tuple(slice(o, o + n) for o, n in zip(off, shape))].clone()


work = tree_map(block, params, layout.work)
b, s_max, n = 2, 32, 3
cache = init_cache(cfg, b, s_max, torch.float32, "cpu")
c_ps = cache_pspecs(cache, mesh, b, "head")
local = tree_map(block, cache, placements_from_pspecs(c_ps, mesh))
gathers = []
real = tp.all_gather


def counting(t, dim, group, size):
    gathers.append(t.numel())
    return real(t, dim, group, size)


tp.all_gather = counting
with tp.model_group(mesh.get_group("model"), 2, 0,
                    cache_dims=_model_dims(c_ps, cache, mesh)):
    forward(work, cfg, {"tokens": torch.zeros((b, n), dtype=torch.long)},
            mode="decode", cache=local, cache_len=5)
seg = local["segments"][0]
print("RESULT::" + json.dumps({
    "gathers": gathers, "layers": cfg.n_layers, "kv": cfg.attention.n_kv_heads,
    "leaf_numel": seg["k"][0].numel(), "dims": leaves(_model_dims(
        c_ps, cache, mesh)), "n": n, "s_max": s_max}))
dist.destroy_process_group()
"""


def test_decode_over_a_dh_sharded_cache_gathers_it_once():
    """starcoder2 (one kv head) on a fake two-rank model axis: its cache
    is split on dh, so a decode layer gathers each of K and V whole, once,
    and afterwards exchanges only the n positions it wrote (each rank's
    kv head there), not the whole cache again."""
    r = subprocess.run([sys.executable, "-c", CACHE_ONCE],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    got = json.loads(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("RESULT::"))[8:])
    assert got["kv"] == 1 and set(got["dims"]) == {-1}
    whole = [g for g in got["gathers"] if g == got["leaf_numel"]]
    assert len(whole) == 2 * got["layers"]
    rest = [g for g in got["gathers"] if g != got["leaf_numel"]]
    assert len(rest) == 2 * got["layers"]
    assert all(g * got["s_max"] <= got["leaf_numel"] * 2 * got["n"]
               for g in rest), got


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("dim", (None, -3, -2, -1))
def test_a_rank_stores_the_written_positions_of_its_block(dim, rank):
    """``tensor_parallel._store`` writes the n positions a forward wrote,
    from each row's start modulo the cache length (the ring buffer wraps;
    row 1 starts 2 before the end), into this rank's block of a (b, S,
    kv, dh) cache leaf split on the sequence, heads or dh dim (or whole),
    exactly as writing them into the whole leaf and taking the block."""
    g = torch.Generator().manual_seed(3)
    b, s, kv, dh, n = 2, 8, 2, 4, 3
    full = torch.randn(b, s, kv, dh, generator=g)
    piece = torch.randn(b, n, kv, dh, generator=g)
    start = torch.tensor([1, s - 2])
    want = full.clone()
    for r in range(b):
        for j in range(n):
            want[r, (int(start[r]) + j) % s] = piece[r, j]

    def block(t):
        if dim is None:
            return t.clone()
        m = t.shape[dim] // 2
        return t.narrow(dim, rank * m, m).clone()
    got = block(full)
    pos = (start[:, None] + torch.arange(n)) % s
    with tp.model_group(object(), 2, rank):
        tp._store(got, dim, piece, pos, start, s)
    assert torch.equal(got, block(want))
