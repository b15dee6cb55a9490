"""Tensor-parallel training on the model axis against one process.

Six tiny configs, f32, three steps of the sharded step under ``fsdp`` on
gloo ranks (separate processes, ``file://`` rendezvous, one launch per
world size): world 2 on a (data 1, model 2) mesh and world 4 on a
(data 2, model 2) mesh, each against one process from the same init and
batches.  stablelm_3b is aligned MHA, wedlm8b_like GQA with g 2,
granite_moe_3b_a800m MoE with a tied table, minicpm3_4b MLA,
starcoder2_3b one kv head (the gathered-kv path), falcon_mamba_7b the
gathered Mamba blocks.  On the world-4 runs the model-axis all-gathers
are counted against what ``tp_plan`` gathers, and the logits each rank
makes are at most V / 2 wide.  ``tp_plan`` of every full-size config at
tp 16 is pinned.
"""
from __future__ import annotations

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
MESHES = {2: (1, 2), 4: (2, 2)}
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
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharded_train import (gather, make_sharded_train_step,
                                            state_placements)
from repro_torch.dist.sharding import shard_tree
import importlib
ts = importlib.import_module("repro_torch.training.train_step")
rdzv, out, archs, data, model = sys.argv[1], sys.argv[2], sys.argv[3], \
    int(sys.argv[4]), int(sys.argv[5])
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
    gathers.append(group is model_group)
    return real_gather(t, dim, group, size)


tp.all_gather = counting_gather
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
    for b in batches(cfg):
        del gathers[:]
        with CommDebugMode() as comm:
            state["params"], state["opt"], m = step(state["params"],
                                                    state["opt"], b)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        per_step.append({"model": sum(gathers),
                         "data": len(gathers) - sum(gathers),
                         "comm_all_gather": counts.get("c10d.allgather_", 0),
                         "comm_all_reduce": counts.get("c10d.allreduce_", 0)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    roles = [(path_key(path), r.role, str(t.placements)) for (path, t), r
             in zip(leaves_with_paths(state["params"]),
                    leaves(step.keywords["layout"].roles))]
    full = gather(state)
    if rank == 0:
        torch.save({"losses": losses, "norms": norms, "state": full,
                    "steps": per_step, "widths": sorted(set(widths)),
                    "roles": roles},
                   os.path.join(out, "%%s_w%%d.pt" %% (arch, world)))
    del widths[:]
if world == 2:
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


def _launch(tmp: Path, world: int):
    rdzv = tmp / f"rdzv{world}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "WORLD_SIZE": str(world),
           "PYTHONPATH": str(ROOT / "src")}
    data, model = MESHES[world]
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(rdzv), str(tmp),
         ",".join(ARCHS), str(data), str(model)],
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
    """{(arch, world): rank 0's losses, grad norms, gathered final state,
    gather counts per step, logits widths and leaf roles} of the gloo
    runs (both launches at once), and {arch: the one-process run}."""
    from repro_torch.training import make_train_step
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "worker.py").write_text(WORKER)
    (tmp / "tp_common.py").write_text(COMMON)
    procs = {w: _launch(tmp, w) for w in MESHES}
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
    runs = {(a, w): torch.load(tmp / f"{a}_w{w}.pt", weights_only=False)
            for a in ARCHS for w in MESHES}
    runs.update({(a, m): torch.load(tmp / f"fwd_{a}_{m}.pt")
                 for a in FWD_ARCHS for m in FWD_MODES})
    return runs, single


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_training_equals_one_process(tp_runs, arch, world):
    """Losses, grad norms and every final param and AdamW leaf within
    1e-5 relative of one process (f32; the row-parallel sums and the
    vocabulary's reductions add in another order)."""
    runs, single = tp_runs
    run, one = runs[arch, world], single[arch]
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=TOL)
    np.testing.assert_allclose(run["norms"], one["norms"], rtol=TOL)
    for (path, a), b in zip(leaves_with_paths(run["state"]),
                            leaves(one["state"])):
        assert _rel(a.numpy(), b.numpy()) <= TOL, path_key(path)


def _expected_model_gathers(roles) -> int:
    """Per step: a param the model axis shards but the plan uses whole
    (``full`` / ``partial``) is gathered for the forward; a sliced one's
    gradient is gathered back."""
    n = 0
    for _, role, placements in roles:
        sharded = "Shard" in placements.split(",")[-1]
        n += (role in (tp.FULL, tp.PARTIAL) and sharded) or role == tp.SLICE
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_no_model_axis_gather_of_a_local_leaf(tp_runs, arch):
    """World 4 (data 2 x model 2): every step's model-axis all-gathers
    are exactly those of the leaves the plan gathers (and the sliced head's
    gradient), none of a leaf it keeps local; the data-axis gathers are
    one per data-sharded leaf plus the ZeRO-2 write-backs; CommDebugMode
    sees all of them; no rank's logits are wider than V / 2."""
    runs, _ = tp_runs
    run = runs[arch, 4]
    cfg = get_config(arch, reduced=True)
    want = _expected_model_gathers(run["roles"])
    local = sum(r == tp.LOCAL for _, r, _ in run["roles"])
    assert local > 0
    for s in run["steps"]:
        assert s["model"] == want, (s, want)
        assert s["comm_all_gather"] == s["model"] + s["data"]
        assert s["data"] > 0
    assert max(run["widths"]) <= cfg.vocab_size // 2


def test_world_two_gathers_nothing_over_data(tp_runs):
    """On the (1, 2) mesh nothing is data-sharded: the only gathers are the
    plan's model-axis ones."""
    runs, _ = tp_runs
    for arch in ARCHS:
        for s in runs[arch, 2]["steps"]:
            assert s["data"] == 0, arch
            assert s["model"] == _expected_model_gathers(
                runs[arch, 2]["roles"]), arch


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