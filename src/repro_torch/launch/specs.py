"""Abstract inputs for every (arch x shape) cell — the reference's
``launch/specs.py``.

The params, optimizer state and cache come from the port's own
``init_model`` / ``init_opt_state`` / ``init_cache`` run under ONE
``FakeTensorMode`` (``fake_mode()``): tensors with shapes and dtypes and
no storage, made with a CPU generator (the ``meta`` device is refused by
``init_model``).  Nothing is allocated, so the dry run builds the
production step functions' inputs at full size on any host, and
``materialize`` makes real (uninitialised) per-device shards of them.

Each cell builder returns ``(fn, args, in_specs, out_specs)``: ``fn``
calls the port's ``forward`` or train step on ``args``, and the specs
are ``dist.sharding`` PartitionSpec trees (``None``: replicated).

``rank_local_cell`` turns a cell into what one rank of the mesh runs: its
local shards of ``args`` (fake tensors, shaped by the cell's placements,
the ones its argument bytes are reckoned from), and a function that runs
the cell as that rank: the sharded train step on local tensors
(``dist.sharded_train.local_train_step``), or ``forward`` on the model
axis's shards under ``dist.tensor_parallel.model_group`` (the cache's
layout given, so a cache leaf not laid out as its block reads it is
gathered per layer), each layer's params gathered over the data axes as
it runs (``dist.layer_gather``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.core.arch import ArchConfig, ShapeSpec
from repro_torch.core.granularity import round_up
from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist.sharding import (P, batch_pspec, block_of,
                                       broadcast_specs, cache_pspecs,
                                       is_spec, local_shape,
                                       mesh_axes, opt_pspecs, param_pspecs,
                                       placements_from_pspecs, spec_axes)
from repro_torch.models.transformer import forward, init_cache, init_model
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

SEED = 0


@functools.lru_cache(maxsize=None)
def fake_mode():
    """The one ``FakeTensorMode`` every abstract tensor of this process
    belongs to (fake tensors of two modes do not mix)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def abstract(shape, dtype) -> torch.Tensor:
    """A fake tensor: ``jax.ShapeDtypeStruct``'s counterpart."""
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype)


def params_abstract(cfg: ArchConfig):
    with fake_mode():
        return init_model(cfg, torch.Generator(device="cpu").manual_seed(SEED),
                          "cpu")


def opt_abstract(params):
    with fake_mode():
        return init_opt_state(params)


def cache_abstract(cfg: ArchConfig, batch: int, max_len: int,
                   swa_ring: bool = False):
    with fake_mode():
        return init_cache(cfg, batch, max_len, device="cpu",
                          swa_ring=swa_ring)


def _batch_like_pspec(mesh, b: int, extra_dims: int) -> P:
    bdim = batch_pspec(mesh, b)[0]   # tokens spec is (bdim, None)
    return P(bdim, *([None] * extra_dims))


# ===========================================================================
# Cell builders: each returns (fn, args, in_pspecs, out_pspecs)
# ===========================================================================

REMAT_FRACTION_OPT = {
    # dense trainers afford saving layers outright
    "phi3-medium-14b": 0.25, "stablelm-3b": 0.5, "starcoder2-3b": 0.5,
    "phi-3-vision-4.2b": 0.5, "minicpm3-4b": 0.5,
}

# sub-2B models replicate and train pure-DP over all 256 chips: no
# per-layer TP collectives at all, grads all-reduce once
DP_ONLY_OPT = {"zamba2-1.2b", "whisper-tiny"}


def _opt_policy(cfg: ArchConfig) -> str:
    if cfg.name in DP_ONLY_OPT:
        return "dp_only"
    # MoE under TP-only forces per-layer (tokens, d_model) combines after
    # the f-sharded expert products; keep 2D FSDP there
    if cfg.ffn.kind == "moe":
        return "fsdp"
    return "auto"


def cell_policy(cfg: ArchConfig, mode: str, variant: str) -> str:
    """The sharding policy of a cell's params."""
    if variant != "opt":
        return "fsdp"
    if mode == "prefill" and _opt_policy(cfg) == "dp_only":
        # dp_only is a TRAIN mapping (grads all-reduce once); prefill takes
        # the auto (tp/fsdp) policy
        return "auto"
    return _opt_policy(cfg)


def train_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               n_micro: int = 4, remat=True, variant: str = "baseline"):
    dp_only = variant == "opt" and _opt_policy(cfg) == "dp_only"
    if variant == "opt":
        remat = REMAT_FRACTION_OPT.get(cfg.name, 1.0)
    if dp_only:
        n_micro = 1            # full batch spreads over all 256 chips
    mb = shape.global_batch // n_micro
    if shape.global_batch % n_micro:
        raise ValueError(
            f"global_batch {shape.global_batch} is not divisible by "
            f"n_micro={n_micro}")
    lead = () if n_micro == 1 else (n_micro,)
    lead_ps = () if n_micro == 1 else (None,)
    batch: Dict[str, Any] = {
        "tokens": abstract((*lead, mb, shape.seq_len), torch.int32)}
    bp = batch_pspec(mesh, mb, include_model=dp_only)
    batch_ps: Dict[str, Any] = {"tokens": P(*lead_ps, *bp)}
    if cfg.family == "vlm":
        batch["embeds"] = abstract((*lead, mb, shape.seq_len, cfg.d_model),
                                   torch.bfloat16)
        batch_ps["embeds"] = P(*lead_ps, *bp, None)
    if cfg.encoder is not None:
        batch["frames"] = abstract((*lead, mb, cfg.encoder.n_frames,
                                    cfg.d_model), torch.bfloat16)
        batch_ps["frames"] = P(*lead_ps, *bp, None)

    params = params_abstract(cfg)
    opt = opt_abstract(params)
    policy = cell_policy(cfg, "train", variant)
    p_ps = param_pspecs(params, mesh, policy=policy)
    o_ps = (opt_pspecs(opt, p_ps, mesh) if variant == "opt"
            else opt_pspecs(opt, p_ps))
    opt_cfg = AdamWConfig()
    fn = make_train_step(cfg, opt_cfg, n_micro=n_micro, remat=remat)
    args = (params, opt, batch)
    in_ps = (p_ps, o_ps, batch_ps)
    out_ps = (p_ps, o_ps, None)
    return fn, args, in_ps, out_ps


def _fwd_inputs(inp: Dict) -> Dict:
    fwd_in = ({"embeds": inp["embeds"]} if "embeds" in inp
              else {"tokens": inp["tokens"]})
    if "frames" in inp:
        fwd_in["frames"] = inp["frames"]
    return fwd_in


def _extra_inputs(cfg: ArchConfig, mesh, b: int, n: int, tokens):
    inputs: Dict[str, Any] = {"tokens": tokens}
    in_extra_ps: Dict[str, Any] = {"tokens": batch_pspec(mesh, b)}
    if cfg.family == "vlm":
        inputs = {"embeds": abstract((b, n, cfg.d_model), torch.bfloat16),
                  "tokens": tokens}
        in_extra_ps["embeds"] = _batch_like_pspec(mesh, b, 2)
    if cfg.encoder is not None:
        inputs["frames"] = abstract((b, cfg.encoder.n_frames, cfg.d_model),
                                    torch.bfloat16)
        in_extra_ps["frames"] = _batch_like_pspec(mesh, b, 2)
    return inputs, in_extra_ps


def prefill_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
                 variant: str = "baseline"):
    b, s = shape.global_batch, shape.seq_len
    buf = round_up(s, 256) if variant == "opt" else s
    cache = cache_abstract(cfg, b, buf)
    inputs, in_extra_ps = _extra_inputs(cfg, mesh, b, s,
                                        abstract((b, s), torch.int32))

    def fn(params, inp, cache):
        logits, new_cache, _, _ = forward(params, cfg, _fwd_inputs(inp),
                                          mode="prefill", cache=cache,
                                          cache_len=0)
        return logits[:, -1], new_cache

    params = params_abstract(cfg)
    policy = cell_policy(cfg, "prefill", variant)
    # prefill keeps the head-mode cache: seq-sharding it during prefill
    # costs one full-KV reshard, which serving pays once per request at
    # the prefill -> decode transition
    cmode = "head"
    p_ps = param_pspecs(params, mesh, policy=policy)
    c_ps = cache_pspecs(cache, mesh, b, mode=cmode)
    args = (params, inputs, cache)
    in_ps = (p_ps, in_extra_ps, c_ps)
    out_ps = (None, c_ps)
    return fn, args, in_ps, out_ps


def decode_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
                n_positions: int = 1, variant: str = "baseline"):
    """serve_step: n_positions new tokens against a cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    max_len = s + n_positions
    swa_ring = (variant == "opt" and cfg.attention is not None
                and cfg.attention.kind == "swa")
    if variant == "opt":
        # sequence-sharded cache needs a tp-divisible buffer
        max_len = round_up(max_len, 256)
    cache = cache_abstract(cfg, b, max_len, swa_ring=swa_ring)
    cache_len = abstract((), torch.int32)
    inputs, in_extra_ps = _extra_inputs(
        cfg, mesh, b, n_positions, abstract((b, n_positions), torch.int32))

    def fn(params, inp, cache, cache_len):
        logits, new_cache, _, _ = forward(params, cfg, _fwd_inputs(inp),
                                          mode="decode", cache=cache,
                                          cache_len=cache_len,
                                          swa_ring=swa_ring)
        return logits, new_cache

    params = params_abstract(cfg)
    policy = cell_policy(cfg, "decode", variant)
    cmode = "seq" if variant == "opt" else "head"
    p_ps = param_pspecs(params, mesh, policy=policy)
    c_ps = cache_pspecs(cache, mesh, b, mode=cmode)
    args = (params, inputs, cache, cache_len)
    in_ps = (p_ps, in_extra_ps, c_ps, P())
    out_ps = (None, c_ps)
    return fn, args, in_ps, out_ps


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               n_micro: int = 4, decode_positions: int = 1,
               variant: str = "baseline"):
    if shape.mode == "train":
        return train_cell(cfg, shape, mesh, n_micro=n_micro,
                          variant=variant)
    if shape.mode == "prefill":
        return prefill_cell(cfg, shape, mesh, variant=variant)
    return decode_cell(cfg, shape, mesh, n_positions=decode_positions,
                       variant=variant)


def output_abstract(cfg: ArchConfig, fn_args, mode: str):
    """The abstract outputs of a cell's ``fn``, without running it: the
    train step returns the params, the optimizer state and four f32
    scalars; prefill the last position's logits and the cache; decode
    every new position's logits and the cache."""
    if mode == "train":
        params, opt, _ = fn_args
        metrics = {k: abstract((), torch.float32)
                   for k in ("loss", "ce", "grad_norm", "lr")}
        return params, opt, metrics
    params, inputs, cache = fn_args[:3]
    lead = (inputs["tokens"].shape[0],) + (
        () if mode == "prefill" else (inputs["tokens"].shape[1],))
    dtype = params["embed"]["table"].dtype
    return abstract((*lead, cfg.vocab_size), dtype), cache


def materialize(tree, pspecs, mesh, device) -> Any:
    """Uninitialised per-device shards of an abstract tree on ``device``
    (``pspecs``: a matching spec tree, ``None`` replicated)."""
    return tree_map(lambda leaf, spec: torch.empty(
        local_shape(leaf.shape, spec, mesh), dtype=leaf.dtype,
        device=device), tree, broadcast_specs(pspecs, tree))


def to_shardings(pspecs, mesh):
    """The reference's name: a spec tree's DTensor placements on a
    ``DeviceMesh`` (a ``None`` leaf: replicated)."""
    return placements_from_pspecs(pspecs, mesh)


def local_abstract(tree, placements, mesh):
    """This rank's shards of an abstract tree as fake tensors, shaped by
    ``placements`` (a matching tree of placement lists) as DTensor shapes
    them."""
    return tree_map(lambda leaf, pl: abstract(
        block_of(tuple(leaf.shape), mesh, pl)[0], leaf.dtype), tree,
        placements)


def _model_dims(c_ps, cache, mesh):
    """Per cache leaf the dim (negative) its spec puts the model axis on,
    or None."""
    _, model = mesh_axes(mesh)

    def dim(spec, leaf):
        for i, entry in enumerate(tuple(spec or ())):
            if model in spec_axes(entry):
                return i - leaf.dim()
        return None
    return tree_map(dim, broadcast_specs(c_ps, cache), cache, is_leaf=is_spec)


def rank_local_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, cell,
                    variant: str = "baseline"):
    """(fn, local args, model-axis size it computes over) of a built
    ``cell`` = (fn, args, in_specs, out_specs) as this rank of ``mesh``
    runs it (see the module docstring).  Every rank of the mesh's process group must call this,
    in the same order (it builds the batch's group)."""
    from repro_torch.dist import layer_gather as lg
    from repro_torch.dist import sharded_train as st
    from repro_torch.dist import tensor_parallel as tp
    fn, args, in_ps, _ = cell
    placements = to_shardings(in_ps, mesh)
    local = local_abstract(args, placements, mesh)
    policy = cell_policy(cfg, shape.mode, variant)
    model = st.model_axis(mesh, policy)
    tp_size = 1 if model is None else model[1]
    p_pl = placements[0]
    if shape.mode == "train":
        o_pl = placements[1]
        layout = st.step_layout(args[0], {"params": p_pl, "opt": o_pl},
                                mesh, cfg, tp_size)
        n_micro, remat = fn.keywords["n_micro"], fn.keywords["remat"]
        tokens = args[2]["tokens"]
        mb = tokens.shape[-2]
        axes, _, blocks = st.batch_split(mesh, mb, policy)
        group = st.axes_group(mesh, axes)
        plan = st.gather_plan(layout, mesh, axes)

        def run(params, opt, rows):
            return st.local_train_step(
                params, opt, rows, cfg=cfg, opt_cfg=fn.keywords["opt_cfg"],
                mesh=mesh, layout=layout, n_micro=n_micro, group=group,
                blocks=blocks, model=model, plan=plan, remat=remat)
        return run, local, tp_size
    layout = st.step_layout(args[0], {"params": p_pl,
                                      "opt": {"master": p_pl}}, mesh, cfg,
                            tp_size)
    dims = _model_dims(in_ps[2], args[2], mesh)
    group = model
    if model is None and any(d is not None for d in leaves(dims)):
        # replicated params (dp_only) over a cache the model axis shards
        _, axis = mesh_axes(mesh)
        group = (mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(
            axis)), mesh.get_local_rank(axis))

    plan = st.gather_plan(layout, mesh)

    def run(params, *rest):
        with lg.gathering(plan, params):
            if group is None:
                return fn(params, *rest)
            with tp.model_group(*group, cache_dims=dims,
                                whole=model is None):
                return fn(params, *rest)
    return run, local, tp_size
