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
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.core.arch import ArchConfig, ShapeSpec
from repro_torch.core.granularity import round_up
from repro_torch.core.tree import tree_map
from repro_torch.dist.sharding import (P, batch_pspec, broadcast_specs,
                                       cache_pspecs, local_shape, opt_pspecs,
                                       param_pspecs)
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
    policy = _opt_policy(cfg) if variant == "opt" else "fsdp"
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
    # dp_only is a TRAIN mapping (grads all-reduce once); prefill takes the
    # auto (tp/fsdp) policy
    policy = (("auto" if _opt_policy(cfg) == "dp_only" else _opt_policy(cfg))
              if variant == "opt" else "fsdp")
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
    policy = _opt_policy(cfg) if variant == "opt" else "fsdp"
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
