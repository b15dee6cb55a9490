"""Hand-rolled AdamW with f32 master weights over bf16 params,
global-norm clipping, and warmup + cosine LR schedules — the reference's
``training/optimizer.py``.

Optimizer state (nested dicts of tensors):
  {"master": f32 params, "m": f32, "v": f32, "step": int32 scalar}
Params keep their dtypes: bf16 weights are re-derived from the f32 master
every update, f32 leaves (``A_log``, the router) stay f32.

The update runs leaf by leaf, IN PLACE, on the device: it never builds a
second f32 tree.  At stablelm_3b's 2.8e9 parameters the state alone is
33.5 GB; a functional update (clipped grads, new m / v / master) would
add 11-34 GB more.  ``step`` and the learning rate stay device tensors,
so an update reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.tree import leaves, leaves_with_paths, path_key, tree_map

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr; ``step`` a
    number or a tensor (the result lives on its device)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio * cfg.lr + (1 - cfg.min_lr_ratio) * cfg.lr * 0.5 \
        * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict:
    """f32 copies of the params (never aliases, f32 leaves included), zero
    moments, and step 0 on the params' device."""
    f32 = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return {"master": f32, "m": tree_map(torch.zeros_like, f32),
            "v": tree_map(torch.zeros_like, f32),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def global_norm(tree) -> Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves(tree)])))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm):
    a new tree (``adamw_update`` scales leaf by leaf instead)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _decay_mask(path_key_str: str) -> bool:
    """No weight decay on norms / biases / scalar SSM params: the
    reference's substring rule over the joined key path.  (The reference
    joins JAX's key reprs, ``['ffn']/['up']``; the separators hold none of
    the letters matched, so the joined names match alike.)"""
    return not any(k in path_key_str for k in ("scale", "bias", "A_log",
                                               "A_logh", "D", "dt_bias"))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state,
                 norm: Optional[Tensor] = None) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, in place: ``params``, ``opt_state`` (master, m, v,
    step) are updated and returned with the metrics {"grad_norm", "lr"}
    (device tensors).  ``grads`` (any float dtype, read only) are cast to
    f32 and clipped leaf by leaf.  ``norm``: the global gradient norm to
    clip by, by default ``global_norm(grads)`` (a sharded update passes
    the norm of the full gradients and its shards of them)."""
    if norm is None:
        norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = opt_state["step"]
    step.add_(1)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    masters = leaves_with_paths(opt_state["master"])
    for (path, mast), p, g, m, v in zip(masters, leaves(params),
                                        leaves(grads),
                                        leaves(opt_state["m"]),
                                        leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if _decay_mask(path_key(path)):
            update.add_(mast, alpha=cfg.weight_decay)
        mast.sub_(update.mul_(lr))
        p.copy_(mast)
    return params, opt_state, {"grad_norm": norm, "lr": lr}
