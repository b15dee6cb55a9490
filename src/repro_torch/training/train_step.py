"""The train step: CE loss + MoE aux, micro-batch gradient accumulation,
fractional remat and optional bf16 gradient compression — the reference's
``training/train_step.py``.

Gradients are taken with ``torch.autograd.grad`` over detached views of
the param leaves: nothing keeps a ``.grad`` on the params between steps.
The micro-batches run one after another (the reference's ``lax.scan``),
each one's gradients added into ONE f32 accumulator and then freed, so
live activation memory is that of one micro-batch.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.arch import ArchConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.transformer import forward
from repro_torch.training.optimizer import AdamWConfig, adamw_update

Tensor = torch.Tensor


def loss_fn(params, cfg: ArchConfig, batch: Dict, aux_weight: float = 0.01,
            remat=True) -> Tuple[Tensor, Dict]:
    """(CE of next-token prediction + aux_weight * MoE aux, {"ce",
    "moe_aux"}).  A VLM's batch carries the stub frontend's ``embeds``, an
    audio model's its ``frames``; the labels are always ``tokens``."""
    fwd_in = {}
    if "embeds" in batch:
        fwd_in["embeds"] = batch["embeds"]
    else:
        fwd_in["tokens"] = batch["tokens"]
    if "frames" in batch:
        fwd_in["frames"] = batch["frames"]
    logits, _, aux, _ = forward(params, cfg, fwd_in, mode="train",
                                remat=remat)
    # under a model group whose plan splits the vocabulary the logits are
    # this rank's block of it
    ce = (tp.vocab_parallel_cross_entropy
          if tp.mode(cfg, "head") == tp.TP else softmax_cross_entropy)(
        logits[:, :-1], batch["tokens"][:, 1:], batch.get("mask"))
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def value_and_grad(fn: Callable, params, *args) -> Tuple[Tuple, Dict]:
    """((value, aux), grads) of ``fn(params, *args) -> (value, aux)``, as
    ``jax.value_and_grad(fn, has_aux=True)``: grads in the params' dtypes
    and structure (zeros for a leaf the value does not reach); value and
    aux detached."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        value, aux = fn(unflatten(params, live), *args)
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    aux = tree_map(torch.Tensor.detach, aux)
    return (value.detach(), aux), unflatten(params, grads)


def _compress(g: Tensor) -> Tensor:
    return g.to(torch.bfloat16)


def compress_grads(grads, enabled: bool):
    """bf16 gradient compression (halves the bytes an all-reduce would
    move), before accumulation.  The leaves stay bf16: the reference's
    round trip ends in a cast to f32, which every consumer here makes per
    leaf (the accumulator, ``adamw_update``) — same values, no f32 tree."""
    if not enabled:
        return grads
    return tree_map(_compress, grads)


def grad_accum_fn(params, cfg: ArchConfig, batch: Dict, n_micro: int,
                  aux_weight: float = 0.01, remat=True,
                  compress: bool = False) -> Tuple[Dict, Tensor, Tensor]:
    """(f32 grads, loss, mean CE) over the global batch as ``n_micro``
    micro-batches: grads = sum over micro-batches of g / n_micro, added
    leaf by leaf into one f32 accumulator.

    batch["tokens"] may be pre-split (n_micro, mb, s); otherwise every
    leaf of the batch is split along its first axis."""
    if batch["tokens"].ndim == 3:
        micro = batch
        if batch["tokens"].shape[0] != n_micro:
            raise ValueError(
                f"pre-split batch has {batch['tokens'].shape[0]} "
                f"microbatches, expected n_micro={n_micro}")
    else:
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(
                f"batch size {b} is not divisible by n_micro={n_micro}")
        mb = b // n_micro
        micro = {k: v.reshape(n_micro, mb, *v.shape[1:])
                 for k, v in batch.items()}
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    ces = []
    for i in range(n_micro):
        (mloss, metrics), grads = value_and_grad(
            loss_fn, params, cfg, {k: v[i] for k, v in micro.items()},
            aux_weight, remat)
        for a, g in zip(leaves(acc), leaves(grads)):
            a.add_((_compress(g) if compress else g).float() / n_micro)
        del grads
        loss = loss + mloss / n_micro
        ces.append(metrics["ce"])
    return acc, loss, torch.mean(torch.stack(ces))


def train_step(params, opt_state, batch: Dict, *, cfg: ArchConfig,
               opt_cfg: AdamWConfig, n_micro: int = 1,
               aux_weight: float = 0.01, remat=True,
               compress: bool = False) -> Tuple[Dict, Dict, Dict]:
    """One optimizer step.  ``params`` and ``opt_state`` are updated in
    place and returned with the metrics {"loss", "ce", "grad_norm", "lr"}
    (device tensors: nothing is read back)."""
    if n_micro > 1:
        grads, loss, ce = grad_accum_fn(params, cfg, batch, n_micro,
                                        aux_weight, remat, compress)
    else:
        # the bf16 grads go to the update as they are: it casts each leaf
        # to f32 itself, so no f32 copy of the tree is made
        (loss, metrics), grads = value_and_grad(loss_fn, params, cfg, batch,
                                                aux_weight, remat)
        grads = compress_grads(grads, compress)
        ce = metrics["ce"]
    params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
    return params, opt_state, {"loss": loss, "ce": ce, **om}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    remat=True, compress: bool = False) -> Callable:
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             n_micro=n_micro, remat=remat, compress=compress)
