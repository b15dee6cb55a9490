"""Sharded training state and step over a ``DeviceMesh``.

The state (params and the AdamW state) is stored as DTensors: each rank
holds its shards under ``param_pspecs`` / ``opt_pspecs(..., mesh)``
(the master, m and v of a replicated param are sharded over the data
axes, ZeRO-2).  A step:

  1. gathers the full params (``full_tensor``: an all-gather per sharded
     leaf);
  2. runs ``grad_accum_fn`` on this rank's rows of every micro-batch of
     the global batch (rows split as ``batch_pspec`` splits them: over the
     data axes, and the model axis too under ``dp_only``);
  3. all-reduces the f32 gradients, the loss and the CE over the ranks
     that split the batch, as a mean (the MoE aux loss reduces its router
     statistics over them in the forward, ``models.moe.batch_group``, so
     it is the aux of the whole micro-batch);
  4. runs ``adamw_update`` on this rank's shards, clipping by the global
     norm of the full gradients.

Compute on the model axis is NOT tensor-parallel: the model axis shards
storage only, and every rank runs the whole model on its rows.  At world
size 1 the gather is a copy and the mean divides by 1, so a step is
bitwise the unsharded ``train_step`` on the same state and batch.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.arch import ArchConfig
from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist.sharding import (batch_pspec, opt_pspecs,
                                       param_pspecs, placements_from_pspecs,
                                       shard_tensor, spec_axes)
from repro_torch.models.moe import batch_group
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm)
from repro_torch.training.train_step import grad_accum_fn

Tensor = torch.Tensor


def state_placements(state: Dict, mesh, policy: str) -> Dict:
    """{"params", "opt"}: the placements tree of a full (unsharded) state
    under ``policy`` on ``mesh``."""
    p_ps = param_pspecs(state["params"], mesh, policy=policy)
    o_ps = opt_pspecs(state["opt"], p_ps, mesh)
    return {"params": placements_from_pspecs(p_ps, mesh),
            "opt": placements_from_pspecs(o_ps, mesh)}


def gather(tree):
    """The full tensors of a DTensor tree (a collective per leaf: every
    rank must call it)."""
    return tree_map(lambda t: t.full_tensor(), tree)


def local(tree):
    """The local shards of a DTensor tree (views: writing them writes the
    DTensors)."""
    return tree_map(lambda t: t.to_local(), tree)


def _coordinate(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates
    off ``axes`` (every rank must call it, in the same order); None for
    no axes."""
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(*rest, *keep).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in keep))
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return group


def batch_split(mesh, micro_batch: int, policy: str):
    """(axes, block, blocks): the mesh axes that split a micro-batch's
    rows, this rank's block of them (major to minor, JAX's order) and the
    number of blocks."""
    axes = spec_axes(batch_pspec(mesh, micro_batch,
                                 include_model=policy == "dp_only")[0])
    coord = _coordinate(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    block, blocks = 0, 1
    for a in axes:
        block = block * sizes[a] + coord[a]
        blocks *= sizes[a]
    return axes, block, blocks


def local_rows(batch: Dict, n_micro: int, block: int, blocks: int) -> Dict:
    """This rank's rows of every micro-batch of the global batch, pre-split
    (n_micro, rows, ...): micro-batch i is rows [i*mb, (i+1)*mb) of the
    global batch, and this rank takes block ``block`` of its mb rows."""
    out = {}
    for k, v in batch.items():
        mb = v.shape[0] // n_micro
        rows = mb // blocks
        out[k] = v.reshape(n_micro, mb, *v.shape[1:])[
            :, block * rows:(block + 1) * rows]
    return out


def _mean(t: Tensor, group, size: int) -> Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(size)


def _to_layout(dt, placements):
    """``dt`` (a DTensor) under ``placements``: itself when they agree."""
    if list(dt.placements) == list(placements):
        return dt
    return dt.redistribute(placements=placements)


def sharded_train_step(params, opt_state, batch: Dict, *, cfg: ArchConfig,
                       opt_cfg: AdamWConfig, mesh, placements: Dict,
                       n_micro: int, block: int, blocks: int, group,
                       aux_weight: float = 0.01, remat=True,
                       compress: bool = False):
    """One optimizer step on DTensor ``params`` / ``opt_state`` (updated
    in place and returned) from the GLOBAL ``batch`` every rank holds;
    returns them with the metrics {"loss", "ce", "grad_norm", "lr"} (the
    loss and CE means over the global batch; device tensors)."""
    b = batch["tokens"].shape[0]
    if b % n_micro or (b // n_micro) % blocks:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"micro-batches over {blocks} ranks")
    full = gather(params)
    with batch_group(group, blocks):
        grads, loss, ce = grad_accum_fn(
            full, cfg, local_rows(batch, n_micro, block, blocks), n_micro,
            aux_weight, remat, compress)
    del full
    if group is not None:
        for g in leaves(grads):
            _mean(g, group, blocks)
        loss, ce = _mean(loss, group, blocks), _mean(ce, group, blocks)
    norm = global_norm(grads)
    # the update runs in the optimizer state's layout; a param whose
    # master is sharded further (ZeRO-2) is sliced to it and gathered back
    o_pl = placements["opt"]["master"]
    p_work = tree_map(_to_layout, params, o_pl)
    g_local = tree_map(lambda g, pl: shard_tensor(g, mesh, pl).to_local(),
                       grads, o_pl)
    del grads
    _, _, om = adamw_update(opt_cfg, local(p_work), g_local,
                            local(opt_state), norm=norm)
    params = tree_map(_to_layout, p_work, placements["params"])
    return params, opt_state, {"loss": loss, "ce": ce, **om}


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh,
                            placements: Dict, global_batch: int,
                            policy: str, n_micro: int = 1, remat=True,
                            compress: bool = False) -> Callable:
    """``sharded_train_step`` bound to this rank's rows of a
    ``global_batch``-row batch and the group that splits them (built here:
    every rank must call this, in the same order)."""
    if global_batch % n_micro:
        raise ValueError(f"global_batch {global_batch} is not divisible by "
                         f"n_micro={n_micro}")
    axes, block, blocks = batch_split(mesh, global_batch // n_micro, policy)
    return functools.partial(
        sharded_train_step, cfg=cfg, opt_cfg=opt_cfg, mesh=mesh,
        placements=placements, n_micro=n_micro, block=block, blocks=blocks,
        group=axes_group(mesh, axes), remat=remat, compress=compress)

