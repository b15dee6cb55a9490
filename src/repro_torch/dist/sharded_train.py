"""Sharded training state and step over a ``DeviceMesh``, tensor-parallel
on the model axis.

The state (params and the AdamW state) is stored as DTensors: each rank
holds its shards under ``param_pspecs`` / ``opt_pspecs(..., mesh)``
(the master, m and v of a replicated param are sharded over the data
axes, ZeRO-2).  A step, on plain local tensors:

  1. runs ``grad_accum_fn`` on this rank's STORAGE shards and its rows of
     every micro-batch of the global batch (rows split as ``batch_pspec``
     splits them: over the data axes, and the model axis too under
     ``dp_only``) under ``tensor_parallel.model_group`` and
     ``layer_gather.gathering(gather_plan(...))``: each layer gathers its
     leaves as it runs (over the data axes that shard them, and over the
     model axis where ``tensor_parallel.tp_plan`` runs the block whole;
     a replicated ``lm_head`` is sliced to this rank's vocabulary
     columns), every rank of a model group computes its heads, ``d_ff``
     columns and vocabulary block of the same rows, and each gradient
     comes back reduce-scattered to its storage shard, so the f32
     accumulator is the size of the shards;
  2. divides the gradients the data axes reduce-scattered by the number
     of ranks that split the batch, and all-reduces the rest as a mean,
     with the loss and the CE (the MoE aux loss reduces its router
     statistics over them in the forward, ``models.moe.batch_group``, so
     it is the aux of the whole micro-batch); then completes the
     gradients over the model group: summed where a rank's heads used a
     whole leaf the model axis does not shard (``PARTIAL``) or its
     vocabulary block of a replicated one (``SLICE``);
  3. runs ``adamw_update`` on this rank's shards in the optimizer state's
     layout, clipping by the global norm: each leaf's squares counted
     once per replica and summed over the mesh.

At world size 1 no plan is entered (it gathers nothing), the mean
divides by 1 and no model group is entered, so a step is bitwise the
unsharded ``train_step`` on
the same state and batch.  ``local_train_step`` is the step on local
tensors (the dry run runs it as one rank of a fake group).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.arch import ArchConfig
from repro_torch.core.tree import (leaves, path_key, tree_map,
                                   tree_map_with_path, unflatten)
from repro_torch.dist import layer_gather as lg
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import (batch_pspec, block_of, mesh_axes,
                                       opt_pspecs,
                                       param_pspecs, placements_from_pspecs,
                                       spec_axes)
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
    rank must call it); for checkpoints and checks, not the step."""
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


# ---------------------------------------------------------------------------
# Layouts on local tensors
# ---------------------------------------------------------------------------

def relayout(t: Tensor, mesh, shape, src, dst) -> Tensor:
    """The local block under placements ``dst`` of a tensor of global
    ``shape`` whose local block under ``src`` is ``t``: a mesh dim that
    ``src`` shards and ``dst`` does not is all-gathered (minor mesh dims
    first, so blocks nest as JAX's), then the result is sliced to
    ``dst``'s block.  ``t`` itself where the two agree."""
    from torch.distributed.tensor import Replicate
    src, dst = list(src), list(dst)
    if src == dst:
        return t
    mid = list(src)
    for i in reversed(range(len(src))):
        if src[i] != dst[i] and src[i].is_shard():
            t = tp.all_gather(t, src[i].dim, mesh.get_group(i), mesh.size(i))
            mid[i] = Replicate()
    if mid == dst:
        return t
    _, m_off = block_of(shape, mesh, mid)
    d_shape, d_off = block_of(shape, mesh, dst)
    return t[tuple(slice(o - m, o - m + n)
                   for o, m, n in zip(d_off, m_off, d_shape))]


@dataclasses.dataclass
class StepLayout:
    """Per param leaf: its global shape, its placements in storage (its
    gradient's too), in the optimizer state and as a layer computes with
    it (``work``: gathered per layer, ``layer_gather``), and its
    ``tensor_parallel`` role."""
    shapes: Any
    params: Any
    opt: Any
    work: Any
    roles: Any


def step_layout(params, placements: Dict, mesh, cfg: ArchConfig,
                tp_size: int) -> StepLayout:
    """The layout of a step on ``params`` (anything with shapes) stored
    under ``placements`` ({"params", "opt"}) with a model group of
    ``tp_size`` ranks (1: no tensor parallelism)."""
    from torch.distributed.tensor import Replicate, Shard
    _, model = mesh_axes(mesh)
    m_at = list(mesh.mesh_dim_names).index(model)

    def role(path, t):
        pl = _at(placements["params"], path)[m_at]
        return tp.leaf_role(cfg, tp_size, path,
                            pl.dim - t.dim() if pl.is_shard() else None)

    roles = tree_map_with_path(role, params)

    def work(t, r):
        out = [Replicate()] * mesh.ndim
        if r.role in (tp.LOCAL, tp.SLICE):
            out[m_at] = Shard(t.dim() + r.dim)
        return out

    return StepLayout(
        shapes=tree_map(lambda t: tuple(t.shape), params),
        params=placements["params"], opt=placements["opt"]["master"],
        work=tree_map(work, params, roles), roles=roles)


_STACKED = (("segments",), ("encoder", "layers"))


def gather_plan(layout: StepLayout, mesh, batch_axes: Tuple[str, ...] = (),
                ) -> Any:
    """The ``layer_gather`` plan of ``layout`` on this rank of ``mesh``:
    per leaf, each mesh dim its storage shards and its ``work`` layout
    does not, minor first (as ``relayout``), then the narrowing to
    ``work``'s block (a sliced ``lm_head``).  A data axis in
    ``batch_axes`` (the axes that split a micro-batch) reduces the
    gradient over its ranks, one outside it takes this rank's block; the
    model axis reduces a ``partial`` leaf's and takes a ``full`` one's.
    None where nothing is gathered (world 1)."""
    from torch.distributed.tensor import Replicate
    _, model = mesh_axes(mesh)
    names = list(mesh.mesh_dim_names)

    def leaf(path, shape, src, dst, r):
        nd = len(shape)
        src, dst = list(src), list(dst)
        steps, mid = [], list(src)
        for i in reversed(range(len(src))):
            if src[i] != dst[i] and src[i].is_shard():
                mid[i] = Replicate()
                if mesh.size(i) == 1:
                    continue
                is_model = names[i] == model
                steps.append(lg.Step(
                    dim=src[i].dim - nd, group=mesh.get_group(i),
                    size=mesh.size(i), rank=mesh.get_local_rank(names[i]),
                    reduce=(r.role == tp.PARTIAL) if is_model
                    else names[i] in batch_axes, model=is_model))
        narrow = ()
        if mid != dst:
            m_shape, m_off = block_of(shape, mesh, mid)
            d_shape, d_off = block_of(shape, mesh, dst)
            narrow = tuple((i - nd, o - m, n) for i, (o, m, n, w) in
                           enumerate(zip(d_off, m_off, d_shape, m_shape))
                           if n != w)
        stacked = any(tuple(path[:len(p)]) == p for p in _STACKED)
        p = lg.LeafPlan(name=path_key(path),
                        local=block_of(shape, mesh, src)[0],
                        steps=tuple(steps), narrow=narrow,
                        whole=stacked and any(s.dim == -nd for s in steps))
        return None if p.trivial else p

    plan = tree_map_with_path(
        lambda path, r: leaf(path, _at(layout.shapes, path),
                             _at(layout.params, path),
                             _at(layout.work, path), r), layout.roles)
    return plan if any(p is not None for p in lg.plan_leaves(plan)) \
        else None


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _complete(g: Tensor, r: tp.Role, p: Optional[lg.LeafPlan], group
              ) -> Tensor:
    """A gradient summed over the model group where this rank's heads
    used a leaf the model axis does not shard (``partial``; a sharded one
    was reduce-scattered in the backward), or where it used its
    vocabulary block of a replicated one (``slice``: the rest of the
    gradient is zeros here)."""
    if r.role == tp.SLICE or (r.role == tp.PARTIAL and not (
            p is not None and p.reduced_over_model())):
        return tp.all_reduce(g, group)
    return g


def _norm(grads, placements, mesh) -> Tensor:
    """The global norm of gradients at their storage layout: each leaf's
    squares counted on the ranks at coordinate 0 of every mesh dim that
    replicates it, then summed over every mesh dim (where no leaf's
    storage is sharded: ``global_norm``, as at world 1)."""
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    coord = mesh.get_coordinate()
    sharded = leaves(tree_map(lambda g, pl: tuple(
        p.is_shard() and n > 1 for p, n in zip(pl, sizes)), grads,
        placements), is_leaf=lambda x: isinstance(x, tuple)
        and all(isinstance(v, bool) for v in x))
    if not any(any(sh) for sh in sharded):
        return global_norm(grads)
    flat = leaves(grads)
    total = torch.zeros((), device=flat[0].device)
    for g, sh in zip(flat, sharded):
        if all(d or c == 0 for d, c in zip(sh, coord)):
            total = total + torch.sum(torch.square(g.float()))
    for i, n in enumerate(sizes):
        if n > 1:
            tp.all_reduce(total, mesh.get_group(i))
    return torch.sqrt(total)


def local_train_step(p_local, o_local, rows: Dict, *, cfg: ArchConfig,
                     opt_cfg: AdamWConfig, mesh, layout: StepLayout,
                     n_micro: int, group, blocks: int, model=None,
                     plan=None, aux_weight: float = 0.01, remat=True,
                     compress: bool = False) -> Dict:
    """One optimizer step on this rank's local shards ``p_local`` /
    ``o_local`` (updated in place) from its pre-split ``rows`` (n_micro,
    rows, ...); returns the metrics.  ``group`` / ``blocks``: the ranks
    that split the batch; ``model``: (group, size, rank) of the model
    axis, or None (no tensor parallelism); ``plan``: ``gather_plan``'s
    (the forward gathers each layer's leaves, and their gradients come
    back at the storage shards' shapes)."""
    m_group, m_size, m_rank = model or (None, 1, 0)
    with tp.model_group(m_group, m_size, m_rank), \
            batch_group(group, blocks), lg.gathering(plan, p_local):
        grads, loss, ce = grad_accum_fn(p_local, cfg, rows, n_micro,
                                        aux_weight, remat, compress)
    plans = (lg.plan_leaves(plan) if plan is not None
             else [None] * len(leaves(grads)))
    if group is not None:
        for g, p in zip(leaves(grads), plans):
            # a leaf the data axes shard was reduce-scattered over them
            if p is not None and p.reduced_over_data():
                g.div_(blocks)
            else:
                _mean(g, group, blocks)
        loss, ce = _mean(loss, group, blocks), _mean(ce, group, blocks)
    if m_size > 1:
        grads = unflatten(grads, [
            _complete(g, r, p, m_group) for g, r, p in
            zip(leaves(grads), leaves(layout.roles), plans)])
    norm = _norm(grads, layout.params, mesh)
    # the update runs in the optimizer state's layout; a param whose
    # master is sharded further (ZeRO-2) is sliced to it and gathered back
    upd = tree_map(lambda t, s, a, b: relayout(t, mesh, s, a, b), p_local,
                   layout.shapes, layout.params, layout.opt)
    g_upd = tree_map(lambda g, s, a, b: relayout(g, mesh, s, a, b), grads,
                     layout.shapes, layout.params, layout.opt)
    del grads
    _, _, om = adamw_update(opt_cfg, upd, g_upd, o_local, norm=norm)

    def write_back(t, u, s, a, b):
        if list(a) != list(b):
            t.copy_(relayout(u, mesh, s, a, b))
    tree_map(write_back, p_local, upd, layout.shapes, layout.opt,
             layout.params)
    return {"loss": loss, "ce": ce, **om}


def sharded_train_step(params, opt_state, batch: Dict, *, cfg: ArchConfig,
                       opt_cfg: AdamWConfig, mesh, layout: StepLayout,
                       n_micro: int, block: int, blocks: int, group,
                       model=None, plan=None, aux_weight: float = 0.01,
                       remat=True, compress: bool = False):
    """One optimizer step on DTensor ``params`` / ``opt_state`` (updated
    in place and returned) from the GLOBAL ``batch`` every rank holds;
    returns them with the metrics {"loss", "ce", "grad_norm", "lr"} (the
    loss and CE means over the global batch; device tensors)."""
    b = batch["tokens"].shape[0]
    if b % n_micro or (b // n_micro) % blocks:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"micro-batches over {blocks} ranks")
    metrics = local_train_step(
        local(params), local(opt_state),
        local_rows(batch, n_micro, block, blocks), cfg=cfg, opt_cfg=opt_cfg,
        mesh=mesh, layout=layout, n_micro=n_micro, group=group,
        blocks=blocks, model=model, plan=plan, aux_weight=aux_weight,
        remat=remat, compress=compress)
    return params, opt_state, metrics


def model_axis(mesh, policy: str):
    """(group, size, rank) of this rank's model axis for ``policy``, or
    None: ``dp_only`` and a model axis of one rank compute whole."""
    _, model = mesh_axes(mesh)
    size = mesh.size(list(mesh.mesh_dim_names).index(model))
    if policy == "dp_only" or size == 1:
        return None
    return mesh.get_group(model), size, mesh.get_local_rank(model)


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh,
                            placements: Dict, global_batch: int,
                            policy: str, n_micro: int = 1, remat=True,
                            compress: bool = False, *,
                            params) -> Callable:
    """``sharded_train_step`` bound to this rank's rows of a
    ``global_batch``-row batch, the group that splits them and the model
    group (built here: every rank must call this, in the same order), for
    ``params`` (the state's, or anything with their shapes)."""
    if global_batch % n_micro:
        raise ValueError(f"global_batch {global_batch} is not divisible by "
                         f"n_micro={n_micro}")
    axes, block, blocks = batch_split(mesh, global_batch // n_micro, policy)
    model = model_axis(mesh, policy)
    layout = step_layout(params, placements, mesh, cfg,
                         1 if model is None else model[1])
    return functools.partial(
        sharded_train_step, cfg=cfg, opt_cfg=opt_cfg, mesh=mesh,
        layout=layout, n_micro=n_micro, block=block, blocks=blocks,
        group=axes_group(mesh, axes), model=model,
        plan=gather_plan(layout, mesh, axes), remat=remat,
        compress=compress)
