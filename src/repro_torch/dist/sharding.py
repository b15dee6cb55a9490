"""Sharding rules: PartitionSpecs for params / optimizer / batch / cache,
and their DTensor placements — the reference's ``dist/sharding.py``.

One rule table serves the trainer and the dry run.  Everything is
divisibility-checked against the actual leaf shapes and the actual mesh,
falling back to replication: a rule that does not divide evenly is
silently weaker, never an uneven shard.

Policies (``param_pspecs``):
  fsdp     2D: tensor-parallel over the ``model`` axis by role, plus a
           ZeRO-3-style shard of a remaining dim over the data axes.
  auto     alias of fsdp.
  tp_only  tensor-parallel only; weights replicated across data axes.
  dp_only  fully replicated params (pure data parallelism).

The rules take any mesh with ``axis_names`` and a name -> size ``shape``
(as the reference tests' duck-typed mesh) or a ``torch.distributed``
``DeviceMesh`` (read through ``rule_mesh``), so they need no process
group.  A spec is the port's ``PartitionSpec``: a tuple
with one entry per tensor dim, each ``None``, an axis name, or a tuple of
names (major to minor, in mesh order).  ``placements_from_pspecs`` turns
a spec into DTensor placements, one per mesh dim.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple, Union

import torch

from repro_torch.core.tree import (leaves_with_paths, tree_map,
                                   tree_map_with_path)

Axes = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names sharding that dim together (major to minor).
    ``P()`` is a fully replicated spec of any rank."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(d) for d in self) + ")"


P = PartitionSpec


def is_spec(x) -> bool:
    """A leaf of a spec tree: a spec, or ``None`` (replicated)."""
    return isinstance(x, PartitionSpec) or x is None


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# ===========================================================================
# Mesh introspection
# ===========================================================================

class _MeshView:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))


def rule_mesh(mesh):
    """``mesh`` as the rules read it (``axis_names``, name -> size
    ``shape``): a ``DeviceMesh`` is adapted, anything else passes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return _MeshView(names, tuple(mesh.shape))
    return mesh


def mesh_axes(mesh) -> Tuple[Axes, str]:
    """(fsdp_axes, model_axis): the data-parallel axes (a single name or a
    tuple — e.g. ("pod", "data") on the multi-pod mesh) and the
    tensor/expert-parallel axis."""
    names = tuple(rule_mesh(mesh).axis_names)
    model = "model" if "model" in names else names[-1]
    dp = tuple(a for a in names if a != model)
    if len(dp) == 1:
        return dp[0], model
    return dp, model


def _dp_tuple(mesh) -> Tuple[str, ...]:
    dp, _ = mesh_axes(mesh)
    return dp if isinstance(dp, tuple) else (dp,)


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return int(math.prod(rule_mesh(mesh).shape[a] for a in axes))


# ===========================================================================
# Batch
# ===========================================================================

def batch_pspec(mesh, batch: int, include_model: bool = False) -> P:
    """Pspec for a (batch, seq) input: batch sharded over as many
    data axes as divide it (plus the model axis for dp_only training,
    where the whole fleet is one big data-parallel group)."""
    shape = rule_mesh(mesh).shape
    cand = list(_dp_tuple(mesh))
    if include_model:
        cand.append(mesh_axes(mesh)[1])
    used = []
    size = 1
    for a in cand:
        if batch % (size * shape[a]) == 0:
            used.append(a)
            size *= shape[a]
    if not used:
        return P(None, None)
    return P(tuple(used) if len(used) > 1 else used[0], None)


# ===========================================================================
# Params
# ===========================================================================

# role -> which dim (negative, so stacked-layer leading dims are
# transparent) is tensor-parallel.  Output-projection weights shard the
# contracting (input) dim so the row-parallel matmul finishes with one
# reduction, matching the Megatron column/row pairing.
_TP_LAST = ("wq", "wk", "wv", "w_up", "w_gate", "wq_b", "wkv_b",
            "shared_up", "lm_head", "in_proj", "up", "gate")
_TP_PENULT = ("wo", "w_down", "shared_down", "out_proj", "down")
_TP_DIM0 = ("table",)        # embedding: the vocab dim (``_tp_dim`` matches it)
_REPLICATED = ("scale", "bias", "router", "A_log", "A_logh", "D", "dt_bias",
               "q_norm", "kv_norm", "conv")


def leaf_name(path) -> str:
    """The reference's ``jax.tree_util.keystr(path).lower()`` of a port
    path (a str per dict key, an int per sequence index):
    ``['segments'][0]['attn']['wq']``."""
    return "".join(f"[{p!r}]" for p in path).lower()


def _tp_dim(name: str, ndim: int) -> Optional[int]:
    last = name.rsplit("'", 2)
    leaf = last[-2] if len(last) >= 2 else name
    if any(r in leaf for r in _REPLICATED):
        return None
    if any(leaf.endswith(r) or r in leaf for r in _TP_PENULT):
        return ndim - 2 if ndim >= 2 else None
    if any(leaf.endswith(r) or r in leaf for r in _TP_LAST):
        return ndim - 1
    if "table" in leaf and ndim >= 2:
        return ndim - 2                       # (V, d) / (L, V, d): vocab dim
    return None


def param_pspecs(params, mesh, policy: str = "fsdp"):
    """Tree of PartitionSpecs matching ``params`` (tensors, fake tensors
    or anything with a ``shape``)."""
    if policy not in ("fsdp", "auto", "tp_only", "dp_only"):
        raise ValueError(f"unknown sharding policy {policy!r}")
    mshape = rule_mesh(mesh).shape
    dp = _dp_tuple(mesh)
    dp_size = _axes_size(mesh, dp)
    _, model = mesh_axes(mesh)
    model_size = mshape[model]

    def leaf_spec(name, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim == 0 or policy == "dp_only":
            return P()
        dims: list = [None] * ndim
        td = _tp_dim(name, ndim)
        if td is not None and shape[td] % model_size == 0 and model_size > 1:
            dims[td] = model
        if policy in ("fsdp", "auto") and dp_size > 1:
            # ZeRO-style: shard the largest still-free dim over data axes
            free = [i for i in range(ndim)
                    if dims[i] is None and shape[i] % dp_size == 0]
            if free:
                big = max(free, key=lambda i: shape[i])
                if shape[big] >= dp_size:
                    dims[big] = dp if len(dp) > 1 else dp[0]
        return P(*dims)

    return tree_map_with_path(
        lambda path, leaf: leaf_spec(leaf_name(path), leaf), params)


# ===========================================================================
# Optimizer
# ===========================================================================

def opt_pspecs(opt, param_ps, mesh=None):
    """Optimizer-state pspecs: master/m/v mirror the param layout; the
    step counter is replicated.  With ``mesh`` given, leaves that ended
    up replicated are additionally sharded over the data axes (ZeRO-2:
    optimizer memory scales down even where params stay replicated)."""
    def upgrade(ps, leaf):
        if ps is None:
            ps = P()
        if any(d is not None for d in ps):
            return ps
        dp = _dp_tuple(mesh)
        dp_size = _axes_size(mesh, dp)
        if dp_size <= 1:
            return ps
        shape = tuple(leaf.shape)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % dp_size == 0 and shape[i] >= dp_size:
                dims = [None] * len(shape)
                dims[i] = dp if len(dp) > 1 else dp[0]
                return P(*dims)
        return ps

    out = {}
    for key in ("master", "m", "v"):
        if mesh is not None:
            out[key] = tree_map(upgrade, param_ps, opt[key], is_leaf=is_spec)
        else:
            out[key] = param_ps
    out["step"] = P()
    return out


# ===========================================================================
# Decode cache
# ===========================================================================

def cache_pspecs(cache, mesh, batch: int, mode: str = "head"):
    """Pspecs for the pre-allocated decode cache.

    Leaves are stacked per layer: KV caches are (L, b, s, kv_heads, dh),
    MLA latents (L, b, s, r), SSM states (L, b, ...).  The batch dim is
    sharded over the data axes; ``mode`` picks where the model axis goes:

      head  KV-head (or feature) sharding — no resharding against the
            per-layer TP attention math; the production serving default.
      seq   sequence sharding — balances long-context cache memory at
            the cost of one gather per step.
    """
    if mode not in ("head", "seq"):
        raise ValueError(f"unknown cache mode {mode!r}")
    mshape = rule_mesh(mesh).shape
    dp = _dp_tuple(mesh)
    dp_size = _axes_size(mesh, dp)
    _, model = mesh_axes(mesh)
    model_size = mshape[model]
    bdim = dp if len(dp) > 1 else dp[0]

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim < 2:
            return P()
        # locate the batch dim (dim 0 of unstacked leaves, dim 1 stacked)
        b_at = next((i for i in (1, 0) if i < ndim and shape[i] == batch),
                    None)
        dims: list = [None] * ndim
        if (b_at is not None and dp_size > 1
                and shape[b_at] % dp_size == 0):
            dims[b_at] = bdim
        if model_size > 1 and b_at is not None:
            if mode == "seq" and b_at + 1 < ndim and \
                    shape[b_at + 1] % model_size == 0:
                dims[b_at + 1] = model
            elif mode == "head":
                # prefer the heads dim (b+2); fall back to the last dim
                for i in (b_at + 2, ndim - 1):
                    if i < ndim and i != b_at and dims[i] is None \
                            and i != b_at + 1 and \
                            shape[i] % model_size == 0:
                        dims[i] = model
                        break
        return P(*dims)

    return tree_map(leaf_spec, cache)


# ===========================================================================
# Shards: shapes, bytes, placements
# ===========================================================================

def check_spec(spec, shape, mesh) -> None:
    """Raise unless ``spec`` fits ``shape`` on ``mesh``: no more entries
    than dims, known axes, no axis used twice, every sharded dim
    divisible by the product of its axes' sizes (the rules never shard
    unevenly)."""
    spec = P() if spec is None else spec
    mshape = rule_mesh(mesh).shape
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than shape "
                         f"{tuple(shape)}")
    seen: List[str] = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes(entry)
        for a in axes:
            if a not in mshape:
                raise ValueError(f"spec {spec!r}: no mesh axis {a!r}")
            if a in seen:
                raise ValueError(f"spec {spec!r} uses axis {a!r} twice")
            seen.append(a)
        n = math.prod(mshape[a] for a in axes)
        if dim % n:
            raise ValueError(f"spec {spec!r}: dim {dim} of {tuple(shape)} "
                             f"does not divide over {axes} ({n})")


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` leaf under ``spec``: each dim
    divided by the product of its axes' sizes."""
    check_spec(spec, shape, mesh)
    mshape = rule_mesh(mesh).shape
    spec = P() if spec is None else spec
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] //= math.prod(mshape[a] for a in spec_axes(entry))
    return tuple(int(d) for d in out)


def shard_bytes(tree, pspecs, mesh) -> int:
    """Per-device bytes of ``tree`` (leaves with ``shape`` and ``dtype``)
    under ``pspecs`` (a matching spec tree; ``None`` anywhere means
    replicated, as jit reads an output spec of ``None``)."""
    specs = [s for _, s in leaves_with_paths(
        broadcast_specs(pspecs, tree), (), is_spec)]
    return int(sum(math.prod(local_shape(leaf.shape, spec, mesh))
                   * leaf.dtype.itemsize
                   for (_, leaf), spec in zip(leaves_with_paths(tree),
                                              specs)))


def broadcast_specs(pspecs, tree):
    """A spec tree with ``tree``'s structure: a ``None`` or spec standing
    for a whole subtree is repeated over its leaves."""
    if is_spec(pspecs):
        return tree_map(lambda _: pspecs, tree)
    if isinstance(pspecs, dict):
        return {k: broadcast_specs(pspecs[k], v) for k, v in tree.items()}
    return type(tree)(broadcast_specs(s, v) for s, v in zip(pspecs, tree))


def placements_for(spec, mesh) -> list:
    """DTensor placements of one spec on a ``DeviceMesh`` (one per mesh
    dim): ``Shard(d)`` where the mesh dim's axis shards tensor dim d,
    else ``Replicate()``.  Where several axes shard one dim, DTensor
    splits in mesh-dim order, major to minor; the spec's tuple must list
    them in that order, so the blocks are JAX's."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    spec = P() if spec is None else spec
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in order:
            out[i] = Shard(d)
    return out


def placements_from_pspecs(pspecs, mesh):
    """Tree of DTensor placement lists from a tree of PartitionSpecs on a
    ``DeviceMesh`` (``None`` leaves become fully replicated, as jit's
    convention) — the reference's ``shardings_from_pspecs``."""
    return tree_map(lambda s: placements_for(s, mesh), pspecs,
                    is_leaf=is_spec)


def block_of(shape, mesh, placements) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a ``shape``
    tensor under ``placements`` on a ``DeviceMesh``: each sharding mesh
    dim, in mesh order, splits the block its predecessors left (major to
    minor, as DTensor and JAX nest them).  Plain integers, so it runs
    under a fake mode too; the rules only ever shard evenly."""
    out, off = list(shape), [0] * len(shape)
    for i, (p, c) in enumerate(zip(placements, mesh.get_coordinate())):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} ({n})")
            out[d] //= n
            off[d] += c * out[d]
    return tuple(out), tuple(off)


def shardings_from_pspecs(pspecs, mesh):
    """The reference's name for ``placements_from_pspecs``."""
    return placements_from_pspecs(pspecs, mesh)


def shard_tensor(full: torch.Tensor, mesh, placements):
    """This rank's block of ``full`` as a DTensor on ``mesh``: sliced
    locally, no communication (every rank holds ``full``).  A proper
    block is a copy, so that ``full``'s storage can be freed; a block
    that is all of ``full`` is ``full`` itself."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    full = full.contiguous()
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, placements)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if local.numel() < full.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def shard_tree(tree, placements, mesh) -> Any:
    """``shard_tensor`` over a tree and its matching placements tree."""
    return tree_map(lambda t, pl: shard_tensor(t, mesh, pl), tree,
                    placements)
