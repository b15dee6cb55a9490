"""Parameters gathered one layer at a time, as GSPMD gathers them inside
the reference's ``lax.scan`` over stacked layers.

A sharded step (``dist.sharded_train``) and the dry run's cells
(``launch.specs.rank_local_cell``) hand ``forward`` each rank's STORAGE
shards.  ``gather_plan`` says per leaf which mesh dims gather it for
compute: the data axes that shard it (minor mesh dims first, so blocks
nest as JAX's), and the model axis where the leaf is used whole
(``tensor_parallel``'s ``full`` / ``partial`` roles of a leaf the model
axis shards); a replicated ``lm_head`` is then narrowed to this rank's
vocabulary block.  ``gathering(plan, params)`` enters it, and the layer
loops of ``models.transformer`` gather each layer's leaves as they run it
(``gathered``), through one autograd function:

  forward   ``all_gather`` of the layer's local slice into the whole leaf;
  backward  over each gathered mesh dim, last gathered first: a
            reduce-scatter (sum) where the ranks along it computed
            different gradients (a data axis that splits the batch, the
            model axis of a ``partial`` leaf), else this rank's block of
            the gradient every rank there computed alike.

So each leaf's gradient lands at its storage shape.  A gathered leaf
lives only while its layer runs: under remat the layer is recomputed,
gathers included; without, ``saving()`` packs every tensor autograd saves
that is (a view of) a gathered leaf as its local slice and gathers it
again when the backward unpacks it.  Leaves outside the layers (the
embedding, the final norm, ``lm_head``, the hybrid models' shared block,
the encoder's final norm) are gathered where they are used.  A stacked
leaf whose data shard falls on the layer dim is gathered whole once per
forward (``stacks``).

Nothing raises inside a layer: ``gathering`` checks every leaf's shape
against the plan before the forward (an exception under checkpoint's
saved-tensor hooks aborts the process).  Outside ``gathering``, or for a
plan that gathers nothing (world 1), the model code runs as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist import tensor_parallel as tp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Step:
    """One mesh dim a leaf is gathered over: the tensor dim (negative, so a
    layer's view of a stacked leaf reads it too), the dim's group, size
    and this rank's index on it, and how the gradient comes back."""
    dim: int
    group: Any
    size: int
    rank: int
    reduce: bool          # sum over the dim's ranks (else take the block)
    model: bool = False   # the model axis (else a data axis)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one param leaf is gathered: ``steps`` in order, then
    ``narrow`` ((dim, start, length), negative dims), from a local shard
    of shape ``local`` (the stacked leaf's)."""
    name: str
    local: Tuple[int, ...]
    steps: Tuple[Step, ...]
    narrow: Tuple[Tuple[int, int, int], ...] = ()
    whole: bool = False   # stacked, data-sharded on the layer dim

    @property
    def trivial(self) -> bool:
        return not self.steps and not self.narrow

    def reduced_over_data(self) -> bool:
        return any(s.reduce and not s.model for s in self.steps)

    def reduced_over_model(self) -> bool:
        return any(s.reduce and s.model for s in self.steps)


def _is_plan(x) -> bool:
    return x is None or isinstance(x, LeafPlan)


def plan_leaves(plan) -> list:
    """The ``LeafPlan`` (or None) of every param leaf, in leaf order."""
    return leaves(plan, is_leaf=_is_plan)


# ---------------------------------------------------------------------------
# The gather and its transpose
# ---------------------------------------------------------------------------

def _gather(t: Tensor, steps) -> Tensor:
    for s in steps:
        t = tp.all_gather(t, s.dim, s.group, s.size)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, steps):
        ctx.steps = steps
        return _gather(t, steps)

    @staticmethod
    def backward(ctx, g):
        for s in reversed(ctx.steps):
            if s.reduce:
                g = tp.reduce_scatter(g, s.dim, s.group, s.size)
            else:
                n = g.shape[s.dim] // s.size
                g = g.narrow(s.dim, s.rank * n, n).clone()
        return g, None


# live gathered leaves: id -> (weakref, local slice, steps), for ``saving``
_LIVE: Dict[int, Tuple[Any, Tensor, Tuple[Step, ...]]] = {}
_BYTES = {"live": 0, "peak": 0}


def _untrack(key: int, nbytes: int) -> None:
    _LIVE.pop(key, None)
    _BYTES["live"] -= nbytes


def _track(full: Tensor, local: Tensor, steps) -> Tensor:
    nbytes = full.numel() * full.element_size()
    _BYTES["live"] += nbytes
    _BYTES["peak"] = max(_BYTES["peak"], _BYTES["live"])
    _LIVE[id(full)] = (weakref.ref(full), local, steps)
    weakref.finalize(full, _untrack, id(full), nbytes)
    return full


def gathered_bytes() -> Dict[str, int]:
    """{"live", "peak"}: the bytes of gathered leaves alive now, and the
    most alive at once since ``reset_peak``."""
    return dict(_BYTES)


def reset_peak() -> None:
    _BYTES["peak"] = _BYTES["live"]


def gather_leaf(t: Tensor, p: Optional[LeafPlan]) -> Tensor:
    """``t`` (a local shard, or a layer's view of one) as compute reads
    it, under ``p``."""
    if p is None or p.trivial:
        return t
    if p.steps:
        t = _track(_Gather.apply(t, p.steps), t, p.steps)
    for dim, start, length in p.narrow:
        t = t.narrow(dim, start, length)
    return t


def gather(tree, plan):
    """A param (sub)tree gathered leaf by leaf under the matching ``plan``
    subtree (``None``: as it is)."""
    if plan is None:
        return tree
    return tree_map(lambda t, p: gather_leaf(t, p), tree, plan,
                    is_leaf=lambda x: isinstance(x, Tensor))


@dataclasses.dataclass(frozen=True)
class _Packed:
    local: Tensor
    steps: Tuple[Step, ...]
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


def _pack(t: Tensor):
    base = t if t._base is None else t._base
    entry = _LIVE.get(id(base))
    if entry is None or entry[0]() is not base:
        return t
    return _Packed(entry[1].detach(), entry[2], tuple(t.shape), t.stride(),
                   t.storage_offset())


def _unpack(p):
    if not isinstance(p, _Packed):
        return p
    with torch.no_grad():
        full = _track(_gather(p.local, p.steps), p.local, p.steps)
    return full.as_strided(p.size, p.stride, p.offset)


def saving():
    """A context in which autograd saves a gathered leaf (or a view of
    one) as its local slice and gathers it again for the backward."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def gathered(fn: Callable, plans) -> Callable:
    """``fn`` with its leading arguments gathered under ``plans`` (one
    subtree or ``None`` each) first: inside ``fn``, so a checkpointed
    layer gathers again when it is recomputed."""
    def run(*args):
        head = [gather(a, p) for a, p in zip(args, plans)]
        return fn(*head, *args[len(plans):])
    return run


def stacks(tree, plan):
    """(``tree`` with its ``whole`` leaves gathered over the layer dim,
    the plan of each layer's view): a stacked leaf whose data shard falls
    on the layer dim is gathered whole, once."""
    if plan is None:
        return tree, None
    out = tree_map(lambda t, p: gather_leaf(t, p) if p is not None
                   and p.whole else t, tree, plan,
                   is_leaf=lambda x: isinstance(x, Tensor))
    return out, tree_map(lambda p: None if p is None or p.whole else p,
                         plan, is_leaf=_is_plan)


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------

_PLAN: Optional[Dict] = None


def current() -> Optional[Dict]:
    """The plan tree (shaped like the params) being gathered under, or
    None."""
    return _PLAN


def _check_leaf(shape: Tuple[int, ...], p: Optional[LeafPlan]) -> None:
    if p is not None and shape != p.local:
        raise ValueError(f"{p.name}: local shape {shape}, the plan "
                         f"gathers a {p.local} shard")


def check(plan, params) -> None:
    """Raise unless every leaf of ``params`` has its plan's local shape."""
    shapes = tree_map(lambda t: tuple(t.shape), params)
    tree_map(_check_leaf, shapes, plan,
             is_leaf=lambda x: isinstance(x, tuple))


@contextlib.contextmanager
def gathering(plan, params):
    """Inside, ``forward`` gathers ``params`` (this rank's storage shards)
    per layer under ``plan``; a no-op for ``plan`` None."""
    global _PLAN
    if plan is not None:
        check(plan, params)
    prev, _PLAN = _PLAN, plan
    try:
        yield
    finally:
        _PLAN = prev


def sub(*keys):
    """The current plan's subtree at ``keys`` (None outside
    ``gathering``)."""
    node = _PLAN
    for k in keys:
        if node is None:
            return None
        node = node[k]
    return node
