"""Tensor parallelism over the ``model`` axis: Megatron's conjugate
operations on plain local tensors, the vocab-parallel embedding, logits
and cross-entropy, and the plan that says which blocks run on their
model-axis shards.

The reference's sharded step is one ``jax.jit`` whose inputs carry the
``param_pspecs`` shardings, and GSPMD partitions the compute: each device
multiplies its column-parallel shards (``wq``/``wk``/``wv``, ``up``/``gate``,
the experts' ``w_up``/``w_gate``) and its row-parallel ones (``wo``,
``down``, ``w_down``) and one reduction finishes each block.  The port
writes that partition out by hand:

  ``copy_to_model``      identity forward, gradient all-reduced over the
                         model group: the input of a column-parallel block;
  ``reduce_from_model``  output all-reduced forward, identity backward: the
                         output of a row-parallel block.

``model_group(group, size, rank)`` switches them on; outside it every
operation here is the identity and the model code runs as before.  Inside
it the model code (``models.transformer``) calls each block's unchanged
body with a LOCAL spec (heads, kv heads or ``d_ff`` divided by the group's
size) on the local shards, between the two operations.  Only
``torch.distributed``'s ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` are used (gloo takes all three on CUDA
tensors), on local tensors: no DTensor inside the forward, so the
attention caches' in-place writes stay legal.

``tp_plan(cfg, tp)`` decides, block by block, how a block runs:

  tp              its model-sharded leaves split on head or channel
                  boundaries: GQA whose q and kv heads divide, MLA whose
                  heads divide (its low-rank ``wq_a`` / ``wkv_a`` and
                  their norms are used whole), FFNs and experts whose
                  ``d_ff`` divides, the vocabulary when it divides;
  tp_kv_gathered  GQA whose q heads divide but kv heads do not, with each
                  rank's q heads inside one kv group: ``wk`` / ``wv`` are
                  used whole and each rank takes the kv head its q heads
                  read;
  gathered        anything else (every SSM block: Mamba's projections do
                  not split on its segments): the block runs whole, on
                  every rank of the model group.

``leaf_role`` turns the plan into what the step does with each leaf:
keep its local shard, gather it whole, or slice a replicated leaf; and
how its gradient comes back (``dist.sharded_train``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.arch import (LAYER_ATTN, AttentionSpec, ArchConfig,
                                   FFNSpec)
from repro_torch.kernels.decode_attention.ops import row_lens

Tensor = torch.Tensor

TP, TP_KV, GATHERED = "tp", "tp_kv_gathered", "gathered"

# leaf roles (``leaf_role``)
LOCAL = "local"        # this rank's model shard; gradient local
FULL = "full"          # whole on every model rank, used alike by each
PARTIAL = "partial"    # whole on every model rank, used by this rank's
                       # heads only: gradient summed over the group
SLICE = "slice"        # replicated in storage, sliced to this rank's
                       # block for compute: gradient (zeros off the
                       # block) summed over the group


@dataclasses.dataclass(frozen=True)
class Role:
    """A param leaf's role and its dim (LOCAL, SLICE; negative) or None."""
    role: str
    dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    group: object
    size: int
    rank: int
    cache_dims: object = None     # {"segments": [...]}: model dim per cache leaf
    whole: bool = False           # every block runs whole (replicated params)


_MODEL: Optional[ModelGroup] = None


@contextlib.contextmanager
def model_group(group, size: int, rank: int, cache_dims=None,
                whole: bool = False):
    """Inside, the model code computes on this rank's model-axis shards
    (``tp_plan``), and every rank of ``group`` must run the same forward
    and backward.  ``cache_dims``: a tree shaped like the decode cache
    whose leaves give the dim the model axis shards (negative, so a
    layer's view reads it too) or None; a cache leaf not laid out as its
    block reads it is gathered once per layer, and only the positions
    the forward wrote are exchanged afterwards.  ``whole``: the params are
    replicated over the group and every block runs whole (``gathered``),
    only the cache being sharded over it.  A no-op for ``group`` None or
    ``size`` 1."""
    global _MODEL
    prev, _MODEL = _MODEL, (None if group is None or size == 1
                            else ModelGroup(group, size, rank, cache_dims,
                                            whole))
    try:
        yield
    finally:
        _MODEL = prev


def current() -> Optional[ModelGroup]:
    return _MODEL


# ===========================================================================
# The plan
# ===========================================================================

def attention_mode(a: AttentionSpec, tp: int) -> str:
    if a.n_heads % tp:
        return GATHERED
    if a.kind == "mla" or a.n_kv_heads % tp == 0:
        return TP
    per = a.n_heads // tp
    return TP_KV if (a.n_heads // a.n_kv_heads) % per == 0 else GATHERED


def ffn_mode(f: FFNSpec, tp: int) -> str:
    return GATHERED if f.d_ff % tp else TP


@functools.lru_cache(maxsize=None)
def _plan(cfg: ArchConfig, tp: int) -> Tuple[Tuple[str, str], ...]:
    vocab = GATHERED if cfg.vocab_size % tp else TP
    plan = {"embed": vocab, "head": vocab}
    kinds = set(cfg.pattern())
    if LAYER_ATTN in kinds:
        plan["attn"] = attention_mode(cfg.attention, tp)
        if cfg.ffn.kind != "none":
            plan["ffn"] = ffn_mode(cfg.ffn, tp)
    if kinds - {LAYER_ATTN}:
        plan["ssm"] = GATHERED
    if cfg.shared_attention:
        plan["shared_attn"] = attention_mode(cfg.attention, tp)
        plan["shared_ffn"] = ffn_mode(
            dataclasses.replace(cfg.ffn, d_ff=cfg.ffn.d_ff or
                                4 * cfg.d_model), tp)
    if cfg.encoder is not None:
        plan["cross"] = plan["encoder_attn"] = plan["attn"]
        plan["encoder_ffn"] = plan["ffn"]
    return tuple(plan.items())


def tp_plan(cfg: ArchConfig, tp: int) -> Dict[str, str]:
    """Block -> ``"tp"``, ``"tp_kv_gathered"`` or ``"gathered"`` for a
    model group of ``tp`` ranks.  Blocks: ``embed`` and ``head`` (the
    vocabulary), ``attn`` and ``ffn`` (every attention layer), ``ssm``,
    ``shared_attn`` / ``shared_ffn`` (the hybrid models' shared block),
    ``cross``, ``encoder_attn`` and ``encoder_ffn``."""
    return dict(_plan(cfg, tp))


def mode(cfg: ArchConfig, block: str) -> Optional[str]:
    """The plan's word for ``block`` under the current model group; None
    outside one."""
    mg = _MODEL
    if mg is None:
        return None
    how = dict(_plan(cfg, mg.size)).get(block)
    return GATHERED if mg.whole and how is not None else how


# which leaves of a block the plan keeps local, uses whole, or slices
_GQA_LOCAL = ("wq", "wo", "wk", "wv")
_MLA_LOCAL = ("wq_b", "wkv_b", "wo")
_MLA_PARTIAL = ("wq_a", "wkv_a", "q_norm", "kv_norm")
_FFN_LOCAL = ("up", "gate", "down", "w_up", "w_gate", "w_down",
              "shared_up", "shared_down")
_ATTN_BLOCKS = ("attn", "cross", "encoder_attn", "shared_attn")


def _block_of(path) -> Tuple[Optional[str], str]:
    """(block, the leaf's name within it) of a param path."""
    head = path[0]
    if head in ("embed", "lm_head"):
        return ("embed" if head == "embed" else "head"), path[-1]
    if head == "segments" and path[2] in ("attn", "ffn", "cross", "ssm"):
        return path[2], path[3]
    if head == "shared_attn" and path[1] in ("attn", "ffn"):
        return "shared_" + path[1], path[2]
    if head == "encoder" and path[1] == "layers" and path[2] in ("attn",
                                                                 "ffn"):
        return "encoder_" + path[2], path[3]
    return None, path[-1]


def leaf_role(cfg: ArchConfig, tp: int, path,
              model_dim: Optional[int]) -> Role:
    """The role of one param leaf under a model group of ``tp`` ranks;
    ``model_dim`` (negative) is the dim the model axis shards in storage,
    None if it replicates the leaf."""
    if tp == 1:
        return Role(FULL)
    block, name = _block_of(path)
    how = tp_plan(cfg, tp).get(block)
    if how is None or how == GATHERED or block == "ssm":
        return Role(FULL)
    if block == "head" and model_dim is None:
        return Role(SLICE, -1)
    if block in _ATTN_BLOCKS:
        if cfg.attention.kind == "mla":
            if name in _MLA_PARTIAL:
                return Role(PARTIAL)
            local = name in _MLA_LOCAL
        elif how == TP_KV and name in ("wk", "wv"):
            return Role(PARTIAL)
        else:
            local = name in _GQA_LOCAL
    elif block in ("embed", "head"):
        local = name == "table"
    else:
        local = name in _FFN_LOCAL
    if not local:
        if model_dim is not None:
            raise ValueError(f"{path}: the model axis shards it, but "
                             f"the plan uses it whole inside {block!r}")
        return Role(FULL)
    if model_dim is None:
        raise ValueError(f"{path}: the plan keeps {block!r} local, but "
                         "the model axis does not shard this leaf")
    return Role(LOCAL, model_dim)


# ===========================================================================
# Collectives and Megatron's pair
# ===========================================================================

def all_reduce(t: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: Tensor, dim: int, group, size: int) -> Tensor:
    """The ``size`` ranks' blocks of ``t`` concatenated along ``dim`` in
    rank order: a new contiguous tensor, no view."""
    first = dim % t.dim() == 0
    x = t.contiguous() if first else t.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out if first else out.movedim(0, dim).contiguous()


def reduce_scatter(t: Tensor, dim: int, group, size: int) -> Tensor:
    """``all_gather``'s transpose: ``t`` summed over the ``size`` ranks,
    this rank's block of it along ``dim``."""
    first = dim % t.dim() == 0
    x = t.contiguous() if first else t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out if first else out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.group = _MODEL.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.contiguous().clone(), _MODEL.group)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: Tensor) -> Tensor:
    """Identity; its gradient is summed over the model group (the input
    of a column-parallel block)."""
    return x if _MODEL is None else _CopyToModel.apply(x)


def reduce_from_model(x: Tensor) -> Tensor:
    """``x`` summed over the model group; its gradient passes as it is
    (the output of a row-parallel block)."""
    return x if _MODEL is None else _ReduceFromModel.apply(x)


# ===========================================================================
# Blocks
# ===========================================================================

def local_attention(a: AttentionSpec, params: Dict, how: str, tp: int,
                    rank: int) -> Tuple[AttentionSpec, Dict, int]:
    """(local spec, the params the body reads, this rank's first kv
    head): ``tp_kv_gathered`` slices the whole ``wk`` / ``wv`` to the one
    kv head this rank's q heads read."""
    per = a.n_heads // tp
    if a.kind == "mla":
        return dataclasses.replace(a, n_heads=per, n_kv_heads=per), params, 0
    if how == TP:
        kv = a.n_kv_heads // tp
        return (dataclasses.replace(a, n_heads=per, n_kv_heads=kv), params,
                rank * kv)
    kv0 = rank * per // (a.n_heads // a.n_kv_heads)
    cols = slice(kv0 * a.head_dim, (kv0 + 1) * a.head_dim)
    params = {**params, "wk": params["wk"][..., cols],
              "wv": params["wv"][..., cols]}
    return dataclasses.replace(a, n_heads=per, n_kv_heads=1), params, kv0


def attention(how: Optional[str], a: AttentionSpec, body: Callable,
              params: Dict, h: Tensor, cache=None, cache_dims=None,
              writes=None) -> Tensor:
    """``body(params, spec, h, cache) -> (out, cache)`` (an attention body
    of ``models.attention``) as the plan says: whole (outside a model
    group, or ``gathered``), or on this rank's heads between
    ``copy_to_model`` and ``reduce_from_model``.  ``writes``: ``(mode,
    cache_len, ring)`` of the forward, which say the cache positions the
    body writes (``_write_start``)."""
    if how is None:
        return body(params, a, h, cache)[0]
    mg = _MODEL
    if how == GATHERED:
        work, done = _cache_enter(cache, cache_dims, None, a, writes,
                                  h.shape[1])
        out, new = body(params, a, h, work)
        done(new)
        return out
    la, params, kv0 = local_attention(a, params, how, mg.size, mg.rank)
    heads = None if a.kind == "mla" else (kv0, la.n_kv_heads)
    work, done = _cache_enter(cache, cache_dims, heads, a, writes,
                              h.shape[1])
    out, new = body(params, la, copy_to_model(h), work)
    done(new)
    return reduce_from_model(out)


def local_ffn(f: FFNSpec, tp: int) -> FFNSpec:
    return dataclasses.replace(f, d_ff=f.d_ff // tp)


# ---------------------------------------------------------------------------
# Caches under a model group (the dry run's prefill / decode cells)
# ---------------------------------------------------------------------------

def _write_start(writes, b: int, n: int, s: int, device) -> Tensor:
    """(b,) the first cache position each row's n new positions take
    (they run on modulo s): prefill from 0; decode from each row's
    ``cache_len`` (a scalar or (b,)), clamped to s - n as
    ``attention._update_rows`` clamps it, or unclamped on the ring
    buffer."""
    mode, cache_len, ring = writes
    if mode != "decode":
        return torch.zeros((b,), dtype=torch.long, device=device)
    start = row_lens(cache_len, b, device).long()
    return start if ring else start.clamp(0, s - n)


def _cache_enter(cache, dims, heads, a: AttentionSpec, writes, n: int):
    """(the layer cache the body reads and writes, finish(new cache)).

    A leaf already laid out as the body reads it (GQA heads sharded as
    the plan splits them) is used in place.  Any other leaf the model
    axis shards is all-gathered for the layer; the body then reads the
    whole of it (MLA's latent, a gathered block: every rank computes the
    same update) or its heads (GQA).  Afterwards only the n positions the
    body wrote are read back: with heads, those positions of every rank's
    heads are all-gathered (not the whole cache again); then this rank's
    stored block is written at them."""
    if cache is None:
        return None, lambda new: None
    mg = _MODEL
    dims = dims or {}
    work, back = {}, []
    for k, t in cache.items():
        dim = dims.get(k)
        if heads is not None and dim == -2 and \
                t.shape[-2] == heads[1] and \
                a.n_kv_heads // heads[1] == mg.size:
            work[k] = t                       # heads local already
            continue
        full = t if dim is None else all_gather(t, dim, mg.group, mg.size)
        if heads is None:
            work[k] = full
            if dim is None:
                continue                      # written in place
        else:
            work[k] = full.narrow(-2, heads[0], heads[1])
        back.append((k, t, dim))

    def done(new):
        for k, t, dim in back:
            b, s = t.shape[0], work[k].shape[1]
            start = _write_start(writes, b, n, s, t.device)
            rows = torch.arange(b, device=t.device)[:, None]
            pos = (start[:, None] + torch.arange(n, device=t.device)) % s
            piece = work[k][rows, pos]
            if heads is not None:
                piece = _publish_heads(piece, heads, a)
            _store(t, dim, piece, pos, start, s)
    return work, done


def _store(t: Tensor, dim, piece: Tensor, pos: Tensor, start: Tensor,
           s: int) -> None:
    """Write ``piece`` (b, n, ...), the whole layer's values at positions
    ``pos`` (b, n): the n from ``start`` modulo ``s``, into ``t``, this
    rank's block of the layer's cache leaf (``dim``: the model axis's, or
    None)."""
    mg = _MODEL
    b, n = pos.shape
    rows = torch.arange(b, device=t.device)[:, None]
    d = None if dim is None else dim % t.dim()
    if d is None or d != 1:
        if d is not None:
            nb = t.shape[d]
            piece = piece.narrow(d, mg.rank * nb, nb)
        t[rows, pos] = piece
        return
    # the sequence dim: this rank holds positions [rank * sb, (rank+1) * sb)
    sb = t.shape[1]
    j = (mg.rank * sb + torch.arange(sb, device=t.device)[None]
         - start[:, None]) % s
    hit = (j < n).reshape(b, sb, *[1] * (t.dim() - 2))
    t.copy_(torch.where(hit, piece[rows, j.clamp(max=n - 1)], t))


def _publish_heads(mine: Tensor, heads, a: AttentionSpec) -> Tensor:
    """Every kv head of ``mine`` (this rank's heads at the written
    positions) as the rank that computes it wrote it: the ranks' head
    blocks all-gathered, each kv head taken from the first rank that
    holds it."""
    mg = _MODEL
    got = all_gather(mine, -2, mg.group, mg.size)
    if heads[1] * mg.size == a.n_kv_heads:
        return got
    per = a.n_heads // mg.size
    g = a.n_heads // a.n_kv_heads
    first = [min(r for r in range(mg.size) if r * per // g == j)
             for j in range(a.n_kv_heads)]
    return got[..., torch.tensor(first, device=got.device), :]


def gather_state(state: Optional[Dict], dims) -> Tuple[Optional[Dict],
                                                       Callable]:
    """(a recurrent state gathered whole over the model group, back(new
    state) -> this rank's blocks of it), for a gathered SSM block."""
    mg = _MODEL
    if mg is None or state is None or not dims:
        return state, lambda new: new
    full = {k: v if dims.get(k) is None else
            all_gather(v, dims[k], mg.group, mg.size)
            for k, v in state.items()}

    def back(new):
        out = {}
        for k, v in new.items():
            d = dims.get(k)
            n = None if d is None else v.shape[d] // mg.size
            out[k] = v if d is None else v.narrow(d, mg.rank * n, n)
        return out
    return full, back


def segment_cache_dims(si: int):
    """The current model group's cache dims of segment ``si`` (None
    outside a group or without them)."""
    mg = _MODEL
    if mg is None or mg.cache_dims is None:
        return None
    return mg.cache_dims["segments"][si]


# ===========================================================================
# Vocabulary
# ===========================================================================

def embed(table: Tensor, tokens: Tensor) -> Tensor:
    """The embedding rows of ``tokens`` from ``table``, this rank's block
    of the vocabulary: ids outside it give zeros, and the blocks are
    summed over the model group."""
    n = table.shape[0]
    local = tokens.long() - _MODEL.rank * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_model(x)


def vocab_parallel_cross_entropy(logits_local: Tensor, labels: Tensor,
                                 mask: Optional[Tensor] = None) -> Tensor:
    """``layers.softmax_cross_entropy`` of logits split over the model
    group by vocabulary block (rank r holds columns [r·V/tp, (r+1)·V/tp)):
    the max, the sum of exps and the gold logit are reduced over the
    group, so no rank holds a (b, s, V) tensor."""
    mg = _MODEL
    lg = logits_local.float()
    n = lg.shape[-1]
    m = lg.detach().amax(dim=-1)
    all_reduce(m, mg.group, dist.ReduceOp.MAX)
    sum_exp = reduce_from_model(torch.exp(lg - m[..., None]).sum(dim=-1))
    lse = torch.log(sum_exp) + m
    local = labels.long() - mg.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)))
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
