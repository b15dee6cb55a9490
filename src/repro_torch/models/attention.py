"""GQA attention (covers MHA/MQA and sliding-window GQA): prefill and
multi-position decode over a dense per-slot cache or a paged pool.

Mirrors the reference ``models/attention.py`` GQA path.  The decode
paths can route the attention core through the Hopper decode-attention
kernel (``kernels.decode_attention``; ``use_kernel=True``), whose q tile
is the M_attn granularity of the NFP principle; the default is the plain
masked core.  Prefill attention has no kernel in the reference either:
it stays the plain core (f32 scores, -1e30 mask).

Caches are updated IN PLACE: the decode paths write the N new positions'
K/V into the cache tensors they were given and return the same dict.
For attention-only models that is safe without the reference's
functional copy: a row's writes land at or past its committed length,
which every causal mask hides until a later forward overwrites them.
MLA, the sliding-window ring buffer and cross-attention are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.arch import AttentionSpec
from repro_torch.kernels.decode_attention.ops import (decode_attention_paged,
                                                      decode_attention_ragged,
                                                      gqa_core, paged_gather,
                                                      row_lens)
from repro_torch.models.layers import _init, apply_rope

Tensor = torch.Tensor


def _gqa_only(a: AttentionSpec) -> None:
    if a.kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet")


# ===========================================================================
# Parameter / cache init
# ===========================================================================

def init_attention(gen: torch.Generator, d_model: int, a: AttentionSpec,
                   dtype=torch.bfloat16, lead: Tuple[int, ...] = ()
                   ) -> Dict[str, Tensor]:
    _gqa_only(a)
    q_dim, kv_dim = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    return {
        "wq": _init(gen, lead + (d_model, q_dim), d_model ** -0.5, dtype),
        "wk": _init(gen, lead + (d_model, kv_dim), d_model ** -0.5, dtype),
        "wv": _init(gen, lead + (d_model, kv_dim), d_model ** -0.5, dtype),
        "wo": _init(gen, lead + (q_dim, d_model), q_dim ** -0.5, dtype),
    }


def init_kv_cache(batch: int, max_len: int, a: AttentionSpec,
                  dtype=torch.bfloat16, device="cpu",
                  lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    """Pre-allocated decode cache (b, max_len, kv, dh), zero-filled.  A
    paged pool is the same tensor read as (n_phys, block_size, kv, dh):
    pages shared by all slots through their block tables, the last page
    the write dump unattached table entries point at."""
    _gqa_only(a)
    shape = lead + (batch, max_len, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# Cache helpers
# ===========================================================================

def _update_rows(cache: Tensor, new: Tensor, offsets: Tensor) -> Tensor:
    """Write ``new`` (b, n, ...) into ``cache`` (b, s, ...) in place at
    per-row offsets.  The start clamps to s - n, as the reference's
    dynamic_update_slice does."""
    b, n = new.shape[0], new.shape[1]
    start = offsets.long().clamp(0, cache.shape[1] - n)
    pos = start[:, None] + torch.arange(n, device=cache.device)
    cache[torch.arange(b, device=cache.device)[:, None], pos] = new
    return cache


def _paged_write_idx(block_tables: Tensor, q_pos: Tensor, block_size: int,
                     n_phys: int) -> Tensor:
    """Flat pool slots (page*block_size + offset) for per-row positions
    (b, n).  Positions past the table's coverage fall through to the
    trailing trash page, never a live block."""
    max_blocks = block_tables.shape[1]
    blk_idx = (q_pos // block_size).clamp(0, max_blocks - 1).long()
    page = torch.gather(block_tables, 1, blk_idx).long()
    page = torch.where(q_pos < max_blocks * block_size, page, n_phys - 1)
    return page * block_size + (q_pos % block_size).long()


def _paged_update(pool: Tensor, new: Tensor, flat_idx: Tensor) -> Tensor:
    """Scatter ``new`` (b, n, ...) into the pool (n_phys, bs, ...) in place
    at flat slots (b, n).  Live destinations are disjoint (writes need
    refcount-1 ownership, ``serving.paged``); only trash-page slots may
    collide, where the winner is irrelevant."""
    flat = pool.view((pool.shape[0] * pool.shape[1],) + tuple(pool.shape[2:]))
    flat[flat_idx.reshape(-1)] = new.reshape((-1,) + tuple(new.shape[2:]))
    return pool


def _causal_mask(q_pos: Tensor, kv_pos: Tensor,
                 window: Optional[int] = None) -> Tensor:
    """q_pos: (b,sq) kv_pos: (b,sk) -> (b,sq,sk) bool."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        m &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def _qkv(params, a: AttentionSpec, x: Tensor, pos: Tensor, theta: float):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, a.n_heads, a.head_dim)
    k = (x @ params["wk"]).reshape(b, s, a.n_kv_heads, a.head_dim)
    v = (x @ params["wv"]).reshape(b, s, a.n_kv_heads, a.head_dim)
    return apply_rope(q, pos, theta), apply_rope(k, pos, theta), v


def _window(a: AttentionSpec) -> Optional[int]:
    return a.window if a.kind == "swa" else None


# ===========================================================================
# GQA / SWA
# ===========================================================================

def gqa_full(params, a: AttentionSpec, x: Tensor, positions: Tensor,
             theta: float, build_cache: Optional[Dict] = None,
             cache_len: int = 0, causal: bool = True
             ) -> Tuple[Tensor, Optional[Dict]]:
    """Self-attention over x (train / prefill); optionally fills
    ``build_cache`` in place at ``cache_len``."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, a, x, positions, theta)
    if causal:
        mask = _causal_mask(positions, positions, _window(a))
    else:
        mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device)
    ctx = gqa_core(q, k, v, mask, 1.0 / (a.head_dim ** 0.5))
    out = ctx.reshape(b, s, -1) @ params["wo"]
    if build_cache is not None:
        build_cache["k"][:, cache_len:cache_len + s] = k
        build_cache["v"][:, cache_len:cache_len + s] = v
    return out, build_cache


def gqa_decode(params, a: AttentionSpec, x: Tensor, cache: Dict,
               cache_len, theta: float, use_kernel: bool = False
               ) -> Tuple[Tensor, Dict]:
    """Multi-position decode forward: N new positions vs the dense cache
    (Eq. 2).  ``cache_len`` is a scalar (aligned rows) or a (b,) vector
    (the scheduler's slots, each at its own length)."""
    b, n, _ = x.shape
    s_max = cache["k"].shape[1]
    offsets = row_lens(cache_len, b, x.device)
    q_pos = offsets[:, None] + torch.arange(n, dtype=torch.int32,
                                            device=x.device)[None, :]
    q, k, v = _qkv(params, a, x, q_pos, theta)
    _update_rows(cache["k"], k, offsets)
    _update_rows(cache["v"], v, offsets)
    if use_kernel:
        ctx = decode_attention_ragged(q, cache["k"], cache["v"], offsets,
                                      window=_window(a))
    else:
        kv_pos = torch.arange(s_max, dtype=torch.int32,
                              device=x.device)[None, :].expand(b, s_max)
        mask = _causal_mask(q_pos, kv_pos, _window(a))
        ctx = gqa_core(q, cache["k"], cache["v"], mask,
                       1.0 / (a.head_dim ** 0.5))
    return ctx.reshape(b, n, -1) @ params["wo"], cache


def gqa_decode_paged(params, a: AttentionSpec, x: Tensor, cache: Dict,
                     cache_len, block_tables: Tensor, theta: float,
                     use_kernel: bool = False) -> Tuple[Tensor, Dict]:
    """Paged multi-position decode: the N new positions' K/V are scattered
    to the pages the table names, then attention runs over each row's
    virtual cache (gathered on the plain path; walked through the table
    by the kernel).  Junk rows of a batched forward write to the trash
    page, so a live block is only ever written by the slot owning it."""
    b, n, _ = x.shape
    n_phys, bs = cache["k"].shape[0], cache["k"].shape[1]
    offsets = row_lens(cache_len, b, x.device)
    q_pos = offsets[:, None] + torch.arange(n, dtype=torch.int32,
                                            device=x.device)[None, :]
    q, k, v = _qkv(params, a, x, q_pos, theta)
    flat_idx = _paged_write_idx(block_tables, q_pos, bs, n_phys)
    _paged_update(cache["k"], k, flat_idx)
    _paged_update(cache["v"], v, flat_idx)
    if use_kernel:
        ctx = decode_attention_paged(q, cache["k"], cache["v"], offsets,
                                     block_tables, window=_window(a))
    else:
        k_virt = paged_gather(cache["k"], block_tables)
        v_virt = paged_gather(cache["v"], block_tables)
        s_virt = k_virt.shape[1]
        kv_pos = torch.arange(s_virt, dtype=torch.int32,
                              device=x.device)[None, :].expand(b, s_virt)
        mask = _causal_mask(q_pos, kv_pos, _window(a))
        ctx = gqa_core(q, k_virt, v_virt, mask, 1.0 / (a.head_dim ** 0.5))
    return ctx.reshape(b, n, -1) @ params["wo"], cache


# ===========================================================================
# Dispatch
# ===========================================================================

def attention_full(params, a: AttentionSpec, x, positions, theta,
                   build_cache=None, cache_len: int = 0, causal: bool = True):
    _gqa_only(a)
    return gqa_full(params, a, x, positions, theta, build_cache, cache_len,
                    causal)


def attention_decode(params, a: AttentionSpec, x, cache, cache_len, theta,
                     use_kernel: bool = False, block_tables=None):
    _gqa_only(a)
    if block_tables is not None:
        return gqa_decode_paged(params, a, x, cache, cache_len, block_tables,
                                theta, use_kernel)
    return gqa_decode(params, a, x, cache, cache_len, theta, use_kernel)
