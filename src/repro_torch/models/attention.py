"""Attention: GQA (covers MHA/MQA and sliding-window GQA) and MLA —
prefill and multi-position decode over a dense per-slot cache or a paged
pool, and sliding-window decode over an O(window) ring buffer.

Mirrors the reference ``models/attention.py``.  The GQA decode paths can
route the attention core through the Hopper decode-attention kernel
(``kernels.decode_attention``; ``use_kernel=True``), whose q tile is the
M_attn granularity of the NFP principle; the default is the plain masked
core.  Prefill attention has no kernel in the reference either: it stays
the plain core (f32 scores, -1e30 mask).  MLA and the ring buffer have no
Pallas kernel in the reference ("XLA path only"), so they run plain torch
ops and ignore ``use_kernel``.

MLA (MiniCPM3 / DeepSeek style) caches a compressed latent and one shared
rotary key per position, ``{"latent": (b, s, kv_lora), "k_rope": (b, s,
rope)}``.  Prefill decompresses K/V and attends GQA-style (non-absorbed);
decode absorbs the key decompression into the query and attends straight
over the latent, so its KV traffic is the latent's bytes (the d_latent
term of the NFP model).  The two round differently in bf16.

Caches are updated IN PLACE: the decode paths write the N new positions'
K/V (MLA: latent and rotary key) into the cache tensors they were given
and return the same dict, so a captured decode step replays static
addresses.  For attention-only models that is safe without the
reference's functional copy: a row's writes land at or past its
committed length, which every causal mask hides until a later forward
overwrites them.

Cross-attention (whisper's decoder) attends to the encoder memory with an
all-true mask and no rotary; its K/V are projected from the memory on
every call (``encode_cross_kv``) and never cached, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.arch import AttentionSpec
from repro_torch.kernels.decode_attention.ops import (NEG_INF,
                                                      decode_attention_paged,
                                                      decode_attention_ragged,
                                                      gqa_core, paged_gather,
                                                      row_lens)
from repro_torch.models.layers import (_init, apply_rope, init_rmsnorm,
                                       rmsnorm)

Tensor = torch.Tensor


# ===========================================================================
# Parameter / cache init
# ===========================================================================

def init_attention(gen: torch.Generator, d_model: int, a: AttentionSpec,
                   dtype=torch.bfloat16, lead: Tuple[int, ...] = ()
                   ) -> Dict[str, Tensor]:
    """The reference's leaves at its ``1/sqrt(shape[0])`` scales, with a
    leading ``lead`` layer axis."""
    if a.kind == "mla":
        qk_h = a.qk_nope_head_dim + a.qk_rope_head_dim
        kv_a = a.kv_lora_rank + a.qk_rope_head_dim
        kv_b = a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
        o_in = a.n_heads * a.v_head_dim
        return {
            "wq_a": _init(gen, (d_model, a.q_lora_rank), d_model ** -0.5,
                          dtype, lead),
            "q_norm": init_rmsnorm(gen, a.q_lora_rank, dtype, lead),
            "wq_b": _init(gen, (a.q_lora_rank, a.n_heads * qk_h),
                          a.q_lora_rank ** -0.5, dtype, lead),
            "wkv_a": _init(gen, (d_model, kv_a), d_model ** -0.5, dtype,
                           lead),
            "kv_norm": init_rmsnorm(gen, a.kv_lora_rank, dtype, lead),
            "wkv_b": _init(gen, (a.kv_lora_rank, kv_b),
                           a.kv_lora_rank ** -0.5, dtype, lead),
            "wo": _init(gen, (o_in, d_model), o_in ** -0.5, dtype, lead),
        }
    q_dim, kv_dim = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    return {
        "wq": _init(gen, (d_model, q_dim), d_model ** -0.5, dtype, lead),
        "wk": _init(gen, (d_model, kv_dim), d_model ** -0.5, dtype, lead),
        "wv": _init(gen, (d_model, kv_dim), d_model ** -0.5, dtype, lead),
        "wo": _init(gen, (q_dim, d_model), q_dim ** -0.5, dtype, lead),
    }


def init_kv_cache(batch: int, max_len: int, a: AttentionSpec,
                  dtype=torch.bfloat16, device="cpu",
                  lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    """Pre-allocated decode cache (b, max_len, kv, dh), zero-filled; MLA:
    the latent (b, max_len, kv_lora) and the rotary key (b, max_len,
    rope).  A paged pool is the same tensors read as (n_phys, block_size,
    ...): pages shared by all slots through their block tables, the last
    page the write dump unattached table entries point at."""
    if a.kind == "mla":
        lead = lead + (batch, max_len)
        return {"latent": torch.zeros(lead + (a.kv_lora_rank,), dtype=dtype,
                                      device=device),
                "k_rope": torch.zeros(lead + (a.qk_rope_head_dim,),
                                      dtype=dtype, device=device)}
    shape = lead + (batch, max_len, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(n_phys: int, block_size: int, a: AttentionSpec,
                        dtype=torch.bfloat16, device="cpu",
                        lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    """Paged decode cache: a GLOBAL pool of ``n_phys`` blocks of
    ``block_size`` positions, shared by all slots through per-slot block
    tables (``serving.paged.BlockManager``), with a leading ``lead`` layer
    axis.  The last block is the write-dump page unattached table entries
    point at."""
    return init_kv_cache(n_phys, block_size, a, dtype, device, lead)


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
                 window: Optional[int] = None,
                 kv_valid: Optional[Tensor] = None) -> Tensor:
    """q_pos: (b,sq) kv_pos: (b,sk) -> (b,sq,sk) bool."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        m &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    if kv_valid is not None:
        m &= kv_valid[:, None, :]
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


def gqa_decode_ring(params, a: AttentionSpec, x: Tensor, cache: Dict,
                    cache_len, theta: float) -> Tuple[Tensor, Dict]:
    """Sliding-window decode over a RING buffer of W_buf >= window + N
    slots (``init_cache(swa_ring=True)``), for one scalar ``cache_len``.

    Global position p lives in slot p % W_buf; a slot holds the LARGEST
    written position congruent to its index, computable from (slot, total
    written) without storing positions:
        p_s = s + W_buf * ((L_tot - 1 - s) // W_buf)   if L_tot > 0.
    Memory is O(window) instead of O(sequence).  The N new positions'
    K/V are written into their slots in place; the core is the plain one,
    as the reference's."""
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    if cl.dim() != 0:
        raise ValueError("the ring buffer takes one scalar cache_len for "
                         f"every row, not a {tuple(cl.shape)} vector")
    b, n, _ = x.shape
    w_buf = cache["k"].shape[1]
    pos = cl + torch.arange(n, dtype=torch.int32, device=x.device)
    q_pos = pos[None, :].expand(b, n)
    q, k, v = _qkv(params, a, x, q_pos, theta)
    slots = (pos % w_buf).long()
    cache["k"][:, slots] = k
    cache["v"][:, slots] = v
    # the position each slot holds after the writes above
    l_tot = cl + n
    s_idx = torch.arange(w_buf, dtype=torch.int32, device=x.device)
    p_s = s_idx + w_buf * torch.div(l_tot - 1 - s_idx, w_buf,
                                    rounding_mode="floor")
    p_s = torch.where(l_tot > 0, p_s, -1)
    kv_pos = p_s[None, :].expand(b, w_buf)
    mask = _causal_mask(q_pos, kv_pos, a.window or w_buf,
                        kv_valid=kv_pos >= 0)
    ctx = gqa_core(q, cache["k"], cache["v"], mask,
                   1.0 / (a.head_dim ** 0.5))
    return ctx.reshape(b, n, -1) @ params["wo"], cache


def cross_attention(params, a: AttentionSpec, x: Tensor, enc_k: Tensor,
                    enc_v: Tensor) -> Tensor:
    """Whisper's decoder cross-attention: x (b, n, d) attends to the
    encoder memory's K/V (b, F, kv, dh), every frame visible."""
    b, n, _ = x.shape
    q = (x @ params["wq"]).reshape(b, n, a.n_heads, a.head_dim)
    mask = torch.ones((b, n, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    ctx = gqa_core(q, enc_k, enc_v, mask, 1.0 / (a.head_dim ** 0.5))
    return ctx.reshape(b, n, -1) @ params["wo"]


def encode_cross_kv(params, a: AttentionSpec, memory: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """The cross-attention K/V (b, F, kv, dh) of the encoder memory."""
    b, f, _ = memory.shape
    k = (memory @ params["wk"]).reshape(b, f, a.n_kv_heads, a.head_dim)
    v = (memory @ params["wv"]).reshape(b, f, a.n_kv_heads, a.head_dim)
    return k, v


# ===========================================================================
# MLA (MiniCPM3 / DeepSeek-style multi-head latent attention)
# ===========================================================================

def _mla_q(params, a: AttentionSpec, x: Tensor, q_pos: Tensor,
           theta: float) -> Tuple[Tensor, Tensor]:
    b, n, _ = x.shape
    qk_h = a.qk_nope_head_dim + a.qk_rope_head_dim
    q = rmsnorm(params["q_norm"], x @ params["wq_a"]) @ params["wq_b"]
    q = q.reshape(b, n, a.n_heads, qk_h)
    q_rope = apply_rope(q[..., a.qk_nope_head_dim:], q_pos, theta)
    return q[..., :a.qk_nope_head_dim], q_rope


def _mla_latent(params, a: AttentionSpec, x: Tensor, pos: Tensor,
                theta: float) -> Tuple[Tensor, Tensor]:
    kv = x @ params["wkv_a"]
    latent = rmsnorm(params["kv_norm"], kv[..., :a.kv_lora_rank])
    # the shared rotary key, rotated as a single "head"
    k_rope = apply_rope(kv[..., a.kv_lora_rank:][..., None, :], pos,
                        theta)[..., 0, :]
    return latent, k_rope


def _mla_wkv_b(params, a: AttentionSpec) -> Tensor:
    return params["wkv_b"].reshape(a.kv_lora_rank, a.n_heads,
                                   a.qk_nope_head_dim + a.v_head_dim)


def _mla_softmax(scores: Tensor, mask: Tensor, a: AttentionSpec,
                 dtype) -> Tensor:
    """(b, h, q, s) scores of the input type -> probabilities of it: f32
    scale, -1e30 mask and softmax, as the reference."""
    scale = 1.0 / ((a.qk_nope_head_dim + a.qk_rope_head_dim) ** 0.5)
    scores = torch.where(mask[:, None], scores.float() * scale, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def mla_full(params, a: AttentionSpec, x: Tensor, positions: Tensor,
             theta: float, build_cache: Optional[Dict] = None,
             cache_len: int = 0) -> Tuple[Tensor, Optional[Dict]]:
    """Non-absorbed MLA for train / prefill: decompress K/V and attend
    GQA-style; optionally fills ``build_cache`` in place at
    ``cache_len``."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(params, a, x, positions, theta)
    latent, k_rope = _mla_latent(params, a, x, positions, theta)
    kv = torch.einsum("bsl,lhd->bshd", latent, _mla_wkv_b(params, a))
    k_nope, v = kv[..., :a.qk_nope_head_dim], kv[..., a.qk_nope_head_dim:]
    scores = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
    probs = _mla_softmax(scores, _causal_mask(positions, positions), a,
                         x.dtype)
    ctx = torch.einsum("bhqs,bshd->bqhd", probs, v)
    out = ctx.reshape(b, s, -1) @ params["wo"]
    if build_cache is not None:
        build_cache["latent"][:, cache_len:cache_len + s] = latent
        build_cache["k_rope"][:, cache_len:cache_len + s] = k_rope
    return out, build_cache


def _mla_absorbed(params, a: AttentionSpec, q_nope: Tensor, q_rope: Tensor,
                  latent: Tensor, k_rope: Tensor, q_pos: Tensor) -> Tensor:
    """Absorbed attention of (b, n) queries over each row's latent cache
    (b, s, kv_lora) and rotary keys (b, s, rope), causal at ``q_pos``."""
    b, n = q_pos.shape
    wkv_b = _mla_wkv_b(params, a)
    wk, wv = wkv_b[..., :a.qk_nope_head_dim], wkv_b[..., a.qk_nope_head_dim:]
    # absorb the key decompression into the query
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wk)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_lat, latent)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
    s = latent.shape[1]
    kv_pos = torch.arange(s, dtype=torch.int32,
                          device=latent.device)[None, :].expand(b, s)
    probs = _mla_softmax(scores, _causal_mask(q_pos, kv_pos), a,
                         q_nope.dtype)
    ctx_lat = torch.einsum("bhqs,bsl->bqhl", probs, latent)
    ctx = torch.einsum("bqhl,lhd->bqhd", ctx_lat, wv)
    return ctx.reshape(b, n, -1) @ params["wo"]


def mla_decode(params, a: AttentionSpec, x: Tensor, cache: Dict,
               cache_len, theta: float) -> Tuple[Tensor, Dict]:
    """Absorbed MLA decode over the dense latent cache: scores computed
    directly against the latent.  ``cache_len`` is a scalar or a (b,)
    vector; the new latents and rotary keys are written in place."""
    b, n, _ = x.shape
    offsets = row_lens(cache_len, b, x.device)
    q_pos = offsets[:, None] + torch.arange(n, dtype=torch.int32,
                                            device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, a, x, q_pos, theta)
    latent_new, k_rope_new = _mla_latent(params, a, x, q_pos, theta)
    _update_rows(cache["latent"], latent_new, offsets)
    _update_rows(cache["k_rope"], k_rope_new, offsets)
    return _mla_absorbed(params, a, q_nope, q_rope, cache["latent"],
                         cache["k_rope"], q_pos), cache


def mla_decode_paged(params, a: AttentionSpec, x: Tensor, cache: Dict,
                     cache_len, block_tables: Tensor, theta: float
                     ) -> Tuple[Tensor, Dict]:
    """Absorbed MLA decode over a paged latent pool: the new latents and
    rotary keys are scattered to the pages the table names, then each
    row's virtual cache is gathered (the decode kernel serves GQA/SWA
    geometries only, as the reference's Pallas kernel)."""
    b, n, _ = x.shape
    n_phys, bs = cache["latent"].shape[0], cache["latent"].shape[1]
    offsets = row_lens(cache_len, b, x.device)
    q_pos = offsets[:, None] + torch.arange(n, dtype=torch.int32,
                                            device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, a, x, q_pos, theta)
    latent_new, k_rope_new = _mla_latent(params, a, x, q_pos, theta)
    flat_idx = _paged_write_idx(block_tables, q_pos, bs, n_phys)
    _paged_update(cache["latent"], latent_new, flat_idx)
    _paged_update(cache["k_rope"], k_rope_new, flat_idx)
    return _mla_absorbed(params, a, q_nope, q_rope,
                         paged_gather(cache["latent"], block_tables),
                         paged_gather(cache["k_rope"], block_tables),
                         q_pos), cache


# ===========================================================================
# Dispatch
# ===========================================================================

def attention_full(params, a: AttentionSpec, x, positions, theta,
                   build_cache=None, cache_len: int = 0, causal: bool = True):
    if a.kind == "mla":
        return mla_full(params, a, x, positions, theta, build_cache,
                        cache_len)
    return gqa_full(params, a, x, positions, theta, build_cache, cache_len,
                    causal)


def attention_decode(params, a: AttentionSpec, x, cache, cache_len, theta,
                     use_kernel: bool = False, swa_ring: bool = False,
                     block_tables=None):
    """Decode dispatch, as the reference's: MLA ignores ``use_kernel``,
    and ``swa_ring`` takes a sliding-window model onto its ring buffer
    (dense, scalar ``cache_len``)."""
    if block_tables is not None:
        if a.kind == "mla":
            return mla_decode_paged(params, a, x, cache, cache_len,
                                    block_tables, theta)
        return gqa_decode_paged(params, a, x, cache, cache_len, block_tables,
                                theta, use_kernel)
    if a.kind == "mla":
        return mla_decode(params, a, x, cache, cache_len, theta)
    if swa_ring and a.kind == "swa":
        return gqa_decode_ring(params, a, x, cache, cache_len, theta)
    return gqa_decode(params, a, x, cache, cache_len, theta, use_kernel)
