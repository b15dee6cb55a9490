"""Decode attention: the Hopper kernel's wrappers, its plain version, and
the tile-slack model.

``decode_attention_ragged`` (dense per-slot cache) and
``decode_attention_paged`` (global paged pool + block tables) replace the
reference's Pallas entries of the same names.  Both take the reference
layout — q ``(b, n, h, dh)``, the cache ``(b, s, kv, dh)`` or the pool
``(n_phys, bs, kv, dh)``, per-row committed lengths ``cache_lens`` — and
return ``(b, n, h, dh)``.  On a CUDA tensor they launch
``csrc/decode_attention.cu`` (see its header for the design and what
bounds it) or raise; only a tensor on the CPU takes the plain version.

The q tile is ``select_q_block(n, dh)`` of ``core.granularity`` — the
M_attn the NFP predictor reads — and the kv tile is ``K_BLOCK`` for the
dense cache and one page for the pool.  The kernel cuts each (row, kv
head, q tile)'s executed kv range into spans of ``kv_span`` tiles, one
block each, merged in span order inside the same launch.  The span is a
pure function of the launch's shapes, never of the lengths (they live on
the device and change every graph replay).  ``dense_launch_args`` /
``paged_launch_args`` give a launch's scalar arguments as pure functions
of the shapes: each wrapper passes exactly their tuple to the entry
point, so ``repro_torch.analysis`` checks the tiles and the span on any
host.  The kernel pads the last q tile logically: rows past ``n`` are
skipped, so no padded copy of q exists.

``slack_report`` models one forward's physical work in numpy (useful vs
padded query rows, executed vs grid kv tiles under the kernel's per-row
skip rule, and, given the span, the spans executed); the kernel executes
exactly its ``kv_tiles_executed`` and ``kv_spans_executed``.

``decode_attention_split`` emulates the kernel's partition of the kv
range, in either addressing mode: spans of tiles, inside each span the
warps' split of its chunks (per-split running max, sum and accumulator),
merged in split order, then the spans merged in span order; the tests
hold it against the reference's dense and paged Pallas kernels.  It is
on no serving path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.granularity import cdiv, round_up, select_q_block
from repro_torch.kernels.build import load_library

K_BLOCK = 128
NEG_INF = -1e30
# the kernel's partition: 16-position chunks, 64-row chunks of query rows
KV_CHUNK = 16
TILE_ROWS = 64
#: kv positions of a span: long enough that a block's prologue (the row
#: length and its table entries, one round trip, then its first copies) and
#: its part of the merge stay small beside the bytes it streams, short
#: enough that a long row spreads over many blocks (on an H100, 512 beat
#: 128, 256, 384, 768 and 1024 at the serving cells' lengths)
SPAN_POSITIONS = 512

Tensor = torch.Tensor
Lens = Union[int, Tensor]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention_dense": [_P] * 5 + [_I] * 10 + [_F] + [_P] * 4,
    "decode_attention_paged": [_P] * 6 + [_I] * 10 + [_F] + [_P] * 4,
}


def _kernels() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version (the reference's ref.py, plus the paged gather)
# ---------------------------------------------------------------------------

def row_lens(cache_lens: Lens, b: int, device) -> Tensor:
    """(b,) int32 per-row lengths from a scalar or a (b,) tensor."""
    if isinstance(cache_lens, Tensor):
        return cache_lens.to(device=device, dtype=torch.int32).reshape(-1
                                                                      ).expand(b)
    return torch.full((b,), int(cache_lens), dtype=torch.int32, device=device)


def gqa_core(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, scale: float
             ) -> Tensor:
    """q: (b,sq,h,dh)  k/v: (b,sk,kv,dh)  mask: (b,sq,sk) bool -> (b,sq,h,dh).
    Grouped without materializing repeated KV heads; scores and softmax in
    f32, probabilities cast back to the input dtype."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return ctx.reshape(b, sq, h, dh)


def paged_gather(pool: Tensor, block_tables: Tensor) -> Tensor:
    """Each row's virtual contiguous cache from the pool:
    (n_phys, bs, ...) + (b, max_blocks) -> (b, max_blocks*bs, ...)."""
    n_phys, bs = pool.shape[0], pool.shape[1]
    b, max_blocks = block_tables.shape
    flat = pool.reshape((n_phys * bs,) + tuple(pool.shape[2:]))
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=pool.device)[None, None, :])
    return flat[idx.reshape(b, max_blocks * bs)]


def decode_attention_ref(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         cache_lens: Lens, *, window: Optional[int] = None
                         ) -> Tensor:
    """q: (b, n, h, dh); k/v_cache: (b, s, kv, dh); row b's n queries sit
    at cache_lens[b] .. cache_lens[b]+n-1.  Returns (b, n, h, dh)."""
    b, n, h, dh = q.shape
    s = k_cache.shape[1]
    lens = row_lens(cache_lens, b, q.device)
    q_pos = lens[:, None] + torch.arange(n, device=q.device, dtype=torch.int32)
    kv_pos = torch.arange(s, device=q.device, dtype=torch.int32)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kv_pos[None, None, :] > (q_pos[:, :, None] - window)
    return gqa_core(q, k_cache, v_cache, mask, 1.0 / (dh ** 0.5))


def decode_attention_paged_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                               cache_lens: Lens, block_tables: Tensor, *,
                               window: Optional[int] = None) -> Tensor:
    """The paged pool gathered into per-row virtual caches, then the
    dense plain version."""
    return decode_attention_ref(q, paged_gather(k_pool, block_tables),
                                paged_gather(v_pool, block_tables),
                                cache_lens, window=window)


def kv_splits(rows: int) -> int:
    """Splits of a span's chunks over the kernel's four warps for ``rows``
    (<= 64) query rows of one row chunk: 16-row m-tiles, so 4 for one
    m-tile, 2 for two, 1 for three or four."""
    return {1: 4, 2: 2}.get(cdiv(rows, 16), 1)


def kv_span(k_block: int, n_kv_tiles: int) -> int:
    """Kv tiles of one span of a launch whose rows' tables hold
    ``n_kv_tiles`` tiles of ``k_block`` positions: ``SPAN_POSITIONS``
    positions, or the whole table where that is shorter (one span: no
    merge)."""
    return min(n_kv_tiles, cdiv(SPAN_POSITIONS, k_block))


def kv_spans(lo_tile: int, hi_tile: int, span: int) -> List[Tuple[int, int]]:
    """The kernel's spans of one range's executed tiles ``lo_tile ..
    hi_tile - 1``: ``(t0, t1)`` per live block, in span order; span j
    holds table tiles ``j*span .. (j+1)*span - 1``.  An empty range keeps
    one block, which stores zeros."""
    if hi_tile <= lo_tile:
        return [(0, 0)]
    return [(max(lo_tile, j * span), min(hi_tile, (j + 1) * span))
            for j in range(lo_tile // span, (hi_tile - 1) // span + 1)]


def _merge(parts):
    """Online-softmax partials (m, l, acc) merged in their order:
    (max, sum, accumulator) over the common max."""
    m_all = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    a_all = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        f = torch.exp(pm - m_all)
        l_all = l_all + f * pl
        a_all = a_all + f[..., None] * pa
    return m_all, l_all, a_all


def decode_attention_split(q: Tensor, k: Tensor, v: Tensor,
                           cache_lens: Lens,
                           block_tables: Optional[Tensor] = None, *,
                           window: Optional[int] = None,
                           span: Optional[int] = None) -> Tensor:
    """The kernel's arithmetic in float32, dense (``block_tables`` None:
    k/v the (b, s, kv, dh) cache, kv tile ``K_BLOCK``, zero past s) or
    paged (k/v the pool, kv tile its page): per (row, q tile, kv head) the
    executed tiles (the skip rule's) cut into ``kv_spans`` of ``span``
    tiles (default: the launch's ``kv_span``);
    per span and chunk of at most ``TILE_ROWS`` query rows, the span's
    positions in ``KV_CHUNK``-position chunks, chunk i to split ``i %
    kv_splits(rows)``; each split runs its own online softmax (scores
    masked to ``NEG_INF``) over its chunks in order, the splits merge in
    split order into the span's partial, and the spans merge in span
    order; an empty row gives 0.  Same arguments and result as
    ``decode_attention_ragged`` / ``decode_attention_paged``."""
    b, n, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    if block_tables is None:
        kb, n_tiles = K_BLOCK, cdiv(k.shape[1], K_BLOCK)
        pad = (0, 0, 0, 0, 0, n_tiles * kb - k.shape[1])
        k_virt, v_virt = F.pad(k.float(), pad), F.pad(v.float(), pad)
    else:
        kb, n_tiles = k.shape[1], block_tables.shape[1]
        k_virt = paged_gather(k, block_tables).float()
        v_virt = paged_gather(v, block_tables).float()
    qb = select_q_block(n, dh)
    if span is None:
        span = kv_span(kb, n_tiles)
    scale = 1.0 / (dh ** 0.5)
    lens = row_lens(cache_lens, b, q.device).tolist()
    out = torch.zeros((b, n, h, dh), dtype=torch.float32, device=q.device)
    for bi, ln in enumerate(lens):
        for q0 in range(0, n, qb):
            nq = min(qb, n - q0)
            hi_tile = min(n_tiles, cdiv(ln + min(n, q0 + qb), kb))
            lo_tile = (0 if window is None
                       else max(0, (ln + q0 - window + 1) // kb))
            # (kv, g*nq, dh), row = gi*nq + qi (the Pallas g*q_block fold)
            qt = q[bi, q0:q0 + nq].float().reshape(nq, kv, g, dh).permute(
                1, 2, 0, 3).reshape(kv, g * nq, dh)
            q_pos = ln + q0 + torch.arange(g * nq, device=q.device) % nq
            spans = []
            for t0, t1 in kv_spans(lo_tile, hi_tile, span):
                pos0, pos1 = t0 * kb, t1 * kb
                chunks = cdiv(pos1 - pos0, KV_CHUNK)
                row_parts = []
                for c0 in range(0, g * nq, TILE_ROWS):
                    qc = qt[:, c0:c0 + TILE_ROWS]
                    qp = q_pos[c0:c0 + TILE_ROWS]
                    splits, parts = kv_splits(qc.shape[1]), []
                    for si in range(splits):
                        m = torch.full(qc.shape[:2], NEG_INF, device=q.device)
                        l = torch.zeros_like(m)
                        acc = torch.zeros_like(qc)
                        for ci in range(si, chunks, splits):
                            pos = pos0 + ci * KV_CHUNK + torch.arange(
                                KV_CHUNK, device=q.device)
                            idx = pos.clamp(max=pos1 - 1)
                            sc = torch.einsum("krd,pkd->krp", qc,
                                              k_virt[bi, idx]) * scale
                            keep = (pos < pos1)[None, :] & (pos[None, :]
                                                            <= qp[:, None])
                            if window is not None:
                                keep &= pos[None, :] > qp[:, None] - window
                            sc = torch.where(keep[None], sc, NEG_INF)
                            m_new = torch.maximum(m, sc.amax(-1))
                            alpha = torch.exp(m - m_new)
                            pr = torch.exp(sc - m_new[..., None])
                            l = alpha * l + pr.sum(-1)
                            acc = alpha[..., None] * acc + torch.einsum(
                                "krp,pkd->krd", pr, v_virt[bi, idx])
                            m = m_new
                        parts.append((m, l, acc))
                    row_parts.append(_merge(parts))    # in split order
                spans.append(tuple(torch.cat(x, 1) for x in zip(*row_parts)))
            _, l_all, a_all = (spans[0] if len(spans) == 1
                               else _merge(spans))     # in span order
            l_all = torch.where(l_all == 0, 1.0, l_all)
            o = a_all / l_all[..., None]               # (kv, rows, dh)
            rows = torch.arange(g * nq, device=q.device)
            gi, qi = rows // nq, rows % nq
            heads = (torch.arange(kv, device=q.device)[:, None] * g
                     + gi[None, :])
            out[bi, q0 + qi[None, :].expand_as(heads), heads] = o
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q: Tensor, k: Tensor, v: Tensor, window: Optional[int],
           k_block: int) -> None:
    b, n, h, dh = q.shape
    kv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the decode-attention kernel takes bf16; "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != v.shape or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q head_dim {dh}")
    if dh % 16 or dh > 128:
        raise ValueError(f"head_dim {dh}: the kernel takes dh % 16 == 0, "
                         "dh <= 128")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if not 1 <= k_block <= 128:
        raise ValueError(f"kv tile {k_block} outside [1, 128]")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if n < 1:
        raise ValueError("no query positions")


def _device_lens(cache_lens: Lens, b: int, q: Tensor) -> Tensor:
    lens = row_lens(cache_lens, b, q.device).contiguous()
    if lens.device != q.device:
        raise ValueError(f"cache_lens on {lens.device}, q on {q.device}")
    return lens


def dense_launch_args(q_shape, k_shape, window: Optional[int]) -> tuple:
    """The scalar arguments of one ``decode_attention_dense`` launch, in
    the entry point's order, from q's (b, n, h, dh) and the cache's (b, s,
    kv, dh) shapes: (b, n, h, kv, dh, s_max, q_block, k_block, span,
    window (-1 for none), scale)."""
    b, n, h, dh = (int(x) for x in q_shape)
    s, kv = int(k_shape[1]), int(k_shape[2])
    return (b, n, h, kv, dh, s, select_q_block(n, dh), K_BLOCK,
            kv_span(K_BLOCK, cdiv(s, K_BLOCK)),
            -1 if window is None else int(window), 1.0 / (dh ** 0.5))


def paged_launch_args(q_shape, pool_shape, tables_shape,
                      window: Optional[int]) -> tuple:
    """The scalar arguments of one ``decode_attention_paged`` launch, in
    the entry point's order, from q's (b, n, h, dh), the pool's (n_phys,
    bs, kv, dh) and the block tables' (b, max_blocks) shapes: (b, n, h,
    kv, dh, block_size, max_blocks, q_block, span, window (-1 for none),
    scale)."""
    b, n, h, dh = (int(x) for x in q_shape)
    bs, kv = int(pool_shape[1]), int(pool_shape[2])
    max_blocks = int(tables_shape[1])
    return (b, n, h, kv, dh, bs, max_blocks, select_q_block(n, dh),
            kv_span(bs, max_blocks), -1 if window is None else int(window),
            1.0 / (dh ** 0.5))


# per device: every arrival-counter buffer made so far, the newest last.
# None is ever freed: a captured graph keeps the raw pointer of the buffer
# it was captured with, and replays count into it.  The counters are 0
# between launches (the last span of a range to arrive sets its counter
# back to 0).
_ARRIVALS: Dict[torch.device, List[Tensor]] = {}


def _arrivals(device: torch.device, n: int) -> Tensor:
    held = _ARRIVALS.setdefault(device, [])
    if not held or held[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention needs more arrival counters "
                               "than it holds: launch once at these shapes "
                               "before the capture")
        grow = 2 * held[-1].numel() if held else 4096
        held.append(torch.zeros(max(n, grow), dtype=torch.int32,
                                device=device))
    return held[-1]


def _span_buffers(q: Tensor, kv: int, n_kv_tiles: int, q_block: int,
                  span: int) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """For a launch of more than one span, the f32 scratch for every
    span's partial (per (row, kv head, q tile) and span, the g*min(q_block,
    n) rows a q tile holds, dh + 2 floats each) and one arrival counter per
    (row, kv head, q tile); (None, None) for a launch of one span."""
    b, n, h, dh = q.shape
    n_spans = cdiv(n_kv_tiles, span)
    if n_spans == 1:
        return None, None
    ranges = b * kv * cdiv(n, q_block)
    part = torch.empty(ranges * n_spans * (h // kv) * min(q_block, n)
                       * (dh + 2), dtype=torch.float32, device=q.device)
    return part, _arrivals(q.device, ranges)


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(q: Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _check_tiles(tiles: Optional[Tensor]) -> None:
    if tiles is not None and tiles.numel() < 2:
        raise ValueError("tiles must hold two int32 counters: kv tiles "
                         "and spans executed")


def decode_attention_ragged(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                            cache_lens: Lens, *,
                            window: Optional[int] = None,
                            tiles: Optional[Tensor] = None) -> Tensor:
    """q: (b, n, h, dh); k/v_cache: (b, s, kv, dh); cache_lens: scalar or
    (b,).  ``tiles`` (a two-element int32 CUDA tensor) accumulates the kv
    tiles and the spans the kernel executes, summed over kv heads."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_lens,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention path for {q.device}")
    _check(q, k_cache, v_cache, window, K_BLOCK)
    _check_tiles(tiles)
    lens = _device_lens(cache_lens, q.shape[0], q)
    o = torch.empty_like(q)
    args = dense_launch_args(q.shape, k_cache.shape, window)
    part, count = _span_buffers(q, args[3], cdiv(k_cache.shape[1], K_BLOCK),
                                args[6], args[8])
    err = _kernels().decode_attention_dense(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        lens.data_ptr(), *args, _ptr(part), _ptr(count), _ptr(tiles),
        _stream(q))
    if err:
        raise RuntimeError(f"decode_attention_dense launch failed: CUDA "
                           f"error {err}")
    decode_attention_ragged.launches += 1
    return o


decode_attention_ragged.launches = 0


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     total_len, *, window: Optional[int] = None) -> Tensor:
    """Aligned-rows entry: q (b, n, h, dh); ``total_len`` = cache_len + n
    (a scalar: every row at the same position).  Every row's queries sit
    at ``total_len - n``, through ``decode_attention_ragged`` (on the card
    its dense kernel)."""
    return decode_attention_ragged(q, k_cache, v_cache,
                                   total_len - q.shape[1], window=window)


def decode_attention_paged(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           cache_lens: Lens, block_tables: Tensor, *,
                           window: Optional[int] = None,
                           tiles: Optional[Tensor] = None) -> Tensor:
    """q: (b, n, h, dh); k/v_pool: (n_phys, bs, kv, dh), whose page size
    ``bs`` is this launch's kv tile; block_tables: (b, max_blocks) int32
    logical tile -> physical page (unassigned entries name the trash
    page).  Row b's queries sit at logical positions cache_lens[b] ..
    cache_lens[b]+n-1, their K/V already in the pool.  ``tiles`` as in
    ``decode_attention_ragged``."""
    if q.device.type == "cpu":
        return decode_attention_paged_ref(q, k_pool, v_pool, cache_lens,
                                          block_tables, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention path for {q.device}")
    _check(q, k_pool, v_pool, window, k_pool.shape[1])
    b = q.shape[0]
    if (block_tables.dtype != torch.int32 or block_tables.device != q.device
            or not block_tables.is_contiguous()
            or block_tables.shape[0] != b):
        raise ValueError("block_tables must be a contiguous (b, max_blocks) "
                         "int32 tensor on q's device")
    _check_tiles(tiles)
    lens = _device_lens(cache_lens, b, q)
    o = torch.empty_like(q)
    args = paged_launch_args(q.shape, k_pool.shape, block_tables.shape,
                             window)
    part, count = _span_buffers(q, args[3], block_tables.shape[1], args[7],
                                args[8])
    err = _kernels().decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), o.data_ptr(),
        lens.data_ptr(), block_tables.data_ptr(), *args, _ptr(part),
        _ptr(count), _ptr(tiles), _stream(q))
    if err:
        raise RuntimeError(f"decode_attention_paged launch failed: CUDA "
                           f"error {err}")
    decode_attention_paged.launches += 1
    return o


decode_attention_paged.launches = 0


# ---------------------------------------------------------------------------
# granularity slack (numpy; copied from the reference ops.slack_report)
# ---------------------------------------------------------------------------

def slack_report(n: int, cache_lens, s_max: int, *,
                 head_dim: int = 128,
                 k_block: int = K_BLOCK,
                 window: Optional[int] = None,
                 active=None,
                 span: Optional[int] = None) -> Dict[str, float]:
    """Model one ragged decode forward's physical work (per kv head).

    Kv tile ij of batch row b and q tile iq executes iff
        ij*k_block < len_b + min(n, (iq+1)*q_block)              (upper)
        and, with a window, ij*k_block + k_block - 1 >=
            len_b + iq*q_block - window + 1                      (lower)
    ``active`` (b,) bool marks rows carrying real requests; the others
    still execute but count as slack.  For the paged launch pass
    ``k_block=block_size`` and the table-covered ``s_max``.  ``span`` (the
    launch's kv tiles per span, ``dense_launch_args`` /
    ``paged_launch_args``; None: the whole table) gives the blocks that
    run, ``kv_spans_executed`` (``kv_spans``, an empty range one), and
    ``rows_split``, the share of (row, q tile) ranges cut into more than
    one span.
    """
    lens = np.asarray(cache_lens, np.int64).ravel()
    b = lens.size
    act = (np.ones(b, bool) if active is None
           else np.asarray(active, bool).ravel())
    qb = select_q_block(n, head_dim)
    n_pad = round_up(n, qb)
    n_q_tiles = n_pad // qb
    s_pad = round_up(s_max, k_block)
    n_kv_tiles = s_pad // k_block
    span = n_kv_tiles if span is None else span
    executed = 0
    useful = 0
    spans = 0
    split = 0
    for bi in range(b):
        for iq in range(n_q_tiles):
            hi = lens[bi] + min(n, (iq + 1) * qb)        # kv end (exclusive)
            tiles = min(n_kv_tiles, cdiv(int(hi), k_block))
            lo_tile = 0
            if window is not None:
                lo_visible = lens[bi] + iq * qb - window + 1
                lo_tile = max(0, int(lo_visible) // k_block)
            t = max(0, tiles - lo_tile)
            executed += t
            if act[bi]:
                useful += t
            live = len(kv_spans(lo_tile, tiles, span))
            spans += live
            split += live > 1

    rows_logical = int(act.sum()) * n
    rows_physical = b * n_pad
    grid = b * n_q_tiles * n_kv_tiles
    return {
        "n": n, "q_block": qb, "k_block": k_block,
        "rows_logical": rows_logical,
        "rows_physical": rows_physical,
        "row_utilization": rows_logical / max(rows_physical, 1),
        "kv_tiles_useful": useful,
        "kv_tiles_executed": executed,
        "kv_tiles_grid": grid,
        "kv_tile_utilization": useful / max(executed, 1),
        "kv_tiles_skipped": grid - executed,
        "kv_spans_executed": spans,
        "rows_split": split / max(b * n_q_tiles, 1),
    }
