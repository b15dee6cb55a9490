"""The decode-attention plain version (what the port's wrappers run for
CPU tensors) against the reference entries ``ops.decode_attention_ragged``
and ``ops.decode_attention_paged`` — the Pallas kernels in interpret mode,
as the reference's own tests run them on the CPU — plus the copied
``slack_report``.

Inputs are float32 so the comparison is about the algorithm: the kernels
accumulate in f32 and the plain version rounds nothing in f32 either, so
they agree to f32 rounding of the softmax sums (2e-5, the tolerance of
the reference's own kernel-vs-oracle tests)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ops as ref_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402

ATOL = RTOL = 2e-5


def _qkv(rng, b, n, h, kv, dh, s):
    q = rng.standard_normal((b, n, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n", [1, 5, 65])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_dense_plain_matches_reference(n, window, heads):
    """Ragged rows: an empty row, a short one, a mid one and a full one."""
    h, kv = heads
    rng = np.random.default_rng(n)
    b, dh, s = 4, 16, 160
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 3, 70, s - n], np.int32)
    want = ref_ops.decode_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        window=window)
    got = ops.decode_attention_ragged(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_dense_scalar_length_broadcasts():
    """A scalar cache length is the aligned case of the (b,) vector."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 3, 4, 4, 4, 16, 64))
    got = ops.decode_attention_ragged(q, k, v, 20)
    want = ops.decode_attention_ragged(q, k, v,
                                       torch.full((3,), 20, dtype=torch.int32))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _pool(rng, k_dense, v_dense, lens, n, bs, layout):
    """Pack a dense cache into a pool: 'fragmented' (random pages),
    'reversed' (descending pages), 'identity' (in order); unassigned
    table entries name the trash page, filled with junk."""
    b, s, kv, dh = k_dense.shape
    max_blocks = s // bs
    need = [-(-int(lens[i] + n) // bs) for i in range(b)]
    n_phys = sum(max(c, 1) for c in need) + 2          # + slack + trash
    order = np.arange(n_phys - 1)
    if layout == "fragmented":
        rng.shuffle(order)
    elif layout == "reversed":
        order = order[::-1]
    tables = np.full((b, max_blocks), n_phys - 1, np.int32)
    k_pool = (100 * rng.standard_normal((n_phys, bs, kv, dh))).astype(
        np.float32)
    v_pool = (100 * rng.standard_normal((n_phys, bs, kv, dh))).astype(
        np.float32)
    pi = 0
    for bi in range(b):
        for j in range(need[bi]):
            p = int(order[pi])
            pi += 1
            tables[bi, j] = p
            k_pool[p] = k_dense[bi, j * bs:(j + 1) * bs]
            v_pool[p] = v_dense[bi, j * bs:(j + 1) * bs]
    return k_pool, v_pool, tables


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("layout", ["fragmented", "reversed", "identity"])
def test_paged_plain_matches_reference(layout, window):
    """Hostile tables: scattered and reversed pages, a zero-length row, a
    single-block row and a full row; junk in unattached pages never leaks."""
    rng = np.random.default_rng(1)
    b, n, h, kv, dh, bs, s = 4, 4, 8, 2, 16, 16, 96
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 5, bs - n, s - n], np.int32)
    k_pool, v_pool, tables = _pool(rng, k, v, lens, n, bs, layout)
    want = ref_ops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(lens), jnp.asarray(tables), window=window)
    got = ops.decode_attention_paged(
        torch.as_tensor(q), torch.as_tensor(k_pool), torch.as_tensor(v_pool),
        torch.as_tensor(lens), torch.as_tensor(tables), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    # and the paged plain version equals the dense one on the same content
    dense = ops.decode_attention_ragged(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lens), window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("k_block", [16, 128])
@pytest.mark.parametrize("n", [1, 5, 64, 65, 130])
def test_slack_report_matches_reference(n, k_block, window):
    """Every field of the reference's report, and without a span one
    block per (row, q tile) range, none of them split."""
    lens = [0, 1, 15, 16, 100, 300]
    active = [True, False, True, True, False, True]
    kw = dict(head_dim=80, k_block=k_block, window=window, active=active)
    got = ops.slack_report(n, lens, 512, **kw)
    want = ref_ops.slack_report(n, lens, 512, **kw)
    assert {k: got[k] for k in want} == want
    assert got["kv_spans_executed"] == len(lens) * (got["rows_physical"]
                                                    // len(lens)
                                                    // got["q_block"])
    assert got["rows_split"] == 0.0


def test_wrapper_rejects_unknown_device_types():
    q = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no decode-attention path"):
        ops.decode_attention_ragged(q, q, q, 0)


# ---------------------------------------------------------------------------
# the kernel's split of the kv range in the paged mode (emulated in float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("layout", ["identity", "fragmented"],
                         ids=["contiguous", "fragmented"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_split_emulation_matches_reference(heads, layout, n, window):
    """The paged mode's per-split online softmax over 16-position chunks,
    merged in split order, against the reference's paged Pallas kernel in
    interpret mode.  Rows: an empty one (length 0), lengths inside a page
    and at its edges (1, 15, 16, 17) and a full row; with GQA, n = 16
    gives 64 resident rows (one split per warp) and n = 1 four rows (four
    splits).  float32 inputs: both sides accumulate in f32 and differ by
    the order of the softmax sums (2e-5, as above)."""
    h, kv = heads
    rng = np.random.default_rng(7 + n)
    b, dh, bs, s = 6, 16, 16, 128
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 1, 15, 16, 17, s - n], np.int32)
    k_pool, v_pool, tables = _pool(rng, k, v, lens, n, bs, layout)
    want = ref_ops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(lens), jnp.asarray(tables), window=window)
    got = ops.decode_attention_split(
        torch.as_tensor(q), torch.as_tensor(k_pool), torch.as_tensor(v_pool),
        torch.as_tensor(lens), torch.as_tensor(tables), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [1, 17, 65])
def test_paged_split_emulation_long_rows(n):
    """Rows of up to 16 pages (more chunks than the kernel's ring of
    three 4-chunk steps holds), n = 17 (two m-tiles: two splits) and
    n = 65 (two q tiles, GQA: a 64-row chunk, then 4 rows) against the
    plain version."""
    rng = np.random.default_rng(n)
    b, h, kv, dh, bs, s = 3, 8, 2, 16, 16, 256
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 100, s - n], np.int32)
    k_pool, v_pool, tables = (torch.as_tensor(a) for a in
                              _pool(rng, k, v, lens, n, bs, "fragmented"))
    q, lens = torch.as_tensor(q), torch.as_tensor(lens)
    for window in (None, 40):
        got = ops.decode_attention_split(q, k_pool, v_pool, lens, tables,
                                         window=window)
        want = ops.decode_attention_paged_ref(q, k_pool, v_pool, lens,
                                              tables, window=window)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bs", [8, 32])
def test_paged_split_emulation_page_sizes(bs):
    """Pages of 8 positions (a 16-position chunk spans two) and of 32 (a
    page spans two chunks), with a window, against the reference's paged
    Pallas kernel."""
    rng = np.random.default_rng(bs)
    b, n, h, kv, dh, s = 4, 3, 8, 2, 16, 96
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 9, 40, s - n], np.int32)
    k_pool, v_pool, tables = _pool(rng, k, v, lens, n, bs, "fragmented")
    for window in (None, 20):
        want = ref_ops.decode_attention_paged(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(lens), jnp.asarray(tables), window=window)
        got = ops.decode_attention_split(
            torch.as_tensor(q), torch.as_tensor(k_pool),
            torch.as_tensor(v_pool), torch.as_tensor(lens),
            torch.as_tensor(tables), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,splits,lo,hi,span,spans", [
    (1, 4, 0, 1, 16, [(0, 1)]),                       # a short row: one span
    (16, 4, 0, 16, 16, [(0, 16)]),                    # exactly one span
    (17, 2, 0, 17, 16, [(0, 16), (16, 17)]),          # one tile past it
    (32, 2, 0, 0, 4, [(0, 0)]),                       # empty: one block of zeros
    (33, 1, 5, 11, 4, [(5, 8), (8, 11)]),             # a window: aligned spans
    (64, 1, 3, 160, 160, [(3, 160)]),                 # the whole table
    (48, 1, 0, 110, 16, [(16 * j, min(110, 16 * j + 16))
                         for j in range(7)]),         # one long row
])
def test_kv_splits_follow_the_warp_layout(rows, splits, lo, hi, span,
                                          spans):
    """The kernel's partition: the warps' split of a span's chunks by the
    16-row m-tiles of ``rows`` query rows, and a range's spans, aligned
    to the table, in span order."""
    assert ops.kv_splits(rows) == splits
    assert ops.kv_spans(lo, hi, span) == spans


@pytest.mark.parametrize("shape,span", [
    ((16, 160), 32),     # the serving cells' 16-position pages: 512 positions
    ((16, 8), 8),        # a short table: one span, no merge
    ((16, 32), 32),      # a table of exactly one span
    ((128, 36), 4),      # the dense cache's 128-position tiles
    ((8, 160), 64),      # pages of 8 positions
    ((24, 7), 7),        # a page no power of two, a table under one span
])
def test_kv_span_is_a_function_of_the_shapes(shape, span):
    """The span in kv tiles: ``SPAN_POSITIONS`` positions, or the whole
    table where that is shorter."""
    assert ops.kv_span(*shape) == span


def test_launch_args_carry_the_span():
    q = (16, 1, 32, 80)
    paged = ops.paged_launch_args(q, (2561, 16, 32, 80), (16, 160), None)
    assert paged[8] == ops.kv_span(16, 160) == 32
    dense = ops.dense_launch_args(q, (16, 2560, 32, 80), None)
    assert dense[8] == ops.kv_span(ops.K_BLOCK, 20) == 4


def test_span_buffers_keep_every_arrival_buffer(monkeypatch):
    """A launch of one span gets no scratch and no counters; one of more
    gets a counter per (row, kv head, q tile) range, and a buffer it
    outgrows stays held (a graph captured on it replays into it)."""
    monkeypatch.setattr(ops, "_ARRIVALS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    q = torch.zeros(16, 1, 32, 80)
    assert ops._span_buffers(q, 32, 32, 16, 32) == (None, None)
    part, small = ops._span_buffers(q, 32, 160, 16, 32)
    assert part.numel() == 16 * 32 * 5 * 82 and small.numel() == 4096
    assert ops._span_buffers(q, 32, 160, 16, 32)[1] is small
    big = ops._span_buffers(torch.zeros(130, 1, 32, 80), 32, 160, 16, 32)[1]
    assert big.numel() == 8192 and not bool(big.any())
    assert ops._ARRIVALS[q.device][0] is small
    assert ops._ARRIVALS[q.device][-1] is big


@pytest.mark.parametrize("span", [1, 3, 5])
def test_slack_report_counts_spans(span):
    """``kv_spans_executed`` is the number of blocks that run: one per
    live span of each (row, q tile) range, one for an empty range."""
    lens, n, kb, s = [0, 3, 40, 200], 2, 16, 256
    rep = ops.slack_report(n, lens, s, head_dim=16, k_block=kb, span=span)
    want = 0
    for ln in lens:
        want += len(ops.kv_spans(0, min(s // kb, -(-(ln + n) // kb)), span))
    assert rep["kv_spans_executed"] == want
    assert rep["rows_split"] == sum(-(-(ln + n) // kb) > span
                                    for ln in lens) / len(lens)


# ---------------------------------------------------------------------------
# the kernel's split in the dense mode (emulated in float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [256, 200], ids=["s256", "s200"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("n", [1, 16, 65])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_dense_split_emulation_matches_reference(heads, n, window, s):
    """The kernel's dense mode: whole 128-position tiles of the skip rule
    walked in 16-position chunks, split over the warps and merged in split
    order, against the reference's dense Pallas kernel in interpret mode.
    Rows of lengths 0, 1, 127, 128, 129 (at and across a tile edge) and a
    full row; with GQA n = 16 gives 64 resident rows (one split per warp)
    and n = 65 two q tiles of up to 256 rows (64-row chunks).  s = 200 is
    no multiple of 128: the last tile runs past the cache, which the kernel
    zero-fills as the reference pads it.  float32 inputs (2e-5, as
    above)."""
    h, kv = heads
    rng = np.random.default_rng(11 + n + s)
    b, dh = 6, 16
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 1, 127, 128, 129, s - n], np.int32)
    want = ref_ops.decode_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        window=window)
    got = ops.decode_attention_split(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the kernel's spans: a range cut into blocks of ``span`` kv tiles, merged
# in span order (emulated in float32)
# ---------------------------------------------------------------------------

SPAN_CASES = {
    # heads, n, lens, window
    "long_row": ((4, 4), 1, [0, 3, 17, 250], None),      # one row far longer
    "window": ((8, 2), 5, [0, 40, 130, 200], 24),
    "n16": ((8, 2), 16, [0, 1, 100, 240], None),          # 64 resident rows
    "n17": ((8, 2), 17, [0, 15, 16, 239], 48),            # 64 + 4 rows
    "gn_over_64": ((16, 2), 9, [0, 30, 120, 247], None),  # g·n = 72 > 64
}


@pytest.mark.parametrize("span", [1, 3, 16])
@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_paged_split_emulation_spans(case, span):
    """Spans of one page (every tile its own block), of three (spans that
    straddle a row's end and, with a window, its start) and of sixteen
    (the whole 256-position table: no merge), against the reference's
    paged Pallas kernel in interpret mode: rows of length 0, short rows
    beside one far longer, n 16 and 17, g·n over 64 rows (two row
    chunks).  float32 (2e-5, as above)."""
    (h, kv), n, lens, window = SPAN_CASES[case]
    rng = np.random.default_rng(span + n)
    b, dh, bs, s = 4, 16, 16, 256
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array(lens, np.int32)
    k_pool, v_pool, tables = _pool(rng, k, v, lens, n, bs, "fragmented")
    want = ref_ops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(lens), jnp.asarray(tables), window=window)
    got = ops.decode_attention_split(
        torch.as_tensor(q), torch.as_tensor(k_pool), torch.as_tensor(v_pool),
        torch.as_tensor(lens), torch.as_tensor(tables), window=window,
        span=span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("span", [1, 2])
@pytest.mark.parametrize("n,window", [(1, None), (17, 24), (65, None)])
def test_dense_split_emulation_spans(n, window, span):
    """The dense mode's spans of one 128-position tile and of two (the
    whole 256-position cache), GQA, against the reference's dense Pallas
    kernel in interpret mode (2e-5, as above)."""
    rng = np.random.default_rng(50 + n + span)
    b, h, kv, dh, s = 4, 8, 2, 16, 256
    q, k, v = _qkv(rng, b, n, h, kv, dh, s)
    lens = np.array([0, 5, 129, s - n], np.int32)
    want = ref_ops.decode_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        window=window)
    got = ops.decode_attention_split(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lens), window=window, span=span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
