"""The Hopper kernels (decode attention, the fused grouped MoE FFN) against
their plain versions on the card.  Needs an NVIDIA GPU (marker ``gpu``;
skipped elsewhere) and imports no JAX, so it runs on the machine with the
card:

    python -m pytest -m gpu tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs.  Decode attention: the kernel keeps scores and
probabilities in f32 where the plain version rounds them to bf16 (as the
reference's ref.py), so they differ by a few bf16 steps (atol 3e-2, rtol
2e-2).  MoE FFN: both sides compute in f32 and round once to bf16; their
sums run in other orders, so an output may round to the neighbouring bf16
value (rtol 8e-3 = two bf16 steps, atol 2e-2 for outputs near 0 whose f32
sums cancel terms of magnitude ~100)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

TOL = dict(atol=3e-2, rtol=2e-2)
MOE_TOL = dict(atol=2e-2, rtol=8e-3)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


@pytest.fixture
def ops():
    _need_card()
    from repro_torch.kernels.decode_attention import ops
    return ops


@pytest.fixture
def moe_ops():
    _need_card()
    from repro_torch.kernels.moe_ffn import ops
    return ops


def _bf16(g, *shape):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("n", [1, 16, 65])
@pytest.mark.parametrize("heads", [(32, 32, 80), (32, 8, 128)],
                         ids=["stablelm", "wedlm"])
def test_dense_kernel_matches_plain(ops, heads, n, window):
    h, kv, dh = heads
    g = torch.Generator(device="cuda").manual_seed(n)
    s = 256
    q, k, v = _bf16(g, 4, n, h, dh), _bf16(g, 4, s, kv, dh), \
        _bf16(g, 4, s, kv, dh)
    lens = torch.tensor([0, 37, 150, s - n], dtype=torch.int32,
                        device="cuda")
    before = ops.decode_attention_ragged.launches
    out = ops.decode_attention_ragged(q, k, v, lens, window=window)
    assert ops.decode_attention_ragged.launches == before + 1
    torch.testing.assert_close(
        out, ops.decode_attention_ref(q, k, v, lens, window=window), **TOL)


@pytest.mark.parametrize("n", [1, 16])
def test_paged_kernel_matches_plain(ops, n):
    g = torch.Generator(device="cuda").manual_seed(n)
    b, h, kv, dh, bs, max_blocks = 4, 32, 32, 80, 16, 16
    n_phys = b * max_blocks + 1
    pages = np.random.default_rng(n).permutation(n_phys - 1)
    tables = torch.as_tensor(pages.reshape(b, max_blocks).astype(np.int32),
                             device="cuda")
    q = _bf16(g, b, n, h, dh)
    k, v = _bf16(g, n_phys, bs, kv, dh), _bf16(g, n_phys, bs, kv, dh)
    lens = torch.tensor([0, 5, 100, 256 - n], dtype=torch.int32,
                        device="cuda")
    tiles = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = ops.decode_attention_paged(q, k, v, lens, tables, tiles=tiles)
    torch.testing.assert_close(
        out, ops.decode_attention_paged_ref(q, k, v, lens, tables), **TOL)
    want = ops.slack_report(n, lens.tolist(), 256, head_dim=dh, k_block=bs)
    assert int(tiles.item()) == kv * want["kv_tiles_executed"]


def test_kernel_rejects_what_it_does_not_take(ops):
    q = torch.zeros((1, 1, 4, 24), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 32, 4, 24), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention_ragged(q, k, k, 0)
    with pytest.raises(TypeError, match="bf16"):
        ops.decode_attention_ragged(q.float(), k, k, 0)


# ---------------------------------------------------------------------------
# fused grouped MoE FFN
# ---------------------------------------------------------------------------

def _moe_weights(g, e, d, f, gated=True):
    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * e ** -0.5).to(torch.bfloat16)
    return {"w_gate": w(e, d, f) if gated else None, "w_up": w(e, d, f),
            "w_down": w(e, f, d)}


def _moe_layout(moe_ops, idx, e, tb):
    """Padded layout of top-k expert ids ``idx`` (T, k): sorted rows'
    slots, block metadata, m_pad and the group sizes."""
    flat = idx.reshape(-1)
    gs = torch.zeros(e, dtype=torch.int32, device="cuda").scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    order = torch.argsort(flat, stable=True)
    slot, be, bv, m_pad = moe_ops.align_block_size(
        flat[order].to(torch.int32), gs, e, tb)
    return order, slot.long(), be, bv, m_pad, gs


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
@pytest.mark.parametrize("t", [1, 4, 41])
def test_moe_kernel_matches_plain(moe_ops, t, gated):
    """granite widths (E 40, top-8, d 1536, f 512); gelu at f 1024 (two
    f tiles).  Router-like random routing; valid rows compared, executed
    blocks counted."""
    e, k, d = 40, 8, 1536
    f = 512 if gated else 1024
    g = torch.Generator(device="cuda").manual_seed(t)
    w = _moe_weights(g, e, d, f, gated)
    idx = torch.rand((t, e), generator=g, device="cuda").topk(k).indices
    tb = 16 if t <= e else 64
    order, slot, be, bv, m_pad, gs = _moe_layout(moe_ops, idx, e, tb)
    x = torch.randn((t * k, d), generator=g, device="cuda").to(torch.bfloat16)
    x_pad = torch.zeros((m_pad, d), dtype=torch.bfloat16, device="cuda")
    x_pad[slot] = x
    act = "swiglu" if gated else "gelu"
    blocks = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = moe_ops.grouped_ffn_padded.launches
    out = moe_ops.grouped_ffn_padded(x_pad, w["w_gate"], w["w_up"],
                                     w["w_down"], be, bv, token_block=tb,
                                     activation=act, blocks=blocks)
    assert moe_ops.grouped_ffn_padded.launches == before + 1
    ref = moe_ops.grouped_ffn_ref(x_pad, w["w_gate"], w["w_up"], w["w_down"],
                                  be, bv, token_block=tb, activation=act)
    torch.testing.assert_close(out[slot], ref[slot], **MOE_TOL)
    assert int(blocks.item()) == sum(-(-int(c) // tb) for c in gs.tolist())


def test_moe_kernel_rows_are_invariant(moe_ops):
    """A row gives bitwise the same output alone (T = 1, block 16) and
    among 41 tokens (block 64), with junk in every padding row."""
    e, k, d, f = 40, 8, 1536, 512
    g = torch.Generator(device="cuda").manual_seed(7)
    w = _moe_weights(g, e, d, f)
    idx = torch.rand((41, e), generator=g, device="cuda").topk(k).indices
    x_tok = torch.randn((41, d), generator=g, device="cuda").to(torch.bfloat16)
    outs = []
    for t, tb in ((1, 16), (41, 64)):
        order, slot, be, bv, m_pad, _ = _moe_layout(moe_ops, idx[:t], e, tb)
        x_pad = torch.full((m_pad, d), 37.0, dtype=torch.bfloat16,
                           device="cuda")
        x_pad[slot] = x_tok[:t][order // k]
        out = moe_ops.grouped_ffn_padded(
            x_pad, w["w_gate"], w["w_up"], w["w_down"], be, bv,
            token_block=tb, activation="swiglu")
        per_pair = torch.empty_like(out[slot])
        per_pair[order] = out[slot]
        outs.append(per_pair[:k])              # token 0's k expert rows
    assert torch.equal(outs[0], outs[1])


def test_moe_kernel_refuses_what_it_does_not_take(moe_ops):
    be = torch.zeros(1, dtype=torch.int32, device="cuda")
    w = _moe_weights(torch.Generator(device="cuda").manual_seed(0), 2, 16,
                     768)
    x = torch.zeros((16, 16), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiple of 512"):
        moe_ops.grouped_ffn_padded(x, w["w_gate"], w["w_up"], w["w_down"],
                                   be, be, token_block=16,
                                   activation="swiglu")
    w = _moe_weights(torch.Generator(device="cuda").manual_seed(0), 2, 20,
                     32)
    with pytest.raises(ValueError, match="multiples of 8"):
        moe_ops.grouped_ffn_padded(
            torch.zeros((16, 20), dtype=torch.bfloat16, device="cuda"),
            w["w_gate"], w["w_up"], w["w_down"], be, be, token_block=16,
            activation="swiglu")
    w = _moe_weights(torch.Generator(device="cuda").manual_seed(0), 2, 16,
                     32)
    with pytest.raises(TypeError, match="bf16"):
        moe_ops.grouped_ffn_padded(x.float(), w["w_gate"], w["w_up"],
                                   w["w_down"], be, be, token_block=16,
                                   activation="swiglu")
    with pytest.raises(ValueError, match="token_block"):
        moe_ops.grouped_ffn_padded(x, w["w_gate"], w["w_up"], w["w_down"],
                                   be, be, token_block=8, activation="swiglu")
