"""The Hopper decode-attention kernels against their plain version on the
card.  Needs an NVIDIA GPU (marker ``gpu``; skipped elsewhere) and imports
no JAX, so it runs on the machine with the card:

    python -m pytest -m gpu tests/test_torch_cuda_kernels.py

Tolerance: bf16 outputs; the kernel keeps scores and probabilities in f32
where the plain version rounds them to bf16 (as the reference's ref.py),
so they differ by a few bf16 steps (atol 3e-2, rtol 2e-2)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

TOL = dict(atol=3e-2, rtol=2e-2)


@pytest.fixture
def ops():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from repro_torch.kernels.decode_attention import ops
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
