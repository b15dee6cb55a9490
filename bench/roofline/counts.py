"""Operations and bytes computed from shapes (the ``model_config``
shape spec): the model's FLOPs per position, a train step's, and the
paged decode-attention kernel's least bytes and FLOPs per launch."""
from __future__ import annotations

from typing import Dict

import numpy as np

from bench.roofline import peaks


def matmul_params(s: Dict) -> int:
    """Parameters one position multiplies with: every layer's attention
    projections and the FFN it routes to (top-k experts and the router),
    and the LM head; not the embedding lookup."""
    d, h, kv, dh = s["d"], s["heads"], s["kv_heads"], s["head_dim"]
    attn = 2 * d * h * dh + 2 * d * kv * dh
    if s["experts"]:
        ffn = s["top_k"] * 3 * d * s["d_ff"] + d * s["experts"]
    else:
        ffn = 3 * d * s["d_ff"]
    return s["layers"] * (attn + ffn) + d * s["vocab"]


def attention_flops(s: Dict, context: float) -> float:
    """FLOPs of one position's attention over ``context`` positions, all
    layers: QK^T and PV, 2 FLOPs a multiply-add each."""
    return 4.0 * s["layers"] * s["heads"] * s["head_dim"] * context


def prefill_flops(s: Dict, prompt_len: int) -> float:
    """A prompt of ``p`` positions, each attending causally to itself and
    those before it."""
    p = int(prompt_len)
    return 2.0 * matmul_params(s) * p + attention_flops(s, p * (p + 1) / 2)


def param_count(s: Dict) -> int:
    """All parameters (every expert, the embedding, an untied head)."""
    d, h, kv, dh = s["d"], s["heads"], s["kv_heads"], s["head_dim"]
    attn = 2 * d * h * dh + 2 * d * kv * dh
    experts = max(s["experts"], 1)
    ffn = experts * 3 * d * s["d_ff"] + (d * s["experts"])
    norms = 2 * d
    head = 0 if s["tied"] else d * s["vocab"]
    return s["layers"] * (attn + ffn + norms) + d * s["vocab"] + head + d


def train_flops(s: Dict, tokens: int) -> float:
    """6 N T, the model-FLOP convention of a train step (N all
    parameters: the dense model this cell trains)."""
    return 6.0 * param_count(s) * tokens


def paged_attention_bound_s(s: Dict, lens: np.ndarray, n: int) -> float:
    """The least time of one paged decode-attention launch (one layer)
    over rows of committed lengths ``lens`` (active rows only) with ``n``
    new positions each: each row's K and V of its ``len + n`` positions
    read once, q read and the output written once (bf16), against the
    bf16 peak for QK^T and PV."""
    lens = np.asarray(lens, np.float64)
    kv_pos = float((lens + n).sum())
    bytes_ = (2 * kv_pos * s["kv_heads"] * s["head_dim"] * 2
              + 2 * len(lens) * n * s["heads"] * s["head_dim"] * 2)
    flops = 4.0 * s["heads"] * s["head_dim"] * n * kv_pos
    return max(bytes_ / peaks.HBM_BYTES_S, flops / peaks.BF16_FLOPS)
