"""The plain float32 reference of the decoders the benchmark runs.

A GQA decoder of RMSNorm (weight only), rotary position embeddings over
the whole head (rotate-half: the first half of each head against the
second), causal softmax attention in which query head ``i`` reads key /
value head ``i // (heads / kv_heads)``, and a SwiGLU FFN: dense, or
``num_local_experts`` experts of which each position takes its
``num_experts_per_tok`` best by router logit (f32), weighted by the
softmax over those logits; then the final RMSNorm and the LM head (the
embedding's transpose where tied).  This follows the published
StableLM-3B-4E1T and Granite-3.0-3B-A800M decoders with the port's
departures (``port_departures`` in each configuration file: RMSNorm for
StableLM's LayerNorm, full rotary, no Granite multipliers).

Plain PyTorch over one sequence, layer by layer: the weights are the
benchmark's own (bf16 tensors in the port's parameter layout, read by
path), cast to float32 a layer at a time; TF32 is off.  Every product
goes through ``mm(x, w)``, so the control can swap in a lower
precision.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

Tensor = torch.Tensor


def f32_mm(x: Tensor, w: Tensor) -> Tensor:
    return x @ w.float()


def _fp8(t: Tensor, dim: int) -> Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum at e4m3's largest value, 448).  The
    rounding passes gradients straight through, as fp8 training does."""
    with torch.no_grad():
        amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
        scale = amax / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def fp8_mm(x: Tensor, w: Tensor) -> Tensor:
    """The product computed from float8 e4m3 operands: activations scaled
    per row, weights per output column (a row-wise scaled fp8 GEMM)."""
    return _fp8(x.float(), -1) @ _fp8(w.float(), 0)


def _norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: Tensor, theta: float) -> Tensor:
    """x (..., s, heads, dh) at positions 0..s-1."""
    s, dh = x.shape[-3], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(lp: Dict, s: Dict, x: Tensor, mm: Callable) -> Tensor:
    """x (b, n, d)."""
    b, n = x.shape[0], x.shape[1]
    h, kv, dh = s["heads"], s["kv_heads"], s["head_dim"]
    q = _rope(mm(x, lp["wq"]).view(b, n, h, dh), s["rope_theta"])
    k = _rope(mm(x, lp["wk"]).view(b, n, kv, dh), s["rope_theta"])
    v = mm(x, lp["wv"]).view(b, n, kv, dh)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / dh ** 0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, h * dh)
    return mm(ctx, lp["wo"])


def _swiglu(x: Tensor, gate: Tensor, up: Tensor, down: Tensor,
            mm: Callable) -> Tensor:
    return mm(torch.nn.functional.silu(mm(x, gate)) * mm(x, up), down)


def _ffn(lp: Dict, s: Dict, x: Tensor, mm: Callable) -> Tensor:
    """x (b, n, d)."""
    if not s["experts"]:
        return _swiglu(x, lp["gate"], lp["up"], lp["down"], mm)
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ lp["router"].float()
    top, idx = torch.topk(logits, s["top_k"], dim=-1)
    weight = torch.softmax(top, dim=-1)
    out = torch.zeros_like(xt)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        y = _swiglu(xt[rows], lp["w_gate"][e], lp["w_up"][e],
                    lp["w_down"][e], mm)
        out = out.index_add(0, rows, y * weight[rows, slot][:, None])
    return out.view_as(x)


def _layers(seg: Dict, n: int):
    """Each layer's view of a stacked segment, one ``unbind`` per leaf:
    under autograd a stacked leaf's gradient is then one stack of its
    layers' gradients, where indexing would make a zero-filled gradient
    of the whole stack for every layer."""
    out = [{} for _ in range(n)]
    for k, v in seg.items():
        parts = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def final_hidden(params: Dict, s: Dict, tokens: Tensor,
                 mm: Callable = f32_mm) -> Tensor:
    """f32 output of the final norm over ``tokens``: (positions, d) of a
    1-D sequence, (b, positions, d) of a (b, positions) batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tokens.dim() == 1:
        return final_hidden(params, s, tokens[None], mm)[0]
    x = params["embed"]["table"][tokens].float()
    eps = s["norm_eps"]
    for seg in params["segments"]:
        for lp in _layers(seg, seg["ln1"]["scale"].shape[0]):
            x = x + _attention(lp["attn"], s, _norm(x, lp["ln1"]["scale"],
                                                    eps), mm)
            x = x + _ffn(lp["ffn"], s, _norm(x, lp["ln2"]["scale"], eps), mm)
    return _norm(x, params["final_norm"]["scale"], eps)


def logits(params: Dict, s: Dict, hidden: Tensor,
           mm: Callable = f32_mm) -> Tensor:
    """(positions, vocab) f32 logits of final-norm rows ``hidden``."""
    head = (params["embed"]["table"].t() if s["tied"]
            else params["lm_head"]["w"])
    return mm(hidden, head)
