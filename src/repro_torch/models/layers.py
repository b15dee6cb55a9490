"""Shared model layers: norms, RoPE, MLPs, embeddings.

Plain functions over dicts of tensors, mirroring the reference layers
cast for cast: bf16 weights and activations, f32 normalization, rotary
and activation internals, cast back to the input dtype at the same
points.  ``init_*`` take a ``torch.Generator`` and an optional leading
``lead`` shape (the stacked layer axis of a segment).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _init(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
          dtype=torch.bfloat16, lead: Tuple[int, ...] = ()) -> Tensor:
    """A ``lead + shape`` leaf of f32 normal draws times ``scale``, cast
    to ``dtype``.  A stacked leaf is drawn one ``shape`` slice per leading
    index, scaled in place and copied into the preallocated output, so the
    f32 temporary is one layer's slice, never the whole stack."""
    out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
    for piece in (out.view((-1,) + shape) if lead else (out,)):
        piece.copy_(torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device).mul_(scale))
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(gen: torch.Generator, d: int, dtype=torch.bfloat16,
                 lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=gen.device)}


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(gen: torch.Generator, d: int, dtype=torch.bfloat16,
                   lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=gen.device)}


def layernorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-5
              ) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs                    # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]                            # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             activation: str = "swiglu", dtype=torch.bfloat16,
             lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
    p = {"up": _init(gen, (d_model, d_ff), d_model ** -0.5, dtype, lead),
         "down": _init(gen, (d_ff, d_model), d_ff ** -0.5, dtype, lead)}
    if activation == "swiglu":
        p["gate"] = _init(gen, (d_model, d_ff), d_model ** -0.5, dtype, lead)
    return p


def mlp(params: Dict[str, Tensor], x: Tensor, activation: str = "swiglu"
        ) -> Tensor:
    up = x @ params["up"]
    if activation == "swiglu":
        gate = F.silu((x @ params["gate"]).float())
        h = (gate * up.float()).to(x.dtype)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ params["down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16) -> Dict[str, Tensor]:
    return {"table": _init(gen, (vocab, d_model), 0.02, dtype)}


def embed(params: Dict[str, Tensor], tokens: Tensor) -> Tensor:
    return params["table"][tokens]


def init_lm_head(gen: torch.Generator, d_model: int, vocab: int,
                 dtype=torch.bfloat16) -> Dict[str, Tensor]:
    return {"w": _init(gen, (d_model, vocab), d_model ** -0.5, dtype)}


def lm_head(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    return x @ params["w"]


def unembed_tied(embed_params: Dict[str, Tensor], x: Tensor) -> Tensor:
    return x @ embed_params["table"].T


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: Tensor, labels: Tensor,
                          mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token CE in f32; logits (b, s, v), labels (b, s) int;
    with ``mask`` (b, s) the masked mean over at least one position."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
