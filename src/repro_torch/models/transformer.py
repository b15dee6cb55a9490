"""Decoder assembly for attention-only architectures.

Layers are grouped into *segments* of identical kind, and each segment's
parameters and cache are STACKED along a leading layer axis, exactly as
the reference lays out its pytree (so ``bridge.params_from_jax`` maps one
onto the other leaf for leaf).  Where the reference runs ``lax.scan``
over the stacked leaves, the port runs a Python loop over layer views of
the same tensors; the cache views are written in place.

Modes:
  train   — full causal self-attention, no cache.
  prefill — same math, fills the cache in place from position 0.
  decode  — the multi-position decode forward (Eq. 2): N new positions
            against a cache of length ``cache_len``.
SSM / hybrid segments, MoE FFNs and the encoder are not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.arch import LAYER_ATTN, ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.attention import (attention_decode, attention_full,
                                          init_attention, init_kv_cache)
from repro_torch.models.layers import (embed, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm, lm_head, mlp,
                                       rmsnorm, unembed_tied)

Tensor = torch.Tensor


# ===========================================================================
# Segments
# ===========================================================================

def make_segments(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Group the layer pattern into runs of identical kind."""
    segs: List[Tuple[str, int]] = []
    for kind in cfg.pattern():
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the parts of the architecture zoo the port lacks."""
    if any(kind != LAYER_ATTN for kind, _ in make_segments(cfg)):
        raise NotImplementedError(f"{cfg.name}: SSM / hybrid segments are "
                                  "not ported yet")
    if cfg.encoder is not None or cfg.shared_attention:
        raise NotImplementedError(f"{cfg.name}: encoders and shared "
                                  "attention are not ported yet")
    if cfg.ffn.kind != "dense":
        raise NotImplementedError(f"{cfg.name}: {cfg.ffn.kind} FFN is not "
                                  "ported yet")


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s view of a stacked segment tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ===========================================================================
# Init
# ===========================================================================

def init_model(cfg: ArchConfig, generator: torch.Generator,
               device: DeviceLike = None, dtype=torch.bfloat16) -> Dict:
    """Random parameters with the reference's structure and scales, drawn
    from ``generator`` directly on ``device`` (the generator must live
    there)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: make the generator on the target device")
    d = cfg.d_model
    params: Dict = {
        "embed": init_embedding(generator, cfg.vocab_size, d, dtype),
        "final_norm": init_rmsnorm(generator, d, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(generator, d, cfg.vocab_size, dtype)
    segs = []
    for _, count in make_segments(cfg):
        lead = (count,)
        segs.append({
            "ln1": init_rmsnorm(generator, d, dtype, lead),
            "attn": init_attention(generator, d, cfg.attention, dtype, lead),
            "ln2": init_rmsnorm(generator, d, dtype, lead),
            "ffn": init_mlp(generator, d, cfg.ffn.d_ff, cfg.ffn.activation,
                            dtype, lead),
        })
    params["segments"] = segs
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None) -> Dict:
    """Pre-allocated dense decode cache: per segment, (layers, batch,
    max_len, kv, dh) K and V."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"segments": [
        init_kv_cache(batch, max_len, cfg.attention, dtype, dev, (count,))
        for _, count in make_segments(cfg)]}


def init_paged_cache(cfg: ArchConfig, n_phys: int, block_size: int,
                     dtype=torch.bfloat16, device: DeviceLike = None) -> Dict:
    """Paged decode state: every layer owns an (n_phys, block_size, kv,
    dh) pool; all layers share one logical block layout (the per-slot
    block tables of ``serving.paged``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"segments": [
        init_kv_cache(n_phys, block_size, cfg.attention, dtype, dev,
                      (count,))
        for _, count in make_segments(cfg)]}


# ===========================================================================
# Forward
# ===========================================================================

def _attn_layer(lp, cfg: ArchConfig, x: Tensor, positions, cache, cache_len,
                mode: str, use_kernel: bool, block_tables) -> Tensor:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        att, _ = attention_decode(lp["attn"], cfg.attention, h, cache,
                                  cache_len, cfg.rope_theta, use_kernel,
                                  block_tables=block_tables)
    else:
        att, _ = attention_full(lp["attn"], cfg.attention, h, positions,
                                cfg.rope_theta, build_cache=cache,
                                cache_len=0)
    x = x + att
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + mlp(lp["ffn"], h2, cfg.ffn.activation)


def forward(params, cfg: ArchConfig, inputs: Dict, *, mode: str = "train",
            cache: Optional[Dict] = None, cache_len=0,
            use_kernel: bool = False, block_tables: Optional[Tensor] = None,
            ) -> Tuple[Tensor, Optional[Dict], Tensor, Tensor]:
    """Returns (logits, cache, moe_aux_loss, hidden), as the reference.

    ``cache`` is updated in place and returned.  ``block_tables`` (b,
    max_blocks) int32 switches decode-mode attention onto the PAGED pool
    (``init_paged_cache``) with a (b,) ``cache_len``.  ``hidden`` is the
    final-norm output (b, s, d) the LM head reads.
    inputs: {"tokens": (b, s) int} or {"embeds": (b, s, d)}.
    """
    check_ported(cfg)
    if "embeds" in inputs:
        x = inputs["embeds"]
    else:
        x = embed(params["embed"], inputs["tokens"])
    b, s = x.shape[0], x.shape[1]
    positions = None
    if mode != "decode":
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    for si, (_, count) in enumerate(make_segments(cfg)):
        sp = params["segments"][si]
        sc = None if cache is None else cache["segments"][si]
        for i in range(count):
            x = _attn_layer(_layer(sp, i), cfg, x, positions,
                            None if sc is None else _layer(sc, i), cache_len,
                            mode, use_kernel, block_tables)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed_tied(params["embed"], x)
    else:
        logits = lm_head(params["lm_head"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, cache, aux, x
