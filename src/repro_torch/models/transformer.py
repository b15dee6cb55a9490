"""Decoder assembly: attention segments (dense or MoE FFN) and Mamba1 SSM
segments.

Layers are grouped into *segments* of identical kind, and each segment's
parameters and cache are STACKED along a leading layer axis, exactly as
the reference lays out its pytree (so ``bridge.params_from_jax`` maps one
onto the other leaf for leaf).  Where the reference runs ``lax.scan``
over the stacked leaves, the port runs a Python loop over layer views of
the same tensors.  Attention caches are written in place through those
views; SSM states are not: each SSM segment's new (conv, ssm) state is a
new stacked tensor in the returned cache, for the engine to commit per
row.

Modes:
  train   — full causal self-attention, no cache.
  prefill — same math, fills the cache from position 0: attention writes
            its K/V from position 0 and SSM layers start from a ZERO state
            (whatever the cache held), so a reused cache row cannot leak
            an earlier request's recurrent state into the prompt.
  decode  — the multi-position decode forward (Eq. 2): N new positions
            against a cache of length ``cache_len``.
The FFN is a dense MLP or the MoE FFN (``models.moe``); ``use_kernel``
reaches the MoE FFN and the selective scan in every mode and GQA / SWA
attention in decode mode (prefill attention and MLA have no kernel).
Attention is GQA, sliding-window GQA (optionally decoding over an
O(window) ring buffer, ``swa_ring``) or MLA.  Hybrid segments, Mamba2,
shared attention and the encoder are not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.arch import LAYER_ATTN, LAYER_SSM, ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.attention import (attention_decode, attention_full,
                                          init_attention, init_kv_cache)
from repro_torch.models.layers import (embed, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm, lm_head, mlp,
                                       rmsnorm, unembed_tied)
from repro_torch.models.mamba import (init_mamba1, init_mamba1_state,
                                      mamba1_block)
from repro_torch.models.moe import init_moe, moe_ffn

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


def has_ssm(cfg: ArchConfig) -> bool:
    """Whether the model carries recurrent state (any non-attention
    segment)."""
    return any(kind != LAYER_ATTN for kind, _ in make_segments(cfg))


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the parts of the architecture zoo the port lacks (every
    attention kind — GQA, sliding window, MLA — is ported)."""
    kinds = {kind for kind, _ in make_segments(cfg)}
    if kinds - {LAYER_ATTN, LAYER_SSM}:
        raise NotImplementedError(f"{cfg.name}: hybrid segments are not "
                                  "ported yet")
    if LAYER_SSM in kinds and cfg.ssm.kind != "mamba1":
        raise NotImplementedError(f"{cfg.name}: {cfg.ssm.kind} SSM blocks "
                                  "are not ported yet")
    if cfg.encoder is not None or cfg.shared_attention:
        raise NotImplementedError(f"{cfg.name}: encoders and shared "
                                  "attention are not ported yet")
    if LAYER_ATTN in kinds and cfg.ffn.kind not in ("dense", "moe"):
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
    for kind, count in make_segments(cfg):
        lead = (count,)
        if kind == LAYER_SSM:
            segs.append({
                "ln1": init_rmsnorm(generator, d, dtype, lead),
                "ssm": init_mamba1(generator, d, cfg.ssm, dtype, lead),
            })
            continue
        if cfg.ffn.kind == "moe":
            ffn = init_moe(generator, d, cfg.ffn, dtype, lead)
        else:
            ffn = init_mlp(generator, d, cfg.ffn.d_ff, cfg.ffn.activation,
                           dtype, lead)
        segs.append({
            "ln1": init_rmsnorm(generator, d, dtype, lead),
            "attn": init_attention(generator, d, cfg.attention, dtype, lead),
            "ln2": init_rmsnorm(generator, d, dtype, lead),
            "ffn": ffn,
        })
    params["segments"] = segs
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None,
               swa_ring: bool = False, ring_headroom: int = 128) -> Dict:
    """Pre-allocated dense decode cache: per attention segment, (layers,
    batch, max_len, kv, dh) K and V (MLA: the latent and rotary key); per
    SSM segment, (layers, batch, d_conv-1, di) conv history in ``dtype``
    and (layers, batch, di, ds) f32 ssm state.

    ``swa_ring``: a sliding-window model allocates an O(window) RING
    buffer of window + ``ring_headroom`` decode positions, rounded up to
    16 and capped at ``max_len``, instead of O(max_len) — pair it with
    ``forward(..., swa_ring=True)``."""
    check_ported(cfg)
    dev = resolve_device(device)
    a = cfg.attention
    attn_len = max_len
    if swa_ring and a is not None and a.kind == "swa" and a.window:
        attn_len = min(max_len, (a.window + ring_headroom + 15) // 16 * 16)
    return {"segments": [
        init_mamba1_state(batch, cfg.d_model, cfg.ssm, dtype, dev, (count,))
        if kind == LAYER_SSM else
        init_kv_cache(batch, attn_len, a, dtype, dev, (count,))
        for kind, count in make_segments(cfg)]}


def init_paged_cache(cfg: ArchConfig, n_phys: int, block_size: int,
                     dtype=torch.bfloat16, device: DeviceLike = None) -> Dict:
    """Paged decode state: every layer owns an (n_phys, block_size, kv,
    dh) K and V pool (MLA: (n_phys, block_size, ·) latent and rotary-key
    pools); all layers share one logical block layout (the per-slot
    block tables of ``serving.paged``).  Paging covers K/V only: a model
    with recurrent state has no sequence axis to page."""
    check_ported(cfg)
    if has_ssm(cfg):
        raise ValueError("paged KV cache supports attention-only "
                         f"architectures; {cfg.name} has SSM segments")
    dev = resolve_device(device)
    return {"segments": [
        init_kv_cache(n_phys, block_size, cfg.attention, dtype, dev,
                      (count,))
        for _, count in make_segments(cfg)]}


# ===========================================================================
# Forward
# ===========================================================================

def _ffn_apply(lp, cfg: ArchConfig, h: Tensor, use_kernel: bool,
               routing_override) -> Tuple[Tensor, Optional[Tensor]]:
    """(out, aux loss); a dense FFN has no aux loss (None)."""
    if cfg.ffn.kind == "moe":
        return moe_ffn(lp["ffn"], cfg.ffn, h,
                       routing_override=routing_override,
                       use_kernel=use_kernel)
    return mlp(lp["ffn"], h, cfg.ffn.activation), None


def _attn_layer(lp, cfg: ArchConfig, x: Tensor, positions, cache, cache_len,
                mode: str, use_kernel: bool, block_tables, routing_override,
                swa_ring: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        att, _ = attention_decode(lp["attn"], cfg.attention, h, cache,
                                  cache_len, cfg.rope_theta, use_kernel,
                                  swa_ring, block_tables=block_tables)
    else:
        att, _ = attention_full(lp["attn"], cfg.attention, h, positions,
                                cfg.rope_theta, build_cache=cache,
                                cache_len=0)
    x = x + att
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    ff, aux = _ffn_apply(lp, cfg, h2, use_kernel, routing_override)
    return x + ff, aux


def _ssm_layer(lp, cfg: ArchConfig, x: Tensor, state: Optional[Dict],
               use_kernel: bool) -> Tuple[Tensor, Optional[Dict]]:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    out, new_state = mamba1_block(lp["ssm"], cfg.ssm, h, state, use_kernel)
    return x + out, new_state


def _ssm_segment(sp: Dict, sc: Optional[Dict], count: int, cfg: ArchConfig,
                 x: Tensor, mode: str, use_kernel: bool
                 ) -> Tuple[Tensor, Optional[Dict]]:
    """Run an SSM segment's layers; returns (x, the segment's new stacked
    state) — the state given is read, not written.  Prefill starts every
    layer from a zero state."""
    states = []
    for i in range(count):
        state = None if sc is None else _layer(sc, i)
        if state is not None and mode == "prefill":
            state = {k: torch.zeros_like(v) for k, v in state.items()}
        x, new_state = _ssm_layer(_layer(sp, i), cfg, x, state, use_kernel)
        states.append(new_state)
    if sc is None:
        return x, None
    return x, {k: torch.stack([st[k] for st in states]) for k in sc}


def forward(params, cfg: ArchConfig, inputs: Dict, *, mode: str = "train",
            cache: Optional[Dict] = None, cache_len=0,
            use_kernel: bool = False, block_tables: Optional[Tensor] = None,
            routing_override=None, swa_ring: bool = False,
            ) -> Tuple[Tensor, Optional[Dict], Tensor, Tensor]:
    """Returns (logits, new_cache, moe_aux_loss, hidden), as the
    reference; the aux loss is summed over the MoE layers.

    Attention caches are updated in place and reappear in ``new_cache``;
    SSM segments get NEW stacked states there (the given cache's states
    are left as they were).  ``block_tables`` (b,
    max_blocks) int32 switches decode-mode attention onto the PAGED pool
    (``init_paged_cache``) with a (b,) ``cache_len``.
    ``routing_override`` (idx (T, k), weights (T, k)) fixes every MoE
    layer's routing (the paper's controlled patterns).  ``swa_ring``
    decodes a sliding-window model over the ring buffer of
    ``init_cache(swa_ring=True)`` (dense cache, scalar ``cache_len``).
    ``hidden`` is the final-norm output (b, s, d) the LM head reads.
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
    auxes = []
    new_segments = []
    for si, (kind, count) in enumerate(make_segments(cfg)):
        sp = params["segments"][si]
        sc = None if cache is None else cache["segments"][si]
        if kind == LAYER_SSM:
            x, sc = _ssm_segment(sp, sc, count, cfg, x, mode, use_kernel)
            new_segments.append(sc)
            continue
        new_segments.append(sc)
        for i in range(count):
            x, layer_aux = _attn_layer(
                _layer(sp, i), cfg, x, positions,
                None if sc is None else _layer(sc, i), cache_len, mode,
                use_kernel, block_tables, routing_override, swa_ring)
            if layer_aux is not None:
                auxes.append(layer_aux)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed_tied(params["embed"], x)
    else:
        logits = lm_head(params["lm_head"], x)
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    new_cache = None if cache is None else {"segments": new_segments}
    return logits, new_cache, aux, x
