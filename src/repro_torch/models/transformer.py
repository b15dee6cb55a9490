"""Model assembly: attention segments (dense or MoE FFN), SSM segments
(Mamba1 or Mamba2), hybrid segments (a Mamba2 block then ONE shared
attention + MLP block, zamba2-style) and the whisper-style encoder with
the decoder's cross-attention.

Layers are grouped into *segments* of identical kind, and each segment's
parameters and cache are STACKED along a leading layer axis, exactly as
the reference lays out its pytree (so ``bridge.params_from_jax`` maps one
onto the other leaf for leaf).  Where the reference runs ``lax.scan``
over the stacked leaves, the port runs a Python loop over layer views of
the same tensors.  Attention caches are written in place through those
views; SSM states are not: each SSM segment's new state (and each hybrid
segment's ``ssm_state``) is a new stacked tensor in the returned cache,
for the engine to commit per row, while a hybrid segment's ``attn`` K/V
are written in place like any attention cache.

Modes:
  train   — full causal self-attention, no cache.
  prefill — same math, fills the cache from position 0: attention writes
            its K/V from position 0 and SSM layers (hybrid ones included)
            start from a ZERO state (whatever the cache held), so a reused
            cache row cannot leak an earlier request's recurrent state
            into the prompt.
  decode  — the multi-position decode forward (Eq. 2): N new positions
            against a cache of length ``cache_len``.
The FFN is a dense MLP or the MoE FFN (``models.moe``); ``use_kernel``
reaches the MoE FFN and the Mamba1 selective scan in every mode and GQA /
SWA attention in decode mode, the hybrid layers' shared attention
included (prefill attention, MLA, Mamba2, the encoder and cross-attention
have no kernel, as in the reference).  Attention is GQA, sliding-window
GQA (optionally decoding over an O(window) ring buffer, ``swa_ring``) or
MLA.

A model with an encoder (whisper) takes ``inputs["frames"]``, the stub
frontend's (b, F, d) frame embeddings, and encodes them on EVERY call,
decode included; every decoder layer projects the memory's cross K/V
again.  Nothing of the memory is cached, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.arch import (LAYER_ATTN, LAYER_HYBRID, LAYER_SSM,
                                   ArchConfig)
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.dist import layer_gather as lg
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels.decode_attention.ops import row_lens
from repro_torch.models.attention import (attention_decode, attention_full,
                                          cross_attention, encode_cross_kv,
                                          init_attention, init_kv_cache,
                                          init_paged_kv_cache)
from repro_torch.models.layers import (embed, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm, lm_head, mlp,
                                       rmsnorm, unembed_tied)
from repro_torch.models.mamba import (init_mamba1, init_mamba1_state,
                                      init_mamba2, init_mamba2_state,
                                      mamba1_block, mamba2_block)
from repro_torch.models.moe import init_moe, moe_ffn, route

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


def segment_states(kind: str, seg: Dict) -> Optional[Dict]:
    """The recurrent-state leaves of a segment's cache, (layers, batch,
    ...): all of an SSM segment's, a hybrid segment's ``ssm_state``, none
    of an attention segment's."""
    if kind == LAYER_SSM:
        return seg
    if kind == LAYER_HYBRID:
        return seg["ssm_state"]
    return None


def segment_kv(kind: str, seg: Dict) -> Optional[Dict]:
    """The K/V leaves of a segment's dense cache, (layers, batch, seq,
    ...): all of an attention segment's, a hybrid segment's ``attn``, none
    of an SSM segment's."""
    if kind == LAYER_ATTN:
        return seg
    if kind == LAYER_HYBRID:
        return seg["attn"]
    return None


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s view of a stacked segment tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: Dict, count: int) -> List[Dict]:
    """Every layer's view of a stacked segment tree, one ``unbind`` per
    leaf.  Under autograd a stacked leaf's gradient is then ONE stack of
    its layers' gradients; indexing each layer (``_layer``) would make a
    zero-filled gradient of the whole stack per layer."""
    out: List[Dict] = [{} for _ in range(count)]
    for k, v in tree.items():
        parts = _unstack(v, count) if isinstance(v, dict) else v.unbind(0)
        for lp, part in zip(out, parts):
            lp[k] = part
    return out


def remat_count(remat, count: int) -> int:
    """How many leading layers of a ``count``-layer segment ``remat``
    (False / True / a fraction in (0, 1)) recomputes in the backward
    pass: round(frac * count), Python's round (half to even)."""
    frac = 1.0 if remat is True else 0.0 if remat is False else float(remat)
    return int(round(frac * count))


def _call(fn, remat_layer: bool, *args, plans=None):
    """``fn(*args)``, under activation checkpointing where
    ``remat_layer``: the layer's activations are not kept for the
    backward pass but recomputed there (same values).  ``plans``: one
    ``layer_gather`` plan subtree (or None) per leading argument, whose
    params are gathered inside the call; without remat, autograd keeps
    the gathered leaves as their local slices (``layer_gather.saving``)."""
    if plans is not None and all(p is None for p in plans):
        plans = None
    if plans is not None:
        fn = lg.gathered(fn, plans)
    if remat_layer:
        # the forward draws no random numbers: the recompute needs no
        # saved RNG state, and a captured train step reads none
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    if plans is None:
        return fn(*args)
    with lg.saving():
        return fn(*args)


# ===========================================================================
# Init
# ===========================================================================

def _init_segment(gen: torch.Generator, cfg: ArchConfig, kind: str,
                  count: int, dtype) -> Dict:
    """One segment's stacked layers, with the reference's leaves."""
    d, lead = cfg.d_model, (count,)
    p: Dict = {"ln1": init_rmsnorm(gen, d, dtype, lead)}
    if kind != LAYER_ATTN:
        init = init_mamba1 if cfg.ssm.kind == "mamba1" else init_mamba2
        p["ssm"] = init(gen, d, cfg.ssm, dtype, lead)
        if kind == LAYER_HYBRID:
            p["ln_shared"] = init_rmsnorm(gen, d, dtype, lead)
        return p
    # the FFN is drawn before the attention: the seeded random weights of
    # the chip checks, and the numbers recorded for them, follow this order
    if cfg.ffn.kind == "moe":
        p["ffn"] = init_moe(gen, d, cfg.ffn, dtype, lead)
    elif cfg.ffn.kind == "dense":
        p["ffn"] = init_mlp(gen, d, cfg.ffn.d_ff, cfg.ffn.activation, dtype,
                            lead)
    p["attn"] = init_attention(gen, d, cfg.attention, dtype, lead)
    p["ln2"] = init_rmsnorm(gen, d, dtype, lead)
    if cfg.encoder is not None:            # whisper decoder: cross-attention
        p["ln_cross"] = init_rmsnorm(gen, d, dtype, lead)
        p["cross"] = init_attention(gen, d, cfg.attention, dtype, lead)
    return p


def init_model(cfg: ArchConfig, generator: torch.Generator,
               device: DeviceLike = None, dtype=torch.bfloat16) -> Dict:
    """Random parameters with the reference's structure and scales, drawn
    from ``generator`` directly on ``device`` (the generator must live
    there): the stacked segments, the hybrid models' ``shared_attn``
    (attention, ``ln2`` and an MLP of ``d_ff`` or 4·d) and the encoder
    (stacked layers and its final norm)."""
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
    params["segments"] = [_init_segment(generator, cfg, kind, count, dtype)
                          for kind, count in make_segments(cfg)]
    if cfg.shared_attention:
        params["shared_attn"] = {
            "attn": init_attention(generator, d, cfg.attention, dtype),
            "ln2": init_rmsnorm(generator, d, dtype),
            "ffn": init_mlp(generator, d, cfg.ffn.d_ff or 4 * d,
                            cfg.ffn.activation, dtype),
        }
    if cfg.encoder is not None:
        lead = (cfg.encoder.n_layers,)
        params["encoder"] = {
            "layers": {
                "ln1": init_rmsnorm(generator, d, dtype, lead),
                "attn": init_attention(generator, d, cfg.attention, dtype,
                                       lead),
                "ln2": init_rmsnorm(generator, d, dtype, lead),
                "ffn": init_mlp(generator, d, cfg.ffn.d_ff,
                                cfg.ffn.activation, dtype, lead),
            },
            "final_norm": init_rmsnorm(generator, d, dtype),
        }
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None,
               swa_ring: bool = False, ring_headroom: int = 128) -> Dict:
    """Pre-allocated dense decode cache: per attention segment, (layers,
    batch, max_len, kv, dh) K and V (MLA: the latent and rotary key); per
    SSM segment, the stacked zero state of its block (conv histories in
    ``dtype``, the ssm state f32); per hybrid segment ``{"ssm_state":
    that state, "attn": K and V of max_len}``.

    ``swa_ring``: a sliding-window model allocates an O(window) RING
    buffer of window + ``ring_headroom`` decode positions, rounded up to
    16 and capped at ``max_len``, instead of O(max_len) — pair it with
    ``forward(..., swa_ring=True)``.  A hybrid segment's K/V keep
    max_len, as in the reference."""
    dev = resolve_device(device)
    a = cfg.attention
    attn_len = max_len
    if swa_ring and a is not None and a.kind == "swa" and a.window:
        attn_len = min(max_len, (a.window + ring_headroom + 15) // 16 * 16)
    segs = []
    for kind, count in make_segments(cfg):
        lead = (count,)
        if kind == LAYER_ATTN:
            segs.append(init_kv_cache(batch, attn_len, a, dtype, dev, lead))
            continue
        init = (init_mamba1_state if cfg.ssm.kind == "mamba1"
                else init_mamba2_state)
        state = init(batch, cfg.d_model, cfg.ssm, dtype, dev, lead)
        segs.append(state if kind == LAYER_SSM else {
            "ssm_state": state,
            "attn": init_kv_cache(batch, max_len, a, dtype, dev, lead)})
    return {"segments": segs}


def init_paged_cache(cfg: ArchConfig, n_phys: int, block_size: int,
                     dtype=torch.bfloat16, device: DeviceLike = None) -> Dict:
    """Paged decode state: every layer owns an (n_phys, block_size, kv,
    dh) K and V pool (MLA: (n_phys, block_size, ·) latent and rotary-key
    pools); all layers share one logical block layout (the per-slot
    block tables of ``serving.paged``).  Paging covers K/V only: a model
    with recurrent state has no sequence axis to page."""
    if has_ssm(cfg):
        raise ValueError("paged KV cache supports attention-only "
                         f"architectures; {cfg.name} has SSM segments")
    dev = resolve_device(device)
    return {"segments": [
        init_paged_kv_cache(n_phys, block_size, cfg.attention, dtype, dev,
                            (count,))
        for _, count in make_segments(cfg)]}


# ===========================================================================
# Forward
# ===========================================================================

def _ffn_apply(lp, cfg: ArchConfig, h: Tensor, use_kernel: bool,
               routing_override) -> Tuple[Tensor, Optional[Tensor]]:
    """(out, aux loss); a dense FFN has no aux loss (None), and a layer
    without an FFN adds zeros, as the reference's.  Under a model group
    whose plan splits the FFN, each rank computes its ``d_ff`` columns
    (every expert's) and the partial outputs are summed; the router runs
    whole on every rank, outside the split, so its aux loss is the
    unsplit one."""
    if cfg.ffn.kind == "none":
        return torch.zeros_like(h), None
    if cfg.ffn.kind == "dense":
        return _mlp_block(cfg, "ffn", lp["ffn"], h), None
    if tp.mode(cfg, "ffn") != tp.TP:
        return moe_ffn(lp["ffn"], cfg.ffn, h,
                       routing_override=routing_override,
                       use_kernel=use_kernel)
    f = tp.local_ffn(cfg.ffn, tp.current().size)
    hc = tp.copy_to_model(h)
    if routing_override is None:
        weights, idx, aux = route(lp["ffn"], f, h.reshape(-1, h.shape[-1]))
        routing_override = (idx, tp.copy_to_model(weights))
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    out, _ = moe_ffn(lp["ffn"], f, hc, routing_override=routing_override,
                     use_kernel=use_kernel)
    return tp.reduce_from_model(out), aux


def _attention_body(cfg: ArchConfig, positions, cache_len, mode: str,
                    use_kernel: bool, block_tables=None,
                    swa_ring: bool = False, causal: bool = True):
    """The attention body ``(params, spec, h, cache) -> (out, cache)`` of
    ``mode`` (``tensor_parallel.attention`` calls it on a local spec)."""
    if mode == "decode":
        return lambda p, a, h, c: attention_decode(
            p, a, h, c, cache_len, cfg.rope_theta, use_kernel, swa_ring,
            block_tables=block_tables)
    return lambda p, a, h, c: attention_full(
        p, a, h, positions, cfg.rope_theta, build_cache=c, cache_len=0,
        causal=causal)


def _attn_layer(lp, cfg: ArchConfig, x: Tensor, positions, cache, cache_len,
                mode: str, use_kernel: bool, block_tables, routing_override,
                memory: Optional[Tensor], swa_ring: bool = False,
                cache_dims=None) -> Tuple[Tensor, Optional[Tensor]]:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + tp.attention(tp.mode(cfg, "attn"), cfg.attention,
                         _attention_body(cfg, positions, cache_len, mode,
                                         use_kernel, block_tables, swa_ring),
                         lp["attn"], h, cache, cache_dims,
                         (mode, cache_len, swa_ring))
    if memory is not None and "cross" in lp:
        hc = rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
        how = tp.mode(cfg, "cross")
        mem = memory if how == tp.GATHERED else tp.copy_to_model(memory)

        def cross(p, a, q, _):
            ck, cv = encode_cross_kv(p, a, mem)
            return cross_attention(p, a, q, ck, cv), None
        x = x + tp.attention(how, cfg.attention, cross, lp["cross"], hc)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    ff, aux = _ffn_apply(lp, cfg, h2, use_kernel, routing_override)
    return x + ff, aux


def _ssm_layer(lp, cfg: ArchConfig, x: Tensor, state: Optional[Dict],
               use_kernel: bool) -> Tuple[Tensor, Optional[Dict]]:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.ssm.kind == "mamba1":
        out, new_state = mamba1_block(lp["ssm"], cfg.ssm, h, state,
                                      use_kernel)
    else:
        out, new_state = mamba2_block(lp["ssm"], cfg.ssm, h, state)
    return x + out, new_state


def _mlp_block(cfg: ArchConfig, block: str, params: Dict, h: Tensor
               ) -> Tensor:
    """A dense MLP, on this rank's ``d_ff`` columns when the plan splits
    ``block``."""
    if tp.mode(cfg, block) != tp.TP:
        return mlp(params, h, cfg.ffn.activation)
    return tp.reduce_from_model(mlp(params, tp.copy_to_model(h),
                                    cfg.ffn.activation))


def _hybrid_layer(lp, shared, cfg: ArchConfig, x: Tensor, positions,
                  state: Optional[Dict], attn_cache: Optional[Dict],
                  cache_len, mode: str, use_kernel: bool, cache_dims=None
                  ) -> Tuple[Tensor, Optional[Dict]]:
    """The SSM block, then the ONE shared attention + MLP block on the
    layer's own ``ln_shared`` and its own K/V cache (written in place)."""
    x, new_state = _ssm_layer(lp, cfg, x, state, use_kernel)
    h = rmsnorm(lp["ln_shared"], x, cfg.norm_eps)
    x = x + tp.attention(tp.mode(cfg, "shared_attn"), cfg.attention,
                         _attention_body(cfg, positions, cache_len, mode,
                                         use_kernel),
                         shared["attn"], h, attn_cache, cache_dims,
                         (mode, cache_len, False))
    h2 = rmsnorm(shared["ln2"], x, cfg.norm_eps)
    return x + _mlp_block(cfg, "shared_ffn", shared["ffn"], h2), new_state


def _recurrent_segment(kind: str, sp: Dict, sc: Optional[Dict], count: int,
                       cfg: ArchConfig, shared: Optional[Dict], x: Tensor,
                       positions, cache_len, mode: str, use_kernel: bool,
                       n_remat: int = 0, cache_dims=None, plan=None
                       ) -> Tuple[Tensor, Optional[Dict]]:
    """Run an SSM or hybrid segment's layers; returns (x, the segment's
    new cache): new stacked states (the states given are read, not
    written) and, hybrid, the K/V given, written in place.  Prefill starts
    every layer from a zero state.  The first ``n_remat`` layers run under
    activation checkpointing (no cache only).  ``plan``: the segment's
    ``layer_gather`` plan (None: its params are used as given)."""
    states = []
    sp, plan = lg.stacks(sp, plan)
    plans = (plan,) if kind == LAYER_SSM else (plan, lg.sub("shared_attn"))
    for i, lp in enumerate(_unstack(sp, count)):
        lc = None if sc is None else _layer(sc, i)
        state = None if lc is None else segment_states(kind, lc)
        if state is not None and mode == "prefill":
            state = {k: torch.zeros_like(v) for k, v in state.items()}
        state, local_state = tp.gather_state(
            state, None if cache_dims is None
            else segment_states(kind, cache_dims))
        if kind == LAYER_SSM:
            x, new_state = _call(_ssm_layer, i < n_remat, lp, cfg, x, state,
                                 use_kernel, plans=plans)
        else:
            x, new_state = _call(
                _hybrid_layer, i < n_remat, lp, shared, cfg, x, positions,
                state, None if lc is None else lc["attn"], cache_len, mode,
                use_kernel, None if cache_dims is None
                else cache_dims["attn"], plans=plans)
        states.append(None if new_state is None else local_state(new_state))
    if sc is None:
        return x, None
    new = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    return x, new if kind == LAYER_SSM else {"ssm_state": new,
                                             "attn": sc["attn"]}


def _sinusoidal(positions: Tensor, d: int) -> Tensor:
    """(..., d) f32 sinusoidal embeddings of integer positions: sin over
    the first half, cos over the second."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, cfg: ArchConfig, frames: Tensor) -> Tensor:
    """The whisper-style encoder over stub frame embeddings (b, F, d):
    sinusoidal positions, then per layer rmsnorm, NON-causal attention
    (with rotary) and the MLP, then the encoder's final norm."""
    b, f, d = frames.shape
    pos = torch.arange(f, dtype=torch.int32,
                       device=frames.device)[None].expand(b, f)
    x = (frames.float() + _sinusoidal(pos, d)).to(frames.dtype)
    ep = params["encoder"]

    def layer(lp, x):
        def body(p, a, h, _):
            return attention_full(p, a, h, pos, cfg.rope_theta,
                                  causal=False)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + tp.attention(tp.mode(cfg, "encoder_attn"), cfg.attention,
                             body, lp["attn"], h)
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        return x + _mlp_block(cfg, "encoder_ffn", lp["ffn"], h2)
    layers, plan = lg.stacks(ep["layers"], lg.sub("encoder", "layers"))
    for lp in _unstack(layers, cfg.encoder.n_layers):
        x = _call(layer, False, lp, x, plans=(plan,))
    return _call(lambda p, x: rmsnorm(p, x, cfg.norm_eps), False,
                 ep["final_norm"], x,
                 plans=(lg.sub("encoder", "final_norm"),))


def _embed(ep: Dict, cfg: ArchConfig, tokens: Tensor) -> Tensor:
    if tp.mode(cfg, "embed") == tp.TP:
        return tp.embed(ep["table"], tokens)
    return embed(ep, tokens)


def _head(hp: Dict, cfg: ArchConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(logits, the final-norm output) from ``hp``: the final norm and the
    tied embedding or ``lm_head``."""
    x = rmsnorm(hp["final_norm"], x, cfg.norm_eps)
    if tp.mode(cfg, "head") == tp.TP:
        # this rank's block of the vocabulary's columns
        x = tp.copy_to_model(x)
    if cfg.tie_embeddings:
        return unembed_tied(hp["embed"], x), x
    return lm_head(hp["lm_head"], x), x


def forward(params, cfg: ArchConfig, inputs: Dict, *, mode: str = "train",
            cache: Optional[Dict] = None, cache_len=0,
            use_kernel: bool = False, block_tables: Optional[Tensor] = None,
            routing_override=None, swa_ring: bool = False, remat=False,
            ) -> Tuple[Tensor, Optional[Dict], Tensor, Tensor]:
    """Returns (logits, new_cache, moe_aux_loss, hidden), as the
    reference; the aux loss is summed over the MoE layers.

    Attention caches are updated in place and reappear in ``new_cache``;
    SSM segments (and hybrid segments' ``ssm_state``) get NEW stacked
    states there (the given cache's states are left as they were).
    ``block_tables`` (b,
    max_blocks) int32 switches decode-mode attention onto the PAGED pool
    (``init_paged_cache``) with a (b,) ``cache_len``.
    ``routing_override`` (idx (T, k), weights (T, k)) fixes every MoE
    layer's routing (the paper's controlled patterns).  ``swa_ring``
    decodes a sliding-window model over the ring buffer of
    ``init_cache(swa_ring=True)`` (dense cache, scalar ``cache_len``).
    ``hidden`` is the final-norm output (b, s, d) the LM head reads.
    inputs: {"tokens": (b, s) int} or {"embeds": (b, s, d)}; a model with
    an encoder adds {"frames": (b, F, d)}, whose encoding every call
    recomputes; its decoder positions are offset by ``cache_len`` in
    decode mode (a scalar or a (b,) vector).

    ``remat`` (False / True / a fraction in (0, 1)): without a cache, the
    first ``remat_count(remat, count)`` layers of each segment keep no
    activations for the backward pass and recompute them there
    (``torch.utils.checkpoint``); the values are unchanged.
    """
    if "embeds" in inputs:
        x = inputs["embeds"]
    else:
        x = _call(_embed, False, params["embed"], cfg, inputs["tokens"],
                  plans=(lg.sub("embed"),))
    b, s = x.shape[0], x.shape[1]
    memory = None
    if cfg.encoder is not None:
        if "frames" not in inputs:
            raise ValueError(f"{cfg.name} has an encoder: inputs need "
                             "'frames', its (b, F, d) frame embeddings")
        memory = encode(params, cfg, inputs["frames"])
        pos0 = row_lens(cache_len if mode == "decode" else 0, b, x.device)
        tok_pos = pos0[:, None] + torch.arange(s, dtype=torch.int32,
                                               device=x.device)[None]
        x = (x.float() + _sinusoidal(tok_pos, cfg.d_model)).to(x.dtype)
    positions = None
    if mode != "decode":
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    shared = params.get("shared_attn")
    auxes = []
    new_segments = []
    for si, (kind, count) in enumerate(make_segments(cfg)):
        sp = params["segments"][si]
        sc = None if cache is None else cache["segments"][si]
        cd = None if cache is None else tp.segment_cache_dims(si)
        n_remat = remat_count(remat, count) if cache is None else 0
        plan = lg.sub("segments", si)
        if kind != LAYER_ATTN:
            x, sc = _recurrent_segment(kind, sp, sc, count, cfg, shared, x,
                                       positions, cache_len, mode,
                                       use_kernel, n_remat, cd, plan)
            new_segments.append(sc)
            continue
        new_segments.append(sc)
        sp, plan = lg.stacks(sp, plan)
        for i, lp in enumerate(_unstack(sp, count)):
            x, layer_aux = _call(
                _attn_layer, i < n_remat, lp, cfg, x, positions,
                None if sc is None else _layer(sc, i), cache_len, mode,
                use_kernel, block_tables, routing_override, memory, swa_ring,
                cd, plans=(plan,))
            if layer_aux is not None:
                auxes.append(layer_aux)
    head = {k: params[k] for k in ("final_norm", "embed" if
                                   cfg.tie_embeddings else "lm_head")}
    logits, x = _call(_head, False, head, cfg, x,
                      plans=(None if lg.current() is None else
                             {k: lg.sub(k) for k in head},))
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    new_cache = None if cache is None else {"segments": new_segments}
    return logits, new_cache, aux, x
