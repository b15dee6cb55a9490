"""Deterministic roofline + granularity latency simulator.

A copy of the reference's framework-free ``core.simulate``: per module
``T = max(FLOPs/phi, bytes/beta)`` (Eq. 5-6 rooflines) plus a launch
floor, where FLOPs are the *physical padded* FLOPs of the same
block-selection rules the kernels use (``core.granularity``).  Summing
modules is the paper's sequential-execution assumption (Sec. 4).

In the port it serves as
  1. the latency source of ``autotune.calibrate_specs`` on a host
     without a card (deterministic T(N) curves on any ``HardwareSpec``),
  2. the simulated step clock of a trace replay (``launch.serve --trace
     ... --trace-clock simulated``), which makes a replay deterministic.
It is a model: a time it gives is never a measurement of the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.arch import (LAYER_ATTN, LAYER_HYBRID, LAYER_SSM, ArchConfig)
from repro_torch.core.granularity import (GranularitySpec, cdiv, moe_padded_tokens,
                                    mxu_padded_rows, round_up,
                                    select_q_block, select_scan_chunk,
                                    select_token_block)
from repro_torch.core.hardware import BYTES_BF16, HardwareSpec
from repro_torch.core.nfp import ETA_COMBINE


# Per-module launch/dispatch floor (kernel launch + DMA warmup).  Matches
# the paper's observation that sub-ms module latencies sit on an overhead
# floor (App. I footnote on FlashInfer short-L noise).
MODULE_OVERHEAD_S = 5e-6


@dataclass
class ModuleCost:
    name: str
    flops: float            # physical (padded) FLOPs
    logical_flops: float    # algorithmic FLOPs (no padding)
    bytes: float            # HBM traffic (block-quantized for kernels)

    def time(self, hw: HardwareSpec) -> float:
        return MODULE_OVERHEAD_S + max(self.flops / hw.phi,
                                       self.bytes / hw.beta)

    def bound(self, hw: HardwareSpec) -> str:
        return "compute" if self.flops / hw.phi >= self.bytes / hw.beta else "memory"


@dataclass
class ForwardCost:
    modules: List[ModuleCost]

    def time(self, hw: HardwareSpec) -> float:
        return sum(m.time(hw) for m in self.modules)

    @property
    def flops(self) -> float:
        return sum(m.flops for m in self.modules)

    @property
    def logical_flops(self) -> float:
        return sum(m.logical_flops for m in self.modules)

    @property
    def bytes(self) -> float:
        return sum(m.bytes for m in self.modules)

    def limiting_module(self, hw: HardwareSpec) -> str:
        return max(self.modules, key=lambda m: m.time(hw)).name


# ===========================================================================
# Per-module cost builders (decode forward: b requests x N positions over a
# cache of length L).  s = bf16 bytes.
# ===========================================================================

def _gemm_module(name: str, rows: int, params: int, s: int,
                 pad_rows: Optional[int] = None) -> ModuleCost:
    """Weight-stationary GEMM: FLOPs = 2*rows*params, traffic ~= weights."""
    prows = pad_rows if pad_rows is not None else mxu_padded_rows(rows, s)
    return ModuleCost(
        name=name,
        flops=2.0 * prows * params,
        logical_flops=2.0 * rows * params,
        bytes=float(params) * s + 2.0 * rows * s,  # weights + tiny act r/w
    )


def attention_core_cost(cfg: ArchConfig, b: int, n: int, ell: int,
                        gran: GranularitySpec, s: int = BYTES_BF16) -> ModuleCost:
    """Work quantization (paper App. F): every executed q tile streams the
    WHOLE KV cache through VMEM — so both FLOPs and KV traffic scale with
    ceil(N/q_block), which is what makes the latency staircase survive in
    the memory-bound regime (Fig. 3a)."""
    a = cfg.attention
    ell_eff = min(ell, a.window) if (a.kind == "swa" and a.window) else ell
    d_qk, d_v = a.score_dims
    qb = select_q_block(n, a.head_dim, gran.attn_policy)
    n_tiles = cdiv(n, qb)
    n_pad = n_tiles * qb
    flops = 2.0 * b * n_pad * ell_eff * a.n_heads * (d_qk + d_v)
    logical = 2.0 * b * n * ell_eff * a.n_heads * (d_qk + d_v)
    kv_bytes = b * n_tiles * (ell_eff + n) * a.kv_cache_bytes_per_token
    qo_bytes = b * n * a.n_heads * (d_qk + d_v) * s
    return ModuleCost("attn_core", flops, logical, kv_bytes + qo_bytes)


def attention_proj_cost(cfg: ArchConfig, b: int, n: int,
                        s: int = BYTES_BF16) -> ModuleCost:
    params = cfg._attn_params()
    return _gemm_module("attn_proj", b * n, params, s)


def dense_ffn_cost(cfg: ArchConfig, b: int, n: int,
                   s: int = BYTES_BF16) -> ModuleCost:
    mats = 3 if cfg.ffn.activation == "swiglu" else 2
    params = mats * cfg.d_model * cfg.ffn.d_ff
    return _gemm_module("dense_ffn", b * n, params, s)


def moe_ffn_cost(cfg: ArchConfig, b: int, n: int, gran: GranularitySpec,
                 routing: str = "balanced", s: int = BYTES_BF16,
                 eta: int = ETA_COMBINE) -> ModuleCost:
    """Work quantization (paper App. E): the kernel config (token_block) is
    selected from the TOKEN count (vLLM Table 8: M <= E branch), and every
    executed token-block re-reads its expert's full weights — both FLOPs
    and weight traffic are staircases in ceil(m_e / token_block)."""
    f = cfg.ffn
    e, k = f.n_experts, f.top_k
    t = b * n                         # logical tokens
    total_slots = t * k
    if routing == "balanced":
        basen = total_slots // e
        rem = total_slots % e
        tokens_per_expert = [basen + (1 if i < rem else 0) for i in range(e)]
    else:                             # skewed: all tokens on the same k experts
        tokens_per_expert = [t] * k + [0] * (e - k)
    tb = select_token_block(t, e)     # tau branch keys on tokens (Table 8)
    padded = moe_padded_tokens(tokens_per_expert, tb)
    n_blocks = padded // tb if tb else 0
    e_act = sum(1 for x in tokens_per_expert if x > 0)
    mats = 3 if f.activation == "swiglu" else 2
    per_expert_params = mats * cfg.d_model * f.d_ff
    flops = 2.0 * padded * per_expert_params
    logical = 2.0 * total_slots * per_expert_params
    if t <= e:
        # decode regime (small-M branch): the block-major grouped kernel —
        # every token-block streams its expert's full weights (no reuse
        # across parallel compute units); this is the traffic staircase
        # behind the paper's memory-bound MoE latency steps.
        w_bytes = float(n_blocks) * per_expert_params * s
    else:
        # train/prefill regime (large-M branch): weight-stationary grouped
        # GEMM (ragged_dot) — weights stream once per active expert.
        w_bytes = float(e_act) * per_expert_params * s
    a_bytes = t * cfg.d_model * s * (1 + 3 * k + eta * k)   # Eq. 17
    return ModuleCost("moe_ffn", flops, logical, w_bytes + a_bytes)


def ssm_cost(cfg: ArchConfig, b: int, n: int, gran: GranularitySpec,
             s: int = BYTES_BF16) -> ModuleCost:
    m = cfg.ssm
    d = cfg.d_model
    di = m.d_inner(d)
    params = cfg._ssm_params()
    chunk = select_scan_chunk(n)
    n_pad = round_up(n, chunk)
    proj_flops = 2.0 * b * n_pad * params
    rec_flops = 6.0 * b * n_pad * di * m.d_state   # recurrence (no weights)
    logical = 2.0 * b * n * params + 6.0 * b * n * di * m.d_state
    # weights once + state read/write once per forward
    state_bytes = 2.0 * b * di * m.d_state * 4     # f32 state
    return ModuleCost("ssm", proj_flops + rec_flops, logical,
                      params * s + state_bytes)


def lm_head_cost(cfg: ArchConfig, b: int, n: int,
                 s: int = BYTES_BF16) -> ModuleCost:
    params = cfg.d_model * cfg.vocab_size
    return _gemm_module("lm_head", b * n, params, s)


def embed_cost(cfg: ArchConfig, b: int, n: int,
               s: int = BYTES_BF16) -> ModuleCost:
    byt = b * n * cfg.d_model * s * 2
    return ModuleCost("embed", 0.0, 0.0, byt)


# ===========================================================================
# Full decode forward
# ===========================================================================

def decode_forward_cost(cfg: ArchConfig, b: int, n: int, ell: int,
                        gran: Optional[GranularitySpec] = None,
                        routing: str = "balanced") -> ForwardCost:
    """Cost of one multi-position decode forward: N positions per request,
    batch b, cache length L.  Modules execute sequentially (paper Sec. 4)."""
    if gran is None:
        head_dim = cfg.attention.head_dim if cfg.attention else 128
        gran = GranularitySpec.for_backend(cfg.ffn.n_experts,
                                           head_dim=head_dim)
    mods: List[ModuleCost] = [embed_cost(cfg, b, n)]
    agg: Dict[str, ModuleCost] = {}

    def add(mc: ModuleCost):
        if mc.name in agg:
            prev = agg[mc.name]
            prev.flops += mc.flops
            prev.logical_flops += mc.logical_flops
            prev.bytes += mc.bytes
        else:
            agg[mc.name] = mc

    for kind in cfg.pattern():
        if kind in (LAYER_ATTN, LAYER_HYBRID):
            add(attention_proj_cost(cfg, b, n))
            add(attention_core_cost(cfg, b, n, ell, gran))
        if kind == LAYER_ATTN:
            if cfg.ffn.kind == "dense":
                add(dense_ffn_cost(cfg, b, n))
            elif cfg.ffn.kind == "moe":
                add(moe_ffn_cost(cfg, b, n, gran, routing))
        if kind in (LAYER_SSM, LAYER_HYBRID):
            add(ssm_cost(cfg, b, n, gran))
    mods.extend(agg.values())
    mods.append(lm_head_cost(cfg, b, n))
    return ForwardCost(mods)


def attention_full_cost(cfg: ArchConfig, b: int, s: int,
                        dtype_bytes: int = BYTES_BF16) -> ModuleCost:
    """Full causal self-attention over s positions (train / prefill):
    score+AV FLOPs ~ b*s^2/2; IO ~ activations (flash-style, no s^2
    materialization)."""
    a = cfg.attention
    d_qk, d_v = a.score_dims
    if a.kind == "swa" and a.window and a.window < s:
        # windowed: each query sees at most `window` keys
        flops = 2.0 * b * s * a.window * a.n_heads * (d_qk + d_v)
    else:
        # causal: sum_{q=1..s} q = s(s+1)/2 key positions
        flops = 1.0 * b * s * (s + 1) * a.n_heads * (d_qk + d_v)
    io = b * s * (a.kv_cache_bytes_per_token
                  + 2 * a.n_heads * (d_qk + d_v) * dtype_bytes)
    return ModuleCost("attn_core", flops, flops, io)


def full_forward_cost(cfg: ArchConfig, b: int, s: int,
                      gran: Optional[GranularitySpec] = None,
                      routing: str = "balanced") -> ForwardCost:
    """One full-sequence forward (prefill / the forward half of a train
    step): b sequences of s tokens."""
    if gran is None:
        head_dim = cfg.attention.head_dim if cfg.attention else 128
        gran = GranularitySpec.for_backend(cfg.ffn.n_experts,
                                           head_dim=head_dim)
    mods: List[ModuleCost] = [embed_cost(cfg, b, s)]
    agg: Dict[str, ModuleCost] = {}

    def add(mc: ModuleCost):
        if mc.name in agg:
            prev = agg[mc.name]
            prev.flops += mc.flops
            prev.logical_flops += mc.logical_flops
            prev.bytes += mc.bytes
        else:
            agg[mc.name] = mc

    for kind in cfg.pattern():
        if kind in (LAYER_ATTN, LAYER_HYBRID):
            add(attention_proj_cost(cfg, b, s))
            add(attention_full_cost(cfg, b, s))
        if kind == LAYER_ATTN:
            if cfg.ffn.kind == "dense":
                add(dense_ffn_cost(cfg, b, s))
            elif cfg.ffn.kind == "moe":
                add(moe_ffn_cost(cfg, b, s, gran, routing))
        if kind in (LAYER_SSM, LAYER_HYBRID):
            add(ssm_cost(cfg, b, s, gran))
    mods.extend(agg.values())
    mods.append(lm_head_cost(cfg, b, s))
    return ForwardCost(mods)


def train_step_cost(cfg: ArchConfig, global_batch: int, seq: int,
                    gran: Optional[GranularitySpec] = None,
                    remat: bool = True, n_micro: int = 1,
                    s: int = BYTES_BF16) -> ForwardCost:
    """One optimizer step: fwd + bwd (+ remat recompute) + AdamW update.

    FLOPs: bwd ~= 2x fwd; remat re-runs the fwd during bwd -> 4x total.
    Bytes: per microbatch the weights stream once fwd + twice bwd (dgrad +
    wgrad reads), activations ~2x fwd IO; optimizer adds f32 master/m/v
    read+write (24 B/param) + f32 grads (8 B/param).
    """
    fwd = full_forward_cost(cfg, global_batch, seq, gran)
    mult = 4.0 if remat else 3.0
    params = cfg.param_count()
    weight_bytes = params * s
    opt_bytes = params * (24.0 + 8.0)
    mods = [ModuleCost(m.name, m.flops * mult, m.logical_flops * mult,
                       m.bytes * 3.0) for m in fwd.modules]
    # optimizer update flops ~ 10 flops/param
    mods.append(ModuleCost("adamw", 10.0 * params, 10.0 * params,
                           opt_bytes))
    # extra weight re-reads across microbatches (beyond the 3x above)
    if n_micro > 1:
        mods.append(ModuleCost("microbatch_weight_restream", 0.0, 0.0,
                               (n_micro - 1) * 3.0 * weight_bytes))
    return ForwardCost(mods)


def latency_curve(cfg: ArchConfig, hw: HardwareSpec, b: int, ell: int,
                  n_values, gran: Optional[GranularitySpec] = None,
                  routing: str = "balanced") -> List[Tuple[int, float]]:
    """Simulated T(N) sweep."""
    return [(int(n), decode_forward_cost(cfg, b, int(n), ell, gran, routing)
             .time(hw)) for n in n_values]


def module_latency_curve(module_fn, hw: HardwareSpec, n_values) -> List[Tuple[int, float]]:
    """T(N) sweep for a single module-cost builder (module-level analysis)."""
    return [(int(n), module_fn(int(n)).time(hw)) for n in n_values]
