"""Near-Free Parallelism: idle-compute baselines and the NFP principle —
a copy of the reference ``core.nfp``, the paper's equations verbatim:

  Eq. 5   AI(N) = C(N)/B(N),  rho = phi/beta
  Eq. 8/9    Dense FFN:  AI = 2bN/s          -> N_idle = rho*s/(2b)
  Eq. 18/19  MoE FFN  (eta = 2 combine accesses)
  Eq. 21/22  Attention (KV-cache dominated)
  Eq. 12     dense model principle:   min(rho*s/2b, M_attn)
  Eq. 13     MoE balanced principle:  min(M_moe*E/k, tau, M_attn)
  Eq. 14     MoE skewed principle:    min(M_moe, M_attn)

plus the reference's extensions: the generalized attention term for GQA
/ MLA / SWA geometries, an SSM idle-compute term, and the model-level
composition over an ArchConfig (first-exiting-module min) that
``parallelism_budget`` reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.core.arch import (LAYER_ATTN, LAYER_HYBRID, LAYER_SSM,
                                   ArchConfig, AttentionSpec)
from repro_torch.core.granularity import GranularitySpec, kv_padded_len
from repro_torch.core.hardware import BYTES_BF16, HardwareSpec

ETA_COMBINE = 2  # paper footnote 2: per-expert activation accesses in combine

INF = float("inf")


# ===========================================================================
# Arithmetic intensities (Eq. 8, 18, 21)
# ===========================================================================

def ai_dense(n: int, b: int, s: int = BYTES_BF16) -> float:
    """Eq. 8: AI_dense(N) = 2bN/s (weight-traffic-dominated)."""
    return 2.0 * b * n / s


def ai_moe(n: int, b: int, k: int, e_act: int, d_ff: int,
           s: int = BYTES_BF16, eta: int = ETA_COMBINE) -> float:
    """Eq. 18."""
    num = 4.0 * b * n * k * d_ff
    den = s * (2.0 * e_act * d_ff + b * n * (1 + 3 * k + eta * k))
    return num / den


def ai_attn(n: int, ell: int, s: int = BYTES_BF16) -> float:
    """Eq. 21 (MHA form; batch cancels)."""
    return 2.0 * n * ell / ((ell + n) * s)


# ===========================================================================
# Idle-compute boundaries (Eq. 9, 19, 22)
# ===========================================================================

def n_idle_dense(rho: float, b: int, s: int = BYTES_BF16) -> float:
    """Eq. 9: N_idle^dense ~= rho*s / (2b)."""
    return rho * s / (2.0 * b)


def n_idle_moe(rho: float, b: int, k: int, e_act: int, d_ff: int,
               s: int = BYTES_BF16, eta: int = ETA_COMBINE) -> float:
    """Eq. 19; +inf when execution stays memory-bound (4k*d_ff <= rho*s*(...))."""
    gate = 4.0 * k * d_ff - rho * s * (1 + 3 * k + eta * k)
    if gate <= 0:
        return INF
    return 2.0 * rho * s * e_act * d_ff / (b * gate)


def n_idle_attn(rho: float, ell: int, s: int = BYTES_BF16) -> float:
    """Eq. 22; +inf when 2L <= rho*s (memory-bound for all N)."""
    if 2.0 * ell <= rho * s:
        return INF
    return rho * s * ell / (2.0 * ell - rho * s)


def n_idle_attn_general(rho: float, ell: int, attn: AttentionSpec,
                        s: int = BYTES_BF16, kv_page: int = 0) -> float:
    """Generalized Eq. 22 for GQA / MLA / SWA geometries.

    C(N) = 2*b*N*L_eff*h*(d_qk + d_v), B(N) = b*(L_eff+N)*kv_bytes_per_token;
    solve AI(N) = rho for N.  ``kv_page`` > 0 rounds L_eff up to the page
    boundary (a paged cache is read in whole blocks)."""
    if attn.kind == "swa" and attn.window is not None:
        ell = min(ell, attn.window)
    ell = kv_padded_len(ell, kv_page)
    d_qk, d_v = attn.score_dims
    c_per = 2.0 * ell * attn.n_heads * (d_qk + d_v)         # FLOPs / position
    kv_b = float(attn.kv_cache_bytes_per_token)
    gate = c_per - rho * kv_b
    if gate <= 0:
        return INF
    return rho * ell * kv_b / gate


def n_idle_ssm(rho: float, b: int, s: int = BYTES_BF16) -> float:
    """SSM projections are weight-stationary like a dense FFN."""
    return n_idle_dense(rho, b, s)


@dataclass(frozen=True)
class NFPPrediction:
    n_max: float
    limiting: str                 # which term is the min
    terms: Dict[str, float]       # every module-level term
    n_idle: float                 # pure idle-compute prediction (baseline)

    @property
    def overprediction(self) -> float:
        """How much the idle-compute intuition over-predicts (Table 24)."""
        if not math.isfinite(self.n_idle):
            return INF
        return self.n_idle / self.n_max if self.n_max > 0 else INF


def predict_dense(hw: HardwareSpec, gran: GranularitySpec, b: int,
                  s: int = BYTES_BF16) -> NFPPrediction:
    """Eq. 12: N_max^dense ~= min(rho*s/2b, M_attn)."""
    terms = {
        "dense_ffn_idle": n_idle_dense(hw.rho, b, s),
        "attn_tile": float(gran.m_attn),
    }
    lim = min(terms, key=terms.get)
    return NFPPrediction(terms[lim], lim, terms, terms["dense_ffn_idle"])


def predict_moe_balanced(hw: HardwareSpec, gran: GranularitySpec,
                         n_experts: int, k: int, d_ff: int, b: int = 1,
                         s: int = BYTES_BF16) -> NFPPrediction:
    """Eq. 13: N_max^{moe,bal} ~= min(M_moe*E/k, tau, M_attn)."""
    terms = {
        "moe_padding_capacity": gran.m_moe * n_experts / k,
        "tau_branch": float(gran.tau if gran.tau else n_experts),
        "attn_tile": float(gran.m_attn),
    }
    lim = min(terms, key=terms.get)
    idle = n_idle_moe(hw.rho, b, k, e_act=n_experts, d_ff=d_ff, s=s)
    return NFPPrediction(terms[lim], lim, terms, idle)


def predict_moe_skewed(hw: HardwareSpec, gran: GranularitySpec,
                       k: int, d_ff: int, b: int = 1,
                       s: int = BYTES_BF16) -> NFPPrediction:
    """Eq. 14: N_max^{moe,skew} ~= min(M_moe, M_attn)."""
    terms = {
        "moe_padding_local": float(gran.m_moe),
        "attn_tile": float(gran.m_attn),
    }
    lim = min(terms, key=terms.get)
    idle = n_idle_moe(hw.rho, b, k, e_act=k, d_ff=d_ff, s=s)
    return NFPPrediction(terms[lim], lim, terms, idle)


def predict_model(cfg: ArchConfig, hw: HardwareSpec, gran: GranularitySpec,
                  b: int, ell: int, routing: str = "balanced",
                  s: int = BYTES_BF16) -> NFPPrediction:
    """Model-level NFP: first-exiting-module min over the modules the
    architecture contains (paper Sec. 4)."""
    pat = cfg.pattern()
    has_attn = any(p in (LAYER_ATTN, LAYER_HYBRID) for p in pat) and cfg.attention
    has_ssm = any(p in (LAYER_SSM, LAYER_HYBRID) for p in pat) and cfg.ssm
    terms: Dict[str, float] = {}
    idle_terms: Dict[str, float] = {}

    if cfg.ffn.kind == "dense":
        terms["dense_ffn_idle"] = n_idle_dense(hw.rho, b, s)
        idle_terms["dense_ffn"] = terms["dense_ffn_idle"]
    elif cfg.ffn.kind == "moe":
        e, k = cfg.ffn.n_experts, cfg.ffn.top_k
        if routing == "balanced":
            terms["moe_padding_capacity"] = gran.m_moe * e / k
            terms["tau_branch"] = float(gran.tau if gran.tau else e)
            e_act = e
        else:
            terms["moe_padding_local"] = float(gran.m_moe)
            e_act = k
        idle_terms["moe_ffn"] = n_idle_moe(hw.rho, b, k, e_act, cfg.ffn.d_ff, s)

    if has_attn:
        terms["attn_tile"] = float(gran.m_attn)
        idle_terms["attn"] = n_idle_attn_general(hw.rho, ell, cfg.attention, s,
                                                 kv_page=gran.kv_page)

    if has_ssm:
        terms["ssm_idle"] = n_idle_ssm(hw.rho, b, s)
        terms["ssm_chunk_capacity"] = float(gran.m_ssm)
        idle_terms["ssm"] = terms["ssm_idle"]

    n_idle = min(idle_terms.values()) if idle_terms else INF
    lim = min(terms, key=terms.get)
    return NFPPrediction(terms[lim], lim, terms, n_idle)


def parallelism_budget(cfg: ArchConfig, hw: HardwareSpec,
                       gran: GranularitySpec, b: int, ell: int,
                       eps: float = 0.2,
                       routing: str = "balanced") -> int:
    """The near-free position budget a verification / block width should
    not exceed.  The fractional boundary is FLOORED: every position inside
    the budget is promised near-free."""
    pred = predict_model(cfg, hw, gran, b, ell, routing=routing)
    n = pred.n_max
    return max(1, math.floor(n)) if math.isfinite(n) else cfg.max_seq_len
