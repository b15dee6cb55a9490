"""Near-Free Parallelism: the model-level NFP budget (paper Eq. 12-14).

The subset of the reference ``core.nfp`` that ``parallelism_budget``
needs: the idle-compute boundaries of the dense FFN, MoE FFN, attention
and SSM modules, and the first-exiting-module minimum over the modules
an architecture contains.
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
