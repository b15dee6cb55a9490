"""Kernel-granularity registry — the single source of truth.

The paper's central mechanism is that logical decode positions are realized
as *quantized physical work units*: query tiles in attention backends
(kBlockM / CTA_TILE_Q) and expert-token blocks in fused MoE kernels
(BLOCK_SIZE_M).  On TPU the corresponding quantum is the Pallas
``BlockSpec`` block shape chosen by our own kernels.

Every function here is used BOTH by the Pallas kernels in
``repro.kernels.*`` (to pick their grids) and by the NFP predictor in
``repro.core.nfp`` (to predict the boundary) — so predictor and
implementation can never drift apart.  This mirrors the paper's
methodology of reading M_attn / M_moe out of backend source (App. E.3,
F.3) except that here the "backend source" is this module.
"""
from __future__ import annotations

from dataclasses import dataclass


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


# ---------------------------------------------------------------------------
# Attention query-tile selection (paper App. F; Tables 14-16).
#
# Two policies, mirroring the two GPU backends the paper inspects:
#   - "fixed64"  (FlashAttention-2-like): one branch, q_block = 64.
#     TPU rationale: 64 query rows x 128 lanes fills 4 bf16 VREG sublane
#     groups and keeps the MXU M-dim at 64 (half-systolic, fine for the
#     memory-bound decode regime).
#   - "adaptive" (FlashInfer-like): scheduler picks the tile from the packed
#     query workload -> 16 / 64 / 128 branches.  The branch boundaries are
#     the tau-analogues for attention.
# ---------------------------------------------------------------------------

ATTN_POLICY_FIXED = "fixed64"
ATTN_POLICY_ADAPTIVE = "adaptive"


def select_q_block(n_q: int, head_dim: int = 128,
                   policy: str = ATTN_POLICY_FIXED) -> int:
    """Query-tile rows executed per grid step (the TPU kBlockM)."""
    if policy == ATTN_POLICY_FIXED:
        return 64
    # adaptive: FlashInfer-style (Table 16), sublane-aligned for bf16
    if n_q <= 16:
        return 16
    if n_q <= 64 or head_dim >= 256:
        return 64
    return 128


def attn_padded_q(n_q: int, head_dim: int = 128,
                  policy: str = ATTN_POLICY_FIXED) -> int:
    """Physical query rows executed for n_q logical rows (Eq. 34)."""
    blk = select_q_block(n_q, head_dim, policy)
    return round_up(n_q, blk)


def m_attn(head_dim: int = 128, policy: str = ATTN_POLICY_FIXED) -> int:
    """M_attn: positions absorbable within one baseline query tile (Eq. 35).

    The baseline decode forward (N=1) launches one tile of
    ``select_q_block(1)`` rows; everything inside it is near-free.
    """
    return select_q_block(1, head_dim, policy)


# ---------------------------------------------------------------------------
# MoE expert-token block alignment (paper App. E; Tables 8-9).
#
# Our Pallas grouped-GEMM MoE kernel sorts tokens by expert and pads each
# expert's token count up to ``token_block`` rows (the BLOCK_SIZE_M
# analogue).  The selection rule mirrors the small/large-M branches of the
# GPU backends so the branch-validity bound tau exists structurally:
#     padded token dim M <= E  -> 16     (decode regime)
#     otherwise                -> 64     (prefill/training regime)
# ---------------------------------------------------------------------------


def select_token_block(m_tokens: int, n_experts: int,
                       quant: str = "bf16") -> int:
    """Expert-token row-block (BLOCK_SIZE_M analogue) for a fused MoE call.

    Branch rules mirror paper Table 9 (SGLang fused-MoE fallback):
      bf16/fp16:        M <= E -> 16, else 64
      per-tensor int8/fp8: M <= E -> 64, else 128
      block-wise fp8:   64 for any M
    """
    if quant in ("fp8_block", "int8_block"):
        return 64
    if quant in ("fp8", "int8"):
        return 64 if m_tokens <= n_experts else 128
    if m_tokens <= n_experts:
        return 16
    return 64


def moe_tau(n_experts: int) -> int:
    """Validity bound of the small-token branch (tau = E, paper Sec. 4.2)."""
    return n_experts


def m_moe(n_experts: int, quant: str = "bf16") -> int:
    """M_moe: expert-token padding granularity in the decode regime."""
    return select_token_block(1, n_experts, quant)


def moe_padded_tokens(tokens_per_expert, token_block: int) -> int:
    """Total physical expert-token rows executed (Eq. 28 summed)."""
    return int(sum(round_up(int(t), token_block) if t > 0 else 0
                   for t in tokens_per_expert))


# ---------------------------------------------------------------------------
# SSM scan-chunk granularity (our TPU extension; DESIGN.md §6).
# The Pallas chunked selective scan processes positions in chunks.
# ---------------------------------------------------------------------------

SSM_CHUNK = 16


def select_scan_chunk(n_positions: int) -> int:
    return SSM_CHUNK


def m_ssm() -> int:
    return SSM_CHUNK


def ssm_padded_positions(n: int) -> int:
    return round_up(n, SSM_CHUNK)


# ---------------------------------------------------------------------------
# MXU alignment — the secondary TPU-specific granularity (DESIGN.md §2):
# matmul M/N/K dims are executed in multiples of the 128x128 systolic tile;
# the LHS row dim additionally in sublane multiples (8 f32 / 16 bf16).
# ---------------------------------------------------------------------------


def mxu_padded_rows(m: int, dtype_bytes: int = 2) -> int:
    sublane = 8 * (4 // dtype_bytes)
    return round_up(m, sublane)


# ---------------------------------------------------------------------------
# Paged-KV block granularity.  With a paged cache the kv sequence is
# read (and, on the Pallas path, tiled) in fixed-size blocks, so the
# attended cache length is quantized up to the page boundary — a second
# attention-side granularity next to the query tile, entering the NFP
# idle term through ``core.nfp.n_idle_attn_general(kv_page=...)``.
# ---------------------------------------------------------------------------


def kv_padded_len(ell: int, kv_page: int) -> int:
    """Cache positions physically touched for ``ell`` logical positions
    under a ``kv_page``-sized paged cache (0 = dense, no quantization)."""
    if kv_page <= 0:
        return ell
    return round_up(max(ell, 1), kv_page)


@dataclass(frozen=True)
class GranularitySpec:
    """Bundle of granularity parameters for one backend configuration.

    ``kv_page`` is the paged-KV block size in positions (0 when the
    dense cache is in use) — the paging granularity knob the NFP
    attention idle term accounts for.
    """

    m_attn: int
    m_moe: int
    tau: int
    m_ssm: int
    attn_policy: str = ATTN_POLICY_FIXED
    kv_page: int = 0

    @classmethod
    def for_backend(cls, n_experts: int = 0,
                    attn_policy: str = ATTN_POLICY_FIXED,
                    head_dim: int = 128,
                    quant: str = "bf16",
                    kv_page: int = 0) -> "GranularitySpec":
        return cls(
            m_attn=m_attn(head_dim, attn_policy),
            m_moe=m_moe(max(n_experts, 1), quant),
            tau=moe_tau(n_experts) if n_experts else 0,
            m_ssm=m_ssm(),
            attn_policy=attn_policy,
            kv_page=kv_page,
        )
