"""Architecture specification schema.

A single declarative schema covers all 10 assigned architectures (dense,
MoE, MLA, SWA, hybrid SSM+attention, pure SSM, encoder-decoder audio, VLM
backbone).  The NFP analytical model (``core.nfp`` / ``core.simulate``),
the model zoo (``repro.models``), the sharding rules (``repro.dist``) and
the dry-run launcher all consume this one schema, so an architecture is
defined exactly once in ``repro/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionSpec:
    """Attention module description.

    kind:
      - "gqa":  grouped-query attention (covers MHA when n_kv == n_heads,
                MQA when n_kv == 1).
      - "mla":  multi-head latent attention (MiniCPM3 / DeepSeek style):
                KV cache stores a compressed latent per token.
      - "swa":  sliding-window GQA (Mixtral): effective cache length is
                min(L, window).
    """

    kind: str = "gqa"                    # gqa | mla | swa
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    window: Optional[int] = None         # swa only
    # MLA-only geometry (MiniCPM3-4B defaults).
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_cache_bytes_per_token(self) -> int:
        """bf16 KV-cache bytes appended per token (the B(N) traffic unit)."""
        s = 2
        if self.kind == "mla":
            # latent + decoupled rope key, shared across heads
            return (self.kv_lora_rank + self.qk_rope_head_dim) * s
        return 2 * self.n_kv_heads * self.head_dim * s

    @property
    def score_dims(self) -> Tuple[int, int]:
        """(per-head qk dim, per-head v dim) used in score/AV matmuls."""
        if self.kind == "mla":
            return (self.qk_nope_head_dim + self.qk_rope_head_dim, self.v_head_dim)
        return (self.head_dim, self.head_dim)


@dataclass(frozen=True)
class FFNSpec:
    kind: str = "dense"                  # dense | moe | none
    d_ff: int = 0                        # dense intermediate (or expert d_ff for moe)
    activation: str = "swiglu"           # swiglu | gelu
    n_experts: int = 0                   # moe only
    top_k: int = 0                       # moe only
    n_shared_experts: int = 0            # moe: always-on shared experts


@dataclass(frozen=True)
class SSMSpec:
    kind: str = "mamba1"                 # mamba1 | mamba2
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                   # mamba2 only
    n_groups: int = 1                    # mamba2 only

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class EncoderSpec:
    """Stub-frontend encoder (whisper / CLIP): the frontend itself is a stub;
    ``input_specs`` provides precomputed frame/patch embeddings."""

    n_layers: int = 4
    n_frames: int = 1500                 # encoder sequence length (stub output)
    frontend: str = "audio"              # audio | vision


# Layer kinds used in ``layer_pattern``.
LAYER_ATTN = "attn"                      # attention + ffn block
LAYER_SSM = "ssm"                        # pure SSM block
LAYER_HYBRID = "hybrid"                  # SSM block + (shared) attention block


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # moe|dense|hybrid|audio|vlm|ssm
    n_layers: int
    d_model: int
    vocab_size: int
    attention: Optional[AttentionSpec] = None
    ffn: FFNSpec = field(default_factory=FFNSpec)
    ssm: Optional[SSMSpec] = None
    encoder: Optional[EncoderSpec] = None
    layer_pattern: Optional[Tuple[str, ...]] = None  # defaults to all-attn
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    # hybrid (zamba2): one shared attention param set reused at every
    # LAYER_HYBRID position.
    shared_attention: bool = False
    notes: str = ""

    # ------------------------------------------------------------------
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            if len(self.layer_pattern) != self.n_layers:
                raise ValueError(
                    f"layer_pattern has {len(self.layer_pattern)} entries "
                    f"for n_layers={self.n_layers}")
            return self.layer_pattern
        return tuple([LAYER_ATTN] * self.n_layers)

    def count_layers(self, kind: str) -> int:
        return sum(1 for p in self.pattern() if p == kind)

    @property
    def is_attention_free(self) -> bool:
        return all(p == LAYER_SSM for p in self.pattern())

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode working set: SSM / hybrid / sliding-window."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attention is not None and self.attention.kind == "swa":
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    # -- parameter counting (used for MODEL_FLOPS = 6 N D and roofline) ----
    def param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        # embeddings (+ untied lm head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.pattern():
            if kind in (LAYER_ATTN, LAYER_HYBRID):
                n += self._attn_params()
                if kind == LAYER_ATTN:
                    n += self._ffn_params(active_only)
            if kind in (LAYER_SSM, LAYER_HYBRID):
                n += self._ssm_params()
        if self.encoder is not None:
            enc_attn = AttentionSpec(
                n_heads=self.attention.n_heads,
                n_kv_heads=self.attention.n_kv_heads,
                head_dim=self.attention.head_dim,
            )
            per = (
                self._attn_params_for(enc_attn)
                + self._ffn_params(active_only)
            )
            n += self.encoder.n_layers * per
            # decoder cross-attention
            n += self.count_layers(LAYER_ATTN) * self._attn_params()
        if self.shared_attention:
            # hybrid shared-attn params were counted once per hybrid layer;
            # correct to a single shared set (+ its ffn)
            h = self.count_layers(LAYER_HYBRID)
            if h > 1:
                n -= (h - 1) * self._attn_params()
        return n

    def _attn_params(self) -> int:
        return self._attn_params_for(self.attention)

    def _attn_params_for(self, a: AttentionSpec) -> int:
        d = self.d_model
        if a.kind == "mla":
            qk_h = a.qk_nope_head_dim + a.qk_rope_head_dim
            n = d * a.q_lora_rank + a.q_lora_rank * a.n_heads * qk_h      # q proj
            n += d * (a.kv_lora_rank + a.qk_rope_head_dim)                # kv down
            n += a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
            n += a.n_heads * a.v_head_dim * d                             # out
            return n
        q = d * a.n_heads * a.head_dim
        kv = 2 * d * a.n_kv_heads * a.head_dim
        o = a.n_heads * a.head_dim * d
        return q + kv + o

    def _ffn_params(self, active_only: bool) -> int:
        d = self.d_model
        f = self.ffn
        if f.kind == "none":
            return 0
        mats = 3 if f.activation == "swiglu" else 2
        per_expert = mats * d * f.d_ff
        if f.kind == "dense":
            return per_expert
        n_exp = f.top_k if active_only else f.n_experts
        n = n_exp * per_expert + f.n_shared_experts * per_expert
        n += d * f.n_experts  # router
        return n

    def _ssm_params(self) -> int:
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        n = d * 2 * di                  # in_proj (x and z)
        n += di * s.d_conv              # conv
        if s.kind == "mamba1":
            dt_rank = max(1, d // 16)
            n += di * (dt_rank + 2 * s.d_state)   # x_proj -> (dt, B, C)
            n += dt_rank * di                      # dt_proj
            n += di * s.d_state                    # A
        else:  # mamba2
            n_heads = di // s.head_dim
            n += d * (2 * s.n_groups * s.d_state + n_heads)  # B, C, dt heads
            n += 2 * s.n_groups * s.d_state * s.d_conv        # B/C convs
            n += n_heads                                      # A (per head)
        n += di * d                     # out_proj
        return n

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Skip rules from the assignment brief (recorded in DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (sub-quadratic required)"
    return True, ""
