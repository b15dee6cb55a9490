"""Paper-analogue MoE model (LLaDA-2.1-mini, paper App. G.3):
20L d_model=2048 d_ff=5120 16H kv=4 head_dim=128, MoE E=256 k=8
moe_d_ff=512 — used for the paper's MoE model-level validation
(Fig. 30-37).
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="llada-2.1-mini-like",
        family="moe",
        n_layers=20,
        d_model=2048,
        vocab_size=128000,
        attention=AttentionSpec(kind="gqa", n_heads=16, n_kv_heads=4,
                                head_dim=128),
        ffn=FFNSpec(kind="moe", d_ff=512, activation="swiglu",
                    n_experts=256, top_k=8),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="llada-mini-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                                head_dim=16),
        ffn=FFNSpec(kind="moe", d_ff=32, activation="swiglu",
                    n_experts=16, top_k=2),
    )
