"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Expert count: 40 (E is a single config field either way).
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        vocab_size=49155,
        attention=AttentionSpec(kind="gqa", n_heads=24, n_kv_heads=8,
                                head_dim=64),
        ffn=FFNSpec(kind="moe", d_ff=512, activation="swiglu",
                    n_experts=40, top_k=8),
        tie_embeddings=True,
        rope_theta=10000.0,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                                head_dim=16),
        ffn=FFNSpec(kind="moe", d_ff=32, activation="swiglu",
                    n_experts=8, top_k=2),
        tie_embeddings=True,
    )
