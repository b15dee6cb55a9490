"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384,
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        vocab_size=32768,
        attention=AttentionSpec(kind="swa", n_heads=48, n_kv_heads=8,
                                head_dim=128, window=4096),
        ffn=FFNSpec(kind="moe", d_ff=16384, activation="swiglu",
                    n_experts=8, top_k=2),
        rope_theta=1000000.0,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="swa", n_heads=4, n_kv_heads=2,
                                head_dim=16, window=8),
        ffn=FFNSpec(kind="moe", d_ff=64, activation="swiglu",
                    n_experts=4, top_k=2),
    )
