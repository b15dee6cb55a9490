"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920,
vocab=100352 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        vocab_size=100352,
        attention=AttentionSpec(kind="gqa", n_heads=40, n_kv_heads=10,
                                head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=17920, activation="swiglu"),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="swiglu"),
    )
