"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288,
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        vocab_size=49152,
        attention=AttentionSpec(kind="gqa", n_heads=24, n_kv_heads=2,
                                head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=12288, activation="gelu"),
        rope_theta=100000.0,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=1,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="gelu"),
    )
