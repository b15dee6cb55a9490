"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32 = MHA) d_ff=6912,
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        vocab_size=50304,
        attention=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=32,
                                head_dim=80),
        ffn=FFNSpec(kind="dense", d_ff=6912, activation="swiglu"),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="swiglu"),
    )
