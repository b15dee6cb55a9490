"""Paper-analogue dense model (WeDLM-8B, paper App. G.2):
36L d_model=4096 d_ff=12288 32H kv=8 head_dim=128 — used for the paper's
dense model-level validation (Fig. 26-29).
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="wedlm8b-like",
        family="dense",
        n_layers=36,
        d_model=4096,
        vocab_size=151936,
        attention=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=8,
                                head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=12288, activation="swiglu"),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="wedlm-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=2,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="swiglu"),
    )
