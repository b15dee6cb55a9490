"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192,
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention blocks.
[arXiv:2411.15242; hf]

A single shared attention+MLP block (one parameter set) is applied at
every 6th position, zamba2-style; remaining layers are Mamba2.
"""
from repro_torch.core.arch import (LAYER_HYBRID, LAYER_SSM, ArchConfig,
                             AttentionSpec, FFNSpec, SSMSpec)


def _pattern(n_layers: int, period: int = 6):
    return tuple(LAYER_HYBRID if (i + 1) % period == 0 else LAYER_SSM
                 for i in range(n_layers))


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        vocab_size=32000,
        attention=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=32,
                                head_dim=64),
        ffn=FFNSpec(kind="none", d_ff=8192, activation="gelu"),
        ssm=SSMSpec(kind="mamba2", d_state=64, d_conv=4, expand=2,
                    head_dim=64, n_groups=1),
        layer_pattern=_pattern(38),
        shared_attention=True,
        tie_embeddings=True,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4,
                                head_dim=16),
        ffn=FFNSpec(kind="none", d_ff=128, activation="gelu"),
        ssm=SSMSpec(kind="mamba2", d_state=16, d_conv=4, expand=2,
                    head_dim=32, n_groups=1),
        layer_pattern=_pattern(4, period=2),
        shared_attention=True,
        tie_embeddings=True,
    )
