"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192,
vocab=32064 — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Backbone only, as in the reference: the CLIP vision tower is a stub.
``models.forward`` takes precomputed patch embeddings merged into the
token-embedding stream through ``inputs["embeds"]``; serving feeds it
tokens.
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        vocab_size=32064,
        attention=AttentionSpec(kind="gqa", n_heads=32, n_kv_heads=32,
                                head_dim=96),
        ffn=FFNSpec(kind="dense", d_ff=8192, activation="swiglu"),
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="phi3-vision-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="swiglu"),
    )
