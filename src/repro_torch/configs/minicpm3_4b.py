"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.
[hf:openbmb/MiniCPM3-4B; hf]

MLA geometry from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        vocab_size=73448,
        attention=AttentionSpec(kind="mla", n_heads=40, n_kv_heads=40,
                                head_dim=96, q_lora_rank=768,
                                kv_lora_rank=256, qk_nope_head_dim=64,
                                qk_rope_head_dim=32, v_head_dim=64),
        ffn=FFNSpec(kind="dense", d_ff=6400, activation="swiglu"),
        tie_embeddings=True,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="mla", n_heads=4, n_kv_heads=4,
                                head_dim=24, q_lora_rank=32,
                                kv_lora_rank=16, qk_nope_head_dim=16,
                                qk_rope_head_dim=8, v_head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="swiglu"),
        tie_embeddings=True,
    )
