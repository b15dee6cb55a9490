"""whisper-tiny [audio]: 4L d_model=384 6H (MHA) d_ff=1536 vocab=51865 —
enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The mel/conv frontend is a STUB per the brief: ``input_specs()`` provides
precomputed frame embeddings (1500 frames x d_model) for the encoder.
"""
from repro_torch.core.arch import (ArchConfig, AttentionSpec, EncoderSpec, FFNSpec)


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        vocab_size=51865,
        attention=AttentionSpec(kind="gqa", n_heads=6, n_kv_heads=6,
                                head_dim=64),
        ffn=FFNSpec(kind="dense", d_ff=1536, activation="gelu"),
        encoder=EncoderSpec(n_layers=4, n_frames=1500, frontend="audio"),
        max_seq_len=65536,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=AttentionSpec(kind="gqa", n_heads=4, n_kv_heads=4,
                                head_dim=16),
        ffn=FFNSpec(kind="dense", d_ff=128, activation="gelu"),
        encoder=EncoderSpec(n_layers=2, n_frames=16, frontend="audio"),
    )
