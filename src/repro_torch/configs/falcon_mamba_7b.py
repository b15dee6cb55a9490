"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 architecture.  [arXiv:2410.05355; unverified]

Attention-free: the NFP attention-granularity term does not apply; the
model-level NFP boundary is min(SSM idle-compute term, scan-chunk
granularity).
"""
from repro_torch.core.arch import LAYER_SSM, ArchConfig, FFNSpec, SSMSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        vocab_size=65024,
        attention=None,
        ffn=FFNSpec(kind="none", d_ff=0),
        ssm=SSMSpec(kind="mamba1", d_state=16, d_conv=4, expand=2),
        layer_pattern=tuple([LAYER_SSM] * 64),
        tie_embeddings=True,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        attention=None,
        ffn=FFNSpec(kind="none", d_ff=0),
        ssm=SSMSpec(kind="mamba1", d_state=8, d_conv=4, expand=2),
        layer_pattern=tuple([LAYER_SSM] * 2),
        tie_embeddings=True,
    )
