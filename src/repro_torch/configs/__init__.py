"""repro_torch.configs — the reference's twelve architectures.

``get_config("<arch-id>")`` and ``get_config("<arch-id>", reduced=True)``
for the small CPU variant, as in the reference registry.
"""
from __future__ import annotations

import importlib

from repro_torch.core.arch import ArchConfig

ARCH_IDS = ["stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m",
            "llada_mini_like", "falcon_mamba_7b", "minicpm3_4b",
            "mixtral_8x22b", "starcoder2_3b", "phi3_medium_14b",
            "phi3_vision_4p2b", "zamba2_1p2b", "whisper_tiny"]


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced_config() if reduced else mod.config()
