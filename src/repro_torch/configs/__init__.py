"""repro_torch.configs — the reference's twelve architectures.

``get_config("<arch-id>")`` and ``get_config("<arch-id>", reduced=True)``
for the small CPU variant, as in the reference registry.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.core.arch import ArchConfig

ARCH_IDS = ["stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m",
            "llada_mini_like", "falcon_mamba_7b", "minicpm3_4b",
            "mixtral_8x22b", "starcoder2_3b", "phi3_medium_14b",
            "phi3_vision_4p2b", "zamba2_1p2b", "whisper_tiny"]


# the reference's registry order: the assigned architectures, then the
# paper-analogue configs (the model-level validation targets of the paper)
ASSIGNED_IDS = ["granite_moe_3b_a800m", "mixtral_8x22b", "minicpm3_4b",
                "starcoder2_3b", "phi3_medium_14b", "stablelm_3b",
                "zamba2_1p2b", "whisper_tiny", "phi3_vision_4p2b",
                "falcon_mamba_7b"]
PAPER_IDS = ["wedlm8b_like", "llada_mini_like"]


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced_config() if reduced else mod.config()


def all_configs(reduced: bool = False) -> Dict[str, ArchConfig]:
    """The assigned architectures' configs by id, as the reference's
    (``ASSIGNED_IDS``; the paper-analogue ones are ``PAPER_IDS``)."""
    return {a: get_config(a, reduced) for a in ASSIGNED_IDS}
