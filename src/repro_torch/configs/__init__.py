"""repro_torch.configs — the architectures the port serves so far.

``get_config("<arch-id>")`` and ``get_config("<arch-id>", reduced=True)``
for the small CPU variant, as in the reference registry.
"""
from __future__ import annotations

import importlib

from repro_torch.core.arch import ArchConfig

ARCH_IDS = ["stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m"]


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise ValueError(f"{name!r} is not ported yet; ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced_config() if reduced else mod.config()
