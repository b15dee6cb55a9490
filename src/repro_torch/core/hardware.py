"""Hardware specification and the balance point rho = phi / beta.

The port serves on one NVIDIA H100 SXM; its peaks come from NVIDIA's
H100 data sheet (dense bf16 tensor-core rate, HBM3 bandwidth, device
memory).  The NFP budget reads ``H100.rho`` — about 295 FLOP per byte.
The paper's three GPUs (its Table 2) are presets too, copied from the
reference, so the predictors can be held against the paper's own numbers
(Table 2 / Table 24); ``H100`` stays the default.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    phi: float           # peak bf16/fp16 compute, FLOP/s
    beta: float          # peak HBM bandwidth, bytes/s
    ici: float = 0.0     # per-link interconnect bandwidth, bytes/s
    n_ici_links: int = 0
    hbm_bytes: float = 0.0
    vmem_bytes: float = 0.0
    mxu_dim: int = 128   # matrix-unit tile side

    @property
    def rho(self) -> float:
        """Hardware balance point (FLOP per byte)."""
        return self.phi / self.beta


H100 = HardwareSpec(
    name="h100",
    phi=989e12,          # dense bf16 tensor-core FLOP/s
    beta=3.35e12,        # HBM3 bytes/s
    hbm_bytes=80e9,
)

# --- the paper's GPUs (Table 2) --------------------------------------------
H20 = HardwareSpec("h20", phi=148e12, beta=4.0e12)
A800 = HardwareSpec("a800", phi=312e12, beta=2.039e12)
H800 = HardwareSpec("h800", phi=989e12, beta=3.35e12)

PRESETS = {h.name: h for h in (H100, H20, A800, H800)}

BYTES_BF16 = 2
BYTES_F32 = 4


def get_hardware(name: str) -> HardwareSpec:
    return PRESETS[name]
