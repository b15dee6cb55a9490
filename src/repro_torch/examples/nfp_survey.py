"""NFP deployment survey: the paper's Table 24 as a living lookup over
all the architectures x hardware targets x batch x context.

Run: PYTHONPATH=src python -m repro_torch.examples.nfp_survey

The hardware targets are the port's H100 and the paper's H20 and H800
(the port has no TPU preset).  Pure host arithmetic: ``--device`` only
states where the port runs (``cuda`` unless given ``cpu``).
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import GranularitySpec, NFPPrediction, predict_model
from repro_torch.core.device import resolve_device
from repro_torch.core.hardware import get_hardware

HARDWARE = ("h100", "h20", "h800")
BATCHES = (1, 8)
CONTEXTS = (4096, 32768)

Row = Tuple[str, str, int, int, NFPPrediction]


def survey() -> List[Row]:
    """(arch, hardware, b, ell, prediction) for every cell of the table."""
    rows = []
    for hw_name in HARDWARE:
        hw = get_hardware(hw_name)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            g = GranularitySpec.for_backend(cfg.ffn.n_experts)
            for b in BATCHES:
                for ell in CONTEXTS:
                    rows.append((arch, hw_name, b, ell,
                                 predict_model(cfg, hw, g, b, ell)))
    return rows


def main(argv=None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    resolve_device(ap.parse_args(argv).device)
    print(f"{'arch':26s} {'hw':8s} {'b':>3s} {'L':>6s} "
          f"{'N_max':>6s} {'idle':>8s} {'over':>6s}  limiting")
    rows = survey()
    for arch, hw_name, b, ell, p in rows:
        idle = f"{p.n_idle:.0f}" if p.n_idle != float("inf") else "inf"
        over = (f"{p.overprediction:.1f}x"
                if p.overprediction != float("inf") else "-")
        print(f"{arch:26s} {hw_name:8s} {b:3d} {ell:6d} "
              f"{p.n_max:6.0f} {idle:>8s} {over:>6s}  {p.limiting}")
    return rows


if __name__ == "__main__":
    main()
