"""Quickstart: the NFP principle in five minutes.

1. Pick an architecture config and hardware.
2. Ask the NFP predictor how many decode positions are near-free.
3. Build a tiny model, run a multi-position decode forward, and check
   the simulated latency curve against the closed-form prediction.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart

The deployment target of step 2 is the port's H100 preset.  Step 4 runs
on ``--device`` (``cuda`` unless given ``cpu``); on the card its MoE FFN
is the hand-written kernel (``csrc/moe_ffn.cu``).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (H20, H100, GranularitySpec, LatencyCurve,
                              balanced_moe_baseline_n, extract_nmax,
                              latency_curve, predict_model,
                              predict_moe_balanced)
from repro_torch.core.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serving import DecodeEngine

ARCH = "llada_mini_like"
PROMPT_LEN = 8
MAX_LEN = 128
MAX_N = 16


def predictions(hw=H100) -> Dict:
    """Steps 1-3 on the full-size config: the model-level prediction on
    the H20 and the module-level idle-compute one, the prediction on
    ``hw``, and N_max(0.2) of the curve simulated on ``hw``."""
    cfg = get_config(ARCH)
    gran = GranularitySpec.for_backend(n_experts=cfg.ffn.n_experts)
    base_n = balanced_moe_baseline_n(cfg.ffn.n_experts, 1, cfg.ffn.top_k)
    ns = sorted(set(range(1, 129)) | {base_n})
    pts = latency_curve(cfg, hw, 1, 4096, ns, gran)
    curve = LatencyCurve([n for n, _ in pts], [t for _, t in pts],
                         baseline_n=base_n)   # Eq. 26 balanced baseline
    return {"cfg": cfg,
            "h20": predict_model(cfg, H20, gran, b=1, ell=4096),
            "module_h20": predict_moe_balanced(
                H20, gran, cfg.ffn.n_experts, cfg.ffn.top_k, cfg.ffn.d_ff),
            "target": predict_model(cfg, hw, gran, b=1, ell=4096),
            "baseline_n": base_n, "curve": curve,
            "nmax_simulated": extract_nmax(curve, 0.2)}


def tiny_decode(cfg, params, rng: np.random.Generator, device) -> Dict:
    """Step 4: a batch-1 engine on ``params``, an 8-token prompt from
    ``rng``, then one decode forward of N = min(budget, 16) positions
    (draft tokens from ``rng``)."""
    eng = DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN, device=device)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, PROMPT_LEN))
    eng.prefill(torch.as_tensor(prompt, device=eng.device))
    budget = eng.nfp_budget()
    n = min(budget, MAX_N)
    draft = rng.integers(0, cfg.vocab_size, size=(1, n))
    logits = eng.decode_step(torch.as_tensor(draft, device=eng.device))
    return {"prompt": prompt, "draft": draft, "budget": budget, "n": n,
            "logits": logits, "use_kernel": eng.use_kernel}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- 1. the paper's headline: idle-compute over-predicts -------------
    out = predictions()
    cfg, pred, mod = out["cfg"], out["h20"], out["module_h20"]
    print(f"[{cfg.name} @ H20]  NFP principle: N_max ~= {pred.n_max:.0f} "
          f"(limited by {pred.limiting})")
    print(f"  module-level idle-compute intuition says {mod.n_idle:.0f} -> "
          f"over-predicts {mod.overprediction:.0f}x (paper Table 24)")

    # ---- 2. on the deployment target (H100) ------------------------------
    tgt = out["target"]
    print(f"[{cfg.name} @ H100]  N_max ~= {tgt.n_max:.0f} "
          f"(limited by {tgt.limiting}, rho={H100.rho:.0f})")

    # ---- 3. simulated T(N) curve agrees with the closed form -------------
    curve = out["curve"]
    print(f"  simulated N_max(0.2) = {out['nmax_simulated']} "
          f"(baseline N_bal0={out['baseline_n']}); T(N_bal0) = "
          f"{curve.baseline_time*1e6:.0f}us")

    # ---- 4. run an ACTUAL multi-position decode forward (tiny model) -----
    small = get_config(ARCH, reduced=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(small, gen, device)
    step = tiny_decode(small, params, np.random.default_rng(args.seed),
                       device)
    print(f"  tiny-model engine: budget={step['budget']}, ran one decode "
          f"forward with N={step['n']}, logits "
          f"{tuple(step['logits'].shape)} on {device.type} "
          f"(MoE kernel: {step['use_kernel']})")
    out.update(step, small=small, params=params)
    return out


if __name__ == "__main__":
    main()
