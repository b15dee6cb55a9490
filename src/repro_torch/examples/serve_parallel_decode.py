"""Parallel-decoding serving demo: AR baseline vs NFP-budgeted
speculative decoding vs diffusion-style block decoding on one model.

Demonstrates the paper's capacity-normalized evaluation (Sec. J.2.3):
the same system-side budget, different algorithm-side utilization.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_parallel_decode

The model is reduced stablelm_3b with random weights from ``--seed`` on
``--device`` (``cuda`` unless given ``cpu``; on the card every decode
forward's attention is the hand-written kernel).  Wall times on the card
end in a synchronize.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serving import (DecodeEngine, DiffusionBlockDecoder,
                                 SpeculativeDecoder)

ARCH = "stablelm_3b"
TOKENS = 48
PROMPT_LEN = 12
MAX_LEN = 512


def _timed(device, fn):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run(cfg, params, prompt: np.ndarray, device) -> Dict:
    """The three decoders on fresh batch-1 engines over ``params`` for the
    (1, p) ``prompt``.  Returns each stream, its stats and wall seconds,
    the NFP budget and the lossless flag."""
    device = resolve_device(device)
    tokens = TOKENS

    def fresh():
        return DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN,
                            device=device)

    # --- AR baseline (N=1 per forward) ------------------------------------
    eng = fresh()
    ar, t_ar = _timed(device, lambda: eng.greedy_generate(
        torch.as_tensor(prompt, device=device), tokens)[0].cpu().numpy())

    # --- speculative, verification length from the NFP budget -------------
    eng = fresh()
    budget = eng.nfp_budget()
    spec = SpeculativeDecoder(eng, gamma=min(budget - 1, 8))
    (toks, stats), t_spec = _timed(device,
                                   lambda: spec.generate(prompt, tokens))
    lossless = bool(np.array_equal(ar, toks[:tokens]))

    # --- diffusion-style block decode --------------------------------------
    eng = fresh()
    diff = DiffusionBlockDecoder(eng, block_size=min(budget - 1, 12),
                                 refine_steps=3)
    (dtoks, dstats), t_diff = _timed(device,
                                     lambda: diff.generate(prompt, tokens))
    return {"budget": budget, "lossless": lossless,
            "ar": {"tokens": ar, "forwards": tokens, "seconds": t_ar},
            "speculative": {"tokens": toks, "stats": stats,
                            "seconds": t_spec},
            "diffusion": {"tokens": dtoks, "stats": dstats,
                          "seconds": t_diff}}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH, reduced=True)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(1, PROMPT_LEN))
    out = run(cfg, params, prompt, device)
    ar, spec, diff = out["ar"], out["speculative"], out["diffusion"]
    print(f"AR greedy:       {TOKENS} tokens, {ar['forwards']} forwards, "
          f"{ar['seconds']:.2f}s")
    stats = spec["stats"]
    print(f"speculative:     {stats['tokens']} tokens, "
          f"{stats['forwards']} forwards "
          f"({stats['tokens_per_forward']:.2f} tok/fwd, "
          f"utilization {stats['position_utilization']:.2f}), "
          f"{spec['seconds']:.2f}s")
    print(f"  lossless vs AR: {out['lossless']}  "
          f"(NFP budget={out['budget']})")
    dstats = diff["stats"]
    print(f"diffusion-block: {dstats['tokens']} tokens, "
          f"{dstats['forwards']} forwards "
          f"({dstats['tokens_per_forward']:.2f} tok/fwd, "
          f"utilization {dstats['position_utilization']:.2f}), "
          f"{diff['seconds']:.2f}s")
    print("\ncapacity-normalized view: all methods spend positions from the"
          "\nsame near-free budget; tokens/forward is the algorithm-side"
          "\nutilization the paper separates from system capacity.")
    out["prompt"] = prompt
    return out


if __name__ == "__main__":
    main()
