"""End-to-end training driver: ~100M-parameter dense LM for a few hundred
steps on the synthetic pipeline, with checkpoint/restart fault tolerance.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--tiny]

The ~100M config is a starcoder2-family model (same code path as the
full 3B); --tiny switches to the smoke config for CI-speed runs.  It
trains on ``--device`` (``cuda`` unless given ``cpu``); weights come from
``--seed``, batches from the synthetic stream (seed 0).

A checkpoint is labelled with the optimizer steps it holds, and a run on
a directory that holds one resumes there with the stream rebuilt at that
step, so a resumed run trains on the batches an uninterrupted run would.
The step time printed ends in a synchronize on the card.  On the card
the step is compiled per batch shape, as the reference jit-compiles it:
the first step runs eagerly and captures a CUDA graph, every later one
replays it (``training.capture``; ``--no-capture`` runs it eagerly), and
a checkpoint is restored on the CPU and copied into the live state.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.core.arch import ArchConfig, AttentionSpec, FFNSpec
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.dist.elastic import StepWatchdog
from repro_torch.models import init_model
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.capture import compiled_train_step


def model_100m() -> ArchConfig:
    return ArchConfig(
        name="dense-100m", family="dense", n_layers=8, d_model=768,
        vocab_size=32768,
        attention=AttentionSpec(kind="gqa", n_heads=12, n_kv_heads=4,
                                head_dim=64),
        ffn=FFNSpec(kind="dense", d_ff=2048, activation="swiglu"),
        tie_embeddings=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--no-capture", action="store_true",
                    help="run the step eagerly on the card (no CUDA graph)")
    return ap


def main(argv=None) -> Dict:
    """Returns {"cfg", "n_params", "start": the step resumed at,
    "compiled": the compiled step's graphs and first-call seconds,
    "losses" and "step_s" of each step run, "tokens_s" (median step),
    "state": {"params", "opt"} as it ends}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("starcoder2_3b", reduced=True) if args.tiny \
        else model_100m()
    params = init_model(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  device "
          f"{device}")

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    state = {"params": params, "opt": init_opt_state(params)}
    step_fn = compiled_train_step(
        make_train_step(cfg, opt_cfg, n_micro=2), device,
        capture=device.type == "cuda" and not args.no_capture)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=2)
    start = 0
    if latest_step(args.ckpt_dir) is not None:    # restart-after-failure
        # into the live leaves, which the captured step holds
        restored, meta = restore(args.ckpt_dir, state, device="cpu")
        for live, new in zip(leaves(state), leaves(restored)):
            live.copy_(new)
        start = int(meta.get("step", 0))
        print(f"resumed from checkpoint at step {start}")
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch), start=start)

    watchdog = StepWatchdog(deadline_s=120.0)
    losses, step_s = [], []
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        t0 = time.perf_counter()
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        watchdog.observe(dt)
        losses.append(metrics["loss"])
        step_s.append(dt)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss={float(metrics['loss']):.4f}  "
                  f"ce={float(metrics['ce']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"lr={float(metrics['lr']):.2e}  {dt:.2f}s/step")
        if (step + 1) % args.ckpt_every == 0:
            # labelled with the updates it holds: a resume repeats none
            ckpt.save(step + 1, state, {"step": step + 1})
    if args.steps % args.ckpt_every:
        ckpt.save(args.steps, state, {"step": args.steps})
    ckpt.wait()
    print("done; final checkpoint committed")
    tokens_s = (args.batch * args.seq / statistics.median(step_s)
                if step_s else None)
    return {"cfg": cfg, "n_params": n_params, "start": start,
            "compiled": step_fn.summary(),
            "losses": torch.stack(losses).tolist() if losses else [],
            "step_s": step_s, "tokens_s": tokens_s, "state": state}


if __name__ == "__main__":
    main()
