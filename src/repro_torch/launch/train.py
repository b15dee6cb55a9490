"""Training launcher: data + train step + checkpoints + restart on
failure, on one card.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
      --steps 100 --ckpt-dir ckpt
On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tiny \
      --steps 50 --ckpt-dir /tmp/ckpt

Weights are random, drawn from seed 0; batches come from the synthetic
stream (seed 0) or ``--data-path``'s binary shards.  Every ``--ckpt-every``
steps the state (params and AdamW state) is written in the background;
a run on a directory that holds a committed checkpoint resumes from it.
A checkpoint is labelled with the number of optimizer steps it holds
(the AdamW state's ``step``), so a resumed run repeats none, and the batch
stream is rebuilt at the restored step (at resume and after every
rollback), so it skips none either: a resumed run trains on the batches
an uninterrupted run would.  A failure while a batch is fetched is
retried in place; once the update has begun (it writes the state in
place, then the loss is read and the checkpoint snapshotted) a failure
rolls back to the last checkpoint instead.

The reference's multi-host flags (``--coordinator``, ``--sharding-policy``)
wait for the port's ``dist`` slice: this launcher runs one device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.dist.elastic import (StepWatchdog, UpdateInterrupted,
                                      elastic_mesh, run_with_restarts)
from repro_torch.models import init_model
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-path", default=None,
                    help="binary shard dir; default synthetic")
    return ap


def train(args) -> dict:
    """Run ``args.steps`` optimizer steps (from the latest checkpoint in
    ``--ckpt-dir``, if any).  Returns {"start": the step resumed at,
    "losses": the loss of each step run (floats, read back once, at the
    end), "state": {"params", "opt"} as it ends, "device"}."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.tiny)
    shape, axes = elastic_mesh(1)
    print(f"mesh {dict(zip(axes, shape))}  arch {cfg.name}  "
          f"device {device}")

    params = init_model(cfg, torch.Generator(device=device).manual_seed(SEED),
                        device)
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.global_batch,
                          path=args.data_path)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    watchdog = StepWatchdog(deadline_s=600.0)

    state = {"params": params, "opt": opt}
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        state, meta = restore(args.ckpt_dir, state, device=device)
        start = int(meta.get("step", 0))
        print(f"resumed at step {start}")
    stream = {"data": make_pipeline(data_cfg, start=start)}
    losses = {}

    def one_step(step: int) -> None:
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(stream["data"]).items()}
        try:
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch)
            losses[step] = metrics["loss"]
            dt = time.time() - t0
            watchdog.observe(dt)
            if step % 10 == 0:
                print(f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                      f"lr={float(metrics['lr']):.2e}  {dt:.2f}s")
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, {"step": step + 1})
        except Exception as exc:
            raise UpdateInterrupted(f"step {step} failed after its update "
                                    "began") from exc

    def restore_fn() -> int:
        ckpt.wait()
        restored, meta = restore(args.ckpt_dir, state, device=device)
        state.update(restored)
        step = int(meta.get("step", 0))
        stream["data"] = make_pipeline(data_cfg, start=step)
        print(f"rolled back to step {step}")
        return step

    run_with_restarts(one_step, start, args.steps, restore_fn)
    if args.steps % args.ckpt_every:
        ckpt.save(args.steps, state, {"step": args.steps})
    ckpt.wait()
    print("training complete; checkpoint committed")
    ordered = [losses[s] for s in sorted(losses)]
    return {"start": start, "device": device, "state": state,
            "losses": (torch.stack(ordered).tolist() if ordered else [])}


def main() -> None:
    train(build_parser().parse_args())


if __name__ == "__main__":
    main()
