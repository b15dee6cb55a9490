"""Training launcher: data + train step + checkpoints + restart on
failure, on one card or sharded over a process group.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
      --steps 100 --ckpt-dir ckpt
On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tiny \
      --steps 50 --ckpt-dir /tmp/ckpt
On one card the step is compiled per batch shape, as the reference
jit-compiles it: its first call runs eagerly and captures a CUDA graph,
every later call replays it (``training.capture``); ``--no-capture``
runs it eagerly (over the same static batch buffers), as ``--device cpu``
does.
Sharded, one process per rank (no ``torchrun`` needed):
  RANK=r WORLD_SIZE=n PYTHONPATH=src python -m repro_torch.launch.train \
      --coordinator host:port --sharding-policy fsdp ...
``--coordinator`` (``host:port``, or any ``torch.distributed`` init URL
such as ``file:///path``) or the ``RANK`` / ``WORLD_SIZE`` environment
(then ``env://``: ``MASTER_ADDR`` / ``MASTER_PORT``) joins a process
group, NCCL on the card (one rank per GPU, ``LOCAL_RANK``) and gloo with
``--device cpu``; a group already initialised by the caller is used as
it is.  The mesh is ``elastic_mesh(world size)``; each rank keeps its
shards of the params and the AdamW state under ``--sharding-policy``
(``dist.sharded_train``: every step gathers the params over the data
axes only; each rank computes the gradients of its rows of the global
batch on its model-axis shards, tensor-parallel where
``dist.tensor_parallel.tp_plan`` splits a block on head or channel
boundaries and whole where it does not; the gradients are averaged over
the ranks that split the batch).  Every
rank draws the same global batch from the stream and takes its rows, so
a run gives the same batches at every world size.  The sharded step is
not captured: its collectives run over gloo in every run one card can
give, and a gloo collective cannot be captured.

Weights are random, drawn from seed 0; batches come from the synthetic
stream (seed 0) or ``--data-path``'s binary shards.  Every ``--ckpt-every``
steps the state (params and AdamW state; gathered full when sharded, and
written by rank 0) is written in the background; a run on a directory
that holds a committed checkpoint resumes from it, at any world size.
A checkpoint is labelled with the number of optimizer steps it holds
(the AdamW state's ``step``), so a resumed run repeats none, and the batch
stream is rebuilt at the restored step (at resume and after every
rollback), so it skips none either: a resumed run trains on the batches
an uninterrupted run would.  A failure while a batch is fetched is
retried in place; once the update has begun (it writes the state in
place, then the loss is read and the checkpoint snapshotted) a failure
rolls back to the last checkpoint instead.  A checkpoint is restored on
the CPU and copied into the live state (the captured step holds its
tensors): the card never holds two copies of the state.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.dist.elastic import (StepWatchdog, UpdateInterrupted,
                                      elastic_mesh, run_with_restarts)
from repro_torch.dist.sharded_train import (gather, make_sharded_train_step,
                                            state_placements)
from repro_torch.dist.sharding import shard_tree
from repro_torch.core.tree import leaves
from repro_torch.models import init_model
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.capture import compiled_train_step

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
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or an init URL) of the process group")
    ap.add_argument("--sharding-policy", default="auto",
                    choices=["auto", "fsdp", "tp_only", "dp_only"])
    ap.add_argument("--no-capture", action="store_true",
                    help="run the unsharded step eagerly on the card "
                         "(no CUDA graph)")
    return ap


def init_distributed(args, device: torch.device):
    """(whether the run is sharded, the device): joins the process group
    ``--coordinator`` or the environment names, unless one exists."""
    if not dist.is_initialized():
        if args.coordinator is None and "WORLD_SIZE" not in os.environ:
            return False, device
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        url = args.coordinator or "env://"
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=url, rank=rank, world_size=world)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return True, device


def train(args) -> dict:
    """Run ``args.steps`` optimizer steps (from the latest checkpoint in
    ``--ckpt-dir``, if any).  Returns {"start": the step resumed at,
    "losses": the loss of each step run (floats, read back once, at the
    end), "state": {"params", "opt"} as it ends (DTensors when sharded),
    "device", "mesh" and "placements" (None unsharded)}."""
    device = resolve_device(args.device)
    sharded, device = init_distributed(args, device)
    world = dist.get_world_size() if sharded else 1
    lead = not sharded or dist.get_rank() == 0
    cfg = get_config(args.arch, reduced=args.tiny)
    shape, axes = elastic_mesh(world)
    mesh = None
    if sharded:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    if lead:
        print(f"mesh {dict(zip(axes, shape))}  arch {cfg.name}  "
              f"device {device}"
              + (f"  policy {args.sharding_policy}" if sharded else ""))

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_model(cfg, gen, device)
    state = {"params": params, "opt": init_opt_state(params)}
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    placements = None
    if sharded:
        placements = state_placements(state, mesh, args.sharding_policy)
        state = shard_tree(state, placements, mesh)
        del params
        step_fn = make_sharded_train_step(
            cfg, opt_cfg, mesh, placements, args.global_batch,
            args.sharding_policy, n_micro=args.n_micro,
            params=state["params"])
    else:
        step_fn = compiled_train_step(
            make_train_step(cfg, opt_cfg, n_micro=args.n_micro), device,
            capture=device.type == "cuda" and not args.no_capture)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.global_batch,
                          path=args.data_path)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    watchdog = StepWatchdog(deadline_s=600.0)

    def save(step: int) -> None:
        # a sharded state is gathered on every rank, written by rank 0
        full = gather(state) if sharded else state
        if lead:
            ckpt.save(step, full, {"step": step})

    def load() -> int:
        if sharded:
            restored, meta = restore(args.ckpt_dir, state, device=device,
                                     shardings=placements, mesh=mesh)
            state.update(restored)
        else:
            # into the live leaves, which the captured step holds
            restored, meta = restore(args.ckpt_dir, state, device="cpu")
            for live, new in zip(leaves(state), leaves(restored)):
                live.copy_(new)
        return int(meta.get("step", 0))

    start = 0
    if latest_step(args.ckpt_dir) is not None:
        start = load()
        if lead:
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
            if step % 10 == 0 and lead:
                print(f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                      f"lr={float(metrics['lr']):.2e}  {dt:.2f}s")
            if (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        except Exception as exc:
            raise UpdateInterrupted(f"step {step} failed after its update "
                                    "began") from exc

    def restore_fn() -> int:
        ckpt.wait()
        if sharded:
            dist.barrier()
        step = load()
        stream["data"] = make_pipeline(data_cfg, start=step)
        print(f"rolled back to step {step}")
        return step

    run_with_restarts(one_step, start, args.steps, restore_fn)
    if args.steps % args.ckpt_every:
        save(args.steps)
    ckpt.wait()
    if sharded:
        dist.barrier()
    if lead:
        print("training complete; checkpoint committed")
    ordered = [losses[s] for s in sorted(losses)]
    return {"start": start, "device": device, "state": state, "mesh": mesh,
            "placements": placements,
            "losses": (torch.stack(ordered).tolist() if ordered else [])}


def main() -> None:
    try:
        train(build_parser().parse_args())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
