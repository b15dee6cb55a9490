"""Multi-request serving launcher: budget-aware continuous batching.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
      --requests 8 --slots 4 --serve-mode speculative --kv-block-size 16

On the CPU, at the reduced size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch granite_moe_3b_a800m --tiny --requests 6 --slots 2 \
      --serve-mode speculative --kv-block-size 16 --tokens 16

Weights are random, drawn from ``--seed``; prompts come from a numpy
generator with the same seed.  The ServingLoop splits the NFP budget of
the H100 spec across the concurrent requests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.models import init_model
from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop


def serve(args) -> None:
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.tiny)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(cfg, gen, device)
    paged = None
    if args.kv_block_size > 0:
        paged = PagedKVConfig(block_size=args.kv_block_size,
                              n_blocks=args.kv_blocks or None)
    eng = DecodeEngine(cfg, params, batch=args.slots, max_len=args.max_len,
                       paged=paged, device=device)
    loop = ServingLoop(eng, mode=args.serve_mode)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        loop.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                    args.tokens)
    kernels = {"decode_attention_dense": attn_ops.decode_attention_ragged,
               "decode_attention_paged": attn_ops.decode_attention_paged,
               "moe_ffn": moe_ops.grouped_ffn_padded}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = loop.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    s = loop.stats()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    budgets = [e["budget"] for e in loop.step_log] or [loop.budget()]
    print(f"arch={cfg.name} mode={args.serve_mode} slots={args.slots} "
          f"requests={args.requests} device={where} "
          f"kernel={eng.use_kernel} nfp_budget={min(budgets)}..{max(budgets)}")
    print(f"served {s['requests']} requests / {s['tokens']} tokens in "
          f"{dt:.3f}s ({s['forwards']} forwards, "
          f"{s['tokens_per_forward']:.2f} tok/fwd, "
          f"max {s['max_positions_per_forward']} positions/fwd)")
    print(f"throughput: {s['tokens'] / max(dt, 1e-9):.1f} tok/s on {where}")
    print("kernel launches: " + ", ".join(
        f"{name} {fn.launches}" for name, fn in kernels.items())
        + ("" if device.type == "cuda" else " (plain versions on the CPU)"))
    if paged is not None:
        print(f"paged kv: block_size={s['kv_block_size']} "
              f"blocks={s['kv_blocks']} peak_used={s['kv_blocks_peak']}  "
              f"prefix: {s['prefix_hits']}/{s['prefix_lookups']} hits, "
              f"{s['prefill_positions_saved']} prefill positions saved")
    for rid, toks in list(results.items())[:4]:
        print(f"  req {rid}: {toks[:16]} ...")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--tiny", action="store_true",
                    help="the reduced configuration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="cache slots (max concurrent requests)")
    ap.add_argument("--serve-mode", default="greedy",
                    choices=["greedy", "speculative"])
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="paged KV block size in positions (0 = dense "
                         "per-slot cache); must divide --max-len")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged pool size in blocks (0 = slots * max_len "
                         "/ block)")
    return ap


def main() -> None:
    ap = build_parser()
    args = ap.parse_args()
    if args.kv_blocks > 0 and args.kv_block_size <= 0:
        ap.error("--kv-blocks sizes the paged pool; add --kv-block-size")
    serve(args)


if __name__ == "__main__":
    main()
