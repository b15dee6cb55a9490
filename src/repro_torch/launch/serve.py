"""Serving launcher: budget-aware continuous batching, one request
through a parallel-decoding driver, calibrated serving, or a trace replay.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
      --requests 8 --slots 4 --serve-mode speculative --kv-block-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch wedlm8b_like \
      --requests 8 --slots 4 --serve-mode diffusion --block-size 16
Calibrated serving (T(N) swept on the captured decode step of a dense
engine, then the BudgetController; ``load`` refuses a stale spec hash):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch wedlm8b_like \
      --requests 8 --serve-mode speculative --max-len 1024 \
      --calibration run --calibration-path calib.json
The pinned trace replay (``loadgen.PINNED_STACK``; wall clock on the card,
``--trace-clock simulated`` for the roofline model of ``--hardware``):
  PYTHONPATH=src python -m repro_torch.launch.serve --trace pinned \
      --bench-out BENCH_serving_h100.json

On the CPU, at the reduced size (the kernels' plain versions; calibration
on the simulator backend, replays on the simulated clock):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch granite_moe_3b_a800m --tiny --requests 6 --slots 2 \
      --serve-mode speculative --kv-block-size 16 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch llada_mini_like --tiny --requests 6 --slots 2 \
      --serve-mode diffusion --kv-block-size 16 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch falcon_mamba_7b --tiny --serve-mode greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch zamba2_1p2b --tiny --serve-mode greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tiny \
      --requests 4 --calibration run --calibration-path /tmp/c.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tiny \
      --trace pinned --requests 8
One request through a single-request driver (a dense engine of
``--batch`` rows, default 1; the drivers follow row 0, greedy returns
every row):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch wedlm8b_like --tiny --algorithm diffusion --tokens 24

A model with recurrent state (falcon_mamba_7b; the hybrid zamba2_1p2b)
serves greedy on the dense cache only: ``--kv-block-size`` and every
other serve mode are refused.  whisper_tiny is refused: its forward
needs frame embeddings, which no engine path passes (as in the
reference).

Weights (and the 4-head MTP bank) are random, drawn from ``--seed``,
unless ``--ckpt-dir`` names a directory of checkpoints: then every mode
serves the ``params`` of its newest committed checkpoint (one written by
either package's train launcher or by ``examples.train_lm``), in their
stored dtypes, on ``--device``; a directory without one raises, as does
a checkpoint whose params do not fit ``--arch``:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
      --steps 100 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
      --ckpt-dir ckpt --requests 8 --kv-block-size 16
Prompts come from a numpy generator seeded by ``--seed``.  The NFP budget
of the ``--hardware`` spec sizes every forward.  On the card every
forward replays a CUDA graph (``serving.capture``; ``--no-capture``: the
eager forwards), and the decode widths and prefill buckets a run can use
are captured before its clock starts.

``serve(args)`` returns what it served: the ``params``, the ``prompts``,
the ``streams`` and ``stats`` (and for the scheduler its ``loop``), and
with ``--ckpt-dir`` the ``restore_s`` the restore took (ending in a
synchronize).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.autotune import (BudgetController, calibrate_engine,
                                  load_table, save_table, spec_fingerprint)
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.granularity import GranularitySpec
from repro_torch.core.hardware import PRESETS, get_hardware
from repro_torch.core.simulate import decode_forward_cost
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.launch.specs import params_abstract
from repro_torch.loadgen import (PINNED_STACK, Trace, generate_trace,
                                 pinned_spec, replay_trace, scorecard)
from repro_torch.models import init_model
from repro_torch.serving import (AdmissionConfig, DecodeEngine,
                                 DiffusionBlockDecoder, MTPDecoder,
                                 PagedKVConfig, ServingLoop,
                                 SpeculativeDecoder, init_mtp_heads)

MODES = ["greedy", "speculative", "diffusion", "mtp"]
MTP_HEADS = 4
#: the NFP latency tolerance of every budget, calibration and replay
EPS = PINNED_STACK.eps
REQUESTS = 8
PINNED_TRACE_REQUESTS = 32
#: the reference's committed scorecard, which no replay of the port writes
REFERENCE_SCORECARD = "BENCH_serving.json"
KERNELS = {"decode_attention_dense": attn_ops.decode_attention_ragged,
           "decode_attention_paged": attn_ops.decode_attention_paged,
           "moe_ffn": moe_ops.grouped_ffn_padded,
           "mamba_scan": scan_ops.selective_scan_padded}


def _heads(args, cfg, device):
    gen = torch.Generator(device=device).manual_seed(args.seed + 5)
    return init_mtp_heads(gen, cfg.d_model, cfg.vocab_size, MTP_HEADS)


def _where(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine(args, cfg, params, device, batch, paged=None) -> DecodeEngine:
    return DecodeEngine(cfg, params, batch=batch, max_len=args.max_len,
                        hardware=get_hardware(args.hardware), paged=paged,
                        device=device,
                        capture=False if args.no_capture else None)


def _paged(args):
    if args.kv_block_size <= 0:
        return None
    return PagedKVConfig(block_size=args.kv_block_size,
                         n_blocks=args.kv_blocks or None)


def single_request(args, cfg, params, device) -> dict:
    """One request through the ``--algorithm`` driver on a dense engine of
    ``--batch`` rows, each its own prompt: greedy generates every row, the
    drivers follow row 0 (as the reference's)."""
    batch = args.batch or 1
    eng = _engine(args, cfg, params, device, batch=batch)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(batch, args.prompt_len))
    t0 = time.perf_counter()
    if args.algorithm == "greedy":
        out = eng.greedy_generate(torch.as_tensor(prompt, device=device),
                                  args.tokens).cpu().numpy()
        stats = {"tokens": batch * args.tokens, "forwards": args.tokens,
                 "tokens_per_forward": float(batch)}
    else:
        if args.algorithm == "speculative":
            dec = SpeculativeDecoder(eng)
        elif args.algorithm == "mtp":
            dec = MTPDecoder(eng, _heads(args, cfg, device))
        else:
            dec = DiffusionBlockDecoder(eng, block_size=args.block_size,
                                        refine_steps=args.refine_steps)
        row, stats = dec.generate(prompt, args.tokens)
        out = row[None]
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} algorithm={args.algorithm} device={device.type} "
          f"batch={batch} kernel={eng.use_kernel} "
          f"nfp_budget={eng.nfp_budget()}")
    print(f"generated {stats['tokens']} tokens in {dt:.3f}s "
          f"({stats['forwards']} forwards, "
          f"{stats['tokens_per_forward']:.2f} tok/fwd)")
    print("tokens:", out[0][:32], "...")
    return {"prompts": prompt, "streams": out, "stats": stats,
            "seconds": dt}


def calibration_controller(args, eng) -> BudgetController:
    """--calibration run|load: sweep (or load) the engine's calibration
    table and wrap it in a BudgetController."""
    key = spec_fingerprint(eng.cfg, eng.hardware, eng.gran,
                           (eng.use_kernel,), eng.batch, eps=EPS)
    if args.calibration == "run":
        t0 = time.perf_counter()
        table = calibrate_engine(eng, modes=(args.serve_mode,), eps=EPS)
        save_table(table, args.calibration_path)
        print(f"calibration: swept {len(table.buckets())} context buckets "
              f"via the {table.backend} backend in "
              f"{time.perf_counter() - t0:.1f}s on {_where(eng.device)} -> "
              f"{args.calibration_path} (key {table.key})")
    else:
        table = load_table(args.calibration_path, expect_key=key)
        print(f"calibration: loaded {args.calibration_path} "
              f"({table.backend} backend, key {table.key})")
    for e in sorted(table.entries, key=lambda e: e.ell):
        if e.mode == args.serve_mode and e.use_kernel == eng.use_kernel:
            print(f"  L<={e.ell}: analytic={e.analytic_nmax} "
                  f"measured={e.measured_nmax} "
                  f"calibrated={e.calibrated_budget} "
                  f"n_idle={e.n_idle:.1f} noise={e.noise:.3f} "
                  f"over-prediction={e.overprediction:.2f}x "
                  f"idle={e.idle_overprediction:.2f}x "
                  f"(limit={e.limiting})")
    return BudgetController(table=table)


def prefill_widths(eng: DecodeEngine, lengths, tokens: int) -> list:
    """The slotted prefill graphs a run of prompts of ``lengths`` x
    ``tokens`` new tokens may replay: an SSM model's exact prompt lengths;
    otherwise every bucket from 8 up to the longest context a preempted
    request is re-admitted with, which also covers a prefix hit's
    suffix.  An SSM model re-admits a preempted request at its exact
    context (prompt and the tokens generated so far), a length not
    warmed here: that graph is captured at its first use, inside the
    run's clock."""
    if eng.recurrent:
        return sorted(set(int(n) for n in lengths))
    top = eng.prefill_bucket(min(eng.max_len, max(lengths) + tokens))
    widths = [8]
    while widths[-1] < top:
        widths.append(eng.prefill_bucket(2 * widths[-1]))
    return widths


def warm(loop, lengths, tokens: int) -> None:
    """Capture every decode width the loop's adapter can ask for (up to
    ``max_width`` + 1 positions a row) and the prefill graphs of
    ``prefill_widths`` before the clock starts."""
    t0 = time.perf_counter()
    eng = loop.engine
    eng.warm_decode(range(1, loop.max_width + 2))
    eng.warm_prefill(prefill_widths(eng, lengths, tokens))
    if eng.capture:
        print("captured " + ", ".join(
            f"{n} {kind}" for kind, (n, _) in eng.graphs.summary().items())
            + f" graphs in {time.perf_counter() - t0:.1f}s")


def serve_requests(args, cfg, params, device) -> dict:
    """``--requests`` prompts through the ServingLoop (the default)."""
    paged = _paged(args)
    eng = _engine(args, cfg, params, device, batch=args.slots, paged=paged)
    controller = (calibration_controller(args, eng)
                  if args.calibration != "off" else None)
    loop = ServingLoop(
        eng, mode=args.serve_mode, eps=EPS, block_size=args.block_size,
        refine_steps=args.refine_steps, controller=controller,
        mtp_heads=(_heads(args, cfg, device) if args.serve_mode == "mtp"
                   else None))
    warm(loop, [args.prompt_len], args.tokens)
    rng = np.random.default_rng(args.seed)
    n_requests = args.requests if args.requests is not None else REQUESTS
    prompts = {}
    for _ in range(n_requests):
        p = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        prompts[loop.submit(p, args.tokens).rid] = p
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = loop.run()
    _sync(device)
    dt = time.perf_counter() - t0
    s = loop.stats()
    where = _where(device)
    budgets = [e["budget"] for e in loop.step_log] or [loop.budget()]
    print(f"arch={cfg.name} mode={args.serve_mode} slots={args.slots} "
          f"requests={n_requests} device={where} "
          f"kernel={eng.use_kernel} captured={eng.capture} "
          f"nfp_budget={min(budgets)}..{max(budgets)}")
    print(f"served {s['requests']} requests / {s['tokens']} tokens in "
          f"{dt:.3f}s ({s['forwards']} forwards, "
          f"{s['tokens_per_forward']:.2f} tok/fwd, "
          f"max {s['max_positions_per_forward']} positions/fwd)")
    print(f"throughput: {s['tokens'] / max(dt, 1e-9):.1f} tok/s on {where}")
    print("kernel launches: " + ", ".join(
        f"{name} {fn.launches}" for name, fn in KERNELS.items())
        + ("" if device.type == "cuda" else " (plain versions on the CPU)"))
    if controller is not None:
        cs = s["controller"]
        line = (f"budget control: analytic~{s['mean_budget_analytic']:.1f} "
                f"applied~{s['mean_budget']:.1f}")
        if "mean_budget_calibrated" in s:
            line += f" calibrated~{s['mean_budget_calibrated']:.1f}"
        if "max_latency_ratio" in s:
            line += (f"  latency ratio mean={s['mean_latency_ratio']:.2f} "
                     f"max={s['max_latency_ratio']:.2f}")
        line += (f"  (shrinks={cs['shrinks']} probes={cs['probes']} "
                 f"gated={cs['gated']})")
        print(line)
    if paged is not None:
        print(f"paged kv: block_size={s['kv_block_size']} "
              f"blocks={s['kv_blocks']} peak_used={s['kv_blocks_peak']}  "
              f"prefix: {s['prefix_hits']}/{s['prefix_lookups']} hits, "
              f"{s['prefill_positions_saved']} prefill positions saved")
    for rid, toks in list(results.items())[:4]:
        print(f"  req {rid}: {toks[:16]} ...")
    return {"prompts": prompts, "streams": results, "stats": s,
            "seconds": dt, "loop": loop}


def simulated_clock(arch: str, slots: int, hw):
    """Roofline latency of one (slots, width) forward of the FULL-SIZE
    ``arch`` at context ell on ``hw`` (``core.simulate``): the
    reference's replay clock."""
    cfg_full = get_config(arch)
    gran = GranularitySpec.for_backend(
        cfg_full.ffn.n_experts,
        head_dim=(cfg_full.attention.head_dim if cfg_full.attention
                  else 128))

    def clock(width: int, ell: int) -> float:
        return decode_forward_cost(cfg_full, slots, width,
                                   max(int(ell), 1), gran).time(hw)
    return clock


def trace_replay(args, cfg, params, device) -> dict:
    """--trace: replay a loadgen trace (the pinned spec or a trace JSON
    file) through the ServingLoop with backpressure, SLO-priority
    admission and preemption, on the wall clock or the simulated one."""
    if args.trace == "pinned":
        n = (args.requests if args.requests is not None
             else PINNED_TRACE_REQUESTS)
        spec = pinned_spec(n_requests=n)
        if spec.vocab_size > cfg.vocab_size:
            # the reduced models' vocabularies are smaller than the
            # pinned trace's; its token ids are drawn from theirs
            print(f"pinned trace: token ids drawn from {cfg.vocab_size}, "
                  f"the vocabulary of {cfg.name} (pinned: "
                  f"{spec.vocab_size})")
            spec = dataclasses.replace(spec, vocab_size=cfg.vocab_size)
        trace = generate_trace(spec)
    else:
        with open(args.trace) as f:
            trace = Trace.from_json(f.read())
    top = max((max(r.prompt) for r in trace.requests), default=0)
    if top >= cfg.vocab_size:
        raise ValueError(f"trace token id {top} is outside {cfg.name}'s "
                         f"vocabulary of {cfg.vocab_size}")
    hw = get_hardware(args.hardware)
    clock_name = args.trace_clock or ("wall" if device.type == "cuda"
                                      else "simulated")
    clock = (simulated_clock(args.arch, args.slots, hw)
             if clock_name == "simulated" else None)
    eng = _engine(args, cfg, params, device, batch=args.slots,
                  paged=_paged(args))
    loop = ServingLoop(
        eng, mode=args.serve_mode, eps=EPS, step_clock=clock,
        block_size=args.block_size, refine_steps=args.refine_steps,
        mtp_heads=(_heads(args, cfg, device) if args.serve_mode == "mtp"
                   else None),
        admission=AdmissionConfig(max_waiting=args.max_waiting or None,
                                  preemption=True))
    warm(loop, [len(r.prompt) for r in trace.requests],
         max((r.max_tokens for r in trace.requests), default=0))
    for fn in KERNELS.values():
        fn.launches = 0
    report = replay_trace(loop, trace)
    m = report["metrics"]
    s = report["serving"]
    where = _where(device)
    print(f"arch={cfg.name} mode={args.serve_mode} slots={args.slots} "
          f"device={where} captured={eng.capture} "
          f"trace={trace.fingerprint()} ({len(trace.requests)} requests)")
    unit = "virtual " if clock is not None else ""
    print(f"replayed {m['completed']} requests / {m['tokens']} tokens in "
          f"{report['makespan_s'] * 1e3:.2f} {unit}ms ({report['clock']} "
          f"clock{', ' + hw.name if clock is not None else ''})")
    if m["completed"]:
        print(f"ttft p50/p95/p99: {m['ttft_p50_s'] * 1e3:.2f} / "
              f"{m['ttft_p95_s'] * 1e3:.2f} / {m['ttft_p99_s'] * 1e3:.2f} ms"
              f"  itl p50/p95: {(m['itl_p50_s'] or 0) * 1e3:.2f} / "
              f"{(m['itl_p95_s'] or 0) * 1e3:.2f} ms")
    print(f"goodput {m['goodput_tok_s']:.1f} tok/s of "
          f"{m['throughput_tok_s']:.1f} tok/s "
          f"(SLO attainment {m['slo_attainment']})")
    print(f"serving: {s['tokens']} tokens, {s['forwards']} forwards, "
          f"{s['preemptions']} preemptions, {s['resumes']} resumes, "
          f"{s['rejections']} rejections, "
          f"{s['prefill_positions_computed']} prefill positions computed, "
          f"{s.get('prefill_positions_saved', 0)} saved")
    print("kernel launches: " + ", ".join(
        f"{name} {fn.launches}" for name, fn in KERNELS.items()))
    for name, g in m["per_class"].items():
        print(f"  [{name}] {g['completed']}/{g['requests']} completed, "
              f"{g['rejected']} rejected, "
              f"goodput={g['goodput_tok_s']:.1f} tok/s, "
              f"attainment={g['slo_attainment']}")
    if args.bench_out:
        stack = dataclasses.replace(
            PINNED_STACK, arch=args.arch, mode=args.serve_mode,
            slots=args.slots, max_len=args.max_len,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            max_waiting=args.max_waiting)
        text = scorecard(report, stack, hardware=hw.name, device=where,
                         trace_seed=trace.spec.seed,
                         trace_requests=len(trace.requests),
                         reduced=args.tiny)
        with open(args.bench_out, "w") as f:
            f.write(text)
        print(f"wrote {args.bench_out}")
    return {"prompts": {r.rid: r.prompt for r in trace.requests},
            "streams": report["streams"], "stats": s,
            "report": report}


def apply_pinned_stack(args) -> None:
    """``--trace pinned`` replays on ``PINNED_STACK``: its arch, mode,
    slots, cache, pool and queue bound replace the flags'."""
    st = PINNED_STACK
    args.arch, args.serve_mode, args.slots = st.arch, st.mode, st.slots
    args.max_len, args.kv_block_size = st.max_len, st.kv_block_size
    args.kv_blocks, args.max_waiting = st.kv_blocks, st.max_waiting


def load_params(cfg, ckpt_dir: str, device) -> dict:
    """The ``params`` subtree of the newest committed checkpoint in
    ``ckpt_dir`` (an ``opt`` beside it is not read), in its stored dtypes,
    on ``device``.  The target tree is ``cfg``'s, built from fake tensors:
    nothing is drawn or allocated for it."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"--ckpt-dir {ckpt_dir}: no committed "
                                "checkpoint to serve")
    restored, _ = restore(ckpt_dir, {"params": params_abstract(cfg)},
                          step=step, device=device)
    print(f"loaded checkpoint step {step} from {ckpt_dir}")
    return restored["params"]


def serve(args) -> dict:
    """Serve as the flags say; returns what was served (see the module's
    docstring) with the ``params`` it used."""
    device = resolve_device(args.device)
    if args.trace == "pinned":
        apply_pinned_stack(args)
    cfg = get_config(args.arch, reduced=args.tiny)
    restore_s = None
    if args.ckpt_dir is not None:
        t0 = time.perf_counter()
        params = load_params(cfg, args.ckpt_dir, device)
        _sync(device)
        restore_s = time.perf_counter() - t0
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_model(cfg, gen, device)
    if args.trace is not None:
        out = trace_replay(args, cfg, params, device)
    elif args.algorithm is not None:
        out = single_request(args, cfg, params, device)
    else:
        out = serve_requests(args, cfg, params, device)
    out["params"] = params
    if restore_s is not None:
        out["restore_s"] = restore_s
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--tiny", action="store_true",
                    help="the reduced configuration")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts, and of the random weights "
                         "without --ckpt-dir")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest committed "
                         "checkpoint in this directory (raising if it holds "
                         "none) instead of random weights; the calibration "
                         "key does not see the weights, as the "
                         "reference's does not")
    ap.add_argument("--hardware", default="h100", choices=sorted(PRESETS),
                    help="hardware spec of the NFP budget and the "
                         "simulator")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default 8); with --trace "
                         "pinned, the trace's length (default 32)")
    ap.add_argument("--slots", type=int, default=4,
                    help="cache slots (max concurrent requests)")
    ap.add_argument("--serve-mode", default="greedy", choices=MODES)
    ap.add_argument("--algorithm", default=None, choices=MODES,
                    help="serve ONE request through this single-request "
                         "driver (a dense engine of --batch rows) instead "
                         "of the scheduler; --requests and --slots are "
                         "ignored")
    ap.add_argument("--batch", type=int, default=None,
                    help="--algorithm only: the engine's rows, each with its "
                         "own prompt (default 1); greedy generates every "
                         "row, the other drivers follow row 0.  The "
                         "scheduler sizes its batch by --slots")
    ap.add_argument("--block-size", type=int, default=None,
                    help="diffusion block size (default: the NFP budget)")
    ap.add_argument("--refine-steps", type=int, default=4,
                    help="diffusion refinement forwards per block")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="paged KV block size in positions (0 = dense "
                         "per-slot cache); must divide --max-len")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged pool size in blocks (0 = slots * max_len "
                         "/ block)")
    ap.add_argument("--no-capture", action="store_true",
                    help="run every decode forward eagerly instead of "
                         "replaying a CUDA graph per width")
    ap.add_argument("--calibration", default="off",
                    choices=["off", "run", "load"],
                    help="'run' sweeps T(N) on the engine (the captured "
                         "step on the card, the simulator on the CPU), "
                         "saves the table and serves with the "
                         "BudgetController; 'load' serves with a saved "
                         "table, refusing a stale spec hash")
    ap.add_argument("--calibration-path", default="nfp_calibration.json",
                    help="calibration table path for --calibration")
    ap.add_argument("--trace", default=None,
                    help="replay a loadgen trace: 'pinned' (the pinned "
                         "spec on loadgen.PINNED_STACK) or a trace JSON "
                         "path (loadgen.Trace)")
    ap.add_argument("--trace-clock", default=None,
                    choices=["wall", "simulated"],
                    help="replay clock (default: wall on the card, "
                         "simulated on the CPU): the roofline model of the "
                         "full-size --arch on --hardware")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="trace mode: bound the waiting queue "
                         "(backpressure; 0 = unbounded)")
    ap.add_argument("--bench-out", default=None,
                    help="trace mode: write the replay's JSON scorecard "
                         "here")
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    if args.kv_blocks > 0 and args.kv_block_size <= 0:
        ap.error("--kv-blocks sizes the paged pool; add --kv-block-size")
    if args.batch is not None and (args.algorithm is None
                                   or args.batch < 1):
        ap.error("--batch sizes the engine of --algorithm (at least 1); "
                 "the scheduler sizes its batch by --slots")
    if args.algorithm is not None and args.kv_block_size > 0:
        ap.error("--algorithm drives a dense engine; drop "
                 "--kv-block-size")
    if args.calibration != "off" and (args.algorithm is not None
                                      or args.trace is not None):
        ap.error("--calibration tunes the multi-request scheduler; drop "
                 "--algorithm and --trace")
    if args.trace is None and (args.bench_out or args.trace_clock):
        ap.error("--bench-out and --trace-clock belong to --trace")
    if args.bench_out and (os.path.basename(args.bench_out)
                           == REFERENCE_SCORECARD):
        ap.error(f"{REFERENCE_SCORECARD} is the reference's scorecard; "
                 "write the port's elsewhere (e.g. BENCH_serving_h100.json)")


def main() -> None:
    ap = build_parser()
    args = ap.parse_args()
    check_args(ap, args)
    serve(args)


if __name__ == "__main__":
    main()
