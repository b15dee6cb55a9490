"""Closed-loop serving: ``clients`` clients, each sending its next request
the moment its last one finishes, through the port's ``ServingLoop``
(``submit`` / ``admit`` / ``step``) on a paged ``DecodeEngine`` whose
forwards replay CUDA graphs.

Set-up makes the weights from the seed, builds the engine and loop, and
captures the decode step (width 1 at the cell's batch) and the prefill
graph of every bucket the mix's prompts reach.  The window then opens:
every client submits, and the driver alternates ``admit`` and ``step``
until ``seconds`` have passed, each call inside a ``bench.<what>``
profiler span, with set-up's objects frozen out of the garbage
collector.  A request's first token is on the host when ``admit``
returns, its later ones when each ``step`` returns (each ends in the
tokens' readback), so the host clock after those calls times them.
With ``trace`` a stretch of the window runs under ``torch.profiler``.

After the window the program's state is freed and the float32
reference judges a sample of the finished requests, drawn from both
halves of the slots (``reference.check``), by ``verdict.judge``: the
program's numbers, and with the ``control`` hook the control's, against
the cell's limits.  Traffic keys: ``clients``, ``slots``,
``max_len``, ``kv_block_size``, ``prefix_cache``, ``prompt_len`` and
``output_len`` (``loadgen``), ``check`` (``max_requests``,
``min_tokens``), ``profile`` (``start_frac``, ``seconds``).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench import loadgen, model_config, verdict, weights
from bench import trace as tracing
from bench.reference import check
from bench.roofline import counts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(job, params, cfg):
    from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
    t = job.cell.traffic
    on_card = torch.device(job.device).type == "cuda"
    engine = DecodeEngine(
        cfg, params, batch=t["slots"], max_len=t["max_len"],
        paged=PagedKVConfig(block_size=t["kv_block_size"],
                            prefix_cache=t["prefix_cache"]),
        device=job.device, use_kernel=on_card, capture=on_card)
    hook = job.hooks.get("engine")
    if hook is not None:
        hook(engine)
    return engine, ServingLoop(engine, mode="greedy")


def run(job) -> Dict:
    t = job.cell.traffic
    conf = job.cell.config
    spec = model_config.shape_spec(conf)
    cfg = model_config.arch_config(conf)
    params = weights.make_params(cfg, conf, job.seed, job.device)
    engine, loop = build(job, params, cfg)
    engine.warm_decode([1])
    engine.warm_prefill(loadgen.prompt_buckets(t, engine.prefill_bucket))
    streams = loadgen.client_streams(t, job.seed, cfg.vocab_size)
    _sync(job.device)

    reqs: Dict[int, object] = {}       # rid -> Request
    submit_t: Dict[int, float] = {}
    first_t: Dict[int, float] = {}
    done_t: Dict[int, float] = {}
    client_of: Dict[int, int] = {}
    slot_of: Dict[int, int] = {}
    step_s: List[float] = []
    admit_s: List[float] = []
    decode_ctx: List[float] = []        # per step: sum over rows of context
    decode_rows: List[int] = []
    prompt_lens: List[int] = []
    stretch_steps: List[tuple] = []     # (lens of active rows, width)
    prof = None
    prof_t0 = prof_s = None
    log0, plog0 = len(loop.step_log), len(engine.prefill_log)
    rf = torch.profiler.record_function

    def submit(c: int, now: float) -> None:
        prompt, n_out = next(streams[c])
        req = loop.submit(prompt, n_out)
        reqs[req.rid] = req
        submit_t[req.rid] = now
        client_of[req.rid] = c

    # set-up's objects (the imports, the engine) leave the collector's
    # view: a full collection over them paused the loop for about 0.1 s,
    # once or twice a window, and moved the tails from run to run
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - job.t_start
    end = t0 + job.seconds
    pcfg = t.get("profile", {})
    p_start = t0 + pcfg.get("start_frac", 0.4) * job.seconds
    p_len = min(pcfg.get("seconds", 2.0), job.seconds / 4)
    for c in range(t["clients"]):
        submit(c, t0)
    n_done = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if job.trace and prof is None and now >= p_start:
            _sync(job.device)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_t0 = time.perf_counter()
        elif prof is not None and prof_s is None and now >= prof_t0 + p_len:
            _sync(job.device)
            prof_s = time.perf_counter() - prof_t0
            prof.stop()
        before = set(loop.active)
        ta = time.perf_counter()
        with rf("bench.admit"):
            n = loop.admit()
        tb = time.perf_counter()
        if n:
            admit_s.append(tb - ta)
            for s in set(loop.active) - before:
                rid = loop.active[s].rid
                first_t[rid] = tb
                slot_of[rid] = s
                prompt_lens.append(len(loop.active[s].prompt))
        if not loop.active:
            continue
        lens = engine.slot_lens_host[sorted(loop.active)].astype(np.float64)
        decode_ctx.append(float((lens + 1).sum()))
        decode_rows.append(len(lens))
        if prof is not None and prof_s is None:
            stretch_steps.append((lens, 1))
        ts = time.perf_counter()
        with rf("bench.step"):
            loop.step()
        te = time.perf_counter()
        step_s.append(te - ts)
        if len(loop.finished) > n_done:
            for rid in loop.finished:
                if rid not in done_t:
                    done_t[rid] = te
                    submit(client_of[rid], te)
            n_done = len(loop.finished)
    if prof is not None and prof_s is None:
        _sync(job.device)
        prof_s = time.perf_counter() - prof_t0
        prof.stop()
    _sync(job.device)
    t_end = time.perf_counter()
    window_s = t_end - t0
    gc.unfreeze()

    on_card = torch.device(job.device).type == "cuda"
    device = {"memory_peak_bytes": int(torch.cuda.max_memory_allocated())
              if on_card else 0}
    tokens = sum(min(len(r.generated), r.max_tokens) for r in reqs.values())
    rec = {
        "kind": "serve", "spec": spec, "setup_s": setup_s,
        "window_s": window_s, "tokens": tokens, "batch": engine.batch,
        "ttft_s": [first_t[r] - submit_t[r] for r in first_t],
        "tpot_s": [(done_t[r] - first_t[r]) / (reqs[r].max_tokens - 1)
                   for r in done_t if reqs[r].max_tokens > 1],
        "step_s": step_s, "admit_s": admit_s,
        "step_log": loop.step_log[log0:],
        "prefill_log": engine.prefill_log[plog0:],
        "decode_ctx": decode_ctx, "decode_rows": decode_rows,
        "prompt_lens": prompt_lens,
        "attempted": len(reqs), "failed": loop.rejected_total,
    }
    if prof is not None:
        stretch = tracing.reduce(prof, prof_s)
        device.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        rec["stretch"] = stretch
        rec["attn_bound_s"] = spec["layers"] * sum(
            counts.paged_attention_bound_s(spec, lens, n)
            for lens, n in stretch_steps)
        rec["breakdown"] = {"device_ops": stretch.top(stretch.ops),
                            "idle_gaps": stretch.top(stretch.gaps)}
        del prof
    rec["device"] = device

    # ---- the output check, once the program's state is freed -----------
    done = sorted(done_t)
    finished = [(reqs[r].prompt, reqs[r].tokens()) for r in done]
    upper = [int(slot_of[r] >= engine.batch // 2) for r in done]
    del engine, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ck = t["check"]
    picked = check.sample(finished, job.seed, ck["max_requests"],
                          ck["min_tokens"], upper)
    samples = [finished[i] for i in picked]
    gaps = check.served_gaps(params, spec, samples, job.device,
                             control=job.hooks.get("control", False))
    nums = check.numbers(gaps)
    compared = {"served_tokens_compared": (gaps["tokens"], 1)}
    rec["checks"], rec["correct"] = verdict.judge(nums, job.cell.limits,
                                                  compared)
    rec["readings"] = nums
    rec["gaps"] = gaps
    rec["held_kv_positions"] = (sum(decode_ctx) / len(decode_ctx)
                                if decode_ctx else 0.0)
    if job.hooks.get("control"):
        rec["control"] = check.numbers(gaps, "control")
        rec["control_checks"], rec["control_correct"] = verdict.judge(
            rec["control"], job.cell.limits, compared)
    return rec
