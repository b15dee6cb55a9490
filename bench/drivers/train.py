"""A training job: the port's train step (forward, backward with remat's
recompute, micro-batch accumulation, clipping, AdamW), compiled per
batch shape as the port's launcher compiles it
(``training.capture.compiled_train_step(make_train_step(...))``: one
CUDA graph replayed per step on the card), fed one batch of token ids
per step, drawn on the device from the seed.

Set-up makes the weights from the seed and the optimizer state, and
calls that one step object once: the first call of a batch shape runs
eagerly and captures the graph.  It then puts the object's state back
at step 0 in place (the initial weights copied into the live leaves, as
the port's restore copies a checkpoint, zero moments, step 0), so that
the ``check_steps`` steps the check compares are all graph replays, as
the window's are.  Of them it reads each step's loss, the first step's
clipped gradient per leaf (from AdamW's first moment after it: ``m / (1
- b1)``) and each leaf's change after the last of them (f32 master
against the initial weights, kept on the host).  The window then
replays the same object for ``seconds``, at most one step queued behind
the running one, and ends in a ``synchronize``.  With ``trace`` a
stretch of it runs under ``torch.profiler``.

After the window the program's state is freed and the float32 reference
(``reference.train``) follows the same first steps from the same
weights and batches; ``verdict.judge`` holds the program's numbers, and
with the ``control`` hook the control's, to the cell's limits.  Traffic
keys: ``batch``, ``seq_len``, ``n_micro``,
``remat``, ``optimizer`` (the port's ``AdamWConfig`` fields),
``check_steps``, ``profile`` (``start_frac``, ``seconds``).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from bench import model_config, verdict, weights
from bench import trace as tracing
from bench.reference import train as ref_train


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _batches(job, vocab: int):
    """Endless (batch, seq_len) token batches from the seed, on the
    device; every call starts the same sequence again."""
    t = job.cell.traffic
    gen = torch.Generator(device=job.device).manual_seed(job.seed ^ 0x5EED)
    while True:
        yield {"tokens": torch.randint(0, vocab, (t["batch"], t["seq_len"]),
                                       generator=gen, device=job.device)}


def _leaf_norms(tree, scale: float = 1.0) -> Dict:
    from repro_torch.core.tree import leaves_with_paths
    paths, norms = [], []
    for path, t in leaves_with_paths(tree):
        paths.append(path)
        norms.append(torch.linalg.vector_norm(t.float()))
    return dict(zip(paths, (torch.stack(norms) * scale).tolist()))


def _change_norms(master, init_host: Dict, chunk: int = 1 << 24) -> Dict:
    """||master - init|| per leaf, the initial leaf brought back from the
    host a chunk at a time."""
    from repro_torch.core.tree import leaves_with_paths
    out = {}
    for path, m in leaves_with_paths(master):
        flat, host = m.reshape(-1), init_host[path].reshape(-1)
        acc = torch.zeros((), dtype=torch.float64, device=m.device)
        for i in range(0, flat.numel(), chunk):
            d = flat[i:i + chunk] - host[i:i + chunk].to(m.device).float()
            acc += torch.sum(torch.square(d), dtype=torch.float64)
        out[path] = acc
    return {k: float(torch.sqrt(v)) for k, v in out.items()}


def _restart(params, opt: Dict, init_host: Dict) -> None:
    """The step object's state back at step 0, in place: the weights and
    their f32 master from the initial weights, zero moments, step 0."""
    from repro_torch.core.tree import leaves_with_paths
    for tree in (params, opt["master"]):
        for path, x in leaves_with_paths(tree):
            x.copy_(init_host[path].to(x.device))
    for tree in (opt["m"], opt["v"]):
        for _, x in leaves_with_paths(tree):
            x.zero_()
    opt["step"].zero_()


def build(job, cfg, params):
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.capture import compiled_train_step
    t = job.cell.traffic
    on_card = torch.device(job.device).type == "cuda"
    fn = make_train_step(cfg, AdamWConfig(**t["optimizer"]),
                         n_micro=t["n_micro"], remat=t["remat"])
    hook = job.hooks.get("step_fn")
    if hook is not None:
        fn = hook(fn)
    return (compiled_train_step(fn, job.device, capture=on_card),
            init_opt_state(params))


def run(job) -> Dict:
    t = job.cell.traffic
    conf = job.cell.config
    spec = model_config.shape_spec(conf)
    cfg = model_config.arch_config(conf)
    if spec["experts"]:
        raise ValueError("the training reference has no MoE aux loss")
    on_card = torch.device(job.device).type == "cuda"
    params = weights.make_params(cfg, conf, job.seed, job.device)
    from repro_torch.core.tree import leaves_with_paths
    init_host = {p: x.to("cpu", copy=True)
                 for p, x in leaves_with_paths(params)}
    step, opt = build(job, cfg, params)
    feed = _batches(job, cfg.vocab_size)
    params, opt, _ = step(params, opt, next(feed))   # eager, then captured
    _restart(params, opt, init_host)
    feed = _batches(job, cfg.vocab_size)
    b1 = t["optimizer"]["b1"]
    losses: List[torch.Tensor] = []
    for i in range(t["check_steps"]):
        params, opt, m = step(params, opt, next(feed))
        losses.append(m["loss"])
        if i == 0:
            first_grad = _leaf_norms(opt["m"], 1.0 / (1.0 - b1))
    change = _change_norms(opt["master"], init_host)
    losses = torch.stack(losses).tolist()
    del init_host
    _sync(job.device)

    tokens_per_step = t["batch"] * t["seq_len"]
    t0 = time.perf_counter()
    setup_s = t0 - job.t_start
    end = t0 + job.seconds
    pcfg = t.get("profile", {})
    p_start = t0 + pcfg.get("start_frac", 0.4) * job.seconds
    p_len = min(pcfg.get("seconds", 2.0), job.seconds / 4)
    prof = prof_t0 = prof_s = None
    n_steps = 0
    done_prev = None
    while time.perf_counter() < end:
        now = time.perf_counter()
        if job.trace and prof is None and now >= p_start:
            _sync(job.device)
            done_prev = None
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_t0 = time.perf_counter()
        elif prof is not None and prof_s is None and now >= prof_t0 + p_len:
            _sync(job.device)
            done_prev = None
            prof_s = time.perf_counter() - prof_t0
            prof.stop()
        with torch.profiler.record_function("bench.train_step"):
            params, opt, _ = step(params, opt, next(feed))
        n_steps += 1
        if on_card:
            done = torch.cuda.Event()
            done.record()
            if done_prev is not None:      # at most one step queued
                done_prev.synchronize()
            done_prev = done
    if prof is not None and prof_s is None:
        _sync(job.device)
        prof_s = time.perf_counter() - prof_t0
        prof.stop()
    _sync(job.device)
    window_s = time.perf_counter() - t0

    device = {"memory_peak_bytes": int(torch.cuda.max_memory_allocated())
              if on_card else 0}
    rec = {"kind": "train", "spec": spec, "setup_s": setup_s,
           "window_s": window_s, "steps": n_steps,
           "tokens": n_steps * tokens_per_step,
           "attempted": n_steps, "failed": 0}
    if prof is not None:
        stretch = tracing.reduce(prof, prof_s)
        device.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        rec["stretch"] = stretch
        rec["breakdown"] = {"device_ops": stretch.top(stretch.ops),
                            "idle_gaps": stretch.top(stretch.gaps)}
        del prof
    rec["device"] = device

    # ---- the check, once the program's state is freed ------------------
    del step, params, opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    init = weights.make_params(cfg, conf, job.seed, job.device)
    feed = _batches(job, cfg.vocab_size)
    batches = [next(feed)["tokens"] for _ in range(t["check_steps"])]
    ref = ref_train.steps(init, spec, batches, t["optimizer"], t["n_micro"])
    lim = job.cell.limits
    vals = compare(losses, first_grad, change, ref)
    if job.hooks.get("control"):
        from bench.reference import model
        ctrl = ref_train.steps(init, spec, batches, t["optimizer"],
                               t["n_micro"], model.fp8_mm)
        rec["control"] = compare(ctrl["losses"], ctrl["first_grad"],
                                 ctrl["change"], ref)
        rec["control_checks"], rec["control_correct"] = verdict.judge(
            rec["control"], lim)
    rec["checks"], rec["correct"] = verdict.judge(vals, lim)
    keep = ref_train.moving(ref["first_grad"])
    rec["readings"] = {**vals, "program_losses": losses,
                       "reference_losses": ref["losses"],
                       "left_out": sorted(ref_train.path_name(k)
                                          for k in ref["first_grad"]
                                          if k not in keep)}
    return rec


def compare(losses, first_grad, change, ref) -> Dict[str, float]:
    """The three numbers of a run (or the control) against the reference:
    each step's loss by its relative gap, the first step's clipped
    gradient and the change after the last step by their worst leaf
    (leaves the reference's first gradient leaves unmoved left out of the
    change)."""
    keep = ref_train.moving(ref["first_grad"])
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(losses, ref["losses"])),
        "first_grad_worst_leaf": ref_train.worst_leaf(first_grad,
                                                      ref["first_grad"]),
        "change_worst_leaf": ref_train.worst_leaf(change, ref["change"],
                                                  keep),
    }
