#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   — require CUDA, print the card's name and power limit.
  2. build    — compile csrc/decode_attention.cu with nvcc (sm_90a).
  3. kernels  — both decode-attention kernels (dense slots, paged pool)
                against their plain PyTorch version at stablelm_3b
                (h = kv = 32, dh = 80) and wedlm8b_like (h = 32, kv = 8,
                dh = 128) shapes: n in {1, 4, 16, 65}, ragged lengths
                with an empty and a full row, fragmented and reversed
                block tables, with and without a window; the executed kv
                tiles must equal slack_report's.  Then times each kernel,
                its plain version and scaled_dot_product_attention (the
                library yardstick, never called by the port).
  4. serving  — full-size stablelm_3b with seeded random weights, 4 slots,
                max_len 256, 8 requests of 48-token prompts (two share
                their first 32 tokens) x 32 new tokens: paged greedy,
                paged speculative, dense greedy.  Checks completion, the
                launch counts (32 layers x decode-shape forwards), and that
                the paged speculative and the dense greedy streams equal
                the paged greedy ones up to bf16 near-ties.
                Then one full-size forward through the kernels against
                the same forward through the plain attention, and a
                torch.profiler view of 4 decode steps (device busy share,
                top kernels).
  5. report   — one JSON line of kernels, the card line, and the final
                {"ok": true, ...} line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# bf16 keeps 8 significant bits: kernel (f32 scores and probabilities) and
# plain version (scores and probabilities rounded to bf16, as the
# reference's ref.py) differ by a few bf16 steps of outputs of magnitude <~ 2
KERNEL_ATOL = 3e-2
KERNEL_RTOL = 2e-2
# kernel vs plain attention inside the full model: each layer's attention
# output differs by bf16 rounding, and 32 residual layers carry it on
# (measured 1.7e-2 relative on an H100)
FORWARD_RTOL = 5e-2
# a verify forward of width 16 and a width-1 forward, or the dense kernel's
# 128-position kv tile and the paged kernel's 16-position page, sum in a
# different order and round differently in bf16; a stream may leave the
# paged greedy one only where the top-2 logits were within 2 bf16 steps
# (2^-5 each in [4, 8)) of each other
GAP_TOL = 2 * 2.0 ** -5
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
MAX_LEN = 256
LAYERS = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters: int = 30) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after
    the L2 cache was overwritten (a 64 MB write > the 50 MB L2), as a
    model forward finds a layer's cache cold.  A sleep kernel first backs
    up the stream, so the host enqueues every launch before the device
    reaches it and the events time device work, not host launch gaps."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)             # ~50 ms of device time
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version
# ---------------------------------------------------------------------------

def kernel_inputs(*, paged, n, h, kv, dh, lens, layout="", seed=0):
    """q plus a dense cache, or the same content packed into a paged pool
    whose pages follow ``layout``; the trash page holds large junk that a
    leaking mask would show."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lens)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q = randn(b, n, h, dh)
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    if not paged:
        return q, randn(b, MAX_LEN, kv, dh), randn(b, MAX_LEN, kv, dh), \
            lens_t, None
    bs = 16
    max_blocks = MAX_LEN // bs
    n_phys = b * max_blocks + 1                        # + trash page
    order = np.arange(n_phys - 1)
    if layout == "fragmented":
        np.random.default_rng(seed).shuffle(order)
    elif layout == "reversed":
        order = order[::-1]
    tables = np.full((b, max_blocks), n_phys - 1, np.int32)
    for bi, ln in enumerate(lens):
        need = -(-(ln + n) // bs)
        tables[bi, :need] = order[bi * max_blocks:bi * max_blocks + need]
    k_pool = randn(n_phys, bs, kv, dh)
    v_pool = randn(n_phys, bs, kv, dh)
    k_pool[-1] = 100.0
    v_pool[-1] = 100.0
    return q, k_pool, v_pool, lens_t, torch.as_tensor(tables, device="cuda")


def check_kernels(ops) -> dict:
    """Every case of phase 3; returns the max abs error per kernel."""
    shapes = {"stablelm_3b": (32, 32, 80), "wedlm8b_like": (32, 8, 128)}
    err = {"dense": 0.0, "paged": 0.0}
    cases = 0
    for shape, (h, kv, dh) in shapes.items():
        for paged in (False, True):
            for n in (1, 4, 16, 65):
                lens = [0, 37, 150, MAX_LEN - n]
                for window in (None, 48):
                    for layout in (("fragmented", "reversed") if paged
                                   else ("",)):
                        q, k, v, lens_t, bt = kernel_inputs(
                            paged=paged, n=n, h=h, kv=kv, dh=dh,
                            lens=lens, layout=layout, seed=cases)
                        tiles = torch.zeros(1, dtype=torch.int32,
                                            device="cuda")
                        if paged:
                            out = ops.decode_attention_paged(
                                q, k, v, lens_t, bt, window=window,
                                tiles=tiles)
                            ref = ops.decode_attention_paged_ref(
                                q, k, v, lens_t, bt, window=window)
                            rep = ops.slack_report(n, lens, MAX_LEN,
                                                   head_dim=dh, k_block=16,
                                                   window=window)
                        else:
                            out = ops.decode_attention_ragged(
                                q, k, v, lens_t, window=window, tiles=tiles)
                            ref = ops.decode_attention_ref(
                                q, k, v, lens_t, window=window)
                            rep = ops.slack_report(n, lens, MAX_LEN,
                                                   head_dim=dh,
                                                   window=window)
                        torch.cuda.synchronize()
                        mode = "paged" if paged else "dense"
                        e = (out.float() - ref.float()).abs()
                        bad = e > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
                        err[mode] = max(err[mode], float(e.max()))
                        where = (f"{mode} {shape} n={n} window={window} "
                                 f"{layout}")
                        if not torch.isfinite(out).all() or bad.any():
                            raise AssertionError(
                                f"kernel disagrees with its plain version: "
                                f"{where}: max abs err {float(e.max()):.4g}")
                        want = kv * rep["kv_tiles_executed"]
                        if int(tiles.item()) != want:
                            raise AssertionError(
                                f"{where}: kernel ran {int(tiles.item())} kv "
                                f"tiles, slack_report says {want}")
                        cases += 1
    print(f"kernels: {cases} cases agree with the plain version within "
          f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL} (bf16); executed kv tiles "
          f"== slack_report; max abs err dense={err['dense']:.4g} "
          f"paged={err['paged']:.4g}")
    return err


def kernel_bound_ms(lens, n, h, kv, dh, paged) -> tuple:
    """Least time for one call: K/V of the visible positions, q, o, lens
    (and the block table) each moved once, against the score and P·V
    multiply-adds at the bf16 tensor rate.  Returns (ms, 'bytes'|'operations')."""
    b = len(lens)
    visible = sum(ln + n for ln in lens)
    bytes_ = (2 * kv * dh * 2 * visible + 2 * b * n * h * dh * 2 + 4 * b
              + (4 * b * MAX_LEN // 16 if paged else 0))
    flops = sum(4 * h * dh * (ln + j + 1) for ln in lens for j in range(n))
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(ops, n: int) -> dict:
    """Kernel, plain and library times at the serving shapes of
    stablelm_3b (4 slots mid-stream, n query positions per row)."""
    F = torch.nn.functional
    h, kv, dh = 32, 32, 80
    lens = [64, 72, 80, 96]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for paged in (False, True):
        q, k, v, lens_t, bt = kernel_inputs(paged=paged, n=n, h=h,
                                            kv=kv, dh=dh, lens=lens,
                                            layout="fragmented", seed=7)
        if paged:
            kern = lambda: ops.decode_attention_paged(q, k, v, lens_t, bt)  # noqa: E731
            plain = lambda: ops.decode_attention_paged_ref(q, k, v, lens_t, bt)  # noqa: E731
            k_virt, v_virt = ops.paged_gather(k, bt), ops.paged_gather(v, bt)
        else:
            kern = lambda: ops.decode_attention_ragged(q, k, v, lens_t)  # noqa: E731
            plain = lambda: ops.decode_attention_ref(q, k, v, lens_t)  # noqa: E731
            k_virt, v_virt = k, v
        s = k_virt.shape[1]
        q_pos = lens_t[:, None] + torch.arange(n, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, None, :]
                <= q_pos[:, :, None])[:, None]
        qt = q.transpose(1, 2).contiguous()
        kt = k_virt.transpose(1, 2).contiguous()
        vt = v_virt.transpose(1, 2).contiguous()
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        bound, by = kernel_bound_ms(lens, n, h, kv, dh, paged)
        # the same bound with K/V counted per executed tile, as the kernel
        # reads it (tile quantization included)
        kb = 16 if paged else ops.K_BLOCK
        tiles = ops.slack_report(n, lens, MAX_LEN, head_dim=dh,
                                 k_block=kb)["kv_tiles_executed"]
        tile_bytes = (2 * tiles * kv * kb * dh * 2
                      + 2 * len(lens) * n * h * dh * 2)
        out["paged" if paged else "dense"] = {
            "ms": time_ms(kern, flush),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "bound_ms": bound, "bound_by": by,
            "tile_bound_ms": tile_bytes / PEAK_BYTES_S * 1e3}
    return out


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def top2_gap(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def record_gaps(loop):
    """Wrap the loop's prefill and ``shared_forward`` to keep the top-2
    logit gap before every token a greedy stream takes: per call, a map
    of row -> (request, stream index) and the gaps by row (device
    tensors; read at the end)."""
    rec = []
    inner_forward = loop.shared_forward
    inner_prefill = loop.engine.prefill_slots
    inner_admit = loop.admit
    prefilled = {}

    def prefill_slots(*args, **kw):
        outs = inner_prefill(*args, **kw)
        prefilled.update(outs)
        return outs

    def admit():
        prefilled.clear()
        admitted = inner_admit()
        fresh = [s for s in sorted(prefilled)
                 if len(loop.active[s].generated) == 1]
        if fresh:
            rec.append(({i: (loop.active[s].rid, 0)
                         for i, s in enumerate(fresh)},
                        top2_gap(torch.stack([prefilled[s][0]
                                              for s in fresh]))))
        return admitted

    def shared_forward(tokens, budget):
        logits, cache, hidden = inner_forward(tokens, budget)
        rec.append(({s: (r.rid, len(r.generated))
                     for s, r in loop.active.items()},
                    top2_gap(logits[:, 0])))
        return logits, cache, hidden

    loop.engine.prefill_slots = prefill_slots
    loop.admit = admit
    loop.shared_forward = shared_forward
    return rec


def serve_run(mods, cfg, params, prompts, *, block_size, mode,
              card, gaps=False):
    DecodeEngine, PagedKVConfig, ServingLoop, ops = mods
    paged = PagedKVConfig(block_size=block_size) if block_size else None
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN, paged=paged,
                       device="cuda")
    loop = ServingLoop(eng, mode=mode)
    rec = record_gaps(loop) if gaps else None
    for p in prompts:
        loop.submit(p, 32)
    torch.cuda.synchronize()
    ops.decode_attention_ragged.launches = 0
    ops.decode_attention_paged.launches = 0
    t0 = time.perf_counter()
    results = loop.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"dense": ops.decode_attention_ragged.launches,
                "paged": ops.decode_attention_paged.launches}
    s = loop.stats()
    name = f"{'paged' if block_size else 'dense'} {mode}"
    if s["requests"] != len(prompts) or any(
            len(t) != 32 for t in results.values()):
        raise AssertionError(f"{name}: not every request finished")
    hit_forwards = sum(1 for e in eng.prefill_log[loop._prefill_log_start:]
                       if e.get("cached_tokens", 0) > 0)
    shaped = s["forwards"] + hit_forwards
    want = {"dense": 0 if block_size else LAYERS * shaped,
            "paged": LAYERS * shaped if block_size else 0}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{want} (32 layers x {shaped} decode-shape "
                             "forwards)")
    if block_size and s["prefix_hits"] < 1:
        raise AssertionError(f"{name}: the shared prompt prefix never hit")
    print(f"serving {name}: {s['requests']} requests, {s['tokens']} tokens, "
          f"{s['forwards']} forwards (+{hit_forwards} prefix-hit), "
          f"{dt:.3f} s wall, {s['tokens'] / dt:.1f} tok/s, launches "
          f"{launches} [{card}]")
    return results, launches, rec


def check_forward(mods, cfg, params, prompts) -> None:
    """One full-size decode forward of width 16 over 4 prefilled slots,
    through the kernels and through the plain attention, on the same
    cache: the logits must agree to bf16 accuracy through 32 layers."""
    DecodeEngine, PagedKVConfig, _, _ = mods
    for paged in (None, PagedKVConfig(block_size=16)):
        eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                           paged=paged, device="cuda")
        eng.prefill_slots({s: prompts[s] for s in range(4)})
        toks = torch.as_tensor(np.stack([p[:16] for p in prompts[4:8]]),
                               device="cuda")
        got, _, _ = eng.decode_slots(toks)
        eng.use_kernel = False
        want, _, _ = eng.decode_slots(toks)
        got, want = got.float(), want.float()
        if got.shape != (4, 16, cfg.vocab_size) or not torch.isfinite(
                got).all():
            raise AssertionError(f"forward logits {tuple(got.shape)} not "
                                 "finite or of the wrong shape")
        rel = float((got - want).norm() / want.norm())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        name = "paged" if paged else "dense"
        print(f"forward {name}: kernel vs plain attention logits, relative "
              f"error {rel:.3g}, argmax agreement {agree:.3f}")
        if rel > FORWARD_RTOL:
            raise AssertionError(f"{name} kernel forward leaves the plain "
                                 f"forward: relative error {rel:.3g}")


def profile_steps(mods, cfg, params, prompts, card) -> None:
    """torch.profiler over 4 steady decode steps of paged speculative
    serving: device busy share of the wall time and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    DecodeEngine, PagedKVConfig, ServingLoop, _ = mods
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                       paged=PagedKVConfig(block_size=16), device="cuda")
    loop = ServingLoop(eng, mode="speculative")
    for p in prompts[:4]:
        loop.submit(p, 32)
    loop.admit()
    for _ in range(2):
        loop.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            loop.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    total = sum(busy.values())
    if total == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile (4 paged speculative steps, under the profiler): wall "
          f"{wall_ms:.1f} ms, device busy {total:.2f} ms "
          f"({100 * total / wall_ms:.1f}%), idle "
          f"{100 * (1 - total / wall_ms):.1f}% [{card}]")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:8.3f} ms  {100 * ms / total:5.1f}%  {name[:90]}")


def compare_streams(name, greedy, other, recs) -> int:
    """``other``'s streams must equal the paged greedy ones; where one
    leaves, the top-2 gap before that token, in every greedy run of
    ``recs`` (all record it), must be a bf16 near-tie."""
    full = 0
    for rid, g in greedy.items():
        d = np.nonzero(g != other[rid])[0]
        if not len(d):
            full += 1
            continue
        pos = int(d[0])
        gaps = [[float(t[i]) for rows, t in rec
                 for i, key in rows.items() if key == (rid, pos)]
                for rec in recs]
        gap = max(found[0] for found in gaps) if all(gaps) else None
        print(f"  request {rid}: {name} leaves paged greedy at token {pos}, "
              f"top-2 gap {gap}")
        if gap is None or gap > GAP_TOL:
            raise AssertionError(
                f"request {rid}: {name} stream diverged at token {pos} "
                f"where the top-2 gap {gap} exceeds {GAP_TOL}")
    print(f"{name} == paged greedy: {full}/{len(greedy)} streams match in "
          f"full (divergence allowed at top-2 gaps <= {GAP_TOL})")
    return full


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import compile_libraries
    from repro_torch.kernels.decode_attention import ops

    # 1. device
    card = card_line()
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    built = compile_libraries(["decode_attention"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in built.items():
        print(f"  {name}: {path.name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # 3. kernels
    err = check_kernels(ops)
    times = time_kernels(ops, n=1)
    for n in (1, 16):
        t = times if n == 1 else time_kernels(ops, n=n)
        for mode, r in t.items():
            print(f"  {mode} n={n}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                  f"executed-tile bound {r['tile_bound_ms']:.5f} ms "
                  f"[{card}]")
    # 4. serving
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
    mods = (DecodeEngine, PagedKVConfig, ServingLoop, ops)
    cfg = get_config("stablelm_3b")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    prompts[5][:32] = prompts[0][:32]          # admitted later: prefix hit
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    greedy, l1, rec = serve_run(mods, cfg, params, prompts,
                                block_size=16, mode="greedy", card=card,
                                gaps=True)
    spec, l2, _ = serve_run(mods, cfg, params, prompts,
                            block_size=16, mode="speculative", card=card)
    dense, l3, rec_dense = serve_run(mods, cfg, params, prompts,
                                     block_size=0, mode="greedy", card=card,
                                     gaps=True)
    compare_streams("paged speculative", greedy, spec, [rec])
    compare_streams("dense greedy", greedy, dense, [rec, rec_dense])
    check_forward(mods, cfg, params, prompts)
    profile_steps(mods, cfg, params, prompts, card)

    # 5. report
    runs = {"paged_greedy": l1, "paged_speculative": l2, "dense_greedy": l3}
    src = "src/repro_torch/csrc/decode_attention.cu"
    kernels = []
    for mode, fn, line in (("dense", "decode_attention_dense", 123),
                           ("paged", "decode_attention_paged", 186)):
        r = times[mode]
        kernels.append({
            "name": fn, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/decode_attention/kernel.py:{line}",
            "launches": sum(r[mode] for r in runs.values()),
            "launches_by_run": {k: r[mode] for k, r in runs.items()},
            "max_abs_err": err[mode],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
