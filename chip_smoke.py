#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

``--out`` (default build/chip_smoke) receives the pinned replay's
scorecard and the calibration tables.

Phases, in order; any failure exits non-zero:
  1. device   — require CUDA, print the card's name and power limit.
  2. build    — compile csrc/decode_attention.cu, csrc/moe_ffn.cu and
                csrc/mamba_scan.cu with nvcc (sm_90a), one process per
                source, started together.
  3. kernels  — decode attention in both addressing modes (dense slots,
                paged pool) against its plain PyTorch version at stablelm_3b
                (h = kv = 32, dh = 80), wedlm8b_like (h = 32, kv = 8,
                dh = 128) and granite_moe_3b_a800m (h = 24, kv = 8, dh = 64)
                shapes: n in {1, 4, 16, 65}, ragged lengths with an empty
                and a full row, fragmented and reversed block tables, with
                and without a window; then the paged kernel's pipeline:
                lengths 0, 1, 15, 16, 17 and 255 in a 32-page table (more
                pages than its ring holds), n in {1, 16, 17}; then the
                dense mode at a 200-position cache (its second 128-position
                tile runs past the cache), lengths 0, 1, 127, 128, 129 and
                full, n in {1, 16, 65}; then wedlm8b_like's diffusion
                shapes, n = 16 and 17 at serving lengths 48-112 in both
                modes; the executed kv tiles must equal slack_report's.  The fused grouped MoE FFN against its
                plain version at granite shapes (E 40, top-8, d 1536, f
                512, swiglu) for T in {1, 4, 16, 40, 41, 256} under
                balanced, skewed and router routing, every row on one
                expert (T = 16, 41), f 1024 swiglu and gelu (T = 4 / 16,
                41) and llada_mini_like shapes (E 256, top-8, d 2048, f
                512) at T = 4 and at its serving T's: decode 4 x (w + 1)
                = 64 and 68, prefill 4 x 48 = 192 and the 64-position
                bucket's 256;
                executed blocks must equal sum ceil(g_e / token_block), and
                a row must give bitwise the same output at T = 1 and T = 41
                (junk in the padding rows).
                The Mamba1 selective scan against its plain version at
                falcon_mamba_7b widths (di 8192, ds 16) for b in {1, 4}
                and s in {1, 5, 16, 17, 48, 200}, and at di 256 for ds in
                {1, 5, 8, 64} (lane groups rounded up past ds), with a
                nonzero h0: y and the final state, and the state after the
                s real positions bitwise the same under two paddings.  Then
                times each kernel (decode attention at n = 1 and 16 at
                stablelm_3b's shapes and n = 17 at wedlm8b_like's; the MoE
                FFN at granite's and llada's decode and prefill), its
                plain version and a library call
                (scaled_dot_product_attention; torch._grouped_mm; none
                computes a selective scan), never called by the port, the
                launch floor (a one-element add_ under the same timing),
                and prints the MoE kernel's M_moe / tau staircase over T
                and the scan's M_ssm staircase over n.
  4. serving  — every decode forward replays a CUDA graph per width (the
                captured decode step, ``serving.capture``).  For each
                model first: captured against eager ``decode_slots`` at
                n in {1, 5, 16, 17}, dense and paged (falcon dense): logits
                and hidden bitwise equal, the cache (K/V, SSM states)
                bitwise equal after a commit, launches per call equal
                across eager calls, the capture and a replay.  Then
                full-size stablelm_3b, then full-size granite_moe_3b_a800m,
                then full-size falcon_mamba_7b, each with seeded random
                bf16 weights, 4 slots, max_len 256,
                8 requests of 48-token prompts (two share their first 32
                tokens) x 32 new tokens: paged greedy, paged speculative,
                dense greedy, and for stablelm_3b dense speculative (verify
                forwards of width 16 through the dense attention mode).
                Checks completion, the launch counts (32 layers x
                decode-shape forwards for decode attention; 32 x all
                forwards, prefill included, for the MoE FFN, whose 16- and
                64-row token blocks must both run), and that the other
                runs' streams equal the paged greedy ones up to bf16
                near-ties (granite: printing whether the routing differed
                where a stream leaves).  Then one
                full-size forward per model through the kernels against the
                same forward through the plain versions, and a
                torch.profiler view of 4 decode steps (device busy share,
                top kernels).  falcon_mamba_7b (64 SSM layers, no
                attention) serves dense greedy only, its 8 requests
                reusing the 4 slots, in bf16 and then with the same
                weights cast to float32: selective-scan launches = 64 x
                all forwards, prefill included.  In float32 every stream
                must equal that request's batch-1 greedy_generate through
                the kernel up to GAP_TOL near-ties, and the full-size
                forward the plain scan's; in bf16 both comparisons are
                printed only (64 random-weight layers amplify a bf16
                rounding into logits that part wholesale).
                Then the paper's two validation models, full size, seeded
                random bf16 weights, the same 8 requests: wedlm8b_like
                (dense, GQA 32/8 x 128) paged greedy, paged MTP (a 4-head
                bank), paged diffusion at the budget's width and dense
                diffusion at block 16 (n = 17, two m-tiles, in every
                refinement forward); llada_mini_like (MoE, E 256 top-8)
                paged greedy, paged MTP and paged diffusion.  Checks:
                completion; launches (decode attention = layers x
                decode-shape forwards, every refinement and commit forward
                one; MoE = layers x all forwards); MTP streams == paged
                greedy under the GAP_TOL / ROUTER_TOL rule; diffusion
                tokens per forward > 1; each slot's committed K/V against a
                prefill of its stream, read before the slot is released
                (FORWARD_RTOL per position in bf16); batched diffusion
                against the single-request DiffusionBlockDecoder at the
                same block, request by request, parting only at a
                near-tie of the selection (printed in bf16, held in f32);
                the full-size forward kernel-vs-plain.  The diffusion runs
                repeat in float32 (wedlm at full size, 33 GB; llada at
                full width and 4 of its 20 layers, printed as a cut)
                through the plain versions (the kernels take bf16 only),
                where the solo comparison and the K/V check are held.
                Every run prints its forwards, positions per forward,
                budget range and tok/s, and a profile of its steady steps
                its device-idle share.  Each model's paged greedy run (for
                falcon its bf16 dense greedy) is repeated eagerly
                (``capture=False``) in the same call: streams identical,
                tok/s and the profiled idle share printed side by side.
                Then each model's NFP calibration on the card:
                ``calibrate_engine`` (wall clock, CUDA events, the
                captured step) on a dense 4-slot engine of 1024 positions
                over ``width_grid(128)`` at buckets 64, 256 and 896, its
                launches exactly layers x forwards: per bucket the measured
                N_max beside the analytic budget, its limiting term, n_idle,
                the noise and both over-prediction ratios.
  5. cli      — through ``repro_torch.launch.serve``: the pinned trace
                replay (``loadgen.PINNED_STACK``, full-width stablelm_3b)
                on the simulated H100 clock, then on the wall clock,
                writing <out>/BENCH_serving_h100.json (TTFT, ITL,
                goodput per SLO class), read back and checked; then
                wedlm8b_like and granite_moe_3b_a800m served speculative
                with ``--calibration run`` and then ``load`` (applied and
                analytic mean budgets, latency ratios).  A summary of
                eager vs captured tok/s, idle shares and the calibration
                table follows.
  6. report   — one JSON line of kernels (launches summed over every run
                above), the command time, the card line, and the final
                {"ok": true, ...} line.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
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
# MoE FFN: kernel and plain version both compute in f32 and round once to
# bf16; the sums run in other orders, so an output may round to its
# neighbouring bf16 value (two bf16 steps relative), and outputs near 0,
# whose f32 sums cancel terms of magnitude ~100, move by ~1e-3 absolute
MOE_ATOL = 2e-2
MOE_RTOL = 2 * 2.0 ** -8
# kernel vs plain versions inside the full model: each layer's attention
# output differs by bf16 rounding, and 32 residual layers carry it on
# (measured 1.7e-2 relative on an H100)
FORWARD_RTOL = 5e-2
# granite, under one fixed routing in both paths, adds the MoE FFN, whose
# plain version rounds h and the up/gate products to bf16 where the
# kernel keeps f32: twice the dense model's bound
MOE_FORWARD_RTOL = 1e-1
# falcon_mamba_7b with its weights cast to float32: kernel and plain scan
# differ by about one f32 rounding per step, and 64 random-weight layers
# amplify a rounding ~1e3-fold (float32 batch-1 vs batch-4 forwards differ
# by 8.4e-5 relative on an H100) — ten times that.  (In bf16 the same
# amplification makes the comparison meaningless; it is printed only.)
SSM_FORWARD_RTOL = 1e-3
# selective scan, kernel vs plain version: both f32; the kernel may fuse
# each step's multiply-add and sums y over ds in its own order, about one
# rounding per step, which the decaying recurrence (exp(dt·A) < 1) keeps
# from growing over 200 steps
SCAN_ATOL = 1e-4
SCAN_RTOL = 1e-4
# a verify forward of width 16 and a width-1 forward, or the dense kernel's
# 128-position kv tile and the paged kernel's 16-position page, sum in a
# different order and round differently in bf16; a stream may leave the
# paged greedy one only where the top-2 logits were within 2 bf16 steps
# (2^-5 each in [4, 8)) of each other
GAP_TOL = 2 * 2.0 ** -5
# an MoE stream may also leave once its routing parted from the other
# run's at a router near-tie.  Router logits (f32 products of the bf16
# normed state with the 0.02-scale router, std ~0.8) move between two runs
# as their states drift by bf16 rounding; an expert choice flips where the
# difference of its k-th and (k+1)-th logits swings through 0, by at least
# the sum of the two runs' margins.  That sum at the FIRST flip (earliest
# token, lowest layer) must stay within 2^-4, twice the largest one read
# on an H100 (0.0333); the flip swaps one of k experts, so the layers
# above it and the tokens after it route on states that legitimately
# differ
ROUTER_TOL = 2.0 ** -4
# diffusion: the batched run (4 rows, ragged) and the batch-1
# DiffusionBlockDecoder may pick other positions only where, in the first
# refinement forward whose picks differ, the two runs' confidence margins
# between a position picked in one run and one picked in the other sum to
# <= CONF_RTOL of the confidence (or a picked token's top-2 gap <= the gap
# tolerance, or, MoE, the row's smallest router margin in that forward <=
# the router tolerance).  In float32 the two runs' logits differ by ~1e-5
# (f32 batch-1 vs batch-4 forwards, measured for falcon at 8.4e-5
# relative through 64 layers), so 2^-10 leaves a ~100-fold margin; router
# logits (one f32 product) differ by ~1e-6, and 2^-16 leaves ~10-fold.  In
# bf16 the comparison is printed only (with ROUTER_TOL it excuses every
# MoE parting: some router margin of a forward is always that small)
CONF_RTOL_F32 = 2.0 ** -10
GAP_TOL_F32 = 2.0 ** -10
ROUTER_TOL_F32 = 2.0 ** -16
CONF_RTOL_BF16 = 2.0 ** -4
# a slot's committed K/V against a prefill of its stream: per position,
# ||a - b|| / ||b|| over layers and heads; bf16 as the full-size forward
# check, f32 ten times the f32 forward bound.  An MoE model is held at
# its first layer, whose K/V come from the tokens alone: deeper layers
# take a routing flip at a router near-tie between the decode-shape and
# the prefill forward (a flipped expert moves a position's state by
# O(1), as the full-size forward with the router shows), and are printed.
# A mask-token input at a committed position shows at the first layer
KV_RTOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# llada_mini_like in float32 (67 GB at 20 layers) runs at full width and
# this depth
LLADA_F32_LAYERS = 4
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
MAX_LEN = 256
# (E, top-k, d_model, expert d_ff)
GRANITE_MOE = (40, 8, 1536, 512)
LLADA_MOE = (256, 8, 2048, 512)
# falcon_mamba_7b's scan: (d_inner, d_state)
FALCON_SCAN = (8192, 16)
# captured vs eager decode_slots: the widths held bitwise equal
CAPTURE_WIDTHS = (1, 5, 16, 17)
# the calibration engines: 4 slots, a dense cache of this length (buckets
# 64, 256 and 896 under width_grid(128))
CALIB_MAX_LEN = 1024
# where the scorecard and calibration tables go (``--out``)
OUT = ROOT / "build" / "chip_smoke"
# run name -> (tok/s, forwards, seconds) and profile label -> idle %, for
# the summary; calibration rows by model
SPEEDS = []
IDLE = {}
CALIBRATION = {}


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


def launch_floor_ms() -> float:
    """The device time a launch of no work reads as under ``time_ms``: a
    one-element ``add_``.  Decode attention's byte bound lies below it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    return time_ms(lambda: one.add_(1.0), flush)


# ---------------------------------------------------------------------------
# phase 3a: decode attention against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(*, paged, n, h, kv, dh, lens, layout="", seed=0,
                  max_len=MAX_LEN):
    """q plus a dense cache of ``max_len`` positions, or the same content
    packed into a paged pool whose pages follow ``layout``; the trash page
    holds large junk that a leaking mask would show."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lens)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q = randn(b, n, h, dh)
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    if not paged:
        return q, randn(b, max_len, kv, dh), randn(b, max_len, kv, dh), \
            lens_t, None
    bs = 16
    max_blocks = max_len // bs
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
    """Every decode-attention case of phase 3; returns the max abs error
    per kernel."""
    shapes = {"stablelm_3b": (32, 32, 80), "wedlm8b_like": (32, 8, 128),
              "granite_moe_3b_a800m": (24, 8, 64)}
    err = {"dense": 0.0, "paged": 0.0}
    cases = 0

    def run(paged, n, h, kv, dh, lens, window, layout="", max_len=MAX_LEN):
        """One case against the plain version; the executed kv tiles
        against slack_report."""
        nonlocal cases
        q, k, v, lens_t, bt = kernel_inputs(
            paged=paged, n=n, h=h, kv=kv, dh=dh, lens=lens, layout=layout,
            seed=cases, max_len=max_len)
        tiles = torch.zeros(1, dtype=torch.int32, device="cuda")
        if paged:
            out = ops.decode_attention_paged(q, k, v, lens_t, bt,
                                             window=window, tiles=tiles)
            ref = ops.decode_attention_paged_ref(q, k, v, lens_t, bt,
                                                 window=window)
        else:
            out = ops.decode_attention_ragged(q, k, v, lens_t, window=window,
                                              tiles=tiles)
            ref = ops.decode_attention_ref(q, k, v, lens_t, window=window)
        rep = ops.slack_report(n, lens, max_len, head_dim=dh,
                               k_block=16 if paged else ops.K_BLOCK,
                               window=window)
        torch.cuda.synchronize()
        mode = "paged" if paged else "dense"
        e = (out.float() - ref.float()).abs()
        bad = e > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
        err[mode] = max(err[mode], float(e.max()))
        where = (f"{mode} h={h} kv={kv} dh={dh} n={n} window={window} "
                 f"{layout} lens={lens} s_max={max_len}")
        if not torch.isfinite(out).all() or bad.any():
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"{where}: max abs err {float(e.max()):.4g}")
        want = kv * rep["kv_tiles_executed"]
        if int(tiles.item()) != want:
            raise AssertionError(f"{where}: kernel ran {int(tiles.item())} kv "
                                 f"tiles, slack_report says {want}")
        cases += 1

    for h, kv, dh in shapes.values():
        for paged in (False, True):
            for n in (1, 4, 16, 65):
                for window in (None, 48):
                    for layout in (("fragmented", "reversed") if paged
                                   else ("",)):
                        run(paged, n, h, kv, dh, [0, 37, 150, MAX_LEN - n],
                            window, layout)
    # the ring and the kv split: rows of up to 17 pages in a 32-page table
    # (more than the ring's 12 chunks in flight), lengths at page edges, an
    # empty row, n of 1, 16 (one m-tile) and 17 (two m-tiles; with GQA
    # g = 4, 68 rows: a 64-row chunk and a 4-row one)
    for h, kv, dh in shapes.values():
        for n in (1, 16, 17):
            for window in (None, 48):
                run(True, n, h, kv, dh, [0, 1, 15, 16, 17, 255], window,
                    "fragmented", 2 * MAX_LEN)
    # the dense mode at a cache of 200 positions (no multiple of its
    # 128-position tile: the second tile runs past the cache and is
    # zero-filled), lengths at and across a tile edge
    for h, kv, dh in shapes.values():
        for n in (1, 16, 65):
            for window in (None, 48):
                run(False, n, h, kv, dh, [0, 1, 127, 128, 129, 200 - n],
                    window, max_len=200)
    # wedlm8b_like's diffusion forwards: n = 16 (a block of 15 at the
    # budget's width) and 17 (block 16: two m-tiles, g = 4 -> 68 rows) at
    # serving lengths, four slots
    h, kv, dh = shapes["wedlm8b_like"]
    for paged in (False, True):
        for n in (16, 17):
            for lens in ([48, 64, 96, 112], [48, 63, 79, 111]):
                run(paged, n, h, kv, dh, lens, None,
                    "fragmented" if paged else "")
    print(f"kernels: {cases} decode-attention cases agree with the plain "
          f"version within atol={KERNEL_ATOL} rtol={KERNEL_RTOL} (bf16); "
          f"executed kv tiles == slack_report; max abs err "
          f"dense={err['dense']:.4g} paged={err['paged']:.4g}")
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
    return _bound(bytes_, flops)


def _bound(bytes_, flops, peak_flops=PEAK_BF16_FLOPS) -> tuple:
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(ops, n: int, shape=(32, 32, 80), lens=(64, 72, 80, 96)
                 ) -> dict:
    """Kernel, plain and library times at serving shapes: by default
    stablelm_3b's (h = kv = 32, dh = 80; 4 slots mid-stream), n query
    positions per row."""
    F = torch.nn.functional
    h, kv, dh = shape
    lens = list(lens)
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
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
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
# phase 3b: the fused grouped MoE FFN against its plain version
# ---------------------------------------------------------------------------

def moe_weights(e, d, f, *, gated=True, seed=0) -> dict:
    """Expert leaves at the reference init's 1/sqrt(E) scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * e ** -0.5).to(torch.bfloat16)
    return {"w_gate": w(e, d, f) if gated else None, "w_up": w(e, d, f),
            "w_down": w(e, f, d)}


def moe_inputs(moe_ops, moe, weights, *, k, t, routing, seed=0) -> dict:
    """T token rows routed to top-k experts (Eq. 25 balanced, skewed, or a
    random f32 router), dispatched and padded as ``moe_dispatch`` does."""
    e, d, _ = weights["w_up"].shape
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    x_tok = torch.randn((t, d), generator=g, device="cuda").to(
        torch.bfloat16)
    if routing == "balanced":
        idx = moe.balanced_routing(t, k, e, device="cuda")
    elif routing == "skewed":
        idx = moe.skewed_routing(t, k, e, device="cuda")
    elif routing == "one expert":            # every row on expert 0
        idx = torch.zeros((t, k), dtype=torch.long, device="cuda")
    else:
        router = torch.randn((d, e), generator=g, device="cuda") * 0.02
        _, idx, _ = moe.route_topk(router, x_tok, k)
    return moe_dispatch(moe_ops, x_tok, idx, e)


def moe_dispatch(moe_ops, x_tok, idx, e, token_block=None) -> dict:
    """Sort token-expert pairs by expert and pad them per expert, as
    ``models.moe.moe_ffn`` and ``grouped_ffn`` do."""
    t, k = idx.shape
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    gs = torch.zeros(e, dtype=torch.int32, device="cuda").scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    tb = token_block or moe_ops.select_token_block(t, e)
    slot, be, bv, m_pad = moe_ops.align_block_size(
        flat[order].to(torch.int32), gs, e, tb)
    slot = slot.long()
    x_sorted = x_tok[order // k]
    x_pad = torch.zeros((m_pad, x_tok.shape[1]), dtype=torch.bfloat16,
                        device="cuda")
    x_pad[slot] = x_sorted
    return {"order": order, "gs": gs, "tb": tb, "slot": slot, "be": be,
            "bv": bv, "x_sorted": x_sorted, "x_pad": x_pad}


def moe_call(moe_ops, w, a, *, plain=False, blocks=None):
    act = "swiglu" if w["w_gate"] is not None else "gelu"
    args = (a["x_pad"], w["w_gate"], w["w_up"], w["w_down"], a["be"],
            a["bv"])
    if plain:
        return moe_ops.grouped_ffn_ref(*args, token_block=a["tb"],
                                       activation=act)
    return moe_ops.grouped_ffn_padded(*args, token_block=a["tb"],
                                      activation=act, blocks=blocks)


def check_moe(moe_ops, moe) -> float:
    """Every MoE FFN case of phase 3; returns the max abs error."""
    e, k, d, f = GRANITE_MOE
    cases = []
    granite = moe_weights(e, d, f, seed=1)
    for t in (1, 4, 16, 40, 41, 256):
        for routing in ("balanced", "skewed", "router"):
            cases.append(("granite", granite, k, t, routing))
    for t in (16, 41):
        cases.append(("granite", granite, k, t, "one expert"))
    wide = moe_weights(e, d, 1024, seed=5)
    for t in (4, 41):
        cases.append(("swiglu f=1024", wide, k, t, "router"))
    gelu = moe_weights(e, d, 1024, gated=False, seed=2)
    for t in (16, 41):
        cases.append(("gelu f=1024", gelu, k, t, "router"))
    # llada_mini_like: T = 4, and its serving T's — decode 4 x (w + 1) at
    # w = 15 and 16, prefill 4 x 48 and the 64-position bucket's 4 x 64
    llada = moe_weights(LLADA_MOE[0], LLADA_MOE[2], LLADA_MOE[3], seed=3)
    for t in (4, 64, 68, 192, 256):
        cases.append(("llada_mini_like", llada, LLADA_MOE[1], t, "router"))
    err = 0.0
    for i, (name, w, k, t, routing) in enumerate(cases):
        a = moe_inputs(moe_ops, moe, w, k=k, t=t, routing=routing, seed=i)
        blocks = torch.zeros(1, dtype=torch.int32, device="cuda")
        out = moe_call(moe_ops, w, a, blocks=blocks)[a["slot"]]
        ref = moe_call(moe_ops, w, a, plain=True)[a["slot"]]
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        bad = diff > MOE_ATOL + MOE_RTOL * ref.float().abs()
        err = max(err, float(diff.max()))
        where = f"moe {name} T={t} {routing} token_block={a['tb']}"
        if not torch.isfinite(out).all() or bad.any():
            raise AssertionError(f"MoE kernel disagrees with its plain "
                                 f"version: {where}: max abs err "
                                 f"{float(diff.max()):.4g}")
        want = sum(-(-g // a["tb"]) for g in a["gs"].tolist())
        if int(blocks.item()) != want:
            raise AssertionError(f"{where}: kernel ran {int(blocks.item())} "
                                 f"blocks, sum ceil(g_e / tb) = {want}")
        if name == "granite" and routing == "router":
            # the full wrapper (pad, launch, gather) gives the same rows
            got = moe_ops.grouped_ffn(a["x_sorted"], w, a["gs"], "swiglu",
                                      n_tokens=t)
            if not torch.equal(got, out):
                raise AssertionError(f"{where}: grouped_ffn differs from "
                                     "the padded launch")
    # row invariance: token 0 alone (block 16) and among 41 (block 64),
    # with junk in every padding row
    g = torch.Generator(device="cuda").manual_seed(99)
    x41 = torch.randn((41, d), generator=g, device="cuda").to(torch.bfloat16)
    _, idx41, _ = moe.route_topk(
        torch.randn((d, e), generator=g, device="cuda") * 0.02, x41, k)
    rows = []
    for t in (1, 41):
        a = moe_dispatch(moe_ops, x41[:t], idx41[:t], e)
        a["x_pad"].fill_(37.0)
        a["x_pad"][a["slot"]] = a["x_sorted"]
        out = moe_call(moe_ops, granite, a)[a["slot"]]
        pairs = torch.empty_like(out)
        pairs[a["order"]] = out
        rows.append((a["tb"], pairs[:k]))
    if rows[0][0] != 16 or rows[1][0] != 64 or not torch.equal(
            rows[0][1], rows[1][1]):
        raise AssertionError("a row's MoE output changed between T = 1 "
                             "(block 16) and T = 41 (block 64)")
    print(f"kernels: {len(cases)} MoE FFN cases agree with the plain "
          f"version within atol={MOE_ATOL} rtol={MOE_RTOL:.4g} (bf16); "
          f"executed blocks == sum ceil(g_e / token_block); token 0's rows "
          f"bitwise equal at T = 1 (block 16) and T = 41 (block 64); max "
          f"abs err {err:.4g}")
    return err


def grouped_mm_ffn(x_sorted, w, gs):
    """The library yardstick for one grouped swiglu FFN: three
    ``torch._grouped_mm`` calls with the SwiGLU (h in bf16) between, or,
    where this PyTorch lacks it, a loop of ``torch.matmul`` over the active
    experts.  Returns (fn, name)."""
    F = torch.nn.functional
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    gm = getattr(torch, "_grouped_mm", None)
    if gm is not None:
        def fn():
            gate = gm(x_sorted, w["w_gate"], offs=offs)
            up = gm(x_sorted, w["w_up"], offs=offs)
            h = (F.silu(gate.float()) * up.float()).to(torch.bfloat16)
            return gm(h, w["w_down"], offs=offs)
        try:
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm"
        except RuntimeError as exc:
            print(f"  torch._grouped_mm refused: {str(exc)[:160]}")
    bounds = np.concatenate([[0], np.cumsum(gs.tolist())])
    active = [(e, int(bounds[e]), int(bounds[e + 1]))
              for e in range(len(gs)) if bounds[e + 1] > bounds[e]]

    def loop():
        out = torch.empty_like(x_sorted)
        for e, lo, hi in active:
            xe = x_sorted[lo:hi]
            h = (F.silu((xe @ w["w_gate"][e]).float())
                 * (xe @ w["w_up"][e]).float()).to(torch.bfloat16)
            out[lo:hi] = h @ w["w_down"][e]
        return out
    return loop, "matmul loop"


def moe_bound_ms(a, d, f) -> tuple:
    """Least time for one grouped FFN call: the active experts' weights,
    the routed rows' x and out each moved once, against 2·3·executed
    rows·d·f at the bf16 tensor rate (executed rows: the padded blocks)."""
    gs = a["gs"].tolist()
    active = sum(1 for g in gs if g)
    rows = sum(-(-g // a["tb"]) * a["tb"] for g in gs)
    m = sum(gs)
    return _bound(active * 3 * d * f * 2 + 2 * m * d * 2, 2 * 3 * rows * d * f)


def read_ms(n_bytes, flush) -> float:
    """Device time of one PyTorch reduction reading ``n_bytes`` of bf16
    once: what streaming the kernel's weight bytes takes on this card in
    practice, against the 3.35 TB/s of ``moe_bound_ms``."""
    buf = torch.ones(n_bytes // 2, dtype=torch.bfloat16, device="cuda")
    return time_ms(lambda: buf.sum(dtype=torch.float32), flush)


GRANITE_TIMES = (("decode_balanced", 4, "balanced"),
                 ("decode_skewed", 4, "skewed"),
                 ("prefill_router", 256, "router"))
# llada_mini_like's diffusion decode (4 rows x 16 positions) and prefill
# (4 prompts of 48)
LLADA_TIMES = (("decode_router", 64, "router"),
               ("prefill_router", 192, "router"))


def time_moe(moe_ops, moe, weights, shape=GRANITE_MOE, runs=GRANITE_TIMES,
             staircase=True) -> dict:
    """Kernel, plain, library and bound at each of ``runs`` (label, T,
    routing) — by default granite decode (T = 4, 4 slots of 1 token,
    balanced and skewed) and prefill (T = 256, router) — then, with
    ``staircase``, the kernel over T under balanced routing (the M_moe /
    tau staircase: M_moe·E/k = 80 and tau = E = 40 for granite)."""
    e, k, d, f = shape
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, t, routing in runs:
        a = moe_inputs(moe_ops, moe, weights, k=k, t=t, routing=routing,
                       seed=5)
        lib, lib_name = grouped_mm_ffn(a["x_sorted"], weights, a["gs"])
        bound, by = moe_bound_ms(a, d, f)
        out[label] = {
            "ms": time_ms(lambda: moe_call(moe_ops, weights, a), flush),
            "plain_ms": time_ms(lambda: moe_call(moe_ops, weights, a,
                                                 plain=True), flush),
            "library_ms": time_ms(lib, flush), "library": lib_name,
            "read_ms": read_ms(sum(1 for g in a["gs"].tolist() if g)
                               * 3 * d * f * 2, flush),
            "bound_ms": bound, "bound_by": by, "token_block": a["tb"],
            "T": t,
            "blocks": sum(-(-g // a["tb"]) for g in a["gs"].tolist())}
    if not staircase:
        return out
    stair = {}
    for t in (1, 2, 5, 10, 20, 40, 41, 80):
        a = moe_inputs(moe_ops, moe, weights, k=k, t=t, routing="balanced",
                       seed=6)
        stair[t] = (time_ms(lambda: moe_call(moe_ops, weights, a), flush),
                    a["tb"], sum(-(-g // a["tb"]) for g in a["gs"].tolist()))
    out["staircase"] = stair
    return out


# ---------------------------------------------------------------------------
# phase 3c: the Mamba1 selective scan against its plain version
# ---------------------------------------------------------------------------

def scan_inputs(b, s, seed=0, widths=FALCON_SCAN) -> tuple:
    """x, dt (a softplus), B, C, A = -(1 .. ds) per channel (falcon's
    A_log = log(1 .. ds)) and a nonzero h0, f32, at ``widths`` (d_inner,
    d_state), falcon's by default."""
    di, ds = widths
    g = torch.Generator(device="cuda").manual_seed(2000 + seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    a = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device="cuda").expand(di, ds).contiguous()
    return (randn(b, s, di), torch.nn.functional.softplus(randn(b, s, di)),
            randn(b, s, ds), randn(b, s, ds), a, randn(b, di, ds))


def scan_padded(scan_ops, args, s_pad) -> tuple:
    """The kernel's padded inputs, as ``selective_scan`` makes them."""
    return tuple(scan_ops.pad_positions(t, s_pad) for t in args[:4]) \
        + tuple(args[4:])


def s_padded(scan_ops, s) -> int:
    return scan_ops.round_up(s, scan_ops.select_scan_chunk(s))


def check_scan(scan_ops) -> float:
    """Every selective-scan case of phase 3; returns the max abs error."""
    err, cases = 0.0, 0
    # falcon widths, then lane groups rounded up past ds (1, 5), the
    # reduced config's ds 8 and the widest state (64) at a narrow d_inner
    shapes = ([(b, s, FALCON_SCAN) for b in (1, 4)
               for s in (1, 5, 16, 17, 48, 200)]
              + [(4, 17, (256, ds)) for ds in (1, 5, 8, 64)])
    for b, s, widths in shapes:
        args = scan_inputs(b, s, seed=cases, widths=widths)
        y, h = scan_ops.selective_scan(*args)
        yr, hr = scan_ops.selective_scan_ref(*args)
        torch.cuda.synchronize()
        where = f"scan b={b} s={s} (di, ds)={widths}"
        for name, got, want in (("y", y, yr), ("state", h, hr)):
            diff = (got - want).abs()
            bad = diff > SCAN_ATOL + SCAN_RTOL * want.abs()
            err = max(err, float(diff.max()))
            if (got.shape != want.shape or not torch.isfinite(got).all()
                    or bad.any()):
                raise AssertionError(
                    f"scan kernel disagrees with its plain version: "
                    f"{where} {name}: max abs err {float(diff.max()):.4g}")
        sp = s_padded(scan_ops, s)
        states = [scan_ops.selective_scan_padded(
            *scan_padded(scan_ops, args, pad))[1] for pad in (sp, sp + 16)]
        if not (torch.equal(states[0], states[1])
                and torch.equal(states[0], h)):
            raise AssertionError(f"{where}: the state after the real "
                                 "positions depends on the padding")
        cases += 1
    print(f"kernels: {cases} selective-scan cases agree with the plain "
          f"version within atol={SCAN_ATOL} rtol={SCAN_RTOL} (f32, y and "
          f"final state); the state is bitwise the same padded to the next "
          f"16 and 16 further; max abs err {err:.4g}")
    return err


def scan_bound_ms(b, s_pad, di, ds) -> tuple:
    """Least time for one scan call over s_pad positions: x, dt, y (b,
    s_pad, di), B, C (b, s_pad, ds), A, h0 and h each moved once, against
    b·s_pad·di·(1 + 7·ds) f32 operations (dt·x; per state dt·A, exp,
    ·h, ·B, +, ·C, + — exp counted as one) at the f32 rate."""
    bytes_ = 4 * (3 * b * s_pad * di + 2 * b * s_pad * ds + di * ds
                  + 2 * b * di * ds)
    return _bound(bytes_, b * s_pad * di * (1 + 7 * ds), PEAK_F32_FLOPS)


def time_scan(scan_ops) -> dict:
    """Kernel, plain version, the whole wrapper (padding included) and the
    bound at falcon decode (b = 4 slots, n = 1 -> 16 padded positions)
    and prefill (b = 4, s = 48), then the kernel over n (the M_ssm
    staircase).  No single PyTorch call computes a selective scan."""
    di, ds = FALCON_SCAN
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, b, s in (("decode", 4, 1), ("prefill", 4, 48)):
        args = scan_inputs(b, s, seed=50)
        sp = s_padded(scan_ops, s)
        padded = scan_padded(scan_ops, args, sp)
        bound, by = scan_bound_ms(b, sp, di, ds)
        out[label] = {
            "ms": time_ms(lambda: scan_ops.selective_scan_padded(*padded),
                          flush),
            "plain_ms": time_ms(lambda: scan_ops.selective_scan_ref(*padded),
                                flush),
            "wrapper_ms": time_ms(lambda: scan_ops.selective_scan(*args),
                                  flush),
            "bound_ms": bound, "bound_by": by,
            "real_bound_ms": scan_bound_ms(b, s, di, ds)[0],
            "library_ms": None, "s_pad": sp}
    stair = {}
    for n in (1, 8, 16, 17, 32, 33):
        sp = s_padded(scan_ops, n)
        padded = scan_padded(scan_ops, scan_inputs(4, n, seed=60), sp)
        stair[n] = (time_ms(lambda: scan_ops.selective_scan_padded(*padded),
                            flush), sp)
    out["staircase"] = stair
    return out


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def top2_gap(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


#: getters of the lists that active route hooks (``RouteRecorder``,
#: ``DiffusionTrace``) append to; ``capture_routes`` feeds them on replay
ROUTE_SINKS = []


def capture_routes(eng) -> None:
    """A route hook appends, in Python, what it computes from each
    ``route_topk`` call, and a replayed CUDA graph calls no Python.  So
    the entries the active hooks append while a width's graph is CAPTURED
    (device tensors the graph rewrites on every replay) are kept per
    width, and every replay of it appends clones of them, as an eager
    forward appends fresh ones; the capture's warm-up forward appends the
    same number first, which are dropped."""
    graphs = eng.graphs
    inner_capture, inner_replay = graphs._capture, graphs.replay
    kept = {}

    def clone(x):
        return tuple(t.clone() for t in x) if isinstance(x, tuple) \
            else x.clone()

    def capture(shape):
        sinks = [get() for get in ROUTE_SINKS]
        marks = [len(sink) for sink in sinks]
        step = inner_capture(shape)
        kept[shape[1]] = []
        for sink, mark in zip(sinks, marks):
            new = sink[mark:]
            del sink[mark:]
            kept[shape[1]].append(new[len(new) // 2:])
        return step

    def replay(tokens, use_kernel):
        out = inner_replay(tokens, use_kernel)
        for get, entries in zip(ROUTE_SINKS, kept[tokens.shape[1]]):
            get().extend(clone(x) for x in entries)
        return out
    graphs._capture, graphs.replay = capture, replay


class RouteRecorder:
    """While a run serves, wraps the port's ``route_topk`` and the engine's
    three forward entries — ``decode_slots`` (decode and verify forwards,
    captured or not), ``_decode_forward`` called from a prefill (the
    prefix-hit suffix forward) and ``_prefill_scratch`` (prompt prefill) —
    to keep,
    for every forward of an MoE model, each row's request and first
    context position and every layer's routing: the chosen experts
    (sorted) and the router margin between the k-th and (k+1)-th expert
    (a log-probability difference), on the device.  Rows admitted by the
    forward's own admission learn their request when it ends."""

    def __init__(self, moe_mod, loop):
        self.mod, self.inner, self.loop = moe_mod, moe_mod.route_topk, loop
        self.calls, self.forwards, self.pending = [], [], []
        self.admitting = False
        self.in_decode = False
        self.saved = ()

    def __enter__(self):
        self.inner = self.mod.route_topk       # whatever wraps it already

        def route(router_w, x, k):
            weights, idx, probs = self.inner(router_w, x, k)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.append((torch.sort(idx, dim=-1).values,
                               torch.log(top[:, k - 1] / top[:, k])))
            return weights, idx, probs
        eng, loop = self.loop.engine, self.loop
        inner_decode, inner_scratch = eng.decode_slots, eng._prefill_scratch
        inner_forward = eng._decode_forward
        inner_admit = loop.admit

        def decode_slots(tokens):
            offsets = eng.slot_lens_host.copy()
            self.calls.clear()
            self.in_decode = True
            try:
                out = inner_decode(tokens)
            finally:
                self.in_decode = False
            self._add(list(range(tokens.shape[0])), offsets, tokens.shape[1])
            return out

        def decode_forward(tokens):
            if self.in_decode:          # an eager decode_slots records it
                return inner_forward(tokens)
            offsets = eng.slot_lens_host.copy()
            self.calls.clear()
            out = inner_forward(tokens)
            self._add(list(range(tokens.shape[0])), offsets, tokens.shape[1])
            return out

        def prefill_scratch(toks, width):
            self.calls.clear()
            out = inner_scratch(toks, width)
            rows = sorted(toks)
            self._add(rows, {s: 0 for s in rows}, width)
            return out

        def admit():
            self.admitting = True
            try:
                admitted = inner_admit()
            finally:
                self.admitting = False
            for slots, offsets, route in self.pending:
                self._keep(slots, offsets, route)
            self.pending.clear()
            return admitted
        self.saved = (inner_decode, inner_scratch, inner_forward, inner_admit)
        self.mod.route_topk = route
        eng.decode_slots, eng._prefill_scratch = decode_slots, prefill_scratch
        eng._decode_forward = decode_forward
        loop.admit = admit
        ROUTE_SINKS.append(self._sink)
        return self

    def _sink(self):
        return self.calls

    def __exit__(self, *exc):
        ROUTE_SINKS.remove(self._sink)
        self.mod.route_topk = self.inner
        eng = self.loop.engine
        (eng.decode_slots, eng._prefill_scratch, eng._decode_forward,
         self.loop.admit) = self.saved

    def _add(self, slots, offsets, n):
        calls, self.calls = self.calls, []
        if not calls:
            return
        layers, rows = len(calls), len(slots)
        route = (torch.stack([c[0] for c in calls]).reshape(layers, rows, n,
                                                            -1),
                 torch.stack([c[1] for c in calls]).reshape(layers, rows, n))
        if self.admitting:       # the admitted slots are not active yet
            self.pending.append((slots, offsets, route))
        else:
            self._keep(slots, offsets, route)

    def _keep(self, slots, offsets, route):
        rows = {i: (self.loop.active[s].rid, int(offsets[s]))
                for i, s in enumerate(slots) if s in self.loop.active}
        self.forwards.append((rows, route))


def route_at(forwards, rid, p):
    """Request ``rid``'s routing at context position ``p`` — (layers, k)
    experts and (layers,) margins — from the last forward whose row covers
    it (a later one re-ran it with the accepted token), or None."""
    found = None
    for rows, (ids, margins) in forwards:
        for i, (req, off) in rows.items():
            if req == rid and off <= p < off + ids.shape[2]:
                found = (ids[:, i, p - off], margins[:, i, p - off])
    return found


def record_gaps(loop):
    """Wrap the loop's prefill and ``shared_forward`` to keep, before every
    token a stream takes, the top-2 logit gap (greedy streams read column
    0): per call, a map row -> (request, stream index of column 0) and the
    gaps by row (device tensors; read at the end)."""
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


def serve_run(mods, cfg, params, prompts, *, block_size, mode, card,
              loop_kw=None, prepare=None, use_kernel=True, capture=True):
    """Serve ``prompts`` x 32 tokens on a 4-slot engine (paged with
    ``block_size``) in ``mode`` (``loop_kw``: the ServingLoop's mode
    arguments), counting every kernel's launches from 0; ``prepare(loop)``
    attaches further recorders before the run; ``use_kernel`` False runs
    the plain versions (and expects no launch); ``capture`` False runs the
    decode forwards eagerly instead of replaying CUDA graphs.  Records the
    run's tok/s in ``SPEEDS``.  Returns (streams, launches, top-2 gap
    record, routing record)."""
    DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe, scan_ops = \
        mods[:7]
    gc.collect()                  # loops of earlier runs hold their caches
    paged = PagedKVConfig(block_size=block_size) if block_size else None
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN, paged=paged,
                       device="cuda", use_kernel=use_kernel, capture=capture)
    if eng.graphs is not None:
        capture_routes(eng)
    loop = ServingLoop(eng, mode=mode, **(loop_kw or {}))
    rec = record_gaps(loop)
    recorder = RouteRecorder(moe, loop)
    if prepare is not None:
        prepare(loop)
    for p in prompts:
        loop.submit(p, 32)
    torch.cuda.synchronize()
    ops.decode_attention_ragged.launches = 0
    ops.decode_attention_paged.launches = 0
    moe_ops.grouped_ffn_padded.launches = 0
    scan_ops.selective_scan_padded.launches = 0
    blocks_seen = set()
    inner_align = moe_ops.align_block_size

    def align(*args):
        blocks_seen.add(args[3])
        return inner_align(*args)
    moe_ops.align_block_size = align
    try:
        with recorder:
            t0 = time.perf_counter()
            results = loop.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        moe_ops.align_block_size = inner_align
    launches = {"dense": ops.decode_attention_ragged.launches,
                "paged": ops.decode_attention_paged.launches,
                "moe": moe_ops.grouped_ffn_padded.launches,
                "scan": scan_ops.selective_scan_padded.launches}
    s = loop.stats()
    f32 = params["embed"]["table"].dtype == torch.float32
    block = (loop_kw or {}).get("block_size")
    name = (f"{cfg.name}{' f32' if f32 else ''} "
            f"{'paged' if block_size else 'dense'} {mode}"
            f"{f' block {block}' if block else ''}"
            f"{'' if use_kernel else ' (plain versions)'}"
            f"{' captured' if capture else ' eager'}")
    if s["requests"] != len(prompts) or any(
            len(t) != 32 for t in results.values()):
        raise AssertionError(f"{name}: not every request finished")
    hit_forwards = sum(1 for e in eng.prefill_log[loop._prefill_log_start:]
                       if e.get("cached_tokens", 0) > 0)
    shaped = s["forwards"] + hit_forwards
    every = s["forwards"] + s["prefill_forwards"]
    is_moe = cfg.ffn.kind == "moe"
    is_ssm = cfg.ssm is not None            # attention-free: every layer SSM
    layers = cfg.n_layers
    attn = 0 if is_ssm else layers * shaped
    want = {"dense": 0 if block_size else attn,
            "paged": attn if block_size else 0,
            "moe": layers * every if is_moe else 0,
            "scan": layers * every if is_ssm else 0}
    if not use_kernel:
        want = dict.fromkeys(want, 0)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{want} ({layers} layers x {shaped} "
                             f"decode-shape forwards; MoE and scan: x "
                             f"{every} forwards)")
    # decode (T = 4) and the 4 x 64 prefill bucket's token blocks
    want_blocks = {moe_ops.select_token_block(t, cfg.ffn.n_experts)
                   for t in (4, 4 * 64)} if is_moe else set()
    if is_moe and use_kernel and blocks_seen != want_blocks:
        raise AssertionError(f"{name}: MoE token blocks {sorted(blocks_seen)}"
                             f", expected {sorted(want_blocks)}")
    if block_size and s["prefix_hits"] < 1:
        raise AssertionError(f"{name}: the shared prompt prefix never hit")
    budgets = [e["budget"] for e in loop.step_log]
    per_fwd = [e["positions"] for e in loop.step_log]
    print(f"serving {name}: {s['requests']} requests, {s['tokens']} tokens, "
          f"{s['forwards']} forwards (+{s['prefill_forwards']} prefill, "
          f"{hit_forwards} of them prefix-hit), "
          f"{s['tokens_per_forward']:.3f} tok/fwd, positions/fwd "
          f"{min(per_fwd)}..{max(per_fwd)} (mean "
          f"{sum(per_fwd) / len(per_fwd):.1f}), budget "
          f"{min(budgets)}..{max(budgets)}, {dt:.3f} s wall, "
          f"{s['tokens'] / dt:.1f} tok/s, launches {launches}"
          f"{', token blocks ' + str(sorted(blocks_seen)) if is_moe else ''}"
          f"{f', {len(eng.graphs.steps)} graphs' if capture else ''}"
          f" [{card}]")
    SPEEDS.append((name, s["tokens"] / dt, s["forwards"], dt))
    return results, launches, rec, recorder.forwards


def check_forward(mods, cfg, params, prompts, rtol, held=True) -> None:
    """One full-size decode forward of width 16 over 4 prefilled slots,
    through the kernels and through the plain versions, on the same
    cache: the logits must agree to bf16 accuracy through 32 layers.  An
    MoE model is held to that under the balanced routing of Eq. 25 in
    every layer, so both paths choose the same experts; with its own
    router the comparison is printed only: a bf16 difference that flips
    one expert choice at a router near-tie changes that token's state
    enough to flip the layers above it, so the logits part wholesale.
    With ``held`` False the comparison is printed only."""
    from repro_torch.models import forward
    DecodeEngine, PagedKVConfig = mods[:2]
    moe = mods[5]
    pools = ((None,) if cfg.attention is None
             else (None, PagedKVConfig(block_size=16)))
    for paged in pools:
        eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                           paged=paged, device="cuda")
        eng.prefill_slots({s: prompts[s] for s in range(4)})
        toks = torch.as_tensor(np.stack([p[:16] for p in prompts[4:8]]),
                               device="cuda")
        tables = eng._device_tables() if paged else None

        def run(use_kernel, routing):
            logits = forward(eng.params, cfg, {"tokens": toks}, mode="decode",
                             cache=eng.cache, cache_len=eng.slot_lens,
                             use_kernel=use_kernel, block_tables=tables,
                             routing_override=routing)[0]
            return logits.float()

        def compare(got, want):
            return (float((got - want).norm() / want.norm()),
                    float((got.argmax(-1) == want.argmax(-1)).float().mean()))
        name = (f"{cfg.name} {'paged' if paged else 'dense'} "
                f"{str(params['embed']['table'].dtype).split('.')[1]}")
        fixed, how = None, ""
        if cfg.ffn.kind == "moe":
            t, k, e = toks.numel(), cfg.ffn.top_k, cfg.ffn.n_experts
            fixed = (moe.balanced_routing(t, k, e, device="cuda"),
                     torch.full((t, k), 1.0 / k, device="cuda"))
            how = " (balanced routing)"
            rel, agree = compare(run(True, None), run(False, None))
            print(f"forward {name}: kernels vs plain versions with the "
                  f"router, logits relative error {rel:.3g}, argmax "
                  f"agreement {agree:.3f} (not held: routing flips)")
        got, want = run(True, fixed), run(False, fixed)
        if got.shape != (4, 16, cfg.vocab_size) or not torch.isfinite(
                got).all():
            raise AssertionError(f"forward logits {tuple(got.shape)} not "
                                 "finite or of the wrong shape")
        rel, agree = compare(got, want)
        print(f"forward {name}: kernels vs plain versions{how}, logits "
              f"relative error {rel:.3g} "
              f"({f'limit {rtol}' if held else 'not held'}), argmax "
              f"agreement {agree:.3f}")
        if held and rel > rtol:
            raise AssertionError(f"{name} kernel forward leaves the plain "
                                 f"forward: relative error {rel:.3g}")


def profile_steps(mods, cfg, params, prompts, card,
                  how="paged speculative", loop_kw=None, warm=2, steps=4,
                  top=8, use_kernel=True, capture=True,
                  host=False) -> None:
    """torch.profiler over ``steps`` steady decode steps (after ``warm``;
    a captured engine has captured its graphs there) of 4-slot serving,
    ``how`` = "paged|dense <mode>": device busy share of the wall time
    and the ``top`` kernels; recorded in ``IDLE``.  With ``host``,
    cProfile over ``steps`` further steps: the host functions that take
    the most of a step's own time."""
    from torch.profiler import ProfilerActivity, profile
    DecodeEngine, PagedKVConfig, ServingLoop = mods[:3]
    paged = how.startswith("paged")
    gc.collect()
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                       paged=PagedKVConfig(block_size=16) if paged else None,
                       device="cuda", use_kernel=use_kernel, capture=capture)
    loop = ServingLoop(eng, mode=how.split()[1], **(loop_kw or {}))
    for p in prompts[:4]:
        loop.submit(p, 32)
    loop.admit()
    for _ in range(warm):
        loop.step()
    torch.cuda.synchronize()
    mark = len(loop.step_log)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    forwards = len(loop.step_log) - mark
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    total = sum(busy.values())
    if total == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    dtype = str(params["embed"]["table"].dtype).split(".")[1]
    label = (f"{cfg.name} {dtype}{'' if use_kernel else ' plain'} {how} "
             f"{'captured' if capture else 'eager'}")
    IDLE[label] = 100 * (1 - total / wall_ms)
    print(f"profile {label} ({steps} steps, {forwards} "
          f"forwards, under the profiler): wall {wall_ms:.1f} ms, device "
          f"busy {total:.2f} ms ({100 * total / wall_ms:.1f}%), idle "
          f"{100 * (1 - total / wall_ms):.1f}% [{card}]")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.3f} ms  {100 * ms / total:5.1f}%  {name[:90]}")
    if host:
        host_profile(loop, label, steps, card)


def host_profile(loop, label, steps, card) -> None:
    """cProfile over ``steps`` decode steps: wall ms per step and the
    functions with the most own time (cProfile adds to every Python
    call, so shares are indicative, not device metrics)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(steps):
        loop.step()
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    print(f"host profile {label} ({steps} steps under cProfile): "
          f"{wall:.2f} ms a step; own time per step: " + "; ".join(
              f"{fn[2]} ({Path(fn[0]).name}:{fn[1]}) "
              f"{1e3 * v[2] / steps:.2f} ms" for fn, v in rows)
          + f" [{card}]")


def gap_at(rec, rid, pos):
    """The top-2 gap before stream token ``pos`` of request ``rid``, from
    the call whose column 0 produced it, or None."""
    gap = None
    for rows, gaps in rec:
        for i, key in rows.items():
            if key == (rid, pos):
                gap = float(gaps[i])
    return gap


def routing_flips(routes_a, routes_b, rid, end, shared):
    """Every layer whose expert choice differed between two runs at the
    context positions 0 .. ``end`` - 1 of request ``rid``: (position,
    layer, router margin in run a, in run b).  A prefix-cache hit reuses
    the K/V of the shared prompt positions, so there ``shared`` {rid:
    (source request, shared length)} names whose routing made them.  None
    where the runs share no routed position (a dense model)."""
    def at(routes, p):
        r = route_at(routes, rid, p)
        if r is None and rid in shared and p < shared[rid][1]:
            r = route_at(routes, shared[rid][0], p)
        return r

    flips, compared = [], False
    for p in range(end):
        a, b = at(routes_a, p), at(routes_b, p)
        if a is None or b is None:
            continue
        compared = True
        for layer in (a[0] != b[0]).any(-1).nonzero().flatten().tolist():
            flips.append((p, layer, float(a[1][layer]), float(b[1][layer])))
    return flips if compared else None


def compare_streams(name, greedy, other, recs, routes, prompt_len,
                    shared, base="paged greedy", held=True) -> int:
    """``other``'s streams must equal the ``base`` ones; where one
    leaves, the top-2 gap before that token, in every greedy run of
    ``recs`` (all record it), must be a bf16 near-tie — or, for an MoE
    model, the two runs' routing (``routes``: paged greedy, other) must
    have parted before that token was taken, first at a router near-tie
    (margins summing to <= ROUTER_TOL).  Stream token i is taken from the
    forward at context position prompt_len + i - 1.  Every stream is
    reported before a failure is raised; with ``held`` False the
    comparison is printed only."""
    full, bad = 0, []
    for rid, g in greedy.items():
        d = np.nonzero(g != other[rid])[0]
        if not len(d):
            full += 1
            continue
        pos = int(d[0])
        gaps = [gap_at(rec, rid, pos) for rec in recs]
        gap = max(gaps) if all(gp is not None for gp in gaps) else None
        end = prompt_len + pos
        flips = routing_flips(*routes, rid, end, shared)
        route, near_tie = "", False
        if flips:
            p, layer, ma, mb = flips[0]
            near_tie = ma + mb <= ROUTER_TOL
            route = (f", routing parted at context position {p} layer "
                     f"{layer} (router margins {ma:.3g} / {mb:.3g}); "
                     f"{len(flips)} layer choices differ before position "
                     f"{end}")
        elif flips is not None:
            route = f", routing identical before position {end}"
        print(f"  request {rid}: {name} leaves {base} at token {pos}, "
              f"top-2 gap {gap}{route}")
        if gap is None or (gap > GAP_TOL and not near_tie):
            bad.append(f"request {rid} at token {pos}")
    if bad and not held:
        print(f"{name}: {len(bad)} of {len(greedy)} streams leave {base} "
              f"beyond the near-tie rule (printed, not held)")
        return full
    if bad:
        raise AssertionError(
            f"{name}: {', '.join(bad)} diverged where the top-2 gap exceeds "
            f"{GAP_TOL} and no routing near-tie (<= {ROUTER_TOL}) explains "
            "it")
    print(f"{name} == {base}: {full}/{len(greedy)} streams match in "
          f"full (divergence allowed at top-2 gaps <= {GAP_TOL} or after "
          f"routing near-ties <= {ROUTER_TOL})")
    return full


# ---------------------------------------------------------------------------
# the captured decode step and the NFP calibration
# ---------------------------------------------------------------------------

def check_capture(mods, cfg, params, prompts, card) -> None:
    """Captured against eager ``decode_slots`` at full size: two engines
    (``capture`` True and False) on the same weights prefill the same 4
    prompts, then at each width of ``CAPTURE_WIDTHS`` run the same tokens
    twice (the captured engine captures, then replays) and commit the
    same advances (one row advancing 0).  Logits and hidden states must
    be bitwise equal, every call's kernel launches equal, and after the
    commits every cache tensor (K/V, and an SSM model's states) bitwise
    equal — dense, and paged for an attention model."""
    from repro_torch.serving.capture import launch_counts
    DecodeEngine, PagedKVConfig = mods[:2]
    pools = ((None,) if cfg.attention is None
             else (None, PagedKVConfig(block_size=16)))
    for paged in pools:
        gc.collect()
        engs = [DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                             paged=paged, device="cuda", capture=c)
                for c in (False, True)]
        for eng in engs:
            with Uncounted(mods):
                eng.prefill_slots({s: prompts[s] for s in range(4)})
        rng = np.random.default_rng(1)
        mode = "paged" if paged else "dense"
        for n in CAPTURE_WIDTHS:
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                size=(4, n)), device="cuda")
            adv = np.array([n, 1, 0, min(2, n)])
            outs, counts, times = [], [], []
            for eng in engs:
                for _ in range(2):
                    before = launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, cache, hidden = eng.decode_slots(toks)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    after = launch_counts()
                    counts.append({k: after[k] - before[k] for k in after})
                outs.append((logits.clone(), hidden.clone()))
                eng.commit_slots(cache, adv)
            same_cache = all(
                torch.equal(a, b)
                for sa, sb in zip(engs[0].cache["segments"],
                                  engs[1].cache["segments"])
                for a, b in zip(sa.values(), sb.values()))
            ok = (torch.equal(outs[0][0], outs[1][0])
                  and torch.equal(outs[0][1], outs[1][1]) and same_cache
                  and all(c == counts[0] for c in counts)
                  and sum(counts[0].values()) > 0)
            print(f"capture {cfg.name} {mode} n={n}: logits and hidden "
                  f"bitwise equal {torch.equal(outs[0][0], outs[1][0])} / "
                  f"{torch.equal(outs[0][1], outs[1][1])}, cache after the "
                  f"commit equal {same_cache}, launches per call "
                  f"{counts[0]} (eager, eager, capture, replay: "
                  f"{'equal' if all(c == counts[0] for c in counts) else counts}"
                  f"); host ms eager {1e3 * times[1]:.1f}, captured "
                  f"{1e3 * times[3]:.1f} (the capture call "
                  f"{1e3 * times[2]:.1f}) [{card}]")
            if not ok:
                raise AssertionError(f"{cfg.name} {mode} n={n}: the captured "
                                     "decode step leaves the eager one")
        del engs


def calibration_table(mods, cfg, params, card) -> dict:
    """The paper's measurement on the card: ``calibrate_engine`` (wall
    clock: the CAPTURED decode step, CUDA events) on a dense 4-slot
    engine of ``CALIB_MAX_LEN`` positions over ``width_grid(128)`` at the
    buckets it derives, every kernel launch of the sweep counted (exactly
    layers x forwards).  Prints per bucket the measured N_max beside the
    analytic budget, n_idle and the limiting term, the noise, both
    over-prediction ratios and T(N); saves the table under
    ``<out>/calibration/``.  Returns the launches."""
    from repro_torch.autotune import calibrate_engine, save_table
    DecodeEngine, ops, moe_ops, scan_ops = mods[0], mods[3], mods[4], mods[6]
    gc.collect()
    eng = DecodeEngine(cfg, params, batch=4, max_len=CALIB_MAX_LEN,
                       device="cuda")
    fns = {"dense": ops.decode_attention_ragged,
           "paged": ops.decode_attention_paged,
           "moe": moe_ops.grouped_ffn_padded,
           "scan": scan_ops.selective_scan_padded}
    for fn in fns.values():
        fn.launches = 0
    warmup, rounds, iters = 3, 5, 5
    t0 = time.perf_counter()
    table = calibrate_engine(eng, modes=("greedy",), warmup=warmup,
                             rounds=rounds, iters=iters)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    forwards = sum(len(e.ns) for e in table.entries) * (warmup
                                                        + rounds * iters)
    is_moe, is_ssm = cfg.ffn.kind == "moe", cfg.ssm is not None
    want = {"dense": 0 if is_ssm else cfg.n_layers * forwards, "paged": 0,
            "moe": cfg.n_layers * forwards if is_moe else 0,
            "scan": cfg.n_layers * forwards if is_ssm else 0}
    print(f"calibration {cfg.name} ({table.backend} backend, captured "
          f"decode step, 4 slots, max_len {CALIB_MAX_LEN}): "
          f"{len(table.entries)} buckets x {len(table.entries[0].ns)} widths"
          f" x {warmup + rounds * iters} forwards in {dt:.1f} s, "
          f"{len(eng.graphs.steps)} graphs, launches {launches} [{card}]")
    if table.backend != "wallclock" or launches != want:
        raise AssertionError(f"{cfg.name} calibration: backend "
                             f"{table.backend}, launches {launches}, "
                             f"expected {want}")
    rows = []
    for e in table.entries:
        t = dict(zip(e.ns, e.times))
        rows.append({"ell": e.ell, "measured": e.measured_nmax,
                     "analytic": e.analytic_nmax, "n_idle": e.n_idle,
                     "limiting": e.limiting, "noise": e.noise,
                     "over": e.overprediction,
                     "idle_over": e.idle_overprediction,
                     "t1_ms": 1e3 * e.baseline_time,
                     "times_ms": {n: 1e3 * x for n, x in t.items()}})
        if not all(np.isfinite(e.times)) or min(e.times) <= 0:
            raise AssertionError(f"{cfg.name} calibration: bad T(N) {t}")
        print(f"  {cfg.name} L={e.ell}: measured N_max {e.measured_nmax}, "
              f"analytic {e.analytic_nmax} ({e.limiting}), n_idle "
              f"{e.n_idle:.1f}, noise {e.noise:.4f}, over-prediction "
              f"{e.overprediction:.2f}x, idle {e.idle_overprediction:.2f}x; "
              f"T(N)/T(1) " + ", ".join(
                  f"{n}: {x / e.baseline_time:.3f}" for n, x in t.items())
              + f"; T(1) {1e3 * e.baseline_time:.4f} ms [{card}]")
    CALIBRATION[cfg.name] = rows
    (OUT / "calibration").mkdir(parents=True, exist_ok=True)
    save_table(table, str(OUT / "calibration" / f"{cfg.name}.json"))
    del eng
    return launches


def serve_model(mods, arch, card, forward_rtol,
                dense_speculative=False) -> dict:
    """Phase 4 for one model: warm-up, the three serving runs (and with
    ``dense_speculative`` a fourth, whose verify forwards of width 16 run
    the dense attention mode), the stream comparisons, the full-size
    forward check and the profile.  Returns the launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    prompts[5][:32] = prompts[0][:32]          # admitted later: prefix hit
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    check_capture(mods, cfg, params, prompts, card)
    greedy, l1, rec, routes = serve_run(mods, cfg, params, prompts,
                                        block_size=16, mode="greedy",
                                        card=card)
    eager, l0, _, _ = serve_run(mods, cfg, params, prompts, block_size=16,
                                mode="greedy", card=card, capture=False)
    same_streams(f"{cfg.name} paged greedy", eager, greedy)
    spec, l2, _, routes_spec = serve_run(mods, cfg, params, prompts,
                                         block_size=16, mode="speculative",
                                         card=card)
    dense, l3, rec_dense, routes_dense = serve_run(
        mods, cfg, params, prompts, block_size=0, mode="greedy", card=card)
    plen, shared = len(prompts[0]), {5: (0, 32)}
    compare_streams(f"{cfg.name} paged speculative", greedy, spec, [rec],
                    (routes, routes_spec), plen, shared)
    compare_streams(f"{cfg.name} dense greedy", greedy, dense,
                    [rec, rec_dense], (routes, routes_dense), plen, shared)
    runs = {"paged_greedy": l1, "paged_greedy_eager": l0,
            "paged_speculative": l2, "dense_greedy": l3}
    if dense_speculative:
        dspec, runs["dense_speculative"], _, routes_dspec = serve_run(
            mods, cfg, params, prompts, block_size=0, mode="speculative",
            card=card)
        compare_streams(f"{cfg.name} dense speculative", greedy, dspec,
                        [rec], (routes, routes_dspec), plen, shared)
    check_forward(mods, cfg, params, prompts, forward_rtol)
    for capture in (True, False):
        profile_steps(mods, cfg, params, prompts, card, how="paged greedy",
                      top=4, capture=capture, host=capture)
    profile_steps(mods, cfg, params, prompts, card)
    runs["calibration"] = calibration_table(mods, cfg, params, card)
    return runs


def same_streams(name, eager, captured) -> None:
    """The captured step is bitwise the eager one, so a run's streams
    must be identical token for token."""
    bad = [rid for rid in eager if not np.array_equal(eager[rid],
                                                      captured[rid])]
    print(f"{name}: captured streams == eager streams in {len(eager) - len(bad)}"
          f"/{len(eager)}")
    if bad:
        raise AssertionError(f"{name}: captured streams leave the eager "
                             f"ones for requests {bad}")


# ---------------------------------------------------------------------------
# phase 4b: MTP and diffusion on the paper's two validation models
# ---------------------------------------------------------------------------

class DiffusionTrace:
    """While a run serves, wraps ``serving.diffusion.pull_confidence`` (the
    one host pull of every refinement forward) and, for an MoE model, the
    port's ``route_topk``, to keep per refinement forward and row: the
    confidences and tokens the selection read, each position's top-2
    logit gap and (MoE) its smallest router margin over the layers, under
    the key (request, committed context length) that ``keys()`` gives at
    the time of the pull."""

    def __init__(self, diff_mod, moe_mod, n_layers, keys):
        self.diff, self.moe, self.layers, self.keys = (diff_mod, moe_mod,
                                                       n_layers, keys)
        self.trace = {}
        self.margins = []

    def __enter__(self):
        inner_pull, inner_route = (self.diff.pull_confidence,
                                   self.moe.route_topk)

        def route(router_w, x, k):
            weights, idx, probs = inner_route(router_w, x, k)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.margins.append(torch.log(top[:, k - 1] / top[:, k]))
            return weights, idx, probs

        def pull(logits):
            conf, preds = inner_pull(logits)
            rows = logits if logits.dim() == 3 else logits[None]
            gap = top2_gap(rows).cpu().numpy()
            margin = None
            if self.margins:
                m = torch.stack(self.margins[-self.layers:]).amin(0)
                margin = m.reshape(rows.shape[:2]).cpu().numpy()
            self.margins.clear()
            conf2 = conf if conf.ndim == 2 else conf[None]
            preds2 = preds if preds.ndim == 2 else preds[None]
            for row, key in self.keys().items():
                self.trace.setdefault(key, []).append(
                    (conf2[row], preds2[row], gap[row],
                     None if margin is None else margin[row]))
            return conf, preds
        self.saved = (inner_pull, inner_route)
        self.diff.pull_confidence = pull
        self.moe.route_topk = route
        ROUTE_SINKS.append(self._sink)
        return self

    def _sink(self):
        return self.margins

    def __exit__(self, *exc):
        ROUTE_SINKS.remove(self._sink)
        self.diff.pull_confidence, self.moe.route_topk = self.saved


def slot_kv(eng, slot, n):
    """Slot ``slot``'s committed K and V, (layers, n, kv, dh) per
    attention segment, read through its block table on a paged engine."""
    out = []
    for seg in eng.cache["segments"]:
        for key in ("k", "v"):
            leaf = seg[key]
            if eng.manager is None:
                out.append(leaf[:, slot, :n])
                continue
            pages = torch.as_tensor(
                eng.manager.tables[slot][:-(-n // eng.manager.block_size)]
                .astype(np.int64), device="cuda")
            out.append(leaf[:, pages].flatten(1, 2)[:, :n])
    return out


def kv_rel_err(got, want) -> tuple:
    """Largest per-position ||got - want|| / ||want|| over heads and head
    dims, K and V together: over every layer, and over the first layer
    alone (whose K/V come from the tokens before any routing decision)."""
    def err(gs, ws):
        num = sum((g.float() - w.float()).pow(2).sum((0, 2, 3))
                  for g, w in zip(gs, ws))
        den = sum(w.float().pow(2).sum((0, 2, 3)) for w in ws)
        return float((num / den).sqrt().max())
    return err(got, want), err([g[:1] for g in got[:2]],
                               [w[:1] for w in want[:2]])


class Uncounted:
    """Launches made inside the block (reference forwards of a check) are
    taken back out of every kernel's count."""

    def __init__(self, mods):
        ops, moe_ops, scan_ops = mods[3], mods[4], mods[6]
        self.fns = (ops.decode_attention_ragged, ops.decode_attention_paged,
                    moe_ops.grouped_ffn_padded,
                    scan_ops.selective_scan_padded)

    def __enter__(self):
        self.saved = [fn.launches for fn in self.fns]

    def __exit__(self, *exc):
        for fn, n in zip(self.fns, self.saved):
            fn.launches = n


def check_committed_kv(mods, cfg, params, errs, use_kernel=True):
    """A ``prepare`` hook for ``serve_run``: before a finished request's
    slot is released, its committed K/V (the whole context: the prompt's
    prefill, then every commit forward) is held against a batch-1 prefill
    of the same context; the per-position relative error goes to
    ``errs``."""
    DecodeEngine = mods[0]
    ref = DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN, device="cuda",
                       use_kernel=use_kernel)

    def prepare(loop):
        eng = loop.engine
        inner = eng.release_slot

        def release_slot(slot):
            req = list(loop.finished.values())[-1]
            ctx = req.context
            n = int(eng.slot_lens_host[slot])
            if req.slot != slot or n != len(ctx):
                raise AssertionError(f"slot {slot}: committed length {n}, "
                                     f"context {len(ctx)}")
            with Uncounted(mods):
                ref.prefill(torch.as_tensor(ctx[None], device="cuda"))
            errs.append(kv_rel_err(slot_kv(eng, slot, n),
                                   slot_kv(ref, 0, n)))
            inner(slot)
        eng.release_slot = release_slot
    return prepare


def solo_diffusion(mods, cfg, params, prompts, block, card,
                   use_kernel=True):
    """Every prompt through a batch-1 ``DiffusionBlockDecoder`` at
    ``block`` (the dense kernel path, or the plain versions), recording
    its refinement forwards.  Returns ({rid: tokens}, trace)."""
    DecodeEngine, ops, moe, diff_mod = mods[0], mods[3], mods[5], mods[7]
    eng = DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN, device="cuda",
                       use_kernel=use_kernel)
    cur = {}
    trace = DiffusionTrace(diff_mod, moe, cfg.n_layers,
                           lambda: {0: (cur["rid"], eng.cache_len)})
    ops.decode_attention_ragged.launches = 0
    streams, forwards = {}, 0
    t0 = time.perf_counter()
    with trace:
        for rid, p in enumerate(prompts):
            cur["rid"] = rid
            dec = diff_mod.DiffusionBlockDecoder(eng, block_size=block)
            streams[rid], st = dec.generate(p[None], 32)
            forwards += st["forwards"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = ops.decode_attention_ragged.launches
    if got != cfg.n_layers * forwards * use_kernel:
        raise AssertionError(f"solo diffusion: {got} decode-attention "
                             f"launches, expected {cfg.n_layers} x "
                             f"{forwards}")
    print(f"solo DiffusionBlockDecoder {cfg.name} "
          f"{str(params['embed']['table'].dtype).split('.')[1]} block "
          f"{block}: {len(prompts)} requests, {forwards} forwards in "
          f"{dt:.3f} s, launches {got} [{card}]")
    return streams, trace.trace


def replay_block(forwards, n, refine_block):
    """Re-run the selection of one block (``refine_steps`` 4, the serving
    default) from its recorded refinement forwards; returns per iteration
    (positions picked, their tokens, the forward's record)."""
    block = np.full(n, -1, np.int64)
    resolved = np.zeros(n, bool)
    per_iter = max(1, -(-n // 4))
    picks = []
    for rec in forwards:
        if resolved.all():
            break
        before = resolved.copy()
        refine_block(block, resolved, rec[0], rec[1], per_iter)
        new = np.nonzero(resolved & ~before)[0]
        picks.append((new, block[new].copy(), rec))
    return picks


def compare_diffusion(name, batched, solo, trace_a, trace_b, prompt_len,
                      block, refine, f32, held) -> int:
    """Batched diffusion streams against the solo driver's at the same
    block, request by request.  Where one parts, its blocks are replayed
    from both traces up to the first refinement forward whose picks
    differ, and the parting must be a near-tie there: two positions whose
    confidence margins in the two runs sum to <= the confidence tolerance
    (relative), or a picked token whose top-2 gaps are <= the gap
    tolerance, or (MoE) a router margin <= the router tolerance in that
    forward.  Printed per parting; held with ``held``."""
    conf_tol = CONF_RTOL_F32 if f32 else CONF_RTOL_BF16
    gap_tol = GAP_TOL_F32 if f32 else GAP_TOL
    router_tol = ROUTER_TOL_F32 if f32 else ROUTER_TOL
    full, bad = 0, []
    for rid, want in solo.items():
        got = batched[rid]
        if np.array_equal(got, want):
            full += 1
            continue
        ctx, gen, why = prompt_len, 1, None
        while gen < 32 and why is None:
            n = min(block, 32 - gen)
            pa = replay_block(trace_a.get((rid, ctx), []), n, refine)
            pb = replay_block(trace_b.get((rid, ctx), []), n, refine)
            for it, ((xa, ta, ra), (xb, tb, rb)) in enumerate(zip(pa, pb)):
                if np.array_equal(xa, xb) and np.array_equal(ta, tb):
                    continue
                tie, what = None, ""
                if np.array_equal(xa, xb):
                    p = int(xa[np.nonzero(ta != tb)[0][0]])
                    g = max(float(ra[2][p]), float(rb[2][p]))
                    tie = g <= gap_tol
                    what = f"token at block position {p}, top-2 gaps {g:.3g}"
                else:
                    rel = min(
                        ((ra[0][x] - ra[0][y]) + (rb[0][y] - rb[0][x]))
                        / ra[0][x]
                        for x in np.setdiff1d(xa, xb)
                        for y in np.setdiff1d(xb, xa))
                    tie = rel <= conf_tol
                    what = f"positions, confidence margins {rel:.3g} relative"
                if not tie and ra[3] is not None:
                    m = min(float(ra[3].min()), float(rb[3].min()))
                    what += f", smallest router margin {m:.3g}"
                    tie = m <= router_tol
                why = (f"block at context {ctx} iteration {it}: {what}", tie)
                break
            else:
                if len(pa) != len(pb) or not pa:
                    why = (f"block at context {ctx}: no record", False)
            ctx, gen = ctx + n, gen + n
        if why is None:
            why = ("no differing pick found", False)
        d = int(np.nonzero(got != want)[0][0])
        print(f"  request {rid}: {name} leaves the solo driver at token {d}:"
              f" {why[0]} ({'near-tie' if why[1] else 'NOT a near-tie'})")
        if not why[1]:
            bad.append(f"request {rid} at token {d}")
    rule = (f"confidence margins <= {conf_tol:.3g}, top-2 gaps <= "
            f"{gap_tol:.3g}, router margins <= {router_tol:.3g}")
    if bad and held:
        raise AssertionError(f"{name}: {', '.join(bad)} parted from the solo "
                             f"driver beyond the near-tie rule ({rule})")
    print(f"{name} vs solo DiffusionBlockDecoder block {block}: "
          f"{full}/{len(solo)} streams match in full ({rule}; "
          f"{'held' if held else 'printed, not held'}"
          f"{f', {len(bad)} beyond the rule' if bad else ''})")
    return full


def diffusion_run(mods, cfg, params, prompts, card, *, block_size, block,
                  solo_cache):
    """One diffusion serving run (``block`` None: the budget's width),
    with the committed-K/V check on every slot and the refinement trace;
    then the comparison with the solo driver at the run's block (solo
    streams cached per block in ``solo_cache``), held in float32.  The
    kernels take bf16 only, so a float32 model runs the plain versions.
    Returns the launches."""
    f32 = params["embed"]["table"].dtype == torch.float32
    errs, holder = [], {}
    kv_hook = check_committed_kv(mods, cfg, params, errs, use_kernel=not f32)

    def prepare(loop):
        kv_hook(loop)
        eng = loop.engine
        holder["loop"] = loop
        inner_width = loop.adapter.width
        widths = holder["widths"] = set()

        def width(n_active, budget):
            w = inner_width(n_active, budget)
            widths.add(w)
            return w
        loop.adapter.width = width
        holder["trace"] = DiffusionTrace(
            mods[7], mods[5], cfg.n_layers,
            lambda: {s: (r.rid, int(eng.slot_lens_host[s]))
                     for s, r in loop.active.items()})
        holder["trace"].__enter__()
    try:
        streams, launches, _, _ = serve_run(
            mods, cfg, params, prompts, block_size=block_size,
            mode="diffusion", card=card,
            loop_kw={"block_size": block} if block else None,
            prepare=prepare, use_kernel=not f32)
    finally:
        if "trace" in holder:
            holder["trace"].__exit__()
    loop = holder["loop"]
    name = (f"{cfg.name}{' f32' if f32 else ''} "
            f"{'paged' if block_size else 'dense'} diffusion")
    tpf = loop.stats()["tokens_per_forward"]
    if tpf <= 1.0:
        raise AssertionError(f"{name}: {tpf:.3f} tokens per forward")
    tol = KV_RTOL[params["embed"]["table"].dtype]
    deep, first = (max(e[i] for e in errs) for i in (0, 1))
    is_moe = cfg.ffn.kind == "moe"
    held = first if is_moe else deep
    print(f"{name}: committed K/V of {len(errs)} slots vs a prefill of their "
          f"streams, largest per-position relative error {deep:.3g} over "
          f"all layers{' (printed: routing flips)' if is_moe else ''}, "
          f"{first:.3g} at the first layer (limit {tol})")
    if len(errs) != len(prompts) or held > tol:
        raise AssertionError(f"{name}: committed K/V leave a prefill of the "
                             f"stream: {errs}")
    # the block each step asked for (a request's last block is clipped to
    # its remaining tokens, in both drivers alike)
    widths = sorted(holder["widths"])
    print(f"{name}: blocks {widths} (budget {loop.step_log[0]['budget']} "
          f"over {loop.step_log[0]['active']} rows)")
    if len(widths) != 1:
        print(f"{name}: no single block to hold against the solo driver")
        return launches
    solo_block = widths[0]
    if solo_block not in solo_cache:
        solo_cache[solo_block] = solo_diffusion(mods, cfg, params, prompts,
                                                solo_block, card,
                                                use_kernel=not f32)
    solo, trace_b = solo_cache[solo_block]
    compare_diffusion(name, streams, solo, holder["trace"].trace, trace_b,
                      len(prompts[0]), solo_block,
                      mods[7].refine_block, f32, held=f32)
    return launches


def serve_parallel(mods, arch, card, forward_rtol, dense_block=None,
                   f32_layers=None) -> dict:
    """Phase 4 for a parallel-decoding validation model: paged greedy,
    paged MTP (held against greedy), paged diffusion at the budget's
    width and, with ``dense_block``, dense diffusion at that block; the
    full-size forward check; a profile of each run's steady steps.  Then
    the same weights in float32 (at ``f32_layers`` layers where given)
    serve the diffusion runs again through the plain versions (the
    kernels take bf16 only), where the solo comparison is held.
    Returns the launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serving import init_mtp_heads
    cfg = get_config(arch)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    heads = init_mtp_heads(torch.Generator(device="cuda").manual_seed(5),
                           cfg.d_model, cfg.vocab_size, 4)
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params:.4g} parameters, {2 * n_params / 1e9:.4g} GB in bf16; "
          f"MTP bank {tuple(heads['heads'].shape)}, "
          f"{2 * heads['heads'].numel() / 1e9:.4g} GB in bf16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    prompts[5][:32] = prompts[0][:32]          # admitted later: prefix hit
    plen, shared = len(prompts[0]), {5: (0, 32)}
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    check_capture(mods, cfg, params, prompts, card)
    greedy, l1, rec, routes = serve_run(mods, cfg, params, prompts,
                                        block_size=16, mode="greedy",
                                        card=card)
    eager, l0, _, _ = serve_run(mods, cfg, params, prompts, block_size=16,
                                mode="greedy", card=card, capture=False)
    same_streams(f"{cfg.name} paged greedy", eager, greedy)
    mtp_kw = {"mtp_heads": heads}
    mtp, l2, _, routes_mtp = serve_run(mods, cfg, params, prompts,
                                       block_size=16, mode="mtp", card=card,
                                       loop_kw=mtp_kw)
    compare_streams(f"{cfg.name} paged mtp", greedy, mtp, [rec],
                    (routes, routes_mtp), plen, shared)
    runs = {"paged_greedy": l1, "paged_greedy_eager": l0, "paged_mtp": l2}
    solo = {}
    runs["paged_diffusion"] = diffusion_run(
        mods, cfg, params, prompts, card, block_size=16, block=None,
        solo_cache=solo)
    profiles = [("paged greedy", None, 2, 4, True),
                ("paged mtp", mtp_kw, 2, 4, False),
                ("paged diffusion", None, 0, 2, False)]
    if dense_block:
        runs["dense_diffusion"] = diffusion_run(
            mods, cfg, params, prompts, card, block_size=0,
            block=dense_block, solo_cache=solo)
        profiles.append(("dense diffusion", {"block_size": dense_block},
                         0, 2, False))
    check_forward(mods, cfg, params, prompts, forward_rtol)
    profile_steps(mods, cfg, params, prompts, card, how="paged greedy",
                  top=4, capture=False)
    for how, kw, warm, steps, host in profiles:
        profile_steps(mods, cfg, params, prompts, card, how=how, loop_kw=kw,
                      warm=warm, steps=steps, top=4, host=host)
    runs["calibration"] = calibration_table(mods, cfg, params, card)
    del params, heads, solo, mtp_kw, profiles
    gc.collect()
    torch.cuda.empty_cache()
    if f32_layers:
        cfg = dataclasses.replace(cfg, n_layers=f32_layers)
        print(f"{cfg.name} f32: cut to {f32_layers} of "
              f"{get_config(arch).n_layers} layers at full width (float32 "
              "at full depth does not fit the card)")
    params32 = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda", dtype=torch.float32)
    solo = {}
    runs["paged_diffusion_f32"] = diffusion_run(
        mods, cfg, params32, prompts, card, block_size=16, block=None,
        solo_cache=solo)
    if dense_block:
        runs["dense_diffusion_f32"] = diffusion_run(
            mods, cfg, params32, prompts, card, block_size=0,
            block=dense_block, solo_cache=solo)
    profile_steps(mods, cfg, params32, prompts, card, how="paged diffusion",
                  warm=0, steps=2, top=4, use_kernel=False)
    return runs


def solo_greedy(mods, cfg, params, prompts, card) -> tuple:
    """Every prompt through a batch-1 engine's ``greedy_generate`` (the
    kernel path), recording the top-2 gap before each token as
    ``record_gaps`` does.  Returns ({rid: tokens}, gaps)."""
    DecodeEngine, scan_ops = mods[0], mods[6]
    eng = DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN, device="cuda")
    inner_prefill, inner_step = eng.prefill, eng.decode_step
    rec, streams, cur = [], {}, {}

    def prefill(tokens):
        logits = inner_prefill(tokens)
        cur["pos"] = 0
        rec.append(({0: (cur["rid"], 0)}, top2_gap(logits)))
        return logits

    def decode_step(tokens, advance=None):
        logits = inner_step(tokens, advance)
        cur["pos"] += 1
        rec.append(({0: (cur["rid"], cur["pos"])}, top2_gap(logits[:, -1])))
        return logits
    eng.prefill, eng.decode_step = prefill, decode_step
    scan_ops.selective_scan_padded.launches = 0
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        cur["rid"] = rid
        streams[rid] = eng.greedy_generate(
            torch.as_tensor(p[None], device="cuda"), 32)[0].cpu().numpy()
    dt = time.perf_counter() - t0
    want = cfg.n_layers * 32 * len(prompts)
    got = scan_ops.selective_scan_padded.launches
    if got != want:
        raise AssertionError(f"solo greedy: {got} scan launches, expected "
                             f"{want}")
    print(f"solo greedy_generate {cfg.name}: {len(prompts)} requests x 32 "
          f"forwards in {dt:.3f} s, scan launches {got} [{card}]")
    return streams, rec


def serve_ssm(mods, arch, card, forward_rtol) -> dict:
    """Phase 4 for an SSM model, dense greedy only.  The bf16 model serves
    8 requests on 4 slots (every slot reused): the main path, launches
    counted.  Its streams against each request's batch-1
    ``greedy_generate`` and its full-size forward against the plain scan
    are printed only: a 64-layer random-weight Mamba1 amplifies one bf16
    rounding into logits that part wholesale (``ssm_sensitivity`` prints
    by how much).  The same weights cast to float32 then serve the same
    requests, and there every stream must equal its solo
    ``greedy_generate`` through the kernel up to the GAP_TOL near-tie rule
    and the forward must agree with the plain scan within
    ``forward_rtol``.  Returns the launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params:.4g} parameters, {2 * n_params / 1e9:.4g} GB in bf16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    check_capture(mods, cfg, params, prompts, card)
    runs = {"dense_greedy_bf16": ssm_checks(mods, cfg, params, prompts,
                                            card, forward_rtol, held=False)}
    for capture in (True, False):
        profile_steps(mods, cfg, params, prompts, card, how="dense greedy",
                      capture=capture, host=capture)
    runs["calibration"] = calibration_table(mods, cfg, params, card)
    params32 = _to_f32(params)
    for p in (params, params32):
        count_launches(cfg, p, prompts, card)
    ssm_sensitivity(cfg, params, params32, prompts)
    del params
    torch.cuda.empty_cache()
    runs["dense_greedy_f32"] = ssm_checks(mods, cfg, params32, prompts, card,
                                          forward_rtol, held=True)
    return runs


def ssm_checks(mods, cfg, params, prompts, card, forward_rtol, held):
    """Serve the 8 requests, compare every stream with its solo
    ``greedy_generate`` and the forward with the plain scan (held or
    printed only).  Returns the serving run's launches."""
    dtype = "f32" if params["embed"]["table"].dtype == torch.float32 \
        else "bf16"
    served, launches, rec, _ = serve_run(mods, cfg, params, prompts,
                                         block_size=0, mode="greedy",
                                         card=card)
    if dtype == "bf16":
        eager, _, _, _ = serve_run(mods, cfg, params, prompts, block_size=0,
                                   mode="greedy", card=card, capture=False)
        same_streams(f"{cfg.name} bf16 dense greedy", eager, served)
    solo, rec_solo = solo_greedy(mods, cfg, params, prompts, card)
    compare_streams(f"{cfg.name} {dtype} dense greedy", solo, served,
                    [rec_solo, rec], ([], []), len(prompts[0]), {},
                    base="solo greedy_generate", held=held)
    check_forward(mods, cfg, params, prompts, forward_rtol, held=held)
    return launches


def count_launches(cfg, params, prompts, card) -> None:
    """Device kernels of one eager width-1 decode forward over 4 slots
    (torch.profiler's kernel events), per layer: what a captured graph
    holds as nodes and an eager forward launches from the host."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import forward
    from repro_torch.models.transformer import init_cache
    cache = init_cache(cfg, 4, MAX_LEN, params["embed"]["table"].dtype,
                       "cuda")
    toks = torch.as_tensor(np.stack([p[:1] for p in prompts[:4]]),
                           device="cuda")
    lens = torch.full((4,), 48, dtype=torch.int32, device="cuda")

    def run():
        forward(params, cfg, {"tokens": toks}, mode="decode", cache=cache,
                cache_len=lens, use_kernel=True)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dtype = str(params["embed"]["table"].dtype).split(".")[1]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    print(f"launches {cfg.name} {dtype}: {len(kernels)} device operations "
          f"(kernels, copies, fills) in one width-1 decode forward, "
          f"{len(kernels) / cfg.n_layers:.2f} per layer; most frequent: "
          + ", ".join(f"{n[:60]} x{c}" for n, c in sorted(
              by_name.items(), key=lambda kv: -kv[1])[:8]) + f" [{card}]")


def ssm_sensitivity(cfg, params, params32, prompts) -> None:
    """How far two arithmetics of the same random-weight model part: the
    logits of 4 prompts run as one batch and one by one (same weights and
    type), and bf16 against the same weights cast to float32."""
    from repro_torch.models import forward
    toks = torch.as_tensor(np.stack(prompts[:4]), device="cuda")

    def logits(p, t):
        return forward(p, cfg, {"tokens": t}, use_kernel=True)[0].float()

    def batch_and_rows(p):
        return logits(p, toks), torch.cat([logits(p, toks[i:i + 1])
                                           for i in range(4)])
    b4, b1 = batch_and_rows(params)
    f4, f1 = batch_and_rows(params32)
    for name, got, want in (("bf16 batch-1 vs batch-4", b1, b4),
                            ("f32 batch-1 vs batch-4", f1, f4),
                            ("bf16 vs f32, batch 4", b4, f4)):
        print(f"sensitivity {cfg.name} ({name}, 4 x 48 tokens): logits "
              f"relative error {float((got - want).norm() / want.norm()):.3g}"
              f", max abs {float((got - want).abs().max()):.3g}, argmax "
              f"agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}"
              f", logit std {float(want.std()):.3g}")


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 5: the serve CLI — pinned replay, calibrated serving
# ---------------------------------------------------------------------------

def cli_runs():
    """(run name, serve CLI arguments): the pinned replay of full-width
    stablelm_3b on the simulated H100 clock, then on the wall clock
    (writing the scorecard); then wedlm8b_like and granite_moe_3b_a800m
    served speculative with ``--calibration run`` and then ``load`` (4
    slots, a dense 1024-position cache: the calibration's engine)."""
    calib = OUT / "calibration"
    out = [("stablelm_pinned_simulated",
            ["--trace", "pinned", "--trace-clock", "simulated"]),
           ("stablelm_pinned_wall",
            ["--trace", "pinned", "--bench-out",
             str(OUT / "BENCH_serving_h100.json")])]
    for arch in ("wedlm8b_like", "granite_moe_3b_a800m"):
        for how in ("run", "load"):
            out.append((f"{arch.split('_')[0]}_calibrated_{how}", [
                "--arch", arch, "--requests", "8", "--tokens", "32",
                "--prompt-len", "48", "--serve-mode", "speculative",
                "--max-len", str(CALIB_MAX_LEN), "--calibration", how,
                "--calibration-path", str(calib / f"{arch}_serve.json")]))
    return out


def run_cli(argv) -> None:
    from repro_torch.launch.serve import build_parser, check_args, serve
    (OUT / "calibration").mkdir(parents=True, exist_ok=True)
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    serve(args)


def report_card(card) -> None:
    """Read back the wall-clock replay's scorecard and check it."""
    data = json.loads((OUT / "BENCH_serving_h100.json").read_text())
    m = data["metrics"]
    if (data["clock"] != "wall" or m["completed"] + m["rejected"]
            != data["pinned"]["trace_requests"] or m["completed"] < 1):
        raise AssertionError(f"pinned replay scorecard: {data}")
    print(f"scorecard BENCH_serving_h100.json ({data['device']}, "
          f"{data['clock']} clock): {m['completed']} completed, "
          f"{m['rejected']} rejected, {m['tokens']} tokens in "
          f"{data['makespan_s']:.4f} s; TTFT p50/p95 "
          f"{1e3 * m['ttft_p50_s']:.2f} / {1e3 * m['ttft_p95_s']:.2f} ms, "
          f"ITL p50/p95 {1e3 * m['itl_p50_s']:.2f} / "
          f"{1e3 * m['itl_p95_s']:.2f} ms, goodput "
          f"{m['goodput_tok_s']:.1f} of {m['throughput_tok_s']:.1f} tok/s; "
          + "; ".join(f"{c}: goodput {g['goodput_tok_s']:.1f} tok/s, "
                      f"attainment {g['slo_attainment']}"
                      for c, g in m["per_class"].items()) + f" [{card}]")


def print_summary(card) -> None:
    """Eager beside captured tok/s, idle shares, and the calibration
    table (measured beside analytic beside idle-compute)."""
    print(f"summary: serving tok/s [{card}]")
    for name, tps, fwd, dt in SPEEDS:
        print(f"  {name}: {tps:.1f} tok/s ({fwd} forwards, {dt:.3f} s)")
    print(f"summary: device idle share under the profiler [{card}]")
    for label, idle in IDLE.items():
        print(f"  {label}: {idle:.1f}%")
    print(f"summary: NFP calibration (4 slots; measured N_max / analytic "
          f"budget (limiting term) / n_idle / noise) [{card}]")
    for arch, rows in CALIBRATION.items():
        print(f"  {arch}: " + "; ".join(
            f"L={r['ell']}: {r['measured']} / {r['analytic']} "
            f"({r['limiting']}) / {r['n_idle']:.1f} / {r['noise']:.4f}"
            for r in rows))


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one NVIDIA GPU")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory for the replay scorecard and the "
                         "calibration tables")
    OUT = ap.parse_args().out.resolve()
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
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    from repro_torch.models import moe

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    built = compile_libraries(["decode_attention", "moe_ffn", "mamba_scan"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in built.items():
        print(f"  {name}: {path.name}")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"    {line.strip()}")

    # 3. kernels
    t0 = time.perf_counter()
    err = check_kernels(ops)
    floor = launch_floor_ms()
    print(f"  launch floor (one-element add_ under the same timing): "
          f"{floor:.4f} ms [{card}]")
    times = {n: time_kernels(ops, n=n) for n in (1, 16)}
    for n, t in times.items():
        for mode, r in t.items():
            print(f"  {mode} n={n}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                  f"executed-tile bound {r['tile_bound_ms']:.5f} ms "
                  f"[{card}]")
    wedlm = {"shape": (32, 8, 128), "lens": (48, 64, 96, 112)}
    times_wedlm = {n: time_kernels(ops, n, **wedlm) for n in (1, 16, 17)}
    for n, t in times_wedlm.items():
        for mode, r in t.items():
            print(f"  {mode} n={n} wedlm8b_like (h 32, kv 8, dh 128, lens "
                  f"{list(wedlm['lens'])}): kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                  f"executed-tile bound {r['tile_bound_ms']:.5f} ms [{card}]")
    moe_err = check_moe(moe_ops, moe)
    e, _, d, f = GRANITE_MOE
    moe_times = time_moe(moe_ops, moe, moe_weights(e, d, f, seed=4))
    for label, r in moe_times.items():
        if label == "staircase":
            continue
        print(f"  moe {label} (token_block {r['token_block']}, "
              f"{r['blocks']} blocks): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, {r['library']} "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), a torch sum over the active experts' "
              f"weight bytes {r['read_ms']:.4f} ms [{card}]")
    e, k, d, f = LLADA_MOE
    llada_times = time_moe(moe_ops, moe, moe_weights(e, d, f, seed=8),
                           shape=LLADA_MOE, runs=LLADA_TIMES,
                           staircase=False)
    for label, r in llada_times.items():
        print(f"  moe llada_mini_like {label} (T {r['T']}, token_block "
              f"{r['token_block']}, {r['blocks']} blocks): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"{r['library']} {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), a torch sum over "
              f"the active experts' weight bytes {r['read_ms']:.4f} ms "
              f"[{card}]")
    print("  moe staircase (balanced routing; T: kernel ms, token block, "
          "blocks): " + ", ".join(
              f"{t}: {ms:.4f} ({tb}, {nb})"
              for t, (ms, tb, nb) in moe_times["staircase"].items())
          + f" [{card}]")
    scan_err = check_scan(scan_ops)
    scan_times = time_scan(scan_ops)
    for label in ("decode", "prefill"):
        r = scan_times[label]
        print(f"  scan {label} (b 4, {r['s_pad']} padded positions): kernel "
              f"{r['ms']:.4f} ms, wrapper with padding {r['wrapper_ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, library none, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}; real positions "
              f"only {r['real_bound_ms']:.5f} ms) [{card}]")
    print("  scan staircase (b 4; n: kernel ms, padded positions): "
          + ", ".join(f"{n}: {ms:.4f} ({sp})"
                      for n, (ms, sp) in scan_times["staircase"].items())
          + f" [{card}]")

    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # 4. serving
    from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
    from repro_torch.serving import diffusion as diff_mod
    mods = (DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe,
            scan_ops, diff_mod)
    runs = {}
    for arch, serve, rtol in (
            ("stablelm_3b", functools.partial(serve_model,
                                              dense_speculative=True),
             FORWARD_RTOL),
            ("granite_moe_3b_a800m", serve_model, MOE_FORWARD_RTOL),
            ("falcon_mamba_7b", serve_ssm, SSM_FORWARD_RTOL),
            ("wedlm8b_like", functools.partial(serve_parallel,
                                               dense_block=16),
             FORWARD_RTOL),
            ("llada_mini_like", functools.partial(
                serve_parallel, f32_layers=LLADA_F32_LAYERS),
             MOE_FORWARD_RTOL)):
        t0 = time.perf_counter()
        for run, launches in serve(mods, arch, card, rtol).items():
            runs[f"{arch.split('_')[0]}_{run}"] = launches
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {arch}: {time.perf_counter() - t0:.1f} s")

    # 5. the pinned trace replay, then calibrated serving, through the CLI
    fns = {"dense": ops.decode_attention_ragged,
           "paged": ops.decode_attention_paged,
           "moe": moe_ops.grouped_ffn_padded,
           "scan": scan_ops.selective_scan_padded}
    for run, argv in cli_runs():
        print(f"cli {run}: python -m repro_torch.launch.serve "
              + " ".join(argv), flush=True)
        t0 = time.perf_counter()
        run_cli(argv)
        runs[run] = {k: fn.launches for k, fn in fns.items()}
        print(f"cli {run}: {time.perf_counter() - t0:.1f} s, launches "
              f"{runs[run]} [{card}]")
        gc.collect()
        torch.cuda.empty_cache()
    report_card(card)
    print_summary(card)

    # 6. report
    src = "src/repro_torch/csrc/decode_attention.cu"
    kernels = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for mode, fn, line in (("dense", "decode_attention_dense", 123),
                           ("paged", "decode_attention_paged", 186)):
        r = times[1][mode]
        kernels.append({
            "name": fn, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/decode_attention/kernel.py:{line}",
            "launches": sum(r[mode] for r in runs.values()),
            "launches_by_run": {k: r[mode] for k, r in runs.items()},
            "max_abs_err": err[mode],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "n16": {key: times[16][mode][key] for key in keys},
            "wedlm_n17": {key: times_wedlm[17][mode][key] for key in keys},
            "launch_floor_ms": floor})
    r = moe_times["decode_balanced"]
    kernels.append({
        "name": "moe_ffn", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_ffn.cu",
        "replaces": "src/repro/kernels/moe_ffn/kernel.py:67",
        "launches": sum(r["moe"] for r in runs.values()),
        "launches_by_run": {k: r["moe"] for k, r in runs.items()},
        "max_abs_err": moe_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "prefill": {key: moe_times["prefill_router"][key] for key in keys},
        "decode_skewed": {key: moe_times["decode_skewed"][key]
                          for key in keys},
        "llada_decode_T64": {key: llada_times["decode_router"][key]
                             for key in keys},
        "llada_prefill_T192": {key: llada_times["prefill_router"][key]
                               for key in keys},
        "staircase_ms": {t: ms for t, (ms, _, _) in
                         moe_times["staircase"].items()}})
    kernels.append({
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:55",
        "launches": sum(r["scan"] for r in runs.values()),
        "launches_by_run": {k: r["scan"] for k, r in runs.items()},
        "max_abs_err": scan_err,
        **{key: scan_times["decode"][key] for key in keys},
        "prefill": {key: scan_times["prefill"][key] for key in keys},
        "staircase_ms": {n: ms for n, (ms, _) in
                         scan_times["staircase"].items()}})
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of command "
          "time")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
