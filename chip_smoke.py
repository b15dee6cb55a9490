#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   — require CUDA, print the card's name and power limit.
  2. build    — compile csrc/decode_attention.cu and csrc/moe_ffn.cu with
                nvcc (sm_90a), one process per source, started together.
  3. kernels  — both decode-attention kernels (dense slots, paged pool)
                against their plain PyTorch version at stablelm_3b
                (h = kv = 32, dh = 80), wedlm8b_like (h = 32, kv = 8,
                dh = 128) and granite_moe_3b_a800m (h = 24, kv = 8, dh = 64)
                shapes: n in {1, 4, 16, 65}, ragged lengths with an empty
                and a full row, fragmented and reversed block tables, with
                and without a window; the executed kv tiles must equal
                slack_report's.  The fused grouped MoE FFN against its
                plain version at granite shapes (E 40, top-8, d 1536, f 512,
                swiglu) for T in {1, 4, 16, 40, 41, 256} under balanced,
                skewed and router routing, gelu at f 1024 and llada_mini
                shapes (E 256, d 2048) at T = 4; executed blocks must equal
                sum ceil(g_e / token_block), and a row must give bitwise the
                same output at T = 1 and T = 41 (junk in the padding rows).
                Then times each kernel, its plain version and a library
                call (scaled_dot_product_attention; torch._grouped_mm),
                never called by the port, and prints the MoE kernel's
                M_moe / tau staircase over T.
  4. serving  — full-size stablelm_3b, then full-size granite_moe_3b_a800m,
                each with seeded random weights, 4 slots, max_len 256,
                8 requests of 48-token prompts (two share their first 32
                tokens) x 32 new tokens: paged greedy, paged speculative,
                dense greedy.  Checks completion, the launch counts (32
                layers x decode-shape forwards for decode attention; 32 x
                all forwards, prefill included, for the MoE FFN, whose 16-
                and 64-row token blocks must both run), and that the paged
                speculative and the dense greedy streams equal the paged
                greedy ones up to bf16 near-ties (granite: printing whether
                the routing differed where a stream leaves).  Then one
                full-size forward per model through the kernels against the
                same forward through the plain versions, and a
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
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
MAX_LEN = 256
LAYERS = 32
# (E, top-k, d_model, expert d_ff)
GRANITE_MOE = (40, 8, 1536, 512)
LLADA_MOE = (256, 8, 2048, 512)


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
# phase 3a: decode attention against its plain version
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
    """Every decode-attention case of phase 3; returns the max abs error
    per kernel."""
    shapes = {"stablelm_3b": (32, 32, 80), "wedlm8b_like": (32, 8, 128),
              "granite_moe_3b_a800m": (24, 8, 64)}
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


def _bound(bytes_, flops) -> tuple:
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
    gelu = moe_weights(e, d, 1024, gated=False, seed=2)
    cases.append(("gelu f=1024", gelu, k, 16, "router"))
    llada = moe_weights(LLADA_MOE[0], LLADA_MOE[2], LLADA_MOE[3], seed=3)
    cases.append(("llada_mini", llada, LLADA_MOE[1], 4, "router"))
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


def time_moe(moe_ops, moe, weights) -> dict:
    """Kernel, plain, library and bound at granite decode (T = 4, 4 slots
    of 1 token, balanced and skewed) and prefill (T = 256, router), then
    the kernel over T under balanced routing (the M_moe / tau staircase:
    M_moe·E/k = 80 and tau = E = 40 for granite)."""
    e, k, d, f = GRANITE_MOE
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, t, routing in (("decode_balanced", 4, "balanced"),
                              ("decode_skewed", 4, "skewed"),
                              ("prefill_router", 256, "router")):
        a = moe_inputs(moe_ops, moe, weights, k=k, t=t, routing=routing,
                       seed=5)
        lib, lib_name = grouped_mm_ffn(a["x_sorted"], weights, a["gs"])
        bound, by = moe_bound_ms(a, d, f)
        out[label] = {
            "ms": time_ms(lambda: moe_call(moe_ops, weights, a), flush),
            "plain_ms": time_ms(lambda: moe_call(moe_ops, weights, a,
                                                 plain=True), flush),
            "library_ms": time_ms(lib, flush), "library": lib_name,
            "bound_ms": bound, "bound_by": by, "token_block": a["tb"],
            "blocks": sum(-(-g // a["tb"]) for g in a["gs"].tolist())}
    stair = {}
    for t in (1, 2, 5, 10, 20, 40, 41, 80):
        a = moe_inputs(moe_ops, moe, weights, k=k, t=t, routing="balanced",
                       seed=6)
        stair[t] = (time_ms(lambda: moe_call(moe_ops, weights, a), flush),
                    a["tb"], sum(-(-g // a["tb"]) for g in a["gs"].tolist()))
    out["staircase"] = stair
    return out


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def top2_gap(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


class RouteRecorder:
    """While a run serves, wraps the port's ``route_topk`` and the engine's
    two forward entries — ``decode_slots`` (decode, verify and prefix-hit
    suffix forwards) and ``_prefill_scratch`` (prompt prefill) — to keep,
    for every forward of an MoE model, each row's request and first
    context position and every layer's routing: the chosen experts
    (sorted) and the router margin between the k-th and (k+1)-th expert
    (a log-probability difference), on the device.  Rows admitted by the
    forward's own admission learn their request when it ends."""

    def __init__(self, moe_mod, loop):
        self.mod, self.inner, self.loop = moe_mod, moe_mod.route_topk, loop
        self.calls, self.forwards, self.pending = [], [], []
        self.admitting = False
        self.saved = ()

    def __enter__(self):
        def route(router_w, x, k):
            weights, idx, probs = self.inner(router_w, x, k)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.append((torch.sort(idx, dim=-1).values,
                               torch.log(top[:, k - 1] / top[:, k])))
            return weights, idx, probs
        eng, loop = self.loop.engine, self.loop
        inner_decode, inner_scratch = eng.decode_slots, eng._prefill_scratch
        inner_admit = loop.admit

        def decode_slots(tokens):
            offsets = eng.slot_lens_host.copy()
            self.calls.clear()
            out = inner_decode(tokens)
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
        self.saved = (inner_decode, inner_scratch, inner_admit)
        self.mod.route_topk = route
        eng.decode_slots, eng._prefill_scratch = decode_slots, prefill_scratch
        loop.admit = admit
        return self

    def __exit__(self, *exc):
        self.mod.route_topk = self.inner
        eng = self.loop.engine
        eng.decode_slots, eng._prefill_scratch, self.loop.admit = self.saved

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


def serve_run(mods, cfg, params, prompts, *, block_size, mode, card):
    DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe = mods
    paged = PagedKVConfig(block_size=block_size) if block_size else None
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN, paged=paged,
                       device="cuda")
    loop = ServingLoop(eng, mode=mode)
    rec = record_gaps(loop)
    recorder = RouteRecorder(moe, loop)
    for p in prompts:
        loop.submit(p, 32)
    torch.cuda.synchronize()
    ops.decode_attention_ragged.launches = 0
    ops.decode_attention_paged.launches = 0
    moe_ops.grouped_ffn_padded.launches = 0
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
                "moe": moe_ops.grouped_ffn_padded.launches}
    s = loop.stats()
    name = f"{cfg.name} {'paged' if block_size else 'dense'} {mode}"
    if s["requests"] != len(prompts) or any(
            len(t) != 32 for t in results.values()):
        raise AssertionError(f"{name}: not every request finished")
    hit_forwards = sum(1 for e in eng.prefill_log[loop._prefill_log_start:]
                       if e.get("cached_tokens", 0) > 0)
    shaped = s["forwards"] + hit_forwards
    every = s["forwards"] + s["prefill_forwards"]
    is_moe = cfg.ffn.kind == "moe"
    want = {"dense": 0 if block_size else LAYERS * shaped,
            "paged": LAYERS * shaped if block_size else 0,
            "moe": LAYERS * every if is_moe else 0}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{want} (32 layers x {shaped} decode-shape "
                             f"forwards; MoE: x {every} forwards)")
    if is_moe and blocks_seen != {16, 64}:
        raise AssertionError(f"{name}: MoE token blocks {sorted(blocks_seen)}"
                             ", expected both 16 and 64")
    if block_size and s["prefix_hits"] < 1:
        raise AssertionError(f"{name}: the shared prompt prefix never hit")
    print(f"serving {name}: {s['requests']} requests, {s['tokens']} tokens, "
          f"{s['forwards']} forwards (+{s['prefill_forwards']} prefill, "
          f"{hit_forwards} of them prefix-hit), {dt:.3f} s wall, "
          f"{s['tokens'] / dt:.1f} tok/s, launches {launches}"
          f"{', token blocks ' + str(sorted(blocks_seen)) if is_moe else ''}"
          f" [{card}]")
    return results, launches, rec, recorder.forwards


def check_forward(mods, cfg, params, prompts, rtol) -> None:
    """One full-size decode forward of width 16 over 4 prefilled slots,
    through the kernels and through the plain versions, on the same
    cache: the logits must agree to bf16 accuracy through 32 layers.  An
    MoE model is held to that under the balanced routing of Eq. 25 in
    every layer, so both paths choose the same experts; with its own
    router the comparison is printed only: a bf16 difference that flips
    one expert choice at a router near-tie changes that token's state
    enough to flip the layers above it, so the logits part wholesale."""
    from repro_torch.models import forward
    DecodeEngine, PagedKVConfig = mods[:2]
    moe = mods[5]
    for paged in (None, PagedKVConfig(block_size=16)):
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
        name = f"{cfg.name} {'paged' if paged else 'dense'}"
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
              f"relative error {rel:.3g} (limit {rtol}), argmax agreement "
              f"{agree:.3f}")
        if rel > rtol:
            raise AssertionError(f"{name} kernel forward leaves the plain "
                                 f"forward: relative error {rel:.3g}")


def profile_steps(mods, cfg, params, prompts, card) -> None:
    """torch.profiler over 4 steady decode steps of paged speculative
    serving: device busy share of the wall time and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    DecodeEngine, PagedKVConfig, ServingLoop = mods[:3]
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
    print(f"profile {cfg.name} (4 paged speculative steps, under the "
          f"profiler): wall {wall_ms:.1f} ms, device busy {total:.2f} ms "
          f"({100 * total / wall_ms:.1f}%), idle "
          f"{100 * (1 - total / wall_ms):.1f}% [{card}]")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms  {100 * ms / total:5.1f}%  {name[:90]}")


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
                    shared) -> int:
    """``other``'s streams must equal the paged greedy ones; where one
    leaves, the top-2 gap before that token, in every greedy run of
    ``recs`` (all record it), must be a bf16 near-tie — or, for an MoE
    model, the two runs' routing (``routes``: paged greedy, other) must
    have parted before that token was taken, first at a router near-tie
    (margins summing to <= ROUTER_TOL).  Stream token i is taken from the
    forward at context position prompt_len + i - 1.  Every stream is
    reported before a failure is raised."""
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
        print(f"  request {rid}: {name} leaves paged greedy at token {pos}, "
              f"top-2 gap {gap}{route}")
        if gap is None or (gap > GAP_TOL and not near_tie):
            bad.append(f"request {rid} at token {pos}")
    if bad:
        raise AssertionError(
            f"{name}: {', '.join(bad)} diverged where the top-2 gap exceeds "
            f"{GAP_TOL} and no routing near-tie (<= {ROUTER_TOL}) explains "
            "it")
    print(f"{name} == paged greedy: {full}/{len(greedy)} streams match in "
          f"full (divergence allowed at top-2 gaps <= {GAP_TOL} or after "
          f"routing near-ties <= {ROUTER_TOL})")
    return full


def serve_model(mods, arch, card, forward_rtol) -> dict:
    """Phase 4 for one model: warm-up, the three serving runs, the stream
    comparisons, the full-size forward check and the profile.  Returns
    the launches by run."""
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
    greedy, l1, rec, routes = serve_run(mods, cfg, params, prompts,
                                        block_size=16, mode="greedy",
                                        card=card)
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
    check_forward(mods, cfg, params, prompts, forward_rtol)
    profile_steps(mods, cfg, params, prompts, card)
    return {"paged_greedy": l1, "paged_speculative": l2, "dense_greedy": l3}


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
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    from repro_torch.models import moe

    # 1. device
    card = card_line()
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    built = compile_libraries(["decode_attention", "moe_ffn"])
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
              f"({r['bound_by']}) [{card}]")
    print("  moe staircase (balanced routing; T: kernel ms, token block, "
          "blocks): " + ", ".join(
              f"{t}: {ms:.4f} ({tb}, {nb})"
              for t, (ms, tb, nb) in moe_times["staircase"].items())
          + f" [{card}]")

    # 4. serving
    from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
    mods = (DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe)
    runs = {}
    for arch, rtol in (("stablelm_3b", FORWARD_RTOL),
                       ("granite_moe_3b_a800m", MOE_FORWARD_RTOL)):
        for run, launches in serve_model(mods, arch, card, rtol).items():
            runs[f"{arch.split('_')[0]}_{run}"] = launches
        torch.cuda.empty_cache()

    # 5. report
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
        "prefill": {key: moe_times["prefill_router"][key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
