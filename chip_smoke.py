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
                modes; then the geometries (h, kv, dh) = (48, 8, 128)
                mixtral_8x22b, (24, 2, 128) starcoder2_3b, (40, 10, 128)
                phi3_medium_14b, (32, 32, 96) phi3_vision_4p2b, (32, 32,
                64) zamba2_1p2b's shared attention and (6, 6, 64)
                whisper_tiny's decoder, n in {1, 16, 17}, with and without
                a window, both modes; then
                mixtral's window of 4096 at lengths 4095, 4096, 4097, 4352
                and 4600 in a 4608-position cache (tiles skipped below
                the window); and the reduced geometries the examples
                serve, dh 16: stablelm_3b's (4, 4) and llada_mini_like's
                (4, 2), n in {1, 9, 13, 16, 17}, both modes; the executed
                kv tiles must equal slack_report's.  The fused grouped MoE FFN against its
                plain version at granite shapes (E 40, top-8, d 1536, f
                512, swiglu) for T in {1, 4, 16, 40, 41, 256} under
                balanced, skewed and router routing, every row on one
                expert (T = 16, 41), f 1024 swiglu and gelu (T = 4 / 16,
                41) and llada_mini_like shapes (E 256, top-8, d 2048, f
                512) at T = 4 and at its serving T's: decode 4 x (w + 1)
                = 64 and 68, prefill 4 x 48 = 192 and the 64-position
                bucket's 256, and mixtral_8x22b's (E 8, top-2, d 6144, f
                16384) at T = 4 and 256, and reduced llada_mini_like's
                (E 16, top-2, d 64, f 32: what quickstart runs) at T = 8
                and 16;
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
                stablelm_3b's shapes, n = 17 at wedlm8b_like's and n = 1
                and 16 at the six later geometries; the MoE FFN at
                granite's, llada's and mixtral's decode and prefill), its
                plain version and a library call
                (scaled_dot_product_attention; torch._grouped_mm; none
                computes a selective scan), never called by the port, the
                launch floor (a one-element add_ under the same timing),
                and prints the MoE kernel's M_moe / tau staircase over T
                and the scan's M_ssm staircase over n.
  3b. moe_plain — the plain MoE path (``moe_ffn(use_kernel=False)``: one
                ``torch._grouped_mm`` per weight over each expert's own
                rows) at the full-width layer shapes of
                granite_moe_3b_a800m (E 40, top-8), llada_mini_like (E
                256, top-8) and mixtral_8x22b (E 8, top-2), bf16, with
                each layer's router, prefill 4 x 48 and decode 4 x 1
                tokens: against ``masked_ffn`` (every row through every
                expert, each keeping its own by ``torch.where``: the
                port's plain path before the grouped products) within 2^-8
                normwise and against ``moe_ffn(use_kernel=True)`` within
                2^-7 (the kernel keeps h in f32), the three timed; then
                llada's width in f32, which a CUDA tensor routes to the
                block-aligned product (``_grouped_mm`` would read the
                group ends back to the host): ms and memory.  A forward
                and backward of one full-width granite MoE layer under
                ``torch.cuda.set_sync_debug_mode("error")``: no host read.
                One train step of granite at full width and 8 of its 32
                layers (batch 4 x 256, n_micro 1, remat True) on the
                grouped and the masked path, the same weights and batch:
                first loss held equal (1e-2 relative) and every leaf's
                gradient (the worst within 2^-8 normwise), median step
                ms and memory peak printed.
  4. analysis— ``python -m repro_torch.analysis --check-baseline`` in a
                subprocess (host syncs on the hot paths, recapture
                hazards, the ctypes signatures against the extern "C"
                lists, the launch tiles at the twelve configs' shapes,
                drift against the pinned contract): any new finding fails.
                Then ``kernel_contracts.LaunchRecorder`` wraps the loaded
                libraries for the serving phases of stablelm_3b (both
                decode-attention modes), granite_moe_3b_a800m (the MoE FFN)
                and falcon_mamba_7b (the scan) below, and after them every
                recorded launch is checked: its arity against the extern
                "C" list, its scalars equal to the launch-args function at
                the recorded shapes and the model's geometry, its tiles
                within the kernel's limits, and the launched tiles equal to
                the declared ones and to the pinned contract.  Prints the
                distinct launch configurations of each entry point.
  5. serving  — every forward replays a CUDA graph (``serving.capture``):
                the decode step per width, the slotted prefill per (batch,
                width), the prefix-hit suffix at its bucket width, the
                single-request prefill and decode steps.  The eager runs
                (``capture=False``) launch the same forwards one by one
                (``serving.capture.EagerGraphs``).  For each
                model first: captured against eager ``decode_slots`` at
                n in {1, 5, 16, 17}, dense and paged (falcon dense): logits
                and hidden bitwise equal, the cache (K/V, SSM states)
                bitwise equal after a commit, launches per call equal
                across eager calls, the capture and a replay.  Then, for
                stablelm_3b (dense and paged), granite_moe_3b_a800m
                (dense), falcon_mamba_7b (dense, exact-length groups) and
                wedlm8b_like (paged), ``prefill_capture``: admissions of
                all four slots, then of two re-admitted ones (paged: one a
                prefix hit), and decode steps with commits, captured
                against eager: every admitted slot's logits and hidden,
                every cache tensor and the slot lengths bitwise, launches
                per call equal; a product over the group's token rows
                against the same rows of the product over the grid's
                (printed: whether the card's GEMM rounds by row count);
                for stablelm_3b and falcon_mamba_7b the
                single-request ``greedy_generate`` and ``peek_step`` /
                ``commit`` / ``decode_step`` captured against eager
                (streams equal, logits and cache bitwise); and per bucket
                the eager and replayed prefill ms, the graphs captured
                and capture seconds, the scratch cache's bytes and the
                memory the prefill graphs add.  Then
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
                rounding into logits that part wholesale), the streams
                against the first 4 requests' greedy_generate.
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
                near-tie of the selection (printed in bf16 for the first
                4 requests, held in f32 for all 8);
                the full-size forward kernel-vs-plain.  The diffusion runs
                repeat in float32 (wedlm at full size, 33 GB; llada at
                full width and 4 of its 20 layers, printed as a cut)
                through the plain versions (the kernels take bf16 only;
                llada's MoE FFN there the block-aligned product, an f32
                CUDA tensor's route), where the solo comparison and the
                K/V check are held; each prints its tok/s.
                Every run prints its forwards, positions per forward,
                budget range and tok/s, and a profile of its steady steps
                its device-idle share.  Each model's paged greedy run (for
                falcon its bf16 dense greedy) is repeated eagerly
                (``capture=False``) in the same call: streams identical,
                tok/s and the profiled idle share printed side by side.
                Then five more attention-only models, seeded random bf16
                weights: minicpm3_4b (MLA, full width and 16 of its 62
                layers; no decode-attention kernel runs, so its launch
                counts are 0) as stablelm_3b without the dense
                speculative run; mixtral_8x22b (sliding window 4096, MoE
                E 8 top-2) at full width and 8 of its 56 layers, the same
                runs, then past its window: 2 slots of 4608 positions
                serve 3 requests of 4352-token prompts (a 4096-token
                shared prefix) paged and dense, a kernel-vs-plain forward
                there with the device tile count equal to slack_report's
                and below the grid, and the ring buffer
                (``init_cache(swa_ring=True)``, 4224 slots) against the
                full cache over decode blocks of 1-16 positions across
                its seam; starcoder2_3b, phi3_medium_14b and
                phi3_vision_4p2b at full size, lighter: the capture
                check, paged and dense greedy with their stream
                comparison and the forward check.  Then zamba2_1p2b
                (Mamba2, no kernel; a shared attention + MLP block in 6 of
                its 38 layers, through the decode-attention kernel) at
                full size as falcon_mamba_7b: the capture check, dense
                greedy in bf16 (captured and eager; streams against the
                solo greedy_generate printed only) and in float32 through
                the plain versions (the kernel takes bf16 only; streams
                held), the bf16 forward held kernel vs plain, launches =
                6 hybrid layers x decode-shape forwards and no scan, one
                captured step against its weight bound beside its Mamba2
                recurrence alone, and its calibration.  Then whisper_tiny
                (encoder-decoder; no engine path passes its frame
                embeddings, as in the reference) at full size over 1500
                seeded stub frames: the train forward, prefill + decode
                at n = 1 and 16 kernel vs plain and against the train
                forward, and a decode forward's time beside the encoder's
                and the cross K/V projections' it recomputes.  Each phase
                prints its device memory peak.
                Each model but the three lighter ones and whisper_tiny
                then takes its NFP
                calibration on the card:
                ``calibrate_engine`` (wall clock, CUDA events, the
                captured step) on a dense 4-slot engine of 1024 positions
                over ``width_grid(128)`` at buckets 64, 256 and 896 (2
                warm-up forwards and 2 rounds of 5 a width), its
                launches exactly layers x forwards: per bucket the measured
                N_max beside the analytic budget, its limiting term, n_idle,
                the noise and both over-prediction ratios, and the
                seconds each width's capture took.
  6. cli      — through ``repro_torch.launch.serve``: the pinned trace
                replay (``loadgen.PINNED_STACK``, full-width stablelm_3b)
                on the simulated H100 clock, then on the wall clock,
                writing <out>/BENCH_serving_h100.json (TTFT, ITL,
                goodput per SLO class), read back and checked; then
                wedlm8b_like and granite_moe_3b_a800m served speculative
                with ``--calibration run`` and then ``load`` (applied and
                analytic mean budgets, latency ratios); full-width
                zamba2_1p2b dense greedy.  A summary of
                eager vs captured tok/s, idle shares and the calibration
                table and the memory peaks follow.
  7. train    — the training path (``repro_torch.training``; it reaches no
                kernel, as the reference's reaches no Pallas kernel: every
                launch count must stay 0).  (a) stablelm_3b at full width
                and 2 of its 32 layers in float32 (TF32 off), batch 2 x 64:
                ``loss_fn`` and every gradient leaf on the card against the
                same port code on the CPU (loss relative error <= 1e-4,
                each leaf normwise <= 1e-3), and on the card remat True and
                0.5 against False and n_micro 2 against 1 (normwise <=
                1e-4).  (b) full-size stablelm_3b (32 layers, 2.8e9
                parameters, bf16 weights, f32 AdamW state): 20 train_steps
                at global batch 8 x 256, n_micro 2, remat True, lr 3e-4,
                warmup 4, on SyntheticLM seed 0; every loss finite and the
                mean of the last 5 below the first; prints the loss curve,
                the median step time over steps 3-20 (each ending in a
                synchronize), tokens/s, the model-FLOP share (6 N T over
                the step over 989e12, remat's extra 2 N T beside it), the
                gradient and optimizer parts of a step, steps with remat
                False, and the memory peaks.  Then ``train_capture``: the
                same 20 steps from the same seed and batches through
                ``training.capture.compiled_train_step`` (the first call
                eager, then its CUDA graph, then 19 replays): per-step
                losses and gradient norms bitwise the eager run's (else
                within the gap of an eager run again); the captured step
                time, tokens/s and model-FLOP share beside the eager
                ones, the first call's eager and capture seconds, memory
                reserved with the graph pool, one replay under the
                profiler; then the captured remat-False step.  Then
                granite_moe_3b_a800m at full width and 8 of its 32 layers
                (batch 4 x 256, n_micro 1, remat True): 4 eager steps and
                4 captured, each from seed 0: losses, norms and final
                params bitwise the eager run's (else within the gap of an
                eager run again).  (c)
                the train CLI (``repro_torch.launch.train``): tiny
                stablelm_3b, 50 steps at lr 1e-2 (last loss < 0.85 x the
                first), then --steps 60 on the same directory (resumes at
                50), and the final checkpoint restored bitwise equal to the
                state in memory; captured (the default) and again with
                ``--no-capture``: bitwise the same losses and checkpoint.
  7b. serve_ckpt — (b)'s captured run's trained full-size stablelm_3b
                params (the AdamW
                state freed) written by ``checkpoint.save`` (5.6 GB) and
                served through ``repro_torch.launch.serve --ckpt-dir``:
                8 requests of 48-token prompts x 32 tokens, 4 slots, paged
                greedy on the captured step.  Held: the served params
                bitwise the trained ones; each request's first token the
                argmax of one eager prefill of the trained params on its
                prompt (a top-2 gap <= GAP_TOL excepted); paged-attention
                launches = 32 layers x (decode forwards + prefix-hit
                forwards), no other kernel.  Prints the save and restore
                seconds and tok/s, then deletes the checkpoint.  Then the
                train CLI's tiny checkpoint (params and AdamW state)
                served with ``--algorithm greedy --batch 2``: 2 rows x 32
                tokens, dense launches = layers x 31 decode forwards.
  7c. examples — the four ``repro_torch.examples`` drivers in-process on
                the card: ``nfp_survey`` (its H100 rows equal
                ``predict_model`` on ``core.hardware.H100``);
                ``quickstart`` (MoE launches = 2 layers x 2 forwards on
                reduced llada_mini_like, whose MoE shape the kernel phase
                holds elementwise; its decode logits, under the kernel
                run's routing, held normwise within 1e-1 against the same
                engine with the kernels' plain versions swapped in on the
                card and against ``use_kernel=False``, the XLA path with h
                rounded to bf16); ``serve_parallel_decode`` (speculative
                lossless against AR, dense attention launches > 0, each
                mode's tokens per forward and wall time); ``train_lm`` at
                its 100M config (75.5e6 parameters), 40 steps with
                checkpoints at 20 and 40, then --steps 60 on the same
                directory: resumes at 40, runs 20, the last loss below the
                first; the median synchronized step (a graph replay) and
                tokens/s, beside 8 ``--no-capture`` steps' median.
  8. dist     — sharded execution on a one-rank NCCL group
                (``tcp://127.0.0.1:<free port>``).  (a) ``dist.ep_moe_ffn``
                (dispatch, batched expert products, combine, two
                all_to_all_single exchanges) at granite_moe_3b_a800m's FFN
                (E 40, top-8, d 1536, f 512) and mixtral_8x22b's (E 8,
                top-2, d 6144, f 16384), swiglu, bf16, T = 4 and 256, at
                capacity factor E/k (no drops), normwise: against the plain
                ``moe_ffn`` (h rounded to bf16, as ep's) within 2^-8 and
                against ``moe_ffn(..., use_kernel=True)`` (the CUDA MoE
                kernel, h in f32) within 2^-7; at capacity factor 0.25:
                finite, its dropped pairs equal to a host recount; both
                paths timed.  (b) the dry run's ``decode_cell`` for
                full-size stablelm_3b at b 8, s 4096 on a 1 x 1 mesh: its
                args materialised on the card raise the caching allocator's
                requested bytes by exactly the cell's per-device
                ``argument_bytes``, and ``torch.cuda.memory_allocated()`` by
                them within its rounding (512 bytes, and at most 1 MiB a
                leaf left unsplit in a large block).  (c) the
                sharded train step (``dist.sharded_train``, policy fsdp)
                against the unsharded ``train_step``: full-size
                stablelm_3b, 3 steps at 8 x 256, n_micro 2, remat True,
                the same seed, batches and AdamWConfig: losses, final
                params and f32 master bitwise equal; step times printed.
  9. tp       — the aligned-rows entry ``decode_attention`` (every row at
                ``total_len - n``: the dense kernel) at stablelm_3b's
                serving shapes, n 1 and 16, against
                ``decode_attention_ref``; its two launches are a run of the
                kernels line.  Then tensor-parallel training
                (``dist.tensor_parallel``): full-width stablelm_3b cut to 4
                of its 32 layers, the one-process ``train_step`` for 3
                steps at 8 x 256, n_micro 2, remat True, bf16 params, then
                the same steps from the same seed and batches by two ranks
                of a (data 1, model 2) mesh, each a process of its own on
                the one card, gloo over CUDA tensors (NCCL takes one rank
                per device): each rank computes its 16 of the 32 heads,
                its half of ``d_ff`` and of the vocabulary.  Held: the
                first loss within 2e-3 and grad norm within 1e-2 relative
                of the one process's, each rank's gathered params (what
                its forward reads) at most 55 % of the one process's, the
                phase within 60 s; printed: losses, grad norms, step
                times, memory peaks, the largest difference of the final
                params.  Then ``fsdp``: the same steps from the same
                seed and batches by two ranks of a (data 2, model 1) mesh,
                each storing half of every param and AdamW leaf and
                gathering each layer's params as it runs
                (``dist.layer_gather``; gradients reduce-scattered back to
                the shards), held against the same one-process run: first
                loss within 2e-3, grad norm within 1e-2, each rank's
                high-water mark of stored plus gathered param bytes at most
                its shard + the leaves outside the layers + twice the
                largest layer's gathered bytes; printed: step times,
                collectives, memory peaks.  No kernel launches in
                training.  With it, ``fsdp_decode`` (its two ranks run at
                the same time as fsdp's, four processes): full-width
                falcon_mamba_7b cut to 4 of its 64 layers, f32, a prefill
                of 4 rows x 48 tokens and 8 one-position decode forwards
                on the kernels, by one process and by two ranks of a
                (data 2, model 1) mesh on 2 rows each, params stored
                halved and gathered per layer: each rank's logits within
                1e-4 (normwise) of its rows of the one process's, (8 + 1)
                x 4 scan launches a rank (added to the kernels line); the
                two runs within 150 s (gloo carries ~1 GB/s a rank pair
                of their gathers through the host).
  10. report  — one JSON line of kernels (launches summed over every run
                above), the command time, the card line, and the final
                {"ok": true, ...} line.
"""
from __future__ import annotations

import argparse
import contextlib
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
# the same rule at mixtral_8x22b's width (d 6144, f 16384), where outputs
# reach an rms of ~2e4: an output is a sum of f = 16384 terms of magnitude
# ~1e2 (each a product of a sum over d = 6144), so a near-zero output
# moves with those sums' rounding (tensor-core f32 accumulation, h carried
# as hi + lo to 2^-16), which scales with the terms and the rows' rms, not
# with the output itself.  MOE_ATOL is that absolute term at granite's
# width (outputs of rms ~1.4e2, moving by ~1e-3); at mixtral's it is
# 2^-10 of the rows' rms, and the kernel is also held against the same
# FFN computed in float64
MOE_WIDE_ATOL_RMS = 2.0 ** -10
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
MIXTRAL_MOE = (8, 2, 6144, 16384)
LLADA_TINY_MOE = (16, 2, 64, 32)        # the reduced config's
# falcon_mamba_7b's scan: (d_inner, d_state)
FALCON_SCAN = (8192, 16)
# decode-attention geometries (h, kv, dh) of mixtral_8x22b, starcoder2_3b,
# phi3_medium_14b, phi3_vision_4p2b, zamba2_1p2b and whisper_tiny: GQA
# g = 6 (96 rows at n = 16), g = 12 (192 rows: three 64-row passes), g = 4
# at 40 heads, MHA at dh 96, and MHA at dh 64 with 32 heads (zamba2's
# shared attention) and with 6 (whisper's decoder: 24 blocks at 4 slots)
NEW_GEOMETRIES = {"mixtral_8x22b": (48, 8, 128),
                  "starcoder2_3b": (24, 2, 128),
                  "phi3_medium_14b": (40, 10, 128),
                  "phi3_vision_4p2b": (32, 32, 96),
                  "zamba2_1p2b": (32, 32, 64),
                  "whisper_tiny": (6, 6, 64)}
# the reduced configs' geometries, which the examples serve on the card
REDUCED_GEOMETRIES = {"stablelm_3b": (4, 4, 16), "llada_mini_like": (4, 2, 16)}
# mixtral_8x22b's sliding window and its long-context runs: 4352-token
# prompts (256 positions past the window) in a 4608-position cache
MIXTRAL_WINDOW = 4096
LONG_MAX_LEN = 4608
# the serving cells' decode attention: (traffic file, (h, kv, dh)) per
# cell, rows at the cell's stationary lengths in tables of the cells'
# max_len (2560 positions)
CELL_ATTENTION = {
    "stablelm_3b.long_answer_c16": ("long_answer_c16", (32, 32, 80)),
    "stablelm_3b.long_prompt_c16": ("long_prompt_c16", (32, 32, 80)),
    "granite_moe_3b_a800m.long_answer_c40": ("long_answer_c40", (24, 8, 64)),
}
CELL_MAX_LEN = 2560
LONG_PROMPT = 4352
# mixtral_8x22b runs at full width and this depth (8 of its 56 layers:
# 2.0e10 parameters, 41 GB in bf16; the full depth needs ~281 GB)
MIXTRAL_LAYERS = 8
# minicpm3_4b runs at full width and this depth (16 of its 62 layers):
# at full depth its phase took ~100 s of the script's 1200
MINICPM3_LAYERS = 16
# captured vs eager decode_slots: the widths held bitwise equal
CAPTURE_WIDTHS = (1, 5, 16, 17)
# the calibration engines: 4 slots, a dense cache of this length (buckets
# 64, 256 and 896 under width_grid(128))
CALIB_MAX_LEN = 1024
# where the scorecard and calibration tables go (``--out``)
OUT = ROOT / "build" / "chip_smoke"
# run name -> (tok/s, forwards, seconds) and profile label -> idle %, for
# the summary; calibration rows by model; device memory peak (GB) by phase
SPEEDS = []
IDLE = {}
CALIBRATION = {}
MEMORY = {}
# a Mamba2 model's captured step against its weight bound and its
# recurrence's share, and whisper's decode forward beside its re-encoding
MAMBA2 = {}
WHISPER = {}


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


def graph_ms(fn, flush) -> float:
    """``time_ms`` of ``fn`` captured into a CUDA graph of its own (one
    eager call on a side stream first) and replayed: device time without
    the host's launch gaps, for work of thousands of small operations."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush)


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
        tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
        if paged:
            out = ops.decode_attention_paged(q, k, v, lens_t, bt,
                                             window=window, tiles=tiles)
            span = ops.paged_launch_args(q.shape, k.shape, bt.shape,
                                         window)[8]
            ref = ops.decode_attention_paged_ref(q, k, v, lens_t, bt,
                                                 window=window)
        else:
            out = ops.decode_attention_ragged(q, k, v, lens_t, window=window,
                                              tiles=tiles)
            ref = ops.decode_attention_ref(q, k, v, lens_t, window=window)
            span = ops.dense_launch_args(q.shape, k.shape, window)[8]
        rep = ops.slack_report(n, lens, max_len, head_dim=dh,
                               k_block=16 if paged else ops.K_BLOCK,
                               window=window, span=span)
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
        want = [kv * rep["kv_tiles_executed"], kv * rep["kv_spans_executed"]]
        if [int(x) for x in tiles] != want:
            raise AssertionError(f"{where}: kernel ran {tiles.tolist()} kv "
                                 f"tiles and spans, slack_report says "
                                 f"{want}")
        cases += 1
        return rep

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
    # the geometries of NEW_GEOMETRIES (mixtral's to whisper's), at an
    # empty, a short, a long and a full row, one m-tile and two
    for h, kv, dh in NEW_GEOMETRIES.values():
        for paged in (False, True):
            for n in (1, 16, 17):
                for window in (None, 48):
                    run(paged, n, h, kv, dh, [0, 37, 150, MAX_LEN - n],
                        window, "fragmented" if paged else "")
    # the reduced geometries the examples serve on the card (dh 16):
    # verify blocks of 9, diffusion blocks of 13, quickstart's N = 16
    for h, kv, dh in REDUCED_GEOMETRIES.values():
        for paged in (False, True):
            for n in (1, 9, 13, 16, 17):
                run(paged, n, h, kv, dh, [0, 8, 37, MAX_LEN - n], None,
                    "fragmented" if paged else "")
    # the serving cells' geometries at their stationary lengths in
    # 2560-position tables, rows cut into spans; the dense mode beside
    for cell, (traffic, (h, kv, dh)) in CELL_ATTENTION.items():
        lens = cell_lengths(traffic)
        lens[0] = CELL_MAX_LEN - 1
        for window in (None, 1000):
            run(True, 1, h, kv, dh, lens, window, "fragmented", CELL_MAX_LEN)
        run(False, 1, h, kv, dh, lens[:8], None, max_len=CELL_MAX_LEN)
    # mixtral's window of 4096 past the window, in a 4608-position cache:
    # the skip rule's lower bound drops the first tiles (at 4352, 2 dense
    # tiles or 16 pages), so fewer tiles run than the grid holds
    h, kv, dh = NEW_GEOMETRIES["mixtral_8x22b"]
    for paged in (False, True):
        for n in (1, 16, 17):
            lens = [4095, 4096, 4097, 4352, min(4600, LONG_MAX_LEN - n)]
            rep = run(paged, n, h, kv, dh, lens, MIXTRAL_WINDOW,
                      "fragmented" if paged else "", LONG_MAX_LEN)
            if rep["kv_tiles_executed"] >= rep["kv_tiles_grid"]:
                raise AssertionError(f"window {MIXTRAL_WINDOW} at {lens}: "
                                     "no kv tile skipped")
    print(f"kernels: {cases} decode-attention cases agree with the plain "
          f"version within atol={KERNEL_ATOL} rtol={KERNEL_RTOL} (bf16); "
          f"executed kv tiles == slack_report; max abs err "
          f"dense={err['dense']:.4g} paged={err['paged']:.4g}")
    return err


def kernel_bound_ms(lens, n, h, kv, dh, paged, max_len=MAX_LEN) -> tuple:
    """Least time for one call: K/V of the visible positions, q, o, lens
    (and the block table) each moved once, against the score and P·V
    multiply-adds at the bf16 tensor rate.  Returns (ms, 'bytes'|'operations')."""
    b = len(lens)
    visible = sum(ln + n for ln in lens)
    bytes_ = (2 * kv * dh * 2 * visible + 2 * b * n * h * dh * 2 + 4 * b
              + (4 * b * max_len // 16 if paged else 0))
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


def cell_lengths(traffic: str) -> list:
    """A serving cell's stationary row lengths: each client's prompt (the
    ``bench.loadgen.length_set`` of the cell's traffic file) plus a share
    of an answer of the same set, the shares the midpoints of equal
    strata, prompts, answers and shares paired by fixed permutations."""
    from bench.loadgen import length_set
    spec = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json")
                      .read_text())
    c = spec["clients"]
    prompts = length_set(spec["prompt_len"], c)
    answers = length_set(spec["output_len"], c)
    rng = np.random.default_rng(0)
    shares = rng.permutation((np.arange(c) + 0.5) / c)
    answers = answers[rng.permutation(c)]
    return [int(p + np.floor(f * a)) for p, f, a in zip(prompts, shares,
                                                         answers)]


def time_cell_kernels(ops) -> dict:
    """The paged kernel at n = 1 over each serving cell's rows at their
    stationary lengths (``cell_lengths``, 160-page tables), against the
    bytes' bound; the longest row's share of the mean beside it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for cell, (traffic, (h, kv, dh)) in CELL_ATTENTION.items():
        lens = cell_lengths(traffic)
        q, k, v, lens_t, bt = kernel_inputs(
            paged=True, n=1, h=h, kv=kv, dh=dh, lens=lens,
            layout="fragmented", seed=11, max_len=CELL_MAX_LEN)
        ms = time_ms(lambda: ops.decode_attention_paged(q, k, v, lens_t, bt),
                     flush)
        bound, by = kernel_bound_ms(lens, 1, h, kv, dh, True, CELL_MAX_LEN)
        span = ops.paged_launch_args(q.shape, k.shape, bt.shape, None)[8]
        rep = ops.slack_report(1, lens, CELL_MAX_LEN, head_dim=dh,
                               k_block=16, span=span)
        out[cell] = {"rows": len(lens), "mean_len": float(np.mean(lens)),
                     "max_len": max(lens), "ms": ms, "bound_ms": bound,
                     "bound_by": by, "span": span,
                     "rows_split": rep["rows_split"],
                     "spans": rep["kv_spans_executed"] * kv}
        del q, k, v, bt
        torch.cuda.empty_cache()
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


def moe_exact(w, a):
    """The swiglu grouped FFN of ``a``'s valid blocks in float64, expert
    by expert: the exact answer both the kernel and its plain version
    approximate."""
    F = torch.nn.functional
    tb, x = a["tb"], a["x_pad"].double()
    out = torch.zeros_like(x)
    blocks = list(zip(a["be"].tolist(), a["bv"].tolist()))
    for e in sorted({b for b, v in blocks if v}):
        rows = torch.cat([torch.arange(i * tb, (i + 1) * tb)
                          for i, (b, v) in enumerate(blocks)
                          if v and b == e]).cuda()
        xe = x[rows]
        h = (F.silu(xe @ w["w_gate"][e].double())
             * (xe @ w["w_up"][e].double()))
        out[rows] = h @ w["w_down"][e].double()
    return out


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
    # llada_mini_like reduced (E 16, top-2, d 64, f 32: one partial
    # column slice in each phase, a reduction shorter than a stage):
    # quickstart's prefill of 8 tokens and its decode forward of 16
    tiny = moe_weights(LLADA_TINY_MOE[0], LLADA_TINY_MOE[2],
                       LLADA_TINY_MOE[3], seed=11)
    for t in (8, 16):
        cases.append(("llada_mini_like reduced", tiny, LLADA_TINY_MOE[1], t,
                      "router"))
    # mixtral_8x22b: E 8 top-2 at d 6144, f 16384 (32 f tiles), decode
    # (4 slots) and prefill
    mixtral = moe_weights(MIXTRAL_MOE[0], MIXTRAL_MOE[2], MIXTRAL_MOE[3],
                          seed=9)
    for t in (4, 256):
        cases.append(("mixtral_8x22b", mixtral, MIXTRAL_MOE[1], t, "router"))
    err = 0.0
    for i, (name, w, k, t, routing) in enumerate(cases):
        a = moe_inputs(moe_ops, moe, w, k=k, t=t, routing=routing, seed=i)
        blocks = torch.zeros(1, dtype=torch.int32, device="cuda")
        out = moe_call(moe_ops, w, a, blocks=blocks)[a["slot"]]
        ref = moe_call(moe_ops, w, a, plain=True)[a["slot"]]
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        where = f"moe {name} T={t} {routing} token_block={a['tb']}"
        atol = MOE_ATOL
        if name == "mixtral_8x22b":
            rms = float(ref.float().pow(2).mean().sqrt())
            atol = MOE_WIDE_ATOL_RMS * rms
            exact = moe_exact(w, a)[a["slot"]]
            to_exact = (out.double() - exact).abs()
            plain_exact = float((ref.double() - exact).abs().max())
            print(f"  {where}: rows' rms {rms:.4g}, atol {atol:.4g}; max "
                  f"abs err against the plain version {float(diff.max()):.4g}"
                  f", against float64 {float(to_exact.max()):.4g} (the plain "
                  f"version's {plain_exact:.4g})")
            if (to_exact > atol + MOE_RTOL * exact.abs()).any():
                raise AssertionError(f"MoE kernel leaves the float64 FFN: "
                                     f"{where}")
        bad = diff > atol + MOE_RTOL * ref.float().abs()
        err = max(err, float(diff.max()))
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
          f"version within atol={MOE_ATOL} (mixtral's width: "
          f"{MOE_WIDE_ATOL_RMS:.4g} x the rows' rms) rtol={MOE_RTOL:.4g} "
          f"(bf16); "
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
# mixtral_8x22b's decode (4 slots x 1 token) and a prefill
MIXTRAL_TIMES = (("decode_router", 4, "router"),
                 ("prefill_router", 256, "router"))


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
    the entries the active hooks append while a key's graph is CAPTURED
    (device tensors the graph rewrites on every replay) are kept per
    key, and every replay of it appends clones of them, as an eager
    forward appends fresh ones; the capture's warm-up forward appends the
    same number first, which are dropped."""
    graphs = eng.graphs
    inner_capture, inner_run = graphs.capture, graphs.run
    kept = {}

    def clone(x):
        return tuple(t.clone() for t in x) if isinstance(x, tuple) \
            else x.clone()

    def capture(key, forward, inputs):
        if key in graphs.steps:
            return inner_capture(key, forward, inputs)
        sinks = [get() for get in ROUTE_SINKS]
        marks = [len(sink) for sink in sinks]
        step = inner_capture(key, forward, inputs)
        kept[key] = []
        for sink, mark in zip(sinks, marks):
            new = sink[mark:]
            del sink[mark:]
            kept[key].append(new[len(new) // 2:])
        return step

    def run(key, forward, inputs):
        out = inner_run(key, forward, inputs)
        for get, entries in zip(ROUTE_SINKS, kept[key]):
            get().extend(clone(x) for x in entries)
        return out
    graphs.capture, graphs.run = capture, run


class RouteRecorder:
    """While a run serves, wraps the port's ``route_topk`` and the engine's
    three forward entries — ``decode_slots`` (decode and verify forwards,
    captured or not), ``_suffix_forward`` (the prefix-hit suffix
    forward) and ``_prefill_graph`` (prompt prefill over the (batch,
    width) grid, of whose rows the group's are kept) — to keep,
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
        self.inner = self.mod.route_topk       # whatever wraps it already

        def route(router_w, x, k):
            weights, idx, probs = self.inner(router_w, x, k)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.append((torch.sort(idx, dim=-1).values,
                               torch.log(top[:, k - 1] / top[:, k])))
            return weights, idx, probs
        eng, loop = self.loop.engine, self.loop
        inner_decode = eng.decode_slots
        inner_suffix, inner_graph = eng._suffix_forward, eng._prefill_graph
        inner_admit = loop.admit

        def decode_slots(tokens):
            offsets = eng.slot_lens_host.copy()
            self.calls.clear()
            out = inner_decode(tokens)
            self._add(list(range(tokens.shape[0])), offsets, tokens.shape[1])
            return out

        def suffix_forward(tokens):
            offsets = eng.slot_lens_host.copy()
            self.calls.clear()
            out = inner_suffix(tokens)
            self._add(list(range(tokens.shape[0])), offsets, tokens.shape[1])
            return out

        def prefill_graph(toks, width):
            self.calls.clear()
            out = inner_graph(toks, width)
            rows = list(range(eng.batch))
            self._add(rows, dict.fromkeys(rows, 0), width, only=sorted(toks))
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
        self.saved = (inner_decode, inner_suffix, inner_graph, inner_admit)
        self.mod.route_topk = route
        eng.decode_slots = decode_slots
        eng._suffix_forward, eng._prefill_graph = suffix_forward, prefill_graph
        loop.admit = admit
        ROUTE_SINKS.append(self._sink)
        return self

    def _sink(self):
        return self.calls

    def __exit__(self, *exc):
        ROUTE_SINKS.remove(self._sink)
        self.mod.route_topk = self.inner
        eng = self.loop.engine
        (eng.decode_slots, eng._suffix_forward, eng._prefill_graph,
         self.loop.admit) = self.saved

    def _add(self, slots, offsets, n, only=None):
        """Keep the routing of a forward over rows ``slots`` (of ``only``
        among them where given)."""
        calls, self.calls = self.calls, []
        if not calls:
            return
        layers, rows = len(calls), len(slots)
        route = (torch.stack([c[0] for c in calls]).reshape(layers, rows, n,
                                                            -1),
                 torch.stack([c[1] for c in calls]).reshape(layers, rows, n))
        if only is not None:
            pick = [slots.index(s) for s in only]
            route, slots = (route[0][:, pick], route[1][:, pick]), only
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


def attn_kernel(cfg) -> bool:
    """Whether the model's decode attention runs the kernel: GQA and
    sliding-window GQA do; MLA (plain torch, as the reference's XLA path)
    and attention-free models do not."""
    return cfg.attention is not None and cfg.attention.kind != "mla"


def kernel_layers(cfg) -> dict:
    """The layers of one forward that launch each kernel: decode
    attention (decode-shaped forwards only) in every GQA / SWA attention
    layer and every hybrid layer's shared attention; the MoE FFN in every
    MoE layer; the selective scan in every Mamba1 layer.  Mamba2 has no
    kernel."""
    from repro_torch.core.arch import LAYER_ATTN, LAYER_HYBRID, LAYER_SSM
    attn = cfg.count_layers(LAYER_ATTN)
    hybrid = cfg.count_layers(LAYER_HYBRID)
    mamba1 = cfg.ssm is not None and cfg.ssm.kind == "mamba1"
    return {"attn": attn + hybrid if attn_kernel(cfg) else 0,
            "moe": attn if cfg.ffn.kind == "moe" else 0,
            "scan": cfg.count_layers(LAYER_SSM) + hybrid if mamba1 else 0}


def serve_run(mods, cfg, params, prompts, *, block_size, mode, card,
              loop_kw=None, prepare=None, use_kernel=True, capture=True,
              batch=4, max_len=MAX_LEN, label=""):
    """Serve ``prompts`` x 32 tokens on a ``batch``-slot engine of
    ``max_len`` positions (paged with ``block_size``) in ``mode``
    (``loop_kw``: the ServingLoop's mode
    arguments), counting every kernel's launches from 0; ``prepare(loop)``
    attaches further recorders before the run; ``use_kernel`` False runs
    the plain versions (and expects no launch); ``capture`` False runs the
    same forwards eagerly instead of replaying CUDA graphs.  The prompts'
    prefill graphs are captured before the clock starts.  Records the
    run's tok/s in ``SPEEDS``.  Returns (streams, launches, top-2 gap
    record, routing record)."""
    DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe, scan_ops = \
        mods[:7]
    gc.collect()                  # loops of earlier runs hold their caches
    paged = PagedKVConfig(block_size=block_size) if block_size else None
    eng = DecodeEngine(cfg, params, batch=batch, max_len=max_len,
                       paged=paged, device="cuda", use_kernel=use_kernel,
                       capture=capture)
    if capture:
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
            # the prefill graphs of the prompts' buckets (an SSM model:
            # lengths) are captured before the clock, decode widths at
            # their first use
            eng.warm_prefill(sorted({len(p) if eng.recurrent
                                     else eng.prefill_bucket(len(p))
                                     for p in prompts}))
            torch.cuda.synchronize()
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
    name = (f"{cfg.name}{' f32' if f32 else ''}{label} "
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
    per = kernel_layers(cfg)
    attn = per["attn"] * shaped
    want = {"dense": 0 if block_size else attn,
            "paged": attn if block_size else 0,
            "moe": per["moe"] * every, "scan": per["scan"] * every}
    if not use_kernel:
        want = dict.fromkeys(want, 0)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{want} (layers {per}; attention x {shaped} "
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
    from repro_torch.models.transformer import has_ssm
    DecodeEngine, PagedKVConfig = mods[:2]
    moe = mods[5]
    pools = ((None,) if has_ssm(cfg)
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
    from repro_torch.models.transformer import has_ssm
    from repro_torch.serving.capture import launch_counts
    DecodeEngine, PagedKVConfig = mods[:2]
    pools = ((None,) if has_ssm(cfg)
             else (None, PagedKVConfig(block_size=16)))
    # an MLA model with a dense FFN reaches no kernel: every count is 0
    kernels = sum(kernel_layers(cfg).values()) > 0
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
                torch.equal(a, b) for a, b in zip(_leaves(engs[0].cache),
                                                  _leaves(engs[1].cache)))
            ok = (torch.equal(outs[0][0], outs[1][0])
                  and torch.equal(outs[0][1], outs[1][1]) and same_cache
                  and all(c == counts[0] for c in counts)
                  and (sum(counts[0].values()) > 0) == kernels)
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


PREFILL = {}                 # model -> the prefill_capture phase's numbers
#: the prefill buckets timed eager vs replayed (an SSM model: lengths)
PREFILL_TIMED = (16, 64, 256)
PREFILL_TIMED_SSM = (16, 48)
#: single-request tokens in prefill_capture's greedy_generate comparison
SINGLE_TOKENS = 16


def _engine_state(eng) -> list:
    """Every cache tensor and the slot lengths, cloned."""
    return ([t.clone() for t in _leaves(eng.cache)]
            + [eng.slot_lens.clone(), torch.as_tensor(eng.slot_lens_host)])


def _bitwise(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(a, b)) and len(a) == len(b)


def _prefill_ms(eng, prompts, slots, iters=3) -> float:
    """Median host ms of ``prefill_slots`` of ``prompts`` into ``slots``
    (each released first), synchronized."""
    out = []
    for _ in range(iters):
        for s in slots:
            eng.release_slot(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_slots(dict(zip(slots, prompts)))
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def prefill_capture(mods, cfg, params, prompts, card, pools=("dense",),
                    single=False) -> None:
    """The captured prefill against eager at full size, on the engine's
    admissions: a captured engine (every forward a graph replay) beside
    a ``capture=False`` one (the same forwards, the (batch, width) grid,
    row flags and scratch included, launched eagerly), on the same
    weights.  Admissions: all four slots at once
    (attention models: one bucket-64 group; SSM models: exact-length
    groups 40 and 48), then slots 1 and 3 released and re-admitted with
    other prompts (the paged engine: slot 1's prompt shares 32 tokens,
    two pages, with slot 0's, so it runs the prefix-hit suffix forward;
    an SSM model: lengths 40 and 33), then decode steps with commits.
    After every call, held bitwise against eager: each admitted slot's
    (logits, hidden), every cache tensor and the slot lengths (the decode
    steps' logits and hidden too), and the launches per call equal.
    Printed, not held: ``row_count_witness`` of the first admission's
    first group.  With ``single``:
    batch-1 ``greedy_generate`` of ``SINGLE_TOKENS`` tokens and a
    ``peek_step`` / ``commit`` / ``decode_step`` sequence, captured
    against eager: streams equal, logits and cache bitwise.  Prints per
    bucket the eager and the replayed prefill ms (median of 3), the
    graphs captured and seconds spent capturing, the scratch cache's
    bytes, and the memory peak with the decode graphs alone and with the
    prefill graphs.  Every launch made here is taken back out of the
    counts (``Uncounted``)."""
    from repro_torch.models.transformer import has_ssm
    from repro_torch.serving.capture import launch_counts
    DecodeEngine, PagedKVConfig = mods[:2]
    t_phase = time.perf_counter()
    recurrent = has_ssm(cfg)
    rng = np.random.default_rng(11)
    if recurrent:
        first = {s: prompts[s][:(48, 40)[s % 2]] for s in range(4)}
        second = {1: prompts[5][:40], 3: prompts[4][:33]}
    else:
        first = {s: prompts[s] for s in range(4)}
        second = {1: prompts[5], 3: prompts[4]}
    failed = []
    for pool in pools:
        gc.collect()
        paged = PagedKVConfig(block_size=16) if pool == "paged" else None
        engs = [DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                             paged=paged, device="cuda", capture=c)
                for c in (True, False)]

        def call(what, fn):
            outs, counts = [], []
            for eng in engs:
                before = launch_counts()
                with Uncounted(mods):
                    out = fn(eng)
                    torch.cuda.synchronize()
                    after = launch_counts()
                counts.append({k: after[k] - before[k] for k in after})
                outs.append((out, _engine_state(eng)))
            res = (_bitwise(outs[0][0], outs[1][0]),
                   _bitwise(outs[0][1], outs[1][1]), counts[0] == counts[1])
            print(f"prefill_capture {cfg.name} {pool} {what}: captured vs "
                  f"eager: outputs bitwise {res[0]}, cache and slot lengths "
                  f"bitwise {res[1]}, launches equal {res[2]} (launches "
                  f"{counts[0]}) [{card}]")
            if not all(res):
                failed.append(f"{pool} {what}: {res}")

        def admit(group):
            def fn(eng):
                got = eng.prefill_slots(group)
                return [t for s in sorted(got) for t in got[s]]
            return fn

        def decode(toks, adv):
            def fn(eng):
                logits, cache, hidden = eng.decode_slots(toks)
                out = [logits.clone(), hidden.clone()]
                eng.commit_slots(cache, adv)
                return out
            return fn
        call("admit slots 0-3", admit(first))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1)),
                               device="cuda")
        call("decode n=1", decode(toks, np.ones(4, np.int64)))
        for eng in engs:
            for s in second:
                eng.release_slot(s)
        call("re-admit slots 1, 3"
             + (" (slot 1 hits 32 cached tokens)" if paged else ""),
             admit(second))
        if paged:
            hits = [e for e in engs[0].prefill_log
                    if e.get("cached_tokens", 0) > 0]
            if len(hits) != 1 or hits[0]["slots"] != [1]:
                raise AssertionError(f"{cfg.name} paged: no prefix hit "
                                     f"{engs[0].prefill_log}")
        for n in (3, 1):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, n)),
                                   device="cuda")
            call(f"decode n={n}", decode(toks, np.array([n, 1, 0, n])))
        del engs
    if single:
        _single_capture(mods, cfg, params, prompts, card)
    with Uncounted(mods):                  # two prompts of one length
        witness = row_count_witness(cfg, params, np.stack(
            [first[0], first[2]]), 48 if recurrent else 64)
    print(f"prefill_capture {cfg.name} row count: {witness} [{card}]")
    if failed:
        raise AssertionError(f"{cfg.name}: the captured forwards leave "
                             f"eager in {failed}")
    # eager vs replayed prefill ms per bucket, and what the graphs cost
    gc.collect()
    torch.cuda.empty_cache()
    widths = PREFILL_TIMED_SSM if recurrent else PREFILL_TIMED
    eager = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                         device="cuda", capture=False)
    captured = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN,
                            device="cuda", capture=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    captured.warm_decode(CAPTURE_WIDTHS)
    torch.cuda.synchronize()
    decode_peak = torch.cuda.max_memory_allocated() - base
    decode_held = torch.cuda.memory_allocated() - base
    captured.warm_prefill(widths)
    torch.cuda.synchronize()
    prefill_peak = torch.cuda.max_memory_allocated() - base
    prefill_held = torch.cuda.memory_allocated() - base
    scratch = sum(t.numel() * t.element_size()
                  for t in _leaves(captured.scratch))
    times = {}
    with Uncounted(mods):
        for w in widths:
            group = [rng.integers(0, cfg.vocab_size, size=w)
                     for _ in range(4)]
            times[w] = tuple(_prefill_ms(e, group, range(4))
                             for e in (eager, captured))
    summary = captured.graphs.summary()
    print(f"prefill_capture {cfg.name}: prefill of 4 slots, eager vs "
          f"replayed ms by {'length' if recurrent else 'bucket'}: "
          + ", ".join(f"{w}: {a:.3f} / {b:.3f}"
                      for w, (a, b) in times.items())
          + f"; graphs captured (count, capture s): "
          + ", ".join(f"{k} {n} ({t:.3f} s)" for k, (n, t) in
                      summary.items())
          + f"; scratch cache {scratch / 1e6:.3f} MB; memory above the "
          f"engine: decode graphs peak {decode_peak / 1e9:.3f} GB (held "
          f"{decode_held / 1e9:.3f}), with the prefill graphs peak "
          f"{prefill_peak / 1e9:.3f} GB (held {prefill_held / 1e9:.3f}); "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    PREFILL[cfg.name] = {"ms": times, "graphs": summary,
                         "scratch_bytes": scratch,
                         "decode_graphs_peak_bytes": decode_peak,
                         "prefill_graphs_peak_bytes": prefill_peak}
    del eager, captured
    gc.collect()
    torch.cuda.empty_cache()


def row_count_witness(cfg, params, group: np.ndarray, width: int,
                      grid_rows=4) -> str:
    """Whether the card's products round by the number of rows they
    cover.  Each (d_in, d_out) projection of the first layer over
    ``group``'s rows x ``width`` token rows against the same rows of its
    product over ``grid_rows`` x ``width``; and the prefill forward of
    ``group`` (prompts of one length, right-padded to ``width``) alone
    against the same rows of the forward over the (grid_rows, width)
    grid, the other rows zeros: the last prompt positions' logits.
    Returns a printable summary (bitwise equal or the largest
    difference)."""
    from repro_torch.models.transformer import forward, init_cache
    table = params["embed"]["table"]
    rows, p = group.shape
    gen = torch.Generator(table.device).manual_seed(5)
    same, mats, gemm_gap = 0, 0, 0.0
    for sub in params["segments"][0].values():
        for w in (sub.values() if isinstance(sub, dict) else ()):
            if w.dim() != 3:
                continue
            x = torch.randn((grid_rows * width, w.shape[1]), generator=gen,
                            device=table.device).to(w.dtype)
            part, whole = x[:rows * width] @ w[0], (x @ w[0])[:rows * width]
            mats += 1
            same += int(torch.equal(part, whole))
            gemm_gap = max(gemm_gap, float((part.float()
                                            - whole.float()).abs().max()))
    last = []
    for n in (rows, grid_rows):
        toks = np.zeros((n, width), np.int64)
        toks[:rows, :p] = group
        cache = init_cache(cfg, n, width, table.dtype, table.device)
        logits = forward(params, cfg,
                         {"tokens": torch.as_tensor(toks, device=table.device)},
                         mode="prefill", cache=cache,
                         use_kernel=table.device.type == "cuda")[0]
        last.append(logits[:rows, p - 1].float())
    gap = float((last[0] - last[1]).abs().max())
    return (f"{same} of {mats} first-layer products over {rows * width} "
            f"token rows bitwise the same rows of the product over "
            f"{grid_rows * width} (largest difference {gemm_gap:.4g}); "
            f"the prefill of {rows} prompts of {p} tokens in a ({rows}, "
            f"{width}) grid vs a ({grid_rows}, {width}) one: logits bitwise "
            f"{gap == 0.0}, largest difference {gap:.4g}")


def _single_capture(mods, cfg, params, prompts, card) -> None:
    """Batch-1 single-request drivers captured against eager: the
    greedy_generate streams equal, then prefill, ``peek_step`` of 5
    positions, ``commit`` (3 of them; an SSM model all 5), ``decode_step``
    of 1: logits (and the prefill's and the peek's hidden) bitwise, then
    the cache bitwise and ``cache_len`` equal."""
    DecodeEngine = mods[0]
    engs = [DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN,
                         device="cuda", capture=c) for c in (True, False)]
    prompt = torch.as_tensor(prompts[0][None], device="cuda")
    with Uncounted(mods):
        streams = [e.greedy_generate(prompt, SINGLE_TOKENS) for e in engs]
        same = torch.equal(streams[0], streams[1])
        draft = torch.as_tensor(prompts[1][None, :5], device="cuda")
        adv = 5 if engs[0].recurrent else 3
        outs = []
        for eng in engs:
            logits = eng.prefill(prompt)
            got = [logits.clone(), eng.last_hidden.clone()]
            logits, cache, hidden = eng.peek_step(draft)
            got += [logits.clone(), hidden.clone()]
            eng.commit(cache, adv)
            got.append(eng.decode_step(draft[:, :1]).clone())
            outs.append((got, [t.clone() for t in _leaves(eng.cache)],
                         eng.cache_len))
        steps = [_bitwise(outs[0][0], outs[1][0]),
                 _bitwise(outs[0][1], outs[1][1]),
                 outs[0][2] == outs[1][2]]
    keys = sorted(engs[0].graphs.steps)
    print(f"prefill_capture {cfg.name} single request (batch 1): "
          f"greedy_generate streams of {SINGLE_TOKENS} equal {same}; "
          f"prefill, peek_step 5, commit {adv}, decode_step 1: logits and "
          f"hidden bitwise {steps[0]}, cache bitwise {steps[1]}, cache_len "
          f"equal {steps[2]}; graphs {keys} [{card}]")
    if not (same and all(steps)):
        raise AssertionError(f"{cfg.name}: the captured single-request "
                             "drivers leave eager")


def calibration_table(mods, cfg, params, card) -> dict:
    """The paper's measurement on the card: ``calibrate_engine`` (wall
    clock: the CAPTURED decode step, CUDA events) on a dense 4-slot
    engine of ``CALIB_MAX_LEN`` positions over ``width_grid(128)`` at the
    buckets it derives (each width's capture timed first), every kernel
    launch of the sweep counted (exactly layers x forwards).  Prints per
    bucket the measured N_max beside the analytic budget, n_idle and the
    limiting term, the noise, both over-prediction ratios and T(N); saves
    the table under ``<out>/calibration/``.  Returns the launches."""
    from repro_torch.autotune import calibrate_engine, save_table
    from repro_torch.autotune.calibrate import width_grid
    DecodeEngine, ops, moe_ops, scan_ops = mods[0], mods[3], mods[4], mods[6]
    gc.collect()
    eng = DecodeEngine(cfg, params, batch=4, max_len=CALIB_MAX_LEN,
                       device="cuda")
    fns = {"dense": ops.decode_attention_ragged,
           "paged": ops.decode_attention_paged,
           "moe": moe_ops.grouped_ffn_padded,
           "scan": scan_ops.selective_scan_padded}
    # the sweep's widths, captured first and timed one by one (a Mamba2
    # model unrolls its per-position loop into the graph: wider, longer)
    captures = {}
    for n in width_grid(min(128, CALIB_MAX_LEN // 2)):
        t0 = time.perf_counter()
        eng.warm_decode([n])
        torch.cuda.synchronize()
        captures[n] = time.perf_counter() - t0
    print(f"calibration {cfg.name}: capture seconds per width " + ", ".join(
        f"{n}: {t:.2f}" for n, t in captures.items())
        + f" (total {sum(captures.values()):.1f} s) [{card}]")
    for fn in fns.values():
        fn.launches = 0
    warmup, rounds, iters = 2, 2, 5
    t0 = time.perf_counter()
    table = calibrate_engine(eng, modes=("greedy",), warmup=warmup,
                             rounds=rounds, iters=iters)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    forwards = sum(len(e.ns) for e in table.entries) * (warmup
                                                        + rounds * iters)
    per = kernel_layers(cfg)
    want = {"dense": per["attn"] * forwards, "paged": 0,
            "moe": per["moe"] * forwards, "scan": per["scan"] * forwards}
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


def model_params(arch, layers=None):
    """The full-width config (cut to ``layers`` where given) and seeded
    random bf16 weights on the card; prints the size."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers}"
          f"{f' of {get_config(arch).n_layers}' if layers else ''} layers, d "
          f"{cfg.d_model}, attention {cfg.attention.kind} "
          f"{cfg.attention.n_heads}/{cfg.attention.n_kv_heads} x "
          f"{cfg.attention.head_dim}, {n_params:.4g} parameters, "
          f"{2 * n_params / 1e9:.4g} GB in bf16")
    return cfg, params


def serve_model(mods, arch, card, forward_rtol,
                dense_speculative=False, layers=None,
                long_context=False, prefill_pools=(),
                prefill_single=False) -> dict:
    """Phase 4 for one model: warm-up, the three serving runs (and with
    ``dense_speculative`` a fourth, whose verify forwards of width 16 run
    the dense attention mode), the stream comparisons, the full-size
    forward check and the profile.  ``layers`` cuts the depth (full
    width); ``long_context`` adds the runs past a sliding window
    (``serve_long``); ``prefill_pools`` / ``prefill_single`` run
    ``prefill_capture`` on those caches (and the single-request
    drivers).  Returns the launches by run."""
    cfg, params = model_params(arch, layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    prompts[5][:32] = prompts[0][:32]          # admitted later: prefix hit
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    check_capture(mods, cfg, params, prompts, card)
    if prefill_pools or prefill_single:
        prefill_capture(mods, cfg, params, prompts, card, prefill_pools,
                        prefill_single)
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
    if long_context:
        runs.update(serve_long(mods, cfg, params, card))
    return runs


def serve_light(mods, arch, card, forward_rtol) -> dict:
    """Phase 4, lighter, for a GQA model whose path the earlier models
    already drive: the capture check, paged greedy (captured) and dense
    greedy with their stream comparison, and the full-size forward check.
    Returns the launches by run."""
    cfg, params = model_params(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    prompts[5][:32] = prompts[0][:32]          # admitted later: prefix hit
    check_capture(mods, cfg, params, prompts, card)
    greedy, l1, rec, routes = serve_run(mods, cfg, params, prompts,
                                        block_size=16, mode="greedy",
                                        card=card)
    dense, l2, rec_dense, routes_dense = serve_run(
        mods, cfg, params, prompts, block_size=0, mode="greedy", card=card)
    compare_streams(f"{cfg.name} dense greedy", greedy, dense,
                    [rec, rec_dense], (routes, routes_dense),
                    len(prompts[0]), {5: (0, 32)})
    check_forward(mods, cfg, params, prompts, forward_rtol)
    return {"paged_greedy": l1, "dense_greedy": l2}


def serve_long(mods, cfg, params, card) -> dict:
    """A sliding-window model past its window: 2 slots of ``LONG_MAX_LEN``
    positions serve 3 requests of ``LONG_PROMPT``-token prompts x 32
    tokens, paged and dense greedy on the kernels (the third shares its
    first 4096 tokens with the first: a 256-page prefix hit whose
    256-position suffix runs as one decode-shaped forward); their streams
    against each other; the kernel-vs-plain forward at those lengths
    (``check_long_forward``) and the ring buffer against the full cache
    (``check_ring``).  Returns the launches by run."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=LONG_PROMPT)
               for _ in range(3)]
    prompts[2][:MIXTRAL_WINDOW] = prompts[0][:MIXTRAL_WINDOW]
    kw = {"batch": 2, "max_len": LONG_MAX_LEN, "label": " long"}
    paged, l1, rec, routes = serve_run(mods, cfg, params, prompts,
                                       block_size=16, mode="greedy",
                                       card=card, **kw)
    dense, l2, rec_dense, routes_dense = serve_run(
        mods, cfg, params, prompts, block_size=0, mode="greedy", card=card,
        **kw)
    compare_streams(f"{cfg.name} long dense greedy", paged, dense,
                    [rec, rec_dense], (routes, routes_dense), LONG_PROMPT,
                    {2: (0, MIXTRAL_WINDOW)}, base="long paged greedy")
    check_long_forward(mods, cfg, params, prompts, card)
    check_ring(mods, cfg, params, prompts[0], card)
    return {"long_paged_greedy": l1, "long_dense_greedy": l2}


def check_long_forward(mods, cfg, params, prompts, card) -> None:
    """One decode forward of width 16 over 2 slots prefilled with
    ``LONG_PROMPT`` tokens, through the kernels and through the plain
    versions on the same cache, dense and paged: the executed kv tiles
    (counted on the device in every layer) must equal slack_report's for
    the window and be fewer than the grid's, and the logits agree within
    MOE_FORWARD_RTOL under balanced routing (printed with the router)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import forward
    DecodeEngine, PagedKVConfig, ops, moe = (mods[0], mods[1], mods[3],
                                             mods[5])
    a = cfg.attention
    for paged in (None, PagedKVConfig(block_size=16)):
        gc.collect()
        eng = DecodeEngine(cfg, params, batch=2, max_len=LONG_MAX_LEN,
                           paged=paged, device="cuda")
        with Uncounted(mods):
            eng.prefill_slots({s: prompts[s] for s in range(2)})
        toks = torch.as_tensor(np.stack([p[:16] for p in prompts[1:3]]),
                               device="cuda")
        tables = eng._device_tables() if paged else None
        t, k = toks.numel(), cfg.ffn.top_k
        fixed = (moe.balanced_routing(t, k, cfg.ffn.n_experts,
                                      device="cuda"),
                 torch.full((t, k), 1.0 / k, device="cuda"))
        counter = torch.zeros(2, dtype=torch.int32, device="cuda")
        inner = (attn_mod.decode_attention_ragged,
                 attn_mod.decode_attention_paged)

        def run(use_kernel, routing):
            return forward(eng.params, cfg, {"tokens": toks}, mode="decode",
                           cache=eng.cache, cache_len=eng.slot_lens,
                           use_kernel=use_kernel, block_tables=tables,
                           routing_override=routing)[0].float()
        attn_mod.decode_attention_ragged = functools.partial(inner[0],
                                                             tiles=counter)
        attn_mod.decode_attention_paged = functools.partial(inner[1],
                                                            tiles=counter)
        try:
            with Uncounted(mods):
                got = run(True, fixed)
        finally:
            (attn_mod.decode_attention_ragged,
             attn_mod.decode_attention_paged) = inner
        with Uncounted(mods):
            want = run(False, fixed)
            routed = (run(True, None), run(False, None))
        lens = eng.slot_lens_host.tolist()
        rep = ops.slack_report(16, lens, LONG_MAX_LEN, head_dim=a.head_dim,
                               k_block=16 if paged else ops.K_BLOCK,
                               window=a.window)
        executed = int(counter[0])
        expect = cfg.n_layers * a.n_kv_heads * rep["kv_tiles_executed"]
        rel = float((got - want).norm() / want.norm())
        rel_r = float((routed[0] - routed[1]).norm() / routed[1].norm())
        mode = "paged" if paged else "dense"
        print(f"forward {cfg.name} long {mode} (lengths {lens}, n 16, window "
              f"{a.window}): kv tiles executed {executed} == "
              f"{cfg.n_layers} layers x {a.n_kv_heads} kv x "
              f"{rep['kv_tiles_executed']} (grid {rep['kv_tiles_grid']} per "
              f"kv head and layer); logits kernels vs plain relative error "
              f"{rel:.3g} (balanced routing, limit {MOE_FORWARD_RTOL}), "
              f"{rel_r:.3g} with the router (not held) [{card}]")
        if (executed != expect
                or rep["kv_tiles_executed"] >= rep["kv_tiles_grid"]
                or got.shape != (2, 16, cfg.vocab_size)
                or not torch.isfinite(got).all() or rel > MOE_FORWARD_RTOL):
            raise AssertionError(f"{cfg.name} long {mode} forward: tiles "
                                 f"{executed} (want {expect}), relative "
                                 f"error {rel:.3g}")
        del eng


# the decode blocks of the ring check: 1-16 positions, crossing the window
# (4096) and the ring's seam (4224)
RING_BLOCKS = (1, 16, 3, 9, 16, 2, 7, 16, 11, 5, 16, 1, 13, 16, 8, 16, 4,
               16, 12, 16, 6, 16, 10, 16, 14, 16, 15, 16, 3, 16, 9, 16, 2,
               16, 16, 16, 7, 16, 11, 16, 5, 16, 13, 16)
RING_PREFILL = 4000


def check_ring(mods, cfg, params, prompt, card) -> None:
    """``forward(swa_ring=True)`` over ``init_cache(swa_ring=True)`` (window
    + 128 headroom = 4224 slots) against the full 4608-position cache:
    both prefill ``RING_PREFILL`` tokens, then decode ``RING_BLOCKS`` (1-16
    positions each) past the window and across the ring's seam, the ring
    wrapping.  Both run the plain versions (the ring has no kernel, as in
    the reference), so only the cache differs.  The ring holds its keys
    in another order, so the bf16 sums round differently: every block's
    logits must agree within FORWARD_RTOL under balanced routing (with
    the router, printed: a near-tie flips an expert)."""
    from repro_torch.models import forward, init_cache
    moe = mods[5]
    a = cfg.attention
    toks_all = np.concatenate([prompt, np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=LONG_MAX_LEN - len(prompt))])
    for routed in (False, True):
        gc.collect()
        caches = {ring: init_cache(cfg, 1, LONG_MAX_LEN, torch.bfloat16,
                                   "cuda", swa_ring=ring)
                  for ring in (False, True)}
        w_buf = caches[True]["segments"][0]["k"].shape[2]
        first = torch.as_tensor(toks_all[None, :RING_PREFILL], device="cuda")
        for cache in caches.values():
            forward(params, cfg, {"tokens": first}, mode="prefill",
                    cache=cache, use_kernel=False)
        pos, worst = RING_PREFILL, 0.0
        for nb in RING_BLOCKS:
            toks = torch.as_tensor(toks_all[None, pos:pos + nb],
                                   device="cuda")
            fixed = None if routed else (
                moe.balanced_routing(nb, cfg.ffn.top_k, cfg.ffn.n_experts,
                                     device="cuda"),
                torch.full((nb, cfg.ffn.top_k), 1.0 / cfg.ffn.top_k,
                           device="cuda"))
            out = {ring: forward(params, cfg, {"tokens": toks},
                                 mode="decode", cache=cache, cache_len=pos,
                                 use_kernel=False, swa_ring=ring,
                                 routing_override=fixed)[0].float()
                   for ring, cache in caches.items()}
            worst = max(worst, float((out[True] - out[False]).norm()
                                     / out[False].norm()))
            pos += nb
        print(f"ring {cfg.name}: {w_buf} slots (window {a.window} + 128), "
              f"prefill {RING_PREFILL}, {len(RING_BLOCKS)} decode blocks of "
              f"1-16 to position {pos} (wrapped {pos > w_buf}), largest "
              f"per-block logits relative error against the full cache "
              f"{worst:.3g} ({'router, not held' if routed else f'balanced routing, limit {FORWARD_RTOL}'}) [{card}]")
        if w_buf != 4224 or pos <= w_buf or pos > LONG_MAX_LEN or (
                not routed and worst > FORWARD_RTOL):
            raise AssertionError(f"{cfg.name} ring buffer leaves the full "
                                 f"cache: {worst:.3g} ({w_buf} slots, "
                                 f"position {pos})")
        del caches


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
    capture_routes(eng)
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
        # held in f32; printed only in bf16, on the first SOLO_PRINTED
        solo_cache[solo_block] = solo_diffusion(
            mods, cfg, params, prompts if f32 else prompts[:SOLO_PRINTED],
            solo_block, card, use_kernel=not f32)
    solo, trace_b = solo_cache[solo_block]
    compare_diffusion(name, streams, solo, holder["trace"].trace, trace_b,
                      len(prompts[0]), solo_block,
                      mods[7].refine_block, f32, held=f32)
    return launches


def serve_parallel(mods, arch, card, forward_rtol, dense_block=None,
                   f32_layers=None, prefill_pools=()) -> dict:
    """Phase 4 for a parallel-decoding validation model: paged greedy,
    paged MTP (held against greedy), paged diffusion at the budget's
    width and, with ``dense_block``, dense diffusion at that block; the
    full-size forward check; a profile of each run's steady steps.  Then
    the same weights in float32 (at ``f32_layers`` layers where given)
    serve the diffusion runs again through the plain versions (the
    kernels take bf16 only), where the solo comparison is held.
    ``prefill_pools``: ``prefill_capture`` on those caches.  Returns the
    launches by run."""
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
    if prefill_pools:
        prefill_capture(mods, cfg, params, prompts, card, prefill_pools)
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


def solo_greedy(mods, cfg, params, prompts, card, use_kernel=True
                ) -> tuple:
    """Every prompt through a batch-1 engine's ``greedy_generate`` (the
    kernel path, or the plain versions), recording the top-2 gap before
    each token as ``record_gaps`` does; the scan and decode-attention
    launches counted.  Returns ({rid: tokens}, gaps)."""
    DecodeEngine, ops, scan_ops = mods[0], mods[3], mods[6]
    eng = DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN, device="cuda",
                       use_kernel=use_kernel)
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
    ops.decode_attention_ragged.launches = 0
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        cur["rid"] = rid
        streams[rid] = eng.greedy_generate(
            torch.as_tensor(p[None], device="cuda"), 32)[0].cpu().numpy()
    dt = time.perf_counter() - t0
    # prefill + 31 decode forwards a request; attention: the decode ones
    per = kernel_layers(cfg)
    want = {"scan": per["scan"] * 32 * len(prompts) * use_kernel,
            "dense": per["attn"] * 31 * len(prompts) * use_kernel}
    got = {"scan": scan_ops.selective_scan_padded.launches,
           "dense": ops.decode_attention_ragged.launches}
    if got != want:
        raise AssertionError(f"solo greedy: launches {got}, expected {want}")
    print(f"solo greedy_generate {cfg.name}"
          f"{'' if use_kernel else ' (plain versions)'}: {len(prompts)} "
          f"requests x 32 forwards in {dt:.3f} s, launches {got} [{card}]")
    return streams, rec


def serve_ssm(mods, arch, card, forward_rtol, prefill_check=False) -> dict:
    """Phase 4 for a model with recurrent state, dense greedy only.  The
    bf16 model serves 8 requests on 4 slots (every slot reused): the main
    path, launches counted.  Its streams against each request's batch-1
    ``greedy_generate`` are printed only: a deep random-weight SSM stack
    may amplify one bf16 rounding into logits that part wholesale
    (``ssm_sensitivity`` prints by how much).  The same weights cast to
    float32 then serve the same requests, and there every stream must
    equal its solo ``greedy_generate`` up to the GAP_TOL near-tie rule.

    falcon_mamba_7b (Mamba1): its kernel, the selective scan, takes
    float32, so the f32 runs go through it and the full-size forward is
    held against the plain scan in f32 (``forward_rtol``), printed in
    bf16.  zamba2_1p2b (Mamba2, no kernel; hybrid layers with shared
    attention): its kernel is decode attention in the hybrid layers,
    which takes bf16 only, so the forward is held kernel vs plain in bf16
    and the f32 runs go through the plain versions; one captured step is
    also timed beside the weight bound and the Mamba2 loop's share
    (``mamba2_step``).  ``prefill_check``: ``prefill_capture`` on the
    dense cache, the single-request drivers included.  Returns the
    launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers} layers ({cfg.count_layers('hybrid')} "
          f"hybrid), d {cfg.d_model}, {cfg.ssm.kind}, {n_params:.4g} "
          f"parameters, {2 * n_params / 1e9:.4g} GB in bf16")
    f32_kernel = cfg.attention is None       # the scan kernel takes f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=48) for _ in range(8)]
    serve_run(mods, cfg, params, prompts[:1], block_size=0,
              mode="greedy", card=card)        # warm-up
    check_capture(mods, cfg, params, prompts, card)
    if prefill_check:
        prefill_capture(mods, cfg, params, prompts, card, single=True)
    runs = {"dense_greedy_bf16": ssm_checks(
        mods, cfg, params, prompts, card, forward_rtol, held=False,
        forward_held=not f32_kernel)}
    for capture in (True, False):
        profile_steps(mods, cfg, params, prompts, card, how="dense greedy",
                      capture=capture, host=capture)
    if cfg.ssm.kind == "mamba2":
        mamba2_step(mods, cfg, params, prompts, card)
    runs["calibration"] = calibration_table(mods, cfg, params, card)
    params32 = _to_f32(params)
    for p, use_kernel in ((params, True), (params32, f32_kernel)):
        count_launches(cfg, p, prompts, card, use_kernel)
    ssm_sensitivity(cfg, params, params32, prompts, f32_kernel)
    del params
    torch.cuda.empty_cache()
    runs["dense_greedy_f32"] = ssm_checks(
        mods, cfg, params32, prompts, card, forward_rtol, held=True,
        forward_held=True, use_kernel=f32_kernel)
    return runs


SOLO_PRINTED = 4


def ssm_checks(mods, cfg, params, prompts, card, forward_rtol, held,
               forward_held, use_kernel=True):
    """Serve the 8 requests (``use_kernel`` False: through the plain
    versions), compare every stream with its solo ``greedy_generate``
    (held or printed only) and, on the kernel path, the forward with the
    plain versions (held when ``forward_held``).  Returns the serving
    run's launches."""
    dtype = "f32" if params["embed"]["table"].dtype == torch.float32 \
        else "bf16"
    served, launches, rec, _ = serve_run(mods, cfg, params, prompts,
                                         block_size=0, mode="greedy",
                                         card=card, use_kernel=use_kernel)
    if dtype == "bf16":
        eager, _, _, _ = serve_run(mods, cfg, params, prompts, block_size=0,
                                   mode="greedy", card=card, capture=False)
        same_streams(f"{cfg.name} bf16 dense greedy", eager, served)
    # a comparison printed only takes the first SOLO_PRINTED requests
    solo, rec_solo = solo_greedy(mods, cfg, params,
                                 prompts if held else prompts[:SOLO_PRINTED],
                                 card, use_kernel)
    compare_streams(f"{cfg.name} {dtype} dense greedy"
                    f"{'' if use_kernel else ' (plain versions)'}", solo,
                    served, [rec_solo, rec], ([], []), len(prompts[0]), {},
                    base="solo greedy_generate", held=held)
    if use_kernel:
        check_forward(mods, cfg, params, prompts, forward_rtol,
                      held=forward_held)
    return launches


def mamba2_step(mods, cfg, params, prompts, card) -> None:
    """One captured width-1 decode step of a Mamba2 model over 4
    prefilled slots: its device time (CUDA events around the replay)
    beside the weight bound (every parameter byte read once), and the
    device time of the Mamba2 recurrence alone (``_mamba2_scan`` of every
    Mamba2 layer at this step's shapes, captured into a graph of its own
    and replayed): the share of the step its small per-position
    operations take."""
    from repro_torch.models import mamba
    DecodeEngine = mods[0]
    gc.collect()
    eng = DecodeEngine(cfg, params, batch=4, max_len=MAX_LEN, device="cuda")
    with Uncounted(mods):
        eng.prefill_slots({s: prompts[s] for s in range(4)})
        toks = torch.as_tensor(np.stack([p[:1] for p in prompts[4:8]]),
                               device="cuda")
        eng.warm_decode([1])
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
        step_ms = time_ms(lambda: eng.decode_slots(toks), flush)
    s = cfg.ssm
    nh = s.d_inner(cfg.d_model) // s.head_dim
    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    layers = cfg.n_layers - cfg.count_layers("attn")
    args = [(randn(4, 1, nh, s.head_dim), randn(4, 1, nh).sigmoid(),
             randn(4, 1, nh, s.d_state), randn(4, 1, nh, s.d_state),
             randn(4, nh, s.head_dim, s.d_state)) for _ in range(layers)]

    def loops():
        for a in args:
            mamba._mamba2_scan(*a)
    loop_ms = graph_ms(loops, flush)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    bound = weight_bytes / PEAK_BYTES_S * 1e3
    MAMBA2[cfg.name] = {"step_ms": step_ms, "bound_ms": bound,
                        "loop_ms": loop_ms}
    print(f"mamba2 step {cfg.name}: one captured width-1 decode step over 4 "
          f"slots {step_ms:.4f} ms of device time against a weight bound of "
          f"{bound:.4f} ms ({weight_bytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s; {bound / step_ms:.1%} of it); "
          f"the Mamba2 recurrence of its {layers} layers alone "
          f"{loop_ms:.4f} ms ({loop_ms / step_ms:.1%} of the step) [{card}]")
    del eng


def count_launches(cfg, params, prompts, card, use_kernel=True) -> None:
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
                cache_len=lens, use_kernel=use_kernel)
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
    print(f"launches {cfg.name} {dtype}"
          f"{'' if use_kernel else ' (plain versions)'}: {len(kernels)} "
          f"device operations (kernels, copies, fills) in one width-1 decode "
          f"forward, {len(kernels) / cfg.n_layers:.2f} per layer; most "
          f"frequent: " + ", ".join(f"{n[:60]} x{c}" for n, c in sorted(
              by_name.items(), key=lambda kv: -kv[1])[:8]) + f" [{card}]")


def ssm_sensitivity(cfg, params, params32, prompts, f32_kernel=True) -> None:
    """How far two arithmetics of the same random-weight model part: the
    logits of 4 prompts run as one batch and one by one (same weights and
    type), and bf16 against the same weights cast to float32 (through the
    plain versions where the kernels take bf16 only)."""
    from repro_torch.models import forward
    toks = torch.as_tensor(np.stack(prompts[:4]), device="cuda")

    def logits(p, t, use_kernel):
        return forward(p, cfg, {"tokens": t},
                       use_kernel=use_kernel)[0].float()

    def batch_and_rows(p, use_kernel):
        return logits(p, toks, use_kernel), torch.cat(
            [logits(p, toks[i:i + 1], use_kernel) for i in range(4)])
    b4, b1 = batch_and_rows(params, True)
    f4, f1 = batch_and_rows(params32, f32_kernel)
    for name, got, want in (("bf16 batch-1 vs batch-4", b1, b4),
                            ("f32 batch-1 vs batch-4", f1, f4),
                            ("bf16 vs f32, batch 4", b4, f4)):
        print(f"sensitivity {cfg.name} ({name}, 4 x 48 tokens): logits "
              f"relative error {float((got - want).norm() / want.norm()):.3g}"
              f", max abs {float((got - want).abs().max()):.3g}, argmax "
              f"agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}"
              f", logit std {float(want.std()):.3g}")


def whisper_forward(mods, arch, card, forward_rtol) -> dict:
    """The encoder-decoder model's forward at full width (no engine serves
    it: its forward needs the stub frontend's frame embeddings, which no
    engine path passes, as in the reference).  Seeded random bf16
    weights and ``n_frames`` frame embeddings for each of 4 rows: the
    train forward over 64 tokens; a prefill of the first 48 into a dense
    cache of MAX_LEN positions, then decode forwards of n = 1 and n = 16
    at length 48, through the kernel and through the plain versions
    (held within ``forward_rtol``), each also against the train forward's
    same positions (held within ``forward_rtol``); decode-attention
    launches = decoder layers x kernel decode forwards.  Then the device
    time of one n = 1 decode forward beside the encoder's alone and the
    decoder layers' cross K/V projections alone (each replayed as a CUDA
    graph: device time without host launch gaps): the share of a decode
    forward spent on the memory, which every call recomputes.  Returns
    the launches."""
    from repro_torch.models import forward, init_cache
    from repro_torch.models.attention import encode_cross_kv
    from repro_torch.models.transformer import _layer, encode
    ops = mods[3]
    cfg, params = model_params(arch)
    g = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((4, cfg.encoder.n_frames, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 64)), device="cuda")
    ops.decode_attention_ragged.launches = 0
    t0 = time.perf_counter()
    full = forward(params, cfg, {"tokens": toks, "frames": frames})[0].float()
    torch.cuda.synchronize()
    if full.shape != (4, 64, cfg.vocab_size) or not torch.isfinite(
            full).all():
        raise AssertionError(f"{cfg.name} train logits {tuple(full.shape)} "
                             "not finite or of the wrong shape")
    print(f"forward {cfg.name} train: 4 x 64 tokens over 4 x "
          f"{cfg.encoder.n_frames} frames, finite logits "
          f"{tuple(full.shape)} in {time.perf_counter() - t0:.3f} s [{card}]")
    cache = init_cache(cfg, 4, MAX_LEN, torch.bfloat16, "cuda")
    forward(params, cfg, {"tokens": toks[:, :48], "frames": frames},
            mode="prefill", cache=cache)
    lens = torch.full((4,), 48, dtype=torch.int32, device="cuda")

    def decode(n, use_kernel):
        return forward(params, cfg, {"tokens": toks[:, 48:48 + n],
                                     "frames": frames}, mode="decode",
                       cache=cache, cache_len=lens,
                       use_kernel=use_kernel)[0].float()

    def rel(got, want):
        return float((got - want).norm() / want.norm())
    for n in (1, 16):
        got, plain = decode(n, True), decode(n, False)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name} decode n={n}: logits not "
                                 "finite")
        e_plain, e_full = rel(got, plain), rel(got, full[:, 48:48 + n])
        agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"forward {cfg.name} decode n={n} at length 48: kernel vs "
              f"plain versions logits relative error {e_plain:.3g}, argmax "
              f"agreement {agree:.3f}; prefill + decode vs the train "
              f"forward {e_full:.3g} (limit {forward_rtol} each)")
        if e_plain > forward_rtol or e_full > forward_rtol:
            raise AssertionError(f"{cfg.name} decode n={n} leaves its "
                                 "reference forward")
    launches = {"dense": ops.decode_attention_ragged.launches, "paged": 0,
                "moe": 0, "scan": 0}
    if launches["dense"] != kernel_layers(cfg)["attn"] * 2:
        raise AssertionError(f"{cfg.name}: {launches['dense']} decode "
                             f"attention launches, expected "
                             f"{kernel_layers(cfg)['attn']} x 2")
    # the device time of one decode forward and of what it recomputes,
    # each replayed as a CUDA graph (no host launch gaps)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    with Uncounted(mods):
        fwd_ms = graph_ms(lambda: decode(1, True), flush)
    enc_ms = graph_ms(lambda: encode(params, cfg, frames), flush)
    memory = encode(params, cfg, frames)
    crosses = [_layer(sp, i)["cross"] for sp in params["segments"]
               for i in range(sp["ln1"]["scale"].shape[0])]
    cross_ms = graph_ms(lambda: [encode_cross_kv(c, cfg.attention, memory)
                                 for c in crosses], flush)
    WHISPER[cfg.name] = {"decode_ms": fwd_ms, "encode_ms": enc_ms,
                         "cross_kv_ms": cross_ms}
    print(f"whisper decode {cfg.name}: one n=1 decode forward over 4 rows "
          f"{fwd_ms:.4f} ms of device time; re-encoding the "
          f"{cfg.encoder.n_frames} frames {enc_ms:.4f} ms "
          f"({enc_ms / fwd_ms:.1%}), re-projecting the cross K/V of "
          f"{len(crosses)} layers {cross_ms:.4f} ms "
          f"({cross_ms / fwd_ms:.1%}); together "
          f"{(enc_ms + cross_ms) / fwd_ms:.1%} of the forward [{card}]")
    return {"forward": launches}


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
    slots, a dense 1024-position cache: the calibration's engine); then
    full-width zamba2_1p2b served dense greedy (8 requests x 32 tokens)."""
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
    out.append(("zamba2_greedy", [
        "--arch", "zamba2_1p2b", "--requests", "8", "--tokens", "32",
        "--prompt-len", "48", "--serve-mode", "greedy"]))
    return out


def run_cli(argv) -> dict:
    """``python -m repro_torch.launch.serve`` in-process; returns what
    ``serve`` served."""
    from repro_torch.launch.serve import build_parser, check_args, serve
    (OUT / "calibration").mkdir(parents=True, exist_ok=True)
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    return serve(args)


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
    print(f"summary: prefill of 4 slots, eager (capture=False) vs "
          f"replayed ms; graphs captured and capture seconds; the prefill "
          f"graphs' memory [{card}]")
    for arch, r in PREFILL.items():
        print(f"  {arch}: " + ", ".join(
            f"{w}: {a:.3f} / {b:.3f}" for w, (a, b) in r["ms"].items())
            + "; " + ", ".join(f"{k} {n} ({t:.3f} s)"
                               for k, (n, t) in r["graphs"].items())
            + f"; scratch {r['scratch_bytes'] / 1e6:.1f} MB, peak above the "
            f"engine {r['decode_graphs_peak_bytes'] / 1e9:.3f} GB with the "
            f"decode graphs, {r['prefill_graphs_peak_bytes'] / 1e9:.3f} GB "
            f"with the prefill graphs too")
    print(f"summary: device memory peak by model phase "
          f"(torch.cuda.max_memory_allocated) [{card}]")
    for arch, gb in MEMORY.items():
        print(f"  {arch}: {gb:.2f} GB")
    for name, r in MAMBA2.items():
        print(f"summary: {name} captured width-1 step {r['step_ms']:.4f} ms, "
              f"weight bound {r['bound_ms']:.4f} ms, Mamba2 recurrence "
              f"{r['loop_ms']:.4f} ms [{card}]")
    for name, r in WHISPER.items():
        print(f"summary: {name} n=1 decode forward {r['decode_ms']:.4f} ms, "
              f"encoder {r['encode_ms']:.4f} ms, cross K/V "
              f"{r['cross_kv_ms']:.4f} ms [{card}]")


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

# (a): float32 on both devices, TF32 off; a float32 sum of the same terms
# in another order (cuBLAS against the CPU's BLAS) moves a relative
# 1e-7-1e-6; the bounds leave room for the backward's longer sums
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_REMAT_RTOL = 1e-4
TRAIN_CHECK_LAYERS = 2
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ, TRAIN_N_MICRO = 8, 256, 2
# steps of the decomposed step (gradients, then the optimizer) and of
# remat False, after the 20; the first of each is a warm-up
TRAIN_EXTRA_STEPS = 4
TRAIN = {}
TRAIN_BATCHES = []            # train_full's batches, for train_capture
TRAIN_CAPTURE = {}


def _rel_norm(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _grad_errors(grads, want) -> float:
    return max(_rel_norm(a, b) for a, b in zip(_leaves(grads), _leaves(want)))


def train_check(card) -> None:
    """(a) ``loss_fn`` and its gradients on the card against the CPU (the
    same port code the CPU tests hold against the reference), then remat
    and micro-batching on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import init_model
    from repro_torch.training import grad_accum_fn, loss_fn
    from repro_torch.training.train_step import value_and_grad
    cfg = dataclasses.replace(get_config("stablelm_3b"),
                              n_layers=TRAIN_CHECK_LAYERS)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda", torch.float32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    (loss, _), grads = value_and_grad(loss_fn, params, cfg, batch, 0.01,
                                      False)
    t0 = time.perf_counter()
    (cpu_loss, _), cpu_grads = value_and_grad(
        loss_fn, tree_map(lambda t: t.cpu(), params), cfg,
        {"tokens": torch.as_tensor(toks)}, 0.01, False)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_err = _grad_errors(grads, cpu_grads)
    errs = {}
    for remat in (True, 0.5):
        _, g = value_and_grad(loss_fn, params, cfg, batch, 0.01, remat)
        errs[f"remat {remat}"] = _grad_errors(g, grads)
    g2, loss2, _ = grad_accum_fn(params, cfg, batch, 2, 0.01, False)
    errs["n_micro 2"] = max(_grad_errors(g2, grads),
                            _rel_norm(loss2, loss))
    n = sum(t.numel() for t in _leaves(params))
    print(f"train check {cfg.name} ({cfg.n_layers} of "
          f"{get_config('stablelm_3b').n_layers} layers, full "
          f"width, {n:.4g} parameters, float32, batch 2 x 64): loss "
          f"{float(loss):.6f} on the card, {float(cpu_loss):.6f} on the CPU "
          f"({cpu_s:.1f} s): relative error {loss_err:.3g} (limit "
          f"{TRAIN_LOSS_RTOL:g}); worst gradient leaf {grad_err:.3g} "
          f"normwise (limit {TRAIN_GRAD_RTOL:g}); on the card against remat "
          f"False, n_micro 1: " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in errs.items())
          + f" (limit {TRAIN_REMAT_RTOL:g}) [{card}]")
    if (loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL
            or max(errs.values()) > TRAIN_REMAT_RTOL):
        raise AssertionError("train check: card against CPU or remat / "
                             "n_micro out of bounds")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_full(card) -> None:
    """(b) 20 steps of full-size stablelm_3b through the eager
    ``train_step``, then the step decomposed (its gradients, then
    ``adamw_update``: what ``train_step`` runs for n_micro > 1) and with
    remat False.  Keeps its losses, gradient norms and batches for
    ``train_capture``; its state is freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      grad_accum_fn, init_opt_state,
                                      make_train_step)
    cfg = get_config("stablelm_3b")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    opt = init_opt_state(params)
    n = sum(t.numel() for t in _leaves(params))
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=4, total_steps=TRAIN_STEPS)
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    t0 = time.perf_counter()
    batches = [{"tokens": torch.as_tensor(next(data)["tokens"],
                                          device="cuda")}
               for _ in range(TRAIN_STEPS + 2 * TRAIN_EXTRA_STEPS + 2)]
    data_s = time.perf_counter() - t0
    TRAIN_BATCHES[:] = batches
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = make_train_step(cfg, opt_cfg, n_micro=TRAIN_N_MICRO, remat=True)
    losses, norms, times = [], [], []
    for b in batches[:TRAIN_STEPS]:
        (params, opt, m), dt = _timed(lambda: step(params, opt, b))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        times.append(dt)
    losses = torch.stack(losses).tolist()
    norms = torch.stack(norms).tolist()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[2:])
    print(f"train {cfg.name}: {cfg.n_layers} layers, {n:.4g} parameters "
          f"(bf16 weights, f32 master / m / v: {state_gb:.2f} GB), "
          f"{TRAIN_STEPS} steps at batch {TRAIN_BATCH} x {TRAIN_SEQ}, n_micro "
          f"{TRAIN_N_MICRO}, remat True, SyntheticLM seed 0 ({data_s:.1f} s "
          f"to draw the batches)")
    print("train loss curve: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"train step (median of steps 3-{TRAIN_STEPS}, host clock ending "
          f"in a synchronize): {1e3 * step_s:.1f} ms, "
          f"{tokens / step_s:.0f} tokens/s; model-FLOP share 6NT "
          f"{6 * n * tokens / step_s / PEAK_BF16_FLOPS:.1%}, with remat's "
          f"recompute 8NT {8 * n * tokens / step_s / PEAK_BF16_FLOPS:.1%} "
          f"of {PEAK_BF16_FLOPS:.3g} FLOP/s; first step "
          f"{1e3 * times[0]:.1f} ms; memory peak {peak:.2f} GB, max "
          f"reserved {reserved:.2f} GB [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    grad_s, opt_s = [], []
    for b in batches[TRAIN_STEPS:TRAIN_STEPS + TRAIN_EXTRA_STEPS]:
        (grads, _, _), dt = _timed(lambda: grad_accum_fn(
            params, cfg, b, TRAIN_N_MICRO, 0.01, True))
        grad_s.append(dt)
        _, dt = _timed(lambda: adamw_update(opt_cfg, params, grads, opt))
        opt_s.append(dt)
        del grads
    grad_s, opt_s = statistics.median(grad_s[1:]), statistics.median(opt_s[1:])
    # AdamW's least traffic: read the f32 grads, read and write master, m
    # and v, write the bf16 params
    opt_bound = n * (4 + 3 * 8 + 2) / PEAK_BYTES_S
    print(f"train step decomposed (median of {TRAIN_EXTRA_STEPS - 1}): "
          f"gradients {1e3 * grad_s:.1f} ms, adamw_update "
          f"{1e3 * opt_s:.1f} ms ({opt_s / (grad_s + opt_s):.1%} of the "
          f"step; its byte bound {1e3 * opt_bound:.1f} ms) [{card}]")
    TRAIN.update(step_ms=1e3 * step_s, tokens_s=tokens / step_s,
                 mfu=6 * n * tokens / step_s / PEAK_BF16_FLOPS,
                 grad_ms=1e3 * grad_s, opt_ms=1e3 * opt_s, peak_gb=peak,
                 max_reserved_gb=reserved, losses=losses, grad_norms=norms)
    train_profile("remat True", step, params, opt, batches[-2], card)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    nr_step = make_train_step(cfg, opt_cfg, n_micro=TRAIN_N_MICRO,
                              remat=False)
    nr_times = []
    try:
        for b in batches[TRAIN_STEPS + TRAIN_EXTRA_STEPS:-2]:
            (params, opt, m), dt = _timed(lambda: nr_step(params, opt, b))
            nr_times.append(dt)
    except torch.cuda.OutOfMemoryError:
        print(f"train remat False: does not fit in the card's memory "
              f"[{card}]")
        return
    nr_s = statistics.median(nr_times[1:])
    nr_peak = torch.cuda.max_memory_allocated() / 1e9
    TRAIN.update(no_remat_ms=1e3 * nr_s, no_remat_peak_gb=nr_peak)
    print(f"train step remat False (median of {len(nr_times) - 1}): "
          f"{1e3 * nr_s:.1f} ms, {tokens / nr_s:.0f} tokens/s, model-FLOP "
          f"share {6 * n * tokens / nr_s / PEAK_BF16_FLOPS:.1%}; remat "
          f"True costs {step_s / nr_s - 1:.1%} more time; memory peak "
          f"{nr_peak:.2f} GB against {peak:.2f} [{card}]")
    train_profile("remat False", nr_step, params, opt, batches[-1], card)


def train_profile(label, step, params, opt, batch, card, top=8) -> None:
    """torch.profiler over one more train step: the device's busy share
    of its wall time (the profiler's host tracing inflates the wall), its
    device operations, and the ``top`` kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    total = sum(busy.values())
    if total == 0:
        print("train profile: the profiler recorded no device time (not "
              "measured)")
        return
    ops = sum(e.count for e in kernels)
    TRAIN[f"profile {label}"] = {"wall_ms": wall_ms, "busy_ms": total,
                                 "device_ops": ops}
    print(f"train profile {label} (one step under the profiler): wall "
          f"{wall_ms:.1f} ms, device busy {total:.1f} ms "
          f"({total / wall_ms:.1%}), idle {1 - total / wall_ms:.1%}, "
          f"{ops} device operations [{card}]")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.3f} ms  {100 * ms / total:5.1f}%  {name[:90]}")


def _gap(got, want) -> float:
    """The largest relative difference of two runs' per-step values."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def _state_gap(got, want) -> float:
    """The worst leaf's normwise difference of two trees."""
    return max(_rel_norm(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def _train_run(cfg, opt_cfg, batches, *, n_micro, remat, captured):
    """Fresh params from seed 0 and ``len(batches)`` steps, eager or
    through ``compiled_train_step``: (losses, grad norms, step seconds,
    params, AdamW state, the compiled step or None)."""
    from repro_torch.models import init_model
    from repro_torch.training import init_opt_state, make_train_step
    from repro_torch.training.capture import compiled_train_step
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    opt = init_opt_state(params)
    step = make_train_step(cfg, opt_cfg, n_micro=n_micro, remat=remat)
    compiled = compiled_train_step(step, "cuda") if captured else None
    run = compiled or step
    losses, norms, times = [], [], []
    for b in batches:
        (params, opt, m), dt = _timed(lambda: run(params, opt, b))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        times.append(dt)
    return (torch.stack(losses).tolist(), torch.stack(norms).tolist(), times,
            params, opt, compiled)


def _held(name, got, want, gap) -> None:
    """Whether the captured run's per-step (loss, grad norm) lists ``got``
    equal the eager ``want`` bitwise, or where two eager runs part (``gap``
    {"loss", "grad_norm"}, None if not measured) lie within their gap."""
    same = got == want
    if not same and gap is not None and max(gap.values()) > 0:
        same = (_gap(got[0], want[0]) <= gap["loss"]
                and _gap(got[1], want[1]) <= gap["grad_norm"])
    if not same:
        raise AssertionError(
            f"{name}: captured losses {got[0]} / grad norms {got[1]} against "
            f"eager {want[0]} / {want[1]} (eager-vs-eager gap {gap})")


def train_capture(card):
    """(b2) ``train_full``'s 20 remat-True steps again, from the same seed
    and batches, through ``training.capture.compiled_train_step``: the
    first call eager then its capture, then 19 replays.  Per-step losses
    and gradient norms bitwise ``train_full``'s (else an eager run again
    gives the eager-vs-eager gap, which bounds them); the median replayed
    step, tokens/s, model-FLOP share, the first call's eager and capture
    seconds, memory reserved with the graph pool, one replay under the
    profiler.  Then the captured remat-False step.  Returns the trained
    params (the AdamW state and the graphs are freed on return)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.capture import compiled_train_step
    cfg = get_config("stablelm_3b")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=4, total_steps=TRAIN_STEPS)
    batches = TRAIN_BATCHES
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, params, opt, step = _train_run(
        cfg, opt_cfg, batches[:TRAIN_STEPS], n_micro=TRAIN_N_MICRO,
        remat=True, captured=True)
    reserved = torch.cuda.max_memory_reserved() / 1e9
    held = torch.cuda.memory_reserved() / 1e9
    peak = torch.cuda.max_memory_allocated() / 1e9
    first = step.summary()
    n = sum(t.numel() for t in _leaves(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[2:])
    bitwise = (losses, norms) == (TRAIN["losses"], TRAIN["grad_norms"])
    eager_gap = None
    TRAIN_CAPTURE.update(
        step_ms=1e3 * step_s, tokens_s=tokens / step_s,
        mfu=6 * n * tokens / step_s / PEAK_BF16_FLOPS,
        first_ms=1e3 * times[0], eager_s=first["eager_s"],
        capture_s=first["capture_s"], graphs=first["graphs"],
        max_reserved_gb=reserved, reserved_gb=held, peak_gb=peak,
        bitwise=bitwise)
    print(f"train_capture {cfg.name}: {TRAIN_STEPS} captured steps (remat "
          f"True, batch {TRAIN_BATCH} x {TRAIN_SEQ}, n_micro "
          f"{TRAIN_N_MICRO}, train_full's seed and batches): losses and "
          f"grad norms bitwise the eager run's: {bitwise} (worst relative "
          f"difference loss {_gap(losses, TRAIN['losses']):.3g}, grad norm "
          f"{_gap(norms, TRAIN['grad_norms']):.3g}); {first['graphs']} "
          f"graph; first call {1e3 * times[0]:.1f} ms (eager step "
          f"{first['eager_s']:.2f} s, capture {first['capture_s']:.2f} s) "
          f"[{card}]")
    print(f"train_capture step (median of steps 3-{TRAIN_STEPS}, host clock "
          f"ending in a synchronize): captured {1e3 * step_s:.1f} ms, "
          f"{tokens / step_s:.0f} tokens/s, model-FLOP share 6NT "
          f"{TRAIN_CAPTURE['mfu']:.1%}; eager in this call "
          f"{TRAIN['step_ms']:.1f} ms, {TRAIN['tokens_s']:.0f} tokens/s, "
          f"{TRAIN['mfu']:.1%} ({TRAIN['step_ms'] / (1e3 * step_s):.2f}x); "
          f"memory: max reserved {reserved:.2f} GB (eager "
          f"{TRAIN['max_reserved_gb']:.2f}), reserved after the steps "
          f"{held:.2f} GB (the state and the graph pool), max allocated "
          f"{peak:.2f} GB (eager {TRAIN['peak_gb']:.2f}) [{card}]")
    train_profile("captured remat True", step, params, opt, batches[-2],
                  card)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    nr = compiled_train_step(make_train_step(cfg, opt_cfg,
                                             n_micro=TRAIN_N_MICRO,
                                             remat=False), "cuda")
    torch.cuda.reset_peak_memory_stats()
    nr_times = []
    for b in batches[TRAIN_STEPS + TRAIN_EXTRA_STEPS:-2]:
        (params, opt, m), dt = _timed(lambda: nr(params, opt, b))
        nr_times.append(dt)
    nr_s = statistics.median(nr_times[1:])
    nr_reserved = torch.cuda.max_memory_reserved() / 1e9
    nr_held = torch.cuda.memory_reserved() / 1e9
    TRAIN_CAPTURE.update(no_remat_ms=1e3 * nr_s, no_remat_first_ms=1e3
                         * nr_times[0], no_remat_max_reserved_gb=nr_reserved,
                         no_remat_reserved_gb=nr_held)
    print(f"train_capture step remat False (median of {len(nr_times) - 1} "
          f"replays): captured {1e3 * nr_s:.1f} ms, {tokens / nr_s:.0f} "
          f"tokens/s, model-FLOP share "
          f"{6 * n * tokens / nr_s / PEAK_BF16_FLOPS:.1%}; eager in this "
          f"call {TRAIN.get('no_remat_ms', float('nan')):.1f} ms; first call "
          f"{1e3 * nr_times[0]:.1f} ms; max reserved {nr_reserved:.2f} GB, "
          f"reserved after the steps {nr_held:.2f} GB [{card}]")
    train_profile("captured remat False", nr, params, opt, batches[-1],
                  card)
    del nr, opt
    gc.collect()
    torch.cuda.empty_cache()
    if not bitwise:
        # the eager-vs-eager gap: train_full's steps once more, eagerly
        params = tree_map(lambda t: t.cpu(), params)
        again = _train_run(cfg, opt_cfg, batches[:TRAIN_STEPS],
                           n_micro=TRAIN_N_MICRO, remat=True, captured=False)
        eager_gap = {"loss": _gap(again[0], TRAIN["losses"]),
                     "grad_norm": _gap(again[1], TRAIN["grad_norms"])}
        del again
        gc.collect()
        torch.cuda.empty_cache()
        params = tree_map(lambda t: t.to("cuda"), params)
        TRAIN_CAPTURE["eager_gap"] = eager_gap
        print(f"train_capture: eager-vs-eager gap over the same "
              f"{TRAIN_STEPS} steps: {eager_gap} [{card}]")
    _held("train_capture", (losses, norms),
          (TRAIN["losses"], TRAIN["grad_norms"]), eager_gap)
    return params


def train_capture_moe(card) -> None:
    """granite_moe_3b_a800m at full width and ``PLAIN_TRAIN_LAYERS`` of its
    32 layers (batch 4 x 256, n_micro 1, remat True, the grouped bf16 MoE
    path): 4 eager steps and 4 captured steps, each from seed 0: per-step
    losses and gradient norms, and the final params, bitwise the eager
    run's; if they part, the same 4 steps eagerly again give the
    eager-vs-eager gap, which bounds them.  Step times."""
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"),
                              n_layers=PLAIN_TRAIN_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 256),
                                        generator=g, device="cuda")}
               for _ in range(PLAIN_TRAIN_STEPS)]

    def run(captured):
        losses, norms, times, params, opt, step = _train_run(
            cfg, AdamWConfig(lr=1e-4), batches, n_micro=1, remat=True,
            captured=captured)
        out = {"metrics": (losses, norms), "params": params,
               "ms": 1e3 * statistics.median(times[1:]),
               "first_ms": 1e3 * times[0],
               "compiled": step.summary() if step else None}
        del opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return out
    eager, cap = run(False), run(True)
    params_gap = _state_gap(cap["params"], eager["params"])
    bitwise = cap["metrics"] == eager["metrics"] and params_gap == 0
    gap = None
    if not bitwise:
        again = run(False)
        gap = {"loss": _gap(again["metrics"][0], eager["metrics"][0]),
               "grad_norm": _gap(again["metrics"][1], eager["metrics"][1]),
               "params": _state_gap(again["params"], eager["params"])}
        del again
    TRAIN_CAPTURE["granite"] = {
        "eager_ms": eager["ms"], "captured_ms": cap["ms"],
        "first_ms": cap["first_ms"], "eager_gap": gap, "bitwise": bitwise,
        **cap["compiled"]}
    print(f"train_capture granite_moe_3b_a800m ({PLAIN_TRAIN_LAYERS} of 32 "
          f"layers at full width, batch 4 x 256, n_micro 1, remat True, "
          f"{PLAIN_TRAIN_STEPS} steps): captured against eager bitwise "
          f"{bitwise} (final params {params_gap:.3g} normwise; "
          f"eager-vs-eager gap {gap}); losses {cap['metrics'][0]}; step "
          f"(median of steps 2-{PLAIN_TRAIN_STEPS}) eager {eager['ms']:.1f} "
          f"ms, captured {cap['ms']:.1f} ms; first call "
          f"{cap['first_ms']:.1f} ms (eager step "
          f"{cap['compiled']['eager_s']:.2f} s, capture "
          f"{cap['compiled']['capture_s']:.2f} s) [{card}]")
    _held("train_capture granite", cap["metrics"], eager["metrics"],
          None if gap is None else {k: gap[k] for k in ("loss",
                                                        "grad_norm")})
    if gap is not None and params_gap > gap["params"]:
        raise AssertionError(f"train_capture granite: final params part by "
                             f"{params_gap:.3g} normwise, eager-vs-eager "
                             f"{gap['params']:.3g}")


def train_cli(card) -> None:
    """(c) The train CLI in-process: 50 steps, a resume to 60, the final
    checkpoint against the state in memory; captured (the default), then
    the same argv with ``--no-capture``: bitwise the same losses and final
    checkpoint."""
    import shutil
    from repro_torch.checkpoint import restore
    from repro_torch.launch.train import build_parser, train
    runs = {}
    for mode in ("captured", "no-capture"):
        ckpt = OUT / ("train_ckpt" if mode == "captured"
                      else "train_ckpt_eager")
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = ["--arch", "stablelm_3b", "--tiny", "--lr", "1e-2",
                "--ckpt-dir", str(ckpt), "--ckpt-every", "20"] + (
            ["--no-capture"] if mode == "no-capture" else [])
        print("cli train: python -m repro_torch.launch.train "
              + " ".join(argv + ["--steps", "50"]), flush=True)
        t0 = time.perf_counter()
        first = train(build_parser().parse_args(argv + ["--steps", "50"]))
        losses = first["losses"]
        print(f"cli train {mode}: losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} ({losses[-1] / losses[0]:.3f} of the "
              f"first; limit 0.85) [{card}]")
        if not (len(losses) == 50 and losses[-1] < 0.85 * losses[0]):
            raise AssertionError(f"cli train: the loss did not fall: "
                                 f"{losses}")
        second = train(build_parser().parse_args(argv + ["--steps", "60"]))
        dt = time.perf_counter() - t0
        if second["start"] != 50 or len(second["losses"]) != 10:
            raise AssertionError(f"cli train: resumed at {second['start']} "
                                 f"with {len(second['losses'])} steps")
        restored, meta = restore(str(ckpt), second["state"], device="cpu")
        same = all(torch.equal(a, b.cpu()) for a, b in
                   zip(_leaves(restored), _leaves(second["state"])))
        print(f"cli train {mode}: resumed at step {second['start']}, ran "
              f"{len(second['losses'])} steps to {meta['step']}; the final "
              f"checkpoint restores bitwise equal to the state in memory: "
              f"{same}; both runs {dt:.1f} s [{card}]")
        if not same or meta["step"] != 60:
            raise AssertionError("cli train: the final checkpoint differs")
        runs[mode] = (losses + second["losses"], restored, dt)
        del first, second
    (l0, c0, t0), (l1, c1, t1) = runs["captured"], runs["no-capture"]
    same = l0 == l1 and all(a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(_leaves(c0), _leaves(c1)))
    TRAIN_CAPTURE["cli"] = {"bitwise": same, "captured_s": t0,
                            "no_capture_s": t1}
    print(f"cli train: captured against --no-capture, 60 steps across the "
          f"resume: losses and final checkpoint bitwise equal: {same}; "
          f"{t0:.1f} s against {t1:.1f} s [{card}]")
    shutil.rmtree(OUT / "train_ckpt_eager", ignore_errors=True)
    if not same:
        raise AssertionError(f"cli train: captured losses {l0} against "
                             f"--no-capture {l1}, or the checkpoints differ")


# ---------------------------------------------------------------------------
# phase 7b: serve_ckpt — serving the trained weights from a checkpoint
# ---------------------------------------------------------------------------

SERVE_CKPT_ARGV = ["--arch", "stablelm_3b", "--requests", "8", "--slots",
                   "4", "--prompt-len", "48", "--tokens", "32",
                   "--serve-mode", "greedy", "--kv-block-size", "16"]
SERVE_CKPT = {}


def serve_ckpt(params, fns, card) -> dict:
    """Save full-size stablelm_3b's trained ``params`` with
    ``checkpoint.save``, serve them through the serve CLI's ``--ckpt-dir``
    (paged greedy, 8 requests): (a) the params it served are bitwise the
    trained ones; (b) each request's first token is the argmax of one eager
    prefill of the trained params on its prompt (up to a GAP_TOL
    near-tie); (c) paged-attention launches = layers x decode-shape
    forwards.  Then serve the tiny checkpoint of the train CLI phase
    (``params`` + ``opt``) with ``--algorithm greedy --batch 2``.  Returns
    the launches of both runs (``fns``: the kernel wrappers by short
    name; ``serve`` counts each run from 0)."""
    import shutil
    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config
    from repro_torch.serving import DecodeEngine
    cfg = get_config("stablelm_3b")
    ckpt = OUT / "serve_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    _, save_s = _timed(lambda: save(str(ckpt), TRAIN_STEPS,
                                    {"params": params},
                                    {"step": TRAIN_STEPS}))
    argv = SERVE_CKPT_ARGV + ["--ckpt-dir", str(ckpt)]
    print("cli serve_ckpt: python -m repro_torch.launch.serve "
          + " ".join(argv), flush=True)
    out = run_cli(argv)
    launches = {k: fn.launches for k, fn in fns.items()}
    shutil.rmtree(ckpt, ignore_errors=True)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(_leaves(out["params"]), _leaves(params)))
    if not same or len(list(_leaves(out["params"]))) != len(
            list(_leaves(params))):
        raise AssertionError("serve_ckpt: the served params differ from "
                             "the trained ones")
    # (b) one eager prefill of all 8 prompts
    prompts, streams = out["prompts"], out["streams"]
    eng = DecodeEngine(cfg, params, batch=len(prompts), max_len=MAX_LEN,
                       device="cuda", capture=False)
    rids = sorted(prompts)
    logits = eng.prefill(torch.as_tensor(np.stack([prompts[r] for r in rids]),
                                         device="cuda")).float()
    first = torch.argmax(logits, dim=-1).tolist()
    gaps = top2_gap(logits).tolist()
    for i, r in enumerate(rids):
        if streams[r][0] != first[i] and gaps[i] > GAP_TOL:
            raise AssertionError(f"serve_ckpt: request {r}'s first token "
                                 f"{streams[r][0]} is not the prefill's "
                                 f"argmax {first[i]} (top-2 gap "
                                 f"{gaps[i]:.4g})")
    parted = [r for i, r in enumerate(rids) if streams[r][0] != first[i]]
    del eng, logits
    # (c)
    loop, s = out["loop"], out["stats"]
    hits = sum(1 for e in loop.engine.prefill_log[loop._prefill_log_start:]
               if e.get("cached_tokens", 0) > 0)
    want = kernel_layers(cfg)["attn"] * (s["forwards"] + hits)
    if launches != {"dense": 0, "paged": want, "moe": 0, "scan": 0}:
        raise AssertionError(f"serve_ckpt: attention launches {launches}, "
                             f"expected paged {want} ({cfg.n_layers} layers "
                             f"x {s['forwards']} forwards + {hits} "
                             f"prefix-hit forwards)")
    tok_s = s["tokens"] / out["seconds"]
    SERVE_CKPT.update(gb=n_bytes / 1e9, save_s=save_s,
                      restore_s=out["restore_s"], tok_s=tok_s)
    print(f"serve_ckpt {cfg.name}: {n_bytes / 1e9:.2f} GB of trained bf16 "
          f"params saved in {save_s:.1f} s ({n_bytes / 1e9 / save_s:.2f} "
          f"GB/s), restored onto the card in {SERVE_CKPT['restore_s']:.1f} "
          f"s; served bitwise the trained params: {same}; first tokens "
          f"equal an eager prefill's argmax for "
          f"{len(rids) - len(parted)} of {len(rids)} requests (the rest at "
          f"top-2 gaps <= {GAP_TOL:.4g}); {s['requests']} requests, "
          f"{s['tokens']} tokens, {s['forwards']} forwards in "
          f"{out['seconds']:.3f} s, {tok_s:.1f} tok/s; launches {launches} "
          f"[{card}]")
    del out, loop
    gc.collect()
    torch.cuda.empty_cache()
    # the train CLI phase's tiny checkpoint: params and AdamW state
    for fn in fns.values():
        fn.launches = 0
    tokens = 32
    argv = ["--arch", "stablelm_3b", "--tiny", "--ckpt-dir",
            str(OUT / "train_ckpt"), "--algorithm", "greedy", "--batch", "2",
            "--tokens", str(tokens)]
    print("cli serve_ckpt tiny: python -m repro_torch.launch.serve "
          + " ".join(argv), flush=True)
    tiny = run_cli(argv)
    tiny_cfg = get_config("stablelm_3b", reduced=True)
    tiny_launches = {k: fn.launches for k, fn in fns.items()}
    want = {"dense": kernel_layers(tiny_cfg)["attn"] * (tokens - 1),
            "paged": 0, "moe": 0, "scan": 0}
    streams = tiny["streams"]
    if streams.shape != (2, tokens) or tiny_launches != want:
        raise AssertionError(f"serve_ckpt tiny: streams {streams.shape}, "
                             f"launches {tiny_launches}, expected {want}")
    print(f"serve_ckpt {tiny_cfg.name} from the train CLI's checkpoint: 2 "
          f"rows x {tokens} tokens in {tiny['seconds']:.3f} s, launches "
          f"{tiny_launches} [{card}]")
    return {"serve_ckpt": launches, "serve_ckpt_tiny": tiny_launches}


# ---------------------------------------------------------------------------
# phase 7c: examples — the four drivers of repro_torch.examples
# ---------------------------------------------------------------------------

EXAMPLES = {}
TRAIN_LM_STEPS = (40, 60)
TRAIN_LM_EVERY = 20
TRAIN_LM_EAGER_STEPS = 8      # --no-capture steps timed beside the captured


def example_nfp_survey(card) -> None:
    """Its H100 rows equal ``predict_model`` on ``core.hardware.H100``."""
    from repro_torch.core import GranularitySpec, predict_model
    from repro_torch.core.hardware import H100
    from repro_torch.configs import get_config
    from repro_torch.examples import nfp_survey
    rows, dt = _timed(lambda: nfp_survey.main([]))
    h100 = [r for r in rows if r[1] == "h100"]
    for arch, _, b, ell, p in h100:
        cfg = get_config(arch)
        want = predict_model(cfg, H100, GranularitySpec.for_backend(
            cfg.ffn.n_experts), b, ell)
        if (p.n_max, p.limiting, p.n_idle) != (want.n_max, want.limiting,
                                               want.n_idle):
            raise AssertionError(f"nfp_survey {arch} b={b} L={ell}: {p}")
    EXAMPLES["nfp_survey"] = {"s": dt, "rows": len(rows)}
    print(f"example nfp_survey: {len(rows)} rows, the {len(h100)} H100 rows "
          f"equal predict_model on core.hardware.H100; {dt:.2f} s [{card}]")


@contextlib.contextmanager
def plain_kernels(ops, moe_ops):
    """Inside the block the model's dense decode attention and its MoE FFN
    call their kernels' plain versions (``decode_attention_ref``,
    ``grouped_ffn_ref``) on the card's tensors, in place of the kernels:
    the same function on the same inputs."""
    import repro_torch.models.attention as attn_mod
    kernel_attn, kernel_moe = (attn_mod.decode_attention_ragged,
                               moe_ops.grouped_ffn_padded)

    def moe_plain(*args, blocks=None, **kw):
        return moe_ops.grouped_ffn_ref(*args, **kw)
    moe_plain.launches = 0         # a captured forward reads the counter
    attn_mod.decode_attention_ragged = ops.decode_attention_ref
    moe_ops.grouped_ffn_padded = moe_plain
    try:
        yield
    finally:
        attn_mod.decode_attention_ragged = kernel_attn
        moe_ops.grouped_ffn_padded = kernel_moe


class RouteTape:
    """Inside the block ``models.moe.route_topk`` records each call's
    (weights, idx, probs), or, given a tape, returns its calls in order
    instead of routing (the same experts and weights in another run)."""

    def __init__(self, moe_mod, replay=None):
        self.mod, self.replay, self.calls = moe_mod, replay, []

    def __enter__(self):
        self.inner = self.mod.route_topk

        def route(router_w, x, k):
            out = (self.inner(router_w, x, k) if self.replay is None
                   else self.replay[len(self.calls)])
            self.calls.append(out)
            return out
        self.mod.route_topk = route
        return self

    def __exit__(self, *exc):
        self.mod.route_topk = self.inner


def example_quickstart(ops, moe_ops, card) -> None:
    """The tiny llada forwards reach the MoE kernel (its shapes are held
    elementwise against the plain version in the kernel phase,
    ``LLADA_TINY_MOE``).  The decode logits are held normwise within
    MOE_FORWARD_RTOL, as ``check_forward`` holds an MoE forward, under the
    kernel run's routing (``RouteTape``): against the same engine through
    the kernels' plain versions on the card, and against the engine with
    ``use_kernel=False`` (the reference's XLA path: bf16 expert products, h
    rounded to bf16)."""
    from repro_torch.examples import quickstart
    from repro_torch.models import moe
    from repro_torch.serving import DecodeEngine
    before = moe_ops.grouped_ffn_padded.launches
    with RouteTape(moe) as tape:
        out, dt = _timed(lambda: quickstart.main([]))
    launches = moe_ops.grouped_ffn_padded.launches - before
    small = out["small"]
    want = kernel_layers(small)["moe"] * 2     # prefill + decode
    if launches != want or not out["use_kernel"]:
        raise AssertionError(f"quickstart: MoE kernel launches {launches}, "
                             f"expected {want}")

    def logits(use_kernel):
        with RouteTape(moe, tape.calls):
            eng = DecodeEngine(small, out["params"], batch=1,
                               max_len=quickstart.MAX_LEN, device="cuda",
                               use_kernel=use_kernel)
            eng.prefill(torch.as_tensor(out["prompt"], device="cuda"))
            return eng.decode_step(torch.as_tensor(out["draft"],
                                                   device="cuda")).float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    got = out["logits"].float()
    with plain_kernels(ops, moe_ops):
        ref = logits(True)
    xla = logits(False)
    errs = {"plain": rel(got, ref), "no_kernel": rel(got, xla)}
    if not torch.isfinite(got).all() or max(errs.values()) > MOE_FORWARD_RTOL:
        raise AssertionError(f"quickstart: kernel logits leave the plain "
                             f"forwards (relative errors {errs})")
    EXAMPLES["quickstart"] = {
        "s": dt, "budget": out["budget"], "n": out["n"],
        "moe_launches": launches, "logits_rel_err": errs,
        "logits_max_abs_err": float((got - ref).abs().max())}
    print(f"example quickstart: budget {out['budget']}, N {out['n']}, "
          f"{launches} MoE kernel launches (d 64, f 32, E 16, top-2); "
          f"logits {tuple(got.shape)} under the kernel run's routing, "
          f"relative error against the kernels' plain versions "
          f"{errs['plain']:.4g} (max abs err "
          f"{float((got - ref).abs().max()):.4g}) and against "
          f"use_kernel=False {errs['no_kernel']:.4g} (limit "
          f"{MOE_FORWARD_RTOL}); {dt:.2f} s [{card}]")


def example_serve_parallel_decode(ops, card) -> None:
    """Speculative is lossless against AR on the attention kernel."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_parallel_decode as spd
    before = ops.decode_attention_ragged.launches
    out, dt = _timed(lambda: spd.main([]))
    launches = ops.decode_attention_ragged.launches - before
    layers = kernel_layers(get_config(spd.ARCH, reduced=True))["attn"]
    if not out["lossless"] or not launches or launches % layers:
        raise AssertionError(f"serve_parallel_decode: lossless "
                             f"{out['lossless']}, attention launches "
                             f"{launches}")
    modes = {"ar": (out["ar"]["forwards"], out["ar"]["seconds"])}
    for mode in ("speculative", "diffusion"):
        modes[mode] = (out[mode]["stats"]["forwards"], out[mode]["seconds"])
    EXAMPLES["serve_parallel_decode"] = {
        "s": dt, "attn_launches": launches,
        **{f"{m}_tok_per_fwd": spd.TOKENS / f for m, (f, _) in modes.items()},
        **{f"{m}_s": t for m, (_, t) in modes.items()}}
    print(f"example serve_parallel_decode: lossless {out['lossless']}, "
          f"{launches} dense attention launches; " + ", ".join(
              f"{m} {spd.TOKENS / f:.2f} tok/fwd in {t:.3f} s"
              for m, (f, t) in modes.items()) + f"; {dt:.2f} s [{card}]")


def example_train_lm(card) -> None:
    """The 100M config for 40 steps (checkpoints at 20 and 40), then to 60
    from the same directory: resumes at 40, runs 20, the loss falls; its
    step replays a CUDA graph.  Then 8 ``--no-capture`` steps of the same
    model in another directory: their median step beside the captured
    one, their losses against the captured run's first 8."""
    import shutil
    from repro_torch.examples import train_lm
    d = OUT / "train_lm"
    shutil.rmtree(d, ignore_errors=True)
    runs = []
    t0 = time.perf_counter()
    for steps in TRAIN_LM_STEPS:
        argv = ["--steps", str(steps), "--ckpt-every", str(TRAIN_LM_EVERY),
                "--ckpt-dir", str(d)]
        print("example train_lm: python -m repro_torch.examples.train_lm "
              + " ".join(argv), flush=True)
        runs.append(train_lm.main(argv))
    dt = time.perf_counter() - t0
    first, second = runs
    shutil.rmtree(d, ignore_errors=True)
    argv = ["--steps", str(TRAIN_LM_EAGER_STEPS), "--ckpt-every",
            str(TRAIN_LM_EAGER_STEPS), "--ckpt-dir", str(d), "--no-capture"]
    print("example train_lm: python -m repro_torch.examples.train_lm "
          + " ".join(argv), flush=True)
    eager = train_lm.main(argv)
    shutil.rmtree(d, ignore_errors=True)
    eager_ms = 1e3 * statistics.median(eager["step_s"][2:])
    same = eager["losses"] == first["losses"][:TRAIN_LM_EAGER_STEPS]
    if (second["start"] != TRAIN_LM_STEPS[0]
            or len(second["losses"]) != TRAIN_LM_STEPS[1] - TRAIN_LM_STEPS[0]
            or not second["losses"][-1] < first["losses"][0]):
        raise AssertionError(f"train_lm: resumed at {second['start']} with "
                             f"{len(second['losses'])} steps, losses "
                             f"{first['losses'][0]:.4f} -> "
                             f"{second['losses'][-1]:.4f}")
    # steady steps: the first two of each run compile and warm up
    steady = first["step_s"][2:] + second["step_s"][2:]
    step_s = statistics.median(steady)
    tokens = 8 * 256
    EXAMPLES["train_lm"] = {"s": dt, "params": first["n_params"],
                            "step_ms": 1e3 * step_s,
                            "tokens_s": tokens / step_s,
                            "eager_step_ms": eager_ms,
                            "first_ms": 1e3 * first["step_s"][0],
                            **first["compiled"],
                            "eager_losses_bitwise": same,
                            "loss_first": first["losses"][0],
                            "loss_last": second["losses"][-1]}
    print(f"example train_lm {first['cfg'].name}: {first['n_params']:.4g} "
          f"parameters, batch 8 x 256, n_micro 2; loss "
          f"{first['losses'][0]:.4f} -> {second['losses'][-1]:.4f}; resumed "
          f"at step {second['start']} and ran {len(second['losses'])}; "
          f"median step (synchronized) captured {1e3 * step_s:.1f} ms, "
          f"{tokens / step_s:.0f} tokens/s; --no-capture in this call "
          f"{eager_ms:.1f} ms (median of steps 3-{TRAIN_LM_EAGER_STEPS}), "
          f"{tokens / eager_ms * 1e3:.0f} tokens/s, its losses bitwise the "
          f"captured run's first {TRAIN_LM_EAGER_STEPS}: {same}; first "
          f"captured step {1e3 * first['step_s'][0]:.1f} ms (eager "
          f"{first['compiled']['eager_s']:.2f} s, capture "
          f"{first['compiled']['capture_s']:.2f} s); both captured runs "
          f"{dt:.1f} s [{card}]")


def examples_phase(ops, moe_ops, card) -> None:
    example_nfp_survey(card)
    example_quickstart(ops, moe_ops, card)
    example_serve_parallel_decode(ops, card)
    example_train_lm(card)


# ---------------------------------------------------------------------------
# phase 8: dist — expert parallelism, the dry run's memory pass and the
# sharded train step on a one-rank NCCL group
# ---------------------------------------------------------------------------

DIST_EP = (("granite_moe_3b_a800m", GRANITE_MOE),
           ("mixtral_8x22b", MIXTRAL_MOE))
DIST_T = (4, 256)
DIST_DROP_CF = 0.25
# ep_moe_ffn rounds h and each pair's output to bf16, as the reference's
# does (the kernel keeps h in f32), and its batched products sum in
# another order than the plain moe_ffn's per-expert ones; the weighted
# combine of k such pairs can cancel, so an elementwise bound on the
# combined row does not hold (one bf16 ulp of a pair output at mixtral's
# width is 256).  Held normwise: against the plain moe_ffn (the same
# roundings) within one bf16 rounding, against the kernel path within two
DIST_EP_PLAIN_RTOL = 2.0 ** -8
DIST_EP_KERNEL_RTOL = 2 * 2.0 ** -8


def _normwise(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())
DIST_DECODE = ("stablelm_3b", 8, 4096)      # arch, batch, cache length
DIST_TRAIN_STEPS = 3
DIST = {}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dropped_on_host(idx, e, cap) -> int:
    """Pairs past their expert's capacity, counted in pair order on the
    host: the drops ``ep_moe_ffn`` makes."""
    counts = np.bincount(idx.reshape(-1), minlength=e)
    return int(np.maximum(counts - cap, 0).sum())


def dist_ep(moe, card) -> None:
    """(a) ``ep_moe_ffn`` against the CUDA MoE kernel path at granite's and
    mixtral's widths."""
    from repro_torch.core.arch import FFNSpec
    from repro_torch.dist.ep_moe import capacity, ep_moe_ffn, local_experts
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    counter = moe_ops.grouped_ffn_padded
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for arch, (e, k, d, f) in DIST_EP:
        spec = FFNSpec(kind="moe", d_ff=f, activation="swiglu", n_experts=e,
                       top_k=k)
        g = torch.Generator(device="cuda").manual_seed(20)
        params = {**moe_weights(e, d, f, seed=21),
                  "router": torch.randn((d, e), generator=g,
                                        device="cuda") * 0.02}
        local = local_experts(params, spec, 0, 1)
        for t in DIST_T:
            x = torch.randn((t, d), generator=g, device="cuda").to(
                torch.bfloat16)
            stats = {}
            out = ep_moe_ffn(local, spec, x, capacity_factor=e / k,
                             stats=stats)
            kernel, _ = moe.moe_ffn(params, spec, x, use_kernel=True)
            ref, _ = moe.moe_ffn(params, spec, x)
            diff = (out.float() - ref.float()).abs()
            to_plain = _normwise(out, ref)
            to_kernel = _normwise(out, kernel)
            if (not torch.isfinite(out).all()
                    or to_plain > DIST_EP_PLAIN_RTOL
                    or to_kernel > DIST_EP_KERNEL_RTOL
                    or int(stats["dropped"])):
                raise AssertionError(
                    f"dist ep {arch} T={t}: normwise against the plain "
                    f"moe_ffn {to_plain:.4g}, against the kernel path "
                    f"{to_kernel:.4g}, dropped {int(stats['dropped'])}")
            drop_stats = {}
            dropped = ep_moe_ffn(local, spec, x, capacity_factor=DIST_DROP_CF,
                                 stats=drop_stats)
            cap = capacity(DIST_DROP_CF, t, k, e)
            _, idx, _ = moe.route_topk(params["router"], x, k)
            want = dropped_on_host(idx.cpu().numpy(), e, cap)
            if (not torch.isfinite(dropped).all()
                    or int(drop_stats["dropped"]) != want):
                raise AssertionError(
                    f"dist ep {arch} T={t} cf {DIST_DROP_CF}: dropped "
                    f"{int(drop_stats['dropped'])}, host recount {want}")
            ep_ms = time_ms(lambda: ep_moe_ffn(local, spec, x,
                                               capacity_factor=e / k),
                            flush)
            # the timing's launches are not the path's: taken back out
            saved = counter.launches
            kernel_ms = time_ms(lambda: moe.moe_ffn(
                params, spec, x, use_kernel=True), flush)
            counter.launches = saved
            DIST[f"ep {arch} T={t}"] = {"ep_ms": ep_ms,
                                       "moe_ffn_kernel_ms": kernel_ms,
                                       "normwise_err_plain": to_plain,
                                       "normwise_err_kernel": to_kernel,
                                       "max_abs_err_plain": float(diff.max())}
            print(f"  dist ep {arch} (E {e}, top-{k}, d {d}, f {f}) T={t}: "
                  f"normwise err against the plain moe_ffn {to_plain:.4g} "
                  f"(limit {DIST_EP_PLAIN_RTOL:.4g}; max abs "
                  f"{float(diff.max()):.4g} of rows' rms "
                  f"{float(ref.float().pow(2).mean().sqrt()):.4g}), against "
                  f"moe_ffn(use_kernel=True) {to_kernel:.4g} (limit "
                  f"{DIST_EP_KERNEL_RTOL:.4g}); at capacity "
                  f"factor {DIST_DROP_CF} (capacity {cap}) {want} of {t * k} "
                  f"pairs dropped, as the host recount; ep_moe_ffn "
                  f"{ep_ms:.4f} ms, moe_ffn with the kernel {kernel_ms:.4f} "
                  f"ms [{card}]")
        del params, local
        gc.collect()
        torch.cuda.empty_cache()


def dist_memory(mesh, card) -> None:
    """(b) the dry run's decode cell, materialised on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.arch import ShapeSpec
    from repro_torch.core.tree import leaves
    from repro_torch.dist.sharding import shard_bytes
    from repro_torch.launch.specs import build_cell, materialize
    arch, b, s = DIST_DECODE
    shape = ShapeSpec(f"decode_{s}", s, b, "decode")
    _, args, in_ps, _ = build_cell(get_config(arch), shape, mesh)
    want = shard_bytes(args, in_ps, mesh)
    n_leaves = len(leaves(args))
    gc.collect()
    torch.cuda.synchronize()
    requested = "requested_bytes.all.current"
    before = (torch.cuda.memory_allocated(),
              torch.cuda.memory_stats()[requested])
    real = materialize(args, in_ps, mesh, "cuda")
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before[0]
    asked = torch.cuda.memory_stats()[requested] - before[1]
    DIST["memory"] = {"argument_bytes": want, "requested_rise": asked,
                      "allocated_rise": rise, "leaves": n_leaves}
    print(f"  dist memory: decode_cell {arch} b {b} s {s} on a 1 x 1 mesh: "
          f"argument_bytes {want} ({want / 1e9:.3f} GB, {n_leaves} leaves); "
          f"the allocator's requested bytes rose {asked}, memory_allocated "
          f"{rise} (+{rise - want}) [{card}]")
    # the caching allocator rounds a block to 512 bytes, and hands a large
    # block out whole when what it would split off is 1 MiB or less
    if asked != want or not 0 <= rise - want <= n_leaves * (2 ** 20 + 512):
        raise AssertionError(f"dist memory: requested {asked}, allocated "
                             f"{rise}, the cell's argument_bytes {want}")
    del real


def dist_train(mesh, card) -> None:
    """(c) the sharded train step against the unsharded one at world 1."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.dist.sharded_train import (gather,
                                                make_sharded_train_step,
                                                state_placements)
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    cfg = get_config("stablelm_3b")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1,
                          total_steps=DIST_TRAIN_STEPS)
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    batches = [{"tokens": torch.as_tensor(next(data)["tokens"],
                                          device="cuda")}
               for _ in range(DIST_TRAIN_STEPS)]
    results = {}
    for label in ("unsharded", "sharded fsdp"):
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        state = {"params": params, "opt": init_opt_state(params)}
        del params
        if label == "unsharded":
            step = make_train_step(cfg, opt_cfg, n_micro=TRAIN_N_MICRO,
                                   remat=True)
        else:
            placements = state_placements(state, mesh, "fsdp")
            state = shard_tree(state, placements, mesh)
            step = make_sharded_train_step(
                cfg, opt_cfg, mesh, placements, TRAIN_BATCH, "fsdp",
                n_micro=TRAIN_N_MICRO, remat=True, params=state["params"])
        losses, times = [], []
        for b in batches:
            (state["params"], state["opt"], m), dt = _timed(
                lambda: step(state["params"], state["opt"], b))
            losses.append(m["loss"])
            times.append(dt)
        full = gather(state) if label != "unsharded" else state
        # the params and the f32 master: the unsharded run's kept on the
        # host (16.8 GB), the sharded run's compared leaf by leaf
        kept = leaves(full["params"]) + leaves(full["opt"]["master"])
        results[label] = {
            "losses": torch.stack(losses).cpu(),
            "step_ms": [1e3 * t for t in times],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if label == "unsharded":
            host = [t.detach().to("cpu", copy=True) for t in kept]
        else:
            same_state = all(torch.equal(t, h.to("cuda"))
                             for t, h in zip(kept, host))
        del state, full, step, kept
        gc.collect()
        torch.cuda.empty_cache()
    a, b = results["unsharded"], results["sharded fsdp"]
    same_loss = torch.equal(a["losses"], b["losses"])
    for label, r in results.items():
        DIST[f"train {label}"] = {"losses": r["losses"].tolist(),
                                  "step_ms": r["step_ms"],
                                  "peak_gb": r["peak_gb"]}
        print(f"  dist train {label}: stablelm_3b full size, "
              f"{DIST_TRAIN_STEPS} steps at {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"n_micro {TRAIN_N_MICRO}, remat True: losses "
              + ", ".join(f"{x:.6f}" for x in r["losses"].tolist())
              + "; step ms " + ", ".join(f"{t:.1f}" for t in r["step_ms"])
              + f"; memory peak {r['peak_gb']:.2f} GB [{card}]")
    print(f"  dist train: sharded (fsdp, 1 x 1 mesh, one NCCL rank) against "
          f"unsharded: losses bitwise equal {same_loss}, final params and "
          f"f32 master ({len(host)} leaves) bitwise equal {same_state} "
          f"[{card}]")
    if not (same_loss and same_state):
        raise AssertionError("dist train: the sharded steps differ from the "
                             "unsharded ones at world 1")


def dist_phase(moe, card) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        dist_ep(moe, card)
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        dist_memory(mesh, card)
        gc.collect()
        torch.cuda.empty_cache()
        dist_train(mesh, card)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 9: tp — tensor-parallel training on two gloo ranks on the one card,
# and the aligned-rows decode-attention entry
# ---------------------------------------------------------------------------

TP_LAYERS = 4             # full-width stablelm_3b cut to 4 of its 32 layers
TP_STEPS = 3
TP_LOSS_RTOL = 2e-3
TP_NORM_RTOL = 1e-2
TP_BYTES_SHARE = 0.55     # a rank's gathered params / the one process's
TP_PHASE_S = 60.0
TP_TIMEOUT_S = 300
# the two ranks' mesh (data, model) per run of the worker
TP_MESH = {"tp": (1, 2), "fsdp": (2, 1)}
# the fsdp and fsdp_decode runs, at once: they move ~27 GB and ~50 GB
# through gloo, which carries ~1 GB/s between two processes on one card
FSDP_PHASE_S = 150.0
FSDP_DECODE_LAYERS = 4    # full-width falcon_mamba_7b cut to 4 of its 64
FSDP_ROWS, FSDP_PROMPT, FSDP_DECODES = 4, 48, 8
FSDP_DECODE_RTOL = 1e-4   # normwise, f32
TP = {}


def tp_config(layers=TP_LAYERS, reduced=False):
    from repro_torch.configs import get_config
    cfg = get_config("stablelm_3b", reduced=reduced)
    return cfg if reduced else dataclasses.replace(cfg, n_layers=layers)


def tp_batches(cfg, device):
    from repro_torch.data import DataConfig, make_pipeline
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    return [{"tokens": torch.as_tensor(next(data)["tokens"], device=device)}
            for _ in range(TP_STEPS)]


def tp_opt_config():
    from repro_torch.training import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TP_STEPS)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _start_ranks(target: str, out: Path, device: str, reduced: bool,
                 *extra, threads: int = 4) -> list:
    """Start ``chip_smoke.<target>(rank, port, out, device, reduced,
    *extra)`` as two processes (gloo over ``device`` tensors on the one
    card); ``_ranks_results`` waits for them."""
    port = free_port()
    env = {**__import__("os").environ,
           "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
           "OMP_NUM_THREADS": str(threads)}
    args = "".join(f", {a!r}" for a in (str(out), device, reduced, *extra))
    return [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.OUT = c.Path({str(OUT)!r}); "
         f"c.{target}({r}, {port}{args})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]


def _ranks_results(procs: list, target: str) -> list:
    """Each rank's ``TP_RESULT::`` JSON of ``_start_ranks``' processes,
    which are waited for (at most ``TP_TIMEOUT_S``) and stopped."""
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"{target} rank {r} failed (exit "
                                 f"{p.returncode}):\n{text[-4000:]}")
    return [json.loads(next(ln for ln in text.splitlines()
                            if ln.startswith("TP_RESULT::"))[11:])
            for text in texts]


def _count_collectives(counts: dict) -> None:
    """Count ``tensor_parallel``'s all-gathers and reduce-scatters (and
    the bytes they return) into ``counts``."""
    from repro_torch.dist import tensor_parallel as tp
    for name in ("all_gather", "reduce_scatter"):
        real = getattr(tp, name)

        def counted(t, dim, group, size, _real=real, _name=name):
            got = _real(t, dim, group, size)
            counts[_name] = counts.get(_name, 0) + 1
            counts[_name + "_bytes"] = counts.get(_name + "_bytes", 0) + \
                got.numel() * got.element_size()
            return got
        setattr(tp, name, counted)


def _gathered_bytes_bound(params, layout, mesh, n_layers: int) -> dict:
    """{"stored", "outside", "layer"}: this rank's stored param bytes,
    the bytes of the leaves outside the layers as a layer computes with
    them, and one layer's."""
    import math
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.dist.sharding import block_of
    work = tree_map(lambda t, s, pl: math.prod(block_of(s, mesh, pl)[0])
                    * t.element_size(), params, layout.shapes, layout.work)
    layer = outside = 0
    for path, n in leaves_with_paths(work):
        if path[0] == "segments":
            layer += n // n_layers
        else:
            outside += n
    stored = sum(t.to_local().numel() * t.element_size()
                 for _, t in leaves_with_paths(params))
    return {"stored": stored, "outside": outside, "layer": layer}


def tp_worker(rank: int, port: int, out: str, device: str = "cuda",
              reduced: bool = False, mode: str = "tp") -> None:
    """One of the two ranks of the sharded run ``mode``, in a process of
    its own: gloo over ``device`` tensors on a (data 1, model 2) mesh
    (``tp``) or a (data 2, model 1) mesh (``fsdp``: each layer's params
    gathered over the data axis as it runs, the gradients reduce-scattered
    back), fsdp sharding, ``TP_STEPS`` sharded steps from the seeded init;
    prints its result as one ``TP_RESULT::`` JSON line (losses, grad
    norms, step times, the param bytes its forward reads, its high-water
    mark of stored plus gathered param bytes and the bound on it, its
    collectives, its memory peak, and the largest difference of its final
    param shards from the one-process run's in ``out``)."""
    import math
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.tree import (leaves, leaves_with_paths, path_key,
                                       tree_map)
    from repro_torch.dist import layer_gather as lg
    from repro_torch.dist.sharded_train import (make_sharded_train_step,
                                                state_placements)
    from repro_torch.dist.tensor_parallel import tp_plan
    from repro_torch.dist.sharding import block_of, shard_tree
    from repro_torch.models import init_model
    from repro_torch.training import init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh(torch.device(device).type, TP_MESH[mode],
                                mesh_dim_names=("data", "model"))
        cfg = tp_config(reduced=reduced)
        params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                            device)
        state = {"params": params, "opt": init_opt_state(params)}
        del params
        placements = state_placements(state, mesh, "fsdp")
        state = shard_tree(state, placements, mesh)
        step = make_sharded_train_step(
            cfg, tp_opt_config(), mesh, placements, TRAIN_BATCH, "fsdp",
            n_micro=TRAIN_N_MICRO, remat=True, params=state["params"])
        gc.collect()
        if torch.device(device).type == "cuda":
            # the peak of the steps, not of the whole init both ranks make
            # before taking their shards
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        layout = step.keywords["layout"]
        # the params the forward reads: this rank's model shards, and the
        # leaves the plan uses whole
        work_bytes = sum(leaves(tree_map(
            lambda t, s, pl: math.prod(block_of(s, mesh, pl)[0])
            * t.element_size(), state["params"], layout.shapes,
            layout.work)))
        bound = _gathered_bytes_bound(state["params"], layout, mesh,
                                      cfg.n_layers)
        counts = {}
        _count_collectives(counts)
        lg.reset_peak()
        losses, norms, times = [], [], []
        for b in tp_batches(cfg, device):
            _sync(device)
            t0 = time.perf_counter()
            state["params"], state["opt"], m = step(state["params"],
                                                    state["opt"], b)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        one = torch.load(Path(out) / "one.pt")
        diff = 0.0
        for path, t in leaves_with_paths(state["params"]):
            want = one[path_key(path)]
            shape, off = block_of(tuple(want.shape), mesh, t.placements)
            want = want[tuple(slice(o, o + n) for o, n in zip(off, shape))]
            got = t.to_local().detach().to("cpu")
            diff = max(diff, float((got.float() - want.float()).abs().max()))
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if torch.device(device).type == "cuda" else None)
        print("TP_RESULT::" + json.dumps({
            "rank": rank, "mode": mode, "mesh": TP_MESH[mode],
            "losses": losses, "grad_norms": norms,
            "step_ms": times, "gathered_param_bytes": work_bytes,
            "high_water_bytes": bound["stored"]
            + lg.gathered_bytes()["peak"],
            "high_water_bound": bound["stored"] + bound["outside"]
            + 2 * bound["layer"], **bound, "collectives": counts,
            "reduce_scatter": f"dist.reduce_scatter_tensor on "
                              f"{dist.get_backend()}",
            "peak_gb": peak, "max_abs_param_diff": diff,
            "tp_plan": tp_plan(cfg, TP_MESH[mode][1])}),
            flush=True)
    finally:
        dist.destroy_process_group()


def tp_train(card, device: str = "cuda", reduced: bool = False) -> None:
    """Sharded training on the card: the one-process ``train_step`` on
    4-layer full-width stablelm_3b, then the same steps from the same
    init and batches by two ranks (``tp_worker``) that split every
    attention head, ``d_ff`` column and vocabulary block between them
    (``tp``), held against it.  Leaves the one process's final params in
    ``<OUT>/tp/one.pt`` for ``fsdp_runs``."""
    from repro_torch.core.tree import leaves_with_paths, path_key
    from repro_torch.models import init_model
    from repro_torch.training import init_opt_state, make_train_step
    t_phase = time.perf_counter()
    cfg = tp_config(reduced=reduced)
    out = OUT / "tp"
    out.mkdir(parents=True, exist_ok=True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
    one_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    opt = init_opt_state(params)
    step = make_train_step(cfg, tp_opt_config(), n_micro=TRAIN_N_MICRO,
                           remat=True)
    losses, norms, times = [], [], []
    for b in tp_batches(cfg, device):
        _sync(device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else None)
    torch.save({path_key(p): t.detach().to("cpu")
                for p, t in leaves_with_paths(params)}, out / "one.pt")
    del params, opt, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ranks = _ranks_results(_start_ranks("tp_worker", out, device, reduced,
                                        "tp"), "tp_worker")
    seconds = time.perf_counter() - t_phase
    loss_err, norm_err = _first_errors(ranks, losses, norms)
    share = max(r["gathered_param_bytes"] for r in ranks) / one_bytes
    TP.update({"config": f"{cfg.name} {cfg.n_layers} layers, d "
                         f"{cfg.d_model}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
                         f"n_micro {TRAIN_N_MICRO}, remat True, bf16 params",
               "one_process": {"losses": losses, "grad_norms": norms,
                               "step_ms": times, "peak_gb": peak,
                               "param_bytes": one_bytes},
               "ranks": ranks, "first_loss_rel_err": loss_err,
               "first_grad_norm_rel_err": norm_err,
               "gathered_param_share": share, "seconds": seconds})
    print(f"  tp one process: {TP['config']}: losses "
          + ", ".join(f"{x:.6f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.5f}" for x in norms) + "; step ms "
          + ", ".join(f"{t:.1f}" for t in times)
          + f"; params {one_bytes} bytes; memory peak {peak} GB [{card}]")
    _print_train_ranks(ranks, one_bytes, card)
    print(f"  tp: first loss rel err {loss_err:.3g} (limit {TP_LOSS_RTOL}), "
          f"first grad norm rel err {norm_err:.3g} (limit {TP_NORM_RTOL}), "
          f"gathered param share {share:.3f} (limit {TP_BYTES_SHARE}), "
          f"phase {seconds:.1f} s (limit {TP_PHASE_S}) [{card}]")
    if not (loss_err <= TP_LOSS_RTOL and norm_err <= TP_NORM_RTOL
            and share <= TP_BYTES_SHARE and seconds <= TP_PHASE_S
            and all(np.isfinite(r["losses"]).all() for r in ranks)):
        raise AssertionError(f"tp: the two-rank run misses its bounds: "
                             f"{json.dumps({k: TP[k] for k in ('first_loss_rel_err', 'first_grad_norm_rel_err', 'gathered_param_share', 'seconds')})}")


def _first_errors(ranks, losses, norms) -> tuple:
    """(first loss, first grad norm) relative errors of the ranks against
    the one process's."""
    return (max(abs(r["losses"][0] - losses[0]) / abs(losses[0])
                for r in ranks),
            max(abs(r["grad_norms"][0] - norms[0]) / abs(norms[0])
                for r in ranks))


def _print_train_ranks(ranks, one_bytes: int, card) -> None:
    for r in ranks:
        print(f"  {r['mode']} rank {r['rank']} of 2 (gloo, mesh data x model "
              f"{r['mesh'][0]} x {r['mesh'][1]}): losses "
              + ", ".join(f"{x:.6f}" for x in r["losses"]) + "; grad norms "
              + ", ".join(f"{x:.5f}" for x in r["grad_norms"]) + "; step ms "
              + ", ".join(f"{t:.1f}" for t in r["step_ms"])
              + f"; gathered params {r['gathered_param_bytes']} bytes "
              f"({r['gathered_param_bytes'] / one_bytes:.3f} of one "
              f"process's); stored + gathered high-water mark "
              f"{r['high_water_bytes']} bytes (bound "
              f"{r['high_water_bound']}: stored {r['stored']} + outside "
              f"the layers {r['outside']} + 2 x a layer's {r['layer']}); "
              f"collectives {r['collectives']} ({r['reduce_scatter']}); "
              f"memory peak {r['peak_gb']} GB; largest final param "
              f"difference {r['max_abs_param_diff']:.4g}; plan "
              f"{r['tp_plan']} [{card}]")


def fsdp_decode_config(reduced: bool = False):
    from repro_torch.configs import get_config
    cfg = get_config("falcon_mamba_7b", reduced=reduced)
    if reduced:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=FSDP_DECODE_LAYERS,
        layer_pattern=cfg.layer_pattern[:FSDP_DECODE_LAYERS])


def fsdp_decode_run(params, cfg, device, rows=slice(None)) -> list:
    """The logits of a prefill of ``FSDP_ROWS`` seeded prompts of
    ``FSDP_PROMPT`` tokens, then of ``FSDP_DECODES`` one-position decode
    forwards of seeded tokens, on the kernels (``use_kernel=True``), for
    the prompts' ``rows``; on the host."""
    from repro_torch.models import forward, init_cache
    g = torch.Generator(device="cpu").manual_seed(24)
    prompt = torch.randint(0, cfg.vocab_size, (FSDP_ROWS, FSDP_PROMPT),
                           generator=g)[rows].to(device)
    steps = torch.randint(0, cfg.vocab_size, (FSDP_ROWS, FSDP_DECODES),
                          generator=g)[rows].to(device)
    cache = init_cache(cfg, prompt.shape[0], FSDP_PROMPT + FSDP_DECODES,
                       torch.float32, device)
    out = []
    with torch.no_grad():
        lg, cache, _, _ = forward(params, cfg, {"tokens": prompt},
                                  mode="prefill", cache=cache, cache_len=0,
                                  use_kernel=True)
        out.append(lg.to("cpu"))
        for i in range(FSDP_DECODES):
            lg, cache, _, _ = forward(params, cfg,
                                      {"tokens": steps[:, i:i + 1]},
                                      mode="decode", cache=cache,
                                      cache_len=FSDP_PROMPT + i,
                                      use_kernel=True)
            out.append(lg.to("cpu"))
    return out


def fsdp_decode_worker(rank: int, port: int, out: str, device: str = "cuda",
                       reduced: bool = False) -> None:
    """One of two ranks of a (data 2, model 1) mesh on the one card
    (gloo): falcon_mamba_7b's f32 params stored fsdp-sharded, each layer's
    gathered as it runs (``dist.layer_gather``), ``fsdp_decode_run`` on
    this rank's rows; prints one ``TP_RESULT::`` JSON line (the normwise
    error of its logits against the one process's rows, its scan
    launches, its high-water mark of stored plus gathered param bytes,
    its collectives, its time and memory peak)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import layer_gather as lg
    from repro_torch.dist.sharded_train import (gather_plan, local,
                                                step_layout)
    from repro_torch.dist.sharding import (param_pspecs,
                                           placements_from_pspecs,
                                           shard_tree)
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.models import init_model
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh(torch.device(device).type, (2, 1),
                                mesh_dim_names=("data", "model"))
        cfg = fsdp_decode_config(reduced)
        params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                            device, torch.float32)
        pl = placements_from_pspecs(param_pspecs(params, mesh, "fsdp"), mesh)
        params = shard_tree(params, pl, mesh)
        plan = gather_plan(step_layout(params, {"params": pl, "opt": {
            "master": pl}}, mesh, cfg, 1), mesh)
        shards = local(params)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        stored = sum(t.numel() * t.element_size() for t in _leaves(shards))
        per = FSDP_ROWS // 2
        counts = {}
        _count_collectives(counts)
        scan_ops.selective_scan_padded.launches = 0
        lg.reset_peak()
        _sync(device)
        t0 = time.perf_counter()
        with lg.gathering(plan, shards):
            got = fsdp_decode_run(shards, cfg, device,
                                  slice(rank * per, (rank + 1) * per))
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        want = torch.load(Path(out) / "decode_one.pt")
        err = max(float(torch.linalg.vector_norm(
            g - w[rank * per:(rank + 1) * per])
            / torch.linalg.vector_norm(w[rank * per:(rank + 1) * per]))
            for g, w in zip(got, want))
        print("TP_RESULT::" + json.dumps({
            "rank": rank, "rows": [rank * per, (rank + 1) * per],
            "normwise_err": err, "finite": all(
                bool(torch.isfinite(g).all()) for g in got),
            "scan_launches": scan_ops.selective_scan_padded.launches,
            "stored_bytes": stored,
            "high_water_bytes": stored + lg.gathered_bytes()["peak"],
            "collectives": counts, "ms": ms,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if torch.device(device).type == "cuda" else None)}),
            flush=True)
    finally:
        dist.destroy_process_group()


def fsdp_runs(card, device: str = "cuda", reduced: bool = False) -> int:
    """The two fsdp runs, their rank pairs at once: ``fsdp``, the
    ``tp_train`` steps by two ranks of a (data 2, model 1) mesh that store
    half of every param and gather each layer's as it runs, held against
    ``tp_train``'s one process; and ``fsdp_decode``, falcon_mamba_7b at
    full width and ``FSDP_DECODE_LAYERS`` layers in f32: this process's
    prefill and decode forwards on the kernels, then the same by two
    ranks on their rows, each layer gathered as it runs, each rank's
    logits held within ``FSDP_DECODE_RTOL`` (normwise) of its rows of
    this process's.  Returns the ranks' scan launches."""
    from repro_torch.models import init_model
    t_phase = time.perf_counter()
    cfg = fsdp_decode_config(reduced)
    out = OUT / "tp"
    out.mkdir(parents=True, exist_ok=True)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device, torch.float32)
    torch.save(fsdp_decode_run(params, cfg, device), out / "decode_one.pt")
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # four processes on the host's cores: two threads each
    train = _start_ranks("tp_worker", out, device, reduced, "fsdp",
                         threads=2)
    decode = _start_ranks("fsdp_decode_worker", out, device, reduced,
                          threads=2)
    try:
        fsdp = _ranks_results(train, "tp_worker")
        ranks = _ranks_results(decode, "fsdp_decode_worker")
    finally:
        for p in train + decode:
            p.kill()
            p.wait()
        for name in ("one.pt", "decode_one.pt"):
            (out / name).unlink(missing_ok=True)
    seconds = time.perf_counter() - t_phase
    one = TP["one_process"]
    loss_err, norm_err = _first_errors(fsdp, one["losses"],
                                       one["grad_norms"])
    want = (FSDP_DECODES + 1) * kernel_layers(cfg)["scan"]
    TP["fsdp"] = {"ranks": fsdp, "first_loss_rel_err": loss_err,
                  "first_grad_norm_rel_err": norm_err}
    TP["fsdp_decode"] = {"config": f"{cfg.name} {cfg.n_layers} layers, d "
                                   f"{cfg.d_model}, f32, {FSDP_ROWS} rows x "
                                   f"{FSDP_PROMPT} prompt + {FSDP_DECODES} "
                                   f"decode forwards, use_kernel=True",
                         "ranks": ranks}
    TP["fsdp_seconds"] = seconds
    _print_train_ranks(fsdp, one["param_bytes"], card)
    for r in ranks:
        print(f"  fsdp_decode rank {r['rank']} of 2 (gloo, data 2 x model "
              f"1), rows {r['rows']}: logits normwise err "
              f"{r['normwise_err']:.3g} (limit {FSDP_DECODE_RTOL}); scan "
              f"launches {r['scan_launches']} (expected {want}); stored + "
              f"gathered high-water mark {r['high_water_bytes']} bytes "
              f"(stored {r['stored_bytes']}); collectives "
              f"{r['collectives']}; {r['ms']:.1f} ms; memory peak "
              f"{r['peak_gb']} GB [{card}]")
    print(f"  fsdp: first loss rel err {loss_err:.3g} (limit "
          f"{TP_LOSS_RTOL}), first grad norm rel err {norm_err:.3g} (limit "
          f"{TP_NORM_RTOL}); fsdp_decode: {TP['fsdp_decode']['config']}; "
          f"both runs {seconds:.1f} s (limit {FSDP_PHASE_S}) [{card}]")
    if not (loss_err <= TP_LOSS_RTOL and norm_err <= TP_NORM_RTOL
            and all(r["high_water_bytes"] <= r["high_water_bound"]
                    and r["collectives"].get("reduce_scatter", 0) > 0
                    and np.isfinite(r["losses"]).all() for r in fsdp)):
        raise AssertionError(f"fsdp: the two-rank run misses its bounds: "
                             f"{json.dumps(TP['fsdp'])}")
    if not all(r["normwise_err"] <= FSDP_DECODE_RTOL and r["finite"]
               and r["scan_launches"] == want for r in ranks):
        raise AssertionError(f"fsdp_decode: a rank misses its bounds: "
                             f"{json.dumps(ranks)}")
    if seconds > FSDP_PHASE_S:
        raise AssertionError(f"fsdp: the two runs took {seconds:.1f} s "
                             f"(limit {FSDP_PHASE_S})")
    return sum(r["scan_launches"] for r in ranks)


def check_aligned(ops, card) -> float:
    """The aligned-rows entry ``decode_attention`` (every row at
    ``total_len - n``) at stablelm_3b's serving shapes, n = 1 and 16,
    against ``decode_attention_ref``; returns the max abs error."""
    h, kv, dh, b, cache_len = 32, 32, 80, 4, 200
    err = 0.0
    for n in (1, 16):
        g = torch.Generator(device="cuda").manual_seed(40 + n)
        q = torch.randn((b, n, h, dh), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, MAX_LEN, kv, dh), generator=g,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        got = ops.decode_attention(q, k, v, cache_len + n)
        want = ops.decode_attention_ref(q, k, v, cache_len)
        e = (got.float() - want.float()).abs()
        err = max(err, float(e.max()))
        if (not torch.isfinite(got).all()
                or (e > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).any()):
            raise AssertionError(f"decode_attention (aligned) n={n}: max abs "
                                 f"err {float(e.max()):.4g}")
        print(f"  aligned decode_attention h {h} kv {kv} dh {dh} b {b} n {n} "
              f"total_len {cache_len + n}: max abs err {float(e.max()):.4g} "
              f"against decode_attention_ref [{card}]")
    return err


# the serving phases whose kernel launches the analysis phase records:
# decode attention in both modes, the MoE FFN, the scan
RECORDED = ("stablelm_3b", "granite_moe_3b_a800m", "falcon_mamba_7b")
ANALYSIS = {}


def analysis_gate(card) -> float:
    """``python -m repro_torch.analysis --check-baseline`` on this
    checkout, in a subprocess; fails on a new finding.  Returns its
    seconds."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--check-baseline"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    print(f"analysis: python -m repro_torch.analysis --check-baseline: rc "
          f"{proc.returncode}, {proc.stdout.strip().splitlines()[-1:]} "
          f"({dt:.1f} s) [{card}]")
    if proc.returncode != 0:
        raise AssertionError(f"analysis gate failed:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    return dt


def analysis_launches(recorder, card) -> float:
    """Every launch recorded during the RECORDED serving phases, checked:
    arity and kinds against the extern "C" lists (KC001), tiles within
    the kernels' limits (KC002), scalars equal to the launch-args
    functions at the recorded shapes and the model's geometry (KC003),
    launched tiles equal to the declared ones (GD002) and to the pinned
    contract.  Returns its seconds."""
    from repro_torch.analysis import baseline
    from repro_torch.analysis import granularity_drift as gd
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    records = recorder.records()
    findings = kc.check_recorded(records, {a: get_config(a)
                                           for a in RECORDED})
    contract = baseline.load_baseline(
        baseline.BASELINE_PATH)["granularity_contract"]
    launched = gd.launched_tiles(records)
    findings += gd.check_drift(contract, launched=launched)
    distinct = kc.distinct_configurations(records)
    for arch in RECORDED:
        mine = [r for r in records if r.label == arch]
        by_entry = kc.distinct_configurations(mine)
        print(f"analysis: {arch}: {sum(r.count for r in mine)} launches "
              "recorded, distinct launch configurations "
              + ", ".join(f"{e} {n}" for e, n in by_entry.items() if n)
              + f" [{card}]")
    print(f"analysis: distinct launch configurations per entry point "
          f"{distinct}; launched tiles "
          f"{ {k: sorted(v) for k, v in sorted(launched.items())} }, "
          f"pinned {contract} [{card}]")
    for f in findings:
        print(f"  {f.render()}")
    if findings:
        raise AssertionError(f"analysis: {len(findings)} finding(s) in "
                             "the recorded launches")
    missing = [e for e, n in distinct.items() if not n]
    off = {k: sorted(launched.get(k, ())) for k in contract
           if launched.get(k) != {contract[k]}}
    if missing or off:
        raise AssertionError(f"analysis: entry points never launched "
                             f"{missing}; tiles off the contract {off}")
    ANALYSIS.update(distinct)
    return time.perf_counter() - t0


# run-name prefix of a model's serving runs in the kernels line (the first
# word of the arch id, where that is unique)
RUN_PREFIX = {"phi3_medium_14b": "phi3medium",
              "phi3_vision_4p2b": "phi3vision"}


# moe_plain: the plain MoE path (one grouped product per weight) at the
# full-width layer shapes, (E, top-k, d_model, expert d_ff) by model;
# prefill 4 x 48 and decode 4 x 1 tokens
PLAIN_MOE = {"granite_moe_3b_a800m": GRANITE_MOE,
             "llada_mini_like": LLADA_MOE, "mixtral_8x22b": MIXTRAL_MOE}
PLAIN_MOE_T = {"prefill": 4 * 48, "decode": 4}
PLAIN_TRAIN_LAYERS = 8
PLAIN_TRAIN_STEPS = 4                         # timed, after one warm-up
# normwise: both plain paths round h to bf16, the kernel keeps it in f32
PLAIN_MASKED_NORM = 2.0 ** -8
# every leaf's gradient, grouped vs masked: bf16 gradients whose
# products sum in another order may differ by their last bit
PLAIN_GRAD_NORM = 2.0 ** -8
PLAIN_KERNEL_NORM = 2.0 ** -7
PLAIN_MOE_RESULTS = {}


def masked_ffn(x_sorted, params, group_sizes, activation, n_tokens=0):
    """The plain MoE FFN the port ran before its grouped products: every
    sorted row through every expert's FFN, each row keeping its own
    expert's by ``torch.where`` (O(M·E)); ``h`` rounded to x's type."""
    F = torch.nn.functional
    m = x_sorted.shape[0]
    expert_of_row = torch.searchsorted(
        torch.cumsum(group_sizes, 0, dtype=torch.int32),
        torch.arange(m, dtype=torch.int32, device=x_sorted.device),
        right=True)
    out = torch.zeros_like(x_sorted)
    for ei in range(group_sizes.shape[0]):
        up = x_sorted @ params["w_up"][ei]
        if activation == "swiglu":
            gate = x_sorted @ params["w_gate"][ei]
            h = (F.silu(gate.float()) * up.float()).to(x_sorted.dtype)
        else:
            h = F.gelu(up.float(), approximate="tanh").to(x_sorted.dtype)
        out = torch.where((expert_of_row == ei)[:, None],
                          h @ params["w_down"][ei], out)
    return out


@contextlib.contextmanager
def plain_moe_as(moe, fn):
    """``models.moe``'s plain expert FFN replaced by ``fn`` inside."""
    real, moe.plain_ffn = moe.plain_ffn, fn
    try:
        yield
    finally:
        moe.plain_ffn = real


def moe_layer_params(arch, seed=0) -> tuple:
    """(FFN spec, params) of one full-width MoE layer, bf16 experts and
    the f32 router, at the reference init's scales."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe
    cfg = get_config(arch)
    params = init_moe(torch.Generator(device="cuda").manual_seed(seed),
                      cfg.d_model, cfg.ffn)
    return cfg.ffn, params


def plain_moe_layers(moe, moe_ops, card) -> None:
    """The grouped plain path against the masked helper and against
    ``moe_ffn(use_kernel=True)`` (normwise both: the kernel keeps ``h`` in
    f32), ms each, at every model's
    full-width layer shapes; then llada's f32 route (the block-aligned
    product) and its memory."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device="cuda")
    for arch, (e, k, d, f) in PLAIN_MOE.items():
        spec, params = moe_layer_params(arch, seed=12)
        for label, t in PLAIN_MOE_T.items():
            x = (torch.randn((4, t // 4, d), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(t)) * 0.5).to(torch.bfloat16)
            launched = moe_ops.grouped_ffn_padded.launches
            grouped = moe.moe_ffn(params, spec, x)[0]
            kernel = moe.moe_ffn(params, spec, x, use_kernel=True)[0]
            if moe_ops.grouped_ffn_padded.launches != launched + 1:
                raise AssertionError(f"moe_plain {arch}: the kernel path "
                                     "launched no kernel")
            with plain_moe_as(moe, masked_ffn):
                masked = moe.moe_ffn(params, spec, x)[0]
            err = float((grouped.float() - masked.float()).abs().max())
            norms = (_normwise(grouped, masked), _normwise(grouped, kernel))
            if not (norms[0] <= PLAIN_MASKED_NORM
                    and norms[1] <= PLAIN_KERNEL_NORM):
                raise AssertionError(f"moe_plain {arch} {label}: grouped "
                                     f"vs masked {norms[0]:.3g}, vs the "
                                     f"kernel path {norms[1]:.3g} normwise")
            ms = {"grouped": time_ms(lambda: moe.moe_ffn(params, spec, x),
                                     flush),
                  "kernel": time_ms(lambda: moe.moe_ffn(
                      params, spec, x, use_kernel=True), flush)}
            with plain_moe_as(moe, masked_ffn):
                ms["masked"] = time_ms(lambda: moe.moe_ffn(params, spec, x),
                                       flush, iters=5)
            PLAIN_MOE_RESULTS[f"{arch} {label}"] = ms
            print(f"moe_plain {arch} {label} (T {t}, E {e}, top-{k}, d {d}, "
                  f"f {f}, bf16, moe_ffn with its router): grouped "
                  f"{ms['grouped']:.4f} ms, masked {ms['masked']:.4f} ms "
                  f"({ms['masked'] / ms['grouped']:.1f}x), kernel path "
                  f"{ms['kernel']:.4f} ms; grouped vs masked max abs err "
                  f"{err:.4g}, {norms[0]:.3g} normwise (limit "
                  f"{PLAIN_MASKED_NORM:.3g}), vs the kernel path "
                  f"{norms[1]:.3g} (limit {PLAIN_KERNEL_NORM:.3g}) "
                  f"[{card}]")
        if arch == "llada_mini_like":
            p32 = {key: v.float() for key, v in params.items()}
            for label, t in PLAIN_MOE_T.items():
                x = torch.randn((4, t // 4, d), device="cuda") * 0.5
                gc.collect()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = moe.moe_ffn(p32, spec, x)[0]
                torch.cuda.synchronize()
                extra = (torch.cuda.max_memory_allocated() - base) / 1e9
                ms32 = time_ms(lambda: moe.moe_ffn(p32, spec, x), flush,
                               iters=5)
                PLAIN_MOE_RESULTS[f"{arch} f32 {label}"] = {
                    "ms": ms32, "peak_gb": extra}
                print(f"moe_plain {arch} f32 {label} (T {t}; a CUDA tensor "
                      f"of f32 takes the block-aligned product): "
                      f"{ms32:.4f} ms, memory above the inputs "
                      f"{extra:.3f} GB, output finite "
                      f"{bool(torch.isfinite(out).all())} [{card}]")
            del p32
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _leaf_gap(got, want) -> float:
    """``_normwise``, or the difference's norm where ``want`` is zero."""
    diff = float((got.double() - want.double()).norm())
    norm = float(want.double().norm())
    return diff / norm if norm else diff


def plain_moe_no_sync(moe, card) -> None:
    """A forward and backward of one full-width granite MoE layer (bf16,
    its router) on the plain path under
    ``torch.cuda.set_sync_debug_mode("error")``: any host read raises."""
    spec, params = moe_layer_params("granite_moe_3b_a800m", seed=13)
    for v in params.values():
        v.requires_grad_()
    x = (torch.randn((4, 48, params["w_up"].shape[1]), device="cuda")
         * 0.5).to(torch.bfloat16)
    x.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_ffn(params, spec, x)
        (out.float().sum() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for name, v in params.items():
        if v.grad is None or not bool(torch.isfinite(v.grad).all()):
            raise AssertionError(f"moe_plain no-sync: {name} has no finite "
                                 "gradient")
    print(f"moe_plain granite_moe_3b_a800m layer forward + backward (x 4 x "
          f"48, bf16) under set_sync_debug_mode('error'): no host read; "
          f"every leaf's gradient finite [{card}]")


def plain_moe_train(moe, card) -> None:
    """One train step of granite at full width and ``PLAIN_TRAIN_LAYERS``
    of its 32 layers (batch 4 x 256, n_micro 1, remat True) on the grouped
    path and on the masked one, same weights and batch: the first loss
    of each, and each leaf's gradient (the worst leaf's normwise
    difference within ``PLAIN_GRAD_NORM``), then the median step ms and
    memory peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, grad_accum_fn,
                                      init_opt_state, make_train_step)
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"),
                              n_layers=PLAIN_TRAIN_LAYERS)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 256),
                                     generator=g, device="cuda")}
    first, grads = {}, {}
    for name, fn in (("grouped", moe.plain_ffn), ("masked", masked_ffn)):
        with plain_moe_as(moe, fn):
            tree, loss, _ = grad_accum_fn(params, cfg, batch, 1, 0.01, True)
        grads[name] = list(_leaves(tree))
        first[name] = (float(loss), float(torch.sqrt(sum(
            v.float().square().sum() for v in grads[name]))))
        del tree
    (l0, n0), (l1, n1) = first["grouped"], first["masked"]
    worst = max(_leaf_gap(a, b) for a, b in zip(grads["grouped"],
                                                grads["masked"]))
    del grads
    first["worst_leaf"] = worst
    if abs(l0 - l1) > 1e-2 * abs(l1) or not worst <= PLAIN_GRAD_NORM:
        raise AssertionError(f"moe_plain train: grouped loss {l0}, masked "
                             f"{l1}; worst leaf's gradient {worst:.3g} "
                             "normwise")
    step = make_train_step(cfg, AdamWConfig(lr=1e-4), n_micro=1, remat=True)
    res = {}
    for name, fn in (("grouped", moe.plain_ffn), ("masked", masked_ffn)):
        opt = init_opt_state(params)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with plain_moe_as(moe, fn):
            for _ in range(PLAIN_TRAIN_STEPS + 1):
                (params, opt, m), dt = _timed(lambda: step(params, opt,
                                                           batch))
                times.append(dt)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"moe_plain train {name}: loss "
                                 f"{float(m['loss'])}")
        res[name] = (1e3 * statistics.median(times[1:]),
                     torch.cuda.max_memory_allocated() / 1e9)
        del opt
    PLAIN_MOE_RESULTS["train"] = {**res, "first": first}
    print(f"moe_plain train granite_moe_3b_a800m ({PLAIN_TRAIN_LAYERS} of 32 "
          f"layers at full width, batch 4 x 256, n_micro 1, remat True): "
          f"first loss grouped {l0:.5f} / masked {l1:.5f}, grad norm "
          f"{n0:.5g} / {n1:.5g}, worst leaf's gradient {worst:.3g} "
          f"normwise (limit {PLAIN_GRAD_NORM:.3g}); step (median of "
          f"{PLAIN_TRAIN_STEPS}) "
          f"grouped {res['grouped'][0]:.1f} ms, masked "
          f"{res['masked'][0]:.1f} ms; memory peak grouped "
          f"{res['grouped'][1]:.2f} GB, masked {res['masked'][1]:.2f} GB "
          f"[{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def moe_plain_phase(moe, moe_ops, card) -> None:
    """The plain MoE path: layer shapes, no host read, a train step."""
    plain_moe_layers(moe, moe_ops, card)
    plain_moe_no_sync(moe, card)
    plain_moe_train(moe, card)


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
    # the geometries of NEW_GEOMETRIES at wedlm8b_like's serving lengths
    times_new = {arch: {n: time_kernels(ops, n, shape=shape,
                                        lens=wedlm["lens"])
                        for n in (1, 16)}
                 for arch, shape in NEW_GEOMETRIES.items()}
    for arch, by_n in times_new.items():
        h, kv, dh = NEW_GEOMETRIES[arch]
        for n, t in by_n.items():
            for mode, r in t.items():
                print(f"  {mode} n={n} {arch} (h {h}, kv {kv}, dh {dh}, g "
                      f"{h // kv}, lens {list(wedlm['lens'])}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                      f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"ms ({r['bound_by']}), executed-tile bound "
                      f"{r['tile_bound_ms']:.5f} ms [{card}]")
    for cell, r in time_cell_kernels(ops).items():
        print(f"  paged n=1 {cell} ({r['rows']} rows, mean length "
              f"{r['mean_len']:.1f}, longest {r['max_len']}, span of "
              f"{r['span']} pages, {r['spans']} blocks, rows split "
              f"{r['rows_split']:.3f}): kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it [{card}]")
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
    e, k, d, f = MIXTRAL_MOE
    mixtral_times = time_moe(moe_ops, moe, moe_weights(e, d, f, seed=10),
                             shape=MIXTRAL_MOE, runs=MIXTRAL_TIMES,
                             staircase=False)
    for label, r in mixtral_times.items():
        print(f"  moe mixtral_8x22b {label} (T {r['T']}, token_block "
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

    # the MoE checks at mixtral's width leave tens of GB cached; a graph
    # capture that had to give cached memory back would fail
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # 3b. the plain MoE path: one grouped product per weight
    t0 = time.perf_counter()
    moe_plain_phase(moe, moe_ops, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase moe_plain: {time.perf_counter() - t0:.1f} s [{card}]")

    # 4. analysis: the static gate now, the recorded launches after the
    # RECORDED serving phases
    from repro_torch.analysis.kernel_contracts import LaunchRecorder
    t_analysis = analysis_gate(card)
    recorder = LaunchRecorder()

    # 5. serving
    from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
    from repro_torch.serving import diffusion as diff_mod
    mods = (DecodeEngine, PagedKVConfig, ServingLoop, ops, moe_ops, moe,
            scan_ops, diff_mod)
    runs = {}
    for arch, serve, rtol in (
            ("stablelm_3b", functools.partial(
                serve_model, dense_speculative=True,
                prefill_pools=("dense", "paged"), prefill_single=True),
             FORWARD_RTOL),
            ("granite_moe_3b_a800m", functools.partial(
                serve_model, prefill_pools=("dense",)), MOE_FORWARD_RTOL),
            ("falcon_mamba_7b", functools.partial(serve_ssm,
                                                  prefill_check=True),
             SSM_FORWARD_RTOL),
            ("wedlm8b_like", functools.partial(
                serve_parallel, dense_block=16, prefill_pools=("paged",)),
             FORWARD_RTOL),
            ("llada_mini_like", functools.partial(
                serve_parallel, f32_layers=LLADA_F32_LAYERS),
             MOE_FORWARD_RTOL),
            ("minicpm3_4b", functools.partial(
                serve_model, layers=MINICPM3_LAYERS), FORWARD_RTOL),
            ("mixtral_8x22b", functools.partial(
                serve_model, layers=MIXTRAL_LAYERS, long_context=True),
             MOE_FORWARD_RTOL),
            ("starcoder2_3b", serve_light, FORWARD_RTOL),
            ("phi3_medium_14b", serve_light, FORWARD_RTOL),
            ("phi3_vision_4p2b", serve_light, FORWARD_RTOL),
            ("zamba2_1p2b", serve_ssm, FORWARD_RTOL),
            ("whisper_tiny", whisper_forward, FORWARD_RTOL)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        prefix = RUN_PREFIX.get(arch, arch.split("_")[0])
        recorder.label = arch
        with recorder if arch in RECORDED else contextlib.nullcontext():
            for run, launches in serve(mods, arch, card, rtol).items():
                runs[f"{prefix}_{run}"] = launches
        MEMORY[arch] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {arch}: {time.perf_counter() - t0:.1f} s, device "
              f"memory peak {MEMORY[arch]:.2f} GB [{card}]")
        if arch == RECORDED[-1]:
            t_analysis += analysis_launches(recorder, card)
            print(f"phase analysis: {t_analysis:.1f} s (the gate and the "
                  f"launch checks) [{card}]")

    # 6. the pinned trace replay, then calibrated serving, through the CLI
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

    # 7. training: no kernel on its path; the counts must stay 0
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    train_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_full(card)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_capture(card)
    TRAIN_BATCHES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    train_capture_moe(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_cli(card)
    runs["train"] = {k: fn.launches for k, fn in fns.items()}
    if any(runs["train"].values()):
        raise AssertionError(f"train: kernels launched {runs['train']}")
    print(f"phase train: {time.perf_counter() - t0:.1f} s, launches "
          f"{runs['train']} [{card}]")

    # 7b. serve_ckpt: the trained full-size params served from a
    # checkpoint (paged attention), then the train CLI's tiny checkpoint
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs.update(serve_ckpt(trained, fns, card))
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase serve_ckpt: {time.perf_counter() - t0:.1f} s, launches "
          f"{runs['serve_ckpt']} (tiny {runs['serve_ckpt_tiny']}), device "
          f"memory peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]")

    # 7c. examples: the MoE kernel (quickstart), dense attention
    # (serve_parallel_decode), training (train_lm: no kernel)
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    examples_phase(ops, moe_ops, card)
    runs["examples"] = {k: fn.launches for k, fn in fns.items()}
    if (not runs["examples"]["moe"] or not runs["examples"]["dense"]
            or runs["examples"]["paged"] or runs["examples"]["scan"]):
        raise AssertionError(f"examples: launches {runs['examples']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase examples: {time.perf_counter() - t0:.1f} s, launches "
          f"{runs['examples']} [{card}]")

    # 8. dist: the MoE kernel runs in (a)'s reference path
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    dist_phase(moe, card)
    runs["dist"] = {k: fn.launches for k, fn in fns.items()}
    if not runs["dist"]["moe"]:
        raise AssertionError(f"dist: the MoE kernel never ran "
                             f"{runs['dist']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase dist: {time.perf_counter() - t0:.1f} s, launches "
          f"{runs['dist']} [{card}]")

    # 9. tp: the aligned decode-attention entry (the dense kernel), then
    # tensor-parallel training (no kernel on its path)
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    aligned_err = check_aligned(ops, card)
    runs["aligned"] = {k: fn.launches for k, fn in fns.items()}
    if runs["aligned"]["dense"] != 2 or sum(runs["aligned"].values()) != 2:
        raise AssertionError(f"aligned: launches {runs['aligned']}")
    gc.collect()
    torch.cuda.empty_cache()
    for fn in fns.values():
        fn.launches = 0
    tp_train(card)
    runs["tp"] = {k: fn.launches for k, fn in fns.items()}
    if any(runs["tp"].values()):
        raise AssertionError(f"tp: kernels launched {runs['tp']}")
    gc.collect()
    torch.cuda.empty_cache()
    # the decode path with each layer gathered per forward: the scan
    # kernel in this process's forwards and in each rank's
    for fn in fns.values():
        fn.launches = 0
    rank_scans = fsdp_runs(card)
    runs["fsdp_decode"] = {k: fn.launches for k, fn in fns.items()}
    runs["fsdp_decode"]["scan"] += rank_scans
    if (not runs["fsdp_decode"]["scan"] or sum(runs["fsdp_decode"].values())
            != runs["fsdp_decode"]["scan"]):
        raise AssertionError(f"fsdp_decode: launches {runs['fsdp_decode']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase tp: {time.perf_counter() - t0:.1f} s, launches "
          f"{runs['tp']} (aligned entry {runs['aligned']}, fsdp_decode "
          f"{runs['fsdp_decode']}) [{card}]")

    # 10. report
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
            **{f"{RUN_PREFIX.get(arch, arch.split('_')[0])}_n{n}":
               {key: t[n][mode][key] for key in keys}
               for arch, t in times_new.items() for n in (1, 16)},
            "launch_floor_ms": floor,
            **({"aligned_entry_max_abs_err": aligned_err}
               if mode == "dense" else {}),
            "launch_configurations": ANALYSIS[f"decode_attention_{mode}"]})
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
        "mixtral_decode_T4": {key: mixtral_times["decode_router"][key]
                              for key in keys},
        "mixtral_prefill_T256": {key: mixtral_times["prefill_router"][key]
                                 for key in keys},
        "staircase_ms": {t: ms for t, (ms, _, _) in
                         moe_times["staircase"].items()},
        "launch_configurations": ANALYSIS["moe_ffn"]})
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
                         scan_times["staircase"].items()},
        "launch_configurations": ANALYSIS["mamba_scan"]})
    print("train summary: " + json.dumps(
        {"eager": {k: v for k, v in TRAIN.items()
                   if k not in ("losses", "grad_norms")},
         "captured": TRAIN_CAPTURE}))
    print("examples summary: " + json.dumps(EXAMPLES))
    print("serve_ckpt summary: " + json.dumps(SERVE_CKPT))
    print("dist summary: " + json.dumps(DIST))
    print("tp summary: " + json.dumps(TP))
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
