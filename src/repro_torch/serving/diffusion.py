"""Diffusion-style block decoding (WeDLM-like: causal attention + masked
iterative refinement) — the DLLM side of the paper's validation.

A block of N positions starts as [MASK] tokens and is refined over
``refine_steps`` decode forwards of N+1 positions (the pending token and
the block); each iteration freezes the most confident still-masked
positions.  The block size is the parallelism knob the NFP budget governs
(paper Sec. 6: "diffusion-style block size").

Confidence and argmax are reduced ON THE DEVICE (``confidence``): only a
(rows, N+1) pair of arrays crosses to the host per refinement forward, not
the (rows, N+1, vocab) logits.  The selection itself (``refine_block``)
stays on the host, in the reference's numpy order.

KV-commit rule: a refinement forward writes the block's K/V in place from
inputs that still hold mask tokens.  Every driver therefore ends a block
with one more forward over the fully resolved block, which overwrites all
of those positions, so the committed K/V equal a prefill of the resolved
stream.  Rows of a shared step that resolve early ride along in every
forward, the commit forward included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.algorithm import (ParallelDecodeAlgorithm,
                                           SlotAdapter)
from repro_torch.serving import spans
from repro_torch.serving.engine import DecodeEngine

Tensor = torch.Tensor


def confidence(logits: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., vocab) logits -> (conf, preds), each (...): the largest
    softmax probability in f32 and its token, as the reference computes
    them on the host (first maximum wins)."""
    lg = logits.float()
    probs = torch.exp(lg - lg.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    preds = torch.argmax(probs, dim=-1)
    return torch.gather(probs, -1, preds[..., None])[..., 0], preds


def refine_block(block: np.ndarray, resolved: np.ndarray, conf: np.ndarray,
                 preds: np.ndarray, per_iter: int) -> None:
    """One refinement update in place: freeze the ``per_iter`` most
    confident still-masked positions of ``block`` given each position's
    confidence and argmax (>= n entries; entry i predicts position i)."""
    n = len(block)
    conf, preds = conf[:n], preds[:n]
    cand = np.where(~resolved)[0]
    order = cand[np.argsort(-conf[cand])]
    pick = order[:per_iter]
    block[pick] = preds[pick]
    resolved[pick] = True


def pull_confidence(logits: Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """``confidence`` on the device, then the one transfer of a refinement
    forward: (..., n) f32 confidences and int64 tokens."""
    conf, preds = confidence(logits)
    both = torch.stack([conf.double(), preds.double()]).cpu().numpy()  # analysis: allow-host-sync
    return both[0].astype(np.float32), both[1].astype(np.int64)


@dataclass
class DiffusionBlockDecoder(ParallelDecodeAlgorithm):
    engine: DecodeEngine
    block_size: Optional[int] = None     # None -> NFP budget
    refine_steps: int = 4
    mask_id: Optional[int] = None        # None -> vocab_size - 1

    def __post_init__(self):
        super().__post_init__()
        if self.refine_steps < 1:
            raise ValueError(f"refine_steps must be >= 1, "
                             f"got {self.refine_steps}")

    def parallel_width(self) -> int:
        if self.block_size is not None:
            return self.block_size
        return max(1, self.engine.nfp_budget() - 1)

    def _mask_id(self) -> int:
        if self.mask_id is not None:
            return self.mask_id
        return self.engine.cfg.vocab_size - 1

    def propose(self, context: np.ndarray, pending: int,
                n: int) -> np.ndarray:
        return np.full((n,), self._mask_id(), np.int64)

    def resolve(self, pending: int, drafts: np.ndarray
                ) -> Tuple[List[int], int]:
        """Iterative refinement, then the commit forward over the fully
        resolved block (module docstring)."""
        n = len(drafts)
        block = np.asarray(drafts, np.int64).copy()
        resolved = np.zeros((n,), bool)
        # refine_steps x ceil(n / refine_steps) >= n: every position is
        # resolved by the last iteration
        per_iter = max(1, int(np.ceil(n / self.refine_steps)))
        for _ in range(self.refine_steps):
            if resolved.all():
                break
            logits, _, _ = self.forward_block(
                np.concatenate([[pending], block]))
            conf, preds = pull_confidence(logits[0])
            refine_block(block, resolved, conf, preds, per_iter)
        _, new_cache, _ = self.forward_block(
            np.concatenate([[pending], block]))
        self.engine.commit(new_cache, n)
        return list(block[:-1]), int(block[-1])


class DiffusionSlotAdapter(SlotAdapter):
    """Scheduler-side diffusion: every active request refines its own
    block, and each refinement iteration is ONE shared forward over all
    rows, so the budget split covers ``n_active * (block + 1)`` positions
    per forward and the block shrinks as concurrency grows.  The commit
    forward over the resolved blocks is shared too."""

    mode = "diffusion"

    def __init__(self, loop, block_size: Optional[int] = None,
                 refine_steps: int = 4, mask_id: Optional[int] = None):
        super().__init__(loop)
        if refine_steps < 1:
            raise ValueError(f"refine_steps must be >= 1, "
                             f"got {refine_steps}")
        self.block_size = block_size
        self.refine_steps = refine_steps
        self.mask_id = mask_id

    def _mask_id(self) -> int:
        if self.mask_id is not None:
            return self.mask_id
        return self.loop.engine.cfg.vocab_size - 1

    def width(self, n_active: int, budget: int) -> int:
        if self.block_size is not None:
            n = self.block_size
        else:
            # each refinement forward carries (block + 1) positions a row
            n = max(1, budget // max(n_active, 1) - 1)
        return min(n, self.loop.max_width)

    def headroom(self) -> int:
        # every forward writes block + 1 positions past a row's length
        return self.loop.max_width

    def run_step(self, slots: List[int], width: int, budget: int) -> None:
        loop = self.loop
        eng = loop.engine
        mask_id = self._mask_id()
        # per-row block sizes, clipped to each request's remaining tokens
        n: Dict[int, int] = {}
        blocks: Dict[int, np.ndarray] = {}
        resolved: Dict[int, np.ndarray] = {}
        for s in slots:
            req = loop.active[s]
            n[s] = max(1, min(width, req.max_tokens - len(req.generated)))
            blocks[s] = np.full((n[s],), mask_id, np.int64)
            resolved[s] = np.zeros((n[s],), bool)
        w = max(n.values())

        def block_tokens() -> np.ndarray:
            tokens = np.zeros((eng.batch, w + 1), np.int64)
            for s in slots:
                tokens[s, 0] = loop.active[s].pending
                tokens[s, 1:1 + n[s]] = blocks[s]
            return tokens

        # every row resolves within refine_steps forwards (ceil per row)
        for _ in range(self.refine_steps):
            if all(resolved[s].all() for s in slots):
                break
            logits, _, _ = loop.shared_forward(block_tokens(), budget)
            conf, preds = pull_confidence(logits)
            loop.read_back(spans.PLAN)
            for s in slots:
                if not resolved[s].all():
                    refine_block(blocks[s], resolved[s], conf[s], preds[s],
                                 max(1, -(-n[s] // self.refine_steps)))
        # the commit forward over the resolved blocks: the only K/V left
        # at the committed positions
        _, new_cache, _ = loop.shared_forward(block_tokens(), budget)
        loop.engine.phases.mark(spans.COMMIT)   # nothing to read back
        advances = np.zeros((eng.batch,), np.int64)
        for s in slots:
            req = loop.active[s]
            req.generated.extend(int(t) for t in blocks[s])
            advances[s] = n[s]                   # pending + block[:-1]
            req.pending = int(blocks[s][-1])
        eng.commit_slots(new_cache, advances)
