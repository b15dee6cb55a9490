"""The propose -> verify -> commit protocol shared by every parallel-
decoding family (speculative verification, MTP heads, diffusion block
refinement), at both serving granularities:

  ``ParallelDecodeAlgorithm``  the batch-1 driver: one request owns the
                               engine (and the whole NFP budget).
  ``SlotAdapter``              driven ROW-WISE by ``ServingLoop``: every
                               active request fills its slot's row of ONE
                               shared multi-position forward per step, and
                               the NFP budget is split across the rows.

The base classes are the greedy shape; ``speculative``, ``mtp`` and
``diffusion`` subclass them.  Greedy prefix acceptance keeps every
greedy, speculative and MTP stream identical to solo greedy decoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.serving import spans
from repro_torch.serving.engine import DecodeEngine, greedy_tokens

__all__ = ["DecodeStats", "ParallelDecodeAlgorithm", "SlotAdapter"]


@dataclass
class DecodeStats:
    """Position/forward accounting — the quantities NFP normalizes
    (paper Sec. J.2.3)."""

    tokens: int = 0
    forwards: int = 0
    positions: int = 0

    @property
    def tokens_per_forward(self) -> float:
        return self.tokens / max(self.forwards, 1)

    @property
    def position_utilization(self) -> float:
        return self.tokens / max(self.positions, 1)

    def as_dict(self) -> Dict:
        return {
            "tokens": self.tokens,
            "forwards": self.forwards,
            "positions": self.positions,
            "tokens_per_forward": self.tokens_per_forward,
            "position_utilization": self.position_utilization,
        }


@dataclass
class ParallelDecodeAlgorithm:
    """Propose -> verify -> commit driver over one dense DecodeEngine.

    Subclass protocol:
      parallel_width()         block width for the next step; the default
                               spends the engine's NFP budget (one
                               position is the pending token's).
      propose(ctx, pending, n) length-n candidate block (np.int64).
      resolve(pending, drafts) verify + commit; returns (the committed
                               tokens after ``pending``, the next pending
                               token).  Default: one multi-position
                               forward with greedy prefix acceptance.
      begin(prompt, pending)   after the prefill.
      observe(hidden, k)       the verify forward's final-norm hidden
                               states (1, n, d) and the accepted index k
                               whose logits gave the next pending token.
    """

    engine: DecodeEngine

    def __post_init__(self):
        self.stats = DecodeStats()

    # -- protocol ------------------------------------------------------
    def parallel_width(self) -> int:
        return max(1, self.engine.nfp_budget() - 1)

    def begin(self, prompt: np.ndarray, pending: int) -> None:
        pass

    def observe(self, hidden, k: int) -> None:
        pass

    def propose(self, context: np.ndarray, pending: int,
                n: int) -> np.ndarray:
        raise NotImplementedError

    def resolve(self, pending: int, drafts: np.ndarray
                ) -> Tuple[List[int], int]:
        """Greedy verification: accept the longest draft prefix the model
        reproduces, plus the model's own next token."""
        block = np.concatenate([[pending], drafts]).astype(np.int64)
        logits, new_cache, hidden = self.forward_block(block)
        # winners on the device; only the (n,) int32 block crosses
        preds = greedy_tokens(logits[0]).cpu().numpy()  # analysis: allow-host-sync
        k = 0
        while k < len(drafts) and preds[k] == drafts[k]:
            k += 1
        self.engine.commit(new_cache, 1 + k)
        self.observe(hidden, k)
        return list(drafts[:k]), int(preds[k])

    # -- shared machinery ----------------------------------------------
    def forward_block(self, block: np.ndarray):
        """One multi-position decode forward over ``block`` (every batch
        row), committing nothing; counts forwards and positions.  Returns
        (logits, new_cache, hidden)."""
        eng = self.engine
        toks = eng._tokens(block)[None].expand(eng.batch, len(block))
        logits, new_cache, hidden = eng.peek_step(toks)
        self.stats.forwards += 1
        self.stats.positions += len(block)
        return logits, new_cache, hidden

    def generate(self, prompt, max_tokens: int) -> Tuple[np.ndarray, Dict]:
        """Generate ``max_tokens`` for ``prompt`` ((1, p) or (b, p) tokens,
        every row the same request).  Returns (tokens, stats)."""
        eng = self.engine
        self.stats = DecodeStats()
        prompt = (prompt.to(eng.device) if isinstance(prompt, torch.Tensor)
                  else eng._tokens(prompt))
        logits = eng.prefill(prompt)
        pending = int(torch.argmax(logits[0]))
        context = prompt[0].cpu().numpy().astype(np.int64)
        generated: List[int] = [pending]
        self.begin(prompt.cpu().numpy(), pending)
        while len(generated) < max_tokens:
            n = min(self.parallel_width(), max_tokens - len(generated))
            drafts = self.propose(context, pending, n)
            committed, next_pending = self.resolve(pending, drafts)
            context = np.concatenate(
                [context, [pending], committed]).astype(np.int64)
            generated.extend(list(committed) + [next_pending])
            pending = next_pending
        self.stats.tokens = len(generated)
        return np.asarray(generated[:max_tokens]), self.stats.as_dict()


class SlotAdapter:
    """Scheduler-side propose -> verify -> commit adapter.

    Subclass protocol:
      width(n_active, budget)  per-request block width for this step.
      headroom()               cache positions a slot needs beyond
                               prompt + max_tokens (admission check).
      begin(req, hidden)       after the request's slot is prefilled;
                               ``hidden`` is the (d,) final-norm state of
                               its last prompt position.
      propose(req, n)          length-<=n draft block for one row.
      propose_rows(want)       drafts for many rows in one dispatch.
      observe(req, k, hidden)  after acceptance: k = accepted index,
                               ``hidden`` the row's (n, d) states.
      run_step(slots, width, budget)
                               the whole verify/commit drive; diffusion
                               overrides it (several shared forwards).
    """

    mode = "greedy"

    def __init__(self, loop):
        self.loop = loop

    # -- protocol ------------------------------------------------------
    def width(self, n_active: int, budget: int) -> int:
        return 1

    def headroom(self) -> int:
        return 0

    def begin(self, req, hidden) -> None:
        pass

    def propose(self, req, n: int) -> np.ndarray:
        return np.zeros((0,), np.int64)

    def propose_rows(self, want: Dict[int, int]) -> Dict[int, np.ndarray]:
        """Draft blocks for many rows at once: {slot: n} -> {slot: drafts}."""
        return {s: self.propose(self.loop.active[s], n)
                for s, n in want.items()}

    def observe(self, req, k: int, hidden) -> None:
        pass

    # -- default drive: propose / ONE shared forward / greedy accept ---
    def run_step(self, slots: List[int], width: int, budget: int) -> None:
        loop = self.loop
        eng = loop.engine
        tokens = np.zeros((eng.batch, width), np.int64)
        want: Dict[int, int] = {}
        for s in slots:
            req = loop.active[s]
            tokens[s, 0] = req.pending
            # clip each row's drafts to its remaining tokens
            n_draft = min(width - 1,
                          req.max_tokens - len(req.generated) - 1)
            if n_draft > 0:
                want[s] = n_draft
        drafts: Dict[int, np.ndarray] = {}
        for s, d in (self.propose_rows(want) if want else {}).items():
            d = np.asarray(d, np.int64)[:want[s]]
            if len(d):
                drafts[s] = d
                tokens[s, 1:1 + len(d)] = d
        logits, new_cache, hidden = loop.shared_forward(tokens, budget)
        # winners computed on the device; the one per-step device->host
        # transfer is this (batch, width) int32 block
        preds = np.asarray(greedy_tokens(logits).cpu())  # analysis: allow-host-sync
        loop.read_back(spans.COMMIT)
        advances = np.zeros((eng.batch,), np.int64)
        for s in slots:
            req = loop.active[s]
            k = 0
            d = drafts.get(s)
            if d is not None:
                while k < len(d) and preds[s, k] == d[k]:
                    k += 1
                req.generated.extend(int(t) for t in d[:k])
            bonus = int(preds[s, k])
            req.generated.append(bonus)
            advances[s] = 1 + k                  # pending + accepted drafts
            req.pending = bonus
            self.observe(req, k, hidden[s])
        eng.commit_slots(new_cache, advances)
