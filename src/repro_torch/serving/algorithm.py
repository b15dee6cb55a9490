"""The scheduler-side propose -> verify -> commit protocol.

``SlotAdapter`` is driven ROW-WISE by ``ServingLoop``: every active
request fills its slot's row of ONE shared multi-position forward per
step, and the NFP budget is split across the rows.  The base class is
the greedy shape; ``speculative.SpeculativeSlotAdapter`` adds n-gram
drafts.  Greedy prefix acceptance keeps every stream identical to solo
greedy decoding.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.serving.engine import greedy_tokens

__all__ = ["SlotAdapter"]


class SlotAdapter:
    """Scheduler-side propose -> verify -> commit adapter.

    Subclass protocol:
      width(n_active, budget)  per-request block width for this step.
      headroom()               cache positions a slot needs beyond
                               prompt + max_tokens (admission check).
      begin(req, hidden)       after the request's slot is prefilled.
      propose(req, n)          length-<=n draft block for one row.
      observe(req, k, hidden)  after acceptance (k = accepted index).
      run_step(slots, width, budget)
                               the whole verify/commit drive.
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
