"""Speculative decoding in the scheduler — consumes the NFP position
budget.  The verification forward IS a multi-position decode forward
(paper Sec. G.1); n-gram drafts come free from the context, and greedy
prefix acceptance keeps the output identical to greedy decoding."""
from __future__ import annotations

import numpy as np

from repro_torch.serving.algorithm import SlotAdapter


def ngram_draft(context: np.ndarray, gamma: int, max_order: int = 3,
                vocab_size: int = 32000) -> np.ndarray:
    """Suffix-match n-gram draft: find the longest recent suffix that
    re-occurs earlier in the context and propose its continuation."""
    out = []
    ctx = list(context)
    for _ in range(gamma):
        prop = None
        for order in range(min(max_order, len(ctx) - 1), 0, -1):
            suffix = ctx[-order:]
            for i in range(len(ctx) - order - 1, -1, -1):
                if ctx[i:i + order] == suffix:
                    prop = ctx[i + order]
                    break
            if prop is not None:
                break
        if prop is None:
            prop = ctx[-1] if ctx else 0
        out.append(int(prop) % vocab_size)
        ctx.append(out[-1])
    return np.asarray(out, np.int64)


class SpeculativeSlotAdapter(SlotAdapter):
    """The remaining NFP budget is split evenly into per-request n-gram
    verification windows: a lone request gets the whole budget, a full
    house degrades to width 1.  Greedy prefix acceptance per row keeps
    every stream lossless."""

    mode = "speculative"

    def width(self, n_active: int, budget: int) -> int:
        w = max(1, budget // max(n_active, 1))
        return min(w, self.loop.max_width)

    def headroom(self) -> int:
        # the shared forward runs the uniform width over every row, so a
        # nearly-done row still needs draft headroom in its cache buffer
        return self.loop.max_width

    def propose(self, req, n: int) -> np.ndarray:
        return ngram_draft(np.append(req.context, req.pending), n,
                           vocab_size=self.loop.engine.cfg.vocab_size)
