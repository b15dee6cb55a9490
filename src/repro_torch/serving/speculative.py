"""Speculative decoding — consumes the NFP position budget.  The
verification forward IS a multi-position decode forward (paper Sec. G.1);
greedy prefix acceptance keeps the output identical to greedy decoding.

Draft sources: suffix-match n-grams from the context (free), or, for the
single-request ``SpeculativeDecoder``, a second (smaller) DecodeEngine
kept in step with the committed stream: the tokens it has not seen ride
in the same decode forward that starts the next draft.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.serving.algorithm import (ParallelDecodeAlgorithm,
                                           SlotAdapter)
from repro_torch.serving.engine import DecodeEngine


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


@dataclass
class SpeculativeDecoder(ParallelDecodeAlgorithm):
    engine: DecodeEngine
    draft_engine: Optional[DecodeEngine] = None
    gamma: Optional[int] = None        # verification length; None -> NFP

    def parallel_width(self) -> int:
        if self.gamma is not None:
            return self.gamma
        # the NFP budget covers the whole forward: gamma drafts + pending
        return max(1, self.engine.nfp_budget() - 1)

    def begin(self, prompt: np.ndarray, pending: int) -> None:
        if self.draft_engine is not None:
            self.draft_engine.prefill(self.draft_engine._tokens(prompt))
            # tokens whose K/V the draft cache holds, in stream order
            self._draft_tokens: List[int] = [int(t) for t in prompt[0]]

    def _draft_propose(self, full: np.ndarray, gamma: int) -> np.ndarray:
        """Draft ``gamma`` tokens after resynchronising the draft cache
        with ``full`` (the committed context + pending): the shared prefix
        stays, the divergent tail (rejected drafts) is dropped by moving
        ``cache_len`` back, and the missing tokens go through ONE catch-up
        forward whose last logits give the first draft."""
        draft = self.draft_engine
        sync = 0
        for a, b in zip(self._draft_tokens, full):
            if a != int(b):
                break
            sync += 1
        draft.cache_len = sync
        self._draft_tokens = self._draft_tokens[:sync]
        chunk = np.asarray(full[sync:], np.int64)     # >= 1: pending is new
        toks = draft._tokens(chunk)[None].expand(draft.batch, len(chunk))
        logits = draft.decode_step(toks)
        self._draft_tokens.extend(int(t) for t in chunk)
        out: List[int] = []
        last = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for _ in range(gamma):
            out.append(int(last[0, 0]))
            if len(out) == gamma:
                break
            logits = draft.decode_step(last)
            self._draft_tokens.append(out[-1])
            last = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return np.asarray(out, np.int64)

    def propose(self, context: np.ndarray, pending: int,
                n: int) -> np.ndarray:
        full = np.append(context, pending)
        if self.draft_engine is not None:
            return self._draft_propose(full, n)
        return ngram_draft(full, n, vocab_size=self.engine.cfg.vocab_size)


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
