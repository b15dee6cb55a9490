"""Multi-token prediction (MTP) — the third parallel-decoding family the
paper abstracts (Sec. 7.1; Gloeckle et al. 2024, DeepSeek-V3).

A bank of ``n_heads`` linear heads (one per future offset) proposes the
next ``n_heads`` tokens from the LAST final-norm hidden state; the model
verifies them with ONE multi-position decode forward and accepts the
longest reproduced prefix, so the output equals greedy decoding.  The
prefill hands over the last prompt position's state, every verify forward
the state at the accepted index whose logits gave the new pending token.

The head product runs in float32, as the reference's (``hidden`` and the
bank cast to f32).  The decoders keep an f32 copy of the bank, made ONCE
when they are built (a bf16 bank of 4 heads at wedlm8b_like's width is
5.0 GB, its copy 10.0 GB): casting per call would materialise the copy
every step.  An f32 bank is used as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import _init
from repro_torch.serving.algorithm import (ParallelDecodeAlgorithm,
                                           SlotAdapter)
from repro_torch.serving.engine import DecodeEngine

Tensor = torch.Tensor


def init_mtp_heads(gen: torch.Generator, d_model: int, vocab: int,
                   n_heads: int, dtype=torch.bfloat16) -> Dict:
    """Random (n_heads, d_model, vocab) head bank at the reference's 0.02
    scale, drawn on the generator's device."""
    return {"heads": _init(gen, (n_heads, d_model, vocab), 0.02, dtype)}


def f32_bank(heads: Dict) -> Dict:
    """The bank with its leaf in float32 (the same tensor if it is)."""
    return {"heads": heads["heads"].float()}


def mtp_propose(heads: Dict, hidden: Tensor) -> Tensor:
    """hidden: (b, d) last-position hidden states -> (b, n_heads) int32
    greedy proposals for offsets +2 .. n_heads+1, in f32 on the device;
    only this small block is meant to cross to the host."""
    bank = heads["heads"].float()
    logits = torch.matmul(hidden.float()[None], bank)      # (h, b, v)
    return torch.argmax(logits, dim=-1).to(torch.int32).T


@dataclass
class MTPDecoder(ParallelDecodeAlgorithm):
    """Single-request MTP: propose with the head bank from the real last
    hidden state, verify with one multi-position forward, accept
    greedily."""

    engine: DecodeEngine
    heads: Dict
    n_predict: Optional[int] = None      # None -> min(n_heads, budget - 1)

    def __post_init__(self):
        super().__post_init__()
        self.heads = f32_bank(self.heads)

    def parallel_width(self) -> int:
        bank = self.heads["heads"].shape[0]
        if self.n_predict is not None:
            return min(self.n_predict, bank)
        return max(1, min(bank, self.engine.nfp_budget() - 1))

    def begin(self, prompt: np.ndarray, pending: int) -> None:
        # the prefill produced ``pending`` from the last prompt position
        self._hidden = self.engine.last_hidden[0]

    def observe(self, hidden, k: int) -> None:
        # logits row k gave the new pending token: propose from its state
        self._hidden = hidden[0, k]

    def propose(self, context: np.ndarray, pending: int,
                n: int) -> np.ndarray:
        props = mtp_propose(self.heads, self._hidden[None]).cpu().numpy()  # analysis: allow-host-sync
        return props[0][:n].astype(np.int64)


class MTPSlotAdapter(SlotAdapter):
    """Scheduler-side MTP: each request proposes from ITS row's last
    hidden state (kept on the Request), the bank caps the useful width,
    and the NFP budget is split evenly across rows; one head-bank
    dispatch serves every row of a step."""

    mode = "mtp"

    def __init__(self, loop, heads: Optional[Dict]):
        super().__init__(loop)
        if heads is None:
            raise ValueError("mtp serving mode needs an mtp_heads bank")
        self.heads = f32_bank(heads)

    def width(self, n_active: int, budget: int) -> int:
        bank = self.heads["heads"].shape[0]
        w = max(1, budget // max(n_active, 1))
        return min(w, self.loop.max_width, bank + 1)

    def headroom(self) -> int:
        return self.loop.max_width

    def begin(self, req, hidden) -> None:
        req.hidden = hidden

    def propose_rows(self, want: Dict[int, int]) -> Dict[int, np.ndarray]:
        # ONE head-bank dispatch over every row's hidden state; only the
        # (rows, heads) int32 proposals cross to the host
        rows = sorted(want)
        hid = torch.stack([self.loop.active[s].hidden for s in rows])
        props = mtp_propose(self.heads, hid).cpu().numpy()  # analysis: allow-host-sync
        return {s: props[i][:want[s]].astype(np.int64)
                for i, s in enumerate(rows)}

    def observe(self, req, k: int, hidden) -> None:
        # a copy: ``hidden`` may be a captured step's output, which the
        # next replay overwrites
        req.hidden = hidden[k].clone()
