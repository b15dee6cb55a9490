"""The served-token check: how far below the reference's best logit each
served token's logit lies.

For a finished request of prompt ``p`` and served tokens ``t``, the
reference runs once over ``p + t[:-1]`` and reads, at each position that
produced a served token, ``max(logits) - logits[served]``: 0 where the
program served the reference's greedy token, small where it took a
near-tie under its own rounding, large where it served a token the model
does not rank first.  Two numbers are read over the sample: the widest
gap, and the mean gap over every compared token; a cell's limits file
names the ones it compares (those its control separates from sound
runs).

The control puts the reference in the program's place one precision
down (``model.fp8_mm``: float8 e4m3 operands) and reads, at the same
positions, the float32 reference's gap of the token the control ranks
first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.reference import model

Sample = Tuple[np.ndarray, np.ndarray]      # (prompt ids, served ids)


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = ref.max(dim=-1).values
    return best - ref.gather(1, tokens[:, None])[:, 0]


def served_gaps(params: Dict, spec: Dict, samples: Sequence[Sample],
                device, control: bool = False) -> Dict:
    """Per sampled request the widest gap of the served tokens
    (``program``) and, with ``control``, of the tokens the fp8 control
    ranks first (``control``); the gaps' sums over all compared tokens
    (``program_sum``, ``control_sum``) and their count (``tokens``)."""
    out: Dict = {"program": [], "control": [], "program_sum": 0.0,
                 "control_sum": 0.0,
                 "tokens": sum(len(t) for _, t in samples)}
    with torch.no_grad():
        for prompt, served in samples:
            seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                                  dtype=torch.long, device=device)
            p = len(prompt)
            h = model.final_hidden(params, spec, seq)[p - 1:]
            ref = model.logits(params, spec, h)
            tok = torch.as_tensor(served, dtype=torch.long, device=device)
            gap = _gap(ref, tok)
            out["program"].append(float(gap.max()))
            out["program_sum"] += float(gap.double().sum())
            if control:
                hc = model.final_hidden(params, spec, seq, model.fp8_mm)
                pick = model.logits(params, spec, hc[p - 1:],
                                    model.fp8_mm).argmax(dim=-1)
                gap = _gap(ref, pick)
                out["control"].append(float(gap.max()))
                out["control_sum"] += float(gap.double().sum())
            del h, ref
    return out


def sample(finished: Sequence[Sample], seed: int, max_requests: int,
           min_tokens: int, half: Optional[Sequence[int]] = None
           ) -> List[int]:
    """Indices of the requests to compare: the one with the most served
    tokens, then others in an order drawn from ``seed`` until
    ``max_requests`` of them or ``min_tokens`` served tokens.  ``half``
    (0 or 1 per request: the half of the slots that served it) makes the
    picks take the halves by turns, so that a sample of two or more holds
    both halves where both served a request."""
    if not finished:
        return []
    sizes = np.array([len(t) for _, t in finished])
    half = [0] * len(finished) if half is None else [int(h) for h in half]
    first = int(np.argmax(sizes))
    order = [int(i) for i in np.random.default_rng(
        [int(seed) & (2 ** 63 - 1), 7]).permutation(len(finished))
        if i != first]
    queues = {h: [i for i in order if half[i] == h] for h in (0, 1)}
    both = bool(queues[1 - half[first]])
    picked, tokens = [first], int(sizes[first])
    while queues[0] or queues[1]:
        if ((len(picked) >= max_requests or tokens >= min_tokens)
                and (len(picked) >= 2 or not both)):
            break
        turn = 1 - half[picked[-1]]
        i = (queues[turn] or queues[1 - turn]).pop(0)
        picked.append(i)
        tokens += int(sizes[i])
    return picked


def numbers(gaps: Dict, who: str = "program") -> Dict[str, float]:
    """The compared numbers of ``who`` (the program or the control): the
    widest gap and the mean gap (None where nothing was compared)."""
    if not gaps["tokens"] or not gaps[who]:
        return {"served_logit_gap": None, "served_logit_gap_mean": None}
    return {"served_logit_gap": max(gaps[who]),
            "served_logit_gap_mean": gaps[f"{who}_sum"] / gaps["tokens"]}
