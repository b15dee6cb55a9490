"""The plain float32 reference of a training job's first steps, and the
numbers the check compares.

``steps`` runs the reference model (``model``) from the benchmark's
initial weights, cast to float32, through ``len(batches)`` steps of
next-token cross-entropy (mean over positions; micro-batches of equal
size averaged), global-norm clipping and AdamW with f32 moments and
decoupled weight decay, as the job's traffic file states them: linear
warmup to ``lr`` then cosine decay to ``min_lr_ratio * lr``; bias
correction; no decay on a leaf whose path names a norm ``scale`` or a
``bias``.  It returns each step's loss, the clipped gradient of step 1
per leaf (by norm) and each leaf's change after the last step (by norm).
Every product goes through ``mm`` (the control swaps in fp8).  Imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from bench.reference import model

Tensor = torch.Tensor
Path = Tuple


def leaves(tree, prefix: Path = ()) -> List[Tuple[Path, Tensor]]:
    """(path, tensor) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v,
                                                              prefix + (i,))]
    return [(prefix, tree)]


def rebuild(tree, new: Dict[Path, Tensor], prefix: Path = ()):
    if isinstance(tree, dict):
        return {k: rebuild(v, new, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, new, prefix + (i,))
                          for i, v in enumerate(tree))
    return new[prefix]


def path_name(path: Path) -> str:
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p) for p in path)


def decays(path: Path) -> bool:
    return not any(k in path_name(path) for k in ("scale", "bias"))


def lr_at(opt: Dict, step: int) -> float:
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    lo = opt["min_lr_ratio"] * lr
    return lo + (lr - lo) * 0.5 * (1.0 + math.cos(math.pi * prog))


def loss_of(params, spec: Dict, tokens: Tensor, mm: Callable) -> Tensor:
    h = model.final_hidden(params, spec, tokens, mm)
    lg = model.logits(params, spec, h[:, :-1], mm)
    return torch.nn.functional.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1))


def steps(init, spec: Dict, batches: Sequence[Tensor], opt: Dict,
          n_micro: int, mm: Callable = model.f32_mm) -> Dict:
    """``init``: the initial weights (any float type, read only);
    ``batches``: one (batch, seq) token tensor per step."""
    flat = leaves(init)
    p = {path: t.detach().float().clone().requires_grad_()
         for path, t in flat}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    tree = rebuild(init, p)
    losses, first_grad = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        loss = 0.0
        for micro in batch.chunk(n_micro):
            with torch.enable_grad():
                val = loss_of(tree, spec, micro, mm) / n_micro
                val.backward()        # adds into each leaf's .grad
            loss += float(val.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {k: (t.grad if t.grad is not None
                         else torch.zeros_like(t)) for k, t in p.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(opt["clip_norm"] / (norm + 1e-9), max=1.0)
            lr = lr_at(opt, step)
            for k, t in p.items():
                g = grads[k].mul_(scale)
                if step == 1:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / (1 - b1 ** step)) / (
                    torch.sqrt(v[k] / (1 - b2 ** step)) + opt["eps"])
                if decays(k):
                    upd = upd + opt["weight_decay"] * t
                t.sub_(lr * upd)
                t.grad = None
        del grads
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - t0.float()))
                  for k, t0 in flat}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def worst_leaf(got: Dict[Path, float], want: Dict[Path, float],
               keep=None) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's
    want), over the leaves ``keep`` names (all by default)."""
    keys = [k for k in want if keep is None or k in keep]
    med = sorted(want[k] for k in keys)[len(keys) // 2]
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def moving(first_grad: Dict[Path, float]) -> set:
    """The leaves whose step-1 gradient is more than a thousandth of the
    median leaf's: the others move under AdamW by round-off alone."""
    med = sorted(first_grad.values())[len(first_grad) // 2]
    return {k for k, g in first_grad.items() if g >= 1e-3 * med}
