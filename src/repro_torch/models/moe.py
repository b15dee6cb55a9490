"""Mixture-of-Experts FFN: top-k routing, dispatch by expert, grouped
expert FFN, weighted combine — the reference's ``models/moe.py``.

Dispatch sorts token-expert pairs by expert with a STABLE sort (as
``jnp.argsort``) and counts group sizes with ``scatter_add_`` (no host
sync; ``torch.bincount`` on CUDA reads its maximum back to the host).
The expert FFN is the Hopper grouped-FFN kernel with ``use_kernel``
(``kernels.moe_ffn``: f32 ``h``, as the reference's Pallas kernel) and
otherwise the plain counterpart of the reference's ``ragged_dot`` path
(``h`` rounded to the activation type).  The combine un-permutes the
weighted rows to (T, k, d) and sums over k in f32: deterministic, where
``index_add_``'s CUDA atomics would change the sum's order run to run.

Controlled routing (paper App. C.3.1) goes through ``routing_override``:
the load-balanced round-robin of Eq. 25 and the load-skewed pattern.

Under ``batch_group`` (data-parallel training, each rank on its rows of a
micro-batch) the aux loss takes its router statistics over the whole
micro-batch, as one process computing on all of it does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.arch import FFNSpec
from repro_torch.kernels.moe_ffn.ops import grouped_ffn
from repro_torch.models.layers import _init

Tensor = torch.Tensor

# (process group, ranks) whose rows make up the micro-batch, or None
_BATCH_GROUP: Optional[Tuple[object, int]] = None


@contextlib.contextmanager
def batch_group(group, size: int):
    """Inside, the aux loss averages its router statistics over the
    ``size`` ranks of ``group``, each holding an equal share of the
    micro-batch's rows (a collective per MoE layer: every rank of the
    group must run the same forward and backward).  A no-op for
    ``group`` None."""
    global _BATCH_GROUP
    prev, _BATCH_GROUP = _BATCH_GROUP, (
        None if group is None else (group, size))
    try:
        yield
    finally:
        _BATCH_GROUP = prev


def _batch_stats(frac: Tensor, mean_p: Tensor) -> Tuple[Tensor, Tensor]:
    """(frac, mean_p) averaged over the batch group.  The mean probability
    keeps the gradient of this rank's own: averaged over the ranks, as
    the trainer averages gradients, that is the gradient of the global
    aux loss."""
    group, size = _BATCH_GROUP
    e = frac.shape[0]
    both = torch.cat([frac, mean_p.detach()])
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    both = both / size
    return both[:e], mean_p + (both[e:] - mean_p).detach()


def init_moe(gen: torch.Generator, d_model: int, f: FFNSpec,
             dtype=torch.bfloat16, lead: Tuple[int, ...] = ()) -> Dict:
    """The reference's leaves and scales: an f32 router at 0.02, expert
    leaves at ``1/sqrt(shape[0])`` of the per-layer (E, d, f) shape —
    1/sqrt(E), the reference ``_init``'s default."""
    e, dff = f.n_experts, f.d_ff
    p = {
        "router": _init(gen, (d_model, e), 0.02, torch.float32, lead),
        "w_up": _init(gen, (e, d_model, dff), e ** -0.5, dtype, lead),
        "w_down": _init(gen, (e, dff, d_model), e ** -0.5, dtype, lead),
    }
    if f.activation == "swiglu":
        p["w_gate"] = _init(gen, (e, d_model, dff), e ** -0.5, dtype, lead)
    if f.n_shared_experts:
        ds = f.n_shared_experts * dff
        p["shared_up"] = _init(gen, (d_model, ds), d_model ** -0.5, dtype,
                               lead)
        p["shared_down"] = _init(gen, (ds, d_model), ds ** -0.5, dtype, lead)
    return p


def route_topk(router_w: Tensor, x: Tensor, k: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (weights (T,k) f32, idx (T,k), router_probs (T,E) f32).
    The router product stays in full f32 (the port never enables TF32):
    a rounded product flips expert choices at near-ties."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(top_vals, dim=-1)       # renormalize over top-k
    return weights, top_idx, probs


def balanced_routing(n_tokens: int, k: int, n_experts: int,
                     device=None) -> Tensor:
    """Paper Eq. 25: round-robin {(i*k + j) mod E} — the load-balanced
    (upper-bound) controlled pattern."""
    i = torch.arange(n_tokens, device=device)[:, None]
    j = torch.arange(k, device=device)[None, :]
    return (i * k + j) % n_experts


def skewed_routing(n_tokens: int, k: int, n_experts: int,
                   device=None) -> Tensor:
    """All tokens on the same k experts — the load-skewed (lower-bound)
    pattern."""
    del n_experts
    return torch.arange(k, device=device)[None, :].expand(n_tokens, k)


def ragged_ffn(x_sorted: Tensor, params: Dict, group_sizes: Tensor,
               activation: str) -> Tensor:
    """The plain counterpart of the reference's ``ragged_dot`` path: each
    sorted row through its expert's FFN (selected by masking, O(M·E)),
    products in x's type and ``h`` rounded to it."""
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


def route(params: Dict, f: FFNSpec, xt: Tensor
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """(weights (T, k) f32, idx (T, k), the switch-style load-balance aux
    loss) of rows ``xt`` (T, d) under the router."""
    e = f.n_experts
    weights, top_idx, probs = route_topk(params["router"], xt, f.top_k)
    frac = F.one_hot(top_idx, e).float().mean(dim=(0, 1))
    mean_p = probs.mean(dim=0)
    if _BATCH_GROUP is not None:
        frac, mean_p = _batch_stats(frac, mean_p)
    return weights, top_idx, e * torch.sum(frac * mean_p)


def moe_ffn(params: Dict, f: FFNSpec, x: Tensor,
            routing_override: Optional[Tuple[Tensor, Tensor]] = None,
            use_kernel: bool = False) -> Tuple[Tensor, Tensor]:
    """x: (..., d) -> (out (..., d), aux_loss scalar f32).

    routing_override: (idx (T,k), weights (T,k)) for controlled patterns
    (no aux loss then)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = f.n_experts, f.top_k

    if routing_override is not None:
        top_idx, weights = routing_override
        top_idx = top_idx.to(xt.device)
        weights = weights.to(device=xt.device, dtype=torch.float32)
        aux = torch.zeros((), dtype=torch.float32, device=xt.device)
    else:
        weights, top_idx, aux = route(params, f, xt)

    # --- dispatch: sort token-expert pairs by expert ----------------------
    flat_idx = top_idx.reshape(-1).long()
    flat_w = weights.reshape(-1)
    order = torch.argsort(flat_idx, stable=True)
    x_sorted = xt[order // k]
    group_sizes = torch.zeros(e, dtype=torch.int32, device=xt.device)
    group_sizes.scatter_add_(0, flat_idx, torch.ones_like(flat_idx,
                                                          dtype=torch.int32))

    # --- expert FFN ---------------------------------------------------------
    if use_kernel:
        h_out = grouped_ffn(x_sorted, params, group_sizes, f.activation,
                            n_tokens=t)
    else:
        h_out = ragged_ffn(x_sorted, params, group_sizes, f.activation)

    # --- combine: back to (T, k) pair order, sum over k in f32 ------------
    contrib = h_out.float() * flat_w[order][:, None]
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    out = pairs.reshape(t, k, d).sum(dim=1).to(x.dtype)

    if f.n_shared_experts:
        sh = F.gelu((xt @ params["shared_up"]).float(), approximate="tanh")
        out = out + (sh.to(x.dtype) @ params["shared_down"])

    return out.reshape(orig_shape), aux
