"""Mixture-of-Experts FFN: top-k routing, dispatch by expert, grouped
expert FFN, weighted combine — the reference's ``models/moe.py``.

Dispatch sorts token-expert pairs by expert with a STABLE sort (as
``jnp.argsort``) and counts group sizes with ``scatter_add_`` (no host
sync; ``torch.bincount`` on CUDA reads its maximum back to the host).
The expert FFN is the Hopper grouped-FFN kernel with ``use_kernel``
(``kernels.moe_ffn``: f32 ``h``, as the reference's Pallas kernel) and
otherwise the plain counterpart of the reference's ``ragged_dot`` path
(``h`` rounded to the activation type): one ``torch._grouped_mm`` per
weight over each expert's own rows, its FLOPs counted by a formula this
module registers with ``FlopCounterMode``; a CUDA tensor of another type
than bf16, which that call would read back to the host, takes the
kernel's block-aligned plain version instead.  The combine un-permutes the
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
from repro_torch.core.granularity import select_token_block
from repro_torch.kernels.moe_ffn.ops import (align_block_size, grouped_ffn,
                                             grouped_ffn_ref)
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


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose backward hands on a contiguous gradient:
    ``_grouped_mm``'s backward refuses an expanded one (strides 0, as
    ``y.sum().backward()`` gives)."""

    @staticmethod
    def forward(ctx, y: Tensor) -> Tensor:
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        return grad.contiguous()


def _gmm(x: Tensor, w: Tensor, offs: Tensor) -> Tensor:
    """(M, K) rows grouped by ``offs`` (the groups' ends) times their
    groups' (E, K, N) weights: one product over each group's own rows."""
    return _ContiguousGrad.apply(torch._grouped_mm(x, w, offs=offs))


def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """2·M·K·N summed over the groups, for each layout ``moe_ffn``'s
    forward and backward call: 2-D × 3-D (the products and the input
    gradient), 2-D × 2-D grouped along the contraction (the weight
    gradient), 3-D × 2-D grouped along N and 3-D × 3-D."""
    if len(a_shape) == 2:
        return 2 * a_shape[0] * a_shape[1] * b_shape[-1]
    if len(b_shape) == 2:
        return 2 * a_shape[1] * a_shape[2] * b_shape[1]
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


def _register_grouped_mm_flops() -> None:
    """``FlopCounterMode`` has no formula for ``aten._grouped_mm`` and
    would count the expert products as no work."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    if torch.ops.aten._grouped_mm not in flop_registry:
        register_flop_formula(torch.ops.aten._grouped_mm)(_grouped_mm_flops)


_register_grouped_mm_flops()


def grouped_products(x_sorted: Tensor, params: Dict, group_sizes: Tensor,
                     activation: str) -> Tensor:
    """The plain counterpart of the reference's ``ragged_dot`` path: each
    sorted row through its own expert's FFN, one grouped product per
    weight (``up``, ``gate`` for SwiGLU, ``down``), products in x's type
    and ``h`` rounded to it.  The group ends stay on the device."""
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    up = _gmm(x_sorted, params["w_up"], offs).float()
    if activation == "swiglu":
        h = F.silu(_gmm(x_sorted, params["w_gate"], offs).float()) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return _gmm(h.to(x_sorted.dtype), params["w_down"], offs)


def aligned_products(x_sorted: Tensor, params: Dict, group_sizes: Tensor,
                     activation: str, n_tokens: int) -> Tensor:
    """The same FFN over the kernel's block-aligned layout
    (``align_block_size``, then ``grouped_ffn_ref``'s gathered per-block
    products): at most E·(token_block − 1) padded rows beyond the routed
    ones, and no host read.  For CUDA tensors other than bf16, where
    ``_grouped_mm`` reads the group ends back to the host."""
    m, d = x_sorted.shape
    e = group_sizes.shape[0]
    token_block = select_token_block(n_tokens or m, e)
    expert_of_sorted = torch.searchsorted(
        torch.cumsum(group_sizes, 0, dtype=torch.int32),
        torch.arange(m, dtype=torch.int32, device=x_sorted.device),
        right=True, out_int32=True)
    slot, block_expert, block_valid, m_pad = align_block_size(
        expert_of_sorted, group_sizes, e, token_block)
    slot = slot.long()
    x_padded = x_sorted.new_zeros((m_pad, d)).index_copy(0, slot, x_sorted)
    out = grouped_ffn_ref(
        x_padded, params["w_gate"] if activation == "swiglu" else None,
        params["w_up"], params["w_down"], block_expert, block_valid,
        token_block=token_block, activation=activation)
    return out[slot]


def plain_ffn(x_sorted: Tensor, params: Dict, group_sizes: Tensor,
              activation: str, n_tokens: int = 0) -> Tensor:
    """The expert FFN without the kernel: ``grouped_products``, or on a
    CUDA tensor of another type than bf16 ``aligned_products``."""
    if x_sorted.device.type == "cuda" and x_sorted.dtype != torch.bfloat16:
        return aligned_products(x_sorted, params, group_sizes, activation,
                                n_tokens)
    return grouped_products(x_sorted, params, group_sizes, activation)


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
        h_out = plain_ffn(x_sorted, params, group_sizes, f.activation,
                          n_tokens=t)

    # --- combine: back to (T, k) pair order, sum over k in f32 ------------
    contrib = h_out.float() * flat_w[order][:, None]
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    out = pairs.reshape(t, k, d).sum(dim=1).to(x.dtype)

    if f.n_shared_experts:
        sh = F.gelu((xt @ params["shared_up"]).float(), approximate="tanh")
        out = out + (sh.to(x.dtype) @ params["shared_down"])

    return out.reshape(orig_shape), aux
