"""Expert-parallel MoE FFN over a process group — the reference's
``dist/ep_moe.py``, with ``torch.distributed.all_to_all_single`` where the
reference runs ``shard_map`` over the ``model`` mesh axis.

The single-device FFN (``models.moe.moe_ffn``) sorts token-expert pairs
and runs one grouped product.  At scale the expert tables live sharded
over the ranks of a group, and each step runs the paper's dispatch ->
expert FFN -> combine pipeline (Sec. 3.3):

  1. every rank routes its LOCAL tokens (router weights replicated),
  2. token activations are packed into per-expert capacity buffers and
     exchanged with one ``all_to_all_single`` (dispatch),
  3. each rank runs its resident experts' FFN as one batched product
     over the received buffers,
  4. a second ``all_to_all_single`` returns expert outputs to the
     token's home rank, where the weighted combine runs in f32.

Capacity semantics match production EP stacks: each (source rank,
expert) pair owns ``capacity`` token slots; overflow pairs are dropped
from that expert's contribution (their routing weight is simply lost),
which keeps the exchange statically shaped.  The capacity depends only on
the source rank's own token count, so a rank's drops depend only on its
own tokens.  ``capacity_factor`` >= E/k guarantees zero drops and
agreement with ``moe_ffn`` up to the order of summation.

No host read: ranks and drops are built on the device (a cumulative sum
of a one-hot), and every exchange has equal splits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.arch import FFNSpec
from repro_torch.core.granularity import round_up
from repro_torch.models.moe import route_topk

Tensor = torch.Tensor

EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def expert_layout(n_experts: int, n_ep: int):
    """(e_pad, e_loc): the experts padded so every rank holds the same
    number of tables, and the tables per rank.  The router never selects
    a padded expert, so its zero weights are dead."""
    e_pad = round_up(n_experts, n_ep)
    return e_pad, e_pad // n_ep


def capacity(capacity_factor: float, t_loc: int, k: int,
             n_experts: int) -> int:
    """Token slots per (source rank, expert): t_loc always suffices,
    because top-k indices are distinct per token."""
    cap = int(math.ceil(capacity_factor * t_loc * k / n_experts))
    return max(1, min(cap, t_loc))


def local_experts(params: Dict, f: FFNSpec, rank: int, n_ep: int) -> Dict:
    """Rank ``rank``'s share of a full MoE parameter dict: its ``e_loc``
    expert tables of the zero-padded ``e_pad``, and the router and shared
    experts whole."""
    e_pad, e_loc = expert_layout(f.n_experts, n_ep)
    out = {}
    for key, w in params.items():
        if key in EXPERT_LEAVES:
            if e_pad > w.shape[0]:
                pad = w.new_zeros((e_pad - w.shape[0], *w.shape[1:]))
                w = torch.cat([w, pad], dim=0)
            w = w[rank * e_loc:(rank + 1) * e_loc]
        out[key] = w
    return out


def _exchange(t: Tensor, group) -> Tensor:
    """One all_to_all_single with equal splits along dim 0: block j goes
    to rank j, and block j of the result came from rank j."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def ep_moe_ffn(params: Dict, f: FFNSpec, x: Tensor, group=None, *,
               capacity_factor: float = 1.0,
               stats: Optional[Dict] = None) -> Tensor:
    """Expert-parallel ``moe_ffn`` forward on this rank.

    x: (t_loc, d), this rank's tokens; ``params``: the router and shared
    experts whole, and this rank's expert tables (``local_experts``),
    (e_loc, d, f) / (e_loc, f, d).  Returns (t_loc, d): the rows of the
    global ``moe_ffn(...)[0]`` (no capacity drops) for these tokens.
    ``stats``, if given, receives "dropped" (a device count of the pairs
    dropped here) and "capacity"."""
    n_ep = dist.get_world_size(group)
    e, k = f.n_experts, f.top_k
    if x.ndim != 2:
        raise ValueError(f"ep_moe_ffn expects (T, d) tokens, got "
                         f"{tuple(x.shape)}")
    t_loc, d = x.shape
    e_pad, e_loc = expert_layout(e, n_ep)
    if params["w_up"].shape[0] != e_loc:
        raise ValueError(f"expert tables hold {params['w_up'].shape[0]} "
                         f"experts; this rank's share is {e_loc} (see "
                         "local_experts)")
    cap = capacity(capacity_factor, t_loc, k, e)
    swiglu = f.activation == "swiglu"

    weights, top_idx, _ = route_topk(params["router"], x, k)
    tk = t_loc * k
    flat_e = top_idx.reshape(-1)                              # (tk,)
    flat_w = weights.reshape(-1)                              # (tk,) f32
    tok_of_pair = torch.arange(tk, device=x.device) // k
    # rank of each pair within its expert's buffer (pair order)
    onehot = (flat_e[:, None] == torch.arange(e_pad, device=x.device)[None]
              ).to(torch.int32)
    rank = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, flat_e[:, None]).squeeze(1)
    keep = rank < cap                                         # capacity drop
    if stats is not None:
        stats["dropped"] = (~keep).sum()
        stats["capacity"] = cap
    # --- dispatch: pack (e_pad, cap, d) buffers, one exchange ------------
    # a dropped pair writes the trash row past the buffers
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, e_pad * cap))
    buf = x.new_zeros((e_pad * cap + 1, d))
    buf[slot] = x[tok_of_pair]
    recv = _exchange(buf[:-1].view(n_ep, e_loc, cap, d), group)
    # --- expert FFN: batched products over this rank's experts -----------
    xr = recv.transpose(0, 1).reshape(e_loc, n_ep * cap, d)
    up = torch.bmm(xr, params["w_up"])
    if swiglu:
        gate = torch.bmm(xr, params["w_gate"])
        h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    out_e = torch.bmm(h, params["w_down"])
    # --- return trip + weighted combine at the token's home rank ---------
    back = out_e.view(e_loc, n_ep, cap, d).transpose(0, 1)
    ret = _exchange(back, group).view(e_pad, cap, d)
    pair_out = ret[flat_e, rank.clamp(0, cap - 1)]
    contrib = pair_out.float() * torch.where(keep, flat_w, 0.0)[:, None]
    # pairs are in (token, k) order: a sum over k, in a fixed order
    out = contrib.view(t_loc, k, d).sum(dim=1).to(x.dtype)

    if f.n_shared_experts:
        sh = F.gelu((x @ params["shared_up"]).float(), approximate="tanh")
        out = out + (sh.to(x.dtype) @ params["shared_down"])
    return out
