"""Mamba1 (falcon-mamba) state-space block — the reference's
``models/mamba.py``.

"full" mode scans the whole sequence (train / prefill); "decode" mode
advances a cached (conv, ssm) state by N new positions.  The scan is the
Hopper selective-scan kernel with ``use_kernel`` (``kernels.mamba_scan``:
positions padded to the scan chunk M_ssm) and otherwise the plain loop.
Projections are stored unpacked (in_x / in_z / x_proj / ...) as in the
reference, bf16 weights and activations; ``A_log``, ``D``, ``dt_bias``,
the scan and the ssm state are float32.

States are never written in place: the block returns a new one, and the
serving engine commits it per row (a recurrent state has no length mask
that would hide a row which should not have moved).

Mamba2 (zamba2) is not ported: ``init_mamba2`` / ``mamba2_block`` raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.arch import SSMSpec
from repro_torch.kernels.mamba_scan.ops import (selective_scan,
                                                selective_scan_ref)
from repro_torch.models.layers import _init

Tensor = torch.Tensor


# ===========================================================================
# Depthwise causal conv1d
# ===========================================================================

def causal_conv1d(x: Tensor, w: Tensor, b: Tensor,
                  conv_state: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """x: (batch, s, c); w: (d_conv, c); returns (out (batch, s, c),
    new_state).  conv_state: (batch, d_conv-1, c), the trailing inputs of
    earlier steps (zeros when None)."""
    d_conv = w.shape[0]
    batch, s, c = x.shape
    if conv_state is None:
        conv_state = x.new_zeros((batch, d_conv - 1, c))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = torch.zeros((batch, s, c), dtype=torch.float32, device=x.device)
    for j in range(d_conv):
        out = out + xp[:, j:j + s].float() * w[j].float()
    out = out + b.float()
    new_state = xp[:, -(d_conv - 1):] if d_conv > 1 else conv_state
    return F.silu(out).to(x.dtype), new_state


# ===========================================================================
# Mamba1
# ===========================================================================

def init_mamba1(gen: torch.Generator, d_model: int, s: SSMSpec,
                dtype=torch.bfloat16, lead: Tuple[int, ...] = ()) -> Dict:
    """The reference's leaves and scales (``1/sqrt(shape[0])`` of the
    per-layer shape unless stated), with a leading ``lead`` layer axis."""
    di = s.d_inner(d_model)
    dt_rank = max(1, d_model // 16)
    dev = gen.device
    a_log = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_x": _init(gen, (d_model, di), d_model ** -0.5, dtype, lead),
        "in_z": _init(gen, (d_model, di), d_model ** -0.5, dtype, lead),
        "conv_w": _init(gen, (s.d_conv, di), 0.5, dtype, lead),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": _init(gen, (di, dt_rank + 2 * s.d_state), di ** -0.5,
                        dtype, lead),
        "dt_proj": _init(gen, (dt_rank, di), dt_rank ** -0.5, dtype, lead),
        "dt_bias": torch.zeros(lead + (di,), dtype=torch.float32, device=dev),
        "A_log": a_log.expand(lead + (di, s.d_state)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": _init(gen, (di, d_model), di ** -0.5, dtype, lead),
    }


def init_mamba1_state(batch: int, d_model: int, s: SSMSpec,
                      dtype=torch.bfloat16, device=None,
                      lead: Tuple[int, ...] = ()) -> Dict:
    """Zero state: conv history in the activation type, ssm state f32.
    (The reference allocates its conv state as bf16 whatever the model's
    type; under float32 weights it turns float32 at the first commit,
    whose ``jnp.where`` promotes it.  The port allocates it in the
    activation type from the start.)"""
    di = s.d_inner(d_model)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, di, s.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba1_block(params: Dict, s: SSMSpec, x: Tensor,
                 state: Optional[Dict] = None, use_kernel: bool = False
                 ) -> Tuple[Tensor, Optional[Dict]]:
    """x: (batch, seq, d_model) -> (out, new_state); ``new_state`` is None
    without a state.  ``state`` is read, never written."""
    batch, seq, d_model = x.shape
    di = s.d_inner(d_model)
    dt_rank = max(1, d_model // 16)
    x_in = x @ params["in_x"]
    z = x @ params["in_z"]
    conv_state = state["conv"] if state is not None else None
    x_conv, new_conv = causal_conv1d(x_in, params["conv_w"],
                                     params["conv_b"], conv_state)
    proj = x_conv @ params["x_proj"]
    dt = proj[..., :dt_rank] @ params["dt_proj"]
    dt = F.softplus(dt.float() + params["dt_bias"])
    b_ssm = proj[..., dt_rank:dt_rank + s.d_state].float()
    c_ssm = proj[..., dt_rank + s.d_state:].float()
    a = -torch.exp(params["A_log"])
    h0 = (state["ssm"] if state is not None
          else torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                           device=x.device))
    scan = selective_scan if use_kernel else selective_scan_ref
    ys, h = scan(x_conv.float(), dt, b_ssm, c_ssm, a, h0)
    y = ys + params["D"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]
    new_state = {"conv": new_conv, "ssm": h} if state is not None else None
    return out, new_state


# ===========================================================================
# Mamba2 (zamba2): not ported
# ===========================================================================

def init_mamba2(*args, **kwargs):
    raise NotImplementedError("Mamba2 (zamba2) blocks are not ported yet")


def mamba2_block(*args, **kwargs):
    raise NotImplementedError("Mamba2 (zamba2) blocks are not ported yet")
