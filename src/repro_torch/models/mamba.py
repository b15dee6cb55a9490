"""Mamba1 (falcon-mamba) and Mamba2 (zamba2) state-space blocks — the
reference's ``models/mamba.py``.

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

Mamba2 has no kernel, neither in the reference nor here: its recurrence (a
scalar decay per head over a (head_dim, d_state) state per head) is a
loop over positions in plain torch, so each position of a forward adds a
few small operations per layer.  ``A_logh``, ``D`` and ``dt_bias`` are
float32, one per head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import scan_op
from repro_torch.core.arch import SSMSpec
from repro_torch.kernels.mamba_scan.ops import (selective_scan,
                                                selective_scan_ref)
from repro_torch.models.layers import _init, rmsnorm

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
    # the reference's tap-by-tap f32 sum, less its zero start (0 + p = p);
    # each cast to f32 is exact, so it is taken once
    xpf, wf = xp.float(), w.float()
    out = xpf[:, :s] * wf[0]
    for j in range(1, d_conv):
        out = out + xpf[:, j:j + s] * wf[j]
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
    scan = selective_scan if use_kernel else _mamba1_scan
    ys, h = scan(x_conv.float(), dt, b_ssm, c_ssm, a, h0)
    y = ys + params["D"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]
    new_state = {"conv": new_conv, "ssm": h} if state is not None else None
    return out, new_state


# ===========================================================================
# Mamba2 (zamba2): scalar per-head decay, the SSD recurrence form
# ===========================================================================

def init_mamba2(gen: torch.Generator, d_model: int, s: SSMSpec,
                dtype=torch.bfloat16, lead: Tuple[int, ...] = ()) -> Dict:
    """The reference's leaves and scales (``1/sqrt(shape[0])`` of the
    per-layer shape unless stated), with a leading ``lead`` layer axis;
    ``A_logh``, ``D`` and ``dt_bias`` are float32, one per head."""
    di = s.d_inner(d_model)
    nh = di // s.head_dim
    gs = s.n_groups * s.d_state
    dev = gen.device

    def const(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)
    return {
        "in_x": _init(gen, (d_model, di), d_model ** -0.5, dtype, lead),
        "in_z": _init(gen, (d_model, di), d_model ** -0.5, dtype, lead),
        "in_B": _init(gen, (d_model, gs), d_model ** -0.5, dtype, lead),
        "in_C": _init(gen, (d_model, gs), d_model ** -0.5, dtype, lead),
        "in_dt": _init(gen, (d_model, nh), d_model ** -0.5, dtype, lead),
        "conv_w": _init(gen, (s.d_conv, di), 0.5, dtype, lead),
        "conv_b": const((di,), 0.0, dtype),
        "convB_w": _init(gen, (s.d_conv, gs), 0.5, dtype, lead),
        "convB_b": const((gs,), 0.0, dtype),
        "convC_w": _init(gen, (s.d_conv, gs), 0.5, dtype, lead),
        "convC_b": const((gs,), 0.0, dtype),
        "A_logh": const((nh,), 0.0, torch.float32),
        "D": const((nh,), 1.0, torch.float32),
        "dt_bias": const((nh,), 0.0, torch.float32),
        "norm": {"scale": const((di,), 1.0, dtype)},
        "out_proj": _init(gen, (di, d_model), di ** -0.5, dtype, lead),
    }


def init_mamba2_state(batch: int, d_model: int, s: SSMSpec,
                      dtype=torch.bfloat16, device=None,
                      lead: Tuple[int, ...] = ()) -> Dict:
    """Zero state: the three conv histories (x, B, C) in the activation
    type, the (nh, head_dim, ds) ssm state f32.  (The reference allocates
    its conv histories as bf16 whatever the model's type, as for Mamba1;
    the port allocates them in the activation type.)"""
    di = s.d_inner(d_model)
    nh = di // s.head_dim
    gs = s.n_groups * s.d_state
    hist = lead + (batch, s.d_conv - 1)
    return {
        "conv": torch.zeros(hist + (di,), dtype=dtype, device=device),
        "convB": torch.zeros(hist + (gs,), dtype=dtype, device=device),
        "convC": torch.zeros(hist + (gs,), dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _mamba1_scan(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                 a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """``selective_scan_ref``; inside ``core.scan_op.whole_scans()`` (the
    dry run) one operation."""
    if scan_op.active():
        return scan_op.selective_scan_whole(x, dt, b_in, c_in, a, h0)
    return selective_scan_ref(x, dt, b_in, c_in, a, h0)


def _mamba2_scan(dtx: Tensor, da: Tensor, b_h: Tensor, c_h: Tensor,
                 h: Tensor) -> Tuple[Tensor, Tensor]:
    """``mamba2_loop``; inside ``core.scan_op.whole_scans()`` (the dry
    run) one operation."""
    if scan_op.active():
        return scan_op.mamba2_scan_whole(dtx, da, b_h, c_h, h)
    return mamba2_loop(dtx, da, b_h, c_h, h)


def mamba2_loop(dtx: Tensor, da: Tensor, b_h: Tensor, c_h: Tensor,
                h: Tensor) -> Tuple[Tensor, Tensor]:
    """The per-position recurrence, position by position in the
    reference's order: h = exp(dt·a)·h + (dt·x) ⊗ B, y = h·C.
    dtx: (b, s, nh, dh); da: (b, s, nh); b_h, c_h: (b, s, nh, ds) (groups
    already repeated to heads); h: (b, nh, dh, ds).  Returns (y (b, s,
    nh, dh), the final h)."""
    ys = []
    for t in range(dtx.shape[1]):
        upd = dtx[:, t, :, :, None] * b_h[:, t, :, None, :]
        h = da[:, t, :, None, None] * h + upd
        ys.append(torch.matmul(h, c_h[:, t, :, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def mamba2_block(params: Dict, s: SSMSpec, x: Tensor,
                 state: Optional[Dict] = None
                 ) -> Tuple[Tensor, Optional[Dict]]:
    """x: (batch, seq, d_model) -> (out, new_state); ``new_state`` is None
    without a state.  ``state`` is read, never written.  No kernel: the
    reference's ``lax.scan`` is a loop over positions here; only what is
    elementwise across positions (exp(dt·a), dt·x, the group repeat) is
    computed for all positions at once."""
    batch, seq, d_model = x.shape
    di = s.d_inner(d_model)
    nh = di // s.head_dim
    ng, ds = s.n_groups, s.d_state
    z = x @ params["in_z"]
    x_in = x @ params["in_x"]
    b_raw = x @ params["in_B"]
    c_raw = x @ params["in_C"]
    dt_raw = x @ params["in_dt"]
    cs = state if state is not None else {}
    x_conv, new_conv = causal_conv1d(x_in, params["conv_w"],
                                     params["conv_b"], cs.get("conv"))
    b_conv, new_conv_b = causal_conv1d(b_raw, params["convB_w"],
                                       params["convB_b"], cs.get("convB"))
    c_conv, new_conv_c = causal_conv1d(c_raw, params["convC_w"],
                                       params["convC_b"], cs.get("convC"))
    rep = nh // ng
    # jnp.repeat(axis=1) over groups: each group serves ``rep`` heads in a
    # row (repeat_interleave, not Tensor.repeat)
    b_h = b_conv.reshape(batch, seq, ng, ds).float().repeat_interleave(
        rep, dim=2)
    c_h = c_conv.reshape(batch, seq, ng, ds).float().repeat_interleave(
        rep, dim=2)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (b,s,nh)
    a = -torch.exp(params["A_logh"])                              # (nh,)
    xh = x_conv.float().reshape(batch, seq, nh, s.head_dim)
    h0 = (state["ssm"] if state is not None
          else torch.zeros((batch, nh, s.head_dim, ds), dtype=torch.float32,
                           device=x.device))
    y, h = _mamba2_scan(dt[..., None] * xh, torch.exp(dt * a), b_h, c_h, h0)
    y = y + params["D"][:, None] * xh
    y = y.reshape(batch, seq, di)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = rmsnorm(params["norm"], y)          # the default eps, as the reference
    out = y @ params["out_proj"]
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "convB": new_conv_b,
                     "convC": new_conv_c, "ssm": h}
    return out, new_state
