"""The plain scans as one operation each, for the dry run.

The plain Mamba1 and Mamba2 scans (``kernels.mamba_scan.ops
.selective_scan_ref`` and ``models.mamba.mamba2_loop``) step position by
position, a few operations a position.  Under the dry run's fake tensors
each operation costs a dispatch, so a 32k-position prefill of a 64-layer
model is millions of them.  Inside ``whole_scans()`` the model's call of
each scan (``models.mamba._mamba1_scan`` / ``_mamba2_scan``) is instead
ONE custom operation forward (``repro_torch::mamba1_scan`` /
``mamba2_scan``) and, under autograd, one backward
(``*_scan_backward``), which count what the loop counts:

- FLOPs: formulas registered with ``FlopCounterMode`` that give the
  loop's count, its per-position product (Mamba1's ``einsum`` of h with
  C, Mamba2's ``matmul``) over every position forward, and the two
  products of its gradient backward (one without C's gradient);
- memory: under autograd the forward allocates, and saves for the
  backward, tensors of the sizes the loop's autograd allocates and
  saves, stacked over the positions — Mamba1: exp(dt·A) and h of every
  position (b, di, ds) and dt·x (b, di); Mamba2: h (b, nh, dh, ds) and
  the contiguous copy of C (b, nh, ds) its ``matmul`` makes; the last
  position's h only where C needs a gradient.  Without autograd only the
  outputs are allocated, as the loop keeps nothing.

The fake implementations, the formulas and these sizes are what the dry
run reads; only its fake tensors reach the backward, whose real
implementation raises.  On real tensors the forward calls the loop (the
saved tensors are empty, of the loop's sizes), so the scans' math is
written once.  Outside the context the model calls the loops.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from repro_torch.kernels.mamba_scan.ops import selective_scan_ref

Tensor = torch.Tensor

_WHOLE = False


@contextlib.contextmanager
def whole_scans():
    """Inside, the model's plain scans run as one operation a call (see
    the module docstring)."""
    global _WHOLE
    prev, _WHOLE = _WHOLE, True
    try:
        yield
    finally:
        _WHOLE = prev


def active() -> bool:
    return _WHOLE


def _needs_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _mamba2_loop(*args: Tensor) -> Tuple[Tensor, Tensor]:
    from repro_torch.models.mamba import mamba2_loop   # it imports this
    return mamba2_loop(*args)


def _fake_only(name: str):
    raise NotImplementedError(f"{name}: only the dry run's fake tensors "
                              "reach the one-operation scans' backward; "
                              "outside core.scan_op.whole_scans() the loop "
                              "runs")


# ===========================================================================
# Mamba1: h_t = exp(dt_t·A)∘h_{t−1} + (dt_t·x_t)⊗B_t, y_t = h_t·C_t
# ===========================================================================

def _m1_saved(x: Tensor, a: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """What the loop saves for the backward: h before the last position
    (b, s − 1, di, ds), exp(dt·A) (b, s, di, ds) and dt·x (b, s, di)."""
    bsz, s, di = x.shape
    ds = a.shape[-1]
    return (x.new_empty((bsz, s - 1, di, ds)),
            x.new_empty((bsz, s, di, ds)), x.new_empty(x.shape))


@torch.library.custom_op("repro_torch::mamba1_scan", mutates_args=())
def mamba1_scan(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """(y, the final h) of the selective scan, nothing saved."""
    return selective_scan_ref(x, dt, b_in, c_in, a, h0)


@mamba1_scan.register_fake
def _(x, dt, b_in, c_in, a, h0):
    return x.new_empty(x.shape), h0.new_empty(h0.shape)


@torch.library.custom_op("repro_torch::mamba1_scan_saving", mutates_args=())
def mamba1_scan_saving(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                       a: Tensor, h0: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(y, the final h), then ``_m1_saved``'s sizes."""
    return (*selective_scan_ref(x, dt, b_in, c_in, a, h0),
            *_m1_saved(x, a))


@mamba1_scan_saving.register_fake
def _(x, dt, b_in, c_in, a, h0):
    return (x.new_empty(x.shape), h0.new_empty(h0.shape),
            *_m1_saved(x, a))


@torch.library.custom_op("repro_torch::mamba1_scan_backward",
                         mutates_args=())
def mamba1_scan_backward(g_y: Tensor, g_h: Tensor, x: Tensor, dt: Tensor,
                         b_in: Tensor, c_in: Tensor, a: Tensor, h0: Tensor,
                         grad_c: bool
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                    Tensor]:
    """Gradients of x, dt, B, C, A and h0 (fake tensors only)."""
    _fake_only("mamba1_scan_backward")


@mamba1_scan_backward.register_fake
def _(g_y, g_h, x, dt, b_in, c_in, a, h0, grad_c):
    return tuple(t.new_empty(t.shape) for t in (x, dt, b_in, c_in, a, h0))


class _Mamba1Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, b_in, c_in, a, h0):
        y, h, *held = mamba1_scan_saving(x, dt, b_in, c_in, a, h0)
        # the final h only for C's gradient, as the loop's product keeps it
        ctx.save_for_backward(x, dt, b_in, c_in, a, h0,
                              h if ctx.needs_input_grad[3] else None, *held)
        return y, h

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = ctx.saved_tensors[:6]
        g_y = (torch.zeros_like(inputs[0]) if g_y is None
               else g_y.contiguous())
        g_h = (torch.zeros_like(inputs[5]) if g_h is None
               else g_h.contiguous())
        return mamba1_scan_backward(g_y, g_h, *inputs,
                                    grad_c=ctx.needs_input_grad[3])


def selective_scan_whole(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                         a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """``selective_scan_ref`` as one operation: (y (b, s, di), h_final)."""
    if _needs_grad(x, dt, b_in, c_in, a, h0):
        return _Mamba1Scan.apply(x, dt, b_in, c_in, a, h0)
    return mamba1_scan(x, dt, b_in, c_in, a, h0)


# ===========================================================================
# Mamba2: h_t = da_t·h_{t−1} + dtx_t⊗B_t, y_t = h_t·C_t per head
# ===========================================================================

def _m2_saved(dtx: Tensor, c_h: Tensor, h0: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """What the loop saves for the backward: h before the last position
    (b, s − 1, nh, dh, ds) and the contiguous copies of C (b, s, nh,
    ds)."""
    bsz, s = dtx.shape[:2]
    return (h0.new_empty((bsz, s - 1, *h0.shape[1:])),
            c_h.new_empty(c_h.shape))


@torch.library.custom_op("repro_torch::mamba2_scan", mutates_args=())
def mamba2_scan(dtx: Tensor, da: Tensor, b_h: Tensor, c_h: Tensor,
                h0: Tensor) -> Tuple[Tensor, Tensor]:
    """(y, the final h) of the Mamba2 recurrence, nothing saved."""
    return _mamba2_loop(dtx, da, b_h, c_h, h0)


@mamba2_scan.register_fake
def _(dtx, da, b_h, c_h, h0):
    return dtx.new_empty(dtx.shape), h0.new_empty(h0.shape)


@torch.library.custom_op("repro_torch::mamba2_scan_saving", mutates_args=())
def mamba2_scan_saving(dtx: Tensor, da: Tensor, b_h: Tensor, c_h: Tensor,
                       h0: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(y, the final h), then ``_m2_saved``'s sizes."""
    return (*_mamba2_loop(dtx, da, b_h, c_h, h0),
            *_m2_saved(dtx, c_h, h0))


@mamba2_scan_saving.register_fake
def _(dtx, da, b_h, c_h, h0):
    return (dtx.new_empty(dtx.shape), h0.new_empty(h0.shape),
            *_m2_saved(dtx, c_h, h0))


@torch.library.custom_op("repro_torch::mamba2_scan_backward",
                         mutates_args=())
def mamba2_scan_backward(g_y: Tensor, g_h: Tensor, dtx: Tensor, da: Tensor,
                         b_h: Tensor, c_h: Tensor, h0: Tensor, grad_c: bool
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Gradients of dtx, da, B, C and h0 (fake tensors only)."""
    _fake_only("mamba2_scan_backward")


@mamba2_scan_backward.register_fake
def _(g_y, g_h, dtx, da, b_h, c_h, h0, grad_c):
    return tuple(t.new_empty(t.shape) for t in (dtx, da, b_h, c_h, h0))


class _Mamba2Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dtx, da, b_h, c_h, h0):
        y, h, *held = mamba2_scan_saving(dtx, da, b_h, c_h, h0)
        # C as the loop keeps it: its contiguous copies, in ``held``
        ctx.save_for_backward(dtx, da, b_h, h0,
                              h if ctx.needs_input_grad[3] else None, *held)
        return y, h

    @staticmethod
    def backward(ctx, g_y, g_h):
        dtx, da, b_h, h0, _, _, c_copy = ctx.saved_tensors
        g_y = torch.zeros_like(dtx) if g_y is None else g_y.contiguous()
        g_h = torch.zeros_like(h0) if g_h is None else g_h.contiguous()
        return mamba2_scan_backward(g_y, g_h, dtx, da, b_h, c_copy, h0,
                                    grad_c=ctx.needs_input_grad[3])


def mamba2_scan_whole(dtx: Tensor, da: Tensor, b_h: Tensor, c_h: Tensor,
                      h0: Tensor) -> Tuple[Tensor, Tensor]:
    """``mamba2_loop`` as one operation: (y (b, s, nh, dh), h_final)."""
    if _needs_grad(dtx, da, b_h, c_h, h0):
        return _Mamba2Scan.apply(dtx, da, b_h, c_h, h0)
    return mamba2_scan(dtx, da, b_h, c_h, h0)


# ===========================================================================
# FLOP formulas: the loops' counts
# ===========================================================================

def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    ops = torch.ops.repro_torch

    # forward: one (di, ds)·(ds) product per row and position, 2·di·ds
    @register_flop_formula([ops.mamba1_scan, ops.mamba1_scan_saving])
    def _m1(x, dt, b_in, c_in, a, h0, *args, out_shape=None, **kwargs):
        bsz, s, di = x
        return 2 * bsz * s * di * a[-1]

    # backward: the product's gradient for h, and for C where C needs one
    @register_flop_formula(ops.mamba1_scan_backward)
    def _m1_bwd(g_y, g_h, x, dt, b_in, c_in, a, *args, grad_c=True,
                out_shape=None, **kwargs):
        bsz, s, di = x
        return 2 * bsz * s * di * a[-1] * (2 if _flag(args, grad_c) else 1)

    @register_flop_formula([ops.mamba2_scan, ops.mamba2_scan_saving])
    def _m2(dtx, da, b_h, c_h, h0, *args, out_shape=None, **kwargs):
        bsz, s, nh, dh = dtx
        return 2 * bsz * s * nh * dh * b_h[-1]

    @register_flop_formula(ops.mamba2_scan_backward)
    def _m2_bwd(g_y, g_h, dtx, da, b_h, *args, grad_c=True, out_shape=None,
                **kwargs):
        bsz, s, nh, dh = dtx
        return (2 * bsz * s * nh * dh * b_h[-1]
                * (2 if _flag(args, grad_c) else 1))


def _flag(args, default: bool) -> bool:
    """The trailing ``grad_c`` flag, passed by position or by keyword."""
    return args[-1] if args and isinstance(args[-1], bool) else default


_register_flops()
