"""Mamba1 selective scan: the Hopper kernel's wrappers and its plain
version.

``selective_scan`` is the counterpart of the reference's jitted wrapper
of the same name: it pads the positions to the scan chunk
``select_scan_chunk(s)`` of ``core.granularity`` (M_ssm, 16) with
``dt = x = B = C = 0`` — identity steps, ``h = exp(0)·h + 0`` — runs
``selective_scan_padded`` and returns ``y`` of the real positions with
the state after them.  ``selective_scan_padded`` is the kernel's
wrapper: on a CUDA tensor it launches ``csrc/mamba_scan.cu`` (see its
header for the design and what bounds it) or raises; only a tensor on
the CPU takes the plain version ``selective_scan_ref``.  The padding
runs on both paths, and the padded steps are computed on both.

``selective_scan_split`` emulates the kernel's sum of y over a channel's
lane group (S states per lane, the partials summed in the butterfly's
fixed order); the tests hold it against the reference's Pallas kernel.

Layouts are the reference's: x/dt ``(b, s, di)``, B/C ``(b, s, ds)``,
A ``(di, ds)``, h0 ``(b, di, ds)``, all float32.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.granularity import round_up, select_scan_chunk
from repro_torch.kernels.build import load_library

MAX_STATE = 64        # the kernel's widest lane group: 16 lanes of 4 states

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 8 + [_I] * 4 + [_P]


def _kernels() -> ctypes.CDLL:
    lib = load_library("mamba_scan")
    lib.mamba_scan.argtypes = _SIGNATURE
    lib.mamba_scan.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version (the reference's ref.py / _mamba1_scan)
# ---------------------------------------------------------------------------

def _recurrence(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                a: Tensor, h0: Tensor, read_y: Callable[[Tensor, Tensor],
                                                        Tensor]
                ) -> Tuple[Tensor, Tensor]:
    """A loop over positions; ``read_y(h_t, C_t)`` gives y_t."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a[None])               # (b, di, ds)
        dbx = (dt_t * x[:, t])[..., None] * b_in[:, t, None, :]
        h = da * h + dbx
        ys.append(read_y(h, c_in[:, t]))
    return torch.stack(ys, dim=1), h


def selective_scan_ref(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                       a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """Returns (y (b, s, di), h_final (b, di, ds)), float32."""
    return _recurrence(x, dt, b_in, c_in, a, h0,
                       lambda h, c: torch.einsum("bds,bs->bd", h, c))


def lane_group(ds: int, states_per_lane: int) -> int:
    """The kernel's lanes per channel: ds / states_per_lane rounded up to
    a power of two."""
    g = 1
    while g * states_per_lane < ds:
        g *= 2
    return g


def selective_scan_split(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                         a: Tensor, h0: Tensor, states_per_lane: int
                         ) -> Tuple[Tensor, Tensor]:
    """The plain recurrence (the state bitwise ``selective_scan_ref``'s)
    with y summed as the kernel sums it: the ds states zero-padded to the
    lane group's G·S, each lane's S terms h·C in state order, then the G
    lane partials in the butterfly's fixed pairwise tree ((p0 + p1) + (p2
    + p3)) + ...  On no serving path."""
    s = states_per_lane
    g = lane_group(a.shape[-1], s)

    def read_y(h, c):
        terms = F.pad(h * c[:, None, :], (0, g * s - h.shape[-1]))
        terms = terms.reshape(*h.shape[:2], g, s)
        part = terms[..., 0]
        for i in range(1, s):
            part = part + terms[..., i]
        while part.shape[-1] > 1:
            part = part[..., 0::2] + part[..., 1::2]
        return part[..., 0]
    return _recurrence(x, dt, b_in, c_in, a, h0, read_y)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor, a: Tensor,
           h0: Tensor) -> None:
    bsz, s, di = x.shape
    ds = a.shape[-1]
    shapes = {"x": (bsz, s, di), "dt": (bsz, s, di), "b_in": (bsz, s, ds),
              "c_in": (bsz, s, ds), "a": (di, ds), "h0": (bsz, di, ds)}
    for name, t in zip(shapes, (x, dt, b_in, c_in, a, h0)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the selective-scan kernel takes float32; "
                            f"{name} is {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"d_state {ds} outside 1..{MAX_STATE}")


def padded_len(s: int) -> int:
    """Positions after padding ``s`` to the scan chunk."""
    return round_up(s, select_scan_chunk(s))


def launch_args(x_shape, a_shape) -> tuple:
    """The scalar arguments of one ``mamba_scan`` launch, in the entry
    point's order, from the padded x's (b, s_pad, di) and A's (di, ds)
    shapes: (bsz, s_pad, di, ds).  The wrapper passes exactly this tuple,
    so ``repro_torch.analysis`` checks the launches on any host."""
    return (int(x_shape[0]), int(x_shape[1]), int(x_shape[2]),
            int(a_shape[-1]))


def selective_scan_padded(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                          a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """The scan over every given position (already padded).  Returns (y
    (b, s_pad, di), h after the last position (b, di, ds))."""
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, b_in, c_in, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no selective-scan path for {x.device}")
    _check(x, dt, b_in, c_in, a, h0)
    y = torch.empty_like(x)
    h = torch.empty_like(h0)
    err = _kernels().mamba_scan(
        x.data_ptr(), dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        *launch_args(x.shape, a.shape),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    selective_scan_padded.launches += 1
    return y, h


selective_scan_padded.launches = 0


def pad_positions(t: Tensor, s_pad: int) -> Tensor:
    """Zero positions appended to a (b, s, c) tensor, contiguous."""
    return F.pad(t, (0, 0, 0, s_pad - t.shape[1])).contiguous()


def selective_scan(x: Tensor, dt: Tensor, b_in: Tensor, c_in: Tensor,
                   a: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """Positions padded to the scan chunk, then the scan.  Returns (y
    (b, s, di), h_final): the state after the s REAL positions (padded
    steps are identities)."""
    s = x.shape[1]
    s_pad = padded_len(s)
    y, h = selective_scan_padded(*(pad_positions(t, s_pad)
                                   for t in (x, dt, b_in, c_in)),
                                 a.contiguous(), h0.contiguous())
    return y[:, :s], h
