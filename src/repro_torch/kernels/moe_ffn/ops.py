"""Fused grouped expert FFN: the block alignment, the Hopper kernel's
wrappers and its plain version.

``align_block_size`` pads each expert's routed rows up to ``token_block``
(the BLOCK_SIZE_M analogue, M_moe in the decode regime) and lays the
padded groups out contiguously, with per-block expert ids and validity
flags — all on the device, under the static bound ``numel + E·(tb−1)``
rounded to a block, so no host sync sizes anything.

``grouped_ffn`` takes token rows sorted by expert plus the group sizes,
pads them, runs ``grouped_ffn_padded`` and gathers the rows back.
``grouped_ffn_padded`` is the kernel's wrapper: on a CUDA tensor it
launches ``csrc/moe_ffn.cu`` (see its header for the design and what
bounds it) or raises; only a tensor on the CPU takes the plain version
``grouped_ffn_ref``, which runs on the same padded layout and block
metadata.  Both keep ``h = act(x·Wg)∘(x·Wu)`` in float32 between the
projections, as the reference's Pallas kernel does (its XLA path rounds
``h`` to the activation type instead).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.granularity import round_up, select_token_block
from repro_torch.kernels.build import load_library

F_TILE = 512          # the reference kernel's f tile: min(f, 512)
ROW_CHUNK = 16        # the kernel's row sub-block; token blocks are multiples
ACTIVATIONS = ("swiglu", "gelu")

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 8 + [_I] * 5 + [_P, _P]


def _kernels() -> ctypes.CDLL:
    lib = load_library("moe_ffn")
    lib.moe_ffn.argtypes = _SIGNATURE
    lib.moe_ffn.restype = ctypes.c_int
    return lib


def check_f_tile(f: int) -> None:
    """The reference tiles f by ``min(f, 512)`` and runs ``f // 512``
    tiles, silently dropping the tail columns of an f > 512 that is no
    multiple of 512; the port refuses such an f instead."""
    if f > F_TILE and f % F_TILE:
        raise ValueError(f"expert d_ff {f} > {F_TILE} is not a multiple of "
                         f"{F_TILE}: the reference's f tiling would drop its "
                         f"last {f % F_TILE} columns")


# ---------------------------------------------------------------------------
# block alignment (moe_align_block_size)
# ---------------------------------------------------------------------------

def _exclusive_cumsum(x: Tensor) -> Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def align_block_size(expert_of_sorted: Tensor, group_sizes: Tensor,
                     n_experts: int, token_block: int,
                     ) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Returns (slot_of_sorted (M,), block_expert (n_blocks,), block_valid
    (n_blocks,), m_pad_max), int32 tensors on the input's device.

    slot_of_sorted maps each sorted row to its padded slot; blocks past
    the padded total are invalid and name the last expert."""
    m = expert_of_sorted.shape[0]
    m_pad_max = round_up(m + n_experts * (token_block - 1), token_block)
    n_blocks = m_pad_max // token_block
    dev = group_sizes.device
    gs = group_sizes.to(torch.int32)
    padded = (gs + token_block - 1) // token_block * token_block
    expert = expert_of_sorted.long()
    rank = (torch.arange(m, dtype=torch.int32, device=dev)
            - _exclusive_cumsum(gs)[expert])
    slot = _exclusive_cumsum(padded)[expert] + rank
    cum = torch.cumsum(padded, 0, dtype=torch.int32)
    block_start = torch.arange(n_blocks, dtype=torch.int32,
                               device=dev) * token_block
    block_valid = (block_start < cum[-1]).to(torch.int32)
    block_expert = torch.searchsorted(cum, block_start, right=True,
                                      out_int32=True).clamp_(0, n_experts - 1)
    return slot, block_expert, block_valid, m_pad_max


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _act(activation: str, gate: Optional[Tensor], up: Tensor) -> Tensor:
    if activation == "swiglu":
        return F.silu(gate) * up
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(up, approximate="tanh")


def grouped_ffn_ref(x_padded: Tensor, w_gate: Optional[Tensor], w_up: Tensor,
                    w_down: Tensor, block_expert: Tensor, block_valid: Tensor,
                    *, token_block: int, activation: str) -> Tensor:
    """Each block of ``token_block`` padded rows through its expert's FFN,
    a gathered per-block batched product in float32; invalid blocks give
    zeros (the Pallas kernel's untouched accumulator).  (m_pad, d) in
    x's type."""
    check_f_tile(w_up.shape[-1])
    m_pad, d = x_padded.shape
    xb = x_padded.reshape(m_pad // token_block, token_block, d).float()
    be = block_expert.long()
    up = torch.bmm(xb, w_up[be].float())
    gate = (torch.bmm(xb, w_gate[be].float()) if activation == "swiglu"
            else None)
    out = torch.bmm(_act(activation, gate, up), w_down[be].float())
    out = torch.where(block_valid.bool()[:, None, None], out, 0.0)
    return out.reshape(m_pad, d).to(x_padded.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(x_padded: Tensor, weights, block_expert: Tensor,
           block_valid: Tensor, token_block: int) -> None:
    m_pad, d = x_padded.shape
    w_gate, w_up, w_down = weights
    e, _, f = w_up.shape
    for name, t in (("x", x_padded), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t is None:
            continue
        if t.device != x_padded.device:
            raise ValueError(f"{name} on {t.device}, x on {x_padded.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the MoE FFN kernel takes bf16; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if w_up.shape != (e, d, f) or w_down.shape != (e, f, d) or (
            w_gate is not None and w_gate.shape != (e, d, f)):
        raise ValueError(f"expert weights do not match x {tuple(x_padded.shape)}"
                         f": up {tuple(w_up.shape)}, down {tuple(w_down.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"d_model {d} and d_ff {f} must be multiples of 8")
    if token_block % ROW_CHUNK or m_pad % token_block:
        raise ValueError(f"token_block {token_block} must be a multiple of "
                         f"{ROW_CHUNK} dividing m_pad {m_pad}")
    for name, t in (("block_expert", block_expert),
                    ("block_valid", block_valid)):
        if (t.dtype != torch.int32 or t.device != x_padded.device
                or not t.is_contiguous()
                or t.shape != (m_pad // token_block,)):
            raise ValueError(f"{name} must be a contiguous (n_blocks,) int32 "
                             "tensor on x's device")


def grouped_ffn_padded(x_padded: Tensor, w_gate: Optional[Tensor],
                       w_up: Tensor, w_down: Tensor, block_expert: Tensor,
                       block_valid: Tensor, *, token_block: int,
                       activation: str, blocks: Optional[Tensor] = None
                       ) -> Tensor:
    """x_padded: (m_pad, d); w_gate/w_up: (E, d, f) (``w_gate`` None for
    gelu); w_down: (E, f, d); block_expert/block_valid: (m_pad /
    token_block,) int32.  Returns (m_pad, d); rows of invalid blocks are
    zero in the plain version and undefined from the kernel.  ``blocks``
    (a one-element int32 CUDA tensor) accumulates the valid blocks the
    kernel executes."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if (w_gate is None) != (activation != "swiglu"):
        raise ValueError("w_gate is given exactly for swiglu")
    check_f_tile(w_up.shape[-1])
    if x_padded.device.type == "cpu":
        return grouped_ffn_ref(x_padded, w_gate, w_up, w_down, block_expert,
                               block_valid, token_block=token_block,
                               activation=activation)
    if x_padded.device.type != "cuda":
        raise ValueError(f"no MoE FFN path for {x_padded.device}")
    _check(x_padded, (w_gate, w_up, w_down), block_expert, block_valid,
           token_block)
    m_pad, d = x_padded.shape
    f = w_up.shape[-1]
    h = torch.empty((m_pad, f), dtype=torch.float32, device=x_padded.device)
    out = torch.empty_like(x_padded)
    err = _kernels().moe_ffn(
        x_padded.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), block_expert.data_ptr(),
        block_valid.data_ptr(), h.data_ptr(), out.data_ptr(), m_pad, d, f,
        token_block, int(w_gate is not None),
        None if blocks is None else blocks.data_ptr(),
        torch.cuda.current_stream(x_padded.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_ffn launch failed: CUDA error {err}")
    grouped_ffn_padded.launches += 1
    return out


grouped_ffn_padded.launches = 0


def grouped_ffn(x_sorted: Tensor, params: Dict, group_sizes: Tensor,
                activation: str = "swiglu", n_tokens: int = 0) -> Tensor:
    """x_sorted: (M = T·k, d) token rows grouped by expert; group_sizes:
    (E,).  Returns (M, d) expert-FFN outputs in the same order.  The
    token block keys on the TOKEN count T (``n_tokens``, a host int from
    the shape; M when 0)."""
    m, d = x_sorted.shape
    e = group_sizes.shape[0]
    token_block = select_token_block(n_tokens or m, e)
    dev = x_sorted.device
    expert_of_sorted = torch.searchsorted(
        torch.cumsum(group_sizes, 0, dtype=torch.int32),
        torch.arange(m, dtype=torch.int32, device=dev), right=True,
        out_int32=True)
    slot, block_expert, block_valid, m_pad_max = align_block_size(
        expert_of_sorted, group_sizes, e, token_block)
    slot = slot.long()
    x_padded = x_sorted.new_zeros((m_pad_max, d))
    x_padded[slot] = x_sorted
    out_padded = grouped_ffn_padded(
        x_padded, params["w_gate"] if activation == "swiglu" else None,
        params["w_up"], params["w_down"], block_expert, block_valid,
        token_block=token_block, activation=activation)
    return out_padded[slot]
