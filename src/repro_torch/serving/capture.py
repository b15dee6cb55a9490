"""The captured decode step: one CUDA graph per decode width.

The port's counterpart of the reference's jitted decode steps
(``_decode_fn`` / ``_decode_paged_fn``): ``DecodeEngine.decode_slots`` on
a CUDA engine replays a ``torch.cuda.CUDAGraph`` of the whole decode
forward instead of launching its few thousand kernels one by one from
Python.  One graph per (width n, kernel flag) at the engine's batch,
captured at first use; all graphs share one memory pool.

What a replay reads must sit at the address the capture saw, so the
engine keeps its inputs in static buffers and writes them with
``copy_``: the tokens (one buffer per graph), ``slot_lens``, the paged
block tables, and the cache (K/V are written in place by the forward;
SSM states are copied in by ``commit_slots``).  What a replay returns
(logits, hidden states, new SSM states) lives in the shared pool, and
ANY later replay may overwrite it: a caller takes what it needs (the
token readback, a hidden row it keeps, a state commit) before the next
decode step, or clones it.

Kernel launch counters (``launches`` on each kernel wrapper) are kept in
Python, and a replay calls no wrapper.  So the capture records how many
launches of each wrapper one forward makes, sets every counter back to
its value before the capture (its warm-up forward and the capture itself
count nothing), and every replay adds the recorded counts.

A capture or replay that fails raises; nothing falls back to the eager
forward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.moe_ffn import ops as moe_ops

Tensor = torch.Tensor

#: the kernel wrappers whose ``launches`` counters a replay advances
COUNTED = ((attn_ops, "decode_attention_ragged"),
           (attn_ops, "decode_attention_paged"),
           (moe_ops, "grouped_ffn_padded"),
           (scan_ops, "selective_scan_padded"))


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, name).launches for mod, name in COUNTED}


def _set_counts(counts: Dict[str, int]) -> None:
    for mod, name in COUNTED:
        getattr(mod, name).launches = counts[name]


@dataclass
class CapturedStep:
    graph: torch.cuda.CUDAGraph
    tokens: Tensor                    # static (batch, n) int64 input
    outputs: Tuple                    # (logits, cache, hidden), pool-owned
    launches: Dict[str, int]          # kernel launches per replay


class DecodeGraphs:
    """The captured decode steps of one engine.  ``forward(tokens)`` is
    the engine's eager decode forward over its static buffers."""

    def __init__(self, device: torch.device,
                 forward: Callable[[Tensor], Tuple]):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures device work; the "
                             f"engine is on {device}")
        self.device = device
        self.forward = forward
        self.pool = None
        self.steps: Dict[Tuple[int, bool], CapturedStep] = {}

    def warm(self, shape, use_kernel: bool) -> CapturedStep:
        """The captured step of ``shape`` (batch, n), captured if new."""
        key = (int(shape[1]), bool(use_kernel))
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = self._capture(shape)
        return step

    def replay(self, tokens: Tensor, use_kernel: bool) -> Tuple:
        """Copy ``tokens`` (batch, n) into the width's static buffer and
        replay its graph (capturing it first if new); returns the
        graph's static outputs."""
        step = self.warm(tokens.shape, use_kernel)
        step.tokens.copy_(tokens)
        step.graph.replay()
        counts = launch_counts()
        for name, n in step.launches.items():
            counts[name] += n
        _set_counts(counts)
        return step.outputs

    def _capture(self, shape) -> CapturedStep:
        before = launch_counts()
        tokens = torch.zeros(tuple(shape), dtype=torch.int64,
                             device=self.device)
        # one eager forward on a side stream first: kernels are built and
        # loaded, library handles and workspaces made, outside the capture
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.forward(tokens)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mark = launch_counts()
        with torch.cuda.graph(graph, pool=self.pool):
            outputs = self.forward(tokens)
        if self.pool is None:
            self.pool = graph.pool()
        after = launch_counts()
        _set_counts(before)
        return CapturedStep(graph, tokens, outputs,
                            {k: after[k] - mark[k] for k in after})
