"""The captured forwards: one CUDA graph per compiled-program key.

The port's counterpart of the reference engine's jitted programs
(``_prefill_fn``, ``_decode_fn``, ``_decode_paged_fn``): a CUDA engine
replays a ``torch.cuda.CUDAGraph`` of each whole forward instead of
launching its few thousand kernels one by one from Python.  A graph is
captured at the first use of its key, and the keys are the reference's
compile keys:

  ("decode", n, use_kernel)             ``decode_slots`` at width n (the
                                        engine's batch), and the paged
                                        prefix-hit suffix forward at its
                                        bucket width
  ("prefill", batch, width, use_kernel) ``prefill_slots``' (batch, width)
                                        grid: a prompt bucket, or an SSM
                                        model's exact prompt length
  ("prefill_single", b, s, use_kernel)  ``prefill``
  ("decode_single", b, n, use_kernel)   ``decode_step`` / ``peek_step``

All graphs of one engine share one memory pool.  An engine without
capture runs the same forwards under the same keys eagerly
(``EagerGraphs``).

What a replay reads must sit at the address the capture saw, so every
input is a static buffer that ``run`` copies the call's values into (the
tokens, and a prefill's row flags and last positions), and everything
else the forward reads lives in the engine's own static tensors, written
with ``copy_`` / ``fill_``: ``slot_lens``, the single-request
``cache_len`` buffer, the paged block tables, the prefill scratch cache
and the cache itself (K/V are written in place by the forward; SSM
states are copied in by the engine).  What a replay returns (logits,
hidden states, new SSM states) lives in the shared pool, and ANY later
replay may overwrite it: a caller takes what it needs (the token
readback, a hidden row it keeps, a state commit) before the next
forward, or clones it.

Kernel launch counters (``launches`` on each kernel wrapper) are kept in
Python, and a replay calls no wrapper.  So the capture records how many
launches of each wrapper one forward makes, sets every counter back to
its value before the capture (its warm-up forward and the capture itself
count nothing), and every replay adds the recorded counts.

Every replay is timed on the device by one pair of CUDA events, made
once per engine: one recorded before its input copy, one after its
launch (``device_seconds`` reads the last replay).  Every ``run`` marks
the launch boundary on the engine's phase clock (``serving.spans``)
between its input copies and the launch.

A capture or replay that fails raises; nothing falls back to the eager
forward.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.serving.spans import LAUNCH, Phases

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
    inputs: tuple                     # static input tensors, rewritten per
                                      # replay
    outputs: Tuple                    # the forward's outputs, pool-owned
    launches: Dict[str, int]          # kernel launches per replay
    seconds: float                    # host time of the capture, warm-up
                                      # forward included


class DecodeGraphs:
    """The captured forwards of one engine, keyed as the module says.
    ``forward(tokens)`` is the engine's eager decode forward over its
    static buffers (the ``"decode"`` keys); the other keys bring their own
    forward to ``run`` / ``capture``."""

    def __init__(self, device: torch.device,
                 forward: Callable[[Tensor], Tuple], phases: Phases):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures device work; the "
                             f"engine is on {device}")
        self.device = device
        self.forward = forward
        self.phases = phases
        self.pool = None
        self.steps: Dict[Tuple, CapturedStep] = {}
        # the last replay's device time: recorded before its input copy
        # and after its launch, on the replaying stream
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._timed = False

    def warm(self, shape, use_kernel: bool) -> CapturedStep:
        """The decode step of ``shape`` (batch, n), captured if new."""
        tokens = torch.zeros(tuple(shape), dtype=torch.int64,
                             device=self.device)
        return self.capture(("decode", int(shape[1]), bool(use_kernel)),
                            self.forward, (tokens,))

    def replay(self, tokens: Tensor, use_kernel: bool) -> Tuple:
        """Copy ``tokens`` (batch, n) into the width's static buffer and
        replay its decode graph (capturing it first if new); returns the
        graph's static outputs."""
        return self.run(("decode", int(tokens.shape[1]), bool(use_kernel)),
                        self.forward, (tokens,))

    def capture(self, key: Tuple, forward: Callable,
                inputs: tuple) -> CapturedStep:
        """The graph of ``key``, captured if new: ``forward`` over static
        copies of ``inputs``, whose values its warm-up forward reads."""
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = self._capture(forward, inputs)
        return step

    def run(self, key: Tuple, forward: Callable,
            inputs: tuple) -> Tuple:
        """Copy ``inputs`` into the static buffers of ``key``'s graph and
        replay it (capturing it first, with ``forward``, if new); returns
        the graph's static outputs."""
        step = self.capture(key, forward, inputs)
        self._events[0].record()
        for buf, x in zip(step.inputs, inputs):
            buf.copy_(x)
        self.phases.mark(LAUNCH)
        step.graph.replay()
        self._events[1].record()
        self._timed = True
        counts = launch_counts()
        for name, n in step.launches.items():
            counts[name] += n
        _set_counts(counts)
        return step.outputs

    def device_seconds(self) -> Optional[float]:
        """Device seconds of the last replay, from its input copy
        to its last node (the launch's wait and any bubble inside the
        graph included); None before the first.  Read it once the replay's
        results are on the host: the events have then completed, and the
        read waits for nothing (an event not yet reached raises)."""
        if not self._timed:
            return None
        return self._events[0].elapsed_time(self._events[1]) / 1e3

    def summary(self) -> Dict[str, Tuple[int, float]]:
        """Graphs and capture seconds per kind of key (its first field)."""
        out: Dict[str, Tuple[int, float]] = {}
        for key, step in self.steps.items():
            n, s = out.get(key[0], (0, 0.0))
            out[key[0]] = (n + 1, s + step.seconds)
        return out

    def _capture(self, forward: Callable,
                 inputs: tuple) -> CapturedStep:
        t0 = time.perf_counter()
        before = launch_counts()
        inputs = tuple(x.clone() for x in inputs)
        # one eager forward on a side stream first: kernels are built and
        # loaded, library handles and workspaces made, outside the capture
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            forward(*inputs)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mark = launch_counts()
        # no garbage collection inside the capture: it may free an
        # unreachable engine's graph, which a capturing stream forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = forward(*inputs)
        finally:
            if collecting:
                gc.enable()
        if self.pool is None:
            self.pool = graph.pool()
        after = launch_counts()
        _set_counts(before)
        return CapturedStep(graph, inputs, outputs,
                            {k: after[k] - mark[k] for k in after},
                            time.perf_counter() - t0)


def _copy_into(dst, src) -> None:
    """Copy a forward's results into the tensors of an earlier result of
    the same structure (the same tensor object is left as it is)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    elif isinstance(dst, Tensor) and dst is not src:
        dst.copy_(src)


class EagerGraphs(DecodeGraphs):
    """The captured path without CUDA graphs, on any device: every ``run``
    of a key copies its inputs into the key's static buffers and runs its
    forward eagerly over them, the results copied into the outputs of the
    key's first run, so a caller gets what a replay gives it (the same
    output tensors, rewritten).  Nothing runs at ``capture``, and the
    forwards' kernel wrappers count their own launches.  The forwards of
    a ``capture=False`` engine (the CPU's, and the card's eager
    reference): a captured engine's, launched one by one.
    """

    def __init__(self, device: torch.device,
                 forward: Callable[[Tensor], Tuple], phases: Phases):
        self.device = device
        self.forward = forward
        self.phases = phases
        self.pool = None
        self.steps: Dict[Tuple, CapturedStep] = {}

    def capture(self, key: Tuple, forward: Callable,
                inputs: tuple) -> CapturedStep:
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = CapturedStep(
                None, tuple(x.clone() for x in inputs), None, {}, 0.0)
        return step

    def run(self, key: Tuple, forward: Callable,
            inputs: tuple) -> Tuple:
        step = self.capture(key, forward, inputs)
        for buf, x in zip(step.inputs, inputs):
            buf.copy_(x)
        self.phases.mark(LAUNCH)
        out = forward(*step.inputs)
        if step.outputs is None:
            step.outputs = out
        else:
            _copy_into(step.outputs, out)
        return step.outputs

    def device_seconds(self) -> Optional[float]:
        """None: an eager forward is not one device interval to time."""
        return None
