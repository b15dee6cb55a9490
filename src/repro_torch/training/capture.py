"""The captured train step: one CUDA graph per batch shape.

The port's counterpart of the reference's ``jax.jit(make_train_step(...))``
(its ``launch/train.py`` and ``examples/train_lm.py``): on the card the
whole step (the forward, the backward with remat's recompute, micro-batch
accumulation, the clip and the AdamW update) is replayed as one
``torch.cuda.CUDAGraph`` instead of being launched op by op from Python.
``make_train_step`` stays the plain eager function; callers wrap it where
the reference calls ``jax.jit``:

    step = compiled_train_step(make_train_step(cfg, opt_cfg, ...), device)
    params, opt_state, metrics = step(params, opt_state, batch)

The key is the batch's leaf names, shapes and dtypes; the static
arguments (cfg, opt_cfg, n_micro, remat, compress) are fixed by the
wrapped function, as jit's are.  The first call of a key runs the step
eagerly on a side stream (that run IS the step: its update and metrics
count, and it warms up cuBLAS handles, the autograd threads and
checkpoint's lazy state), then captures the step into the trainer's one
memory pool.  A capture records the work and runs none of it, so the
state advances once.  Every later call copies the batch into the key's
static buffers and replays the graph.

The graph bakes in the address of every param and AdamW leaf: the step
updates them in place (``adamw_update``), and ``step`` and the learning
rate are device tensors.  The wrapper holds the leaves of the state it
was first called with, and a call with any other leaf raises
``ValueError``: a restored checkpoint is copied into the live state, never
swapped in.  The metrics a replay writes live in the pool and the next
replay overwrites them, so every call returns clones of them (device
copies, no host read).

A capture or replay that fails raises; nothing carries on eagerly on the
card.  ``capture=False`` gives the eager twin (``EagerTrainStep``): the
same keys, static batch buffers and returned clones over eager steps, on
any device: the CPU's path and the card's eager reference.

The sharded step (``dist.sharded_train``) is not captured: its
collectives run over gloo in every run one card can give, and a gloo
collective cannot be captured.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.tree import leaves, leaves_with_paths, path_key, tree_map
from repro_torch.serving.capture import _copy_into, _set_counts, launch_counts

Tensor = torch.Tensor


def batch_key(batch: Dict) -> Tuple:
    """The compile key of a batch: its leaves' names, shapes and dtypes."""
    return tuple((path_key(path), tuple(t.shape), t.dtype)
                 for path, t in leaves_with_paths(batch))


def _state(params, opt_state) -> list:
    return list(leaves_with_paths({"params": params,
                                   "opt_state": opt_state}))


def _clones(metrics: Dict) -> Dict:
    return tree_map(torch.Tensor.clone, metrics)


@dataclass
class CapturedTrainStep:
    graph: Optional[torch.cuda.CUDAGraph]
    batch: Dict                       # static batch buffers, rewritten per
                                      # call
    metrics: Optional[Dict]           # the step's metrics: pool-owned (a
                                      # graph), the first call's (eager)
    launches: Dict[str, int]          # kernel launches per replay
    eager_s: float                    # host time of the first call's eager
                                      # step (ending in the capture's
                                      # synchronize)
    capture_s: float                  # host time of the capture


class TrainGraphs:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with one CUDA graph per batch key, as the module says."""

    captures = True

    def __init__(self, step_fn: Callable, device: torch.device):
        device = torch.device(device)
        if self.captures and device.type != "cuda":
            raise ValueError(f"a CUDA graph captures device work; the "
                             f"train step is on {device}")
        self.step_fn = step_fn
        self.device = device
        self.pool = None
        self.steps: Dict[Tuple, CapturedTrainStep] = {}
        self.held: Optional[List[Tensor]] = None

    def __call__(self, params, opt_state, batch: Dict):
        self._check_state(params, opt_state)
        step = self.steps.get(batch_key(batch))
        if step is None:
            metrics = self._first(params, opt_state, batch)
        else:
            metrics = self.replay(step, params, opt_state, batch)
        return params, opt_state, metrics

    def replay(self, step: CapturedTrainStep, params, opt_state,
               batch: Dict) -> Dict:
        """Copy ``batch`` into ``step``'s static buffers and replay its
        graph (which updates ``params`` / ``opt_state``, the leaves it was
        captured with); returns clones of the metrics it wrote."""
        for buf, x in zip(leaves(step.batch), leaves(batch)):
            buf.copy_(x)
        step.graph.replay()
        counts = launch_counts()
        for name, n in step.launches.items():
            counts[name] += n
        _set_counts(counts)
        return _clones(step.metrics)

    def summary(self) -> Dict[str, float]:
        """Graphs, and the first calls' eager and capture seconds."""
        return {"graphs": len(self.steps),
                "eager_s": sum(s.eager_s for s in self.steps.values()),
                "capture_s": sum(s.capture_s for s in self.steps.values())}

    def _check_state(self, params, opt_state) -> None:
        """The state must be the leaves the graphs were captured with."""
        live = _state(params, opt_state)
        if self.held is None:
            self.held = [t for _, t in live]
            return
        if len(live) != len(self.held):
            raise ValueError(f"train step called with {len(live)} state "
                             f"leaves; it was captured with "
                             f"{len(self.held)}")
        for (path, t), held in zip(live, self.held):
            if t is not held:
                raise ValueError(
                    f"train step called with another tensor at "
                    f"{path_key(path)} than it was captured with: copy a "
                    f"restored state into the live leaves instead")

    def _eager(self, params, opt_state, batch: Dict) -> Dict:
        """The step itself, eagerly; it must update the state in place."""
        p, o, metrics = self.step_fn(params, opt_state, batch)
        if any(a is not b for (_, a), (_, b) in
               zip(_state(p, o), _state(params, opt_state))):
            raise ValueError("the train step returned new state tensors; "
                             "a captured step must update them in place")
        return metrics

    def _first(self, params, opt_state, batch: Dict) -> Dict:
        """The first call of a key: the step eagerly on a side stream,
        then its capture (which runs nothing)."""
        t0 = time.perf_counter()
        static = tree_map(torch.Tensor.clone, batch)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = _clones(self._eager(params, opt_state, static))
        current.wait_stream(side)
        torch.cuda.empty_cache()
        mark = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: it may free another
        # graph's tensors, which a capturing stream forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                # entering the capture synchronized: the eager step is done
                t1 = time.perf_counter()
                _, _, outputs = self.step_fn(params, opt_state, static)
        finally:
            if collecting:
                gc.enable()
        if self.pool is None:
            self.pool = graph.pool()
        after = launch_counts()
        # the eager step counted its own launches; the capture ran none
        _set_counts(mark)
        self.steps[batch_key(batch)] = CapturedTrainStep(
            graph, static, outputs, {k: after[k] - mark[k] for k in after},
            t1 - t0, time.perf_counter() - t1)
        return metrics


class EagerTrainStep(TrainGraphs):
    """The captured step without CUDA graphs, on any device: every call of
    a key copies the batch into the key's static buffers and runs the step
    eagerly over them, the metrics copied into the first call's metric
    tensors, and returns clones of them, as a replay does."""

    captures = False

    def replay(self, step: CapturedTrainStep, params, opt_state,
               batch: Dict) -> Dict:
        for buf, x in zip(leaves(step.batch), leaves(batch)):
            buf.copy_(x)
        metrics = self._eager(params, opt_state, step.batch)
        if step.metrics is None:
            step.metrics = metrics
        else:
            _copy_into(step.metrics, metrics)
        return _clones(step.metrics)

    def _first(self, params, opt_state, batch: Dict) -> Dict:
        step = self.steps[batch_key(batch)] = CapturedTrainStep(
            None, tree_map(torch.Tensor.clone, batch), None, {}, 0.0, 0.0)
        return self.replay(step, params, opt_state, batch)


def compiled_train_step(step_fn: Callable, device,
                        capture: bool = True) -> TrainGraphs:
    """``step_fn`` (``make_train_step``'s) compiled per batch shape: CUDA
    graphs (``capture``, on the card only) or the eager twin."""
    return (TrainGraphs if capture else EagerTrainStep)(step_fn, device)
