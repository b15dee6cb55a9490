"""Offline empirical NFP calibration.

The analytic budget (``core.nfp.parallelism_budget``) is a closed-form
prediction; the paper's headline is that closed-form intuitions
over-predict the practical boundary.  This module sweeps T(N) on the
engine the scheduler will serve with — per (serve mode, context-length
bucket, kernel on/off) — extracts the empirical knee with the paper's
Eq. 4 protocol (``core.measure``), and records measured vs analytic
boundaries in a ``CalibrationTable`` the online ``BudgetController``
consumes.

Latency sources ("backends"):

  wallclock   times the engine's CAPTURED ``decode_slots`` (one CUDA
              graph replay per forward) with the App. C.1.2 protocol
              (warmup, R rounds x I iters, median of round medians +
              per-round spread), on CUDA events.  An eager forward's
              T(N) is host launch time, flat in N, so its knee would say
              nothing: an engine without capture is refused on the card.
              On the CPU (``capture=False``) it times the plain versions
              on the host clock, which checks the protocol, not a device.
  simulator   the roofline + granularity latency model
              (``core.simulate``) on the engine's ``HardwareSpec``,
              deterministic with zero spread.

The serving baseline is ALWAYS width 1 at the engine's full batch: the
knee answers "how many positions per slot row can one (batch, N)
forward carry before a width-1 step's latency grows past (1+eps)" — the
quantity the scheduler trades against.  The knee uses
``extract_nmax(contiguous=True)`` so a noisy rebound past the boundary
cannot inflate it.  This is the reference's ``autotune.calibrate`` with
a torch time function.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.autotune.store import (CalibrationEntry, CalibrationTable,
                                        spec_fingerprint)
from repro_torch.core.granularity import GranularitySpec
from repro_torch.core.measure import (LatencyCurve, extract_nmax,
                                      time_callable)
from repro_torch.core.nfp import parallelism_budget, predict_model
from repro_torch.core.simulate import decode_forward_cost

__all__ = ["DEFAULT_MODES", "context_buckets", "width_grid",
           "simulator_time_fn", "calibrate_specs", "calibrate_engine"]

DEFAULT_MODES = ("greedy", "speculative", "mtp", "diffusion")

# context-length ladder: powers of 4 — boundaries move slowly in ell
# (the attention idle term is the only ell-dependent one), so coarse
# buckets keep sweep cost low without losing the knee's ell trend
CONTEXT_LADDER = (64, 256, 1024, 4096, 16384, 65536)

# TimeFn(n, ell, use_kernel) -> (seconds per forward, relative spread)
TimeFn = Callable[[int, int, bool], Tuple[float, float]]


def context_buckets(max_len: int) -> List[int]:
    """Ladder buckets below ``max_len``, plus ``max_len`` itself."""
    bs = [b for b in CONTEXT_LADDER if b < max_len]
    return bs + [int(max_len)]


def width_grid(cap: int = 128) -> List[int]:
    """Sampled widths: dense at small N (the knees live there), then
    tile-boundary landmarks with one-past probes (16/64 + 1)."""
    ns = list(range(1, 9)) + [12, 16, 17, 24, 32, 48, 64, 65, 96, 128]
    return sorted({n for n in ns if n <= max(cap, 2)} | {1, 2})


def simulator_time_fn(cfg, hw, gran: GranularitySpec, batch: int,
                      routing: str = "balanced") -> TimeFn:
    """Roofline-simulator latency source (deterministic, zero spread)."""
    def fn(n: int, ell: int, use_kernel: bool) -> Tuple[float, float]:
        return (decode_forward_cost(cfg, batch, n, ell, gran, routing)
                .time(hw), 0.0)
    return fn


# ---------------------------------------------------------------------------
# Core sweep: pure specs + a latency source
# ---------------------------------------------------------------------------

def calibrate_specs(cfg, hw, gran: GranularitySpec, batch: int,
                    max_len: int = 4096,
                    modes: Sequence[str] = DEFAULT_MODES,
                    kernels: Sequence[bool] = (False,),
                    eps: float = 0.2,
                    buckets: Optional[Sequence[int]] = None,
                    ns: Optional[Sequence[int]] = None,
                    time_fn: Optional[TimeFn] = None,
                    backend: str = "simulator",
                    routing: str = "balanced") -> CalibrationTable:
    """Calibrate from specs alone against any latency source.

    One T(N) sweep runs per (context bucket, kernel flag); the decode
    forward itself is serve-mode independent, so every requested mode
    shares that curve — the mode axis exists in the artifact so the
    controller's lookup is explicit about what it serves (and so future
    mode-specific latency sources can fill it without a schema change).
    """
    if time_fn is None:
        time_fn = simulator_time_fn(cfg, hw, gran, batch, routing)
    buckets = list(buckets) if buckets else context_buckets(max_len)
    ns = list(ns) if ns else width_grid()
    entries: List[CalibrationEntry] = []
    for use_kernel in kernels:
        for ell in buckets:
            times, spreads = [], []
            for n in ns:
                t, spread = time_fn(int(n), int(ell), bool(use_kernel))
                times.append(float(t))
                spreads.append(float(spread))
            curve = LatencyCurve(ns, times, baseline_n=1, spreads=spreads)
            measured = extract_nmax(curve, eps, contiguous=True)
            analytic = parallelism_budget(cfg, hw, gran, batch, int(ell),
                                          eps, routing)
            pred = predict_model(cfg, hw, gran, batch, int(ell), routing)
            for mode in modes:
                entries.append(CalibrationEntry(
                    mode=mode, ell=int(ell), use_kernel=bool(use_kernel),
                    eps=float(eps), ns=[int(n) for n in ns], times=times,
                    spreads=spreads, baseline_time=curve.baseline_time,
                    noise=curve.max_spread, measured_nmax=int(measured),
                    analytic_nmax=int(analytic), n_idle=float(pred.n_idle),
                    limiting=pred.limiting))
    key = spec_fingerprint(cfg, hw, gran, kernels, batch, eps)
    return CalibrationTable(key=key, arch=cfg.name, hardware=hw.name,
                            batch=int(batch), eps=float(eps),
                            backend=backend, entries=entries)


# ---------------------------------------------------------------------------
# Live-engine calibration
# ---------------------------------------------------------------------------

def _wallclock_time_fn(engine, warmup: int, rounds: int,
                       iters: int) -> TimeFn:
    """Times real ``decode_slots`` forwards on the live engine: every
    slot row at cache length ell, one (batch, n) forward, no commit.
    Slot lengths are written INTO the engine's static buffers (a captured
    graph reads them there) and restored after each sample, as are the
    host mirror and the kernel flag."""

    def fn(n: int, ell: int, use_kernel: bool) -> Tuple[float, float]:
        saved_lens = engine.slot_lens.clone()
        saved_lens_host = engine.slot_lens_host.copy()
        saved_kernel = engine.use_kernel
        try:
            engine.slot_lens.fill_(int(ell))
            engine.slot_lens_host = np.full((engine.batch,), ell, np.int64)
            engine.use_kernel = use_kernel
            toks = torch.zeros((engine.batch, n), dtype=torch.int64,
                               device=engine.device)
            return time_callable(lambda: engine.decode_slots(toks),
                                 warmup, rounds, iters, engine.device)
        finally:
            engine.slot_lens.copy_(saved_lens)
            engine.slot_lens_host = saved_lens_host
            engine.use_kernel = saved_kernel
    return fn


def calibrate_engine(engine, modes: Sequence[str] = DEFAULT_MODES,
                     kernels: Optional[Sequence[bool]] = None,
                     eps: float = 0.2,
                     buckets: Optional[Sequence[int]] = None,
                     ns: Optional[Sequence[int]] = None,
                     backend: str = "auto",
                     warmup: int = 2, rounds: int = 3, iters: int = 5,
                     ) -> CalibrationTable:
    """Calibrate a live ``DecodeEngine``.

    ``backend="auto"`` picks wallclock on a CUDA engine and the roofline
    simulator on a CPU one (host timings of the plain versions say
    nothing about the card's knee)."""
    if backend == "auto":
        backend = ("wallclock" if engine.device.type == "cuda"
                   else "simulator")
    if kernels is None:
        kernels = (engine.use_kernel,)
    if ns is None:
        # a decode forward at bucket ell writes positions ell..ell+n-1,
        # so the width grid must leave headroom inside the engine's
        # cache even at the largest bucket
        ns = width_grid(cap=min(128, max(2, engine.max_len // 2)))
    max_n = max(ns)
    if max_n >= engine.max_len:
        raise ValueError(
            f"width grid reaches {max_n} but the engine cache holds only "
            f"{engine.max_len} positions; pass a smaller ns")
    if buckets is None:
        buckets = sorted({min(b, engine.max_len - max_n)
                          for b in context_buckets(engine.max_len)})
        buckets = [b for b in buckets if b >= 1]
        if not buckets:       # unreachable: max_len - max_n >= 1 above
            raise RuntimeError("derived an empty context-bucket grid")
    if backend == "wallclock":
        if max(buckets) + max_n > engine.max_len:
            raise ValueError(
                f"bucket {max(buckets)} + width {max_n} overruns the "
                f"engine's {engine.max_len}-position cache; live sweeps "
                "need ell + n <= max_len")
        if engine.manager is not None:
            raise ValueError(
                "wallclock calibration drives synthetic cache lengths "
                "through decode_slots, which a paged engine cannot serve "
                "without real block tables — calibrate a dense engine of "
                "the same config, or use backend='simulator'")
        if engine.device.type == "cuda" and not engine.capture:
            raise ValueError(
                "wallclock calibration on the card times the captured "
                "decode step; an eager forward's T(N) is host launch time "
                "and its knee says nothing — build the engine with "
                "capture=True")
        live = int(engine.slot_lens_host.max())
        if live > min(buckets):
            raise ValueError(
                f"a slot holds {live} committed positions, past bucket "
                f"{min(buckets)}: the sweep's forwards write K/V in place "
                "from each bucket on and would overwrite them — calibrate "
                "an engine without live requests")
        saved_kernel = engine.use_kernel
        try:                    # every graph captured before any timing
            for use_kernel in kernels:
                engine.use_kernel = bool(use_kernel)
                engine.warm_decode(ns)
        finally:
            engine.use_kernel = saved_kernel
        time_fn = _wallclock_time_fn(engine, warmup, rounds, iters)
    elif backend == "simulator":
        time_fn = simulator_time_fn(engine.cfg, engine.hardware,
                                    engine.gran, engine.batch)
    else:
        raise ValueError(f"unknown calibration backend {backend!r}")
    return calibrate_specs(engine.cfg, engine.hardware, engine.gran,
                           engine.batch, max_len=engine.max_len,
                           modes=modes, kernels=kernels, eps=eps,
                           buckets=buckets, ns=ns, time_fn=time_fn,
                           backend=backend)
