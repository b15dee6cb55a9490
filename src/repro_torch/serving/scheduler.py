"""Budget-aware continuous-batching scheduler over one DecodeEngine.

The paper's Sec. 6 reads N_max(eps) as a deployment knob: how many
decode positions one forward carries near-free.  The scheduler spends it
across many concurrent requests:

  - each request owns a SLOT (one batch row) of the engine's cache, at
    its own sequence length,
  - admission keeps the active set small enough that every request gets
    at least one position inside the budget; newly admitted requests are
    prefilled TOGETHER in one bucketed forward,
  - every step the adapter drives one batched multi-position forward
    whose total positions (active slots x width) stay within N_max(eps).

Modes, each a ``SlotAdapter`` (``serving.algorithm``):

  greedy       one position per request per forward,
  speculative  per-request n-gram verification windows,
  mtp          per-request head-bank proposals from each row's last
               hidden state, one shared verify forward,
  diffusion    per-request mask-block refinement: every refinement
               iteration is one shared forward, and a last shared forward
               over the resolved blocks commits their K/V.

Greedy, speculative and mtp streams are identical to each request decoded
alone by greedy decoding; diffusion streams are identical to the solo
``DiffusionBlockDecoder`` at the same block size.  A model with recurrent
(SSM) state serves greedy only: a verify or refinement forward advances
the state over every drafted or masked position, and the state after the
accepted prefix is not kept.

Load-pressure policies, as in the reference: ``submit`` backpressure
(bounded waiting queue -> ``AdmissionRejected``), SLO-class priority
admission, and ``preempt`` with recompute-on-resume.  Admission runs at
the arrival boundary (``run`` calls ``admit``); ``step`` only decodes.

Budget control, as in the reference: a ``controller``
(``autotune.BudgetController``) refines the analytic budget per step
against the step latency the loop observes, and a ``step_clock`` model
(``core.simulate``) can stand in for the wall clock.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention.ops import slack_report
from repro_torch.serving.algorithm import SlotAdapter
from repro_torch.serving.diffusion import DiffusionSlotAdapter
from repro_torch.serving.engine import DecodeEngine, greedy_tokens
from repro_torch.serving.mtp import MTPSlotAdapter
from repro_torch.serving.spans import (ADMIT_PHASES, BEGIN, COMMIT, PLAN,
                                       STEP_PHASES, UPLOAD, WAIT)
from repro_torch.serving.speculative import SpeculativeSlotAdapter

__all__ = ["AdmissionConfig", "AdmissionRejected", "Request", "SLOClass",
           "ServingLoop", "DEFAULT_SLO_CLASSES"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class SLOClass:
    """One multi-tenant service class: admission priority plus the
    latency targets ``loadgen.stats`` scores goodput against."""

    name: str
    priority: int = 0                  # higher admits first, preempts lower
    ttft_target_s: float = float("inf")
    itl_target_s: float = float("inf")


#: interactive beats default beats batch in admission order; the targets
#: are the reference's, so a replay scores goodput as the reference does
DEFAULT_SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", priority=10,
                            ttft_target_s=0.5, itl_target_s=0.05),
    "default": SLOClass("default", priority=0,
                        ttft_target_s=2.0, itl_target_s=0.2),
    "batch": SLOClass("batch", priority=-10),
}


class AdmissionRejected(RuntimeError):
    """Backpressure: the waiting queue is at ``max_waiting`` capacity."""


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control knobs (defaults: unbounded FIFO queue, no
    preemption, one class).

    ``max_waiting``  bounds the waiting queue; ``submit`` beyond it
                     raises ``AdmissionRejected``.
    ``preemption``   lets ``admit`` evict the lowest-priority active
                     request when a STRICTLY higher-priority arrival
                     cannot get a slot or enough KV blocks.
    ``classes``      the SLO-class registry (None -> defaults).
    """

    max_waiting: Optional[int] = None
    preemption: bool = False
    classes: Optional[Dict[str, SLOClass]] = None

    def slo(self, name: str) -> SLOClass:
        table = self.classes if self.classes is not None \
            else DEFAULT_SLO_CLASSES
        return table[name]


@dataclass
class Request:
    """One generation request and its runtime state."""

    rid: int
    prompt: np.ndarray                     # (p,) int64
    max_tokens: int
    generated: List[int] = field(default_factory=list)
    pending: Optional[int] = None          # next token to feed (emitted,
    slot: Optional[int] = None             #   not yet in the cache)
    hidden: Optional[Tensor] = None        # (d,) state MTP proposes from
    done: bool = False
    slo_class: str = "default"
    preemptions: int = 0                   # times evicted + requeued

    @property
    def context(self) -> np.ndarray:
        """Tokens whose KV is committed in the request's cache slot."""
        n_cached = len(self.generated) - 1      # all but the pending token
        return np.concatenate(
            [self.prompt, self.generated[:n_cached]]).astype(np.int64)

    def tokens(self) -> np.ndarray:
        return np.asarray(self.generated[:self.max_tokens], np.int64)


class ServingLoop:
    """Multiplex concurrent requests through one shared DecodeEngine.

    ``mode`` selects the per-slot adapter, or ``adapter=`` plugs in a
    ``SlotAdapter`` instance (it receives this loop as its ``loop``; its
    ``mode`` names the loop's).  ``mtp_heads`` feeds the mtp adapter, ``block_size`` /
    ``refine_steps`` / ``mask_id`` the diffusion one.

    ``controller`` (an ``autotune.BudgetController``) replaces the raw
    analytic budget per step: the analytic value stays the hard cap, and
    the controller shrinks and probes inside it against the observed
    step latency (admission keeps the analytic gate).  ``step_clock(width,
    ell) -> seconds`` substitutes a latency model for the wall clock, one
    call per forward of a step.

    Telemetry.  ``step_log`` has one entry per forward; a step's own
    fields go on its last forward's entry.  ``step_latency_s`` is the host
    time of the adapter's ``run_step`` (what the controller observes).
    The step's host time and its phases, in seconds, are read at each
    phase boundary from one clock (``serving.spans``), so the five sum to
    the whole:

      host_step_s    the whole ``step()``, budget to retire
      host_plan_s    ``budget()``, ``width()``, the token array, drafts,
                     and the entry's own telemetry (the modelled
                     attention slack)
      host_upload_s  the tokens to the device, the block tables, the
                     copies into the graph's static buffers
      host_launch_s  the graph's replay (eagerly: the forward) and the
                     launch counters
      host_wait_s    the argmax and the tokens' readback: the host
                     waiting on the device
      host_commit_s  acceptance, ``commit_slots``, retiring finished
                     requests

    A diffusion step's several forwards add to the same five.  On a CUDA
    engine each forward's entry whose results were read back also has
    ``graph_device_s``: the device's time from the decode graph's input
    copy to its last node, bubbles inside it and the wait for its launch
    included (``DecodeGraphs.device_seconds``).

    An admitting ``admit()`` puts on its last ``engine.prefill_log``
    entry ``rids`` (the admitted request ids) and, in seconds:

      host_admit_s    the whole call
      host_select_s   candidates, budgets, block costs, the pool's plans
      host_prefill_s  the grid input and the prefill graph's launch
      host_scatter_s  the paged scatter's index arrays and its launch
      host_wait_s     the host waiting on the device: the scatter's
                      index upload (from pageable memory, so it waits
                      for the prefill), the first tokens' argmax and
                      readback
      host_begin_s    slot bookkeeping, ``register_prompt``, the
                      adapter's ``begin``

    While a profiler runs, each call and phase is also a
    ``torch.profiler.record_function`` range (``serve.step``,
    ``serve.step.plan``, ..., ``serve.admit.select``, ...) on its
    timeline; with none running no range is made.  A call that began
    under a profiler, or after one ran on the engine's calls, is marked
    ``profiled: True`` on its entry: its times hold the profiler's cost,
    which outlasts the profiler (``serving.spans``)."""

    MODES = ("greedy", "speculative", "diffusion", "mtp")

    def __init__(self, engine: DecodeEngine, mode: str = "greedy",
                 eps: float = 0.2, max_width: int = 16,
                 adapter: Optional[SlotAdapter] = None,
                 mtp_heads: Optional[Dict] = None,
                 block_size: Optional[int] = None, refine_steps: int = 4,
                 mask_id: Optional[int] = None,
                 controller=None,
                 step_clock: Optional[Callable[[int, int], float]] = None,
                 admission: Optional[AdmissionConfig] = None):
        self.engine = engine
        self.eps = eps
        self.max_width = max_width
        self.controller = controller
        self.step_clock = step_clock
        self.admission = admission if admission is not None \
            else AdmissionConfig()
        if adapter is None:
            if mode not in self.MODES:
                raise ValueError(f"unknown serving mode {mode!r}")
            if mode == "speculative":
                adapter = SpeculativeSlotAdapter(self)
            elif mode == "mtp":
                adapter = MTPSlotAdapter(self, mtp_heads)
            elif mode == "diffusion":
                adapter = DiffusionSlotAdapter(
                    self, block_size=block_size, refine_steps=refine_steps,
                    mask_id=mask_id)
            else:
                adapter = SlotAdapter(self)
        adapter.loop = self
        if adapter.mode != "greedy" and engine.recurrent:
            raise ValueError(
                f"serving mode {adapter.mode!r} on {engine.cfg.name}: its "
                "recurrent SSM state would take in the rejected or masked "
                "positions of every multi-position forward; serve it "
                "greedy")
        self.adapter = adapter
        self.mode = adapter.mode
        if controller is not None:
            controller.bind(self.mode, engine.use_kernel,
                            clocked=step_clock is not None)
        # budget provenance of the CURRENT step (set by ``budget()``,
        # read by ``shared_forward`` telemetry and ``step`` timing)
        self._budget_info: Dict = {}
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}            # slot -> request
        self.free_slots: List[int] = list(range(engine.batch))
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self.preempted_total = 0
        self.resumed_total = 0
        self.rejected_total = 0
        # engine.prefill_log outlives this loop — remember where ours starts
        self._prefill_log_start = len(engine.prefill_log)
        # one telemetry entry per FORWARD (diffusion: per refinement and
        # commit forward): active/width/positions/budget plus, on the
        # kernel path, its modelled granularity slack
        self.step_log: List[Dict] = []

    # ------------------------------------------------------------------
    def submit(self, prompt, max_tokens: int,
               slo_class: str = "default") -> Request:
        try:
            self.admission.slo(slo_class)
        except KeyError:
            raise ValueError(f"unknown SLO class {slo_class!r}") from None
        cap = self.admission.max_waiting
        if cap is not None and len(self.waiting) >= cap:
            self.rejected_total += 1
            raise AdmissionRejected(
                f"waiting queue at capacity ({cap}); shed load or retry")
        prompt = np.asarray(prompt, np.int64).ravel()
        headroom = self.adapter.headroom()
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the engine's "
                f"max_len={self.engine.max_len}; it can never be admitted")
        if len(prompt) + int(max_tokens) + headroom > self.engine.max_len:
            raise ValueError(
                f"request of {len(prompt)} prompt + {max_tokens} tokens "
                f"(+{headroom} draft headroom) cannot fit "
                f"max_len={self.engine.max_len}")
        mgr = self.engine.manager
        if mgr is not None:
            worst = -(-min(len(prompt) + int(max_tokens) + headroom,
                           self.engine.max_len) // mgr.block_size)
            if worst > mgr.n_blocks:
                raise ValueError(
                    f"request needs up to {worst} KV blocks but the pool "
                    f"only has {mgr.n_blocks}; it can never be admitted")
        req = Request(self._next_rid, prompt, int(max_tokens),
                      slo_class=slo_class)
        self._next_rid += 1
        self.waiting.append(req)
        return req

    # ------------------------------------------------------------------
    def budget(self) -> int:
        """Position budget at the CURRENT longest active context: the
        analytic NFP budget, refined by the controller when one is
        attached (analytic / calibrated / applied provenance lands in
        each forward's ``step_log`` entry).  Reads the engine's host
        mirror of the slot lengths, never the device."""
        lens = self.engine.slot_lens_host
        ell = max(int(lens.max()) if lens.size else 1, 1)
        analytic = self.engine.nfp_budget(self.eps, ell=ell)
        info = {"ell": ell, "analytic": analytic, "applied": analytic}
        if self.controller is not None:
            info["applied"] = self.controller.budget(
                ell, len(self.active), analytic)
            calibrated = self.controller.table_budget(
                ell, len(self.active), analytic)
            if calibrated is not None:
                info["calibrated"] = calibrated
        self._budget_info = info
        return info["applied"]

    def _reserve_len(self, req: Request) -> int:
        """Cache positions a request can touch over its lifetime."""
        return min(len(req.prompt) + req.max_tokens
                   + self.adapter.headroom(), self.engine.max_len)

    @staticmethod
    def _admit_tokens(req: Request) -> np.ndarray:
        """Positions a (re-)admission must have committed KV for: the
        prompt, or for a preempted request its whole context (recompute
        on resume — the stream itself is host state)."""
        return req.context if req.generated else req.prompt

    def _priority(self, req: Request) -> int:
        return self.admission.slo(req.slo_class).priority

    def _pop_candidate(self) -> Optional[Request]:
        """Highest-priority waiting request (FIFO within a class)."""
        if not self.waiting:
            return None
        best = min(self.waiting, key=lambda r: (-self._priority(r), r.rid))
        self.waiting.remove(best)
        return best

    def _block_cost(self, req: Request) -> int:
        """Pool blocks this admission consumes: fresh allocations plus
        the evictable cached blocks it would pin."""
        mgr = self.engine.manager
        if mgr is None:
            return 0
        need, pinned = mgr.admission_cost(
            self._admit_tokens(req).tolist(), self._reserve_len(req))
        return need + pinned

    def _blocks_left(self, promised: int) -> int:
        mgr = self.engine.manager
        return (mgr.available_blocks() - promised) if mgr is not None else 0

    def _fits(self, req: Request, promised: int) -> bool:
        if not self.free_slots:
            return False
        if self.engine.manager is None:
            return True
        return self._block_cost(req) <= self._blocks_left(promised)

    def preempt(self, slot: int) -> Request:
        """Evict the request in ``slot`` mid-stream and requeue it for
        recompute-on-resume."""
        req = self.active.pop(slot)
        self.engine.preempt_slot(slot)
        self.free_slots.append(slot)
        req.slot = None
        req.hidden = None           # MTP: rebuilt from the resume prefill
        req.preemptions += 1
        self.preempted_total += 1
        self.waiting.appendleft(req)
        return req

    def _preempt_for(self, cand: Request, promised: int) -> None:
        """Evict strictly-lower-priority active requests while ``cand``
        cannot get a slot or enough KV blocks."""
        while not self._fits(cand, promised):
            victims = [s for s, r in self.active.items()
                       if self._priority(r) < self._priority(cand)]
            if not victims:
                return
            victim = max(victims, key=lambda s: (
                -self._priority(self.active[s]), self.active[s].rid))
            self.preempt(victim)

    def admit(self) -> int:
        """Fill free slots in SLO-priority order while every active
        request still fits >= 1 position inside the budget (and, paged,
        the pool covers each reservation), then prefill ALL newly admitted
        slots together.  Returns the number admitted.  One batched argmax
        and one small readback give every fresh request its first token.
        An admitting call's host phases and request ids go on its last
        ``engine.prefill_log`` entry (class docstring)."""
        phases = self.engine.phases
        phases.start("serve.admit", ADMIT_PHASES)
        admitted: Dict[int, Request] = {}
        promised = 0                      # blocks owed to this group
        ell = int(self.engine.slot_lens_host.max())
        while self.free_slots or self.admission.preemption:
            cand = self._pop_candidate()
            if cand is None:
                break
            if self.admission.preemption:
                self._preempt_for(cand, promised)
            ell_next = max(ell, len(self._admit_tokens(cand)), 1)
            budget = self.engine.nfp_budget(self.eps, ell=ell_next)
            over_budget = (len(self.active) + len(admitted)
                           >= max(1, budget))
            if over_budget or not self._fits(cand, promised):
                self.waiting.appendleft(cand)
                break
            promised += self._block_cost(cand)
            slot = self.free_slots.pop(0)
            cand.slot = slot
            admitted[slot] = cand
            ell = ell_next
        if not admitted:
            phases.stop()
            return 0
        outs = self.engine.prefill_slots(
            {s: self._admit_tokens(r) for s, r in admitted.items()},
            reserve={s: self._reserve_len(r) for s, r in admitted.items()})
        fresh = sorted(s for s, r in admitted.items() if not r.generated)
        if fresh:
            phases.mark(WAIT)
            first = np.asarray(greedy_tokens(torch.stack(
                [outs[s][0] for s in fresh])).cpu())
            phases.mark(BEGIN)
            for i, s in enumerate(fresh):
                req = admitted[s]
                req.pending = int(first[i])
                req.generated = [req.pending]
        for slot, req in admitted.items():
            if req.preemptions and slot not in fresh:
                self.resumed_total += 1
            self.active[slot] = req
            self.adapter.begin(req, outs[slot][1])
        entry = self.engine.prefill_log[-1]
        phases.stop(entry)
        entry["rids"] = [r.rid for r in admitted.values()]
        return len(admitted)

    # ------------------------------------------------------------------
    def _attn_slack(self, width: int) -> Optional[Dict]:
        """This forward's modelled decode-attention slack (None off the
        kernel path, where nothing is tiled, and for the models the kernel
        does not serve: MLA and no attention)."""
        a = self.engine.cfg.attention
        if not self.engine.use_kernel or a is None or a.kind == "mla":
            return None
        active = np.zeros(self.engine.batch, bool)
        active[list(self.active)] = True
        extra = {}
        if self.engine.manager is not None:
            # the paged launch tiles kv by PAGE
            extra["k_block"] = self.engine.manager.block_size
        return slack_report(
            width, self.engine.slot_lens_host, self.engine.max_len,
            head_dim=a.head_dim,
            window=a.window if a.kind == "swa" else None,
            active=active, **extra)

    def shared_forward(self, tokens: np.ndarray, budget: int
                       ) -> Tuple[Tensor, Dict, Tensor]:
        """ONE batched multi-position decode forward over all slots,
        WITHOUT committing lengths; appends this forward's telemetry.
        Returns (logits, cache, hidden)."""
        width = tokens.shape[1]
        entry = {
            "active": len(self.active), "width": width,
            "positions": len(self.active) * width, "budget": budget,
            "budget_analytic": self._budget_info.get("analytic", budget),
            "ell": self._budget_info.get("ell", 1),
        }
        if "calibrated" in self._budget_info:
            entry["budget_calibrated"] = self._budget_info["calibrated"]
        if self.engine.manager is not None:
            entry["kv_blocks_used"] = self.engine.manager.blocks_used()
        slack = self._attn_slack(width)
        if slack is not None:
            entry.update({
                "attn_rows_physical": slack["rows_physical"],
                "attn_row_util": slack["row_utilization"],
                "kv_tiles_executed": slack["kv_tiles_executed"],
                "kv_tiles_grid": slack["kv_tiles_grid"],
                "kv_tiles_skipped": slack["kv_tiles_skipped"],
                "kv_tile_util": slack["kv_tile_utilization"],
            })
        self.step_log.append(entry)
        phases = self.engine.phases
        phases.mark(UPLOAD)
        out = self.engine.decode_slots(
            torch.as_tensor(tokens, device=self.engine.device))
        phases.mark(WAIT)
        return out

    def read_back(self, phase: str) -> None:
        """The last forward's results are on the host: the step goes on in
        ``phase``, and on a CUDA engine the forward's entry takes its
        decode graph's device time (``graph_device_s``), whose events the
        readback has waited for."""
        self.engine.phases.mark(phase)
        seconds = self.engine.graphs.device_seconds()
        if seconds is not None:
            self.step_log[-1]["graph_device_s"] = seconds

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One DECODE iteration: the adapter drives its shared forward and
        per-slot commit, then finished requests retire.  Returns False
        when no work remains."""
        if not self.active:
            return bool(self.waiting)
        phases = self.engine.phases
        phases.start("serve.step", STEP_PHASES)
        budget = self.budget()
        slots = sorted(self.active)
        width = self.adapter.width(len(slots), budget)
        mark = len(self.step_log)
        t0 = phases.mark(PLAN)
        self.adapter.run_step(slots, width, budget)
        # --- step latency + controller feedback ------------------------
        # run_step waits on its token readback, so the host clock spans
        # the step's device work; step_clock substitutes a latency model
        # per forward
        dt = phases.mark(COMMIT) - t0
        new = self.step_log[mark:]
        if new:
            if self.step_clock is not None:
                ell = self._budget_info.get("ell", 1)
                dt = sum(self.step_clock(e["width"], ell) for e in new)
            new[-1]["step_latency_s"] = dt
            if self.controller is not None:
                ratio = self.controller.observe(
                    self._budget_info.get("ell", 1),
                    max(e["width"] for e in new), dt / len(new))
                if ratio is not None:
                    new[-1]["latency_ratio"] = ratio
        # --- retire ----------------------------------------------------
        for s in slots:
            req = self.active[s]
            if len(req.generated) >= req.max_tokens:
                req.done = True
                self.finished[req.rid] = req
                del self.active[s]
                self.engine.release_slot(s)
                self.free_slots.append(s)
        phases.stop(new[-1] if new else None)
        return bool(self.active or self.waiting)

    # ------------------------------------------------------------------
    def run(self) -> Dict[int, np.ndarray]:
        """Serve until the queue drains; returns {rid: tokens}."""
        while True:
            self.admit()
            if not self.active and self.waiting:
                raise RuntimeError(
                    "admission stalled with an empty active set — the "
                    "pool cannot cover the head-of-queue reservation "
                    "(submit() should have rejected it)")
            if not self.step():
                break
        return {rid: req.tokens() for rid, req in
                sorted(self.finished.items())}

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        total_tokens = sum(len(r.tokens()) for r in self.finished.values())
        total_positions = sum(e["positions"] for e in self.step_log)
        forwards = len(self.step_log)
        out = {
            "requests": len(self.finished),
            "tokens": total_tokens,
            "forwards": forwards,
            "preemptions": self.preempted_total,
            "resumes": self.resumed_total,
            "rejections": self.rejected_total,
            "positions": total_positions,
            "tokens_per_forward": total_tokens / max(forwards, 1),
            "position_utilization": total_tokens / max(total_positions, 1),
            "max_positions_per_forward": max(
                (e["positions"] for e in self.step_log), default=0),
        }
        prefills = self.engine.prefill_log[self._prefill_log_start:]
        out["prefill_forwards"] = len(prefills)
        out["prefill_buckets"] = sorted({e["bucket"] for e in prefills})
        out["prefill_positions_computed"] = sum(
            e.get("computed_tokens", 0) for e in prefills)
        if self.engine.manager is not None:
            out.update(self.engine.manager.stats())
            out["prefill_positions_saved"] = sum(
                e.get("cached_tokens", 0) for e in prefills)
        # budget provenance: what the analytic predictor said, what the
        # calibration table said, what was spent — plus the controller's
        # observed-latency accounting when one is attached
        if self.step_log:
            out["mean_budget"] = (sum(e["budget"] for e in self.step_log)
                                  / len(self.step_log))
            out["mean_budget_analytic"] = (
                sum(e.get("budget_analytic", e["budget"])
                    for e in self.step_log) / len(self.step_log))
            calibrated = [e["budget_calibrated"] for e in self.step_log
                          if "budget_calibrated" in e]
            if calibrated:
                out["mean_budget_calibrated"] = (sum(calibrated)
                                                 / len(calibrated))
        latencies = [e["step_latency_s"] for e in self.step_log
                     if "step_latency_s" in e]
        if latencies:
            out["step_latency_total_s"] = sum(latencies)
        ratios = [e["latency_ratio"] for e in self.step_log
                  if "latency_ratio" in e]
        if ratios:
            out["mean_latency_ratio"] = sum(ratios) / len(ratios)
            out["max_latency_ratio"] = max(ratios)
        if self.controller is not None:
            out["controller"] = self.controller.stats()
        slacked = [e for e in self.step_log if "kv_tile_util" in e]
        if slacked:
            out["mean_attn_row_util"] = (
                sum(e["attn_row_util"] for e in slacked) / len(slacked))
            out["mean_kv_tile_util"] = (
                sum(e["kv_tile_util"] for e in slacked) / len(slacked))
            out["kv_tiles_skipped"] = sum(
                e["kv_tiles_skipped"] for e in slacked)
            out["kv_tiles_executed"] = sum(
                e["kv_tiles_executed"] for e in slacked)
        return out
