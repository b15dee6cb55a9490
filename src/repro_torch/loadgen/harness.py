"""Replay a trace through the port's ``ServingLoop`` on a virtual clock.

A copy of the reference's ``loadgen.harness``, catching the port's own
``AdmissionRejected``.  Open-loop replay: requests become visible to the
loop when the virtual clock reaches their ``arrival_s`` — never earlier,
so queueing delay, backpressure rejections and preemption pressure come
from the trace's shape.

The clock is whatever the loop itself runs on.  Each decode step's
``step_latency_s`` advances time: wall seconds (on the card, where the
step ends in its token readback), or the loop's injected ``step_clock``
model (``core.simulate``), which prices prefill too, per bucketed
``prefill_log`` entry (bucket positions at bucket context).  Without a
model clock, admission is timed on the host clock around ``admit``,
after a synchronize on a CUDA engine so the prefill's device work lands
in the first token's time.  With a model clock the replay is
DETERMINISTIC: two same-seed runs give identical metrics.

Token timestamps: every token a request has accumulated by the end of a
step or admission materializes at that boundary's clock reading — the
first token at (re)prefill completion, so TTFT = queue wait + prefill,
and parallel-decoded tokens of one step share a timestamp (ITL 0.0 gaps
are real parallelism).

``PINNED_STACK`` is the serving stack the pinned trace is replayed on
(the reference's ``benchmarks/load_harness.py``), and ``scorecard``
turns a replay report into its JSON scorecard.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.loadgen.stats import RequestRecord, summarize
from repro_torch.loadgen.trace import Trace
from repro_torch.serving.scheduler import AdmissionRejected, ServingLoop

__all__ = ["PINNED_STACK", "PinnedStack", "replay_trace", "scorecard"]

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class PinnedStack:
    """The serving configuration of the pinned replay: a paged engine
    with a deliberately tight block pool (preemption fires), bounded
    waiting queue, SLO-priority admission with preemption, and the
    speculative adapter."""

    arch: str = "stablelm_3b"
    mode: str = "speculative"
    slots: int = 4
    max_len: int = 256
    kv_block_size: int = 16
    kv_blocks: int = 24
    max_waiting: int = 6
    preemption: bool = True
    eps: float = 0.2


PINNED_STACK = PinnedStack()

#: the loop counters a scorecard keeps (the reference's scorecard keys)
SERVING_KEYS = ("requests", "tokens", "forwards", "tokens_per_forward",
                "preemptions", "resumes", "rejections",
                "prefill_forwards", "prefill_positions_computed",
                "prefill_positions_saved", "kv_preemptions",
                "kv_preempt_blocks_freed")


def replay_trace(loop: ServingLoop, trace: Trace,
                 max_virtual_s: Optional[float] = None) -> Dict:
    """Drive ``loop`` with ``trace``; returns a report dict with the
    per-request ``records``, the ``summarize`` metrics, the loop's own
    ``stats`` and the final token streams (trace-rid keyed)."""
    records = {t.rid: RequestRecord(
        rid=t.rid, slo_class=t.slo_class, tenant=t.tenant,
        arrival_s=t.arrival_s) for t in trace.requests}
    handles: Dict[int, int] = {}             # loop rid -> trace rid
    eng = loop.engine
    clocked = loop.step_clock is not None
    now = 0.0
    i = 0
    pending = list(trace.requests)

    def drain(at: float) -> None:
        """Timestamp every newly materialized token at ``at``."""
        for loop_rid, trace_rid in handles.items():
            req = loop.finished.get(loop_rid)
            if req is None:
                for r in loop.active.values():
                    if r.rid == loop_rid:
                        req = r
                        break
            if req is None:                   # still waiting / preempted
                for r in loop.waiting:
                    if r.rid == loop_rid:
                        req = r
                        break
            if req is None:
                continue
            rec = records[trace_rid]
            n = int(req.tokens().shape[0])
            while rec.n_tokens < n:
                rec.token_times.append(at)
            rec.preemptions = req.preemptions

    while True:
        # --- arrivals due by ``now`` enter the loop's queue ------------
        while i < len(pending) and pending[i].arrival_s <= now + 1e-12:
            t = pending[i]
            i += 1
            try:
                req = loop.submit(np.asarray(t.prompt, np.int64),
                                  t.max_tokens, slo_class=t.slo_class)
                handles[req.rid] = t.rid
            except AdmissionRejected:
                records[t.rid].rejected = True
        # --- admission (prefill cost advances the clock) ---------------
        pmark = len(eng.prefill_log)
        t0 = time.perf_counter()
        loop.admit()
        if clocked:
            for e in eng.prefill_log[pmark:]:
                b = max(int(e["bucket"]), 1)
                now += loop.step_clock(b, b)
        else:
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            now += time.perf_counter() - t0
        drain(now)                        # first tokens land at prefill end
        if not loop.active:
            if i < len(pending):
                if loop.waiting:
                    raise RuntimeError(
                        "replay stalled: waiting requests cannot be "
                        "admitted and nothing is active to retire")
                now = max(now, pending[i].arrival_s)   # idle-skip
                continue
            if loop.waiting:
                raise RuntimeError(
                    "replay stalled with requests still waiting")
            break                                       # fully drained
        # --- one decode step -------------------------------------------
        smark = len(loop.step_log)
        loop.step()
        now += sum(e.get("step_latency_s", 0.0)
                   for e in loop.step_log[smark:])
        drain(now)
        if max_virtual_s is not None and now > max_virtual_s:
            break

    streams = {handles[r]: loop.finished[r].tokens()
               for r in loop.finished if r in handles}
    recs = [records[t.rid] for t in trace.requests]
    return {
        "clock": "simulated" if clocked else "wall",
        "makespan_s": now,
        "metrics": summarize(recs, {
            n: loop.admission.slo(n)
            for n in {r.slo_class for r in recs}}, now),
        "records": recs,
        "serving": loop.stats(),
        "streams": streams,
        "trace_fingerprint": trace.fingerprint(),
    }


def scorecard(report: Dict, stack: PinnedStack, *, hardware: str,
              device: str, trace_seed: int, trace_requests: int,
              reduced: bool) -> str:
    """The replay's JSON scorecard (sorted keys): the reference's
    ``BENCH_serving.json`` schema plus the device it ran on and whether
    the model was cut to its reduced configuration."""
    serving = report["serving"]
    payload = {
        "schema_version": SCHEMA_VERSION,
        "bench": "serving_load_harness",
        "clock": report["clock"],
        "hardware": hardware,
        "device": device,
        "pinned": dict(asdict(stack), trace_seed=trace_seed,
                       trace_requests=trace_requests, reduced=reduced),
        "trace_fingerprint": report["trace_fingerprint"],
        "makespan_s": report["makespan_s"],
        "metrics": report["metrics"],
        "serving": {k: serving[k] for k in SERVING_KEYS if k in serving},
    }
    return json.dumps(payload, sort_keys=True, indent=1) + "\n"
