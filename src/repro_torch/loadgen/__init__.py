"""repro_torch.loadgen — seeded trace-driven production-traffic harness.

Three pieces, copies of the reference's: ``trace`` generates
deterministic request traces (Poisson / MMPP arrivals, heavy-tail length
mixes, shared-prefix fleets, multi-tenant SLO classes), ``harness``
replays a trace through the port's ``ServingLoop`` on a virtual clock
(and keeps ``PINNED_STACK``, the pinned replay's serving stack), and
``stats`` turns the per-request timelines into TTFT / inter-token-latency
percentiles and goodput-under-SLO.
"""
from repro_torch.loadgen.harness import (PINNED_STACK, PinnedStack,
                                         replay_trace, scorecard)
from repro_torch.loadgen.stats import (RequestRecord, itls, percentile,
                                       summarize, ttft)
from repro_torch.loadgen.trace import (ArrivalSpec, LengthSpec, TenantSpec,
                                       Trace, TraceRequest, TraceSpec,
                                       generate_trace, pinned_spec)

__all__ = ["ArrivalSpec", "LengthSpec", "PINNED_STACK", "PinnedStack",
           "RequestRecord", "TenantSpec", "Trace", "TraceRequest",
           "TraceSpec", "generate_trace", "itls", "percentile",
           "pinned_spec", "replay_trace", "scorecard", "summarize", "ttft"]
