"""Hot-path static analysis of the port (the counterpart of the
reference's ``repro.analysis``).

Four checkers, one CLI (``python -m repro_torch.analysis``):

  host-sync          blocking device->host reads reachable from the
                     serving loop's step, the engine's decode, the train
                     step and the AdamW update
  recapture-hazard   CUDA graphs or compiled wrappers built per call,
                     widths and token shapes derived from runtime shapes
                     that would capture one decode graph per value
  kernel-contract    the ctypes signatures against the ``extern "C"``
                     entry points of ``csrc/*.cu``, and each launch's
                     tiles against the kernel's limits
  granularity-drift  the tiles ``core.granularity`` declares (read by
                     the NFP predictor) vs the tiles the wrappers launch
                     vs the pinned contract, and the CPU emulation's
                     constants vs the kernels' constexprs

Findings diff against ``analysis-baseline.json`` beside this package, so
existing debt is suppressed while NEW findings fail
``--check-baseline``.  On the card, ``kernel_contracts.LaunchRecorder``
records the real launches for the same checks.  Pure AST analysis and
ctypes bookkeeping: nothing here imports JAX or the reference package.
"""
from repro_torch.analysis.baseline import (diff_against_baseline,
                                           load_baseline, write_baseline)
from repro_torch.analysis.callgraph import Project
from repro_torch.analysis.cli import run_checkers
from repro_torch.analysis.findings import Finding

__all__ = ["Finding", "Project", "run_checkers", "load_baseline",
           "write_baseline", "diff_against_baseline"]
