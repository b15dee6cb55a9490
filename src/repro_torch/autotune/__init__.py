"""repro_torch.autotune — empirical NFP calibration + online budget control.

Closes the loop the analytic predictor leaves open: ``calibrate``
measures the near-free boundary on the live engine (the captured decode
step on the card, the roofline simulator on a CPU host), ``store``
persists the result as a spec-keyed artifact, and ``controller`` adapts
the serving loop's position budget online against observed step
latency.  ``store`` and ``controller`` are copies of the reference's.

  calibrate:  calibrate_engine / calibrate_specs -> CalibrationTable
  store:      save_table / load_table / spec_fingerprint (stale-key
              refusal via CalibrationMismatchError)
  controller: BudgetController (AIMD, variance-gated, per-context-
              bucket) — plug into ServingLoop(controller=...)
"""
from repro_torch.autotune.calibrate import (DEFAULT_MODES, calibrate_engine,
                                            calibrate_specs, context_buckets,
                                            simulator_time_fn, width_grid)
from repro_torch.autotune.controller import BudgetController, ControllerConfig
from repro_torch.autotune.store import (CalibrationEntry,
                                        CalibrationMismatchError,
                                        CalibrationTable, load_table,
                                        save_table, spec_fingerprint)

__all__ = ["DEFAULT_MODES", "BudgetController", "CalibrationEntry",
           "CalibrationMismatchError", "CalibrationTable",
           "ControllerConfig", "calibrate_engine", "calibrate_specs",
           "context_buckets", "load_table", "save_table",
           "simulator_time_fn", "spec_fingerprint", "width_grid"]
