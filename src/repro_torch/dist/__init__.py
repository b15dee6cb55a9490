"""repro_torch.dist — elastic / fault-tolerant training primitives (a
copy of the reference's framework-free ``dist/elastic.py``)."""
from repro_torch.dist.elastic import (StepWatchdog, UpdateInterrupted,
                                      elastic_mesh, run_with_restarts)

__all__ = ["StepWatchdog", "UpdateInterrupted", "elastic_mesh",
           "run_with_restarts"]
