"""repro_torch.data — token pipelines (numpy only: a copy of the
reference's, batch for batch)."""
from repro_torch.data.pipeline import (BinaryShards, DataConfig, SyntheticLM,
                                       make_pipeline)

__all__ = ["DataConfig", "SyntheticLM", "BinaryShards", "make_pipeline"]
