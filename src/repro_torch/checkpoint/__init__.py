"""repro_torch.checkpoint — fault-tolerant checkpointing."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, restore, save)

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]
