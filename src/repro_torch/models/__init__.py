"""repro_torch.models — attention-only decoders (GQA/MHA; dense or MoE FFN)."""
from repro_torch.models.transformer import (forward, init_cache,
                                            init_model, init_paged_cache,
                                            make_segments)

__all__ = ["forward", "init_cache", "init_model", "init_paged_cache",
           "make_segments"]
