"""repro_torch.models — decoders of attention (GQA/MHA, sliding-window
GQA, MLA; dense or MoE FFN) and Mamba1 SSM layers."""
from repro_torch.models.transformer import (forward, init_cache,
                                            init_model, init_paged_cache,
                                            make_segments)

__all__ = ["forward", "init_cache", "init_model", "init_paged_cache",
           "make_segments"]
