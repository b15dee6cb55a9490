"""repro_torch.serving — decode engine, paged KV bookkeeping, the
parallel-decoding drivers (greedy, speculative, MTP, diffusion) at batch 1
and as slot adapters, and the multi-request scheduler."""
from repro_torch.serving.algorithm import (DecodeStats,
                                           ParallelDecodeAlgorithm,
                                           SlotAdapter)
from repro_torch.serving.diffusion import (DiffusionBlockDecoder,
                                           DiffusionSlotAdapter,
                                           refine_block)
from repro_torch.serving.engine import DecodeEngine, greedy_tokens
from repro_torch.serving.mtp import (MTPDecoder, MTPSlotAdapter,
                                     init_mtp_heads, mtp_loss, mtp_propose)
from repro_torch.serving.paged import (BlockAllocator, BlockManager,
                                       PagedKVConfig, PrefixCache)
from repro_torch.serving.scheduler import (DEFAULT_SLO_CLASSES,
                                           AdmissionConfig,
                                           AdmissionRejected, Request,
                                           SLOClass, ServingLoop)
from repro_torch.serving.speculative import (SpeculativeDecoder,
                                             SpeculativeSlotAdapter,
                                             ngram_draft)

__all__ = ["AdmissionConfig", "AdmissionRejected", "BlockAllocator",
           "BlockManager", "DEFAULT_SLO_CLASSES", "DecodeEngine",
           "DecodeStats", "DiffusionBlockDecoder", "DiffusionSlotAdapter",
           "MTPDecoder", "MTPSlotAdapter", "PagedKVConfig",
           "ParallelDecodeAlgorithm", "PrefixCache", "Request", "SLOClass",
           "ServingLoop", "SlotAdapter", "SpeculativeDecoder",
           "SpeculativeSlotAdapter", "greedy_tokens", "init_mtp_heads",
           "mtp_loss", "mtp_propose", "ngram_draft", "refine_block"]
