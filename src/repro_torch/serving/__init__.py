"""repro_torch.serving — decode engine, paged KV bookkeeping, the
greedy / speculative slot adapters and the multi-request scheduler."""
from repro_torch.serving.algorithm import SlotAdapter
from repro_torch.serving.engine import DecodeEngine, greedy_tokens
from repro_torch.serving.paged import (BlockAllocator, BlockManager,
                                       PagedKVConfig, PrefixCache)
from repro_torch.serving.scheduler import (DEFAULT_SLO_CLASSES,
                                           AdmissionConfig,
                                           AdmissionRejected, Request,
                                           SLOClass, ServingLoop)
from repro_torch.serving.speculative import SpeculativeSlotAdapter, ngram_draft

__all__ = ["AdmissionConfig", "AdmissionRejected", "BlockAllocator",
           "BlockManager", "DEFAULT_SLO_CLASSES", "DecodeEngine",
           "PagedKVConfig", "PrefixCache", "Request", "SLOClass",
           "ServingLoop", "SlotAdapter", "SpeculativeSlotAdapter",
           "greedy_tokens", "ngram_draft"]
