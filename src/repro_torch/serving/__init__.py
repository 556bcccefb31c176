from repro_torch.serving.backend import (BlockAllocator, ExecutionBackend,
                                         GenerationResult, GumbelNoise,
                                         InFlightBatch, PagedBatchLayout,
                                         PendingPrefill,
                                         bucket_key, build_paged_layout,
                                         sample_tokens)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_pool import PrefixPool

__all__ = ["ServingEngine", "GenerationResult", "ExecutionBackend",
           "InFlightBatch", "bucket_key", "BlockAllocator",
           "PagedBatchLayout", "build_paged_layout", "GumbelNoise",
           "sample_tokens", "PrefixPool", "PendingPrefill"]
