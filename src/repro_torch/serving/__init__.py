from repro_torch.serving.backend import (BlockAllocator, ExecutionBackend,
                                         GenerationResult, GumbelNoise,
                                         InFlightBatch, PagedBatchLayout,
                                         PendingPrefill,
                                         bucket_key, build_paged_layout,
                                         sample_tokens)
from repro_torch.serving.chaos import ChaosDriver, FaultAction, FaultPlan
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_pool import PrefixPool
from repro_torch.serving.scheduler import (AdmissionResult, BatchRecord,
                                           CompletedRequest,
                                           ContinuousBatchingScheduler,
                                           RequestQueue, ResumeState,
                                           SchedulerConfig, ServeRequest,
                                           tier_priority)

__all__ = ["ServingEngine", "GenerationResult", "ExecutionBackend",
           "InFlightBatch", "bucket_key", "BlockAllocator",
           "PagedBatchLayout", "build_paged_layout", "GumbelNoise",
           "sample_tokens", "PrefixPool", "PendingPrefill",
           "ContinuousBatchingScheduler", "RequestQueue", "SchedulerConfig",
           "ServeRequest", "AdmissionResult", "BatchRecord",
           "CompletedRequest", "ResumeState", "tier_priority",
           "ChaosDriver", "FaultAction", "FaultPlan"]
