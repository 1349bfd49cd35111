"""Serving subsystem of the port: continuous batching over a paged KV
pool (see serving/engine.py). Public surface:

  ContinuousEngine   slot-pool continuous batching over PagedCachePool
  Request            one prompt + generation budget (+ latency trace)
  Sampler            greedy decoding (bf16 tie-stable option)
  Scheduler          ticketed slot admission (host side)
  SchedulingPolicy   fifo admission / victim / SLO policy
  PagedCachePool     block-paged KV arena with shared prompt prefixes,
                     lazy chain growth and a retained-prefix LRU
  BlockAllocator     refcounted free list over arena blocks
  BlockTableMap      per-slot-type tables + prefix registry (host side)
"""
from repro_torch.serving.block_allocator import (BlockAllocator,
                                                 BlockTableMap, NoBlocksError)
from repro_torch.serving.cache_pool import PagedCachePool
from repro_torch.serving.engine import (ContinuousEngine, Request,
                                        apply_serving_policy,
                                        build_prefill_fn, pad_prompts,
                                        synthetic_requests)
from repro_torch.serving.metrics import (DepthTracker, RequestTrace,
                                         aggregate, hit_rate, percentile)
from repro_torch.serving.sampler import Sampler, stable_argmax
from repro_torch.serving.scheduler import (PolicyContext, Scheduler,
                                           SchedulerError, SchedulingPolicy)

__all__ = [
    "BlockAllocator", "BlockTableMap", "ContinuousEngine", "DepthTracker",
    "NoBlocksError", "PagedCachePool", "PolicyContext", "Request",
    "RequestTrace", "Sampler", "Scheduler", "SchedulerError",
    "SchedulingPolicy", "aggregate", "apply_serving_policy",
    "build_prefill_fn", "hit_rate", "pad_prompts", "percentile",
    "stable_argmax", "synthetic_requests",
]
