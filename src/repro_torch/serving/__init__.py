"""Serving subsystem of the port (see serving/engine.py). Public surface:

  ContinuousEngine   slot-pool continuous batching over PagedCachePool
                     (default) or CachePool; spec_draft=(arch, params)
                     enables draft-verify speculative decoding
  ServeEngine        static-batch baseline (padded lockstep decode)
  make_spec_pair     acceptance-1.0 speculative fixture: inert upper
                     periods + a one-period draft sharing embed/head
  Request            one prompt + generation budget (+ latency trace)
  Sampler            temperature/top-k/top-p decode with JAX's threefry
                     keys (greedy and the bf16 tie-stable argmax too)
  fold_keys          per-token keys fold_in(request key, token index)
  Scheduler          ticketed slot admission (host side)
  SchedulingPolicy   fifo admission / victim / SLO policy
  CachePool          dense per-slot KV pool (baseline, speculative draft)
  PagedCachePool     block-paged KV arena with shared prompt prefixes,
                     lazy chain growth and a retained-prefix LRU
  BlockAllocator     refcounted free list over arena blocks
  BlockTableMap      per-slot-type tables + prefix registry (host side)
"""
from repro_torch.serving.block_allocator import (BlockAllocator,
                                                 BlockTableMap, NoBlocksError)
from repro_torch.serving.cache_pool import CachePool, PagedCachePool
from repro_torch.serving.engine import (ContinuousEngine, Request,
                                        ServeEngine, apply_serving_policy,
                                        build_first_token_fn,
                                        build_prefill_fn, make_spec_pair,
                                        pad_prompts, prompt_granularity,
                                        synthetic_requests)
from repro_torch.serving.metrics import (DepthTracker, RequestTrace,
                                         aggregate, hit_rate, percentile)
from repro_torch.serving.sampler import Sampler, fold_keys, stable_argmax
from repro_torch.serving.scheduler import (PolicyContext, Scheduler,
                                           SchedulerError, SchedulingPolicy)

__all__ = [
    "BlockAllocator", "BlockTableMap", "CachePool", "ContinuousEngine",
    "DepthTracker", "NoBlocksError", "PagedCachePool", "PolicyContext",
    "Request", "RequestTrace", "Sampler", "Scheduler", "SchedulerError",
    "SchedulingPolicy", "ServeEngine", "aggregate", "apply_serving_policy",
    "build_first_token_fn", "build_prefill_fn", "fold_keys", "hit_rate",
    "make_spec_pair", "pad_prompts", "percentile", "prompt_granularity",
    "stable_argmax", "synthetic_requests",
]
