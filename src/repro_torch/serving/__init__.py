"""Serving subsystem of the port (see serving/engine.py). Public surface:

  ContinuousEngine   slot-pool continuous batching over PagedCachePool
                     (default) or CachePool; spec_draft=(arch, params)
                     enables draft-verify speculative decoding; encdec
                     archs over EncDecCachePool, bert archs scored or
                     embedded (task="score" | "embed"); run_one serves
                     one request at batch 1
  ServeEngine        static-batch baseline (padded lockstep decode)
  make_spec_pair     acceptance-1.0 speculative fixture: inert upper
                     periods + a one-period draft sharing embed/head
  Request            one prompt + generation budget (+ latency trace)
  Sampler            temperature/top-k/top-p decode with JAX's threefry
                     keys (greedy and the bf16 tie-stable argmax too)
  fold_keys          per-token keys fold_in(request key, token index)
  throughput_probe   warm-up-aware timed run -> tokens/s + percentiles
  Scheduler          ticketed slot admission (host side)
  SchedulingPolicy   admission / victim / SLO policy (fifo |
                     arrival-deadline | prefix-affinity; see
                     serving/scheduler.py)
  ReplicaRouter      prefix-affinity routing over N engine replicas
                     (ROUTE_POLICIES prefix | depth | rr;
                     prefix_route_key is its content key)
  CachePool          dense per-slot KV pool (baseline, speculative draft)
  PagedCachePool     block-paged KV arena with shared prompt prefixes,
                     lazy chain growth and a retained-prefix LRU
  EncDecCachePool    encdec pool: dense per-slot self-attention rows and
                     a refcounted cross-attention block arena keyed by
                     the raw encoder input (frames_key), shared by
                     same-input requests
  BlockAllocator     refcounted free list over arena blocks
  BlockTableMap      per-slot-type tables + prefix registry (host side)
  AdmissionController  chunked-prefill admission: one resumable prompt
                     chunk per step, fused into the decode token budget
  plan_chunk         the budget partition (size + active <= budget)
  SLO / OpenLoopDriver / poisson_arrivals / slo_report
                     open-loop traffic: seeded Poisson arrivals with
                     TTFT/ITL SLOs and goodput accounting (traffic.py)
"""
from repro_torch.serving.admission import (AdmissionController, PrefillTask,
                                           chunk_granularity, plan_chunk)
from repro_torch.serving.block_allocator import (BlockAllocator,
                                                 BlockTableMap, NoBlocksError)
from repro_torch.serving.cache_pool import (CachePool, EncDecCachePool,
                                            PagedCachePool, frames_key)
from repro_torch.serving.engine import (ContinuousEngine, Request,
                                        ServeEngine, apply_serving_policy,
                                        build_encdec_prefill_fn,
                                        build_first_token_fn,
                                        build_prefill_fn, make_spec_pair,
                                        pad_prompts, prompt_granularity,
                                        synthetic_encdec_requests,
                                        synthetic_requests,
                                        synthetic_scoring_requests,
                                        throughput_probe)
from repro_torch.serving.metrics import (DepthTracker, RequestTrace,
                                         aggregate, hit_rate, percentile)
from repro_torch.serving.sampler import Sampler, fold_keys, stable_argmax
from repro_torch.serving.router import (ROUTE_POLICIES, ReplicaRouter,
                                        prefix_route_key)
from repro_torch.serving.scheduler import (ArrivalDeadlinePolicy,
                                           PolicyContext,
                                           PrefixAffinityPolicy, Scheduler,
                                           SchedulerError, SchedulingPolicy)
from repro_torch.serving.traffic import (SLO, OpenLoopDriver,
                                         bimodal_requests, meets_slo,
                                         poisson_arrivals, slo_report)

__all__ = [
    "AdmissionController", "ArrivalDeadlinePolicy", "BlockAllocator",
    "BlockTableMap", "CachePool", "ContinuousEngine", "DepthTracker",
    "EncDecCachePool", "NoBlocksError", "OpenLoopDriver", "PagedCachePool",
    "PolicyContext", "PrefixAffinityPolicy", "ROUTE_POLICIES",
    "PrefillTask", "ReplicaRouter", "Request", "RequestTrace", "SLO",
    "Sampler", "Scheduler",
    "SchedulerError", "SchedulingPolicy", "ServeEngine", "aggregate",
    "apply_serving_policy", "bimodal_requests", "build_encdec_prefill_fn",
    "build_first_token_fn", "build_prefill_fn", "chunk_granularity",
    "fold_keys", "frames_key", "hit_rate",
    "make_spec_pair", "meets_slo", "pad_prompts", "percentile",
    "plan_chunk", "poisson_arrivals", "prefix_route_key",
    "prompt_granularity", "slo_report",
    "stable_argmax", "synthetic_encdec_requests", "synthetic_requests",
    "synthetic_scoring_requests", "throughput_probe",
]
