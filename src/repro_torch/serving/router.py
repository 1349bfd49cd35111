"""Prefix-affinity front end over N engine replicas (port of
repro/serving/router.py; pure host code).

One `ContinuousEngine` owns one cache pool, so its shared-prefix registry
and retained-prefix LRU are replica-local. A fleet behind a prefix-blind
balancer therefore stores every hot system prompt N times and splits each
tenant's stream across N independent LRUs. `ReplicaRouter` routes by
content instead: a request is keyed by its leading prompt block (the
first `block_size` tokens, the granularity the pool's prefix registry
shares at), and a sticky key -> replica map sends every request that
could share blocks to the replica that already holds them. An unseen key
binds to the replica with the least outstanding work (queue + active
slots); the `depth` and `rr` policies turn affinity off (the baselines).

Routing never changes tokens: a request's output depends on the params,
its prompt, budget and sampler, not on which replica serves it, so the
router moves throughput and hit rates only. Every replica runs K8 on its
own decode steps when its pool is paged with attn_kernel="paged"; the
replicas step one after the other in one loop (on one card they share
the device and may share one params tree).

The router presents the engine surface OpenLoopDriver drives (`submit`,
`step`, `scheduler.has_work`), so open-loop traffic drives a fleet as it
drives one engine.
"""
from __future__ import annotations

import collections
import hashlib
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.metrics import hit_rate

ROUTE_POLICIES = ("prefix", "depth", "rr")


def prefix_route_key(prompt, block_size: int) -> Optional[bytes]:
    """Content key of the request's leading prompt block, or None when the
    prompt cannot fill one block (sub-block prompts are never registered
    for sharing, so affinity has nothing to win; they route by depth).

    sha256 over str(block_size) and the bytes of the first block_size
    tokens, as the JAX router hashes them (int32 tokens give equal
    keys). The pool's own registry also keys on padded_len; the router
    groups by content only, which at worst co-locates two requests that
    share fewer blocks than hoped, and never misses a shareable pair."""
    if len(prompt) < block_size:
        return None
    h = hashlib.sha256(str(block_size).encode())
    h.update(bytes(memoryview(np.ascontiguousarray(prompt[:block_size]))))
    return h.digest()


class _FleetScheduler:
    """The `engine.scheduler` surface OpenLoopDriver and the reports read,
    aggregated over the fleet."""

    def __init__(self, router: "ReplicaRouter"):
        self._router = router

    @property
    def has_work(self) -> bool:
        return any(e.scheduler.has_work for e in self._router.replicas)

    @property
    def completed(self) -> list:
        return [r for e in self._router.replicas
                for r in e.scheduler.completed]


class ReplicaRouter:
    """Route requests across engine replicas; step whichever have work.

    policy:
      prefix  sticky content-addressed affinity (leading prompt block ->
              replica), least depth for unseen and sub-block prefixes;
      depth   always the least outstanding work (prefix-blind);
      rr      round robin (fully blind).

    max_keys bounds the sticky map (LRU on use): a stale binding only
    costs a warm start on another replica, so a small bound is safe.
    """

    def __init__(self, replicas: Sequence, *, policy: str = "prefix",
                 block_size: Optional[int] = None, max_keys: int = 4096):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"route policy must be one of {ROUTE_POLICIES}, "
                f"got {policy!r}")
        self.replicas = list(replicas)
        self.policy = policy
        # the replicas' clock (a mesh's shared one), for an open-loop
        # driver
        self.clock = getattr(self.replicas[0], "clock", time.perf_counter)
        if block_size is None:
            pools = [p for p in (getattr(e, "pool", None)
                                 for e in self.replicas)
                     if hasattr(p, "block_size")]
            if policy == "prefix" and not pools:
                raise ValueError(
                    "prefix routing needs paged replicas (their "
                    "block_size defines the affinity key) or an "
                    "explicit block_size")
            block_size = pools[0].block_size if pools else 16
        self.block_size = block_size
        self.scheduler = _FleetScheduler(self)
        self._affinity: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._max_keys = max_keys
        self._rr_next = 0
        self.routed_submits = 0
        self.routed_affinity_hits = 0   # sticky map sends (prefix policy)
        self.routed_fallback = 0        # prefix policy fell back to depth

    # ---------------- routing ----------------

    def _depth(self, i: int) -> int:
        e = self.replicas[i]
        return e.scheduler.queued + len(e.scheduler.active)

    def _least_depth(self) -> int:
        return min(range(len(self.replicas)), key=self._depth)

    def route(self, request) -> int:
        """Replica index for a request (no submission): the policy's
        decision, exposed on its own for tests."""
        if self.policy == "rr":
            i = self._rr_next
            self._rr_next = (i + 1) % len(self.replicas)
            return i
        if self.policy == "depth":
            return self._least_depth()
        key = prefix_route_key(request.prompt, self.block_size)
        if key is None:
            self.routed_fallback += 1
            return self._least_depth()
        i = self._affinity.get(key)
        if i is None:
            i = self._least_depth()
            self._affinity[key] = i
            if len(self._affinity) > self._max_keys:
                self._affinity.popitem(last=False)
        else:
            self._affinity.move_to_end(key)
            self.routed_affinity_hits += 1
        return i

    def submit(self, request):
        """Route and enqueue on the chosen replica."""
        self.routed_submits += 1
        self.replicas[self.route(request)].submit(request)

    # ---------------- stepping ----------------

    def step(self) -> bool:
        """One step on every replica that has work (idle replicas cost
        nothing). True while any replica still has work, the contract of
        ContinuousEngine.step()."""
        progressed = False
        for e in self.replicas:
            if e.scheduler.has_work:
                progressed = e.step() or progressed
        return progressed

    def run(self, requests: Optional[List] = None) -> list:
        """Submit `requests` (optional) and drive the fleet to drain;
        returns every completed request across replicas."""
        for r in requests or ():
            self.submit(r)
        while self.step():
            pass
        return self.scheduler.completed

    # ---------------- reporting ----------------

    def report(self, wall_s: float) -> dict:
        """Fleet aggregate + per-replica engine reports. tokens_per_s sums
        the replicas' tokens over the shared wall clock (the replicas step
        interleaved in one loop); retained_hit_rate pools the replicas'
        retained hits and prefix misses."""
        per = []
        hits = misses = 0
        tokens = 0
        for idx, e in enumerate(self.replicas):
            r = e.report(wall_s)
            r["replica"] = idx
            per.append(r)
            if "retained_block_hits" in r:
                hits += r["retained_block_hits"]
                misses += r["prefix_misses"]
            tokens += sum(len(q.generated) for q in e.scheduler.completed)
        return {
            "replicas": len(self.replicas),
            "route_policy": self.policy,
            "routed_submits": self.routed_submits,
            "routed_affinity_hits": self.routed_affinity_hits,
            "routed_fallback": self.routed_fallback,
            "completed": sum(len(e.scheduler.completed)
                             for e in self.replicas),
            "tokens_per_s": tokens / wall_s if wall_s > 0 else 0.0,
            "retained_hit_rate": hit_rate(hits, misses),
            "per_replica": per,
        }
