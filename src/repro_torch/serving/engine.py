"""Continuous-batching serving engine (port of repro/serving/engine.py,
the paged decoder `generate` path).

`ContinuousEngine` keeps a fixed pool of `max_batch` decode slots backed
by a PagedCachePool: attention KV lives in block arenas addressed
through per-slot block tables, identical prompt prefixes are stored once
and shared, and evicted prefix blocks stay warm on a bounded LRU.
Admission is fifo and batched: one left-padded prefill per padded-length
bucket (group sizes padded to powers of two), gated on block
availability. With the default `growth="lazy"` only prompt blocks are
allocated at admission and decode blocks grow as each slot's cursor
reaches them; when growth exhausts the arena a victim slot (the youngest
admission) is preempted and re-enters the queue with its generated
tokens as a continuation prefill. One decode step advances every active
slot per iteration; its attention runs the hand-written kernel
(`attn_kernel="paged"`) or the plain-torch gather (`"xla"`).

Not ported yet: the dense pool, the static engine, chunked prefill,
speculative decoding, sampled decoding, meshes, the encoder-decoder and
BERT families and batch-1 `run_one`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed.steps import build_serve_step, greedy_next
from repro_torch.serving.block_allocator import NoBlocksError
from repro_torch.serving.cache_pool import PagedCachePool
from repro_torch.serving.metrics import DepthTracker, RequestTrace, aggregate
from repro_torch.serving.sampler import Sampler
from repro_torch.serving.scheduler import (PolicyContext, Scheduler,
                                           SchedulingPolicy)


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget. The engine
    fills `generated` ((n,) int32, n <= max_new_tokens) on completion,
    `rid` at submit, and `trace` with submit/admit/token timestamps."""
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    generated: Optional[np.ndarray] = None
    rid: Optional[int] = None
    trace: RequestTrace = dataclasses.field(default_factory=RequestTrace)


def apply_serving_policy(arch, params, policy=None):
    """Cast the parameter copy per the precision policy (norms and biases
    stay fp32) and run compute in its compute dtype."""
    if policy is None:
        return arch, params
    from repro_torch.precision import get_policy
    policy = get_policy(policy)
    cfg = policy.apply_to_cfg(arch.cfg)
    return dataclasses.replace(arch, cfg=cfg), policy.cast_params(params)


def build_prefill_fn(arch, max_len: int):
    """(params, tokens, positions) -> (fp32 last-position logits
    (B, 1, V), pooled cache of max_len rows)."""
    @torch.no_grad()
    def prefill(params, tokens, positions):
        logits, cache = arch.prefill(params, {"tokens": tokens},
                                     cache_len=max_len, positions=positions)
        return logits.float(), cache
    return prefill


def synthetic_requests(n: int, vocab: int, *, prompt_len: int,
                       new_tokens: int, seed: int = 0,
                       min_new_frac: float = 0.5, shared_prefix: int = 0):
    """Load-generator workload: prompt lengths in [prompt_len/2,
    prompt_len], budgets in [new_tokens*min_new_frac, new_tokens], and
    an optional common prefix. A pure function of the arguments, drawn
    exactly as the JAX package draws it, so both engines see
    byte-identical requests."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(5, vocab, size=shared_prefix).astype(np.int32)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        new = int(rng.integers(max(1, int(new_tokens * min_new_frac)),
                               new_tokens + 1))
        tail = rng.integers(5, vocab, size=plen).astype(np.int32)
        reqs.append(Request(prompt=np.concatenate([prefix, tail]),
                            max_new_tokens=new))
    return reqs


def pad_prompts(prompts: List[np.ndarray], granularity: int = 1,
                pad_len: Optional[int] = None):
    """Left-pad to a common length -> (tokens, positions, lengths).
    Positions are per-request LOCAL timelines (negative for padding)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    plen = pad_len if pad_len is not None else int(lens.max())
    plen = -(-plen // granularity) * granularity
    if plen < int(lens.max()):
        raise ValueError(f"pad_len {plen} < longest prompt {lens.max()}")
    B = len(prompts)
    tokens = np.zeros((B, plen), np.int32)
    positions = np.empty((B, plen), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = p
        positions[i] = np.arange(plen) - (plen - len(p))
    return tokens, positions, lens


def _slice_request(cache, g: int):
    """Batch row g of a batched-prefill cache as a batch-1 cache."""
    return {"slots": tuple({k: v[:, g:g + 1] for k, v in s.items()}
                           for s in cache["slots"]),
            "index": cache["index"][g:g + 1]}


class ContinuousEngine:
    """Continuous-batching decode over a fixed slot pool (paged)."""

    def __init__(self, arch, params, *, max_batch: int = 8,
                 max_len: int = 256, policy=None, prefill_bucket: int = 1,
                 on_step=None, block_size: int = 16,
                 slots_budget: Optional[int] = None, sampler=None,
                 attn_kernel: Optional[str] = None, growth: str = "lazy",
                 sched_policy="fifo", slo_ms: Optional[float] = None,
                 preempt: bool = True, retain_blocks: Optional[int] = None,
                 watermark: int = 0):
        """Args as the JAX engine's for the paged decoder path (mesh,
        chunking, speculation and the other families excepted). Caches
        live on the device of the params. attn_kernel "paged" runs the
        hand-written kernel, "xla" the plain-torch gather; None adopts
        arch.cfg.attn_kernel."""
        if arch.kind != "decoder":
            raise NotImplementedError(
                f"serving {arch.kind} archs is not ported yet")
        if attn_kernel is None:
            attn_kernel = arch.cfg.attn_kernel
        self.arch, self.params = apply_serving_policy(arch, params, policy)
        if attn_kernel != self.arch.cfg.attn_kernel:
            self.arch = dataclasses.replace(self.arch, cfg=dataclasses.replace(
                self.arch.cfg, attn_kernel=attn_kernel))
        self.device = self.params["embed"]["embedding"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = Sampler.parse(sampler)
        self.prefill_bucket = max(prefill_bucket, 1)
        if retain_blocks is None:
            # one BATCH's worth of blocks: a multi-tenant set of hot
            # prefixes thrashes an LRU of one request's worth
            retain_blocks = max(1, max_batch * (max_len // block_size))
        self.pool = PagedCachePool(
            self.arch, max_batch, max_len, block_size=block_size,
            slots_budget=slots_budget,
            attn_kernel=attn_kernel, growth=growth,
            retain_blocks=retain_blocks, watermark=watermark,
            device=self.device)
        # slack rows so the padded prompt never reaches the request
        # cache's last row, which stays pos=-1 (the insert's filler)
        self._prefill_len = max_len + max(block_size, self.prefill_bucket)
        self.scheduler = Scheduler(max_batch)
        slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.sched_policy = SchedulingPolicy.parse(sched_policy, slo_s=slo_s)
        self.preempt_enabled = preempt
        self.on_step = on_step
        # steps (prefill or decode) whose fp32 logits held a NaN or inf,
        # counted on the device and read only by report()
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self._step = build_serve_step(self._decode_step,
                                      sampler=self.sampler)
        self._prefill = build_prefill_fn(self.arch, self._prefill_len)
        self._tokens = np.zeros((max_batch, 1), np.int32)
        self._positions = np.full((max_batch, 1), -1, np.int32)
        self._emitted: Dict[int, list] = {}     # slot -> generated ids
        self._resume: Dict[int, list] = {}      # rid -> preempted tokens
        self._admit_seq: Dict[int, int] = {}
        self._admit_time: Dict[int, float] = {}
        self._admit_counter = 0
        self._depth = DepthTracker()
        self._next_rid = 0
        self.steps_run = 0
        self.slot_steps = 0
        self.max_concurrent = 0
        self.preemptions = 0

    # ---------------- request lifecycle ----------------

    def submit(self, request: Request):
        """Queue a request; it must fit max_len (prompt + budget)."""
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(request.prompt)} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_len {self.max_len}")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.rid is None:
            request.rid = self._next_rid
            self._next_rid += 1
        request.trace.mark_submit()
        self.scheduler.submit(request)

    def _finish(self, slot: int):
        req = self.scheduler.complete(slot)
        req.generated = np.array(self._emitted.pop(slot), np.int32)
        req.trace.done_t = time.perf_counter()
        self.pool.evict(slot)
        self._admit_seq.pop(slot, None)
        self._admit_time.pop(slot, None)
        # position -1 marks the slot inactive: its decode writes go
        # nowhere and its attention rows are dead
        self._positions[slot, 0] = -1
        self._tokens[slot, 0] = 0
        return req

    def _count_nonfinite(self, logits):
        self._nonfinite += (~torch.isfinite(logits)).any()

    def _decode_step(self, params, batch, cache):
        logits, cache = self.arch.decode_step(params, batch, cache)
        self._count_nonfinite(logits)
        return logits, cache

    def _pick(self, logits):
        """(B, 1, V) fp32 prefill logits -> (B,) first tokens."""
        if self.sampler is not None:
            return self.sampler.sample(logits[:, -1, :])
        return greedy_next(logits)

    def _resume_of(self, req: Request) -> list:
        return self._resume.get(req.rid, [])

    def _full_prompt(self, req: Request) -> np.ndarray:
        """The prompt an admission prefills: the original prompt plus the
        tokens generated before a preemption."""
        resume = self._resume_of(req)
        prompt = np.asarray(req.prompt, np.int32)
        if not resume:
            return prompt
        return np.concatenate([prompt, np.asarray(resume, np.int32)])

    def _plen(self, req: Request) -> int:
        return len(req.prompt) + len(self._resume_of(req))

    def _padded_len(self, req: Request) -> int:
        plen = max(self._plen(req), 1)
        return -(-plen // self.prefill_bucket) * self.prefill_bucket

    def _policy_ctx(self) -> PolicyContext:
        return PolicyContext(now=time.perf_counter(),
                             admit_seq=self._admit_seq,
                             admit_t=self._admit_time)

    def _fits(self, req: Request, pending: dict):
        """Would this request's block plan fit beside the admissions
        already planned in this pass?"""
        budget = req.max_new_tokens - len(self._resume_of(req))
        need = self.pool.admission_plan(self._full_prompt(req),
                                        self._plen(req),
                                        self._padded_len(req), budget)
        avail = self.pool.admissible_blocks()
        ok = all(n + pending.get(si, 0) <= avail[si]
                 for si, n in need.items())
        return ok, need

    def _admit(self):
        """Fill free slots from the queue in policy order: one batched
        prefill per padded-length bucket, then each cache row is inserted
        into its slot."""
        while True:
            pairs, pending = [], {}
            while self.scheduler.free_slots and self.scheduler.queued:
                i = self.sched_policy.pick(self.scheduler.queue_items(),
                                           self._policy_ctx())
                req = self.scheduler.peek(i)
                ok, need = self._fits(req, pending)
                if not ok:
                    break   # head of line waits for evictions
                for si, n in need.items():
                    pending[si] = pending.get(si, 0) + n
                pairs.append(self.scheduler.assign_at(i))
            if not pairs:
                return
            groups: Dict[int, list] = {}
            for slot, req in pairs:
                groups.setdefault(self._padded_len(req), []).append(
                    (slot, req))
            failed = []
            for padded, grp in groups.items():
                prompts = [self._full_prompt(r) for _, r in grp]
                # pad the group to a power-of-two size by replicating its
                # last request (outputs discarded), as the JAX engine does
                n = len(grp)
                n_pad = 1 << (n - 1).bit_length()
                tokens, positions, lens = pad_prompts(
                    prompts + [prompts[-1]] * (n_pad - n),
                    self.prefill_bucket, pad_len=padded)
                logits, batch_cache = self._prefill(
                    self.params,
                    torch.as_tensor(tokens, device=self.device),
                    torch.as_tensor(positions, device=self.device))
                self._count_nonfinite(logits)
                first = self._pick(logits).cpu().numpy()
                now = time.perf_counter()
                for g, (slot, req) in enumerate(grp):
                    resume = self._resume_of(req)
                    try:
                        self.pool.insert(
                            _slice_request(batch_cache, g), slot,
                            prompt=prompts[g], plen=len(prompts[g]),
                            padded_len=padded,
                            budget=req.max_new_tokens - len(resume))
                    except NoBlocksError:
                        failed.append(slot)
                        continue
                    self._resume.pop(req.rid, None)
                    t0 = int(first[g])
                    if req.trace.admit_t is None:   # the FIRST admission
                        req.trace.admit_t = now     # counts for TTFT
                    req.trace.mark_token(now)
                    self._emitted[slot] = list(resume) + [t0]
                    self._tokens[slot, 0] = t0
                    self._positions[slot, 0] = int(lens[g])
                    self._admit_counter += 1
                    self._admit_seq[slot] = self._admit_counter
                    self._admit_time[slot] = now
                    if len(self._emitted[slot]) >= req.max_new_tokens:
                        self._finish(slot)
            for slot in reversed(failed):
                self.scheduler.requeue(slot)
            if failed:
                return

    def _preempt(self, slot: int):
        """Evict a mid-decode victim: blocks freed, generated tokens
        parked as continuation state, request requeued by arrival."""
        req = self.scheduler.active[slot]
        self._resume[req.rid] = self._emitted.pop(slot)
        req.trace.preemptions += 1
        self.preemptions += 1
        self.pool.evict(slot)
        self.scheduler.preempt(slot)
        self._admit_seq.pop(slot, None)
        self._admit_time.pop(slot, None)
        self._positions[slot, 0] = -1
        self._tokens[slot, 0] = 0

    def _grow_active(self):
        """Back every active slot's next write with a block, preempting
        the policy's victim when the arena is exhausted. Oldest
        admissions grow first, so the oldest request always progresses."""
        for slot in sorted(self.scheduler.active,
                           key=lambda s: self._admit_seq.get(s, 0)):
            if slot not in self.scheduler.active:
                continue            # preempted as a victim earlier in loop
            row = int(self._positions[slot, 0])
            while True:
                try:
                    self.pool.grow(slot, row)
                    break
                except NoBlocksError:
                    if not self.preempt_enabled:
                        raise RuntimeError(
                            "paged arena exhausted mid-decode with "
                            "preemption disabled: raise slots_budget / "
                            "watermark, or enable preempt")
                    candidates = sorted(self.scheduler.active)
                    victim = self.sched_policy.victim(candidates,
                                                      self._policy_ctx())
                    if victim == slot and len(candidates) == 1:
                        raise RuntimeError(
                            "single active slot cannot grow: the arena "
                            "is smaller than one request's chain (raise "
                            "slots_budget)")
                    self._preempt(victim)
                    if victim == slot:
                        break

    def _evict_overdue(self):
        """SLO eviction: an active request older (since admission) than
        the policy's SLO finishes early with the tokens it has."""
        if self.sched_policy.slo_s is None or not self.scheduler.active:
            return
        ctx = self._policy_ctx()
        for slot in sorted(self.scheduler.active):
            if self.sched_policy.overdue(slot, ctx):
                self.scheduler.active[slot].trace.evicted_slo = True
                self._finish(slot)

    def step(self) -> bool:
        """One iteration: SLO evictions, admissions, lazy growth, then
        one decode step over the active slots. False when idle."""
        self._evict_overdue()
        self._admit()
        if self.pool.growth == "lazy":
            self._grow_active()
            self.pool.flush_growth()
        active = sorted(self.scheduler.active)
        self.max_concurrent = max(self.max_concurrent, len(active))
        self._depth.sample(self.scheduler.queued)
        if not active:
            if self.scheduler.queued:
                req = self.scheduler.peek()
                raise RuntimeError(
                    f"request rid={req.rid} (prompt {len(req.prompt)}, "
                    f"budget {req.max_new_tokens}) cannot fit an empty "
                    f"paged arena: raise slots_budget or max_len")
            return self.scheduler.has_work
        cache = {**self.pool.cache, "tables": self.pool.device_tables()}
        nxt, new_cache = self._step(
            self.params, torch.as_tensor(self._tokens, device=self.device),
            torch.as_tensor(self._positions, device=self.device), cache)
        self.pool.cache["index"] = new_cache["index"]
        nxt = nxt.cpu().numpy()          # host sync: tokens feed next step
        now = time.perf_counter()
        self.steps_run += 1
        self.slot_steps += len(active)
        for slot in active:
            req = self.scheduler.active[slot]
            self._emitted[slot].append(int(nxt[slot]))
            req.trace.mark_token(now)
            self._tokens[slot, 0] = int(nxt[slot])
            self._positions[slot, 0] += 1
            if len(self._emitted[slot]) >= req.max_new_tokens:
                self._finish(slot)
        if self.on_step is not None:
            self.on_step({"step": self.steps_run, "active": len(active),
                          "queued": self.scheduler.queued,
                          "preemptions": self.preemptions})
        return self.scheduler.has_work

    def run(self, requests: Optional[List[Request]] = None) -> List[Request]:
        """Submit `requests` (if given) and step until idle."""
        for r in requests or ():
            self.submit(r)
        while self.step():
            pass
        return self.scheduler.completed

    def report(self, wall_s: float) -> dict:
        """Throughput/latency stats of the completed requests plus slot
        utilization, decode steps, peak concurrency, queue depth,
        preemptions, prefix-block hits and the number of steps whose
        logits were not all finite."""
        done = self.scheduler.completed
        stats = aggregate([r.trace for r in done], wall_s,
                          sum(len(r.generated) for r in done))
        denom = max(1, self.steps_run * self.max_batch)
        stats["slot_utilization"] = self.slot_steps / denom
        stats["decode_steps"] = self.steps_run
        stats["max_concurrent"] = self.max_concurrent
        stats["preemptions"] = self.preemptions
        stats["sched_policy"] = self.sched_policy.name
        stats.update(self._depth.stats())
        stats["task"] = "generate"
        stats["growth"] = self.pool.growth
        stats["shared_block_hits"] = self.pool.shared_hits
        stats["retained_block_hits"] = self.pool.retained_hits
        stats["prefix_misses"] = self.pool.prefix_misses
        stats["retained_hit_rate"] = self.pool.retained_hit_rate
        stats["nonfinite_logit_steps"] = int(self._nonfinite)
        return stats
