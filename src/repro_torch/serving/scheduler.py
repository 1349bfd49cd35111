"""Slot scheduler + the fifo, arrival-deadline and prefix-affinity
policies for the continuous-batching engine (port of
repro/serving/scheduler.py; pure host code).

Host-side admission control over a fixed pool of decode slots, split in
two layers:

`Scheduler` owns the MECHANISM: the slot <-> request mapping, a ticketed
admission queue, and the preempt/requeue path. No device state, no
timing — which keeps its invariants (the ones the property tests check)
easy to state:

  * a slot is either free or bound to exactly one in-flight request;
  * a request is queued, active in exactly one slot, or completed;
  * every queued request keeps its original arrival ticket; preemption
    and requeue re-insert BY TICKET, so arrival order is never lost no
    matter how admission reorders departures from the queue;
  * completion frees the slot for the next admitted request.

`SchedulingPolicy` owns the POLICY: which queued request to admit next,
which active slot to preempt when lazy growth exhausts the arena, and
when an active slot has blown its SLO and should be evicted early.
Policies see an immutable snapshot (the queue, plus a `PolicyContext` of
admission times/order and a warm-prefix probe) and return indices — they
never mutate scheduler state, so any policy composes with the same
engine invariants:

  fifo             admit in arrival order; preempt the youngest
                   admission (it has the least work to redo), or under
                   chunked admission the slot whose continuation
                   re-chunks the fewest tokens.
  arrival-deadline admit by earliest deadline (arrival + SLO); preempt
                   the slot with the latest deadline. With a uniform SLO
                   this is arrival-time-aware FIFO that also ranks
                   preemption victims by arrival.
  prefix-affinity  admit the first queued request whose leading prompt
                   block is already resident (live or retained) in the
                   paged pool, turning warm prefixes into copy-free
                   admissions while they are warm; arrival order when
                   nothing is warm or the pool cannot answer.

SLO eviction (`slo_s`) is orthogonal to the admission order: any policy
evicts a slot whose request has been running longer than the SLO since
admission (the engine finishes it early with the tokens it has, flagging
`trace.evicted_slo`).
"""
from __future__ import annotations

import bisect
import collections
import copy
import dataclasses
import itertools
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)



class SchedulerError(RuntimeError):
    pass


class Scheduler:
    """Fixed-capacity slot assignment with a ticketed admission queue.

    The queue holds (ticket, request) pairs; tickets are assigned once at
    submit() and travel with the request through any number of
    preempt()/requeue() round-trips, so "arrival order" stays a stable,
    policy-independent notion."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self._free: Deque[int] = collections.deque(range(n_slots))
        self._queue: List[Tuple[int, Any]] = []   # sorted by ticket
        self.active: Dict[int, Any] = {}
        self.completed: List[Any] = []
        self._seq = itertools.count()
        self._slot_ticket: Dict[int, int] = {}    # slot -> arrival ticket

    # ---------------- queue side ----------------

    def submit(self, request) -> int:
        """Enqueue a request; returns its arrival ticket (FIFO order)."""
        ticket = next(self._seq)
        self._queue.append((ticket, request))
        return ticket

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self.active)

    def queue_items(self) -> Sequence[Tuple[int, Any]]:
        """Immutable snapshot of (ticket, request) pairs in arrival
        order — what a SchedulingPolicy ranks for admission."""
        return tuple(self._queue)

    # ---------------- slot side ----------------

    @property
    def next_free(self) -> Optional[int]:
        """The slot the next assignment binds (None when none is free):
        the engine plans an admission in that slot's share of the pool."""
        return self._free[0] if self._free else None

    def peek(self, i: int = 0):
        """The i-th queued request in arrival order (None when out of
        range) — lets the engine gate admission on cache-pool capacity
        without dequeuing."""
        return self._queue[i][1] if 0 <= i < len(self._queue) else None

    def assign_at(self, i: int) -> Optional[Tuple[int, Any]]:
        """Bind the i-th queued request (arrival order; a policy's pick)
        to one free slot, or None if either side is empty."""
        if not self._free or not (0 <= i < len(self._queue)):
            return None
        slot = self._free.popleft()
        if slot in self.active:  # corrupted free list — refuse to reuse
            raise SchedulerError(f"slot {slot} free but active")
        ticket, req = self._queue.pop(i)
        self.active[slot] = req
        self._slot_ticket[slot] = ticket
        return slot, req

    def assign_one(self) -> Optional[Tuple[int, Any]]:
        """Bind the queue head to one free slot (FIFO), or None if
        either side is empty."""
        return self.assign_at(0)

    def assign(self) -> List[Tuple[int, Any]]:
        """Bind queued requests to free slots (FIFO). Returns the new
        (slot, request) pairs; the caller prefills and inserts their
        caches."""
        pairs: List[Tuple[int, Any]] = []
        while True:
            pair = self.assign_one()
            if pair is None:
                return pairs
            pairs.append(pair)

    def _reinsert(self, slot: int) -> Any:
        if slot not in self.active:
            raise SchedulerError(f"requeue() on inactive slot {slot}")
        req = self.active.pop(slot)
        ticket = self._slot_ticket.pop(slot)
        self._free.append(slot)
        bisect.insort(self._queue, (ticket, req))
        return req

    def requeue(self, slot: int):
        """Undo an assignment (admission failed downstream, e.g. the
        paged pool ran out of blocks): the request re-enters the queue
        at its ARRIVAL-TICKET position — arrival order is preserved —
        and the slot frees."""
        return self._reinsert(slot)

    def preempt(self, slot: int):
        """Evict a mid-decode victim so its blocks can serve someone
        else: same mechanics as requeue() (ticket-ordered re-entry), a
        distinct name so call sites read as what they are. The ENGINE
        owns the continuation state (generated-so-far tokens)."""
        return self._reinsert(slot)

    def admitted_order(self, slot: int) -> int:
        """The active slot's arrival ticket (a stable tie-break for victim
        selection)."""
        return self._slot_ticket[slot]

    def complete(self, slot: int):
        """Release a slot whose request finished; returns the request.
        Same-step assign -> complete is a legal lifecycle: the scoring
        family finishes requests AT admission (one batched score call,
        no decode), so a slot may bind and free inside one engine step."""
        if slot not in self.active:
            raise SchedulerError(f"complete() on inactive slot {slot}")
        req = self.active.pop(slot)
        self._slot_ticket.pop(slot, None)
        self._free.append(slot)
        self.completed.append(req)
        return req

    # ---------------- invariants (used by tests) ----------------

    def check_invariants(self):
        free = list(self._free)
        assert len(set(free)) == len(free), "duplicate free slots"
        assert not (set(free) & set(self.active)), "slot both free and active"
        assert len(free) + len(self.active) == self.n_slots, (
            "slots leaked", free, list(self.active))
        assert all(0 <= s < self.n_slots for s in free + list(self.active))
        assert set(self._slot_ticket) == set(self.active), (
            "slot tickets out of sync with active slots")
        tickets = [t for t, _ in self._queue]
        assert tickets == sorted(tickets), "queue not in arrival order"
        assert len(set(tickets)) == len(tickets), "duplicate tickets"
        live = [r for _, r in self._queue] + list(self.active.values())
        assert not set(map(id, self.completed)) & set(map(id, live)), (
            "request both completed and live (queued/active)")


# ---------------------------------------------------------------------------
# scheduling policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolicyContext:
    """Immutable view the engine hands a policy each decision point.

    now: wall-clock seconds (time.perf_counter domain).
    admit_seq: slot -> monotone admission sequence number (higher =
        admitted later; survives slot reuse).
    admit_t: slot -> admission wall-clock time (RESETS on every
        re-admission of a preempted request — use submit_t for
        arrival/deadline ranking, which a continuation keeps).
    active: slot -> in-flight request (victim selection ranks these).
    submit_t: callable(request) -> submission wall-clock time.
    prefix_warm: callable(request) -> bool, True when the request's
        leading prompt block is resident in the paged pool (live shared
        or retained); None when the pool cannot answer (dense pool,
        encdec, scoring).
    resume_cost: callable(slot) -> tokens a preemption of that slot
        would re-prefill (prompt + generated so far). Set only under
        chunked admission, where re-prefilling is metered chunk work;
        the base victim rule then minimizes it. None keeps the
        youngest-admission victim.
    """
    now: float = 0.0
    admit_seq: Dict[int, int] = dataclasses.field(default_factory=dict)
    admit_t: Dict[int, float] = dataclasses.field(default_factory=dict)
    active: Dict[int, Any] = dataclasses.field(default_factory=dict)
    submit_t: Callable[[Any], float] = lambda req: 0.0
    prefix_warm: Optional[Callable[[Any], bool]] = None
    resume_cost: Optional[Callable[[int], int]] = None


class SchedulingPolicy:
    """Base policy: FIFO admission, youngest-admission victim, SLO
    eviction when `slo_s` is set. Subclasses override `pick` and/or
    `victim`; `parse` maps the CLI spec strings."""

    name = "fifo"

    def __init__(self, slo_s: Optional[float] = None):
        if slo_s is not None and slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {slo_s}")
        self.slo_s = slo_s

    # -- admission: index into queue_items() to admit next ------------
    def pick(self, queue: Sequence[Tuple[int, Any]],
             ctx: PolicyContext) -> int:
        return 0

    # -- preemption: which active slot to sacrifice -------------------
    def victim(self, slots: Sequence[int], ctx: PolicyContext) -> int:
        """Default: the youngest admission — it has generated the least
        (its continuation prefill redoes the least work) and preempting
        it keeps arrival order intact when it re-enters the queue.

        With a resume_cost in the context (chunked admission) the proxy
        becomes exact: the slot whose continuation re-chunks the FEWEST
        tokens, ties broken by youngest admission."""
        if ctx.resume_cost is not None:
            return min(slots, key=lambda s: (ctx.resume_cost(s),
                                             -ctx.admit_seq.get(s, -1)))
        return max(slots, key=lambda s: ctx.admit_seq.get(s, -1))

    # -- SLO: should this active slot be evicted early? ---------------
    def overdue(self, slot: int, ctx: PolicyContext) -> bool:
        if self.slo_s is None:
            return False
        return ctx.now - ctx.admit_t.get(slot, ctx.now) > self.slo_s

    @classmethod
    def parse(cls, spec, slo_s: Optional[float] = None
              ) -> "SchedulingPolicy":
        """Policy instance from a spec: an existing policy passes
        through — COPIED if an slo_s must be attached, so one policy
        object shared across engines never inherits another engine's
        SLO; a name in {fifo, arrival-deadline, prefix-affinity}
        constructs one."""
        if isinstance(spec, SchedulingPolicy):
            if slo_s is not None and spec.slo_s is None:
                spec = copy.copy(spec)
                spec.slo_s = slo_s
            return spec
        if spec is None:
            spec = "fifo"
        policies = {p.name: p for p in (SchedulingPolicy,
                                        ArrivalDeadlinePolicy,
                                        PrefixAffinityPolicy)}
        if spec not in policies:
            raise ValueError(
                f"unknown scheduling policy {spec!r}: "
                f"expected one of {sorted(policies)}")
        return policies[spec](slo_s=slo_s)


class ArrivalDeadlinePolicy(SchedulingPolicy):
    """Earliest-deadline-first admission over deadline = submit + SLO.

    With one global SLO this equals arrival-time order, but it stays
    arrival-aware through preemption churn (a continuation keeps its
    submit time, hence its deadline) and ranks preemption victims by
    slack: the latest submit time has the most room to absorb a requeue.
    Ranking by admission time would invert this under churn: a
    re-admitted continuation always carries the newest admit_t and would
    be preempted again and again."""

    name = "arrival-deadline"

    def pick(self, queue, ctx):
        return min(range(len(queue)),
                   key=lambda i: (ctx.submit_t(queue[i][1]), queue[i][0]))

    def victim(self, slots, ctx):
        def deadline(s):
            req = ctx.active.get(s)
            return (ctx.submit_t(req) if req is not None else 0.0,
                    ctx.admit_seq.get(s, -1))
        return max(slots, key=deadline)


class PrefixAffinityPolicy(SchedulingPolicy):
    """Admit the first queued request whose leading prompt block is
    already resident in the paged pool (live shared or retained),
    turning warm prefixes into copy-free admissions while they are still
    warm; arrival order when nothing is warm or the pool cannot
    answer."""

    name = "prefix-affinity"

    def pick(self, queue, ctx):
        if ctx.prefix_warm is not None:
            for i, (_, req) in enumerate(queue):
                if ctx.prefix_warm(req):
                    return i
        return 0
