"""The port's Scheduler FIFO helpers (assign_one, assign, admitted_order;
serving/scheduler.py) against the JAX package's Scheduler, driven as
tests/test_scheduling.py and tests/test_serving_properties.py drive it:
the same operations on both, the same answers and state after each."""
import numpy as np
import pytest

from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.serving.scheduler import Scheduler


def _state(s):
    return (list(s._free), [(t, r) for t, r in s.queue_items()],
            dict(s.active), list(s.completed), dict(s._slot_ticket))


def test_preempt_restores_arrival_order_like_jax():
    """tests/test_scheduling.py's preempt/assign sequence, on both."""
    pair = (JScheduler(2), Scheduler(2))
    for s in pair:
        for i in range(5):
            s.submit(f"r{i}")
    got = [s.assign() for s in pair]
    assert got[0] == got[1] and [r for _, r in got[1]] == ["r0", "r1"]
    for s in pair:
        s.preempt(got[1][0][0])
        assert s.peek() == "r0"
        s.check_invariants()
    again = [s.assign() for s in pair]
    assert again[0] == again[1] and [r for _, r in again[1]] == ["r0"]
    for s in pair:
        assert s.admitted_order(again[1][0][0]) == 0
        s.complete(got[1][1][0])
    nxt = [s.assign() for s in pair]
    assert nxt[0] == nxt[1] and [r for _, r in nxt[1]] == ["r2"]
    assert _state(pair[0]) == _state(pair[1])


@pytest.mark.parametrize("seed", range(6))
def test_random_schedules_match_jax(seed):
    """tests/test_serving_properties.py's random submit / assign /
    complete interleavings (seeded here): the same pairs, tickets and
    state on both after every operation, FIFO admission, and a drain
    that completes every request once."""
    rng = np.random.default_rng(seed)
    n_slots, n_requests = int(rng.integers(1, 5)), int(rng.integers(0, 26))
    pair = (JScheduler(n_slots), Scheduler(n_slots))
    pending = [f"r{i}" for i in range(n_requests)]
    admitted = []
    for c in rng.integers(0, 2 ** 16, size=200):
        op = c % 3
        if op == 0 and pending:
            req = pending.pop(0)
            tickets = [s.submit(req) for s in pair]
            assert tickets[0] == tickets[1]
        elif op == 1:
            outs = [s.assign() for s in pair]
            assert outs[0] == outs[1]
            admitted += [r for _, r in outs[1]]
        elif op == 2 and pair[1].active:
            slots = sorted(pair[1].active)
            slot = slots[int(rng.integers(0, len(slots)))]
            orders = [s.admitted_order(slot) for s in pair]
            assert orders[0] == orders[1]
            for s in pair:
                s.complete(slot)
        for s in pair:
            s.check_invariants()
        assert _state(pair[0]) == _state(pair[1])
    while pending:
        req = pending.pop(0)
        for s in pair:
            s.submit(req)
    while pair[1].has_work:
        outs = [s.assign() for s in pair]
        assert outs[0] == outs[1]
        admitted += [r for _, r in outs[1]]
        for slot in sorted(pair[1].active):
            for s in pair:
                s.complete(slot)
    assert admitted == [f"r{i}" for i in range(n_requests)]
    assert _state(pair[0]) == _state(pair[1])


def test_assign_one_and_next_free():
    """assign_one binds the queue head to the slot next_free names; None
    when either side is empty, as the JAX helper."""
    pair = (JScheduler(2), Scheduler(2))
    assert [s.assign_one() for s in pair] == [None, None]
    for s in pair:
        s.submit("a")
        s.submit("b")
        s.submit("c")
    port = pair[1]
    for _ in range(2):
        slot = port.next_free
        outs = [s.assign_one() for s in pair]
        assert outs[0] == outs[1] and outs[1][0] == slot
    assert port.next_free is None
    assert [s.assign_one() for s in pair] == [None, None]
