"""The port's ReplicaRouter and prefix-affinity policy against the JAX
package's (repro/serving/router.py, scheduler.PrefixAffinityPolicy).

The cases of tests/test_router.py run on both routers: the content key
bit for bit, the routes of each policy on stub replicas, the sticky
map's LRU bound and counters, and, on live fleets of reduced qwen2.5-14b
engines (the port's with the kernel path, its plain version on the CPU;
the JAX ones with the XLA gather), routed tokens equal to one port
engine and to the JAX fleet, and the report's fields. Routing never
changes tokens, so every fleet emits one engine's greedy stream.
"""
import jax
import numpy as np
import pytest

from conftest import make_serving_requests as jax_make_requests
from repro.configs import reduced_arch as jreduced
from repro.serving import ContinuousEngine as JEngine
from repro.serving import ReplicaRouter as JRouter
from repro.serving import Request as JRequest
from repro.serving import prefix_route_key as jkey
from repro.serving.scheduler import PolicyContext as JContext
from repro.serving.scheduler import PrefixAffinityPolicy as JAffinity
from repro_torch.bridge import params_from_jax
from repro_torch.configs import reduced_arch as treduced
from repro_torch.serving import (ROUTE_POLICIES, ContinuousEngine,
                                 PolicyContext, PrefixAffinityPolicy,
                                 ReplicaRouter, Request, SchedulingPolicy,
                                 prefix_route_key)

ARCH = "qwen2.5-14b"


def _prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(
        5, vocab, size=n).astype(np.int32)


# --------------------------------------------------------------------------
# prefix_route_key
# --------------------------------------------------------------------------

def test_route_key_sub_block_prompts_have_no_key():
    assert prefix_route_key(_prompt(0, 7), 8) is None is jkey(_prompt(0, 7),
                                                              8)
    assert prefix_route_key(_prompt(0, 8), 8) is not None


def test_route_key_depends_only_on_leading_block():
    p = _prompt(1, 24)
    q = np.concatenate([p[:8], _prompt(2, 40)])
    r = p.copy()
    r[3] += 1
    assert prefix_route_key(p, 8) == prefix_route_key(q, 8)
    assert prefix_route_key(p, 8) != prefix_route_key(r, 8)
    assert prefix_route_key(p, 8) != prefix_route_key(p, 16)


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_route_key_bytes_equal_jax(block_size):
    for seed in range(6):
        p = _prompt(seed, 3 * block_size, vocab=50000)
        assert prefix_route_key(p, block_size) == jkey(p, block_size)


# --------------------------------------------------------------------------
# routing decisions on stub replicas, both routers
# --------------------------------------------------------------------------

class _StubSched:
    def __init__(self):
        self.queued, self.active, self.completed = 0, {}, []

    @property
    def has_work(self):
        return bool(self.queued or self.active)


class _StubReplica:
    def __init__(self):
        self.scheduler = _StubSched()
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)
        self.scheduler.queued += 1


def _routers(n=3, **kw):
    """(port router, JAX router), each over its own stub replicas."""
    return tuple(cls([_StubReplica() for _ in range(n)], block_size=8, **kw)
                 for cls in (ReplicaRouter, JRouter))


def _both(routers, fn):
    out = [fn(rt, req_cls) for rt, req_cls in zip(routers,
                                                  (Request, JRequest))]
    assert out[0] == out[1]
    return out[0]


def _counters(rt):
    return (rt.routed_submits, rt.routed_affinity_hits, rt.routed_fallback)


def test_rr_policy_cycles():
    rts = _routers(policy="rr")
    routes = _both(rts, lambda rt, R: [rt.route(R(prompt=_prompt(i, 16)))
                                       for i in range(7)])
    assert routes == [0, 1, 2, 0, 1, 2, 0]


def test_depth_policy_picks_least_outstanding():
    rts = _routers(policy="depth")
    for rt in rts:
        for i, q in enumerate((5, 1, 3)):
            rt.replicas[i].scheduler.queued = q
    assert _both(rts, lambda rt, R: rt.route(R(prompt=_prompt(0, 16)))) == 1
    for rt in rts:
        rt.replicas[1].scheduler.active = {0: None, 1: None, 2: None, 3: None}
    assert _both(rts, lambda rt, R: rt.route(R(prompt=_prompt(1, 16)))) == 2


def test_prefix_policy_sticky_under_depth_changes():
    rts = _routers(policy="prefix")
    shared = _prompt(7, 8)
    home = _both(rts, lambda rt, R: rt.route(
        R(prompt=np.concatenate([shared, _prompt(1, 8)]))))
    for rt in rts:
        rt.replicas[home].scheduler.queued = 100
    assert _both(rts, lambda rt, R: rt.route(
        R(prompt=np.concatenate([shared, _prompt(2, 8)])))) == home
    assert _both(rts, lambda rt, R: _counters(rt)) == (0, 1, 0)


def test_prefix_policy_sub_block_falls_back_to_depth():
    rts = _routers(policy="prefix")
    for rt in rts:
        rt.replicas[0].scheduler.queued = 9
        rt.replicas[2].scheduler.queued = 9
    assert _both(rts, lambda rt, R: rt.route(R(prompt=_prompt(0, 4)))) == 1
    assert _both(rts, lambda rt, R: _counters(rt)) == (0, 0, 1)


def test_prefix_policy_distinct_prefixes_balance_by_depth():
    rts = _routers(policy="prefix")

    def homes(rt, R):
        out = []
        for i in range(4):
            home = rt.route(R(prompt=_prompt(100 + i, 16)))
            out.append(home)
            rt.replicas[home].scheduler.queued += 10
        return out

    assert len(set(_both(rts, homes))) == 3


def test_affinity_map_is_bounded_lru():
    rts = _routers(policy="prefix", max_keys=2)
    keys = [_prompt(200 + i, 8) for i in range(3)]

    def fill(rt, R):
        for p in keys:
            rt.route(R(prompt=p))
        n = len(rt._affinity)
        rt.route(R(prompt=keys[0]))
        return n, len(rt._affinity), list(rt._affinity.values())

    assert _both(rts, fill)[:2] == (2, 2)


def test_submit_lands_on_routed_replica_and_counts():
    rts = _routers(policy="rr")

    def go(rt, R):
        for i in range(4):
            rt.submit(R(prompt=_prompt(i, 16)))
        return rt.routed_submits, [len(e.submitted) for e in rt.replicas]

    assert _both(rts, go) == (4, [2, 1, 1])


def test_router_validation():
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])
    with pytest.raises(ValueError, match="route policy"):
        ReplicaRouter([_StubReplica()], block_size=8, policy="best-effort")
    with pytest.raises(ValueError, match="paged replicas"):
        ReplicaRouter([_StubReplica()], policy="prefix")
    assert set(ROUTE_POLICIES) == {"prefix", "depth", "rr"}


# --------------------------------------------------------------------------
# live fleets: tokens and reports against one port engine and JAX's fleet
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_pair():
    jarch, tarch = jreduced(ARCH), treduced(ARCH)
    jparams = jarch.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(tarch.cfg, jax.tree.map(np.asarray, jparams))
    return jarch, jparams, tarch, tparams


ENGINE_KW = dict(max_batch=2, max_len=48, cache="paged", block_size=8,
                 policy="fp32")


def _port_engine(tarch, tparams, **kw):
    return ContinuousEngine(tarch, tparams, attn_kernel="paged",
                            **ENGINE_KW, **kw)


def _jax_engine(jarch, jparams, **kw):
    return JEngine(jarch, jparams, attn_kernel="xla", **ENGINE_KW, **kw)


def _prompts(jarch):
    """Two tenant prefixes (>= one block each) and one sub-block prompt,
    the stream of tests/test_router.py."""
    a = jax_make_requests(jarch, [8, 8], seed=3, prefix=16,
                          max_new_tokens=5)
    b = jax_make_requests(jarch, [8, 8], seed=4, prefix=16, prefix_seed=11,
                          max_new_tokens=5)
    return [r.prompt.copy() for r in (a[0], b[0], a[1], b[1])] + [
        _prompt(9, 6)]


def _reqs(cls, prompts):
    return [cls(prompt=p.copy(), max_new_tokens=5) for p in prompts]


def _tokens(reqs):
    return [r.generated.tolist() for r in reqs]


@pytest.mark.parametrize("policy", ROUTE_POLICIES)
def test_routed_tokens_match_single_engine(qwen_pair, policy):
    jarch, jparams, tarch, tparams = qwen_pair
    prompts = _prompts(jarch)
    solo = _reqs(Request, prompts)
    _port_engine(tarch, tparams).run(solo)
    fleet = ReplicaRouter([_port_engine(tarch, tparams) for _ in range(2)],
                          policy=policy)
    reqs = _reqs(Request, prompts)
    done = fleet.run(reqs)
    jfleet = JRouter([_jax_engine(jarch, jparams) for _ in range(2)],
                     policy=policy)
    jreqs = _reqs(JRequest, prompts)
    jfleet.run(jreqs)
    assert len(done) == len(solo)
    assert _tokens(reqs) == _tokens(solo) == _tokens(jreqs)
    assert not fleet.scheduler.has_work
    assert _counters(fleet) == _counters(jfleet)
    assert fleet.routed_submits == len(prompts)
    # the same requests landed on the same replicas
    assert ([sorted(r.prompt.tobytes() for r in e.scheduler.completed)
             for e in fleet.replicas]
            == [sorted(r.prompt.tobytes() for r in e.scheduler.completed)
                for e in jfleet.replicas])


def test_router_report_schema(qwen_pair):
    jarch, jparams, tarch, tparams = qwen_pair
    prompts = _prompts(jarch)
    fleet = ReplicaRouter([_port_engine(tarch, tparams) for _ in range(2)],
                          policy="prefix")
    fleet.run(_reqs(Request, prompts))
    jfleet = JRouter([_jax_engine(jarch, jparams) for _ in range(2)],
                     policy="prefix")
    jfleet.run(_reqs(JRequest, prompts))
    rep, jrep = fleet.report(1.0), jfleet.report(1.0)
    assert set(rep) == set(jrep)
    for key in ("replicas", "route_policy", "routed_submits",
                "routed_affinity_hits", "routed_fallback", "completed",
                "retained_hit_rate"):
        assert rep[key] == jrep[key], key
    assert rep["replicas"] == 2 and rep["route_policy"] == "prefix"
    assert rep["completed"] == 5
    assert rep["routed_fallback"] >= 1 and rep["routed_affinity_hits"] >= 2
    for key in ("tokens_per_s", "retained_hit_rate"):
        assert isinstance(rep[key], float) and np.isfinite(rep[key])
    assert len(rep["per_replica"]) == 2
    for idx, (sub, jsub) in enumerate(zip(rep["per_replica"],
                                          jrep["per_replica"])):
        assert sub["replica"] == idx
        assert np.isfinite(sub["tokens_per_s"])
        for key in ("decode_steps", "shared_block_hits",
                    "retained_block_hits", "prefix_misses"):
            assert sub[key] == jsub[key], (idx, key)


def test_router_block_size_defaults_from_paged_replica(qwen_pair):
    _, _, tarch, tparams = qwen_pair
    fleet = ReplicaRouter([_port_engine(tarch, tparams)], policy="prefix")
    assert fleet.block_size == 8


# --------------------------------------------------------------------------
# the prefix-affinity scheduling policy
# --------------------------------------------------------------------------

def test_prefix_affinity_picks_match_jax():
    """The first warm request of the queue, else the head, on both
    policies, for every pattern of warm flags."""
    pol, jpol = PrefixAffinityPolicy(), JAffinity()
    assert SchedulingPolicy.parse("prefix-affinity").name == jpol.name
    reqs = [Request(prompt=_prompt(i, 8)) for i in range(5)]
    queue = list(enumerate(reqs))
    index = {id(r): i for i, r in enumerate(reqs)}
    for mask in range(32):
        warm = lambda r: bool(mask >> index[id(r)] & 1)
        got = pol.pick(queue, PolicyContext(prefix_warm=warm))
        want = jpol.pick(queue, JContext(prefix_warm=warm))
        assert got == want == (next(
            (i for i in range(5) if mask >> i & 1), 0))
    assert pol.pick(queue, PolicyContext()) == 0


def test_prefix_affinity_engine_matches_jax(qwen_pair):
    """A stream whose tenants come back after their prefix went warm
    (retained) or stayed cold: the port's engine with the prefix-affinity
    policy admits in the JAX engine's order (the completion order of one
    slot at a time) and emits its tokens, and the warm probe answers as
    the JAX pool's does."""
    jarch, jparams, tarch, tparams = qwen_pair
    warm_a = jax_make_requests(jarch, [8, 8, 8], seed=5, prefix=16,
                               max_new_tokens=4)
    cold = jax_make_requests(jarch, [24, 24], seed=6, max_new_tokens=4)
    warm_b = jax_make_requests(jarch, [8], seed=7, prefix=16, prefix_seed=5,
                               max_new_tokens=4)
    prompts = [r.prompt.copy() for r in (warm_a[0], cold[0], cold[1],
                                         warm_a[1], warm_b[0], warm_a[2])]
    kw = dict(max_batch=1, max_len=48, cache="paged", block_size=8,
              policy="fp32", sched_policy="prefix-affinity")
    teng = ContinuousEngine(tarch, tparams, attn_kernel="paged", **kw)
    jeng = JEngine(jarch, jparams, attn_kernel="xla", **kw)
    treqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    jreqs = [JRequest(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    teng.run(treqs)
    jeng.run(jreqs)
    order = lambda eng: [r.prompt.tobytes() for r in eng.scheduler.completed]
    assert order(teng) == order(jeng)
    assert order(teng) != [p.tobytes() for p in prompts]   # reordered
    assert _tokens(treqs) == _tokens(jreqs)
    tr, jr = teng.report(1.0), jeng.report(1.0)
    for key in ("retained_block_hits", "prefix_misses", "shared_block_hits"):
        assert tr[key] == jr[key], key
    for p in prompts:
        args = (p, len(p), -(-len(p) // 8) * 8)
        assert teng.pool.prefix_warm(*args) == jeng.pool.prefix_warm(*args)
