"""The port's sampled decoding against the JAX package (jax 0.9.0).

The PRNG first: PRNGKey, fold_in, the 32-bit random bits and the
uniforms are bit-exact with jax.random; each log differs from XLA's by
at most one ulp, so a gumbel value is held within two ulps at magnitude
max(|g|, 1). Then Sampler.sample's picks for temperature, top-k, top-p
and their mixes, the request and per-token keys, and the engines:
the sampled continuous engine (paged, dense) and the static engine
against their JAX counterparts on reduced gemma2-2b (fp32, the JAX
side on attn_kernel="xla"), and the dense CachePool's arenas after
insert, evict and rollback."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import CachePool as JaxCachePool
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving.sampler import Sampler as JaxSampler
from repro.serving.sampler import fold_keys as jax_fold_keys
from repro_torch.serving import (CachePool, ContinuousEngine, Request,
                                 Sampler, ServeEngine, fold_keys)
from repro_torch.serving import sampler as ts

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)
U32 = st.integers(0, 2 ** 32 - 1)


def _keys(seed, n):
    """n distinct (2,) uint32 JAX keys: fold_in(PRNGKey(seed), i)."""
    base = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.fold_in(base, i))
                     for i in range(n)])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-2 ** 40, 2 ** 40))
def test_prng_key_bit_exact(seed):
    np.testing.assert_array_equal(ts.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@settings(max_examples=40, deadline=None)
@given(k1=U32, k2=U32, data=U32)
def test_fold_in_bit_exact(k1, k2, data):
    key = np.array([k1, k2], np.uint32)
    want = np.asarray(jax.random.fold_in(jnp.asarray(key), data))
    np.testing.assert_array_equal(ts.fold_in(key, data), want)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), rows=st.integers(1, 4),
       n=st.integers(1, 3000))
def test_random_bits_and_uniform_bit_exact(seed, rows, n):
    keys = _keys(seed, rows)
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                                jnp.uint32)) for k in keys])
    np.testing.assert_array_equal(
        ts.random_bits(keys, n).numpy().astype(np.uint32), bits)
    # the ranges the sampler draws from: the scale maxval - minval is 1
    # in fp32 there, so the shift is exact whether or not XLA contracts
    # it into a fused multiply-add (it does on the CPU)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
        want = np.stack([np.asarray(jax.random.uniform(
            jnp.asarray(k), (n,), minval=lo, maxval=hi)) for k in keys])
        got = ts.uniform(keys, n, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("n", [1, 1024, 256000])
def test_gumbel_within_two_ulps_and_bits_at_full_vocab(n):
    """At gemma2-2b's vocab too: bits and uniforms bit-exact; log within
    one ulp of XLA's; gumbel within 2 ulps at magnitude max(|g|, 1)."""
    keys = _keys(5, 3)
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                                jnp.uint32)) for k in keys])
    np.testing.assert_array_equal(
        ts.random_bits(keys, n).numpy().astype(np.uint32), bits)
    u = ts.uniform(keys, n, TINY, 1.0).numpy()
    assert _ulps(np.asarray(jnp.log(jnp.asarray(u))),
                 torch.log(torch.from_numpy(u)).numpy()).max() <= 1
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,)))
                     for k in keys])
    got = ts.gumbel(keys, n).numpy()
    spacing = np.spacing(np.maximum(np.abs(want), 1.0)).astype(np.float64)
    assert (np.abs(got.astype(np.float64) - want) <= 2 * spacing).all()


SAMPLERS = ["temperature=1", "temperature=0.7", "temperature=1.5,seed=9",
            "temperature=0.8,top_k=1", "temperature=0.8,top_k=50",
            "temperature=0.8,top_p=0.9", "temperature=1,top_p=0.5,seed=4",
            "temperature=0.8,top_k=50,top_p=0.9,seed=3",
            "temperature=0.6,top_k=5000,top_p=0.95"]


@pytest.mark.parametrize("spec", SAMPLERS)
@pytest.mark.parametrize("vocab", [1024, 256000])
def test_sampler_picks_match_jax(spec, vocab):
    """Sampler.sample draws the JAX sampler's tokens, row keys from the
    engines' scheme (request key folded with a token index). The logits
    are scaled so that the top-p edge is not within 1e-6 of a
    cumulative mass (checked)."""
    rng = np.random.default_rng(vocab)
    rows = 8 if vocab == 1024 else 3
    logits = (rng.standard_normal((rows, vocab)) * 4).astype(np.float32)
    js, tsm = JaxSampler.parse(spec), Sampler.parse(spec)
    rkeys = np.stack([tsm.request_key(r) for r in range(rows)])
    np.testing.assert_array_equal(
        rkeys, np.stack([np.asarray(js.request_key(r))
                         for r in range(rows)]))
    keys = fold_keys(rkeys, np.arange(rows) * 3)
    np.testing.assert_array_equal(
        keys, np.asarray(jax_fold_keys(jnp.asarray(rkeys),
                                       jnp.arange(rows, dtype=jnp.int32)
                                       * 3)))
    if js.top_p < 1.0:
        t = np.sort(logits / np.float32(js.temperature), axis=-1)[:, ::-1]
        p = np.exp(t - t[:, :1])
        cum = np.cumsum(p / p.sum(axis=-1, keepdims=True), axis=-1)
        assert np.abs(cum - js.top_p).min() > 1e-6
    want = np.asarray(js.sample(jnp.asarray(logits), jnp.asarray(keys)))
    got = tsm.sample(torch.from_numpy(logits), keys)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


SPEC = [(7, 5), (11, 4), (5, 6), (9, 3)]
SAMPLER = "temperature=0.9,top_k=50,top_p=0.95,seed=7"
MAX_LEN = 48


def make_requests(cls, vocab, spec=SPEC, seed=1, prefix=0):
    """tests/conftest.make_serving_requests, for either package."""
    rng = np.random.default_rng([seed, 999])
    common = rng.integers(5, vocab, size=prefix).astype(np.int32)
    return [cls(prompt=np.concatenate([
                    common, np.random.default_rng([seed, i]).integers(
                        5, vocab, size=n).astype(np.int32)]),
                max_new_tokens=m) for i, (n, m) in enumerate(spec)]


def _tokens(reqs):
    return [r.generated.tolist() for r in reqs]


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_sampled_continuous_engine_matches_jax(gemma_pair, cache):
    jarch, jparams, tarch, tparams = gemma_pair
    kw = dict(max_batch=2, max_len=MAX_LEN, prefill_bucket=8,
              policy="fp32", sampler=SAMPLER, cache=cache)
    if cache == "paged":
        kw.update(block_size=8)
    a = make_requests(JaxRequest, jarch.cfg.vocab)
    JaxEngine(jarch, jparams, **kw,
              **({"attn_kernel": "xla"} if cache == "paged" else {})).run(a)
    b = make_requests(Request, tarch.cfg.vocab)
    ContinuousEngine(tarch, tparams, **kw,
                     **({"attn_kernel": "paged"} if cache == "paged"
                        else {})).run(b)
    assert _tokens(b) == _tokens(a)
    assert all(len(r.generated) == r.max_new_tokens for r in b)


@pytest.mark.parametrize("sampler", [None, SAMPLER])
def test_static_engine_matches_jax(gemma_pair, sampler):
    """Each engine is held to its own JAX counterpart: on jax 0.9.0 the
    JAX static and continuous engines part under sampling."""
    jarch, jparams, tarch, tparams = gemma_pair
    a = make_requests(JaxRequest, jarch.cfg.vocab)
    JaxServeEngine(jarch, jparams, max_len=MAX_LEN, policy="fp32",
                   sampler=sampler).run_batch(a)
    b = make_requests(Request, tarch.cfg.vocab)
    ServeEngine(tarch, tparams, max_len=MAX_LEN, policy="fp32",
                sampler=sampler).run_batch(b)
    assert _tokens(b) == _tokens(a)


def test_temperature_zero_is_greedy_and_top_k1_is_argmax(gemma_pair):
    _, _, tarch, tparams = gemma_pair
    kw = dict(max_batch=2, max_len=MAX_LEN, prefill_bucket=8,
              policy="fp32")
    runs = []
    for sampler in (None, "temperature=0,seed=123",
                    "temperature=1.7,top_k=1,seed=5"):
        reqs = make_requests(Request, tarch.cfg.vocab)
        ContinuousEngine(tarch, tparams, sampler=sampler, **kw).run(reqs)
        runs.append(_tokens(reqs))
    assert runs[0] == runs[1] == runs[2]


def _request_cache(rng, like):
    """A batch-1 request cache shaped like `like`, random content."""
    slots = []
    for s in like["slots"]:
        L = s["k"].shape[2]
        slots.append({
            "k": rng.standard_normal((s["k"].shape[0], 1) + s["k"].shape[2:]),
            "v": rng.standard_normal((s["v"].shape[0], 1) + s["v"].shape[2:]),
            "pos": np.tile(np.arange(L, dtype=np.int32) - 3,
                           (s["pos"].shape[0], 1, 1))})
    return {"slots": slots, "index": np.array([int(rng.integers(1, 9))],
                                              np.int32)}


def test_dense_cache_pool_arenas_match_jax(gemma_pair):
    """Insert, evict and rollback leave the port's dense pool equal to
    the JAX pool, leaf by leaf (k/v in the pool's bf16, positions
    including the left-pad rows' negative ones, cursors)."""
    jarch, _, tarch, _ = gemma_pair
    jpool = JaxCachePool(jarch, 3, 24)
    tpool = CachePool(tarch, 3, 24)
    rng = np.random.default_rng(0)
    like = jax.tree.map(np.asarray, jpool.cache)

    def compare():
        for js, tsl in zip(jpool.cache["slots"], tpool.cache["slots"]):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(
                    tsl[name].float().numpy(),
                    np.asarray(js[name], np.float32), err_msg=name)
        np.testing.assert_array_equal(tpool.lengths(), jpool.lengths())

    for slot in (0, 2, 1):
        req = _request_cache(rng, like)
        jreq = {"slots": tuple({k: jnp.asarray(v, jnp.float32)
                                if k != "pos" else jnp.asarray(v)
                                for k, v in s.items()}
                               for s in req["slots"]),
                "index": jnp.asarray(req["index"])}
        treq = {"slots": tuple({k: torch.as_tensor(
                    v, dtype=torch.float32 if k != "pos" else torch.int32)
                    for k, v in s.items()} for s in req["slots"]),
                "index": torch.as_tensor(req["index"])}
        jpool.insert(jreq, slot)
        tpool.insert(treq, slot)
        compare()
    jpool.evict(2)
    tpool.evict(2)
    compare()
    rows = {0: range(5, 9), 1: range(22, 26)}    # 1 wraps its ring
    new_index = np.array([5, 22, 0], np.int32)
    jpool.rollback_rows(rows, new_index, 12)
    tpool.rollback_rows(rows, new_index, 12)
    compare()
