"""The port's model code against the JAX package on the same inputs:
models/common.py functions, models/attention.py (full sequence, pooled
prefill cache with the ring-tail write, the paged branch with both
decode implementations) and reduced gemma2-2b's decoder_apply.

Everything runs in fp32 (compute dtype and caches) unless a test says
otherwise. Tolerances: 1e-5 for single functions and one attention
layer, 1e-4 for whole-model logits (two layers plus a 1024-wide head
accumulate more summation-order differences).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decoder as jdec
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decoder as tdec

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(rng, i, o, bias=False):
    p = {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(size=(o,)).astype(np.float32)
    return p


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


# --------------------------------------------------------------------------
# models/common.py
# --------------------------------------------------------------------------

def _common_case(name, rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    if name == "rmsnorm":
        p = {"scale": rng.normal(size=(16,)).astype(np.float32)}
        return (jcommon.rmsnorm_apply(p, x),
                tcommon.rmsnorm_apply(_tree_t(p), _t(x)))
    if name == "softcap":
        return jcommon.softcap(x * 40, 30.0), tcommon.softcap(_t(x * 40), 30.0)
    if name == "rope_shared_positions":
        pos = np.arange(5, dtype=np.int32) + 7
        return (jcommon.apply_rope(x, pos), tcommon.apply_rope(_t(x), _t(pos)))
    if name == "rope_per_slot_positions":
        pos = np.array([[-2, -1, 0, 1, 2], [3, 4, 5, 6, 7]], np.int32)
        return (jcommon.apply_rope(x, pos, 500.0),
                tcommon.apply_rope(_t(x), _t(pos), 500.0))
    if name == "gelu":
        return jcommon.gelu(x * 3), tcommon.gelu(_t(x * 3))
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    if name == "dense_bias":
        p = _dense(rng, 16, 8, bias=True)
        return (jcommon.dense_apply(p, h, jnp.float32),
                tcommon.dense_apply(_tree_t(p), _t(h), torch.float32))
    if name == "gated_gelu_mlp":
        p = {"up": _dense(rng, 16, 32), "gate": _dense(rng, 16, 32),
             "down": _dense(rng, 32, 16)}
        return (jcommon.mlp_apply(p, h, activation="gelu",
                                  compute_dtype=jnp.float32),
                tcommon.mlp_apply(_tree_t(p), _t(h), activation="gelu",
                                  compute_dtype=torch.float32))
    e = {"embedding": rng.normal(size=(50, 16)).astype(np.float32)}
    if name == "embed":
        ids = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
        return (jcommon.embed_apply(e, ids, jnp.float32),
                tcommon.embed_apply(_tree_t(e), _t(ids), torch.float32))
    if name == "embed_attend":
        return (jcommon.embed_attend(e, h, jnp.float32),
                tcommon.embed_attend(_tree_t(e), _t(h), torch.float32))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "rmsnorm", "softcap", "rope_shared_positions", "rope_per_slot_positions",
    "gelu", "dense_bias", "gated_gelu_mlp", "embed", "embed_attend"])
def test_common_matches_jax(name):
    want, got = _common_case(name, np.random.default_rng(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_rmsnorm_keeps_input_dtype():
    x = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    p = {"scale": np.zeros(8, np.float32)}
    got = tcommon.rmsnorm_apply(_tree_t(p), _t(x).to(torch.bfloat16))
    want = jcommon.rmsnorm_apply(p, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# --------------------------------------------------------------------------
# models/attention.py
# --------------------------------------------------------------------------

D, H, KV, HD = 32, 4, 2, 8


def _attn_setup(seed, **over):
    rng = np.random.default_rng(seed)
    kw = dict(d_model=D, n_heads=H, n_kv_heads=KV, head_dim=HD,
              qkv_bias=True, sliding_window=6, logit_softcap=20.0)
    kw.update(over)
    jcfg = jattn.AttnConfig(**kw)
    tcfg = tattn.AttnConfig(**kw)
    p = {"wq": _dense(rng, D, H * HD, True), "wk": _dense(rng, D, KV * HD, True),
         "wv": _dense(rng, D, KV * HD, True), "wo": _dense(rng, H * HD, D)}
    return rng, jcfg, tcfg, p


@pytest.mark.parametrize("window", [None, 6])
def test_attention_full_sequence(window):
    rng, jcfg, tcfg, p = _attn_setup(0, sliding_window=window)
    x = rng.normal(size=(2, 9, D)).astype(np.float32)
    want, _ = jattn.attn_apply(p, jcfg, x, compute_dtype=jnp.float32)
    got, _ = tattn.attn_apply(_tree_t(p), tcfg, _t(x),
                              compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("S,cache_len", [(5, 12), (9, 6)],
                         ids=["rows", "ring_tail"])
def test_attention_pooled_prefill_cache(S, cache_len):
    """Left-padded prefill into a per-slot cache: the row write and, for
    S >= cache_len (a sliding-window ring), the rolled tail write."""
    rng, jcfg, tcfg, p = _attn_setup(1)
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    pos = np.stack([np.arange(S) - 2, np.arange(S)]).astype(np.int32)
    jc = jattn.init_kv_cache(2, cache_len, KV, HD, jnp.float32,
                             per_slot=True)
    want, jnew = jattn.attn_apply(p, jcfg, x, positions=pos, cache=jc,
                                  compute_dtype=jnp.float32)
    tc = tattn.init_kv_cache(2, cache_len, KV, HD, torch.float32)
    tc["index"] = torch.zeros(2, dtype=torch.int32)
    got, tnew = tattn.attn_apply(_tree_t(p), tcfg, _t(x), positions=_t(pos),
                                 cache=tc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jnew[name]), **F32)
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    np.testing.assert_array_equal(tnew["index"].numpy(),
                                  np.asarray(jnew["index"]))


def _paged_state(rng, B=3, bs=4, nb=3, n_blocks=10):
    k = rng.normal(size=(n_blocks, bs, KV, HD)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, KV, HD)).astype(np.float32)
    pos = np.full((n_blocks, bs), -1, np.int32)
    tbl = np.zeros((B, nb), np.int32)
    tbl[0] = [1, 2, 3]
    tbl[1, :2] = [4, 5]
    for r in range(7):                          # slot 0 history 0..6
        pos[tbl[0, r // bs], r % bs] = r
    for r in range(5):                          # slot 1 history 0..4
        pos[tbl[1, r // bs], r % bs] = r
    index = np.array([7, 5, 0], np.int32)
    positions = np.array([[7], [5], [-1]], np.int32)   # slot 2 inactive
    return {"k": k, "v": v, "pos": pos}, tbl, index, positions


@pytest.mark.parametrize("kernel", ["xla", "paged"])
def test_attention_paged_branch_matches_jax_xla(kernel):
    """The port's paged branch, either implementation, against the JAX
    XLA branch. Outputs of live slots agree to 1e-5 (the JAX branch
    gives a dead slot the uniform mean, the kernel contract 0). On data
    blocks the positions agree exactly and K/V to 1e-5 (the new rows are
    projections, computed by each framework); the null block differs by
    design: the JAX branch writes a dead slot's row there, the kernel
    writes nothing."""
    rng, jcfg, tcfg, p = _attn_setup(2)
    tcfg = dataclasses.replace(tcfg, decode_kernel=kernel)
    arenas, tbl, index, positions = _paged_state(rng)
    x = rng.normal(size=(3, 1, D)).astype(np.float32)
    jc = {**{k: jnp.asarray(v) for k, v in arenas.items()},
          "index": jnp.asarray(index), "table": jnp.asarray(tbl)}
    want, jnew = jattn.attn_apply(p, jcfg, x, positions=positions, cache=jc,
                                  compute_dtype=jnp.float32)
    tc = {**{k: _t(v) for k, v in arenas.items()}, "index": _t(index),
          "table": _t(tbl)}
    got, tnew = tattn.attn_apply(_tree_t(p), tcfg, _t(x),
                                 positions=_t(positions), cache=tc,
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **F32)
    np.testing.assert_array_equal(tnew["pos"].numpy()[1:],
                                  np.asarray(jnew["pos"])[1:])
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].numpy()[1:],
                                   np.asarray(jnew[name])[1:], **F32)
    np.testing.assert_array_equal(tnew["index"].numpy(),
                                  np.asarray(jnew["index"]))
    assert tnew["k"] is tc["k"]                 # written in place


# --------------------------------------------------------------------------
# models/decoder.py (reduced gemma2-2b)
# --------------------------------------------------------------------------

def _fp32(jarch, tarch):
    return (dataclasses.replace(jarch.cfg, compute_dtype=jnp.float32),
            dataclasses.replace(tarch.cfg, compute_dtype=torch.float32))


def test_decoder_logits_match_jax(gemma_pair):
    jarch, jparams, tarch, tparams = gemma_pair
    jcfg, tcfg = _fp32(jarch, tarch)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab, size=(2, 20)).astype(np.int32)
    want, _, _ = jdec.decoder_apply(jparams, jcfg, tokens)
    got, caches, aux = tdec.decoder_apply(tparams, tcfg, _t(tokens))
    assert caches is None and got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == float(aux["router_entropy"]) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["xla", "paged"])
def test_paged_decode_equals_full_forward(gemma_pair, kernel):
    """Token-by-token decode through the paged cache (fp32 arenas) gives
    the full forward's logits at every position, through a ring wrap of
    the sliding-window layers (window 16, 20 tokens)."""
    _, _, tarch, tparams = gemma_pair
    tcfg = dataclasses.replace(tarch.cfg, compute_dtype=torch.float32,
                               attn_kernel=kernel)
    T, bs = 20, 8
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, size=(1, T)).astype(np.int32))
    full, _, _ = tdec.decoder_apply(tparams, tcfg, tokens)
    cache = tdec.init_paged_decoder_cache(tcfg, 1, 24, block_size=bs,
                                          n_blocks=4, dtype=torch.float32)
    cache["tables"] = tuple(torch.arange(1, 1 + t.shape[1],
                                         dtype=torch.int32)[None]
                            for t in cache["tables"])
    for t in range(T):
        logits, cache, _ = tdec.decoder_apply(
            tparams, tcfg, tokens[:, t:t + 1], caches=cache,
            positions=torch.tensor([[t]], dtype=torch.int32))
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, t].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f"t={t}")


def test_prefill_then_decode_equals_full_forward(gemma_pair):
    """Prefill into the pooled cache (fp32 rows), then decode: the last
    logits of each call equal the full forward's."""
    _, _, tarch, tparams = gemma_pair
    tcfg = dataclasses.replace(tarch.cfg, compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, size=(2, 14)).astype(np.int32))
    full, _, _ = tdec.decoder_apply(tparams, tcfg, tokens)
    cache = tdec.init_decoder_cache(tcfg, 2, 40, torch.float32)
    logits, cache, _ = tdec.decoder_apply(tparams, tcfg, tokens[:, :10],
                                          caches=cache)
    np.testing.assert_allclose(logits.numpy(), full[:, :10].numpy(),
                               rtol=1e-4, atol=1e-4)
    for t in range(10, 14):
        logits, cache, _ = tdec.decoder_apply(
            tparams, tcfg, tokens[:, t:t + 1], caches=cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert cache["index"].tolist() == [14, 14]
