"""The port's encoder-decoder (whisper-large-v3) against the JAX package
on the same inputs: cross-attention in its three forms, encode, the
training and single-stream decode, encdec_apply, the cross-K/V
projection, the serving prefill and decode step (logits and caches),
the loss and every gradient, the configs, the bridge, the training data
stream, fused LANS on whisper's leaves and the training CLI.

Inputs are made with numpy from a seed; the params are the JAX init,
carried over by repro_torch.bridge. Tolerances: 1e-5 (rtol and atol)
for fp32 compute on both sides, logits, caches, loss and gradients
alike; the single-stream decode through Arch, whose cache stores K/V in
bf16 on both sides, 1e-3 (a bf16 rounding of a key that differs by an
fp32 ulp moves it by 2^-8 relative); fused LANS against unfused 2e-5
(tests/test_kernels.py's fp32 tolerance).
"""
import contextlib
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs import reduced_arch as jreduced
from repro.core.optim.base import tree_paths as jpaths
from repro.launch.train import make_data as jmake_data
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.optim import fused_lans, lans
from repro_torch.core.optim.base import apply_updates, tree_items
from repro_torch.core.schedules import constant
from repro_torch.distributed.steps import loss_and_grads
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted

F32 = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-large-v3"


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX arch, JAX params, port arch, port params): reduced
    whisper-large-v3 (2 layers per stack, d 128, 16 frames), fp32
    compute on both sides, the same weights."""
    ja = jreduced(ARCH)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32))
    ta = tconfigs.reduced_arch(ARCH)
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=torch.float32))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    return ja, jp, ta, params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))


def _inputs(cfg, seed=0, B=2, S=9):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return frames, tokens


def _left_padded(S, pads):
    """(B, S) local positions, row b left-padded by pads[b] (pads < 0)."""
    return np.stack([np.arange(S) - p for p in pads]).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, shapes, bridge
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    for t, j in ((tconfigs.get_arch(ARCH), jget(ARCH)),
                 (tconfigs.reduced_arch(ARCH), jreduced(ARCH))):
        assert (t.name, t.kind, t.source) == (j.name, j.kind, j.source)
        for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab",
                  "n_frames", "max_target", "head_dim"):
            assert getattr(t.cfg, f) == getattr(j.cfg, f), f
        assert t.cfg.compute_dtype == torch.bfloat16
        assert t.cfg.param_dtype == torch.float32
    assert tconfigs.NOT_PORTED == ()
    assert isinstance(tconfigs.get_arch(ARCH).cfg, ted.EncDecConfig)


def test_full_whisper_shapes_match_jax():
    """Full width and depth, shapes only: the port's init on the meta
    device against the JAX init's abstract evaluation: 46 leaves,
    1,579,450,880 params, the largest leaf 209,715,200 elements."""
    jshapes = jax.eval_shape(jget(ARCH).init, jax.random.PRNGKey(0))
    want = dict(zip(jax.tree.leaves(jpaths(jshapes)),
                    [tuple(s.shape) for s in jax.tree.leaves(jshapes)]))
    with torch.device("meta"):
        got = {p: tuple(t.shape) for p, t in tree_items(
            tconfigs.get_arch(ARCH).init(None))}
    assert got == want
    assert len(got) == 46
    assert sum(math.prod(s) for s in got.values()) == 1_579_450_880
    assert math.prod(got["dec_layers/mlp/down/kernel"]) == 209_715_200 == \
        max(math.prod(s) for s in got.values())


def test_bridge_rejects_a_wrong_tree(pair):
    _, jp, ta, _ = pair
    bad = jax.tree.map(np.asarray, jp)
    bad["dec_layers"]["cross_attn"]["wk"]["kernel"] = \
        bad["dec_layers"]["cross_attn"]["wk"]["kernel"][..., :3]
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_jax(ta.cfg, bad)
    del bad["enc_ln_post"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(ta.cfg, bad)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def _attn_case(seed, qk_norm=False):
    rng = np.random.default_rng(seed)
    d, h, hd = 32, 4, 8
    kw = dict(d_model=d, n_heads=h, n_kv_heads=h, head_dim=hd,
              qkv_bias=True, qk_norm=qk_norm, rope=False, causal=True)
    dense = lambda i, o, b: {
        "kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
        **({"bias": rng.normal(size=(o,)).astype(np.float32)} if b else {})}
    p = {"wq": dense(d, h * hd, True), "wk": dense(d, h * hd, True),
         "wv": dense(d, h * hd, True), "wo": dense(h * hd, d, False)}
    if qk_norm:
        p["q_norm"] = {"scale": rng.normal(size=(hd,)).astype(np.float32)}
        p["k_norm"] = {"scale": rng.normal(size=(hd,)).astype(np.float32)}
    return rng, kw, p


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("form", ["kv_x", "dense", "paged"])
def test_cross_attention_matches_jax(form, qk_norm):
    """The three cross forms against the JAX package at fp32: K/V
    projected from the memory (kv_x; never causal, so a query sees every
    memory row), precomputed dense K/V with pad rows at position -1, and
    the paged arena gathered through a table (blocks out of order, a
    null entry). The causal flag of the config is ignored by all."""
    rng, kw, p = _attn_case(3 + qk_norm, qk_norm)
    B, S, Sm, H, hd, bs = 2, 3, 10, 4, 8, 4
    x = rng.normal(size=(B, S, 32)).astype(np.float32)
    mem = rng.normal(size=(B, Sm, 32)).astype(np.float32)
    pos = np.array([[4, 5, 6], [-1, 0, 1]], np.int32)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    kw_j, kw_t = {}, {}
    if form == "kv_x":
        kw_j, kw_t = dict(kv_x=mem), dict(kv_x=_t(mem))
    else:
        k = rng.normal(size=(B, 12, H, hd)).astype(np.float32)
        v = rng.normal(size=(B, 12, H, hd)).astype(np.float32)
        kpos = np.where(np.arange(12) < Sm, np.arange(12), -1).astype(
            np.int32)
        if form == "dense":
            kv = {"k": k, "v": v, "pos": kpos}
        else:
            # 3 blocks of 4 rows per slot in an 8-block arena; slot 1's
            # last table entry is the null block (pos -1 everywhere)
            ka = np.zeros((8, bs, H, hd), np.float32)
            va, pa = np.zeros_like(ka), np.full((8, bs), -1, np.int32)
            table = np.array([[5, 2, 7], [1, 4, 0]], np.int32)
            for b in range(B):
                for j, blk in enumerate(table[b]):
                    if blk:
                        ka[blk] = k[b, j * bs:(j + 1) * bs]
                        va[blk] = v[b, j * bs:(j + 1) * bs]
                        pa[blk] = kpos[j * bs:(j + 1) * bs]
            kv = {"k": ka, "v": va, "pos": pa, "table": table}
        kw_j = dict(kv_cache={n: jnp.asarray(a) for n, a in kv.items()})
        kw_t = dict(kv_cache={n: _t(a) for n, a in kv.items()})
    want, _ = jattn.attn_apply(p, jcfg, x, positions=pos,
                               compute_dtype=jnp.float32, **kw_j)
    got, cache = tattn.attn_apply(_tree_t(p), tcfg, _t(x),
                                  positions=_t(pos),
                                  compute_dtype=torch.float32, **kw_t)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cross_read_keeps_compute_dtype_probs_at_one_row():
    """At S = 1 in bf16 the read-only kv_cache path computes exactly what
    the kv_x path computes from the same memory (bf16 probabilities),
    not the fp32 probabilities of a cached self-attention decode step;
    and kv_cache excludes cache and kv_x."""
    rng, kw, p = _attn_case(5)
    cfg = tattn.AttnConfig(**{**kw, "causal": False})
    p = _tree_t(p)
    x = _t(rng.normal(size=(2, 1, 32)).astype(np.float32))
    mem = _t(rng.normal(size=(2, 10, 32)).astype(np.float32))
    bf = torch.bfloat16
    inline, _ = tattn.attn_apply(p, cfg, x, kv_x=mem, compute_dtype=bf)
    kv = {n: tattn.dense_apply(p[n], mem, bf).reshape(2, 10, 4, 8)
          for n in ("wk", "wv")}
    read, _ = tattn.attn_apply(p, cfg, x, compute_dtype=bf,
                               kv_cache={"k": kv["wk"], "v": kv["wv"]})
    assert torch.equal(read, inline)
    for extra in (dict(kv_x=mem), dict(cache={"index": torch.zeros(2)})):
        with pytest.raises(ValueError, match="exclusive"):
            tattn.attn_apply(p, cfg, x, kv_cache={"k": kv["wk"],
                                                  "v": kv["wv"]}, **extra)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_encode_decode_apply_match_jax(pair):
    ja, jp, ta, tp = pair
    frames, tokens = _inputs(ja.cfg, seed=1)
    jmem = jed.encode(jp, ja.cfg, frames)
    tmem = ted.encode(tp, ta.cfg, _t(frames))
    np.testing.assert_allclose(_np(tmem), np.asarray(jmem), **F32)
    jlog, _ = jed.decode(jp, ja.cfg, tokens, jmem)
    tlog, cache = ted.decode(tp, ta.cfg, _t(tokens), tmem)
    assert cache is None and tlog.dtype == torch.float32
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **F32)
    np.testing.assert_allclose(
        _np(ted.encdec_apply(tp, ta.cfg, _t(frames), _t(tokens))),
        np.asarray(jed.encdec_apply(jp, ja.cfg, frames, tokens)), **F32)
    # decode positions past max_target read the table's last row
    far = np.arange(60, 69, dtype=np.int32)
    np.testing.assert_allclose(
        _np(ted.decode(tp, ta.cfg, _t(tokens), tmem, positions=_t(far))[0]),
        np.asarray(jed.decode(jp, ja.cfg, tokens, jmem,
                              positions=jnp.asarray(far))[0]), **F32)


def test_precompute_cross_kv_matches_jax(pair):
    ja, jp, ta, tp = pair
    frames, _ = _inputs(ja.cfg, seed=2)
    jmem = jed.encode(jp, ja.cfg, frames)
    jk, jv = jed.precompute_cross_kv(jp, ja.cfg, jmem)
    tk, tv = ted.precompute_cross_kv(tp, ta.cfg, _t(np.asarray(jmem)))
    assert tuple(tk.shape) == (2, 2, 16, 4, 32)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **F32)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **F32)


def test_loss_and_grads_match_jax(pair):
    ja, jp, ta, tp = pair
    frames, tokens = _inputs(ja.cfg, seed=3, S=12)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -3:] = -100
    jb = {"frames": frames, "tokens": tokens, "labels": labels}
    (jloss, _), jg = jax.value_and_grad(ja.loss_fn, has_aux=True)(jp, jb)
    loss, aux, tg = loss_and_grads(ta.loss_fn, tp,
                                   {k: _t(v) for k, v in jb.items()}, None)
    assert aux == {}
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    jflat = dict(zip(jax.tree.leaves(jpaths(jg)), jax.tree.leaves(jg)))
    items = tree_items(tg)
    assert len(items) == 46 == len(jflat)
    for path, g in items:
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]),
                                   err_msg=path, **F32)


def test_layers_remat_only_under_autograd(pair, monkeypatch):
    """Each encoder layer, and each decoder layer without a cache, is
    recomputed in the backward pass; nothing is where autograd records
    nothing, and a cached decode never is."""
    ja, _, ta, tp = pair
    calls = []
    real = ted.checkpoint
    monkeypatch.setattr(ted, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    frames, tokens = map(_t, _inputs(ja.cfg, seed=4))
    with torch.no_grad():
        ted.encdec_apply(tp, ta.cfg, frames, tokens)
    assert calls == []
    with torch.enable_grad():
        ted.encdec_apply(tp, ta.cfg, frames, tokens)
        assert len(calls) == 2 * ta.cfg.n_layers
        memory = ted.encode(tp, ta.cfg, frames)
        calls.clear()
        cache = ted.init_encdec_cache(ta.cfg, 2, 16)
        ted.decode(tp, ta.cfg, tokens, memory.detach(), caches=cache)
    assert calls == []


def test_single_stream_decode_matches_jax(pair):
    """The scalar-cursor path: a prefill as long as the cache (the
    roll branch), then a prefill shorter than it and one-token steps,
    fp32 caches on both sides: logits at 1e-5, caches and cursors equal
    in layout; then Arch.prefill(per_slot=False) + decode_step with the
    memory operand (bf16 caches, as in JAX)."""
    ja, jp, ta, tp = pair
    frames, tokens = _inputs(ja.cfg, seed=5, S=8)
    jmem = jed.encode(jp, ja.cfg, frames)
    tmem = _t(np.asarray(jmem))
    for cache_len, split in ((8, 8), (12, 5)):
        jc = jed.init_encdec_cache(ja.cfg, 2, cache_len, dtype=jnp.float32)
        tc = ted.init_encdec_cache(ta.cfg, 2, cache_len,
                                   dtype=torch.float32)
        assert tc["index"].ndim == 0 and tc["self"]["pos"].shape == (
            2, cache_len)
        for lo, hi in ((0, split), (split, split + 1), (split + 1, 8)):
            if not lo < hi <= 8:
                continue
            jl, jc = jed.decode(jp, ja.cfg, tokens[:, lo:hi], jmem,
                                caches=jc)
            with torch.no_grad():
                tl, tc = ted.decode(tp, ta.cfg, _t(tokens[:, lo:hi]), tmem,
                                    caches=tc)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
            assert int(tc["index"]) == int(jc["index"]) == hi
        for n in ("k", "v", "pos"):
            np.testing.assert_allclose(_np(tc["self"][n]),
                                       np.asarray(jc["self"][n], np.float32),
                                       **F32)
    jl, jc = ja.prefill(jp, {"tokens": tokens[:, :6], "frames": frames},
                        cache_len=10)
    with torch.no_grad():
        tl, tc = ta.prefill(tp, {"tokens": _t(tokens[:, :6]),
                                 "frames": _t(frames)},
                            cache_len=10, per_slot=False)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jl, _ = ja.decode_step(jp, {"tokens": tokens[:, 6:7],
                                    "memory": jmem}, jc)
        tl, tc = ta.decode_step(tp, {"tokens": _t(tokens[:, 6:7]),
                                     "memory": tmem}, tc)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)
    assert int(tc["index"]) == 7


def test_serving_prefill_and_decode_match_jax(pair):
    """prefill_serve on left-padded prompts and two decode_serve steps
    on the dense cross form: logits, the self cache (k, v, positions),
    the cross K/V and cursors against the JAX package at 1e-5; and
    through Arch.prefill / Arch.decode_step."""
    ja, jp, ta, tp = pair
    frames, tokens = _inputs(ja.cfg, seed=6, S=9)
    pos = _left_padded(9, [3, 0])
    jl, jc = ja.prefill(jp, {"tokens": tokens, "frames": frames},
                        cache_len=24, per_slot=True, positions=pos)
    with torch.no_grad():
        tl, tc = ta.prefill(tp, {"tokens": _t(tokens), "frames": _t(frames)},
                            cache_len=24, positions=_t(pos))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
    assert tl.shape == (2, 1, ja.cfg.vocab)
    for step, (toks, p) in enumerate((([[7], [8]], [[6], [9]]),
                                      ([[3], [4]], [[7], [10]]))):
        for n in ("k", "v", "pos"):
            np.testing.assert_allclose(
                _np(tc["slots"]["self"][n]),
                np.asarray(jc["slots"]["self"][n], np.float32), **F32)
        for n in ("k", "v", "pos"):
            np.testing.assert_allclose(_np(tc["cross"][n]),
                                       np.asarray(jc["cross"][n],
                                                  np.float32), **F32)
        np.testing.assert_array_equal(tc["index"].numpy(),
                                      np.asarray(jc["index"]))
        toks, p = np.asarray(toks, np.int32), np.asarray(p, np.int32)
        jl, jc = ja.decode_step(jp, {"tokens": toks, "positions": p}, jc)
        with torch.no_grad():
            tl, tc = ta.decode_step(tp, {"tokens": _t(toks),
                                         "positions": _t(p)}, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)


def test_left_padded_rows_equal_unpadded(pair):
    """A left-padded serving row's logits and valid cache rows equal the
    same prompt prefilled alone without padding (pads are masked as
    keys and never enter a position)."""
    _, _, ta, tp = pair
    frames, tokens = _inputs(ta.cfg, seed=7, S=9)
    pos = _left_padded(9, [4, 0])
    with torch.no_grad():
        padded, pc = ted.prefill_serve(tp, ta.cfg, _t(tokens), _t(pos),
                                       _t(frames), 16)
        alone, ac = ted.prefill_serve(tp, ta.cfg, _t(tokens[:1, 4:]), None,
                                      _t(frames[:1]), 16)
    np.testing.assert_allclose(_np(padded[:1]), _np(alone), **F32)
    self_p, self_a = pc["slots"]["self"], ac["slots"]["self"]
    np.testing.assert_allclose(_np(self_p["k"][:, 0, 4:9]),
                               _np(self_a["k"][:, 0, :5]), **F32)
    assert (self_p["pos"][:, 0, :4] < 0).all()


# ---------------------------------------------------------------------------
# training: data, fused LANS, CLI
# ---------------------------------------------------------------------------

def test_training_stream_matches_jax():
    """The CLI's encdec batches (frames from the seeded numpy generator,
    tokens and labels from the LM iterator) equal the JAX launcher's."""
    ta, ja = tconfigs.reduced_arch(ARCH), jreduced(ARCH)
    t_it = ttrain.make_data(ta, batch=2, seq=16, seed=3)
    j_it = jmake_data(ja, batch=2, seq=16, seed=3)
    for _ in range(2):
        tb, jb = next(t_it), next(j_it)
        assert sorted(tb) == sorted(jb) == ["frames", "labels", "tokens"]
        for k in tb:
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))


def test_fused_lans_step1_matches_unfused(pair):
    """One shared set of step-1 gradients of reduced whisper applied by
    lans and by fused_lans (K1-K3's plain versions on the CPU): params
    and moments leaf by leaf within 2e-5, over all 46 leaves."""
    _, _, ta, tp = pair
    frames, tokens = _inputs(ta.cfg, seed=8, S=12)
    batch = {"frames": _t(frames), "tokens": _t(tokens),
             "labels": _t(np.roll(tokens, -1, axis=1))}
    _, _, grads = loss_and_grads(ta.loss_fn, tp, batch, None)
    outs = []
    for tx in (lans(constant(2e-3)), fused_lans(constant(2e-3))):
        with torch.no_grad():
            upd, st = tx.update(grads, tx.init(tp), tp)
        if not hasattr(st, "mu"):
            st = next(s for s in st if hasattr(s, "mu"))
        outs.append({"params": apply_updates(tp, upd), "mu": st.mu,
                     "nu": st.nu})
    for name in outs[0]:
        a, b = tree_items(outs[0][name]), tree_items(outs[1][name])
        assert len(a) == 46
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-5,
                                       atol=2e-5, err_msg=f"{name} {path}")


def test_cli_trains_whisper_on_cpu():
    with contextlib.redirect_stdout(io.StringIO()):
        summary = ttrain.main(["--device", "cpu", "--arch", ARCH,
                               "--steps", "2", "--batch", "2", "--seq",
                               "16"])
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
