"""The port's BERT against the JAX package on the same inputs: LayerNorm,
the bidirectional cache-free attention path, reduced bert-large's loss
and every gradient from bridged params, the configs and the bridge.

Tolerances: 1e-5 (rtol and atol) for single functions and the fp32 loss;
gradients to 1e-5 absolute (two layers and a tied 512-wide readout sum in
another order on each side). With the default bf16 compute the loss
agrees to 1e-2 relative (bf16 matmuls round at other places in the two
frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced_arch as jreduced
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro.data.corpus import mlm_batch_iterator as jmlm
from repro.data.sharding import ShardSpec as JShard
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.optim.base import tree_items
from repro_torch.distributed.steps import loss_and_grads
from repro_torch.models import attention as tattn
from repro_torch.models import bert as tbert
from repro_torch.models import common as tcommon

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


@pytest.fixture(scope="module")
def bert_pair():
    """(JAX arch, JAX params, port arch, port params) for reduced
    bert-large with fp32 compute on both sides and the JAX init carried
    over by the bridge; plus one MLM/NSP batch."""
    ja = jreduced("bert-large")
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32))
    ta = tconfigs.reduced_arch("bert-large")
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=torch.float32))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    corpus = JCorpus(vocab=ja.cfg.vocab, num_docs=64, doc_len=256, seed=0)
    batch = next(jmlm(corpus, JShard(64, 1, 0, 0), per_worker_batch=4,
                      seq_len=64, seed=0))
    return ja, jp, ta, tp, batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(16,)).astype(np.float32),
         "bias": rng.normal(size=(16,)).astype(np.float32)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcommon.layernorm_apply(p, jnp.asarray(x, jdt))
    got = tcommon.layernorm_apply(_tree_t(p), _t(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == torch.float32
                                  else dict(rtol=1e-2, atol=1e-2)))
    init = tcommon.layernorm_init(16, lead=(3,))
    assert init["scale"].shape == (3, 16) and (init["scale"] == 1).all()
    assert (init["bias"] == 0).all()


@pytest.mark.parametrize("query_scale", [None, 0.3])
def test_bidirectional_attention_matches_jax(query_scale):
    """BERT's attention: no RoPE, no causal mask, qkv biases."""
    rng = np.random.default_rng(1)
    d, h, hd = 32, 4, 8
    kw = dict(d_model=d, n_heads=h, n_kv_heads=h, head_dim=hd, qkv_bias=True,
              rope=False, causal=False, query_scale=query_scale)
    dense = lambda i, o, b: {
        "kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
        **({"bias": rng.normal(size=(o,)).astype(np.float32)} if b else {})}
    p = {"wq": dense(d, h * hd, True), "wk": dense(d, h * hd, True),
         "wv": dense(d, h * hd, True), "wo": dense(h * hd, d, False)}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    want, _ = jattn.attn_apply(p, jattn.AttnConfig(**kw), x,
                               compute_dtype=jnp.float32)
    got, cache = tattn.attn_apply(_tree_t(p), tattn.AttnConfig(**kw), _t(x),
                                  compute_dtype=torch.float32)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # position 0 attends to later positions: not causal
    causal, _ = tattn.attn_apply(
        _tree_t(p), tattn.AttnConfig(**{**kw, "causal": True}), _t(x),
        compute_dtype=torch.float32)
    assert not torch.allclose(causal[:, 0], got[:, 0])


@pytest.mark.parametrize("per_batch_positions", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_branch_matches_jax(causal, per_batch_positions):
    """The remat-chunked query-block branch (S >= q_chunk_threshold and a
    multiple of q_block: here 16 positions in blocks of 4, GQA, QK-norm
    and RoPE on), causal and bidirectional, with shared or per-batch
    (left-padded, pads at -1) positions: output and the gradients with
    respect to x and every param against the JAX package's branch; and
    the same output as the unchunked path of the port."""
    rng = np.random.default_rng(7 + causal + 2 * per_batch_positions)
    d, h, kv, hd, S = 32, 4, 2, 8, 16
    kw = dict(d_model=d, n_heads=h, n_kv_heads=kv, head_dim=hd,
              qkv_bias=True, qk_norm=True, causal=causal,
              q_chunk_threshold=8, q_block=4)
    dense = lambda i, o, b: {
        "kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
        **({"bias": rng.normal(size=(o,)).astype(np.float32)} if b else {})}
    p = {"wq": dense(d, h * hd, True), "wk": dense(d, kv * hd, True),
         "wv": dense(d, kv * hd, True), "wo": dense(h * hd, d, False),
         "q_norm": {"scale": rng.normal(size=(hd,)).astype(np.float32)},
         "k_norm": {"scale": rng.normal(size=(hd,)).astype(np.float32)}}
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    if per_batch_positions:
        pos = np.stack([pos, pos - 3]).astype(np.int32)
        pos[1, :3] = -1
    w = rng.normal(size=(2, S, d)).astype(np.float32)

    def jf(x, p):
        out, _ = jattn.attn_apply(p, jattn.AttnConfig(**kw), x,
                                  positions=jnp.asarray(pos),
                                  compute_dtype=jnp.float32)
        return jnp.sum(out * w), out

    (_, want), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, p))
    tx = _t(x).requires_grad_(True)
    tp = jax.tree.map(lambda a: _t(a).requires_grad_(True), p)
    got, _ = tattn.attn_apply(tp, tattn.AttnConfig(**kw), tx,
                              positions=_t(pos), compute_dtype=torch.float32)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32)
    for (path, a), b in zip(tree_items(tp), jax.tree.leaves(jgp)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=path, **F32)
    with torch.no_grad():
        whole, _ = tattn.attn_apply(
            tp, tattn.AttnConfig(**{**kw, "q_chunk_threshold": 4096}), tx,
            positions=_t(pos), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), whole.numpy(), **F32)


def test_reduced_bert_loss_and_grads_match_jax(bert_pair):
    ja, jp, ta, tp, batch = bert_pair
    (jl, jaux), jg = jax.value_and_grad(ja.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux, tg = loss_and_grads(ta.loss_fn, tp, {k: _t(v) for k, v in
                                              batch.items()}, None)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    for key in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), **F32)
    from repro.core.optim.base import tree_paths as jpaths
    jflat = dict(zip(jax.tree.leaves(jpaths(jg)), jax.tree.leaves(jg)))
    got = tree_items(tg)
    assert [p for p, _ in got] == sorted(jflat)
    assert len(got) == 29
    for path, g in got:
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]),
                                   rtol=1e-5, atol=1e-5, err_msg=path)


def test_bf16_compute_loss_matches_jax(bert_pair):
    """The configs' default compute dtype (bf16), as the CLI runs it."""
    ja, jp, ta, tp, batch = bert_pair
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.bfloat16))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=torch.bfloat16))
    jl, _ = ja.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = ta.loss_fn(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)


def test_logits_shapes_and_no_grad_path(bert_pair):
    _, _, ta, tp, batch = bert_pair
    with torch.no_grad():
        mlm, nsp = tbert.bert_pretrain_logits(tp, ta.cfg, _t(batch["tokens"]),
                                              _t(batch["token_types"]))
    assert mlm.shape == (4, 64, ta.cfg.vocab) and mlm.dtype == torch.float32
    assert nsp.shape == (4, 2) and torch.isfinite(mlm).all()


def test_configs_match_jax():
    assert dataclasses.asdict(tconfigs.reduced_arch("bert-large").cfg).keys()\
        == dataclasses.asdict(jreduced("bert-large").cfg).keys()
    for t, j in [(tconfigs.get_arch("bert-large"), jget_arch("bert-large")),
                 (tconfigs.reduced_arch("bert-large"),
                  jreduced("bert-large"))]:
        assert (t.name, t.kind, t.source) == (j.name, j.kind, j.source)
        for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab",
                  "max_pos", "type_vocab", "head_dim"):
            assert getattr(t.cfg, f) == getattr(j.cfg, f), f
        assert t.cfg.compute_dtype == torch.bfloat16
    assert "bert-large" not in tconfigs.NOT_PORTED


def test_full_bert_large_shapes_match_jax():
    """Full width and depth, shapes only: the port's init on the meta
    device against the JAX init's abstract evaluation."""
    ja = jget_arch("bert-large")
    jshapes = jax.eval_shape(ja.init, jax.random.PRNGKey(0))
    from repro.core.optim.base import tree_paths as jpaths
    want = dict(zip(jax.tree.leaves(jpaths(jshapes)),
                    [tuple(s.shape) for s in jax.tree.leaves(jshapes)]))
    with torch.device("meta"):
        got = {p: tuple(t.shape) for p, t in tree_items(
            tconfigs.get_arch("bert-large").init(None))}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == 336_201_532


def test_bridge_rejects_a_wrong_tree(bert_pair):
    _, jp, ta, _, _ = bert_pair
    bad = jax.tree.map(np.asarray, jp)
    bad["pooler"]["kernel"] = bad["pooler"]["kernel"][:, :3]
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_jax(ta.cfg, bad)
    del bad["pooler"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(ta.cfg, bad)


def test_bert_paged_serving_is_decoder_only():
    """BERT scores without a cache: asking it for a paged cache raises
    the JAX package's error, in its wording, and so does encdec."""
    for name in ("bert-large", "whisper-large-v3"):
        for arch in (tconfigs.reduced_arch(name), jreduced(name)):
            with pytest.raises(NotImplementedError,
                               match="paged serving is decoder-only"):
                arch.init_paged_cache(2, 16)
