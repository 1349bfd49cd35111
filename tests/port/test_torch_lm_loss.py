"""The port's causal-LM losses against the JAX package's
(repro/models/decoder.py): lm_loss on given logits, and chunked_lm_loss
through a tied or untied head with and without a final softcap, over
chunks of 4 and 8 of a 16-position sequence with ignored labels: the
loss and its gradients with respect to the hidden states and to the
readout (embedding or lm_head). The same numpy inputs from a seed go to
both sides.

Tolerance: 1e-5 (rtol and atol), fp32 on both sides, summed in another
order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decoder as jdec
from repro_torch.models import decoder as tdec

F32 = dict(rtol=1e-5, atol=1e-5)
B, S, D, V = 2, 16, 24, 96


def _cfgs(tie, final_softcap):
    kw = dict(name="lm", n_layers=2, d_model=D, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab=V, tie_embeddings=tie,
              final_softcap=final_softcap)
    return (jdec.DecoderConfig(**kw, compute_dtype=jnp.float32),
            tdec.DecoderConfig(**kw, compute_dtype=torch.float32))


def _inputs(seed, tie):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100                  # ignored rows
    labels[1, -5:] = -100
    head = ({"embed": {"embedding": (rng.normal(size=(V, D)) * 0.3
                                     ).astype(np.float32)}} if tie else
            {"lm_head": {"kernel": (rng.normal(size=(D, V)) * 0.3
                                    ).astype(np.float32)}})
    return hidden, labels, head


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else
            torch.from_numpy(v).requires_grad_(True) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("final_softcap", [None, 30.0])
@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_lm_loss_and_grads_match_jax(chunk, tie, final_softcap):
    jcfg, tcfg = _cfgs(tie, final_softcap)
    hidden, labels, head = _inputs(chunk + 2 * tie, tie)

    def jloss(h, p):
        return jdec.chunked_lm_loss(p, jcfg, h, jnp.asarray(labels),
                                    chunk=chunk)

    want, (jgh, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jax.tree.map(jnp.asarray, head))
    th, tp = torch.from_numpy(hidden).requires_grad_(True), _t(head)
    got = tdec.chunked_lm_loss(tp, tcfg, th, torch.from_numpy(labels),
                               chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), **F32)
    for (path, t), (_, j) in zip(_leaves(tp), _leaves(jgp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=path, **F32)
    # the same number as lm_loss over the whole head's logits
    with torch.no_grad():
        full = tdec.lm_loss(tdec._head_logits(tp, tcfg, th),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(full), float(got.detach()), **F32)


@pytest.mark.parametrize("moe_aux", [None, 0.7])
def test_lm_loss_and_grads_match_jax(moe_aux):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(B, S, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    labels[:, ::3] = -100
    aux = None if moe_aux is None else np.float32(moe_aux)

    def jloss(x):
        return jdec.lm_loss(x, jnp.asarray(labels),
                            moe_aux=None if aux is None else jnp.asarray(aux))

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tx = torch.from_numpy(logits).requires_grad_(True)
    got = tdec.lm_loss(tx, torch.from_numpy(labels),
                       moe_aux=None if aux is None else torch.tensor(aux))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **F32)


def test_all_labels_ignored_gives_zero_loss():
    """count is clamped to 1: a batch with no valid label has loss 0 on
    both sides, and no NaN in its gradients."""
    jcfg, tcfg = _cfgs(True, None)
    hidden, labels, head = _inputs(0, True)
    labels[:] = -100
    want = jdec.chunked_lm_loss(jax.tree.map(jnp.asarray, head), jcfg,
                                jnp.asarray(hidden), jnp.asarray(labels),
                                chunk=8)
    th, tp = torch.from_numpy(hidden).requires_grad_(True), _t(head)
    got = tdec.chunked_lm_loss(tp, tcfg, th, torch.from_numpy(labels),
                               chunk=8)
    got.backward()
    assert float(got.detach()) == float(want) == 0.0
    assert torch.isfinite(th.grad).all() and (th.grad == 0).all()


def test_chunk_must_divide_the_sequence():
    _, tcfg = _cfgs(True, None)
    hidden, labels, head = _inputs(0, True)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tdec.chunked_lm_loss(_t(head), tcfg, torch.from_numpy(hidden),
                             torch.from_numpy(labels), chunk=5)


def test_chunked_lm_loss_keeps_only_a_chunk_of_logits():
    """The forward of chunked_lm_loss under grad keeps no (B, S, V)
    tensor for the backward pass: every saved tensor is smaller than a
    chunk's logits would be twice over (each chunk's logits are
    recomputed), while lm_loss on the full logits keeps the whole
    (B, S, V) log-softmax."""
    _, tcfg = _cfgs(False, 30.0)
    hidden, labels, head = _inputs(3, False)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    th, tp = torch.from_numpy(hidden).requires_grad_(True), _t(head)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tdec.chunked_lm_loss(tp, tcfg, th, torch.from_numpy(labels),
                             chunk=4)
    assert max(sizes) < B * S * V
    sizes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tdec.lm_loss(tdec._head_logits(tp, tcfg, th),
                     torch.from_numpy(labels))
    assert max(sizes) >= B * S * V


def test_dataclass_fields_match_jax():
    """The port's DecoderConfig has the JAX package's training fields with
    the same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(jdec.DecoderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tdec.DecoderConfig)}
    for name in ("qk_norm", "tie_embeddings", "remat", "max_seq",
                 "final_softcap", "scale_embeds"):
        assert tf[name] == jf[name], name
