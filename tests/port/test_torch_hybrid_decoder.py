"""The MoE, Mamba-2 and hybrid decoders on the port, against the JAX
package, from params carried over by repro_torch.bridge: reduced
granite-moe-3b-a800m, mamba2-130m, jamba-1.5-large-398b and grok-1-314b.

  * decoder_apply logits within 1e-4 (whole models: two layers, or
    jamba's one period of eight, plus a 1024-wide head), with and
    without left padding, and the MoE aux terms;
  * Arch.loss_fn's loss and every gradient within 1e-4 (granite at
    capacity 1.25, so that pairs are dropped; mamba2; jamba), moe_aux
    weighted 0.01 as in JAX;
  * prefill then decode through the pooled and the paged caches equal
    the full forward (the Mamba state slot-resident beside the arenas);
  * the bridge's shape check and the configs' numbers;
  * the training CLI on the CPU.

fp32 compute on both sides.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs import reduced_arch as jreduced
from repro.launch.train import make_data as jmake_data
from repro.models import decoder as jdec
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.optim.base import tree_items
from repro_torch.distributed.steps import loss_and_grads
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder as tdec

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-moe-3b-a800m", "mamba2-130m", "jamba-1.5-large-398b",
         "grok-1-314b"]


@functools.lru_cache(maxsize=None)
def _pair(name, **over):
    """(JAX arch, JAX params, port arch, port params), reduced, fp32
    compute, cfg fields `over` on both sides."""
    ja, ta = jreduced(name), tconfigs.reduced_arch(name)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(
        ja.cfg, compute_dtype=jnp.float32, **over))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(
        ta.cfg, compute_dtype=torch.float32, **over))
    jp = jax.jit(ja.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(ta.cfg, jax.tree.map(np.asarray, jp))
    return ja, jp, ta, tp


def test_configs_equal_the_jax_configs():
    """Full and reduced configs field for field (dtype fields by name),
    and the same citation."""
    for name in ARCHS:
        for jarch, tarch in ((jget(name), tconfigs.get_arch(name)),
                             (jreduced(name), tconfigs.reduced_arch(name))):
            jc, tc = dataclasses.asdict(jarch.cfg), dataclasses.asdict(
                tarch.cfg)
            for k, v in tc.items():
                if k in ("compute_dtype", "param_dtype"):
                    assert str(v).split(".")[-1] == jnp.dtype(jc[k]).name
                elif k != "attn_kernel":
                    assert v == jc[k], (name, k)
            assert tarch.source == jarch.source
    assert tconfigs.NOT_PORTED == ()


@pytest.mark.parametrize("name", ARCHS)
def test_bridge_checks_the_new_trees(name):
    """The JAX init's tree goes through the bridge's shape check for
    every arch (router, (E, din, dout) stacks, A_log, conv_w, ...), and
    a wrong expert count is refused."""
    ja, jp, ta, tp = _pair(name)
    assert {p for p, _ in tree_items(tp)} == {
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    if ta.cfg.n_experts:
        bad = dataclasses.replace(ta.cfg, n_experts=ta.cfg.n_experts + 1)
        with pytest.raises(ValueError, match="shape mismatch"):
            params_from_jax(bad, jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_decoder_logits_match_jax(name, pads):
    ja, jp, ta, tp = _pair(name)
    S = 32
    tokens = np.random.default_rng(3).integers(
        0, ja.cfg.vocab, size=(2, S)).astype(np.int32)
    positions = None
    if pads:    # row 0 left-padded by 16 (a whole mamba chunk and more)
        positions = np.tile(np.arange(S, dtype=np.int32), (2, 1))
        positions[0] -= 16
    want, _, jaux = jdec.decoder_apply(jp, ja.cfg, tokens,
                                       positions=positions)
    got, _, taux = tdec.decoder_apply(
        tp, ta.cfg, torch.from_numpy(tokens),
        positions=None if positions is None else torch.from_numpy(positions))
    if pads:
        want, got = np.asarray(want)[:, 16:], got[:, 16:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("moe_aux_loss", "router_entropy"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)
    assert (float(taux["moe_aux_loss"]) > 0) == bool(ta.cfg.n_experts)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_loss_and_grads_match_jax(name):
    """Arch.loss_fn (lm_loss + 0.01 moe_aux) and every gradient; granite
    and jamba route at capacity 1.25, which drops pairs at this batch."""
    ja, jp, ta, tp = _pair(name)
    assert ta.cfg.capacity_factor == 1.25
    it = jmake_data(ja, batch=2, seq=32, seed=0)
    b = next(it)
    (want, jaux), jg = jax.value_and_grad(ja.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, aux, grads = loss_and_grads(
        ta.loss_fn, tp, {k: torch.from_numpy(v) for k, v in b.items()},
        None)
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    np.testing.assert_allclose(float(aux["router_entropy"]),
                               float(jaux["router_entropy"]), **TOL)
    jleaves = jax.tree.leaves(jg)
    titems = tree_items(grads)
    assert len(titems) == len(jleaves)
    for (path, g), j in zip(titems, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path,
                                   **TOL)


def test_granite_drops_at_capacity_1_25():
    """The loss test's batch really drops (token, k) pairs at 1.25: the
    same forward at the dropless capacity gives other logits."""
    _, _, ta, tp = _pair("granite-moe-3b-a800m")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, ta.cfg.vocab, size=(2, 32)).astype(np.int32))
    a, _, _ = tdec.decoder_apply(tp, ta.cfg, tokens)
    dropless = dataclasses.replace(ta.cfg, capacity_factor=4.0)
    b, _, _ = tdec.decoder_apply(tp, dropless, tokens)
    assert not torch.allclose(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_prefill_then_decode_equals_full_forward(name, paged):
    """Prefill 16 tokens, then decode 16 one at a time (the recurrent
    Mamba step, MoE over one token per slot): every logit equals the
    full forward's (dropless routing, as serving runs). Paged: the
    attention slots on block arenas (fp32), the Mamba state beside them,
    slot-resident; mamba2 has no arena at all."""
    ja, jp, ta, tp = _pair(name, capacity_factor=4.0)
    cfg = ta.cfg
    T, P = 32, 16
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, T)).astype(np.int32))
    full, _, _ = tdec.decoder_apply(tp, cfg, tokens)
    if paged:
        cache = tdec.init_paged_decoder_cache(cfg, 2, 32, block_size=8,
                                              n_blocks=8,
                                              dtype=torch.float32)
        assert all((t is None) == (m == "mamba")
                   for t, (m, _) in zip(cache["tables"], cfg.superblock))
        cache["tables"] = tuple(
            None if t is None else
            (1 + torch.arange(2 * t.shape[1], dtype=torch.int32)).reshape(
                2, -1) for t in cache["tables"])
    else:
        cache = tdec.init_decoder_cache(cfg, 2, 32, torch.float32)
    logits, cache, _ = tdec.decoder_apply(
        tp, cfg, tokens[:, :P], caches=cache,
        positions=torch.arange(P, dtype=torch.int32).expand(2, P))
    np.testing.assert_allclose(logits.numpy(), full[:, :P].numpy(), **TOL)
    for t in range(P, T):
        logits, cache, _ = tdec.decoder_apply(
            tp, cfg, tokens[:, t:t + 1], caches=cache,
            positions=torch.full((2, 1), t, dtype=torch.int32))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   err_msg=f"t={t}", **TOL)
    assert cache["index"].tolist() == [T, T]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-130m"])
def test_cli_trains_on_cpu(name):
    out = ttrain.main(["--device", "cpu", "--arch", name, "--steps", "2",
                       "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
