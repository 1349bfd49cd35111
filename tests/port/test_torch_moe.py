"""The port's MoE ffn (models/moe.py) against the JAX package's on the
same inputs, fp32: outputs and aux terms within 1e-5, dropless,
capacity 1.25 with drops, a `valid` mask with pads, both expert-compute
routes (the dense (E, cap) buffer and the per-expert gathered rows), and
the router's top-k tie order. Mirrors tests/test_models.py:103,114. The
route's capacity positions are also held, equal, against the token-dim
cumsum they replaced."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)


def _params(rng, cfg):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": {"kernel": rng.normal(size=(d, e)).astype(np.float32)},
         "up": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
         "down": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)}
    if cfg.gated:
        p["gate"] = (rng.normal(size=(e, d, f))
                     / np.sqrt(d)).astype(np.float32)
    return p


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


CASES = {
    # serving's dropless policy: capacity_factor = n_experts
    "dropless": dict(n_experts=8, top_k=2, capacity_factor=8.0, S=16),
    # training's 1.25: some (token, k) pairs overflow their expert
    "capacity_1.25_drops": dict(n_experts=8, top_k=2, capacity_factor=1.25,
                                S=16),
    "capacity_0.25_top1": dict(n_experts=4, top_k=1, capacity_factor=0.25,
                               S=32),
    "left_pads": dict(n_experts=8, top_k=2, capacity_factor=1.25, S=16,
                      pads=(5, 0)),
    "ungated_gelu": dict(n_experts=4, top_k=2, capacity_factor=1.25, S=8,
                         gated=False, activation="gelu"),
}


@pytest.mark.parametrize("route", ["dense", "gathered"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, route, monkeypatch):
    c = dict(CASES[case])
    S, pads = c.pop("S"), c.pop("pads", None)
    cfg_kw = dict(d_model=16, d_ff=32, **c)
    jcfg, tcfg = jmoe.MoeConfig(**cfg_kw), tmoe.MoeConfig(**cfg_kw)
    rng = np.random.default_rng(len(case))
    p = _params(rng, jcfg)
    x = rng.normal(size=(2, S, 16)).astype(np.float32)
    valid = None
    if pads is not None:
        valid = np.ones((2, S), bool)
        for b, n in enumerate(pads):
            valid[b, :n] = False
    # the route is the port's choice of expert compute, not the function
    monkeypatch.setattr(tmoe, "DENSE_ROWS", 1 << 30 if route == "dense"
                        else 0)
    want, jaux = jmoe.moe_apply(p, jcfg, x, valid=valid,
                                compute_dtype=jnp.float32)
    got, taux = tmoe.moe_apply(
        _tree_t(p), tcfg, torch.from_numpy(x),
        valid=None if valid is None else torch.from_numpy(valid),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for k in ("moe_aux_loss", "router_entropy"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **F32)
    if pads is not None:
        # pads produce exactly 0 and take no capacity
        assert not got[0, :pads[0]].any()


def test_capacity_drops_really_drop():
    """At capacity 1.25 the 1.25 case drops pairs: its output differs
    from the dropless one's (so the drop path is what the parity test
    held)."""
    rng = np.random.default_rng(3)
    kw = dict(d_model=16, d_ff=32, n_experts=8, top_k=2)
    p = _tree_t(_params(rng, tmoe.MoeConfig(**kw)))
    x = torch.from_numpy(rng.normal(size=(2, 16, 16)).astype(np.float32))
    outs = [tmoe.moe_apply(p, tmoe.MoeConfig(capacity_factor=cf, **kw), x,
                           compute_dtype=torch.float32)[0]
            for cf in (1.25, 8.0)]
    assert not torch.allclose(outs[0], outs[1])


def test_top_k_ties_go_to_the_lower_index_like_lax():
    """Equal router probabilities: both packages pick the lowest expert
    indices, in ascending order."""
    import jax
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    jv, ji = jax.lax.top_k(probs, 2)
    tv, ti = tmoe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2], [0, 1]])


@pytest.mark.parametrize("route", ["dense", "gathered"])
def test_moe_grads_match_jax(route, monkeypatch):
    """Gradients through routing with drops (capacity 1.25), w.r.t. the
    input and every weight, within 1e-5, on both expert-compute routes
    (the gathered one is what training at real batch sizes takes)."""
    import jax
    monkeypatch.setattr(tmoe, "DENSE_ROWS", 1 << 30 if route == "dense"
                        else 0)
    cfg_kw = dict(d_model=16, d_ff=32, n_experts=8, top_k=2,
                  capacity_factor=1.25)
    jcfg, tcfg = jmoe.MoeConfig(**cfg_kw), tmoe.MoeConfig(**cfg_kw)
    rng = np.random.default_rng(7)
    p = _params(rng, jcfg)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, jcfg, x, compute_dtype=jnp.float32)
        return jnp.sum(out * out) + aux["moe_aux_loss"]

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = {k: (v.requires_grad_() if torch.is_tensor(v) else
              {kk: vv.requires_grad_() for kk, vv in v.items()})
          for k, v in _tree_t(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_apply(tp, tcfg, tx, compute_dtype=torch.float32)
    (torch.sum(out * out) + aux["moe_aux_loss"]).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **F32)
    for k in ("up", "down", "gate"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg_p[k]),
                                   **F32)
    np.testing.assert_allclose(tp["router"]["kernel"].grad.numpy(),
                               np.asarray(jg_p["router"]["kernel"]), **F32)


def _cumsum_route(idx_k, E, cap, valid=None):
    """The oracle: the route's positions as the port first took them, a
    cumsum along the token dim of a token-major (G, Tl * K, E) one-hot."""
    G, Tl, K = idx_k.shape
    sel = (idx_k[..., None] == torch.arange(E)).to(torch.int64)
    if valid is not None:
        sel = sel * valid[..., None, None].to(sel.dtype)
    position = torch.cumsum(sel.reshape(G, Tl * K, E), dim=1) - 1
    flat_e = idx_k.reshape(G, Tl * K)
    pos_k = torch.gather(position, -1, flat_e[..., None])[..., 0]
    keep = pos_k < cap
    if valid is not None:
        keep = keep & valid.repeat_interleave(K, dim=1)
    density = (sel.sum(dim=2) > 0).float().mean(dim=(0, 1))
    return flat_e, pos_k, keep, density


def route_case(G, Tl, K, E, pads, seed=0):
    """(idx_k, valid, cap) of a routing case: each token's K distinct
    experts, skewed toward the low indices so that capacity 1.25 drops
    pairs; `pads` left pads on every group, or no `valid` mask."""
    gen = torch.Generator().manual_seed(seed)
    scores = torch.rand((G, Tl, E), generator=gen) + torch.linspace(1, 0, E)
    idx_k = tmoe._top_k(scores, K)[1]
    valid = None
    if pads:
        valid = torch.ones((G, Tl), dtype=torch.bool)
        valid[:, :pads] = False
    return idx_k, valid, max(1, int(1.25 * Tl * K / E))


ROUTE_CASES = [(G, 64, K, E, pads) for G in (1, 2, 4) for K in (1, 2, 8)
               for E in (4, 8, 40) if K <= E for pads in (0, 5)]
# granite-moe-3b-a800m's cell: 16,384 tokens, top 8 of 40, one group
ROUTE_CASES += [(1, 16384, 8, 40, 0), (1, 16384, 8, 40, 1000)]


@pytest.mark.parametrize("G,Tl,K,E,pads", ROUTE_CASES)
def test_capacity_route_equals_the_token_dim_cumsum(G, Tl, K, E, pads):
    """_capacity_route's expert-major flat scan gives every pair its
    expert and keep flag, every pair of a real token its position, and
    every expert its density, as the token-dim cumsum does: equal."""
    idx_k, valid, cap = route_case(G, Tl, K, E, pads)
    want = _cumsum_route(idx_k, E, cap, valid)
    got = tmoe._capacity_route(idx_k, E, cap, valid)
    for name, w, g in zip(("flat_e", "pos_k", "keep", "density"), want, got):
        if name == "pos_k" and valid is not None:
            # a pad's position is not used: it is never kept
            w, g = (x[valid.repeat_interleave(K, dim=1)] for x in (w, g))
        assert w.dtype == g.dtype and torch.equal(w, g), name
    if K < E:
        # the skew fills experts past their capacity: routed pairs drop
        pads_k = (torch.zeros_like(want[2]) if valid is None
                  else ~valid.repeat_interleave(K, dim=1))
        assert not (want[2] | pads_k).all()
