"""The dry run's configuration surface (repro_torch/configs) against the
JAX package's: SHAPES and ASSIGNED; for every arch and every assigned
shape `supports`, `input_specs` and the skip reason; for every arch at
full size `param_count`, `active_params` and `abstract_params` (every
leaf's path, shape and dtype against jax.eval_shape of the JAX init);
and at decode_32k the decode caches, leaf by leaf.

Both sides build shapes only: jax.eval_shape / ShapeDtypeStructs on the
JAX side, meta tensors on the port's. The JAX dry-run module itself is
not imported (it forces 512 host devices on import); its active_params
is `_jax_active_params` below, the same sum over the JAX abstract params.

One departure is pinned (ROADMAP Queue 3): the port's decoders serve
from the pooled (per-slot) cache only, so a decoder's `cache_specs` is
JAX's per_slot=True cache, a (B,) cursor and (B, L) position rows where
JAX's single-stream cache has a 0-d cursor and (L,) rows.
"""
import functools
import math

import jax
import pytest
import torch

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget
from repro_torch.configs import ASSIGNED, SHAPES, all_archs, get_arch
from repro_torch.launch import dryrun

ARCHS = sorted(all_archs())
DECODE = "decode_32k"


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts, tuples and lists (None leaves
    dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {} if tree is None else {prefix.rstrip("/"): tree}


def _dtype(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def _shapes(tree) -> dict:
    return {p: (tuple(v.shape), _dtype(v)) for p, v in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return _shapes(jget(name).abstract_params())


def _jax_active_params(name) -> int:
    """repro/launch/dryrun.py:active_params on the JAX abstract params."""
    arch = jget(name)
    total = arch.param_count()
    cfg = arch.cfg
    if getattr(cfg, "n_experts", 0) and cfg.n_experts > cfg.top_k:
        expert = sum(math.prod(l.shape) for l in
                     jax.tree.leaves(arch.abstract_params())
                     if l.ndim == 4 and l.shape[1] == cfg.n_experts)
        total = total - expert + expert * cfg.top_k // cfg.n_experts
    return total


def test_shapes_and_assigned_equal_jax():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert ASSIGNED == JASSIGNED
    assert ARCHS == sorted([*JASSIGNED, "bert-large"])


@pytest.mark.parametrize("name", ARCHS)
def test_arch_flags_equal_jax(name):
    a, j = get_arch(name), jget(name)
    assert (a.zero3, a.zero1, a.long_context_ok, a.train_microbatches,
            a.embeds_input) == (j.zero3, j.zero1, j.long_context_ok,
                                j.train_microbatches, j.embeds_input)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_supports_and_input_specs_equal_jax(name, shape):
    a, j = get_arch(name), jget(name)
    assert a.supports(shape) == j.supports(shape)
    if not a.supports(shape):
        want = ("long_500k requires sub-quadratic attention"
                if shape == "long_500k"
                else f"{j.kind} has no {JSHAPES[shape].kind} step")
        assert a.skip_reason(shape) == want
        return
    got = a.input_specs(shape)
    assert all(t.device.type == "meta" for t in got.values())
    assert _shapes(got) == _shapes(j.input_specs(shape))


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_equal_jax_at_full_size(name):
    a = get_arch(name)
    params = a.abstract_params()
    assert all(t.device.type == "meta" for t in _flat(params).values())
    assert _shapes(params) == _jax_params(name)
    assert a.param_count() == jget(name).param_count()
    assert dryrun.active_params(a) == _jax_active_params(name)


DECODERS = [n for n in ARCHS if jget(n).kind == "decoder"]
CACHED = [n for n in ARCHS if jget(n).kind in ("decoder", "encdec")]


@pytest.mark.parametrize("name", CACHED)
def test_cache_specs_equal_jax(name):
    a, j = get_arch(name), jget(name)
    got = _shapes(a.cache_specs(DECODE))
    if j.kind == "encdec":
        assert got == _shapes(j.cache_specs(DECODE))
        return
    # decoders: the pooled cache (the departure the module docstring
    # names), equal to JAX's per-slot cache leaf by leaf
    s = JSHAPES[DECODE]
    pooled = jax.eval_shape(lambda: j.init_cache(s.global_batch, s.seq_len,
                                                 per_slot=True))
    assert got == _shapes(pooled)
    single = _shapes(j.cache_specs(DECODE))
    differ = {p for p in got if got[p] != single.get(p)}
    assert differ and all(p == "index" or p.endswith("/pos")
                          for p in differ), differ
    assert set(got) == set(single)


@pytest.mark.parametrize("name", DECODERS)
def test_paged_cache_specs_equal_jax(name):
    got = get_arch(name).paged_cache_specs(DECODE)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shapes(got) == _shapes(jget(name).paged_cache_specs(DECODE))


def test_reduced_arch_clears_zero3():
    from repro.configs import reduced_arch as jreduced
    from repro_torch.configs import reduced_arch
    for name in ("grok-1-314b", "jamba-1.5-large-398b"):
        assert get_arch(name).zero3
        assert not reduced_arch(name).zero3
        assert not jreduced(name).zero3
    assert reduced_arch("qwen2.5-32b").zero1 == jreduced("qwen2.5-32b").zero1
