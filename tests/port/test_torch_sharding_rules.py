"""The port's partition-spec rules (repro_torch.distributed.sharding)
against the JAX package's, spec by spec, and the mesh builders.

The rules are pure functions of paths, shapes and axis sizes, so both
sides run on shape-only meshes (16 x 16, and 2 x 16 x 16 with pod) and
on shapes only: jax.eval_shape on the JAX side, tensors on the meta
device on the port's. Every case of tests/test_sharding_rules.py is
here against both packages, then every leaf of every arch in configs/
(reduced and full, with and without zero3), the optimizer states (chain,
ZeRO-1, mixed precision, fused), batches and serving caches, and the
DTensor placements the specs become.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jget
from repro.configs import reduced_arch as jreduced
from repro.core.optim import adamw as jadamw
from repro.core.optim import lamb as jlamb
from repro.core.optim import lans as jlans
from repro.core.optim.fused import fused_lans as jfused_lans
from repro.distributed import sharding as jshd
from repro.precision import get_policy as jpolicy
from repro.precision import mixed_precision as jmixed
from repro.precision.fused import fused_mixed_lans as jfused_mixed
from repro_torch.configs import get_arch as tget
from repro_torch.configs import reduced_arch as treduced
from repro_torch.core.optim import adamw as tadamw
from repro_torch.core.optim import fused_lans as tfused_lans
from repro_torch.core.optim import lamb as tlamb
from repro_torch.core.optim import lans as tlans
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.sharding import PSpec
from repro_torch.precision import fused_mixed_lans as tfused_mixed
from repro_torch.precision import get_policy as tpolicy
from repro_torch.precision import mixed_precision as tmixed


class FakeMesh:
    """Shape-only stand-in (both packages' rules read `shape`)."""
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


class FakeDeviceMesh:
    """What `placements` reads of a DeviceMesh: its dim names."""
    def __init__(self, *names):
        self.mesh_dim_names = names


MESH = FakeMesh(data=16, model=16)
POD_MESH = FakeMesh(pod=2, data=16, model=16)
ARCHS = ("grok-1-314b", "granite-moe-3b-a800m", "qwen2.5-14b",
         "qwen2.5-32b", "chameleon-34b", "whisper-large-v3",
         "mistral-nemo-12b", "jamba-1.5-large-398b", "mamba2-130m",
         "gemma2-2b", "bert-large")


def both(fn_name, *args, **kw):
    """(JAX spec, port spec) of one rule on the same arguments."""
    j = getattr(jshd, fn_name)(*args, **kw)
    t = getattr(tshd, fn_name)(*args, **kw)
    assert tuple(j) == tuple(t), (fn_name, args, j, t)
    return j, t


# --------------------------------------------------------------------------
# the cases of tests/test_sharding_rules.py, on both packages
# --------------------------------------------------------------------------

def test_embedding_shards_vocab():
    _, s = both("param_spec", "embed/embedding", (131072, 6144), MESH)
    assert s == PSpec("model", None)


def test_attention_column_and_row_parallel():
    _, s = both("param_spec", "slot0/mixer/wq/kernel", (13, 6144, 6144),
                MESH, n_stack_dims=1)
    assert s == PSpec(None, None, "model")
    _, s = both("param_spec", "slot0/mixer/wo/kernel", (13, 6144, 6144),
                MESH, n_stack_dims=1)
    assert s == PSpec(None, "model", None)


def test_mlp_column_row():
    _, s = both("param_spec", "slot0/ffn/up/kernel", (2, 1024, 4096), MESH,
                n_stack_dims=1)
    assert s == PSpec(None, None, "model")
    _, s = both("param_spec", "slot0/ffn/down/kernel", (2, 4096, 1024),
                MESH, n_stack_dims=1)
    assert s == PSpec(None, "model", None)


def test_moe_expert_parallel_when_divisible():
    _, s = both("param_spec", "slot1/ffn/up", (9, 16, 8192, 24576), MESH,
                n_stack_dims=1)
    assert s == PSpec(None, "model", None, None)


def test_moe_ff_fallback_when_not_divisible():
    _, s = both("param_spec", "slot0/ffn/up", (64, 8, 6144, 32768), MESH,
                n_stack_dims=1)
    assert s == PSpec(None, None, None, "model")
    _, s = both("param_spec", "slot0/ffn/down", (64, 8, 32768, 6144), MESH,
                n_stack_dims=1)
    assert s == PSpec(None, None, "model", None)


def test_zero3_adds_data_axis():
    _, s = both("param_spec", "slot0/mixer/wq/kernel", (64, 6144, 6144),
                MESH, zero3=True, n_stack_dims=1)
    assert s == PSpec(None, "data", "model")
    _, s = both("param_spec", "slot0/mixer/wq/kernel", (64, 6144, 6144),
                POD_MESH, zero3=True, n_stack_dims=1)
    assert s == PSpec(None, ("pod", "data"), "model")


def test_bias_and_norms_replicated():
    _, s = both("param_spec", "slot0/pre_mixer_norm/scale", (64, 6144), MESH,
                n_stack_dims=1)
    assert s == PSpec(None, None)
    _, s = both("param_spec", "final_norm/scale", (6144,), MESH)
    assert s == PSpec(None)


def test_batch_pspec_uses_pod_and_data():
    jb = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32)}
    tb = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                device="meta")}
    for mesh, want in ((MESH, PSpec("data", None)),
                       (POD_MESH, PSpec(("pod", "data"), None))):
        j, t = jshd.batch_pspec(jb, mesh), tshd.batch_pspec(tb, mesh)
        assert tuple(j["tokens"]) == tuple(t["tokens"]) == tuple(want)


def test_cache_pspec_kv_layout():
    jc = {"slots": ({"k": jax.ShapeDtypeStruct((13, 128, 32768, 8, 128),
                                               jnp.bfloat16)},)}
    tc = {"slots": ({"k": torch.empty((13, 128, 32768, 8, 128),
                                      dtype=torch.bfloat16, device="meta")},)}
    j, t = jshd.cache_pspec(jc, MESH), tshd.cache_pspec(tc, MESH)
    assert tuple(j["slots"][0]["k"]) == tuple(t["slots"][0]["k"]) \
        == (None, "data", None, None, "model")


def test_full_params_spec_no_crashes_and_divisible():
    """Every full arch: every sharded dim divides its axis size."""
    for name in ("grok-1-314b", "gemma2-2b", "jamba-1.5-large-398b",
                 "whisper-large-v3", "mamba2-130m"):
        specs, shapes = _port_specs(tget(name), MESH, zero3=_zero3(name))
        for path, spec in specs.items():
            for dim, ax in zip(shapes[path], tuple(spec)):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([MESH.shape[a] for a in axes]))
                assert dim % size == 0, (name, path, spec)


def test_real_mesh_end_to_end_tiny():
    """A 1 x 1 local mesh on the CPU (a one-rank process group of its
    own): params placed by the rules, the loss runs and is finite."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(data=1, model=1, device="cpu")
        arch = treduced("granite-moe-3b-a800m")
        params = arch.init(torch.Generator().manual_seed(0))
        placed = tshd.distribute(params, mesh,
                                 tshd.params_pspec(params, mesh))
        full = {k: v for k, v in _leaves(placed)}
        assert all(type(v).__name__ == "DTensor" for v in full.values())
        from repro_torch.distributed.partial import whole
        from repro_torch.core.optim.base import tree_map
        batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
                 "labels": torch.zeros((2, 16), dtype=torch.int32)}
        loss, _ = arch.loss_fn(tree_map(whole, placed), batch)
        assert bool(torch.isfinite(loss))
    finally:
        dist.destroy_process_group()


def test_bridge_places_jax_params_and_state_on_a_mesh():
    """bridge.place_from_jax: the JAX params and a JAX lans state, placed
    on a 1 x 1 mesh by the rules, hold the JAX values."""
    import torch.distributed as dist
    from repro_torch.bridge import place_from_jax
    from repro_torch.distributed.partial import whole
    from repro_torch.launch.mesh import make_local_mesh
    ja = jreduced("bert-large")
    jparams = jax.jit(ja.init)(jax.random.PRNGKey(0))
    jstate = jlans(1e-3).init(jparams)
    try:
        mesh = make_local_mesh(data=1, model=1, device="cpu")
        params, state = place_from_jax(
            treduced("bert-large").cfg, jax.tree.map(np.asarray, jparams),
            mesh, opt_state=jax.tree.map(np.asarray, jstate))
        want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
        for path, leaf in _leaves(params):
            assert type(leaf).__name__ == "DTensor", path
            np.testing.assert_array_equal(whole(leaf).numpy(), want[path])
        assert int(state[0].count) == 0
        assert type(state[0].mu["pooler"]["kernel"]).__name__ == "DTensor"
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# every leaf of every arch, reduced and full, zero3 or not, pod or not
# --------------------------------------------------------------------------

def _zero3(name):
    return jget(name).zero3


def _leaves(tree, prefix=""):
    """(path, leaf) in the JAX package's flattening order: dict keys
    sorted, tuple and NamedTuple items in order; a PSpec is a leaf, and
    None is none (JAX's trees skip it)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, PSpec):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}/{i}")
        return out
    return [(prefix, tree)]


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_params(arch):
    with torch.device("meta"):
        return arch.init(None)


def _port_specs(arch, mesh, zero3):
    params = _port_params(arch)
    specs = tshd.params_pspec(params, mesh, zero3=zero3)
    return (dict(_leaves(specs)),
            {p: tuple(v.shape) for p, v in _leaves(params)})


@pytest.mark.parametrize("mesh", ["16x16", "pod"])
@pytest.mark.parametrize("zero3", [False, True])
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_params_pspec_equals_jax_on_every_leaf(name, size, zero3, mesh):
    m = MESH if mesh == "16x16" else POD_MESH
    ja = jreduced(name) if size == "reduced" else jget(name)
    ta = treduced(name) if size == "reduced" else tget(name)
    jparams = jax.eval_shape(ja.init, jax.random.PRNGKey(0))
    tparams = _port_params(ta)
    jpaths = [p for p, _ in _leaves(jax.tree.map(lambda _: "leaf",
                                                 jparams))]
    assert jpaths == [p for p, _ in _leaves(tparams)]
    jspec = _jax_specs(jshd.params_pspec(jparams, m, zero3=zero3))
    tspec = [tuple(s) for _, s in _leaves(
        tshd.params_pspec(tparams, m, zero3=zero3))]
    assert tspec == jspec


# --------------------------------------------------------------------------
# optimizer states, batches, caches
# --------------------------------------------------------------------------

ZMESH = FakeMesh(data=4, model=2)


def _state_pair(kind, jparams, tparams):
    """(JAX state shapes, port state on meta) of one optimizer."""
    jtx, ttx = {
        "lans": (jlans(1e-3), tlans(1e-3)),
        "lamb": (jlamb(1e-3), tlamb(1e-3)),
        "adamw": (jadamw(1e-3), tadamw(1e-3)),
        "mixed": (jmixed(jlans(1e-3), jpolicy("bf16")),
                  tmixed(tlans(1e-3), tpolicy("bf16"))),
        "fused_mixed": (jfused_mixed(1e-3, jpolicy("bf16")),
                        tfused_mixed(1e-3, tpolicy("bf16"))),
    }[kind]
    if kind in ("mixed", "fused_mixed"):
        jparams = jax.eval_shape(jpolicy("bf16").cast_params, jparams)
        tparams = tpolicy("bf16").cast_params(tparams)
    jstate = jax.eval_shape(jtx.init, jparams)
    with torch.device("meta"):
        tstate = ttx.init(tparams)
    return jparams, tparams, jstate, tstate


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("kind", ["lans", "lamb", "adamw", "mixed",
                                  "fused_mixed"])
@pytest.mark.parametrize("name", ["bert-large", "qwen2.5-14b",
                                  "granite-moe-3b-a800m", "whisper-large-v3"])
def test_opt_state_pspec_equals_jax(name, kind, zero1):
    """Moments follow their param's spec (the zero3-style spec for ZeRO-1
    moments), masters the moments', counters and loss scale replicate."""
    jparams = jax.eval_shape(jreduced(name).init, jax.random.PRNGKey(0))
    tparams = _port_params(treduced(name))
    jparams, tparams, jstate, tstate = _state_pair(kind, jparams, tparams)
    jp = jshd.params_pspec(jparams, ZMESH)
    tp = tshd.params_pspec(tparams, ZMESH)
    jm = jshd.params_pspec(jparams, ZMESH, zero3=True) if zero1 else None
    tm = tshd.params_pspec(tparams, ZMESH, zero3=True) if zero1 else None
    jspec = _jax_specs(jshd.opt_state_pspec(jstate, jp, moments_spec=jm))
    tspec = [tuple(s) for _, s in _leaves(
        tshd.opt_state_pspec(tstate, tp, moments_spec=tm))]
    assert tspec == jspec
    if zero1:
        assert any("data" in (a if isinstance(a, tuple) else (a,))
                   for s in tspec for a in s if a is not None)


def test_fused_state_moments_follow_params():
    """A bare FusedState (fused_lans, fused_lamb): its moments take their
    param's spec, as a chain state's do in both packages. The JAX rule
    iterates a bare FusedState's fields as if it were a chain and
    replicates them (a plain tuple, which its jit_train_step refuses:
    ROADMAP Queue 3), so the port is held to the JAX spec of the same
    moments under lans."""
    from repro_torch.core.optim.fused import FusedState
    jparams = jax.eval_shape(jreduced("bert-large").init,
                             jax.random.PRNGKey(0))
    tparams = _port_params(treduced("bert-large"))
    with torch.device("meta"):
        tstate = tfused_lans(1e-3).init(tparams)
    tp = tshd.params_pspec(tparams, ZMESH)
    spec = tshd.opt_state_pspec(tstate, tp)
    assert isinstance(spec, FusedState) and spec.count == PSpec()
    jlans_spec = jshd.opt_state_pspec(jax.eval_shape(jlans(1e-3).init,
                                                     jparams),
                                      jshd.params_pspec(jparams, ZMESH))
    for field in ("mu", "nu"):
        assert [tuple(s) for _, s in _leaves(getattr(spec, field))] == \
            _jax_specs(getattr(jlans_spec[0], field))
    jquirk = jshd.opt_state_pspec(
        jax.eval_shape(jfused_lans(1e-3).init, jparams),
        jshd.params_pspec(jparams, ZMESH))
    assert type(jquirk) is tuple and all(
        s == () for s in _jax_specs(jquirk))


@pytest.mark.parametrize("mesh", ["16x16", "pod", "4x2"])
def test_batch_pspec_equals_jax(mesh):
    m = {"16x16": MESH, "pod": POD_MESH, "4x2": ZMESH}[mesh]
    shapes = {"tokens": (64, 128), "labels": (64, 128), "nsp": (64,),
              "odd": (3, 5), "scalar": ()}
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, dtype=torch.int32, device="meta")
          for k, s in shapes.items()}
    assert [tuple(s) for _, s in _leaves(tshd.batch_pspec(tb, m))] == \
        _jax_specs(jshd.batch_pspec(jb, m))


CACHE_ARCHS = ("gemma2-2b", "granite-moe-3b-a800m", "mamba2-130m",
               "jamba-1.5-large-398b", "qwen2.5-14b", "whisper-large-v3")


# paged serving is decoder-only in both packages
@pytest.mark.parametrize("name, paged", [(n, False) for n in CACHE_ARCHS] + [
    (n, True) for n in CACHE_ARCHS if n != "whisper-large-v3"])
def test_cache_pspec_equals_jax(name, paged):
    ja, ta = jreduced(name), treduced(name)
    if paged:
        jc = jax.eval_shape(lambda: ja.init_paged_cache(4, 64, block_size=8))
        tc = ta.init_paged_cache(4, 64, block_size=8, device="meta")
    else:
        jc = jax.eval_shape(lambda: ja.init_cache(4, 64, per_slot=True))
        tc = ta.init_cache(4, 64, device="meta")
    jpaths = [p for p, _ in _leaves(jax.tree.map(lambda _: "leaf", jc))]
    assert jpaths == [p for p, _ in _leaves(tc)]
    for m in (ZMESH, FakeMesh(data=2, model=4), MESH):
        assert [tuple(s) for _, s in _leaves(tshd.cache_pspec(tc, m))] == \
            _jax_specs(jshd.cache_pspec(jc, m))


# --------------------------------------------------------------------------
# placements and meshes
# --------------------------------------------------------------------------

def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    two = FakeDeviceMesh("data", "model")
    pod = FakeDeviceMesh("pod", "data", "model")
    assert tshd.placements(PSpec(None, "model"), two) == (Replicate(),
                                                          Shard(1))
    assert tshd.placements(PSpec("data", "model"), two) == (Shard(0),
                                                            Shard(1))
    assert tshd.placements(PSpec(("data", "model"), None), two) == (
        Shard(0), Shard(0))
    assert tshd.placements(PSpec(), two) == (Replicate(), Replicate())
    assert tshd.placements(PSpec(None, ("pod", "data"), "model"), pod) == \
        (Shard(1), Shard(1), Shard(2))
    with pytest.raises(ValueError, match="not on the mesh"):
        tshd.placements(PSpec("pod"), two)


def test_params_sharding_and_cache_shardings():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeDeviceMesh("data", "model")
    mesh.shape = (2, 2)
    params = _port_params(treduced("bert-large"))
    sh = tshd.params_sharding(params, mesh)
    assert sh["tok_embed"]["embedding"] == (Replicate(), Shard(0))
    assert sh["layers"]["attn"]["wq"]["kernel"] == (Replicate(), Shard(2))
    # dense (layers, B, L, kv, hd): B over data, hd over model
    cache = treduced("gemma2-2b").init_cache(4, 64, device="meta")
    csh = tshd.cache_shardings(cache, mesh)
    assert csh["slots"][0]["k"] == (Shard(1), Shard(4))
    assert csh["index"] == (Replicate(), Replicate())


def test_make_local_mesh_never_shrinks():
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_local_mesh(data=2, model=1, device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(data=1, model=1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError, match="process group has 1"):
            make_local_mesh(data=1, model=2, device="cpu")
    finally:
        dist.destroy_process_group()
