"""The port's MoE ffn routing in groups (models/moe.py: `groups=`, what a
rank's block of a data-cut batch is on a mesh) against the JAX package's
moe_apply under a two-device host mesh, whose ambient data axis makes it
route in two groups, each with its own capacity and cumsum.

The JAX side runs in a process of its own, started with
XLA_FLAGS=--xla_force_host_platform_device_count=2 (the flag must be set
before JAX starts; tests/test_sharded_serving.py runs its JAX meshes
that way), which writes its outputs for the parent to compare: fp32
outputs within 1e-5, moe_aux_loss and router_entropy within 1e-6, and
left padding (`valid` False) routing nowhere (its rows exactly 0)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.models import moe as tmoe

# name: MoeConfig fields, sequence length, left pads per row
CASES = {
    "capacity_1.25_drops": (dict(n_experts=8, top_k=2,
                                 capacity_factor=1.25), 16, None),
    "capacity_0.25_top1": (dict(n_experts=4, top_k=1,
                                capacity_factor=0.25), 32, None),
    "left_pads": (dict(n_experts=8, top_k=2, capacity_factor=1.25), 16,
                  (5, 0)),
    "ungated_gelu": (dict(n_experts=4, top_k=2, capacity_factor=1.25,
                          gated=False, activation="gelu"), 8, None),
}
D, FF, ROWS = 16, 32, 2

_JAX_GROUPS = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_local_mesh
    from repro.models import moe
    assert jax.device_count() == 2, jax.devices()
    cases, path = json.loads(sys.argv[1]), sys.argv[2]
    data = dict(np.load(path))
    out = {}
    mesh = make_local_mesh(data=2, model=1)
    for name, kw in cases.items():
        cfg = moe.MoeConfig(d_model=%d, d_ff=%d, **kw)
        p = {"router": {"kernel": data[name + "/router"]},
             "up": data[name + "/up"], "down": data[name + "/down"]}
        if name + "/gate" in data:
            p["gate"] = data[name + "/gate"]
        valid = data.get(name + "/valid")
        fn = jax.jit(lambda p, x, v, cfg=cfg: moe.moe_apply(
            p, cfg, x, valid=v, compute_dtype=jnp.float32))
        with mesh:
            y, aux = fn(p, data[name + "/x"], valid)
        out[name + "/y"] = np.asarray(y)
        for k, v in aux.items():
            out[name + "/" + k] = np.asarray(v)
    np.savez(path + ".out.npz", **out)
""" % (D, FF))


def _inputs(name):
    kw, S, pads = CASES[name]
    rng = np.random.default_rng(len(name))
    e = kw["n_experts"]
    p = {"router": rng.normal(size=(D, e)).astype(np.float32),
         "up": (rng.normal(size=(e, D, FF)) / np.sqrt(D)).astype(np.float32),
         "down": (rng.normal(size=(e, FF, D))
                  / np.sqrt(FF)).astype(np.float32)}
    if kw.get("gated", True):
        p["gate"] = (rng.normal(size=(e, D, FF))
                     / np.sqrt(D)).astype(np.float32)
    p["x"] = rng.normal(size=(ROWS, S, D)).astype(np.float32)
    if pads is not None:
        valid = np.ones((ROWS, S), bool)
        for b, n in enumerate(pads):
            valid[b, :n] = False
        p["valid"] = valid
    return p


@pytest.fixture(scope="module")
def jax_groups(tmp_path_factory):
    """{name/output: array} of JAX's moe_apply on a 2 x 1 host mesh."""
    path = tmp_path_factory.mktemp("moe") / "inputs.npz"
    np.savez(path, **{f"{name}/{k}": v for name in CASES
                      for k, v in _inputs(name).items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join(
               [os.path.abspath("src"), os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", _JAX_GROUPS,
                    json.dumps({n: c[0] for n, c in CASES.items()}),
                    str(path)], env=env, check=True, timeout=600)
    return dict(np.load(f"{path}.out.npz"))


@pytest.mark.parametrize("route", ["dense", "gathered"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_groups_match_jax_on_a_data_mesh(jax_groups, name, route,
                                         monkeypatch):
    inp = _inputs(name)
    cfg = tmoe.MoeConfig(d_model=D, d_ff=FF, **CASES[name][0])
    p = {"router": {"kernel": torch.from_numpy(inp["router"])},
         **{k: torch.from_numpy(inp[k]) for k in ("up", "down", "gate")
            if k in inp}}
    valid = inp.get("valid")
    monkeypatch.setattr(tmoe, "DENSE_ROWS", 1 << 30 if route == "dense"
                        else 0)
    y, aux = tmoe.moe_apply(
        p, cfg, torch.from_numpy(inp["x"]),
        valid=None if valid is None else torch.from_numpy(valid),
        compute_dtype=torch.float32, groups=2)
    np.testing.assert_allclose(y.numpy(), jax_groups[f"{name}/y"],
                               rtol=1e-5, atol=1e-5)
    for k in ("moe_aux_loss", "router_entropy"):
        np.testing.assert_allclose(float(aux[k]), jax_groups[f"{name}/{k}"],
                                   rtol=0, atol=1e-6, err_msg=k)
    if valid is not None:
        assert not y.numpy()[~valid].any()


def test_two_groups_route_apart():
    """Two groups are not one: each group's own capacity drops (token,
    k) pairs that one group of the same tokens keeps, so the outputs
    differ (what makes the comparison above a test of the grouping)."""
    inp = _inputs("capacity_0.25_top1")
    cfg = tmoe.MoeConfig(d_model=D, d_ff=FF,
                         **CASES["capacity_0.25_top1"][0])
    p = {"router": {"kernel": torch.from_numpy(inp["router"])},
         **{k: torch.from_numpy(inp[k]) for k in ("up", "down", "gate")}}
    x = torch.from_numpy(inp["x"])
    one, _ = tmoe.moe_apply(p, cfg, x, compute_dtype=torch.float32)
    two, _ = tmoe.moe_apply(p, cfg, x, compute_dtype=torch.float32,
                            groups=2)
    assert not torch.equal(one, two)
