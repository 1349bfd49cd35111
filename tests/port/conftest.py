"""Shared set-up of the port's parity tests (tests/port/test_torch_*.py).

Each test feeds the same inputs, made with numpy from a seed, to a JAX
function of `repro` and to its counterpart in `repro_torch`, on the CPU.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="session")
def gemma_pair():
    """(JAX arch, JAX params, port arch, port params) for reduced
    gemma2-2b, with the same weights on both sides (the JAX init,
    carried over by repro_torch.bridge)."""
    import jax
    from repro.configs import reduced_arch
    from repro_torch import configs as tconfigs
    from repro_torch.bridge import params_from_jax
    jarch = reduced_arch("gemma2-2b")
    jparams = jarch.init(jax.random.PRNGKey(0))
    tarch = tconfigs.reduced_arch("gemma2-2b")
    tparams = params_from_jax(tarch.cfg,
                              jax.tree.map(np.asarray, jparams))
    return jarch, jparams, tarch, tparams
