"""Params and optimizer states from the JAX package to the port, through
numpy.

The port keeps the JAX package's param layout: nested dicts with the
same keys, dense kernels (in, out), and every `slot{i}` leaf (decoder),
`enc_layers` / `dec_layers` leaf (encoder-decoder) or `layers` leaf
(BERT) stacked over the periods or layers. So the conversion is leaf by
leaf; what it adds is a check that the tree has exactly the shapes the
port's `decoder_init` / `encdec_init` / `bert_init` would build for
`cfg`, so that both frameworks compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.bert import BertConfig, bert_init
from repro_torch.models.decoder import decoder_init
from repro_torch.models.encdec import EncDecConfig, encdec_init


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_shapes(v, path))
        else:
            out[path] = tuple(v.shape)
    return out


def _convert(tree, device):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _convert(v, device)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a).copy())
        out[k] = t.to(device)
    return out


def params_from_jax(cfg, np_tree, device="cpu"):
    """The JAX package's decoder, encoder-decoder or BERT params (nested
    dict of numpy arrays, or of anything np.asarray takes) as the port's
    params for `cfg` (a DecoderConfig, EncDecConfig or BertConfig), on
    `device`, dtypes kept. Raises when keys or shapes differ from what
    the port builds for `cfg`."""
    init = (bert_init if isinstance(cfg, BertConfig)
            else encdec_init if isinstance(cfg, EncDecConfig)
            else decoder_init)
    with torch.device("meta"):
        want = _shapes(init(None, cfg))
    got = _shapes(np_tree)
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"param tree does not match {cfg.name}: missing "
                         f"{missing}, unexpected {extra}, shape mismatch "
                         f"{[(k, got[k], want[k]) for k in wrong]}")
    return _convert(np_tree, device)


def _state_classes():
    from repro_torch.core.optim.adamw import AdamWState, MomentumState
    from repro_torch.core.optim.base import (EmptyState, ScaleByScheduleState,
                                             ScaleState)
    from repro_torch.core.optim.fused import FusedState
    from repro_torch.core.optim.lamb import LambState
    from repro_torch.core.optim.lans import LansState
    return {c.__name__: c for c in (
        LansState, LambState, AdamWState, FusedState, MomentumState,
        ScaleByScheduleState, EmptyState, ScaleState)}


def opt_state_from_jax(state, device="cpu"):
    """A JAX optimizer state as the port's, so that a trajectory started in
    the JAX package can go on in the port. The state is a NamedTuple of
    the optimizer modules (matched by class name, so nothing of JAX is
    imported) or a tuple of them (what `chain` builds); its `count`
    becomes a 0-d int32 tensor and every other field, a tree of JAX or
    numpy arrays, the same tree of tensors. Raises on any other state."""
    if type(state) is tuple:
        return tuple(opt_state_from_jax(s, device) for s in state)
    cls = _state_classes().get(type(state).__name__)
    if cls is None:
        raise ValueError(f"no port of optimizer state "
                         f"{type(state).__name__}")

    def field(name, v):
        if name == "count":
            return torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                                device=device)
        return _convert(v, device)

    return cls(**{f: field(f, getattr(state, f)) for f in cls._fields})


def place_from_jax(cfg, np_params, mesh, *, opt_state=None, zero3=False,
                   moments_spec=None, device="cpu"):
    """The JAX package's params (and, given, its optimizer state) bridged
    as params_from_jax and opt_state_from_jax do, then placed on `mesh`
    by the sharding rules (distributed/sharding.py: params_pspec with
    `zero3`, opt_state_pspec with `moments_spec` for ZeRO-1), so that a
    step on the mesh starts from the JAX parameters. Returns (params,
    opt_state or None)."""
    from repro_torch.distributed import sharding as shd
    params = params_from_jax(cfg, np_params, device)
    pspec = shd.params_pspec(params, mesh, zero3=zero3)
    state = None
    if opt_state is not None:
        state = opt_state_from_jax(opt_state, device)
        state = shd.distribute(state, mesh, shd.opt_state_pspec(
            state, pspec, moments_spec))
    return shd.distribute(params, mesh, pspec), state
