"""Cost model of a traced step: the counterpart of repro/launch/hlo_cost.py.

The JAX package compiles a step and walks its optimized HLO. The port
runs eagerly, so it counts the step as it runs: `Tracer`, a
TorchDispatchMode, sees every aten op the step dispatches (the forward,
the backward and its recomputed regions, the optimizer, and the local
ops under DTensor) and charges it. The step may run on meta tensors
(launch/dryrun.py: nothing is allocated, any shape fits) or on real ones
(the tests hold the two counts equal).

  FLOPs        the matmuls and attention by torch's FLOP counter
               (torch.utils.flop_counter's formulas), kept by the dtype
               they run in ("tf32" for fp32 matmuls where TF32 is
               allowed); every pointwise op, cast and reduction one FLOP
               per element of its largest tensor, kept as "elementwise"
               (hlo_cost charges XLA's elementwise ops, converts and
               reduces so); copies, indexing and factories none.
  bytes        per op, its tensor operands' bytes plus its results'
               bytes: what the eager port moves, since nothing is fused.
               Views move nothing; a write-only first operand (copy_,
               fill_, zero_) is charged once, as the result.
  collectives  bytes of each collective's output, by kind (all-gather,
               all-reduce, reduce-scatter, all-to-all, collective-
               permute), as hlo_analysis charges them; c10d ops and
               functional collectives alike, so DTensor's redistributes
               and the port's own sums (distributed/partial.py: a
               rank-order sum is an all-gather, an exchange an
               all-to-all) are seen where they run. They are counted in
               the bytes too, as in hlo_cost.
  loops        a loop that runs through `loop(n)` (the train step's
               microbatches) runs its first trip, which starts the
               accumulators, counted once, and its second, the
               steady-state body, counted n - 1 times, as hlo_cost
               multiplies a while body by its trip count.
  hand kernels a kernel reached on meta tensors runs its stand-in,
               which charges the kernel's own FLOPs and bytes (the cost
               functions beside each kernel: kernels/lans.py, lamb.py,
               paged_attention.py) through `charge_kernel`.
  memory       the peak of the bytes of the storages that the traced ops
               create and that are alive at once (`peak_bytes`): the
               step's temporaries and its outputs.

Ops that DTensor's sharding propagation runs on fake tensors of the
global shapes are not the rank's work and are skipped.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d and functional-collective op names -> kind
_COLL_OPS = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLL_FREE = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
              "monitored_barrier_"}
# reductions (no pointwise tag): one FLOP per element of the input
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "cumsum", "cumprod", "argmax", "argmin", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "all", "any",
    "native_layer_norm", "native_layer_norm_backward", "topk", "sort",
}
# ops that write their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_"}
# ops that move no bytes of their own
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "set_", "resize_",
         "_has_compatible_shallow_copy_type", "is_same_size"}


def _zeros():
    return {k: 0.0 for k in COLLECTIVES}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=_zeros)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=_zeros)
    # the FLOPs of `flops` by the dtype they run in: the matmuls' and
    # attention's dtypes, and "elementwise"
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # hand kernels charged by their cost functions: name -> launches
    kernels: Dict[str, float] = dataclasses.field(default_factory=dict)


_TRACERS: list = []


def active() -> Optional["Tracer"]:
    """The innermost tracer in force, else None."""
    return _TRACERS[-1] if _TRACERS else None


def charge_kernel(name: str, flops_by_dtype: Dict[str, float],
                  nbytes: float):
    """Charge one launch of hand kernel `name` to the tracer in force (its
    stand-in calls this; nothing happens without a tracer)."""
    tracer = active()
    if tracer is None:
        return
    c = tracer.cost
    w = tracer.times
    for k, v in flops_by_dtype.items():
        c.flops += v * w
        c.flops_by_dtype[k] = c.flops_by_dtype.get(k, 0.0) + v * w
    c.bytes += nbytes * w
    c.kernels[name] = c.kernels.get(name, 0.0) + w
    mine = tracer.by_op.setdefault(f"kernel::{name}", [0.0, 0.0])
    mine[0] += sum(flops_by_dtype.values()) * w
    mine[1] += nbytes * w


def loop(n: int):
    """The trips of an n-trip loop: range(n), or under a tracer that folds
    loops trip 0 (counted once) and trip 1 (counted n - 1 times). A loop
    body whose first trip differs from the others (it starts the
    accumulators) is then counted exactly."""
    tracer = active()
    if tracer is None or not tracer.fold_loops or n <= 2:
        yield from range(n)
        return
    yield 0
    prev = tracer.times
    tracer.times = prev * (n - 1)
    try:
        yield 1
    finally:
        tracer.times = prev


def nbytes_of(t) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _matmul_dtype(tensors) -> str:
    dt = tensors[0].dtype if tensors else torch.float32
    name = str(dt).replace("torch.", "")
    if dt == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return name


class Tracer(TorchDispatchMode):
    """Counts the cost (`cost`, a Cost) of every op run under it, and
    `peak_bytes`, the most bytes of storages made under it alive at
    once. `fold_loops`: `loop(n)` runs two trips (see the module
    docstring). `times` is the weight of what is charged now (the
    loop's multiplier)."""

    def __init__(self, *, fold_loops: bool = True):
        super().__init__()
        self.cost = Cost()
        # op name (a hand kernel's "kernel::<name>") -> [FLOPs, bytes]
        # charged to it: where the cost goes
        self.by_op: Dict[str, list] = {}
        self.fold_loops = fold_loops
        self.times = 1.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def __enter__(self):
        _TRACERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        _TRACERS.remove(self)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the rank's local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if any(_is_fake(t) for t in ins + outs):
            return out      # sharding propagation on global shapes
        flops, nbytes = self.cost.flops, self.cost.bytes
        self._charge(func, args, ins, outs)
        mine = self.by_op.setdefault(func._schema.name, [0.0, 0.0])
        mine[0] += self.cost.flops - flops
        mine[1] += self.cost.bytes - nbytes
        if not func.is_view:
            # an output on an input's storage (in place, or an alias) is
            # no new allocation
            held = {t.untyped_storage()._cdata for t in ins}
            for o in outs:
                if o.untyped_storage()._cdata not in held:
                    self._track(o)
        return out

    # ---------------- charging ----------------

    def _charge(self, func, args, ins, outs):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        c, w = self.cost, self.times
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
            if name in _COLL_FREE:
                return
            kind = _COLL_OPS.get(name)
            if kind is None:
                raise NotImplementedError(f"no cost for collective {func}")
            if ns == "c10d":
                # in-place c10d ops: the first argument holds the outputs
                res = [t for t in tree_flatten(args[0])[0]
                       if isinstance(t, torch.Tensor)]
            else:
                res = outs
            out_bytes = sum(nbytes_of(t) for t in res)
            c.coll[kind] += out_bytes * w
            c.coll_counts[kind] += w
            c.bytes += (out_bytes + sum(nbytes_of(t) for t in ins
                                        if not any(t is r for r in res))
                        ) * w
            return
        if func.is_view or name in _FREE:
            return
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, out_val=outs[0] if len(outs) == 1
                                      else tuple(outs))
            key = _matmul_dtype(ins)
            c.flops += f * w
            c.flops_by_dtype[key] = c.flops_by_dtype.get(key, 0.0) + f * w
        elif ((torch.Tag.pointwise in func.tags and name != "clone")
              or name in _REDUCTIONS
              or (name == "_to_copy" and outs[0].dtype != ins[0].dtype)):
            n = max([t.numel() for t in ins + outs] or [0])
            c.flops += n * w
            c.flops_by_dtype["elementwise"] = (
                c.flops_by_dtype.get("elementwise", 0.0) + n * w)
        moved = sum(nbytes_of(t) for t in outs)
        skip = ins[0] if name in _WRITE_ONLY and ins else None
        moved += sum(nbytes_of(t) for t in ins if t is not skip)
        c.bytes += moved * w

    # ---------------- memory ----------------

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

