"""Multi-pod dry run: trace every (arch x shape x mesh) combination of the
port on meta tensors, at the production shapes and meshes, and record its
cost, collectives and memory for the roofline (the counterpart of
repro/launch/dryrun.py, which lowers and compiles with abstract inputs).

Nothing is allocated and no card is used: params, optimizer state,
batches and caches are meta tensors (configs/base.py: abstract_params,
input_specs, cache_specs, paged_cache_specs), and the port's own steps
run on them under a tracer (launch/trace_cost.py), which counts what one
rank runs; launch/trace_analysis.py turns that into the record. The
numbers are computed from shapes on the card's constants: none of them
is measured.

One rank's program is traced: rank 0 of make_production_mesh, (data 16,
model 16) or (pod 2, data 16, model 16), over a fake process group of
256 or 512 ranks. The fake backend comes from
torch.testing._internal.distributed.fake_pg, a torch testing module: its
collectives return at once and move nothing, so that the step runs on
one process with the shapes of rank 0's shards. It is imported here only,
inside the dry run, which takes the process's default group for its
time (and refuses to run beside another).

  train    build_train_step(arch.loss_fn, make_tx(arch), mesh, zero3=,
           zero1=, heads=, mamba=, microbatches=mb), the optimizer the
           unfused lans, mb the JAX dry run's rule; the microbatch loop
           traced once in its steady state (trace_cost.loop)
  prefill  the serving prefill step on the mesh (build_prefill_step):
           the whole admitted group on every data rank, the model axis
           computing what serve_params cuts (heads, ff columns, experts,
           vocab rows, Mamba heads)
  decode   decoders: build_serve_step on the paged pool's share of a
           data rank (paged_cache_specs with the ServeLayout: its KV
           heads and Mamba heads; K8's stand-in with --attn-kernel
           paged), the picks over "model" where the vocab is cut;
           encoder-decoder:
           build_serve_step on the pooled cache with the dense cross K/V
Serving takes a (data, model) mesh: on the two-pod mesh each pod serves
its half of the batch as a replica, and a batch that does not divide
over the data ranks (long_500k's one sequence) is served by each data
rank's model group as a replica.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all   # the 10 assigned
Flags: --mesh {pod1,pod2,both}  --attn-kernel {xla,paged}  --out experiments/dryrun
Each combination writes <out>/<arch>__<shape>__<mesh>.json and prints a
status line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED, SHAPES, get_arch
from repro_torch.core.optim import lans
from repro_torch.core.optim.base import tree_items
from repro_torch.core.schedules import warmup_hold_decay
from repro_torch.distributed import sharding as shd
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.trace_cost import Tracer

META = torch.device("meta")


def make_tx(arch):
    """The paper's optimizer + schedule, as the JAX dry run's."""
    sched = warmup_hold_decay(0.00675, 3519, 1501, 962)  # paper stage-1
    mu_dtype = arch.cfg.param_dtype if arch.zero3 else torch.float32
    return lans(sched, mu_dtype=mu_dtype)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake default process group of `world` ranks, this process its
    rank `rank`, destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("the dry run needs the default process group "
                           "to itself: run it in a fresh process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_like(tree):
    """A batch's tensors as meta tensors of their shapes and dtypes."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in tree.items()}


def train_microbatches(arch, shape, mesh) -> int:
    """The JAX dry run's rule: the arch's microbatches, as long as each
    keeps a row per data rank (pod x data)."""
    sizes = shd.mesh_shape(mesh)
    dp_total = sizes.get("data", 1) * sizes.get("pod", 1)
    return max(1, min(arch.train_microbatches,
                      shape.global_batch // dp_total))


def trace_train(arch, batch, mesh=None, *, microbatches: int = 1, tx=None,
                policy=None, fold_loops: bool = True, gen=None):
    """(analysis, Tracer) of one train step of `arch` on meta tensors:
    build_train_step with `tx` (default make_tx(arch)), on `mesh` (this
    rank's shards; None: one device), `batch` a dict of tensors (their
    shapes). Arguments: params, optimizer state and batch. With a
    torch.Generator `gen` the same step runs on real tensors instead,
    params drawn from `gen` on its device and `batch` as it is (what the
    tests hold the dry run to)."""
    from repro_torch.distributed.steps import build_train_step
    tx = tx if tx is not None else make_tx(arch)
    kw = {} if mesh is None else dict(
        zero3=arch.zero3, zero1=arch.zero1, heads=arch.heads,
        mamba=arch.mamba)
    step, init = build_train_step(arch.loss_fn, tx, mesh,
                                  microbatches=microbatches,
                                  param_init_fn=arch.init, policy=policy,
                                  **kw)
    if gen is None:
        with torch.device(META):
            params, state = init(None)
        batch = _meta_like(batch)
    else:
        params, state = init(gen)
    if mesh is not None:
        pspec, ospec = step.specs_for(params, state)
        params = shd.distribute(params, mesh, pspec)
        state = shd.distribute(state, mesh, ospec)
    with Tracer(fold_loops=fold_loops) as tracer:
        out = step(params, state, batch)
    n = 1 if mesh is None else mesh.size()
    return trace_analysis.analyze_trace(
        tracer, n, arguments=(params, state, batch),
        outputs=out[:2]), tracer


def _serving_mesh(mesh, batch: int):
    """(the mesh one serving replica runs on, its batch): a pod mesh's
    (data, model) submesh with the batch split over the pods, and the
    model axis alone where the batch does not divide over the data
    ranks."""
    sizes = shd.mesh_shape(mesh)
    pods = sizes.get("pod", 1)
    if pods > 1:
        mesh = mesh["data", "model"]
        if batch % pods == 0:
            batch //= pods
    if batch % sizes.get("data", 1):
        mesh = mesh["model"]
    return mesh, batch


def _serve_params(arch, mesh):
    params = arch.abstract_params()
    return params if mesh is None else shd.serve_params(
        params, mesh, arch.heads, arch.mamba)


def trace_prefill(arch, shape, mesh):
    """(analysis, Tracer) of the serving prefill step on `mesh`."""
    from repro_torch.distributed.steps import build_prefill_step
    from repro_torch.serving.engine import (build_encdec_prefill_fn,
                                            build_prefill_fn)
    smesh, B = _serving_mesh(mesh, shape.global_batch)
    layout = shd.serve_layout(arch.heads, B, smesh, arch.mamba)
    cache_kw = layout.cache_kw(arch.heads[1])
    params = _serve_params(arch, smesh)
    batch = arch.input_specs(shape.name)
    tokens = torch.empty((B, shape.seq_len), dtype=torch.int32, device=META)
    if arch.kind == "encdec":
        fn = build_encdec_prefill_fn(arch, shape.seq_len,
                                     cache_kw["kv_heads"])
        args = (params, tokens, None,
                torch.empty((B, *batch["frames"].shape[1:]),
                            dtype=batch["frames"].dtype, device=META))
    else:
        fn = build_prefill_fn(arch, shape.seq_len, **cache_kw)
        args = (params, tokens, None)
    step = build_prefill_step(fn, smesh)
    with Tracer() as tracer:
        out = step(*args)
    return trace_analysis.analyze_trace(tracer, mesh.size(), arguments=args,
                                        outputs=out), tracer


def _encdec_serve_cache(arch, rows: int, max_len: int, kv: int):
    """The pooled encoder-decoder cache of `rows` slots on the meta device,
    its cross K/V dense (what prefill_serve returns)."""
    from repro_torch.models import encdec as ed_lib
    cfg = arch.cfg
    cache = ed_lib.init_encdec_cache(cfg, rows, max_len,
                                     dtype=cfg.compute_dtype, per_slot=True,
                                     device=META, kv_heads=kv)
    shape = (cfg.n_layers, rows, cfg.n_frames, kv, cfg.head_dim)
    cache["cross"] = {
        "k": torch.empty(shape, dtype=cfg.compute_dtype, device=META),
        "v": torch.empty(shape, dtype=cfg.compute_dtype, device=META),
        "pos": torch.empty((cfg.n_frames,), dtype=torch.int32, device=META)}
    return cache


def trace_decode(arch, shape, mesh, attn_kernel: str = "xla"):
    """(analysis, Tracer) of one serving decode step on `mesh`: decoders
    on the paged pool's share, the encoder-decoder on its pooled cache."""
    from repro_torch.distributed.steps import build_serve_step
    smesh, B = _serving_mesh(mesh, shape.global_batch)
    layout = shd.serve_layout(arch.heads, B, smesh, arch.mamba)
    kv = layout.local_heads(arch.heads[1])
    if arch.kind == "decoder":
        cache = arch.paged_cache_specs(shape.name, batch=B, layout=layout)
    else:
        cache = _encdec_serve_cache(arch, layout.rows, shape.seq_len, kv)
    params = _serve_params(arch, smesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    positions = torch.empty((B, 1), dtype=torch.int32, device=META)
    from repro_torch.serving.sampler import vocab_cut
    step = build_serve_step(arch.decode_step, smesh, layout=layout,
                            vocab=vocab_cut(smesh, params))
    args = (params, tokens, positions, cache)
    with Tracer() as tracer:
        out = step(*args)
    return trace_analysis.analyze_trace(tracer, mesh.size(), arguments=args,
                                        outputs=out[0]), tracer


def lower_one(arch_name: str, shape_name: str, multi_pod: bool,
              attn_kernel: str = "xla") -> dict:
    """The record of one combination, traced on rank 0 of the production
    mesh (inside fake_world)."""
    arch = get_arch(arch_name)
    if attn_kernel != "xla" and arch.kind == "decoder":
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, attn_kernel=attn_kernel))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_chips = mesh.size()
    record = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "pod2" if multi_pod else "pod1", "n_chips": n_chips,
        "kind": shape.kind, "params": arch.param_count(),
        "zero3": arch.zero3, "zero1": arch.zero1,
    }
    if not arch.supports(shape_name):
        record["status"] = "skipped"
        record["reason"] = arch.skip_reason(shape_name)
        return record

    t0 = time.time()
    if shape.kind == "train":
        mb = train_microbatches(arch, shape, mesh)
        record["microbatches"] = mb
        analysis, _ = trace_train(arch, arch.input_specs(shape_name), mesh,
                                  microbatches=mb)
    elif shape.kind == "prefill":
        analysis, _ = trace_prefill(arch, shape, mesh)
    else:
        analysis, _ = trace_decode(arch, shape, mesh, attn_kernel)
        record["cache"] = "paged" if arch.kind == "decoder" else "dense"
        record["attn_kernel"] = attn_kernel

    n_active = active_params(arch)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    if shape.kind == "train":
        model_flops = trace_analysis.model_flops_training(n_active, n_tokens)
    else:
        model_flops = trace_analysis.model_flops_inference(n_active,
                                                           n_tokens)
    analysis["model_flops"] = model_flops
    analysis["useful_flops_ratio"] = (
        model_flops / analysis["flops_global"]
        if analysis.get("flops_global") else 0.0)
    record.update(analysis)
    record["status"] = "ok"
    record["trace_s"] = round(time.time() - t0, 1)
    return record


def active_params(arch) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = arch.param_count()
    cfg = arch.cfg
    if getattr(cfg, "n_experts", 0) and cfg.n_experts > cfg.top_k:
        expert_leaf = sum(math.prod(t.shape) for _, t in
                          tree_items(arch.abstract_params())
                          if t.ndim == 4 and t.shape[1] == cfg.n_experts)
        total = total - expert_leaf + expert_leaf * cfg.top_k // cfg.n_experts
    return total


def run_one(arch_name, shape_name, multi_pod, attn_kernel="xla") -> dict:
    """lower_one inside a fake process group of the mesh's ranks; an
    error becomes the record's status."""
    try:
        with fake_world(512 if multi_pod else 256):
            return lower_one(arch_name, shape_name, multi_pod,
                             attn_kernel=attn_kernel)
    except Exception as e:
        return {"arch": arch_name, "shape": shape_name,
                "mesh": "pod2" if multi_pod else "pod1",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def status_line(tag: str, rec: dict) -> str:
    status = rec["status"]
    if status == "ok":
        r = rec["roofline"]
        extra = (f" bound={r['dominant']} "
                 f"c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s "
                 f"x={r['collective_s']:.3f}s "
                 f"useful={rec['useful_flops_ratio']:.2f} "
                 f"[{rec['trace_s']}s]")
    elif status == "skipped":
        extra = f" ({rec['reason']})"
    else:
        extra = f" {rec['error'][:160]}"
    return f"{tag:60s} {status}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (the 10 assigned)")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--attn-kernel", default="xla", choices=["xla", "paged"],
                    help="decode shapes: the plain arena gather or K8 "
                         "(its stand-in, charged by its own cost)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch_name in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                tag = (f"{arch_name}__{shape_name}__"
                       f"{'pod2' if multi_pod else 'pod1'}")
                rec = run_one(arch_name, shape_name, multi_pod,
                              args.attn_kernel)
                failures += rec["status"] == "error"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                print(status_line(tag, rec), flush=True)
    if failures:
        raise SystemExit(f"{failures} combinations failed")


if __name__ == "__main__":
    main()
