"""One rank of the port's mesh train-step tests (test_torch_mesh_train.py
on the CPU, test_torch_cuda_kernels.py on four cards), and what they
share: the cases, the one-device and mesh runs, and the comparison.

`run_rank` is started with the spawn method, one process per rank, over a
process group whose rendezvous is a FileStore (no TCP port): gloo on the
CPU, or NCCL with rank r on card r. It builds the mesh of one layout
and, for every case of the inputs file, runs the placed train step from
the given params over the given batches, then writes what it saw
(losses, the params gathered whole, the partial all-reduces of each
step) for the parent to compare. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-3
STEPS = 3
# name: (arch, optimizer, microbatches)
CASES = {
    "bert-fused_lans": ("bert-large", "fused_lans", 1),
    "bert-fused_mixed_lans": ("bert-large", "fused_mixed_lans", 1),
    "bert-fused_lamb": ("bert-large", "fused_lamb", 1),
    "bert-lans": ("bert-large", "lans", 1),
    "qwen-fused_lans": ("qwen2.5-14b", "fused_lans", 2),
}


def make_tx(name):
    """(transform, policy name) of a case's optimizer."""
    from repro_torch.core.optim import fused_lamb, fused_lans, lans
    from repro_torch.precision import fused_mixed_lans, get_policy
    if name == "fused_mixed_lans":
        return fused_mixed_lans(LR, get_policy("bf16")), "bf16"
    return {"fused_lans": fused_lans, "fused_lamb": fused_lamb,
            "lans": lans}[name](LR), "fp32"


def case_arch(arch_name, policy):
    """The reduced arch, computing in fp32 (bf16 under the bf16 policy)."""
    from repro_torch.configs import reduced_arch
    from repro_torch.precision import get_policy
    arch = reduced_arch(arch_name)
    cfg = (dataclasses.replace(arch.cfg, compute_dtype=torch.float32)
           if policy == "fp32" else get_policy(policy).apply_to_cfg(arch.cfg))
    return dataclasses.replace(arch, cfg=cfg)


@contextlib.contextmanager
def mesh_order(data, microbatches):
    """While active, a one-device step built with microbatches=1 takes
    its gradient in the order of a mesh whose batch is cut over `data`
    ranks (distributed/steps.py): each rank's block of each microbatch
    on its own, its losses' means over the whole microbatch (WHOLE); a
    rank's microbatches summed and divided by their number, as the step
    sums them; then the ranks' sums added, as the all-reduce adds them
    (exactly: a sum of two is the same in either order). The maths is
    one device's; only the order of the gradient's sums is the mesh's,
    so that a mesh run can be held to it element by element."""
    from repro_torch.core.optim.base import tree_map
    from repro_torch.distributed import steps
    from repro_torch.models.common import WHOLE
    plain = steps.loss_and_grads

    def blocks(batch, n):
        size = next(iter(batch.values())).shape[0] // n
        return [{k: v[i * size:(i + 1) * size] if v.ndim else v
                 for k, v in batch.items()} for i in range(n)]

    def add(a, b):
        return tree_map(torch.add, a, b) if isinstance(a, dict) else a + b

    def one_rank(loss_fn, params, batch, scale, r):
        runs = [plain(loss_fn, params, {**blocks(mb, data)[r], WHOLE: mb},
                      scale) for mb in blocks(batch, microbatches)]
        if microbatches == 1:
            return runs[0]
        grads = runs[0][2]
        for _, _, g in runs[1:]:
            grads = add(grads, g)
        auxs = [a for _, a, _ in runs]
        aux = {k: torch.stack([a[k] for a in auxs]).mean(dim=0)
               if torch.is_tensor(v) and v.is_floating_point() else v
               for k, v in auxs[-1].items()}
        return (torch.stack([l for l, _, _ in runs]).sum() / microbatches,
                aux, tree_map(lambda g: g / microbatches, grads))

    def in_mesh_order(loss_fn, params, batch, scale):
        loss, aux, grads = one_rank(loss_fn, params, batch, scale, 0)
        for r in range(1, data):
            loss_r, aux_r, grads_r = one_rank(loss_fn, params, batch, scale,
                                              r)
            loss, grads = loss + loss_r, add(grads, grads_r)
            aux = {k: v + aux_r[k] if torch.is_tensor(v)
                   and v.is_floating_point() else v for k, v in aux.items()}
        return loss, aux, grads

    steps.loss_and_grads = in_mesh_order
    try:
        yield
    finally:
        steps.loss_and_grads = plain


def one_device_step(case, data=1):
    """The case's one-device step, (params, state, batch) -> (params,
    state, metrics), its gradient summed in the order of a mesh whose
    batch is cut over `data` ranks (mesh_order) when data > 1."""
    from repro_torch.distributed.steps import build_train_step
    tx, policy = make_tx(case["optimizer"])
    arch = case_arch(case["arch"], policy)
    mb = case["microbatches"]
    step, _ = build_train_step(arch.loss_fn, tx,
                               microbatches=1 if data > 1 else mb,
                               policy=policy)
    if data == 1:
        return step

    def in_mesh_order(params, state, batch):
        with mesh_order(data, mb):
            return step(params, state, batch)

    return in_mesh_order


def whole_tree(tree):
    """A copy of a tree of dicts, tuples and NamedTuples with every
    DTensor leaf gathered whole (partial.whole)."""
    from repro_torch.distributed.partial import whole
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [whole_tree(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return whole(tree).detach().clone() if torch.is_tensor(tree) else tree


def run_steps(case, params, batches, mesh=None, *, zero3=False, zero1=False,
              data=1):
    """(losses, whole params, partial all-reduces per step, checks,
    kernel launches of the case's steps) of the case's train step on
    `mesh`, or with no mesh of one_device_step (in the order of `data`
    ranks). On a mesh, rank 0's `checks` holds for each step the mesh
    step's params beside those of the one-device step in the mesh's
    order taken from the same params, state and batch as the mesh step
    (so its gradient is the mesh's, bit for bit); [] off a mesh and on
    the other ranks."""
    from repro_torch.core.optim.base import tree_items
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.partial import reduce_partials
    from repro_torch.distributed.steps import (build_train_step,
                                               place_train_step)
    tx, policy = make_tx(case["optimizer"])
    arch = case_arch(case["arch"], policy)
    step, init = build_train_step(
        arch.loss_fn, tx, mesh, zero3=zero3,
        microbatches=case["microbatches"], param_init_fn=lambda _: params,
        policy=policy)
    p, o = init(None)
    ref = None
    if mesh is None:
        step = one_device_step(case, data)
    else:
        pspec, ospec = step.specs_for(p, o)
        if zero1:
            ospec = shd.opt_state_pspec(
                o, pspec, moments_spec=shd.params_pspec(p, mesh, zero3=True))
        step = place_train_step(step, mesh, pspec, ospec, batches[0])
        ref = one_device_step(case, shd.mesh_shape(mesh)["data"])
    flat = lambda tree: dict(tree_items(whole_tree(tree)))
    losses, calls, checks = [], [], []
    launched = dict.fromkeys(launches(), 0)
    for b in batches:
        # every rank gathers (a collective); rank 0 alone runs the check
        start = (whole_tree(p), whole_tree(o)) if ref is not None else None
        before, counts = reduce_partials.calls, launches()
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        calls.append(reduce_partials.calls - before)
        for k, n in launches().items():
            launched[k] += n - counts[k]
        if ref is not None:
            got = flat(p)
            if dist.get_rank() == 0:
                checks.append((got, flat(ref(*start, b)[0])))
    return losses, flat(p), calls, checks, launched


def launches():
    """{kernel: launches so far} of K1-K6 (counted on CUDA only)."""
    from repro_torch.kernels import lamb, lans
    return {k.__name__: k.launches for k in (*lans.KERNELS, *lamb.KERNELS)}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def run_rank(rank, world, store_path, layout, inputs_path, out_path,
             device="cpu"):
    torch.set_num_threads(1)
    backend = "gloo"
    if device == "cuda":
        from repro_torch import select_device
        select_device("cuda")           # TF32 off, as one device runs
        torch.cuda.set_device(rank)
        device, backend = f"cuda:{rank}", "nccl"
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device=device.split(":")[0])
        inputs = to_device(torch.load(inputs_path), device)
        out = {}
        for name, case in inputs["cases"].items():
            losses, params, calls, checks, launched = run_steps(
                case, inputs["params"][case["arch"]], case["batches"], mesh,
                zero3=layout["zero3"], zero1=layout["zero1"])
            out[name] = {"losses": losses, "calls": calls,
                         "launches": launched,
                         "params": (to_device(params, "cpu") if rank == 0
                                    else None),
                         "checks": (to_device(checks, "cpu") if rank == 0
                                    else None)}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def start_ranks(ctx, layout, tmp, inputs_path, tag, device="cpu"):
    """The processes of one layout's ranks (started), spawned from ctx."""
    world = layout["data"] * layout["model"]
    procs = [ctx.Process(target=run_rank, args=(
        r, world, str(tmp / f"store-{tag}"), layout, str(inputs_path),
        str(tmp / f"out-{tag}"), device)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, tmp, tag, timeout):
    """Rank 0's results after every rank exited 0 within `timeout`
    (seconds, for each join), and every rank reported the same losses.
    A rank still alive is killed."""
    try:
        for p in procs:
            p.join(timeout)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * len(procs), f"{tag}: rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [torch.load(tmp / f"out-{tag}.{r}") for r in range(len(procs))]
    for name in ranks[0]:
        assert all(r[name]["losses"] == ranks[0][name]["losses"]
                   for r in ranks), name
    return ranks[0]


def port_inputs(seed=0):
    """Inputs made by the port alone (no JAX): params of the reduced
    archs from a CPU torch.Generator, and seeded numpy batches (MLM with
    -100 on unmasked positions for BERT, shifted next tokens for qwen)."""
    from repro_torch.configs import reduced_arch
    params, batches = {}, {}
    rng = np.random.default_rng(seed)
    for name in ("bert-large", "qwen2.5-14b"):
        arch = reduced_arch(name)
        params[name] = arch.init(torch.Generator().manual_seed(seed))
        out = []
        for _ in range(STEPS):
            tok = rng.integers(0, arch.cfg.vocab, size=(4, 32))
            if name == "bert-large":
                lab = np.where(rng.random((4, 32)) < 0.15, tok, -100)
                b = {"tokens": tok, "mlm_labels": lab,
                     "nsp_labels": rng.integers(0, 2, size=(4,)),
                     "token_types": np.zeros_like(tok)}
            else:
                lab = np.concatenate([tok[:, 1:], np.full((4, 1), -100)], 1)
                b = {"tokens": tok, "labels": lab}
            out.append({k: torch.from_numpy(v.astype(np.int32))
                        for k, v in b.items()})
        batches[name] = out
    cases = {name: dict(arch=a, optimizer=o, microbatches=mb,
                        batches=batches[a])
             for name, (a, o, mb) in CASES.items()}
    return params, cases


def key_bias(path):
    return path.endswith("wk/bias")


def assert_params_close(got, want, *, skip=()):
    """Every element of every leaf of `got` against `want` (path ->
    tensor), bar the paths in `skip`: fp32 within rtol 1e-5 and atol
    1e-6, bf16 within one bf16 ulp."""
    for path, a in want.items():
        b = got[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path in skip:
            continue
        rtol = 2 ** -7 if a.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=rtol, atol=1e-6, err_msg=path)


def check_against_one_device(got, want, layout, case):
    """A mesh run against the one-device step whose gradient is summed in
    the mesh's order (run_steps with the layout's data):
    - each step's params, every element of every leaf, against the
      one-device step's from the same params, state and batch
      (got["checks"]);
    - the losses over the steps, fp32 within 1e-5 relative, under
      fused_mixed_lans (bf16) within 1e-4, as test_torch_train.py holds
      that transform against the generic wrapper;
    - the params after the steps, every element of every leaf, but for
      the attention key bias on a layout that cuts leaves over ranks.
    Params: fp32 within rtol 1e-5 and atol 1e-6, bf16 within one bf16
    ulp. The key bias's true gradient is 0 (it adds one constant to a
    query row's logits), so its gradient is rounding noise of all the
    params, which LANS's g / ||g|| scales to a unit-size step: once a
    cut leaf's norms, summed over the ranks in another order, have moved
    any param by its last bit, the next step's noise, and so the key
    bias's direction, is another. The per-step check holds it."""
    for mesh_params, ref_params in got["checks"]:
        assert_params_close(mesh_params, ref_params)
    bf16 = CASES[case][1] == "fused_mixed_lans"
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=1e-4 if bf16 else 1e-5)
    cuts = layout["model"] > 1 or layout["zero3"] or layout["zero1"]
    assert_params_close(got["params"], want["params"], skip={
        p for p in want["params"] if cuts and key_bias(p)})
