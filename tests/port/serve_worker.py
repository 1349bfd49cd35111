"""One rank of the port's serving-on-a-mesh tests
(test_torch_sharded_serving.py, test_torch_exactness_envelope.py and
test_torch_vocab_picks.py on the CPU, test_torch_cuda_kernels.py on four
cards), and what they share:
the workloads, the cases, one engine run of a case (on a mesh or on one
device), and the host state every rank must agree on.

`run_rank` is started with the spawn method, one process per rank, over
a process group whose rendezvous is a FileStore (no TCP port): gloo on
the CPU, NCCL with rank r on card r. It builds the mesh of one layout
and runs every case it is given, each on a fresh engine, then writes
what it saw for the parent to compare: the requests' outputs, the
engine's host state, the pool's local shapes and arena bytes, and the
K8 launches. `run_cli_rank` runs the serve CLI with --mesh the same way,
and `run_pick_rank` the vocab-parallel picks on one rank's columns.
It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("qwen2.5-14b", "bert-large", "whisper-large-v3")
POLICIES = (None, "fp32", "bf16", "fp16_mixed")
# the JAX sharded-serving tests' engine: block 8, 2 slots, 48 rows
DEC = dict(cache="paged", block_size=8, max_batch=2, max_len=48)


def _case(arch, work, one=False, **kw):
    """A case: `arch` (a reduced arch, or a VARIANTS name) serving the
    workload `work` on an engine built with `kw`, through the engine's
    loop, or with `one` each request through run_one (on a fresh engine
    as the loop's)."""
    return dict(arch=arch, work=work, kw=kw, one=one)


# reduced archs with a config changed: name -> (arch, fields). h2: two
# heads (of 64), so that a model axis of four cuts attention in two head
# groups of two ranks
VARIANTS = {"whisper-large-v3:h2": ("whisper-large-v3", {"n_heads": 2}),
            "bert-large:h2": ("bert-large", {"n_heads": 2})}


def _cases():
    out = {
        "paged": _case("qwen2.5-14b", "stream4", **DEC),
        "dense": _case("qwen2.5-14b", "stream4", **{**DEC,
                                                     "cache": "dense"}),
        "chunked": _case("qwen2.5-14b", "stream4", chunk_budget=8, **DEC),
        "spec": _case("qwen2.5-14b", "stream4", spec_k=3, **DEC),
        # a 56-row ring of 7 blocks and 4 slots' worth: 28 data blocks
        "placement": _case("qwen2.5-14b", "stream4",
                           **{**DEC, "max_len": 56, "slots_budget": 4}),
        "fp32": _case("qwen2.5-14b", "stream4", policy="fp32", **DEC),
        "kernel-fp32": _case("qwen2.5-14b", "stream4", policy="fp32",
                             attn_kernel="paged", **DEC),
        "bf16-stable": _case("qwen2.5-14b", "stream4", policy="bf16",
                             sampler="temperature=0,stable=1", **DEC),
        "bf16-stable-chunked": _case("qwen2.5-14b", "stream4",
                                     policy="bf16", chunk_budget=8,
                                     sampler="temperature=0,stable=1",
                                     **DEC),
        "router": _case("qwen2.5-14b", "stream4", **DEC),
        # the MoE, Mamba-2 and hybrid decoders, fp32: on a model axis each
        # rank serves its experts, vocab rows and Mamba heads (and their
        # SSM state)
        "granite": _case("granite-moe-3b-a800m", "stream4", policy="fp32",
                         **DEC),
        "mamba2": _case("mamba2-130m", "stream4", policy="fp32", **DEC),
        "jamba": _case("jamba-1.5-large-398b", "stream4", policy="fp32",
                       attn_kernel="paged", **DEC),
        # the encoder-decoder and BERT scoring, fp32: on a model axis each
        # rank's vocab rows of whisper's dec_embed and BERT's tok_embed
        "whisper": _case("whisper-large-v3", "encdec5", policy="fp32",
                         cache="paged", block_size=8, prefill_bucket=8,
                         max_batch=4, max_len=32),
        "bert": _case("bert-large", "score5", policy="fp32", task="score",
                      max_batch=4, max_len=16),
        # planted faults: the last data rank drops its last slot's token
        # from the gather; K8's plain version handed the local arena with
        # the global KV-head count
        "fault-drop": _case("qwen2.5-14b", "stream4", policy="fp32", **DEC),
        "fault-global-kv": _case("qwen2.5-14b", "stream4", policy="fp32",
                                 attn_kernel="paged", **DEC),
        # a vocab-parallel pick that takes every rank's columns as the
        # row's first ones (it ignores the rank's offset)
        "fault-vocab-offset": _case("qwen2.5-14b", "stream4",
                                    policy="fp32", **DEC),
        # decisions that read a clock, with rank 1's own clock running a
        # thousand times fast: SLO eviction under the deadline policy
        # (an SLO no request reaches on rank 0's clock), and an open-loop
        # driver's Poisson arrivals
        "clock-slo": _case("qwen2.5-14b", "stream4",
                           sched_policy="arrival-deadline", slo_ms=1e4,
                           **DEC),
        "clock-open-loop": _case("qwen2.5-14b", "stream4", **DEC),
        # rank 1's logits hold a NaN in its first slot at every decode step
        "nan-rank1": _case("qwen2.5-14b", "stream4", policy="fp32", **DEC),
    }
    # three slots, which do not divide over two data ranks: every data
    # rank holds and decodes all three
    out["fp32-b3"] = _case("qwen2.5-14b", "stream4", policy="fp32",
                           **{**DEC, "max_batch": 3})
    # each request through run_one, against the loop's stream
    out["one-fp32"] = _case("qwen2.5-14b", "stream4", one=True,
                            policy="fp32", **DEC)
    out["one-whisper"] = {**out["whisper"], "one": True}
    out["one-bert"] = {**out["bert"], "one": True}
    # two heads: on 1 x 4 attention in two head groups of two ranks
    out["whisper-h2"] = {**out["whisper"], "arch": "whisper-large-v3:h2"}
    out["bert-h2"] = {**out["bert"], "arch": "bert-large:h2"}
    # a scoring batch of two slots: one slot per data rank, whose pooler
    # product is then one row
    out["scoring-block1"] = _case("bert-large", "score5", policy="fp32",
                                  task="score", max_batch=2, max_len=16)
    for p in POLICIES:
        out[f"env-decoder-{p}"] = _case(
            "qwen2.5-14b", "stream3", policy=p, **DEC)
        out[f"env-scoring-{p}"] = _case(
            "bert-large", "score5", policy=p, task="score", max_batch=4,
            max_len=16)
        out[f"env-encdec-{p}"] = _case(
            "whisper-large-v3", "encdec5", policy=p, cache="paged",
            block_size=8, prefill_bucket=8, max_batch=4, max_len=32)
    return out


CASES = _cases()


def stream(vocab, spec, seed, prefix):
    """(prompt, max_new_tokens, frames) of the JAX tests'
    make_serving_requests (tests/conftest.py): a common prefix, then a
    tail per request, each a pure function of (seed, index)."""
    common = np.random.default_rng([seed, 999]).integers(
        5, vocab, size=prefix).astype(np.int32)
    return [(np.concatenate([common, np.random.default_rng([seed, i])
                             .integers(5, vocab, size=n).astype(np.int32)]),
             m, None) for i, (n, m) in enumerate(spec)]


def workload(name, arch):
    """The requests of a workload as (prompt, max_new_tokens, frames)."""
    from repro_torch.serving import (synthetic_encdec_requests,
                                     synthetic_scoring_requests)
    cfg = arch.cfg
    if name == "stream4":
        return stream(cfg.vocab, [(8, 5), (12, 6), (8, 4), (16, 5)], 2, 16)
    if name == "stream3":
        return stream(cfg.vocab, [(8, 5), (12, 6), (8, 4)], 2, 16)
    if name == "score5":
        reqs = synthetic_scoring_requests(5, cfg.vocab, prompt_len=12,
                                          seed=3)
    else:
        reqs = synthetic_encdec_requests(
            5, cfg.vocab, n_frames=cfg.n_frames, d_model=cfg.d_model,
            prompt_len=6, new_tokens=8, n_inputs=2, seed=4)
    return [(r.prompt, r.max_new_tokens, r.frames) for r in reqs]


def _requests(work):
    from repro_torch.serving import Request
    return [Request(prompt=p.copy(), max_new_tokens=n, frames=f)
            for p, n, f in work]


def host_state(engine):
    """What every rank's host loop must agree on at the end of a run: the
    scheduler's queue, slots and completions, every share's block tables
    and counters, and the picked tokens."""
    engines = getattr(engine, "replicas", [engine])
    out = []
    for e in engines:
        sched = e.scheduler
        st = {"queue": [t for t, _ in sched._queue],
              "active": sorted(sched.active), "free": list(sched._free),
              "completed": [r.rid for r in sched.completed],
              "tokens": [np.asarray(r.generated).tolist()
                         for r in sched.completed],
              "steps": e.steps_run, "preemptions": e.preemptions}
        pool = e.pool
        shards = getattr(pool, "shards", None)
        if shards is not None:
            st["tables"] = [[m.table.tolist() for m in
                             (s.values() if isinstance(s, dict) else [s])]
                            for s in shards]
            st["hits"] = (pool.shared_hits, pool.retained_hits,
                          pool.prefix_misses)
        out.append(st)
    return out


def pool_shapes(engine):
    """{leaf path: (local shape, bytes)} of the engine's pool cache (its
    float K/V leaves and arenas, and the integer bookkeeping)."""
    from repro_torch.serving.cache_pool import EncDecCachePool
    pool = engine.pool
    if pool is None:
        return {}
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif torch.is_tensor(t):
            out[path] = (tuple(t.shape), t.numel() * t.element_size())

    walk(pool.cache, "")
    if isinstance(pool, EncDecCachePool):
        out["n_local"] = pool.map.alloc.n_blocks - 1
    elif hasattr(pool, "n_local"):
        out["n_local"] = dict(pool.n_local)
    return out


@contextlib.contextmanager
def planted(fault, n_kv=None):
    """While active, the fault `fault` (None: none) is planted in the
    serving code; `n_kv` is the arch's global KV-head count."""
    if fault is None:
        yield
        return
    if fault == "fault-drop":
        from repro_torch.distributed import steps
        real = steps.gather_slots

        def dropping(picks, layout, mesh, **kw):
            picks = picks[:layout.block].clone()
            if layout.data_rank == layout.data - 1:
                picks[-1] = 0           # the last slot's token is lost
            return real(picks, layout, mesh, **kw)
        steps.gather_slots = dropping
        try:
            yield
        finally:
            steps.gather_slots = real
        return
    if fault == "fault-vocab-offset":
        from repro_torch.serving import sampler
        real = sampler.VocabCut.offset
        sampler.VocabCut.offset = lambda self, n: 0
        try:
            yield
        finally:
            sampler.VocabCut.offset = real
        return
    if fault.startswith("clock"):
        with fast_clock(1000.0 if dist.get_rank() == 1 else 1.0):
            yield
        return
    if fault == "nan-rank1":
        from repro_torch.configs.base import Arch
        real_decode = Arch.decode_step

        def poisoned(self, params, batch, cache):
            logits, cache = real_decode(self, params, batch, cache)
            if dist.get_rank() == 1:
                logits = logits.clone()
                logits[0] = float("nan")
            return logits, cache
        Arch.decode_step = poisoned
        try:
            yield
        finally:
            Arch.decode_step = real_decode
        return
    assert fault == "fault-global-kv", fault
    from repro_torch.kernels import paged_attention as pa
    real = pa.paged_attention_fused_plain

    def global_kv(q, k_new, v_new, k_arena, v_arena, pos, tables, q_pos,
                  cursor, **kw):
        # the local arena's heads tiled to the global count: the rank's
        # query heads then pair with the wrong KV heads, and the new rows
        # land in a copy
        rep = n_kv // k_arena.shape[-2]
        return real(q, k_new.repeat(1, 1, rep, 1),
                    v_new.repeat(1, 1, rep, 1), k_arena.repeat(1, 1, rep, 1),
                    v_arena.repeat(1, 1, rep, 1), pos, tables, q_pos,
                    cursor, **kw)
    pa.paged_attention_fused_plain = global_kv
    try:
        yield
    finally:
        pa.paged_attention_fused_plain = real


@contextlib.contextmanager
def fast_clock(rate):
    """While active, time.perf_counter runs `rate` times fast."""
    import time
    real = time.perf_counter
    t0 = real()
    time.perf_counter = lambda: t0 + (real() - t0) * rate
    try:
        yield
    finally:
        time.perf_counter = real


def reduced(arch_name):
    """The port's reduced arch (VARIANTS applied)."""
    import dataclasses
    from repro_torch.configs import reduced_arch
    base, over = VARIANTS.get(arch_name, (arch_name, {}))
    arch = reduced_arch(base)
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg,
                                                             **over))


def case_arch(name):
    return reduced(CASES[name]["arch"])


def run_case(name, params, mesh=None, device="cpu"):
    """One case on a fresh engine (on `mesh`, or one device): {"tokens",
    "params" (the engine's param shapes), "embeddings", "state",
    "shapes", "report", "launches"}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import (ContinuousEngine, OpenLoopDriver,
                                     ReplicaRouter, make_spec_pair,
                                     poisson_arrivals)
    case = CASES[name]
    arch = case_arch(name)
    kw = dict(case["kw"])
    params = params[case["arch"]]
    reqs = _requests(workload(case["work"], arch))
    if name == "spec":
        params, darch, dparams = make_spec_pair(arch, params)
        kw["spec_draft"] = (darch, dparams)
    fault = (name if name.startswith(("fault", "clock", "nan"))
             and mesh is not None else None)
    with planted(fault, arch.heads[1]):
        if name == "router":
            engine = ReplicaRouter([ContinuousEngine(arch, params, mesh=mesh,
                                                     **kw) for _ in range(2)],
                                   policy="prefix")
        else:
            engine = ContinuousEngine(arch, params, mesh=mesh, **kw)
        pa.paged_attention_fused.launches = 0
        if case["one"]:
            for r in reqs:
                engine.run_one(r)
        elif name == "clock-open-loop":
            arrivals = poisson_arrivals(len(reqs), 10.0, seed=0)
            OpenLoopDriver(engine, reqs, arrivals,
                           time_fn=engine.clock).run()
        else:
            engine.run(reqs)
    launches = pa.paged_attention_fused.launches
    first = getattr(engine, "replicas", [engine])[0]
    from repro_torch.core.optim.base import tree_items
    return {"tokens": [np.asarray(r.generated) for r in reqs],
            "params": {path: tuple(t.shape)
                       for path, t in tree_items(first.params)},
            "embeddings": [None if r.embedding is None
                           else np.asarray(r.embedding) for r in reqs],
            "state": host_state(engine),
            "shapes": pool_shapes(first),
            "report": engine.report(1.0), "launches": launches,
            "steps": sum(e.steps_run for e in
                         getattr(engine, "replicas", [engine]))}


def run_rank(rank, world, store_path, layout, names, inputs_path, out_path,
             device="cpu"):
    torch.set_num_threads(1)
    backend = "gloo"
    if device == "cuda":
        from repro_torch import select_device
        select_device("cuda")
        torch.cuda.set_device(rank)
        device, backend = f"cuda:{rank}", "nccl"
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data=layout["data"], model=layout["model"],
                               device=device.split(":")[0])
        params = to_device(torch.load(inputs_path), device)
        out = {name: parsed_meshes() if name == "parse_mesh"
               else run_case(name, params, mesh, device) for name in names}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def run_pick_rank(rank, world, store_path, inputs_path, out_path):
    """One rank of the vocab-parallel pick tests
    (test_torch_vocab_picks.py): each sampler of the inputs picks from
    this rank's columns of the whole rows, over a gloo group of `world`
    ranks, with and without the offset fault; records the picks, the
    non-finite flag and the largest tensor a greedy or stable pick
    gathered."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.distributed import partial
        from repro_torch.serving import sampler as smp
        inputs = torch.load(inputs_path, weights_only=False)
        logits = inputs["logits"]
        n = logits.shape[-1] // world
        local = logits[:, rank * n:(rank + 1) * n].contiguous()
        cut = smp.VocabCut(dist.group.WORLD, rank, world)
        real = partial.all_gather_dim
        widest = {"numel": 0}

        def recording(t, dim, group):
            widest["numel"] = max(widest["numel"], t.numel())
            return real(t, dim, group)
        out = {"picks": {}, "widest": {}}
        for spec in inputs["samplers"]:
            s = smp.Sampler.parse(spec)
            widest["numel"] = 0
            partial.all_gather_dim = recording
            try:
                out["picks"][spec] = s.sample(local, inputs["keys"], cut)
            finally:
                partial.all_gather_dim = real
            out["widest"][spec] = widest["numel"]
        out["flag"] = int(smp.nonfinite(local, cut))
        out["own_flag"] = int(smp.nonfinite(local))
        with planted("fault-vocab-offset"):
            out["fault"] = smp.greedy(local, cut)
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def parsed_meshes():
    """{spec: mesh shape} of the serve CLI's parse_mesh on a two-rank
    group."""
    from repro_torch.launch.serve import parse_mesh
    return {spec: tuple(parse_mesh(spec).shape)
            for spec in ("2x1", "1x2", "2")}


def run_cli_rank(rank, world, store_path, argv, out_path):
    """The serve CLI (launch/serve.py:main) with `argv` on one rank of a
    `world`-rank gloo group; saves its report and tokens."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch import serve
        stats, done = serve.main(argv)
        torch.save({"report": stats,
                    "tokens": [np.asarray(r.generated) for r in done]},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def start(ctx, target, world, tmp, tag, *args, **kw):
    """`world` processes of `target`(rank, world, store, *args, out, **kw)
    from ctx, started."""
    procs = [ctx.Process(target=target, args=(
        r, world, str(tmp / f"store-{tag}"), *args, str(tmp / f"out-{tag}")),
        kwargs=kw) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, tmp, tag, timeout):
    """Every rank's results, after every rank exited 0 within `timeout`
    seconds (each join); a rank still alive is killed."""
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
    return [torch.load(tmp / f"out-{tag}.{r}", weights_only=False)
            for r in range(len(procs))]


def same_tokens(a, b) -> bool:
    """Two runs' token lists equal, request by request."""
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def ranks_agree(ranks, name) -> bool:
    """Every rank's host state and tokens of case `name` equal rank 0's."""
    first = ranks[0][name]
    return all(r[name]["state"] == first["state"]
               and same_tokens(r[name]["tokens"], first["tokens"])
               for r in ranks[1:])


LAYOUTS = {"2x1": dict(data=2, model=1), "1x2": dict(data=1, model=2),
           "2x2": dict(data=2, model=2), "1x4": dict(data=1, model=4)}
