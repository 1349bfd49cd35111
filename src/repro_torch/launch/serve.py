"""Serving launcher of the port: decode of a decoder or encoder-decoder
arch through the continuous engine (paged or dense pool) or the static
baseline, and scoring or embedding with a bert arch, on CUDA unless
--device cpu.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --full --precision fp32 --attn-kernel paged --requests 8 \\
      --max-batch 4 --prompt-len 64 --new-tokens 32 --seed 0 \\
      --spec-draft self --spec-k 4 --sampler temperature=0.8,top_k=50
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --chunk-budget 8 --arrival-rate 50 --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch whisper-large-v3 --shared-inputs 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch bert-large --task score
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch gemma2-2b --full --attn-kernel paged --mesh 2x1

The flags and defaults are those of `repro.launch.serve`, plus
--device, and so are the flag-compatibility errors (`flag_errors`). It
generates the same synthetic request stream from --seed, builds random
weights from --seed with a torch.Generator on the device, serves the
stream and prints a JSON report (tokens/s, TTFT and ITL percentiles,
slot utilization, decode steps, preemptions, prefix-block hits, and
under --spec-draft the rounds and acceptance rate). --attn-kernel paged
runs the hand-written CUDA kernel for decode attention (its plain
PyTorch version on the CPU); xla runs the plain-torch gather. --cache
dense keeps per-slot rows; --engine static runs the padded lockstep
baseline in waves of --max-batch; --sampler samples with JAX's keys;
--spec-draft self|truncated arms speculative decoding with --spec-k
tokens per round. --chunk-budget N admits prompts chunk by chunk within
N tokens per step (chunked prefill; continuous engine, paged pool).
--arrival-rate R replays the stream as seeded open-loop Poisson traffic
at R requests/s (arrivals seeded by --seed) instead of submitting it all
up front, and adds goodput and SLO attainment against --ttft-slo-ms /
--itl-slo-ms to the report. --sched-policy arrival-deadline admits by
earliest deadline, prefix-affinity the first request whose leading
prompt block is warm in the pool. --replicas N (> 1) serves through a
ReplicaRouter over N engines that share one params tree on the device,
routed by --route-policy prefix (default) | depth | rr; the report then
has the fleet's counters and a per_replica list. Every decoder arch
serves: the dense ones, the MoE granite-moe-3b-a800m and grok-1-314b
(routed dropless), mamba2-130m and the hybrid jamba-1.5-large-398b
(their SSM state slot-resident); and every precision, --precision fp16
feeding fp16 queries to the kernel.
--arch whisper-large-v3 serves the encoder-decoder (synthetic frame
inputs; --shared-inputs N draws only N distinct inputs, whose cross
blocks same-input requests share in the arena); --arch bert-large
--task score|embed scores or embeds (--max-len defaults to
--prompt-len). --interpret (with --attn-kernel paged) runs the
kernel's plain PyTorch version on the card too, launching nothing.

--mesh DxM (2x1, 1x2, 2x2; a bare N is 1xN) serves on a mesh of D x M
ranks (serving/engine.py), with --replicas too (each replica on the
mesh): run it as D x M processes under `torchrun --nproc-per-node D*M`
(one card per rank with NCCL where there are enough cards, else all on
card 0 with gloo), or inside a process group the caller has set up.
Every rank builds the same weights from --seed, keeps its part of them
(its heads, ff columns, experts, vocab rows and Mamba heads where the
model axis divides them: distributed/sharding.py: serve_params) and
serves the same stream; rank 0 prints the report. A world of another size, or no
process group, exits with both counts: a mesh never serves on one
device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch import select_device
from repro_torch.configs import get_arch, reduced_arch
from repro_torch.metrics import MetricsLogger
from repro_torch.serving import (SLO, ContinuousEngine, OpenLoopDriver,
                                 ReplicaRouter, ServeEngine, aggregate,
                                 make_spec_pair,
                                 poisson_arrivals, slo_report,
                                 synthetic_encdec_requests,
                                 synthetic_requests,
                                 synthetic_scoring_requests)

# Flags that configure the continuous engine's PAGED pool (or features
# built on it), as in repro.launch.serve: each fails under --engine
# static or --cache dense, where what it configures does not exist.
PAGED_ONLY_FLAGS = (
    ("--growth", lambda a: a.growth is not None),
    ("--slots-budget", lambda a: a.slots_budget != 0),
    ("--retain-blocks", lambda a: a.retain_blocks is not None),
    ("--watermark", lambda a: a.watermark != 0),
    ("--chunk-budget", lambda a: a.chunk_budget is not None),
    ("--spec-draft", lambda a: a.spec_draft != "none"),
    ("--spec-k", lambda a: a.spec_k is not None),
    ("--replicas", lambda a: a.replicas != 1),
    ("--route-policy", lambda a: a.route_policy is not None),
    ("--attn-kernel paged", lambda a: a.attn_kernel == "paged"),
    ("--interpret", lambda a: a.interpret),
)

# Flags of the continuous engine's scheduler/traffic loop: valid with
# either cache, invalid under --engine static (no scheduler there).
CONTINUOUS_ONLY_FLAGS = (
    ("--sched-policy", lambda a: a.sched_policy != "fifo"),
    ("--slo-ms", lambda a: a.slo_ms is not None),
    ("--no-preempt", lambda a: not a.preempt),
    ("--arrival-rate", lambda a: a.arrival_rate is not None),
    ("--mesh", lambda a: a.mesh is not None),
)

def flag_errors(args) -> list:
    """Every flag-compatibility error of this parse, in the JAX
    launcher's wording; one SystemExit lists them all."""
    errs = []
    paged = args.engine == "continuous" and args.cache == "paged"
    bad = [f for f, req in PAGED_ONLY_FLAGS if req(args) and not paged]
    if bad:
        errs.append(
            f"{' '.join(bad)}: only apply to the continuous engine's "
            f"paged pool (--engine continuous --cache paged)")
    if args.engine != "continuous":
        bad = [f for f, req in CONTINUOUS_ONLY_FLAGS if req(args)]
        if bad:
            errs.append(
                f"{' '.join(bad)}: only apply to the continuous "
                f"engine's scheduler (--engine continuous)")
    if paged and args.interpret and args.attn_kernel != "paged":
        errs.append(
            "--interpret: only applies to the Pallas kernel path "
            "(--attn-kernel paged)")
    return errs


def parse_mesh(spec, device="cpu"):
    """'DxM' (data x model) or a bare 'N' (1 x N) -> a mesh over the
    ranks of the process group (launch/mesh.py:make_local_mesh); None
    stays None (one device). A group of another size, or none, exits
    with a message that names both counts."""
    if spec is None:
        return None
    from repro_torch.launch.mesh import make_local_mesh
    low = str(spec).lower()
    data, model = low.split("x") if "x" in low else (1, low)
    data, model = int(data), int(model)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * model:
        raise SystemExit(
            f"--mesh {spec} needs {data * model} ranks, the process group "
            f"has {world}: run it under torchrun --nproc-per-node "
            f"{data * model}, or in a process group of that size")
    return make_local_mesh(data=data, model=model,
                           device=torch.device(device).type)


def kind_error(args, kind: str):
    """The JAX launcher's error for the first flag that does not fit the
    arch's family, in its wording; None when all fit."""
    if args.engine == "static" and kind != "decoder":
        return f"--engine static is decoder-only, got {kind}"
    if kind == "bert" and args.task == "generate":
        return (f"{args.arch} is a bert arch: pass --task score or --task "
                f"embed")
    if kind != "bert" and args.task != "generate":
        return f"--task {args.task} needs a bert arch, got {kind}"
    for flag, wrong in (
            ("--shared-prefix", args.shared_prefix and kind != "decoder"),
            ("--shared-inputs", args.shared_inputs and kind != "encdec")):
        if wrong:
            return f"{flag} does not apply to {kind} archs"
    return None


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--engine", choices=["continuous", "static"],
                    default="continuous")
    ap.add_argument("--task", choices=["generate", "score", "embed"],
                    default="generate")
    ap.add_argument("--shared-inputs", type=int, default=0)
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "bf16_compute", "fp16"],
                    help="inference precision policy (greedy always fp32)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", "--max-batch", dest="max_batch", type=int,
                    default=4, help="decode slot-pool size")
    ap.add_argument("--max-len", type=int, default=0,
                    help="KV pool length (0: prompt-len + new-tokens)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prefill-bucket", type=int, default=8,
                    help="round prompt lengths up to this multiple")
    ap.add_argument("--cache", choices=["paged", "dense"], default="paged",
                    help="paged: block arena + shared prompt prefixes; "
                         "dense: per-slot rows (the baseline)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged cache block granularity")
    ap.add_argument("--slots-budget", type=int, default=0,
                    help="size the paged arena for this many dense-"
                         "equivalent slots (0: max-batch)")
    ap.add_argument("--growth", choices=["lazy", "eager"], default=None,
                    help="lazy (default): allocate decode blocks on demand "
                         "and preempt on exhaustion; eager: reserve the "
                         "whole chain at admission")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=["fifo", "arrival-deadline", "prefix-affinity"])
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="finish any slot active longer than this early")
    ap.add_argument("--no-preempt", dest="preempt", action="store_false",
                    help="turn arena exhaustion into an error instead of "
                         "preempting a victim")
    ap.add_argument("--retain-blocks", type=int, default=None,
                    help="LRU bound on warm prefix blocks per attention "
                         "slot-type (default: one batch's worth; 0 "
                         "disables)")
    ap.add_argument("--watermark", type=int, default=0,
                    help="free blocks admission holds back per slot-type")
    ap.add_argument("--attn-kernel", choices=["xla", "paged"], default=None,
                    help="paged decode attention: 'paged' runs the "
                         "hand-written kernel, 'xla' the plain-torch "
                         "gather (token-identical). Default: the arch's")
    ap.add_argument("--interpret", action="store_true",
                    help="--attn-kernel paged through the kernel's plain "
                         "PyTorch version on any device (no launch)")
    ap.add_argument("--chunk-budget", type=int, default=None,
                    help="per-step token budget of chunked-prefill "
                         "admission: prompts prefill chunk by chunk in "
                         "the decode loop's spare capacity (continuous "
                         "engine + paged cache only; token-identical to "
                         "whole-prompt prefill)")
    ap.add_argument("--spec-draft", default="none",
                    choices=["none", "self", "truncated"],
                    help="speculative draft-verify decode: 'self' drafts "
                         "with the target itself, 'truncated' doctors the "
                         "target's upper periods inert and drafts with its "
                         "first period (make_spec_pair; acceptance 1.0). "
                         "Continuous engine + paged cache only")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens proposed and verified per round "
                         "(>= 2; default 4)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a DxM mesh (a bare N: 1xN) of D*M "
                         "ranks, e.g. under torchrun --nproc-per-node")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--route-policy", default=None,
                    choices=["prefix", "depth", "rr"])
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrival rate in requests/s: "
                         "submit on the arrival clock instead of all up "
                         "front, and report goodput/SLO attainment "
                         "(continuous engine only; default closed loop)")
    ap.add_argument("--ttft-slo-ms", type=float, default=1000.0,
                    help="open-loop TTFT bound (submit -> first token)")
    ap.add_argument("--itl-slo-ms", type=float, default=200.0,
                    help="open-loop bound on every inter-token gap; one "
                         "violation disqualifies the whole stream")
    ap.add_argument("--sampler", default="greedy",
                    help="'greedy' or 'temperature=0.8,top_k=40,"
                         "top_p=0.95,seed=0' (temperature=0 == greedy; "
                         "add stable=1 for the bf16 tie-stable argmax)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common system-prompt tokens prepended to every "
                         "request (exercises prefix sharing)")
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for per-step latency")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, requests=None):
    """Parse `argv` (default: sys.argv), serve, print the JSON report.
    Returns (report dict, completed requests). `requests` (a list of
    Request) replaces the synthetic stream, e.g. a caller's own mix;
    the pool's length still comes from the flags."""
    args = build_parser().parse_args(argv)
    errs = flag_errors(args)
    if errs:
        raise SystemExit("; ".join(errs))
    try:
        engine, reqs, log, device = _build(args)
    except NotImplementedError as e:     # a feature not ported yet
        raise SystemExit(str(e)) from None
    if requests is not None:
        reqs = requests
    t0 = time.perf_counter()
    if args.engine == "continuous":
        if args.arrival_rate is not None:
            arrivals = poisson_arrivals(len(reqs), args.arrival_rate,
                                        seed=args.seed)
            wall = OpenLoopDriver(engine, reqs, arrivals,
                                  time_fn=engine.clock).run()
            stats = engine.report(wall)
            stats.update(slo_report(
                reqs, SLO(args.ttft_slo_ms, args.itl_slo_ms), wall))
        else:
            engine.run(reqs)
            stats = engine.report(time.perf_counter() - t0)
        done = engine.scheduler.completed
        first = engine.replicas[0] if args.replicas > 1 else engine
        attn_kernel = first.pool.attn_kernel if first.paged else "xla"
    else:
        for r in reqs:          # TTFT includes the inter-wave queue wait
            r.trace.mark_submit()
        for i in range(0, len(reqs), args.max_batch):
            engine.run_batch(reqs[i:i + args.max_batch])
        stats = aggregate([r.trace for r in reqs], time.perf_counter() - t0,
                          sum(len(r.generated) for r in reqs))
        done, attn_kernel = reqs, "xla"
    stats.update(engine=args.engine, task=args.task,
                 precision=args.precision,
                 cache=args.cache if args.engine == "continuous"
                 else "static", attn_kernel=attn_kernel,
                 sampler=args.sampler, device=str(device),
                 mesh=args.mesh or "1x1")
    log.log(-1, **{k: v for k, v in stats.items()
                   if isinstance(v, (int, float))})
    log.close()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                          for k, v in stats.items()}))
    return stats, done


def _build(args):
    """(engine, requests, metrics logger, device) for the parsed flags."""
    arch = reduced_arch(args.arch) if args.reduced else get_arch(args.arch)
    err = kind_error(args, arch.kind)
    if err:
        raise SystemExit(err)
    device = select_device(args.device)
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import join_launched_group
        device = join_launched_group(device)
        mesh = parse_mesh(args.mesh, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = arch.init(gen)
    if arch.kind == "bert":          # scoring holds no decode budget
        max_len = args.max_len or args.prompt_len
    else:
        max_len = args.max_len or (args.prompt_len + args.new_tokens)
    if arch.kind == "encdec":
        reqs = synthetic_encdec_requests(
            args.requests, arch.cfg.vocab, n_frames=arch.cfg.n_frames,
            d_model=arch.cfg.d_model, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens,
            n_inputs=args.shared_inputs or None, seed=args.seed)
    elif arch.kind == "bert":
        reqs = synthetic_scoring_requests(
            args.requests, arch.cfg.vocab, prompt_len=args.prompt_len,
            seed=args.seed)
    else:
        reqs = synthetic_requests(args.requests, arch.cfg.vocab,
                                  prompt_len=args.prompt_len,
                                  new_tokens=args.new_tokens,
                                  seed=args.seed,
                                  shared_prefix=args.shared_prefix)
    max_len += args.shared_prefix
    if args.cache == "paged" and arch.kind == "decoder":
        # arena rows come in whole blocks
        max_len = -(-max_len // args.block_size) * args.block_size
    log = MetricsLogger(args.metrics)
    if args.engine == "static":
        engine = ServeEngine(arch, params, max_len=max_len,
                             policy=args.precision, sampler=args.sampler)
        return engine, reqs, log, device

    spec_kw = {}
    spec_k = args.spec_k if args.spec_k is not None else 4
    if args.spec_draft == "self":
        spec_kw = dict(spec_draft=(arch, params), spec_k=spec_k)
    elif args.spec_draft == "truncated":
        params, draft_arch, draft_params = make_spec_pair(arch, params)
        spec_kw = dict(spec_draft=(draft_arch, draft_params), spec_k=spec_k)
    last = {"t": time.perf_counter()}

    def make_on_step(replica):
        def on_step(rec):
            now = time.perf_counter()
            log.log(rec["step"], active=rec["active"], queued=rec["queued"],
                    preemptions=rec["preemptions"],
                    step_latency_ms=(now - last["t"]) * 1e3,
                    replica=replica)
            last["t"] = now
        return on_step

    def make_engine(replica):
        return ContinuousEngine(
            arch, params, max_batch=args.max_batch, max_len=max_len,
            policy=args.precision, mesh=mesh,
            prefill_bucket=args.prefill_bucket,
            on_step=make_on_step(replica), cache=args.cache,
            block_size=args.block_size,
            slots_budget=args.slots_budget or None, sampler=args.sampler,
            attn_kernel=args.attn_kernel,
            kernel_interpret=args.interpret,
            growth=args.growth or "lazy",
            sched_policy=args.sched_policy, slo_ms=args.slo_ms,
            preempt=args.preempt, retain_blocks=args.retain_blocks,
            watermark=args.watermark, chunk_budget=args.chunk_budget,
            task=args.task, **spec_kw)

    if args.replicas > 1:
        # the replicas share one params tree on the device
        engine = ReplicaRouter([make_engine(i) for i in range(args.replicas)],
                               policy=args.route_policy or "prefix")
    else:
        engine = make_engine(0)
    return engine, reqs, log, device


if __name__ == "__main__":
    main()
