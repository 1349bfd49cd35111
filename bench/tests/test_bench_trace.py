"""The trace reader on a hand-made Chrome trace: the stretch's union of
device intervals, its idle gaps named by the host's op, and each
kernel's metric tags from the Python frames around its launch."""
from bench.harness import trace

PY = "python_function"


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    ev("user_annotation", trace.STRETCH, 0, 100),
    ev(PY, "/x/src/repro_torch/distributed/steps.py(10): step_fn", 0, 90),
    ev(PY, "/x/src/repro_torch/models/attention.py(5): attn_apply", 5, 10),
    ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
    ev(PY, "/x/src/repro_torch/distributed/steps.py(20): update", 40, 30),
    ev(PY, "/x/src/repro_torch/kernels/lans.py(30): lans_phase1", 45, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 46, 1, correlation=2),
    ev("cpu_op", "aten::mm", 60, 15),
    ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=3),
    ev("kernel", "gemm", 10, 20, tid=7, correlation=1),
    ev("kernel", "lans_phase1_kernel", 50, 10, tid=7, correlation=2),
    ev("kernel", "ncclDevKernel_AllReduce", 55, 10, tid=8, correlation=3),
    ev("gpu_memcpy", "Memcpy HtoD", 200, 5, tid=7, correlation=4),
]


def test_timeline_unions_and_names_the_gaps():
    tl = trace.timeline(EVENTS)
    assert tl.window_us == 100
    assert tl.busy_us == 20 + 15          # [10, 30) and [50, 65)
    assert tl.remainder_us == 0
    # gaps [0, 10) and [30, 50) while Python ran, [65, 100) inside aten::mm
    gaps = {k: round(v * 1e6, 6) for k, v in tl.idle_by_host}
    assert gaps == {"host: aten::mm": 35, "host: python": 30}


def test_attribute_tags_by_enclosing_frames():
    mods = {"attention_fwd_ms": ("repro_torch/models/attention.py",),
            "lans_update_ms": ("repro_torch/distributed/steps.py:update",
                               "repro_torch/kernels/lans.py")}
    ops = {o.name: o for o in trace.attribute(EVENTS, mods)}
    assert ops["gemm"].tags == {"attention_fwd_ms"}
    assert ops["lans_phase1_kernel"].tags == {"lans_update_ms"}
    assert ops["ncclDevKernel_AllReduce"].tags == frozenset()
    assert ops["ncclDevKernel_AllReduce"].nccl
    assert "Memcpy HtoD" not in ops      # outside the stretch


def test_lans_roofline_reads_the_lans_kernels_alone():
    from bench.harness.train import Ctx
    from bench.metrics import lans_roofline
    opt = frozenset({"lans_update_ms"})
    ops = [trace.Op("void (anonymous namespace)::lans_phase1_kernel<float,"
                    " float>(float const*)", 0, 600, opt),
           trace.Op("void (anonymous namespace)::sq_norm_kernel<float>()",
                    0, 400, opt),
           trace.Op("vectorized_elementwise_kernel", 0, 3000, opt),
           trace.Op("lans_phase2_kernel", 0, 500)]   # not the optimizer's
    # 3.35e9 bytes at 3.35e12 B/s take 1 ms: the kernels' 1 ms a step
    ctx = Ctx(ops=ops, traced_steps=1, lans_bytes=3.35e9)
    assert abs(lans_roofline.read(ctx) - 100.0) < 1e-9
    ctx.ops = ops[2:]
    assert lans_roofline.read(ctx) is None
