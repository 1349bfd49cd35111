"""What the fused optimizer wrappers share (kernels/lans.py: K1-K4,
kernels/lamb.py: K5-K6), the Python side of csrc/optim_common.cuh: the
operand types and their codes, the number of per-CTA partials of one
sum, the operand checks, the launch plumbing (pointers, the current
stream, the error check) and the guarded trust ratio of the plain
versions."""
from __future__ import annotations

import ctypes

import torch

GX_TYPES = (torch.float32, torch.bfloat16)    # g and x
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_PARTS = 1024   # per-CTA partials of one sum (optim_common.cuh kMaxCtas)


def trust_ratio(x_norm, u_sq, trust):
    """||x|| * rsqrt(u_sq) where u_sq > 0, else 1 (select, so a NaN u_sq
    gives 1); 1 wherever the trust flag is off."""
    one = torch.ones_like(x_norm)
    s = torch.where(u_sq > 0.0,
                    x_norm * torch.rsqrt(torch.clamp(u_sq, min=1e-38)), one)
    return torch.where(trust > 0.0, s, one)


def stand_in(t) -> bool:
    """True for a meta tensor or a fake one: the dry run's (launch/
    dryrun.py), on which a wrapper runs its kernel's stand-in (outputs of
    the kernel's shapes and dtypes, its cost charged to the tracer in
    force: launch/trace_cost.py) and neither the kernel nor its plain
    version."""
    if t.device.type == "meta":
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def charge(name, cost):
    """A stand-in's launch of kernel `name`, charged to the tracer in force
    at its (FLOPs, bytes) `cost`; the FLOPs are fp32 elementwise work."""
    from repro_torch.launch.trace_cost import charge_kernel
    flops, nbytes = cost
    charge_kernel(name, {"elementwise": flops}, nbytes)


def on_cuda(t, name) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {t.device}")
    return True


def check(name, t, device, dtypes, numel=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.ndim != 1 or (numel is not None and t.numel() != numel):
        raise ValueError(f"{name} must be 1-D with {numel} elements, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_operands(scalars, norms, g, m, v, x):
    """The 8-float scalars (and norms, unless None), g (unless None), m,
    v and x: flat, contiguous, of x's length, on x's device."""
    dev, n = x.device, x.numel()
    f32 = (torch.float32,)
    check("scalars", scalars, dev, f32, 8)
    if norms is not None:
        check("norms", norms, dev, f32, 8)
    if g is not None:
        check("g", g, dev, GX_TYPES, n)
    check("m", m, dev, f32, n)
    check("v", v, dev, f32, n)
    check("x", x, dev, GX_TYPES, n)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def check_max_parts(lib, fn_name, source):
    """Raise unless the library's partial count is MAX_PARTS."""
    fn = getattr(lib, fn_name)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    if fn() != MAX_PARTS:
        raise RuntimeError(f"csrc/{source} and kernels/optim_common.py "
                           f"disagree on the number of partials")
