"""Plain PyTorch building blocks of the references, in float32 with TF32
off, and the control's lower precision.

Nothing here imports the program. Parameters are flat dicts {path:
tensor} with the program's '/'-joined paths, so that the harness hands
the same weights to both sides and compares leaf by leaf.

`Prec` carries the precision the reference computes in: "fp32" (the
reference) or "fp8" (the control: every matrix product takes operands
rounded to float8 e4m3 in the forward pass and e5m2 for the gradient in
the backward pass, each scaled per tensor by its largest magnitude, as
fp8 training does, and accumulates in float32).
"""
from __future__ import annotations

import dataclasses
import math

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t, dtype, top):
    """t rounded to the float8 `dtype`, scaled per tensor so that its
    largest magnitude maps to `top`, and returned in float32."""
    if t.numel() == 0:
        return t.float()
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = fp8_round(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = fp8_round(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, gy):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(gy, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # broadcast batch dims of b (a weight shared by every row)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str = "fp32"

    def mm(self, a, b):
        """a @ b at this precision (float32 operands and result)."""
        if self.name == "fp32":
            return a @ b
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        raise ValueError(f"unknown precision {self.name!r}")

    def dense(self, x, w, b=None):
        y = self.mm(x, w)
        return y if b is None else y + b


FP32 = Prec("fp32")
FP8 = Prec("fp8")


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def rmsnorm(x, scale, eps):
    """x / rms(x) * (1 + scale): the scale stored as an offset from 1."""
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def log_softmax_pick(logits, labels):
    """log p(label) of each row of logits (..., V)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None])[..., 0]
