"""The arithmetic of the references: f32 with TF32 off, or the control's
fp8.

``Arith("f32")`` multiplies in float32 with TF32 off. ``Arith("fp8")``
is the control: every operand of every matrix product is rounded to
float8 e4m3 with one scale per tensor (its largest magnitude mapped to
448), and every gradient flowing back through such an operand to float8
e5m2 (largest magnitude mapped to 57344), the products then accumulated
in f32: the step below bfloat16 that a lower-precision path would take.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Arith:
    """``q(x)``: an operand of a matrix product in this arithmetic."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.kind == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor = None) -> torch.Tensor:
        y = self.q(x) @ self.q(w).T
        return y if b is None else y + b


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (not TF32) inside the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)
