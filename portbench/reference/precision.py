"""Lower precisions for the control of the output check.

The configurations state bfloat16 compute with float32 statistics. The
control is the reference computed one step lower, in float8 (e4m3, the
format fp8 inference uses): both operands of every matrix product and
convolution rounded to it with one scale per tensor (its largest magnitude
at e4m3's largest finite value, 448), products accumulated in float32; in
the train step each such operand's gradient is rounded to e5m2 likewise, as
float8 training carries its gradients.
"""

from __future__ import annotations

import torch

def _scaled(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to a float8 ``dtype`` with a per-tensor scale (its largest
    magnitude at the format's largest finite value), back in float32."""
    scale = largest / t.detach().abs().amax().float().clamp_min(1e-30)
    return (t.detach().float() * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: e4m3 going forward, the gradient in e5m2
    coming back."""

    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, 57344.0)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, back in float32;
    its gradient, where one is taken, rounded to e5m2 likewise."""
    return _Fp8.apply(t) if t.requires_grad else _scaled(t, torch.float8_e4m3fn, 448.0)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in float32, its gradient straight through."""
    return t + (t.detach().to(torch.bfloat16).float() - t).detach()


ROUNDINGS = {"float32": None, "bfloat16": round_bf16, "float8_e4m3": round_fp8}
