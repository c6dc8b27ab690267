"""Values whose derivative is that of a twin expression.

Two places need a value computed one way and differentiated another:

* the packs that emulate ``mc_tpu``'s jitted f32 arithmetic bit for bit
  (``term.fma_f32``'s exact fused multiply-add, ``sqrt_f32``'s correctly
  rounded root) compute on numpy scalars, which carry no derivative: their
  derivative is that of the plain torch expression of the same formula;
* the greeks that differentiate a kernel: the value is what the kernel
  computes, the derivative that of its plain PyTorch version on the same
  inputs (``engines.kernel_sums`` does this for the partials kernels).

``with_derivative_of(value, twin)`` returns ``value``'s bits with
``twin``'s derivative, in reverse mode (``torch.autograd``) and in forward
mode (``torch.autograd.forward_ad``), so a non-finite value cannot poison
the derivative as ``value + (twin - twin.detach())`` would.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["carries_derivative", "with_derivative_of", "f32", "primal"]


def carries_derivative(x) -> bool:
    """Whether ``x`` is a tensor that requires grad or carries a forward
    tangent."""
    return torch.is_tensor(x) and (
        x.requires_grad or fwAD.unpack_dual(x).tangent is not None)


class _ValueOf(torch.autograd.Function):
    """forward(value, twin) = value; the derivative is twin's."""

    @staticmethod
    def forward(value, twin):
        return value.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return None, grad

    @staticmethod
    def jvp(ctx, value_t, twin_t):
        return twin_t


def with_derivative_of(value: torch.Tensor, twin: torch.Tensor):
    """``value`` (no derivative of its own), carrying ``twin``'s derivative
    when ``twin`` has one; the two must agree in shape, dtype and device."""
    if not carries_derivative(twin):
        return value
    value = fwAD.unpack_dual(value).primal.detach()
    return _ValueOf.apply(value, twin)


def f32(v) -> torch.Tensor:
    """``v`` as a 0-d f32 tensor on the CPU: a float rounded once, a tensor
    converted with its autograd graph and forward tangent kept (the same
    bits either way)."""
    if torch.is_tensor(v):
        return v.to("cpu", torch.float32)
    return torch.tensor(float(v), dtype=torch.float32)


def primal(v) -> float:
    """The value of a float or 0-d tensor, without its derivative."""
    if torch.is_tensor(v):
        return float(fwAD.unpack_dual(v).primal.detach())
    return float(v)
