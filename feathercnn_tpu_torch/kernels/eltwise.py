"""``eltwise_int8``: the int8-edge residual add (an Eltwise SUM whose
operands and output are int8 edges) in one pass.

Counterpart of the reference's int8 Eltwise, which is plain jnp
(``feathercnn_tpu/ops/lowering.py:1837-1851``, ``_lower_eltwise``'s
``eltwise_int8`` branch) and has no Pallas kernel: each int8 operand
dequantized by its scale, the sum in f32, the fused activation, then the
requantization to the output scale.  Compiled, the reference multiplies by
the f32 reciprocal of the output scale where its source divides by it
(XLA folds a division by a constant), and the port does the same
(``numerics.reciprocal``).

On a CUDA tensor :func:`eltwise_int8` launches the hand-written kernel in
``csrc/eltwise_int8.cu`` (whose header note says what bounds it on an H100
and what its design does about that), with the three scales as kernel
arguments (the output scale as its f32 reciprocal, ``inv``); on a CPU
tensor it computes the same function with :func:`eltwise_int8_plain`.
The dispatcher (``dispatch.eltwise_forward``) sends an int8-edge Eltwise
there when :func:`takes_kernel` holds for its operands (two int8 operands
of one shape), whatever their layout:
:func:`kernel_operands` passes each as it is where the kernel reads it so
(contiguous, or channel slices at a 16-byte pitch) and a contiguous copy
otherwise (a misaligned view, a row shard).
The forms the kernel does not compute (three operands, a float operand)
take :func:`eltwise_int8_sum`, counted in ``eltwise_int8.fallbacks``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..numerics import apply_activation, requantize, scale_tensor, sum_terms
from .matmul import _ACT_CODES

__all__ = ["eltwise_int8", "eltwise_int8_plain", "eltwise_int8_sum",
           "kernel_operands", "takes_kernel"]


def eltwise_int8_sum(xs: Sequence[torch.Tensor], scales, inv,
                     act: Optional[str] = None) -> torch.Tensor:
    """The int8-edge Eltwise in PyTorch ops, over any number of operands:
    each int8 operand dequantized by its scale and a float one taken as it
    is, summed left to right in f32 with each product fused into the add
    that consumes it (``numerics.sum_terms``, as the reference's
    compiled add contracts it), the activation ``act``, then
    ``clip(round_half_even(acc * inv), -127, 127)`` as int8, ``inv`` the
    f32 reciprocal of the output scale (``numerics.reciprocal``).  The
    scales and ``inv`` are the node's kept ``numerics.Scale`` values (or
    device tensors): no host sync."""
    dev = xs[0].device
    acc = sum_terms([(x.float(), scale_tensor(s, dev)
                      if x.dtype == torch.int8 else None)
                     for x, s in zip(xs, scales)])
    return requantize(apply_activation(acc, act), inv)


def eltwise_int8_plain(x0: torch.Tensor, x1: torch.Tensor, s0: float,
                       s1: float, inv: float,
                       act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: :func:`eltwise_int8_sum` of two operands,
    ``fma(x0, s0, x1 * s1)`` before the activation and the
    requantization."""
    return eltwise_int8_sum((x0, x1), (s0, s1), inv, act)


# the kernel's pitched form indexes 16-byte vectors with 32-bit rows and
# columns
_ROWS_MAX = 16 << 32


def row_pitch(x: torch.Tensor, c: int) -> Optional[int]:
    """The row pitch, in elements, at which the kernel reads ``x`` as it
    is, as rows of its ``c`` channels (the last dimension): ``c`` where x
    is contiguous; the row stride of a channel slice of a contiguous tensor
    (channels at unit stride, leading dimensions one row stride apart),
    where ``c`` and that stride are multiples of 16.  None where x is not
    16-byte aligned or not such rows (a row shard of a batch, a slice of
    channels not a multiple of 16): the kernel reads a copy of it."""
    if x.data_ptr() % 16:
        return None
    if x.is_contiguous():
        return c
    if c % 16 or x.stride(-1) != 1 or x.numel() >= _ROWS_MAX:
        return None
    lead = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    if any(s0 != s1 * n1 for (_, s0), (n1, s1) in zip(lead, lead[1:])):
        return None
    pitch = lead[-1][1]
    return pitch if pitch % 16 == 0 and pitch >= c else None


def takes_kernel(xs: Sequence[torch.Tensor]) -> bool:
    """Whether :func:`eltwise_int8` computes the int8-edge Eltwise of these
    operands: exactly two, both int8, of one shape, on one device.  Decides
    without launching; any layout goes (:func:`kernel_operands`)."""
    return (len(xs) == 2 and all(x.dtype == torch.int8 for x in xs)
            and xs[0].shape == xs[1].shape and xs[0].device == xs[1].device)


def kernel_operands(x0: torch.Tensor, x1: torch.Tensor):
    """``(x0, x1, c, ld0, ld1)`` as ``fcnn_eltwise_int8`` takes them, for
    two int8 operands of one shape: ``c`` 0 where both are contiguous (one
    flat pass), else rows of ``c`` channels at pitches ``ld0`` and ``ld1``
    (:func:`row_pitch`).  An operand the kernel cannot read as it is becomes
    a contiguous copy (a new allocation, 16-byte aligned), so that every
    such pair launches."""
    c = x0.shape[-1] if x0.dim() else 1
    xs, lds = [], []
    for x in (x0, x1):
        ld = row_pitch(x, c)
        if ld is None:
            x, ld = x.clone(memory_format=torch.contiguous_format), c
        xs.append(x)
        lds.append(ld)
    if xs[0].is_contiguous() and xs[1].is_contiguous():
        return xs[0], xs[1], 0, 0, 0
    return xs[0], xs[1], c, lds[0], lds[1]


def eltwise_int8(x0: torch.Tensor, x1: torch.Tensor, s0: float, s1: float,
                 inv: float, act: Optional[str] = None) -> torch.Tensor:
    """``clip(round_half_even(act(x0 * s0 + x1 * s1) * inv), -127, 127)``
    as int8, on two int8 tensors of one shape (``act``: None, "relu" or
    "relu6"), ``inv`` the f32 reciprocal of the output scale
    (``numerics.reciprocal``).  A CPU pair takes :func:`eltwise_int8_plain`; a
    CUDA pair, in any layout, launches the kernel (:func:`kernel_operands`);
    any other raises."""
    if x0.dtype != torch.int8 or x1.dtype != torch.int8:
        raise ValueError(f"eltwise_int8: int8 operands, got {x0.dtype} and "
                         f"{x1.dtype}")
    if x0.shape != x1.shape or x0.device != x1.device:
        raise ValueError(f"eltwise_int8: operands {tuple(x0.shape)} on "
                         f"{x0.device} and {tuple(x1.shape)} on {x1.device}"
                         f" differ")
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x0.device.type == "cpu":
        return eltwise_int8_plain(x0, x1, s0, s1, inv, act)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    out = torch.empty(x0.shape, dtype=torch.int8, device=x0.device)
    if out.numel() == 0:
        return out
    x0, x1, c, ld0, ld1 = kernel_operands(x0, x1)
    from .build import load_library
    rc = load_library().fcnn_eltwise_int8(
        x0.data_ptr(), x1.data_ptr(), out.data_ptr(), x0.numel(), c, ld0,
        ld1, float(s0), float(s1), float(inv), _ACT_CODES[act],
        torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eltwise_int8 launch failed: CUDA error {rc} "
                           f"(x={tuple(x0.shape)} act={act})")
    eltwise_int8.launches += 1
    return out


eltwise_int8.launches = 0
# int8-edge Eltwise nodes of the "cuda" backend in a form the kernel does
# not compute (takes_kernel false: three operands, a float operand), which
# took eltwise_int8_sum
eltwise_int8.fallbacks = 0
