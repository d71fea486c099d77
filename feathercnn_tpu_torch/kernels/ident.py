"""``ident``: an identity copy, and the boundary probe that runs it.

Counterpart of the Pallas kernel ``ident`` inside ``bench/chain_micro.py``
(``main``, :180-196, ``pallas_call`` at :187): a copy of ``x`` over
``N // chunk`` chunks of ``chunk`` images.  The chain probe's ``idctx``
mode puts it between a producer conv and a consumer conv to measure what
one more custom-kernel boundary costs; :func:`boundary_probe` does the same
here, and on the H100 measures what one more hand-kernel launch through
``ctypes`` costs between two kernels of a path.

On a CUDA tensor :func:`ident` launches the hand-written kernel in
``csrc/ident.cu`` (16-byte copies with a masked tail; bound by bytes); on a
CPU tensor it computes the same function with :func:`ident_plain`.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .matmul import gemm_layout

__all__ = ["ident", "ident_plain", "boundary_probe", "STAGES"]

# ResNet-50's identity-block signatures, as bench/chain_micro.py:19-20:
# stage -> (H = W, C, Cm, blocks)
STAGES = {2: (56, 256, 64, 2), 3: (28, 512, 128, 3),
          4: (14, 1024, 256, 5), 5: (7, 2048, 512, 2)}
_S = 0.02            # the probe's activation scale (chain_micro.py:60)


def _check(x: torch.Tensor, chunk: int) -> None:
    if x.dim() == 0 or chunk < 1 or x.shape[0] % chunk:
        raise ValueError(f"ident: the batch of x {tuple(x.shape)} must be a "
                         f"multiple of chunk={chunk} (the reference reshapes "
                         f"to (N // chunk, chunk, ...))")


def ident_plain(x: torch.Tensor, chunk: int = 2) -> torch.Tensor:
    """Plain PyTorch version: a copy of ``x``."""
    _check(x, chunk)
    return x.clone()


def ident(x: torch.Tensor, chunk: int = 2) -> torch.Tensor:
    """A copy of ``x`` (any type, contiguous, ``x.shape[0] % chunk == 0``),
    one grid row of the kernel per chunk of ``chunk`` images.  A CPU ``x``
    takes :func:`ident_plain`; a CUDA ``x`` launches the kernel or
    raises."""
    _check(x, chunk)
    if x.device.type == "cpu":
        return ident_plain(x, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    chunks = x.shape[0] // chunk
    if x.numel() == 0:
        return out
    if chunks > 65535:
        raise ValueError(f"ident: {chunks} chunks, the kernel's grid takes "
                         f"at most 65535")
    from .build import load_library
    rc = load_library().fcnn_ident(
        x.data_ptr(), out.data_ptr(), x.numel() * x.element_size() // chunks,
        chunks, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ident launch failed: CUDA error {rc} "
                           f"(x={tuple(x.shape)} {x.dtype} chunk={chunk})")
    ident.launches += 1
    return out


ident.launches = 0


def _device_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn`` (CUDA events), each run
    behind a spin kernel so that the first launch's host cost is hidden and
    any later launch the host issues too slowly shows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def boundary_probe(stage: int, batch: int = 128, chunk: int = 2,
                   device=None, reps: int = 20) -> dict:
    """``bench/chain_micro.py --what idctx`` (:150-204) at one stage's
    signature: int8 x (batch, H, W, C) from ``np.random.default_rng(0)``;
    the producer, a 1x1 C -> C int8 conv with ReLU and int8 requant; the
    consumer, a 1x1 stride-2 C -> C/2 int8 conv summed to f32.  Both run
    through ``matmul_epilogue``, as the port runs the reference's XLA int8
    1x1 convs; the second variant puts :func:`ident` between them.  Every
    kernel goes through the dispatcher.

    Returns the stage, shapes and both variants' sums (equal: ``ident`` is
    a copy) and, on a CUDA ``device`` with ``reps`` > 0, the median device
    ms of each variant over ``reps`` runs (otherwise None).  The sums come
    from one untimed run of each variant."""
    from . import dispatch
    hw, c = STAGES[stage][:2]
    if batch % chunk:
        raise ValueError(f"boundary_probe: batch {batch} is not a multiple "
                         f"of chunk {chunk}")
    device = torch.device(device if device is not None else "cuda")
    rng = np.random.default_rng(0)
    x8 = rng.integers(-127, 128, size=(batch, hw, hw, c), dtype=np.int8)
    win = rng.integers(-127, 128, size=(c, c), dtype=np.int8)
    wout = rng.integers(-127, 128, size=(c, c // 2), dtype=np.int8)
    x8, win, wout = (torch.from_numpy(a).to(device) for a in (x8, win, wout))
    win, wout = gemm_layout(win), gemm_layout(wout)
    w_scale = torch.full((c,), float(np.float32(1e-3 * _S)), device=device)

    def prod(a):
        y = dispatch.matmul_epilogue(a.reshape(-1, c), win, w_scale=w_scale,
                                     activation="relu", out_dtype=torch.int8,
                                     out_scale=1.0 / _S)
        return y.reshape(a.shape)

    def cons(a):
        a2 = a[:, ::2, ::2, :].contiguous().reshape(-1, c)
        return dispatch.matmul_epilogue(a2, wout,
                                        out_dtype=torch.float32).sum()

    def none():
        return cons(prod(x8))

    def with_ident():
        return cons(dispatch.ident(prod(x8), chunk))

    out = {"stage": stage, "batch": batch, "chunk": chunk,
           "x_shape": tuple(x8.shape), "sum_none": float(none()),
           "sum_ident": float(with_ident()), "ms_none": None,
           "ms_ident": None}
    if device.type == "cuda" and reps > 0:
        out["ms_none"] = _device_ms(none, reps)
        out["ms_ident"] = _device_ms(with_ident, reps)
    return out

