"""Collective/compute overlap: ring-pipelined collective matmuls —
counterpart of ``feathercnn_tpu/parallel/overlap.py``.

- ``allgather_matmul``: y = all_gather(x, K axis) @ W without holding the
  gathered x: each ring step multiplies the chunk that arrived while the
  next transfer is in flight.
- ``matmul_reducescatter``: y_shard = reduce_scatter(x @ W) chunk by
  chunk, each rank adding its part to the chunk travelling the ring.

Each step's transfer (``dist.start_exchange``: ``batch_isend_irecv``) is
issued before the step's ``torch.matmul`` and waited after it, so the
transfer and the product overlap where the backend runs them apart (NCCL
on its own stream; gloo on the host).  Per rank, with a process group in
place of the reference's ``(mesh, axis)``: the arrays are this rank's
shards under the reference's ``in_specs``.  The reference's ``batch_axis``
(x's M split over the data axis) has no argument here: each rank already
holds only its own rows of M, and the ring runs in the group it is given
(the engine gives its model group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .dist import start_exchange

__all__ = ["allgather_matmul", "matmul_reducescatter"]


def _ring(group):
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    me = dist.get_rank(group) if n > 1 else 0
    return n, me


def allgather_matmul(group, x, w, bias=None, activation=None,
                     w_sharded_out: bool = False):
    """``x`` (M, K/n) this rank's K chunk; ``w`` (K, N) whole, or with
    ``w_sharded_out`` (K, N/n) this rank's output columns (``bias`` its
    slice likewise: the Megatron column-parallel form the engine's TP path
    uses).  Returns y = x_all @ w (+ bias, ReLU): (M, N), or this rank's
    (M, N/n) with ``w_sharded_out``; in x's dtype, summed in f32."""
    n, me = _ring(group)
    kc = x.shape[-1]

    def w_rows(src):
        return w[src * kc:(src + 1) * kc].float()

    chunk = x
    xfer = None
    if n > 1:   # step 1's transfer is in flight during step 0's product
        xfer = start_exchange([(chunk, (me + 1) % n)],
                              [(chunk.shape, chunk.dtype, chunk.device,
                                (me - 1) % n)], group)
    acc = chunk.float() @ w_rows(me)
    for s in range(1, n):
        (chunk,) = xfer.wait()
        if s < n - 1:
            xfer = start_exchange([(chunk, (me + 1) % n)],
                                  [(chunk.shape, chunk.dtype, chunk.device,
                                    (me - 1) % n)], group)
        acc = acc + chunk.float() @ w_rows((me - s) % n)
    y = acc
    if bias is not None:
        y = y + bias.float()
    if activation == "relu":
        y = torch.clamp_min(y, 0)
    return y.to(x.dtype)


def matmul_reducescatter(group, x, w, bias=None):
    """``x`` (M, K/n) and ``w`` (K/n, N) this rank's K slices.  Returns
    this rank's (M, N/n) chunk of x_all @ w_all (+ its ``bias`` slice):
    each rank's partial product, ring-accumulated chunk by chunk (after
    n - 1 steps rank i holds its fully reduced chunk i)."""
    n, me = _ring(group)
    part = x.float() @ w.float()
    nc = part.shape[-1] // n

    def n_chunk(i):
        return part[:, i * nc:(i + 1) * nc]

    acc = n_chunk((me - 1) % n).contiguous()
    for s in range(1, n):
        xfer = start_exchange([(acc, (me + 1) % n)],
                              [(acc.shape, acc.dtype, acc.device,
                                (me - 1) % n)], group)
        nxt = n_chunk((me - 1 - s) % n)   # read while the chunk travels
        (acc,) = xfer.wait()
        acc = acc + nxt
    y = acc
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
