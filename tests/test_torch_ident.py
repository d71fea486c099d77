"""The port's ``ident`` and its boundary probe against the JAX package, on
the CPU.

The reference's ``ident`` is a closure inside ``bench/chain_micro.py``
(``main``, :180-196); ``_reference_ident`` below is its body, copied, with
the closure's N, HW, HW, C taken from ``x`` and run in interpret mode.  On
the CPU the port's ``ident`` takes its plain version (``x.clone()``).
Tolerance: bit equality (a copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from feathercnn_tpu_torch.kernels import dispatch as kdispatch
from feathercnn_tpu_torch.kernels.ident import (STAGES, boundary_probe,
                                                ident, ident_plain)


def _reference_ident(x, chunk):
    """bench/chain_micro.py:180-196, interpret=True."""
    N, HW, _, C = x.shape
    q = N // chunk
    xs = x.reshape(q, chunk, HW, HW, C)

    def k(x_ref, o_ref):
        o_ref[0] = x_ref[0]

    out = pl.pallas_call(
        k, grid=(q,),
        in_specs=[pl.BlockSpec((1, chunk, HW, HW, C),
                               lambda i: (i, 0, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, chunk, HW, HW, C),
                               lambda i: (i, 0, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, chunk, HW, HW, C), x.dtype),
        interpret=True,
    )(xs)
    return out.reshape(N, HW, HW, C)


def test_ident_equals_pallas_interpret():
    """int8, bf16 and f32, chunk 1 and 2, odd sizes: bit-equal to the
    reference; a batch that is not a multiple of the chunk raises, as the
    reference's reshape would."""
    rng = np.random.default_rng(0)
    for dt, jdt in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        for n, hw, c, chunk in ((3, 5, 7, 1), (4, 7, 3, 2), (2, 9, 13, 2)):
            # int8 values in range; floats off the integers (both
            # frameworks round f32 to bf16 to nearest even)
            a = rng.integers(-127, 128, size=(n, hw, hw, c)).astype(
                np.float32) * (1.0 if dt == torch.int8 else 0.37)
            x = torch.from_numpy(a).to(dt)
            want = _reference_ident(jnp.asarray(a).astype(jdt), chunk)
            want = torch.from_numpy(
                np.array(want.astype(jnp.float32))).to(dt)
            got = ident(x, chunk)
            assert got.dtype == dt and got.data_ptr() != x.data_ptr()
            assert torch.equal(got, want), (dt, n, hw, c, chunk)
            assert torch.equal(ident_plain(x, chunk), want)
    x = torch.zeros(3, 2, 2, 4, dtype=torch.int8)
    for fn in (ident, ident_plain):
        with pytest.raises(ValueError, match="multiple of chunk=2"):
            fn(x, 2)
    # no fallback: off the CPU, ident launches its kernel or raises
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ident(torch.empty(2, 2, 2, 4, device="meta"), 2)


def test_boundary_probe_variants_agree(monkeypatch):
    """The probe at every stage's signature, batch 2: both variants give
    the same sum, which equals a numpy computation of the producer and
    consumer convs; ident runs once per probe, through the dispatcher."""
    calls = []
    orig = kdispatch.ident

    def rec(x, chunk=2):
        calls.append((tuple(x.shape), x.dtype, chunk))
        return orig(x, chunk)
    monkeypatch.setattr(kdispatch, "ident", rec)
    for stage, (hw, c, _, _) in STAGES.items():
        r = boundary_probe(stage, batch=2, chunk=2, device="cpu")
        assert r["sum_none"] == r["sum_ident"], r
        assert r["ms_none"] is None and r["ms_ident"] is None
        assert calls[-1] == ((2, hw, hw, c), torch.int8, 2)
        # the probe's int8 data: default_rng(0), x then the two weights
        rng = np.random.default_rng(0)
        x8 = rng.integers(-127, 128, size=(2, hw, hw, c), dtype=np.int8)
        win = rng.integers(-127, 128, size=(c, c), dtype=np.int8)
        wout = rng.integers(-127, 128, size=(c, c // 2), dtype=np.int8)
        acc = x8.reshape(-1, c).astype(np.float64) @ win.astype(np.float64)
        y = np.maximum(acc.astype(np.float32) * np.float32(1e-3 * 0.02), 0)
        q = np.clip(np.rint(y * np.float32(1 / 0.02)), -127, 127)
        q = q.reshape(2, hw, hw, c)[:, ::2, ::2, :].reshape(-1, c)
        out = q @ wout.astype(np.float64)
        # the probe sums f32 values in f32: within 1e-6 of the sum of |out|
        assert abs(r["sum_none"] - out.sum()) <= 1e-6 * np.abs(out).sum(), \
            (stage, r, out.sum())
    assert len(calls) == len(STAGES)
    with pytest.raises(ValueError, match="multiple of chunk"):
        boundary_probe(2, batch=3, chunk=2, device="cpu")
