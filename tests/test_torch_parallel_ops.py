"""The port's explicit parallel functions (``parallel/{tp,spatial,overlap}``)
against the reference's ``shard_map`` versions.

The port's functions run on 4 gloo ranks started by
``parallel.launch.spawn`` (each rank gets its shards of the same numpy
inputs, made from a seed); the reference's on the conftest's virtual CPU
mesh ``(1, 4)``.  float32 throughout; tolerance rtol 1e-5, atol 1e-5 (the
two frameworks sum a conv in different orders), except ``tp_conv_pair``:
two convs and a 4-way sum of partials of magnitude ~50 differ by a few
f32 ulps there, so it takes the reference's own bound for the pair
(rtol 1e-4, atol 1e-4, tests/test_parallel.py:54-55).  Few test items per file
(see tests/test_torch_kernels.py for why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from feathercnn_tpu.parallel import ShardingConfig as JSharding
from feathercnn_tpu.parallel import build_mesh as jbuild_mesh
from feathercnn_tpu.parallel.overlap import (allgather_matmul as j_agmm,
                                             matmul_reducescatter as j_mmrs)
from feathercnn_tpu.parallel.spatial import (halo_exchange as j_halo,
                                             spatial_conv2d as j_spatial)
from feathercnn_tpu.parallel.tp import (column_parallel_conv as j_col,
                                        row_parallel_conv as j_row,
                                        tp_conv_pair as j_pair)
from feathercnn_tpu_torch.parallel.launch import ops_rank, spawn

N = 4
TOL = dict(rtol=1e-5, atol=1e-5)
PAIR_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mesh():
    return jbuild_mesh(JSharding(mesh_shape=(1, N)))


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _held(outs, i, dim, ref, tol, what):
    """Case ``i``'s per-rank results joined along ``dim`` against ``ref``;
    with ``dim`` None every rank holds the whole result (each summed in
    its own ring order), and each is held."""
    parts = [o[i] for o in outs]
    for got in (parts if dim is None else [np.concatenate(parts, dim)]):
        np.testing.assert_allclose(got, np.asarray(ref), **tol,
                                   err_msg=what)


def test_tp_convs_match_shard_map(mesh):
    rng = np.random.default_rng(0)
    x = _f32(rng, 2, 8, 8, 16)
    w = _f32(rng, 3, 3, 16, 32)
    b = _f32(rng, 32)
    w1, b1 = _f32(rng, 1, 1, 16, 32), _f32(rng, 32)
    w2, b2 = _f32(rng, 3, 3, 32, 24), _f32(rng, 24)
    xr = _f32(rng, 2, 4, 4, 32)
    wr = _f32(rng, 1, 1, 32, 16)
    br = _f32(rng, 16)
    cases = [
        ("column_parallel_conv", (x, w, b), dict(pad=1), (None, 3, 0), 3),
        ("column_parallel_conv", (x, w, b), dict(pad=1, gather_output=True),
         (None, 3, 0), None),
        ("row_parallel_conv", (xr, wr, br), {}, (3, 2, None), None),
        ("row_parallel_conv", (xr, wr, br), dict(scatter_output=True),
         (3, 2, 0), 3),
        ("tp_conv_pair", (x, w1, b1, w2, b2), dict(pad2=1),
         (None, 3, 0, 2, None), None),
    ]
    outs = spawn(ops_rank, N, args=([c[:4] for c in cases],))
    J = [jnp.asarray(a) for a in (x, w, b, xr, wr, br, w1, b1, w2, b2)]
    x_, w_, b_, xr_, wr_, br_, w1_, b1_, w2_, b2_ = J
    want = [j_col(mesh, "model", x_, w_, b_, pad=1),
            j_col(mesh, "model", x_, w_, b_, pad=1, gather_output=True),
            j_row(mesh, "model", xr_, wr_, br_),
            j_row(mesh, "model", xr_, wr_, br_, scatter_output=True),
            j_pair(mesh, "model", x_, w1_, b1_, w2_, b2_, pad2=1)]
    for i, (case, ref) in enumerate(zip(cases, want)):
        tol = PAIR_TOL if case[0] == "tp_conv_pair" else TOL
        _held(outs, i, case[4], ref, tol, f"{case[0]} {case[2]}")


def test_spatial_matches_shard_map(mesh):
    """The halo exchange (edge ranks zero-padded), then the H-split conv at
    3x3 pad 1 with bias and ReLU, 5x5 pad 2, and the three stride-2 shapes
    (3x3 pad 1, 1x1 pad 0, 7x7 pad 3)."""
    import jax
    rng = np.random.default_rng(1)
    x = _f32(rng, 1, 16, 12, 8)
    w3, b3 = _f32(rng, 3, 3, 8, 8), _f32(rng, 8)
    x5, w5 = _f32(rng, 1, 16, 8, 4), _f32(rng, 5, 5, 4, 4)
    cases = [("halo_exchange", (x, 1, 2), {}, (1, None, None)),
             ("spatial_conv2d", (x, w3, b3), dict(pad=1, activation="relu"),
              (1, None, None)),
             ("spatial_conv2d", (x5, w5), dict(pad=2), (1, None))]
    strided = []
    for kh, pad in ((3, 1), (1, 0), (7, 3)):
        xs, ws = _f32(rng, 1, 16, 8, 4), _f32(rng, kh, kh, 4, 4)
        strided.append((xs, ws, pad))
        cases.append(("spatial_conv2d", (xs, ws), dict(stride=2, pad=pad),
                      (1, None)))
    outs = spawn(ops_rank, N, args=(cases,))
    halo = jax.shard_map(lambda v: j_halo(v, "model", 1, 2), mesh=mesh,
                         in_specs=P(None, "model"),
                         out_specs=P(None, "model"), check_vma=False)
    want = [halo(jnp.asarray(x)),
            j_spatial(mesh, "model", jnp.asarray(x), jnp.asarray(w3),
                      jnp.asarray(b3), pad=1, activation="relu"),
            j_spatial(mesh, "model", jnp.asarray(x5), jnp.asarray(w5),
                      pad=2)]
    want += [j_spatial(mesh, "model", jnp.asarray(xs), jnp.asarray(ws),
                       stride=2, pad=pad) for xs, ws, pad in strided]
    for i, (case, ref) in enumerate(zip(cases, want)):
        _held(outs, i, 1, ref, TOL, f"{case[0]} {case[2]}")


def test_ring_matmuls_match_shard_map(mesh):
    """``allgather_matmul`` with W whole and in its ``w_sharded_out`` form,
    and ``matmul_reducescatter``: rings of ``batch_isend_irecv``."""
    rng = np.random.default_rng(2)
    x, w, b = _f32(rng, 8, 32), _f32(rng, 32, 16), _f32(rng, 16)
    xr, wr = _f32(rng, 8, 32), _f32(rng, 32, 24)
    cases = [("allgather_matmul", (x, w, b), dict(activation="relu"),
              (1, None, None), None),
             ("allgather_matmul", (x, w, b),
              dict(activation="relu", w_sharded_out=True), (1, 1, 0), 1),
             ("matmul_reducescatter", (xr, wr), {}, (1, 0), 1)]
    outs = spawn(ops_rank, N, args=([c[:4] for c in cases],))
    want = [j_agmm(mesh, "model", jnp.asarray(x), jnp.asarray(w),
                   jnp.asarray(b), activation="relu"),
            j_agmm(mesh, "model", jnp.asarray(x), jnp.asarray(w),
                   jnp.asarray(b), activation="relu", w_sharded_out=True),
            j_mmrs(mesh, "model", jnp.asarray(xr), jnp.asarray(wr))]
    for i, (case, ref) in enumerate(zip(cases, want)):
        _held(outs, i, case[4], ref, TOL, f"{case[0]} {case[2]}")
