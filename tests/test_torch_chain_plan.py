"""The float chain kernel's launch plan (``chain_plan``), on the CPU.

The CUDA kernel (``kernels/csrc/fused_chain_float.cu``) runs only on the
card; its plan is made on the host and held here: at ResNet-50's four
stage shapes at b128 in bf16 and f32 and at the ragged shapes that
``chip_smoke.py`` runs on the card, the variant, the tile, the tiles per
thread block, the ring's stages and the shared memory are what the kernel
takes, and an f32 block with Cm = 512 is refused.  Then the plan's tiling
of one block is emulated with plain PyTorch: each thread block's tiles,
conv1 over the tile's halo (0 outside the image, as the kernel writes
y1), conv2 over that halo, conv3 and the shortcut, stitched together,
against ``fused_chain_plain``.

Tolerance: equality.  The emulation sums every product in float64 and
rounds once to f32, as the plain version does, so only the cut into tiles
differs, and the halo's zeros make that exact.

The int8 kernel's plan (``chain_plan`` at ``itemsize`` 1,
``kernels/csrc/fused_chain.cu``) is held the same way: at the four stage
shapes (two tiles per thread block at stages 2-4, one whose columns the
two consumers split at stage 5), at the ragged shapes ``chip_smoke.py``
runs, and with each "mma_sync" reason; and its tiling of a two-block
chain (the column split included, conv2 per tap in f32 where Cm > 128) is
emulated and stitched against ``fused_chain_plain``, equal bit for bit:
the int8 sums are exact, and every rounding step is the plain version's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feathercnn_tpu_torch.kernels.fused_chain import (
    FLOAT_ADD_STEPS, INT8_VARIANTS, _SMEM_LIMIT, _f32, chain_plan,
    fused_chain_plain, int8_chain_smem, smem_bytes, tile_plan,
    wgmma_chain_smem)
from feathercnn_tpu_torch.numerics import fma_f32, requantize


def _check(p, n, h, w, c, cm, itemsize, case):
    tiles = n * -(-h // p.th) * -(-w // p.tw)
    assert p.th == p.tw and p.th in (7, 8), case
    pairs = -(-tiles // p.tiles_per_cta)
    assert p.grid == (min(pairs, 132) if p.variant == "wgmma" else pairs), \
        case
    assert p.smem <= _SMEM_LIMIT, case
    assert len(p.args()) == 7, case
    if p.variant == "wgmma":
        assert itemsize == 2 and c % 8 == 0 and cm % 8 == 0, case
        assert p.tiles_per_cta in (1, 2) and 2 <= p.stages <= 4, case
        assert (p.th + 2) * (p.tw + 2) <= 128 and p.th * p.tw <= 64, case
        assert p.smem == wgmma_chain_smem(p.tiles_per_cta, p.stages, p.th,
                                          p.tw, cm), case
        assert (p.kadd, p.carry) == FLOAT_ADD_STEPS[cm > 256], case
        assert not p.reason, case
        # two tiles only where no more fit, one only where two do not
        if p.tiles_per_cta == 1:
            assert all(wgmma_chain_smem(2, 2, t, t, cm) > _SMEM_LIMIT
                       for t in (7, 8)), case
        if p.stages < 4:
            assert wgmma_chain_smem(p.tiles_per_cta, p.stages + 1, p.th,
                                    p.tw, cm) > _SMEM_LIMIT, case
    else:
        assert p.variant == ("fma_f32" if itemsize == 4 else "mma_sync"), case
        assert p.reason and p.tiles_per_cta == 1, case
        assert p.smem == smem_bytes(p.th, p.tw, cm, itemsize), case


def test_chain_plan_at_resnet50_stages_and_ragged_shapes():
    """b128 at stages 2-5: bf16 takes "wgmma", two tiles per block but at
    stage 5 (Cm = 512), where one tile's y1 and y2 leave no room for a
    second, and 128 products per rounded add but at stage 5, 32 with the
    error carried; f32 takes "fma_f32" at stages 2-4 and is refused at
    stage 5.
    The ragged shapes plan the variant chip_smoke.py expects of them; a
    misaligned pointer takes "mma_sync" with its reason."""
    stages = [(56, 256, 64, 2), (28, 512, 128, 2), (14, 1024, 256, 2),
              (7, 2048, 512, 1)]
    for h, c, cm, per_cta in stages:
        p = chain_plan(128, h, h, c, cm, 2)
        assert p.variant == "wgmma" and p.tiles_per_cta == per_cta, (h, p)
        _check(p, 128, h, h, c, cm, 2, (h, "bf16"))
        if cm == 512:
            with pytest.raises(ValueError):
                chain_plan(128, h, h, c, cm, 4)
        else:
            _check(chain_plan(128, h, h, c, cm, 4), 128, h, h, c, cm, 4,
                   (h, "f32"))
    for (n, h, w, c, cm, itemsize) in [
            (2, 9, 11, 64, 32, 2), (1, 13, 9, 72, 144, 2),
            (1, 21, 7, 40, 24, 2), (1, 7, 33, 16, 8, 2),
            (1, 17, 20, 136, 56, 2), (2, 6, 5, 20, 12, 2),
            (1, 5, 7, 21, 10, 2), (3, 7, 7, 48, 144, 4),
            (2, 9, 11, 64, 32, 4), (2, 6, 5, 18, 6, 4),
            (2, 56, 56, 256, 64, 2), (3, 7, 7, 2048, 512, 2),
            (2, 14, 14, 1024, 256, 4)]:
        p = chain_plan(n, h, w, c, cm, itemsize)
        _check(p, n, h, w, c, cm, itemsize, (n, h, w, c, cm, itemsize))
    # tile counts that are not a multiple of the tiles per block
    assert chain_plan(1, 21, 7, 40, 24, 2).grid == 2
    assert chain_plan(3, 7, 7, 2048, 512, 2).grid == 3
    p = chain_plan(2, 9, 11, 64, 32, 2, aligned=False)
    assert p.variant == "mma_sync" and "aligned" in p.reason
    # the library builds the plan's two rounded-add steps, and only those
    src = (Path(__file__).resolve().parent.parent / "feathercnn_tpu_torch"
           / "kernels" / "csrc" / "fused_chain_float.cu").read_text()
    shipped = src.split("#ifdef FCNN_FLOAT_PROBE")[1].split("#else")[1]
    shipped = shipped.split("#endif")[0]
    built = {(int(k), c == "true") for k, c in
             re.findall(r"launch_wg<(\d+), (true|false)>", shipped)}
    assert built == set(FLOAT_ADD_STEPS)


def _mm(a, b):
    return (a.double() @ b.double()).float()


def _tiled_block(plan, x, w1, b1, w2, b2, w3, b3):
    """One block as the plan's persistent thread blocks compute it: each
    walks over pairs of tiles (block b takes pairs b, b + grid, ...), one
    tile per consumer."""
    n, h, w, c = x.shape
    cm = w1.shape[1]
    th, tw, k = plan.th, plan.tw, plan.tiles_per_cta
    tiles_w = -(-w // tw)
    per_img = -(-h // th) * tiles_w
    xp = F.pad(x, (0, 0, 1, tw + 1, 1, th + 1))     # zeros past the image
    inside = F.pad(torch.ones(1, h, w, 1), (0, 0, 1, tw + 1, 1, th + 1))
    out = torch.empty_like(x)
    pairs = [p for blk in range(plan.grid)
             for p in range(blk, -(-n * per_img // k), plan.grid)]
    assert sorted(pairs) == list(range(-(-n * per_img // k)))
    for pair in pairs:
        for cw in range(k):
            tile = pair * k + cw
            if tile >= n * per_img:
                continue
            img, r = divmod(tile, per_img)
            ty, tx = divmod(r, tiles_w)
            oh0, ow0 = ty * th, tx * tw
            halo = xp[img, oh0:oh0 + th + 2, ow0:ow0 + tw + 2]
            y1 = torch.clamp_min(_mm(halo.reshape(-1, c), w1) + b1, 0)
            y1 = (y1.reshape(th + 2, tw + 2, cm)
                  * inside[0, oh0:oh0 + th + 2, ow0:ow0 + tw + 2]
                  ).to(x.dtype)
            cols = torch.cat([y1[i:i + th, j:j + tw].reshape(-1, cm)
                              for i in range(3) for j in range(3)], 1)
            y2 = torch.clamp_min(_mm(cols, w2) + b2, 0).to(x.dtype)
            xs = xp[img, oh0 + 1:oh0 + th + 1, ow0 + 1:ow0 + tw + 1]
            o = torch.clamp_min(_mm(y2, w3) + b3
                                + xs.reshape(-1, c).float(), 0)
            o = o.to(x.dtype).reshape(th, tw, c)
            hh, ww = min(th, h - oh0), min(tw, w - ow0)
            out[img, oh0:oh0 + hh, ow0:ow0 + ww] = o[:hh, :ww]
    return out


def test_chain_plan_tiling_stitches_to_the_plain_version():
    """One bf16 block at small widths, on the plan's tiles (two per thread
    block, an odd tile count, H and W not multiples of the tile), equals
    fused_chain_plain bit for bit."""
    rng = np.random.default_rng(7)
    for (n, h, w, c, cm) in [(1, 21, 7, 40, 24), (2, 9, 11, 64, 32),
                             (1, 17, 20, 32, 16)]:
        def rnd(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.normal(size=shape) * scale).astype(np.float32))
        x = rnd(n, h, w, c).to(torch.bfloat16)
        ws = (rnd(1, c, cm, scale=c ** -0.5).to(torch.bfloat16),
              rnd(1, cm, scale=0.1),
              rnd(1, 9 * cm, cm, scale=(9 * cm) ** -0.5).to(torch.bfloat16),
              rnd(1, cm, scale=0.1),
              rnd(1, cm, c, scale=cm ** -0.5).to(torch.bfloat16),
              rnd(1, c, scale=0.1))
        plan = chain_plan(n, h, w, c, cm, 2)
        assert plan.variant == "wgmma" and plan.tiles_per_cta == 2, plan
        want = fused_chain_plain(x, *ws)
        got = _tiled_block(plan, x, *(t[0] for t in ws))
        assert torch.equal(got, want), ((n, h, w, c, cm), plan)


def _check_int8(p, n, h, w, c, cm, case):
    tiles = n * -(-h // p.th) * -(-w // p.tw)
    assert p.variant in INT8_VARIANTS and p.th == p.tw, case
    assert p.smem <= _SMEM_LIMIT and len(p.int8_args()) == 5, case
    if p.variant == "mma_sync":
        assert p.reason and p.tiles_per_cta == 1, case
        assert (p.th, p.tw) == tile_plan(h, w, cm, 1), case
        assert p.smem == smem_bytes(p.th, p.tw, cm, 1), case
        assert p.grid == tiles, case
        return
    assert c % 16 == 0 and cm % 16 == 0 and not p.reason, case
    assert (p.kadd, p.carry) == (0, False), case
    assert p.smem == int8_chain_smem(p.tiles_per_cta, p.stages, p.th, p.tw,
                                     cm), case
    assert p.grid == min(-(-tiles // p.tiles_per_cta), 132), case
    # two tiles a block only where the launch has four waves of pairs
    assert (p.tiles_per_cta == 2) == (tiles >= 8 * 132), case
    if p.stages < 4:
        assert int8_chain_smem(p.tiles_per_cta, p.stages + 1, p.th, p.tw,
                               cm) > _SMEM_LIMIT, case


def test_int8_chain_plan_at_resnet50_stages_and_ragged_shapes():
    """b128 int8 at stages 2-5: "wgmma", an 8x8 tile at stage 2 and 7x7
    after, two tiles per block at stages 2-3 (6,272 and 2,048 tiles) and
    one with the columns split at stages 4-5 (512 and 128 tiles: under 8 x
    132), 4, 4, 4 and 3 ring stages, a persistent grid; the other
    tiles-per-block plan, which chip_smoke.py times beside, fits too.  The
    ragged shapes chip_smoke.py runs plan their variant, and each
    "mma_sync" reason is given."""
    want = {56: (8, 2, 4, 132), 28: (7, 2, 4, 132), 14: (7, 1, 4, 132),
            7: (7, 1, 3, 128)}
    for h, c, cm in [(56, 256, 64), (28, 512, 128), (14, 1024, 256),
                     (7, 2048, 512)]:
        p = chain_plan(128, h, h, c, cm, 1)
        assert p.variant == "wgmma", (h, p)
        assert (p.th, p.tiles_per_cta, p.stages, p.grid) == want[h], (h, p)
        _check_int8(p, 128, h, h, c, cm, (h, "int8"))
        other = chain_plan(128, h, h, c, cm, 1, per_cta=3 - p.tiles_per_cta)
        assert other.variant == "wgmma" and other.smem <= _SMEM_LIMIT
        assert other.smem == int8_chain_smem(other.tiles_per_cta,
                                             other.stages, other.th,
                                             other.tw, cm)
    with pytest.raises(ValueError):
        chain_plan(128, 56, 56, 256, 64, 2, per_cta=1)   # float: no per_cta
    ragged = {(2, 9, 11, 64, 32): "wgmma",
              (1, 13, 9, 72, 144): "mma_sync", (3, 7, 7, 48, 144): "wgmma",
              (2, 8, 8, 40, 16): "mma_sync", (2, 6, 5, 24, 8): "mma_sync",
              (2, 15, 15, 256, 64): "wgmma", (1, 28, 28, 512, 128): "wgmma",
              (1, 7, 9, 2048, 512): "wgmma", (1, 5, 6, 24, 257): "mma_sync",
              (1, 5, 6, 32, 272): "wgmma", (3, 17, 20, 32, 48): "wgmma",
              (23, 56, 56, 64, 32): "wgmma", (2, 9, 9, 32, 48): "wgmma",
              (1, 7, 7, 256, 160): "wgmma"}
    for (n, h, w, c, cm), v in ragged.items():
        p = chain_plan(n, h, w, c, cm, 1)
        assert p.variant == v, ((n, h, w, c, cm), p)
        _check_int8(p, n, h, w, c, cm, (n, h, w, c, cm))
        if v == "mma_sync":
            assert p.reason == "C or Cm not a multiple of 16", p
    p = chain_plan(2, 9, 9, 32, 48, 1, aligned=False)
    assert p.variant == "mma_sync" and "aligned" in p.reason
    # 1,127 tiles: two a block, 564 work items over 132 blocks, the last
    # item's second consumer past the last tile; 27 tiles: one a block
    p = chain_plan(23, 56, 56, 64, 32, 1)
    assert (p.tiles_per_cta, p.grid, 23 * 49 % 2) == (2, 132, 1), p
    p = chain_plan(3, 17, 20, 32, 48, 1)
    assert (p.tiles_per_cta, p.grid) == (1, 27), p


def _int8_tiled_block(plan, j, nb, x, w1, b1, w2, b2, w3, b3, ws, sc,
                      out_dtype):
    """Block j of an int8 chain as the plan's persistent thread blocks
    compute it: each walks over its work items (block b takes b, b + grid,
    ...); an item is two tiles, one per consumer, or one tile whose column
    passes the two consumers take in turn (64 columns a pass for conv1,
    64 or 128 for conv2, 128 for conv3).  conv1 runs over the tile's halo
    and writes 0 where the halo leaves the image; conv2 sums per tap in
    f32 where Cm > 128."""
    n, h, w, c = x.shape
    cm = w1.shape[1]
    th, tw, k = plan.th, plan.tw, plan.tiles_per_cta
    sx, sy1, sy2, r = sc
    w1s, w2s, w3s = ws
    tiles_w = -(-w // tw)
    per_img = -(-h // th) * tiles_w
    tiles = n * per_img
    items = -(-tiles // k)
    xp = F.pad(x, (0, 0, 1, tw + 1, 1, th + 1))
    inside = F.pad(torch.ones(1, h, w, 1), (0, 0, 1, tw + 1, 1, th + 1))
    bn2 = 64 if cm <= 64 else 128

    def passes(cols, width, cw):
        """The column slices consumer cw computes."""
        all_p = [slice(q, min(q + width, cols)) for q in range(0, cols, width)]
        return all_p if k == 2 else all_p[cw::2]

    out = torch.empty(x.shape, dtype=out_dtype)
    order = [i for b in range(plan.grid) for i in range(b, items, plan.grid)]
    assert sorted(order) == list(range(items))
    for item in order:
        for cw in range(2):
            tile = item * k + cw if k == 2 else item
            if tile >= tiles:
                continue
            img, rr = divmod(tile, per_img)
            ty, tx = divmod(rr, tiles_w)
            oh0, ow0 = ty * th, tx * tw
            halo = xp[img, oh0:oh0 + th + 2, ow0:ow0 + tw + 2].reshape(-1, c)
            keep = inside[0, oh0:oh0 + th + 2, ow0:ow0 + tw + 2].reshape(-1, 1)
            owners = range(2) if k == 1 else (cw,)
            y1 = torch.zeros(halo.shape[0], cm, dtype=torch.int8)
            for o in owners:
                for cs in passes(cm, 64, o):
                    a = fma_f32(_mm(halo, w1[:, cs]), w1s[cs] * _f32(sx),
                                b1[cs])
                    y1[:, cs] = requantize(torch.clamp_min(a, 0),
                                           1.0 / sy1) * keep.to(torch.int8)
            y1 = y1.reshape(th + 2, tw + 2, cm)
            taps = [y1[i:i + th, jj:jj + tw].reshape(-1, cm)
                    for i in range(3) for jj in range(3)]
            y2 = torch.zeros(th * tw, cm, dtype=torch.int8)
            for o in owners:
                for cs in passes(cm, bn2, o):
                    if cm <= 128:
                        a = _mm(torch.cat(taps, 1), w2[:, cs])
                    else:
                        a = torch.zeros(th * tw, cs.stop - cs.start)
                        for t, tp in enumerate(taps):
                            a = a + _mm(tp, w2[t * cm:(t + 1) * cm, cs])
                    y2[:, cs] = requantize(torch.clamp_min(
                        fma_f32(a, w2s[cs] * _f32(sy1), b2[cs]), 0), 1.0 / sy2)
            xs = xp[img, oh0 + 1:oh0 + th + 1, ow0 + 1:ow0 + tw + 1]
            xs = xs.reshape(-1, c).float()
            o_t = torch.empty(th * tw, c, dtype=out_dtype)
            for o in owners:
                for cs in passes(c, 128, o):
                    t3 = fma_f32(_mm(y2, w3[:, cs]), w3s[cs] * _f32(sy2),
                                 b3[cs])
                    if j == 0:
                        v = fma_f32(xs[:, cs], _f32(sx), t3)
                    else:
                        v = t3 + xs[:, cs] * _f32(sx)
                    v = torch.clamp_min(v, 0)
                    o_t[:, cs] = (requantize(v, r) if out_dtype == torch.int8
                                  else v.to(out_dtype))
            o_t = o_t.reshape(th, tw, c)
            hh, ww = min(th, h - oh0), min(tw, w - ow0)
            out[img, oh0:oh0 + hh, ow0:ow0 + ww] = o_t[:hh, :ww]
    return out


def test_int8_chain_plan_tiling_stitches_to_the_plain_version():
    """Two-block int8 chains at small widths on the int8 plan's tiles: one
    tile per block with the column split (ragged tile counts, Cm = 48 with
    an odd number of conv1 passes, Cm = 144 > 128 with per-tap f32 sums,
    C = 160 with a half conv3 pass), and two tiles per block (an odd tile
    count, more work items than the grid's blocks); the int8 edge between
    the blocks and the last block's int8, bf16 or f32 output all equal
    fused_chain_plain bit for bit."""
    rng = np.random.default_rng(11)
    cases = [((2, 9, 11, 64, 48), torch.bfloat16),
             ((1, 10, 9, 32, 144), torch.float32),
             ((1, 7, 8, 160, 32), torch.int8),
             ((22, 49, 49, 32, 16), torch.int8)]
    for (n, h, w, c, cm), out_dtype in cases:
        nb = 2

        def i8(*shape):
            return torch.from_numpy(
                rng.integers(-127, 128, size=shape).astype(np.int8))

        def f32(*shape, lo, hi):
            return torch.from_numpy(
                rng.uniform(lo, hi, size=shape).astype(np.float32))
        x = i8(n, h, w, c)
        w1, w2, w3 = i8(nb, c, cm), i8(nb, 9 * cm, cm), i8(nb, cm, c)
        b1, b2 = f32(nb, cm, lo=-1, hi=1), f32(nb, cm, lo=-1, hi=1)
        b3 = f32(nb, c, lo=-1, hi=1)
        wsc = tuple(f32(nb, cols, lo=0.5e-3 / kk ** 0.5, hi=1.5e-3 / kk ** 0.5)
                    for kk, cols in ((c, cm), (9 * cm, cm), (cm, c)))
        sx = tuple(float(v) for v in rng.uniform(0.02, 0.05, nb))
        sy1 = tuple(float(v) for v in rng.uniform(5e-4, 2e-3, nb))
        sy2 = tuple(float(v) for v in rng.uniform(5e-4, 2e-3, nb))
        s_out = 0.05 if out_dtype == torch.int8 else None
        want = fused_chain_plain(x, w1, b1, w2, b2, w3, b3, wsc,
                                 (sx, sy1, sy2, s_out), out_dtype=out_dtype)
        plan = chain_plan(n, h, w, c, cm, 1)
        assert plan.variant == "wgmma", plan
        if n == 22:   # 1,078 tiles: 539 items over the 132 blocks
            assert plan.tiles_per_cta == 2 and plan.grid == 132, plan
        else:
            assert plan.tiles_per_cta == 1, plan
        act = x
        for j in range(nb):
            last = j == nb - 1
            r = _f32(1.0 / (sx[j + 1] if not last else (s_out or 1.0)))
            odt = out_dtype if last else torch.int8
            act = _int8_tiled_block(
                plan, j, nb, act, w1[j], b1[j], w2[j], b2[j], w3[j], b3[j],
                tuple(t[j] for t in wsc), (sx[j], sy1[j], sy2[j], r), odt)
        assert act.dtype == want.dtype
        assert torch.equal(act, want), ((n, h, w, c, cm), out_dtype, plan)
