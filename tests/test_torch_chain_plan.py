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
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feathercnn_tpu_torch.kernels.fused_chain import (
    FLOAT_ADD_STEPS, _SMEM_LIMIT, chain_plan, fused_chain_plain, smem_bytes,
    wgmma_chain_smem)


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
