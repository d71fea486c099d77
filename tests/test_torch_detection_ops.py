"""The detection heads' ops of the PyTorch port — DetectionOutput, Proposal,
ROIPooling, PSROIPooling (fused and unfused), Normalize, PriorBox, the
exact greedy NMS (``kernels/nms.py``), the heads' f32 ``exp`` and the
Softmax on R-FCN's vote logits — against the JAX package on identical
tensors, on the CPU.

Both engines run the same one-op graphs (or the same numpy arrays go
through the reference's functions) on inputs made from a seed, with
planted ties.  Tolerances, with their reasons:

- equal, to the bit: the NMS keep masks (against all four of the
  reference's forms, with scores tied and IoUs exactly at the
  threshold); DetectionOutput's rows but their boxes (image, label, score
  and order) under each flag set the zoo bakes and the defaults, both
  ``share_location`` settings, f32 scores and bf16-valued scores with
  ties; Proposal's rows
  (their ROIs kept in the reference's order, deltas past ``exp``'s range
  included); ROIPooling (a max); PriorBox (the same numpy); the heads'
  ``exp_f32`` against ``jnp.exp`` on 423,012 inputs up to 88.3763 and
  the specials (inf, NaN, +-0, subnormals); on every f32 value of
  (88.3763, 88.7229), where the result passes 2.4e38 and XLA's step at
  the top exponent is not this one, within 6 ulp (a decoded box there is
  past any image);
- DetectionOutput's boxes: the reference's head compiled alone folds
  its constant ``pvar * pw`` before the product with the delta fuses into
  the add; compiled in a whole model it rounds ``pvar * delta`` instead,
  and the port follows the model (tests/test_torch_detection.py holds a
  model's boxes to the bit).  The centers are one rounding apart, so each
  coordinate within 2 ulp of its row's largest coordinate magnitude;
- PSROIPooling and its fused vote average: the reference sums each bin in
  an f32 einsum, the port in f64 rounded once, so f32 outputs within
  2^-20 of the output's largest magnitude (each bin sums at most ~100
  terms of one sign-mixed map), and bf16 outputs within 1 bf16 ulp of
  the larger value;
- Normalize: the sum of squares over 64 channels in another order than
  XLA's: f32 within 4 ulp of the larger value, bf16 within 1 bf16 ulp;
- the Softmax on logits of +-1e6 (R-FCN's vote logits at the zoo's random
  weights): no NaN, every probability within 2^-22 (f32) or 1 bf16 ulp
  (bf16) of the reference's, which puts a barrier after its upcast.

Few test items per file: see tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.kernels.nms import (greedy_nms_bitpack,
                                        greedy_nms_blocked,
                                        greedy_nms_fixpoint)
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels.nms import greedy_nms
from feathercnn_tpu_torch.ops.lowering import exp_f32
from feathercnn_tpu_torch.weights import graph_from_reference


def _bf16_values(a):
    """f32 array of the bf16 values nearest ``a``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _run_both(g, feed, **config):
    """Every output of ``g`` from the JAX engine and the port's, f32."""
    want = {k: np.asarray(v.astype(np.float32)) for k, v in
            JEngine(g, JConfig(**config)).run(feed).items()}
    got = {k: v.float().numpy() for k, v in
           Engine(graph_from_reference(g), EngineConfig(**config),
                  device="cpu").run(feed).items()}
    return want, got


def test_exp_and_nms_match_reference():
    """``exp_f32`` against ``jnp.exp`` (the module docstring's domain), and
    ``greedy_nms`` against the reference's four forms on integer-grid
    boxes (IoUs of small rationals: many exactly at 1/2 or 1/3, the
    thresholds), sorted by scores of 4 levels (many ties), at
    ``plus_one`` 0 and 1, over a batch of 3 x 2 slices."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-100, 88.3763, 300_000), rng.normal(0, 3, 100_000),
        np.linspace(-88.5, -87.0, 20_001), np.linspace(-1e-3, 1e-3, 2001),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 88.72283935546875,
         88.7229, 1e30]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp_f32(torch.from_numpy(x)).numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])
    # every f32 value of the top interval
    top = np.arange(np.float32(88.3763).view(np.int32),
                    np.float32(88.7229).view(np.int32) + 1,
                    dtype=np.int32).view(np.float32)
    d = np.abs(exp_f32(torch.from_numpy(top)).numpy().view(np.int32)
               - np.asarray(jax.jit(jnp.exp)(top)).view(np.int32))
    assert d.max() <= 6, int(d.max())

    k = 64
    lo = rng.integers(0, 6, size=(3, 2, k, 2))
    boxes = np.concatenate([lo, lo + rng.integers(1, 5, size=lo.shape)],
                           axis=-1).astype(np.float32)
    scores = rng.integers(0, 4, size=(3, 2, k)).astype(np.float32) / 4
    order = np.argsort(-scores, axis=-1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], axis=-2)
    valid = np.take_along_axis(scores, order, axis=-1) > 0
    n_keep = []
    for thresh in (0.5, 1 / 3, 0.45):
        for plus_one in (0.0, 1.0):
            mine = greedy_nms(torch.from_numpy(sb), torch.from_numpy(valid),
                              thresh, plus_one).numpy()
            forms = {
                "fixpoint": greedy_nms_fixpoint(sb, valid, thresh, plus_one),
                "bitpack": greedy_nms_bitpack(sb, valid, thresh, plus_one),
                "blocked": greedy_nms_blocked(sb, valid, thresh, plus_one,
                                              block=16)}
            for name, ref in forms.items():
                assert np.array_equal(mine, np.asarray(ref)), \
                    (name, thresh, plus_one)
            # unsorted rows, the reference's rank from the scores (ties by
            # position): the port's keep mask on the stably sorted rows,
            # put back in place
            ref = greedy_nms_bitpack(boxes, scores > 0, thresh, plus_one,
                                     scores=scores)
            back = np.empty_like(mine)
            np.put_along_axis(back, order, mine, axis=-1)
            assert np.array_equal(back, np.asarray(ref)), \
                ("scores", thresh, plus_one)
            n_keep.append(int(mine.sum()))
    print(f"NMS kept {n_keep} of {valid.sum()} candidates, equal to the "
          "reference's four forms")


def _det_graph(n, num_classes, share_loc):
    """PriorBox on two feature maps (4 and 6 priors a cell: 154 priors)
    concatenated, and a DetectionOutput reading ``loc`` and ``conf``
    inputs (rank 2: both engines keep them f32)."""
    b = JBuilder("det", seed=0)
    data = b.input("data", (n, 60, 60, 3))
    f1 = b.input("f1", (n, 5, 5, 4))
    f2 = b.input("f2", (n, 3, 3, 4))
    p1 = b.priorbox("p1", f1, data, [20.0], [40.0], [2.0])
    p2 = b.priorbox("p2", f2, data, [40.0], [60.0], [2.0, 3.0], clip=True,
                    step=20.0)
    pb = b.concat("priors", [p1, p2], axis=2)
    num_loc = 1 if share_loc else num_classes
    loc = b.input("loc", (n, 154 * num_loc * 4))
    conf = b.input("conf", (n, 154 * num_classes))
    out = b.detection_output("det", loc, conf, pb, num_classes,
                             nms_threshold=0.45, nms_top_k=50, keep_top_k=40,
                             confidence_threshold=0.05)
    b.graph.nodes[-1].attrs["share_location"] = share_loc
    return b.finish([out, pb])


# the zoo's bakes (feathercnn_tpu/models/zoo.py:1193, :1256-1258), the
# defaults and two other forms
DET_FLAGS = ({}, {"det_thresh_first": 512},
             {"topk_radix": False, "det_take_gather": True,
              "det_thresh_first": 1024},
             {"topk_radix": False}, {"topk_radix": False,
                                     "nms_blocked": False})


def test_detection_output_matches_reference():
    """DetectionOutput's rows under each flag set of ``DET_FLAGS`` (those
    with ``det_thresh_first`` once on scores sparse enough for the
    reference's threshold-first form, once on dense ones), with shared and
    per-class boxes, on f32 scores and on bf16-valued scores of 8 levels:
    equal to the reference's, and its priors too."""
    n, nc = 2, 6
    rng = np.random.default_rng(1)
    feed = {"data": np.zeros((n, 60, 60, 3), np.float32),
            "f1": np.zeros((n, 5, 5, 4), np.float32),
            "f2": np.zeros((n, 3, 3, 4), np.float32)}
    dense = rng.uniform(0, 1, size=(n, 154 * nc)).astype(np.float32)
    sparse = np.where(rng.uniform(size=dense.shape) < 0.12, dense,
                      dense * 0.04).astype(np.float32)
    tied = _bf16_values(np.round(dense * 8) / 8 * 0.9)
    scores = {"dense": dense, "sparse": sparse, "tied bf16": tied,
              "tied sparse": _bf16_values(np.where(sparse > 0.05, tied,
                                                   sparse))}
    kept, moved = {}, 0
    for share_loc in (True, False):
        g = _det_graph(n, nc, share_loc)
        loc = rng.normal(0, 1.5, size=(n, g.inputs["loc"].shape[1])).astype(
            np.float32)
        flags = DET_FLAGS if share_loc else DET_FLAGS[:3]
        for cfg in flags:
            jeng = JEngine(g, JConfig(**cfg))
            teng = Engine(graph_from_reference(g), EngineConfig(**cfg),
                          device="cpu")
            for what, conf in scores.items():
                f = dict(feed, loc=loc, conf=conf)
                want = {k: np.asarray(v) for k, v in jeng.run(f).items()}
                got = {k: v.numpy() for k, v in teng.run(f).items()}
                assert np.array_equal(got["priors"], want["priors"])
                w, t = want["det"], got["det"]
                case = (share_loc, cfg, what)
                assert np.array_equal(t[..., :3], w[..., :3]), case
                scale = np.abs(w[..., 3:]).max(-1, keepdims=True)
                assert (np.abs(t[..., 3:] - w[..., 3:])
                        <= 2 * np.spacing(scale)).all(), case
                kept[(share_loc, what)] = int((t[..., 1] >= 0).sum())
                moved += int((t[..., 3:] != w[..., 3:]).sum())
    print(f"rows equal under {len(DET_FLAGS)} flag sets, {moved} box "
          f"coordinates within 2 ulp; detections kept (share_location, "
          f"scores): {kept}")


def _two_stage_graph(n):
    """Proposal on (n, 20, 24) RPN maps (9 anchors, stride 16) with
    ``im_info``, then ROIPooling of a (n, 20, 24, 16) map and PSROIPooling
    (k = 3, 4 classes) of a (n, 20, 24, 36) map followed by its global AVE
    vote."""
    b = JBuilder("two_stage", seed=0)
    prob = b.input("prob", (n, 20, 24, 18))
    deltas = b.input("deltas", (n, 20, 24, 36))
    info = b.input("im_info", (n, 3))
    feat = b.input("feat", (n, 20, 24, 16))
    psmap = b.input("psmap", (n, 20, 24, 36))
    rois = b.proposal("rois", prob, deltas, info, pre_nms_top_n=300,
                      post_nms_top_n=60, min_size=16)
    pooled = b.roi_pooling("pool", feat, rois, 3, 4)
    ps = b.psroi_pooling("ps", psmap, rois, 4, 3)
    vote = b.pool("vote", ps, 0, mode="AVE", global_pooling=True)
    return b.finish([rois, pooled, vote])


# the ROI heads' TPU forms: the fused vote average, ROIPooling's mask form
# and its uncapped pyramid
ROI_FLAGS = ({}, {"psroi_fuse_ave": True}, {"roipool_table": False},
             {"roipool_full_pyramid": True})


def test_proposal_and_roi_pooling_match_reference():
    """Proposal's rows, ROIPooling and PSROIPooling with its vote average
    under each of ``ROI_FLAGS``, in f32 and bf16, batch 2 with an
    ``im_info`` row each (319 x 383, scale 1.5: ``im_w - 1`` is no bf16
    value; 250 x 301): fg scores of 6 levels (ties), deltas normal with 5%
    at +-4e5 (``exp`` overflows to inf; the clip brings the box to the
    image's edge), ``min_size`` filtering some boxes; every tolerance the
    module docstring's."""
    n = 2
    g = _two_stage_graph(n)
    rng = np.random.default_rng(2)
    shape = (n, 20, 24)
    deltas = rng.normal(0, 1, size=shape + (36,)).astype(np.float32)
    wild = rng.uniform(size=deltas.shape) < 0.05
    deltas = np.where(wild, rng.choice([-4e5, 4e5], size=deltas.shape),
                      deltas).astype(np.float32)
    feed = {"prob": _bf16_values(rng.integers(0, 6, size=shape + (18,))
                                 / 6),
            "deltas": deltas,
            "im_info": np.asarray([[319, 383, 1.5], [250, 301, 1.0]],
                                  np.float32),
            "feat": rng.normal(size=shape + (16,)).astype(np.float32),
            "psmap": (rng.normal(size=shape + (36,)) * 1e3).astype(
                np.float32)}
    for dt in ("float32", "bfloat16"):
        for cfg in ROI_FLAGS:
            want, got = _run_both(g, feed, compute_dtype=dt, **cfg)
            for k in ("rois", "pool"):
                assert np.array_equal(got[k], want[k]), (dt, cfg, k)
            w, t = want["vote"], got["vote"]
            err = np.abs(t - w)
            if dt == "float32":
                assert err.max() <= 2.0 ** -20 * np.abs(w).max(), (
                    cfg, float(err.max()))
            else:
                assert (err <= 2.0 ** -7 * np.maximum(np.abs(w), np.abs(t))
                        ).all(), (cfg, float(err.max()))
        rois = got["rois"]
        print(f"{dt}: {int((rois[:, 0] >= 0).sum())} of {len(rois)} ROIs "
              f"kept, {int((rois[:, 1:] == 0).all(-1).sum())} zero boxes, "
              f"rows and pooled features equal")


def test_normalize_priorbox_and_vote_softmax_match_reference():
    """Normalize (per pixel, and ``across_spatial``; with a learned scale
    per channel and a shared one), PriorBox with and without clip, flip
    and step, and the Softmax of logits of +-1e6 (R-FCN's vote logits),
    in f32 and bf16, against the JAX engine (the module docstring's
    tolerances)."""
    b = JBuilder("ssd_layers", seed=3)
    x = b.input("data", (2, 7, 9, 64))
    img = b.input("img", (2, 90, 120, 3))
    logits = b.input("logits", (2, 300, 21))
    outs = [b.normalize("norm", x, init_scale=20.0),
            b.normalize("norm_sp", x, across_spatial=True,
                        channel_shared=True, init_scale=3.0),
            b.priorbox("pb", x, img, [30.0], [60.0], [2.0, 3.0]),
            b.priorbox("pb_clip", x, img, [30.0, 50.0], [], [2.0], flip=False,
                       clip=True, step=13.0, offset=0.25),
            b.softmax("vote", logits)]
    g = b.finish(outs)
    g.params["norm/scale"] = np.random.default_rng(4).uniform(
        5, 25, size=64).astype(np.float32)
    rng = np.random.default_rng(5)
    feed = {"data": (rng.normal(size=(2, 7, 9, 64)) * 4).astype(np.float32),
            "img": np.zeros((2, 90, 120, 3), np.float32),
            "logits": (rng.normal(size=(2, 300, 21)) * 4e5).astype(
                np.float32)}
    feed["logits"][:, :5] = 0.0                      # whole rows tied
    for dt in ("float32", "bfloat16"):
        want, got = _run_both(g, feed, compute_dtype=dt)
        for k in ("pb", "pb_clip"):
            assert np.array_equal(got[k], want[k]), (dt, k)
        for k in ("norm", "norm_sp"):
            w, t = want[k], got[k]
            if dt == "float32":
                ulp = np.spacing(np.maximum(np.abs(w), np.abs(t)))
                assert (np.abs(t - w) <= 4 * ulp).all(), (dt, k)
            else:
                assert (np.abs(t - w) <= 2.0 ** -7 * np.maximum(
                    np.abs(w), np.abs(t))).all(), (dt, k)
        w, t = want["vote"], got["vote"]
        assert not np.isnan(t).any() and not np.isnan(w).any(), dt
        tol = 2.0 ** -22 if dt == "float32" else 2.0 ** -7
        assert (np.abs(t - w) <= tol * np.maximum(1.0, np.abs(w))).all(), (
            dt, float(np.abs(t - w).max()))
        print(f"{dt}: vote softmax {int((t == 1).sum())} ones, "
              f"{int((t == 0).sum())} zeros of {t.size}, max |diff| "
              f"{float(np.abs(t - w).max()):.3e}")
