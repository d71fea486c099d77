#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feathercnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and the models' input sizes on
the "cuda" backend, with seeded random weights.  The int8 paths are calibrated by the
port (``method="max"``) and run full int8 (``quant="w8a8"``) with bf16
float activations; the bf16 paths run ``quant=None`` in bf16:

- ResNet-50 at batch 128, then behind an ``InferenceServer``; then the
  same calibrated model written by ``save_ftpu`` to a temporary
  directory, reloaded by ``Engine.from_path`` through the native mmap
  loader (the port's C++ library, built at first use) and compiled
  (``compile(batch)``): its output equal to the built engine's
  (``torch.equal``), its ``summary(top=5)`` printed on one line; then the
  same file served by ``python -m feathercnn_tpu_torch.serve`` in a
  subprocess (``cli_http``): seeded uint8 pictures through the C++
  ``preprocess``, 32 ``.npy`` requests from 8 threads and 4 JSON ones,
  every answer equal to the engine's direct run at b128, ``/healthz`` and
  ``/metrics``; then ResNet-50 with ``s2d_stem`` (one SpaceToDepth, a 4x4
  s1 stem on 12 channels in cuDNN's float conv), its stem's device ms
  beside the 7x7 one's;
  then the same model sharded (``parallel_paths``, ``parallel/`` on
  ``torch.distributed``): written once by ``save_ftpu`` and loaded by each
  rank that ``parallel.launch.spawn`` starts, in a process group of one
  over NCCL (mesh (1, 1): bit-equal to the unsharded engine), DP x TP
  (2, 2) on 4 ranks and spatial (1, 2) on 2 ranks that share the card
  over gloo (every rank b128 in, the global output back; each rank's 33 +
  16 launches counted, held to their plain versions and to their plans'
  variants: the TP FC at N = 500 among them), DP x TP's rank 0 node by
  node, then a 2-stage ``PipelineEngine`` on ``cuda:0`` twice with 2
  micro-batches; each output against the unsharded engine's (top-1 equal
  on >= 99% of the images, prob cosine >= 0.9999), ms per batch per rank
  (the ranks time-share the card: not scaling figures), and rank 0's
  launches (the pipeline's) each timed alone on the card beside its
  bound, summed per kernel; then the tools (``tools_path``): the ResNet-50
  deploy of ``tools/deploys`` with its seeded synthetic caffemodel
  converted by the port's converter at b128; ``validate`` on 256 seeded
  ``.npy`` images (a bf16 fp leg, a w8a8 leg of 33 + 16 launches a
  forward, every launch of both held to its plain version); ``tune`` in
  bf16 (per conv signature: cuDNN's conv, B1/B2, Winograd) and
  ``tune_regions`` in w8a8 (the chain kernel against the per-layer path)
  baked into the file, which ``Engine.from_path`` reloads with both taken
  (its launches held to plain, its output bit-equal to an engine built
  with the same choices); ``tune_flags`` for one round; ``engine_loop`` +
  ``slope_time`` and ``layer_timings`` beside the main path's forward,
  ``trace``'s file, ``run_model`` on the tuned file, ``verify_gpu`` (the
  card against the port on the CPU: ResNet-50 w8a8 b4, cosine >= 0.995 and
  top-1 1.0; MobileNet-SSD on its pre-NMS tensors) and ``diff_blobs``
  (quant none against w8a8); two child processes with one fresh
  ``compilation_cache_dir``, the first building the kernels there, the
  second loading them unbuilt; and the int8 conv forms the port used to
  refuse (``CONV_FORM_CASES``: 3x3 at stride (1, 2) and (2, 1), a 1x1 at
  (2, 1), a group-32 conv with two outputs a channel, depthwise at stride
  3 and with ``act_segments``) at full width through the dispatcher, each
  launch counted, equal to plain and timed beside its bound and bf16
  ``F.conv2d(stride=(sh, sw), groups=g)``;
- MobileNet-v1 at batch 256 on its default route, where its 13 depthwise
  convs take the int8 depthwise kernel, and with the 13 ``*/dw`` layers
  overridden to "depthwise" (the float depthwise kernel, int8 in);
- MobileNet-v2 at batch 128 with its 17 ``*/dwise`` layers overridden to
  "depthwise" (bf16 in).  Its default route sends them to PyTorch's float
  grouped conv, as the reference leaves them to XLA's; the CPU tests cover
  it;
- ResNet-50 at batch 128 with ``fuse_chains=True`` and the wildcard region
  table ``meta["chain_regions"] = {"*": True}`` that ``bench.py
  --fuse-chains`` sets: its 12 identity blocks run as 4 chains (nb 2, 3, 5,
  2) through the fused-chain kernel, one launch per block;
- ResNet-50 at batch 128 in bf16 (``quant=None``, no calibration),
  unchained: its convs run in PyTorch's (cuDNN's) float conv, as the
  reference leaves float convs to XLA's, and its FC in the float variant of
  ``matmul_epilogue``.  It is the yardstick of the next path;
- the same in bf16 with ``fuse_chains`` and the wildcard region table: the
  12 identity blocks run as 3 chains (nb 2, 3, 5) and 2 single blocks at
  stage 5 through the float fused-chain kernel, one launch per block;
- the boundary probe (``kernels/ident.py``, the ``idctx`` mode of
  ``bench/chain_micro.py``) at ResNet-50's stages 2-5, b128: a producer and
  a consumer int8 1x1 conv with and without the ``ident`` copy between
  them;
- VGG-16 at batch 128 under weight-only int8 (``quant="w8"``, no
  calibration): its 12 3x3 convs after the float stem through
  ``conv2d_implicit_gemm`` and its 3 FCs through ``matmul_epilogue``, both
  on their "wgmma_w8" variant (bf16 x int8 weight); then with every ``conv*_*``
  layer named "winograd" in ``algo_overrides`` (``BASELINE.json:9``): its
  13 convs through ``kernels/winograd.py`` (PyTorch ops, as the
  reference's is plain jnp), each held against ``F.conv2d``, then the same
  in f32, its agreement alone; then full int8 (``"wgmma"``);
- GoogLeNet at batch 256, full int8 (``BASELINE.json:10``): int8 Concat
  and LRN edges, then behind an ``InferenceServer``;
- AlexNet at batch 256, full int8: its 2-group convs in PyTorch's float
  grouped conv (its baked ``int8_grouped=False``), norm2 on float edges;
  then the same with its float convs summed in f64, its agreement alone;
- SqueezeNet v1.1 at batch 1 in fp32 (``BASELINE.json:6``; cuDNN's f32
  convs, TF32 off, no hand kernel), then at batch 128 full int8
  (passthrough Concats);
- the rest of the classification zoo, full int8 at ``bench.py:58-81``'s
  batches (``ZOO_REST``): DenseNet-121 b128 (a standalone int8 Scale
  before each dense layer, int8 Concats, the growth-32 3x3 convs at
  N = 32), then the same with ``concat_dus`` (4 ladders, 54 appends that
  write into one buffer in place, checked by its storage; the ladder
  nodes' device ms beside the Concats'); ResNeXt-50 b128, its 16
  grouped 3x3 convs (cardinality 32)
  through ``conv2d_implicit_gemm`` as super-groups on "wgmma_halo" (the
  kernels line's ``conv2d_implicit_gemm_grouped``; q = 32 / (C/32) groups
  a 32-wide column tile, each tile's input halo staged once by TMA), each
  beside PyTorch's f32 ``F.conv2d(groups=32)`` as its library call and
  the bf16 one, and timed on the block-diagonal plan these launches took
  before, then behind an
  ``InferenceServer``; SE-ResNet-50 b96 (Sigmoid, the int8 Axpy);
  Inception-v3 b128 at 299x299 (1x7, 7x1, 1x3, 3x1 convs on
  ``conv2d_implicit_gemm``, requantizing AVE pools); ShuffleNet v1 b128
  (its grouped 1x1 and depthwise convs in PyTorch's float grouped conv,
  its baked ``int8_grouped=False``) and v2 b128;
- the segmentation family, full int8 at ``bench.py:58-81``'s batches and
  the deploys' sizes (``SEGMENTATION``): DeepLab-LargeFOV b16 at 321x321
  (conv5_1-3 at dilation 2 and fc6 at 12 on ``conv2d_implicit_gemm``
  with its taps spaced by the dilation, the kernels line's
  ``conv2d_implicit_gemm_dilated``; an Interp to 321x321), FCN-8s,
  FCN-16s and FCN-32s b16 at 224x224 (conv1's pad 100, the 7x7 fc6 on
  ``conv2d_implicit_gemm``, the N = 21 score convs on
  ``matmul_epilogue``, the Deconvolutions and Crops in PyTorch) and
  PSPNet-50 b4 at 473x473 (stages 4-5 at dilation 2 and 4, the
  requantizing pyramid pools of its baked ``avepool_matmul``, conv6 at
  N = 150);
- the detection families, full int8 at ``bench.py:58-81``'s batches and
  the deploys' sizes (``DETECTION``): MobileNet-SSD b128 at 300x300 (13
  depthwise convs on the int8 depthwise kernel, DetectionOutput with its
  baked ``det_thresh_first``), VGG16-SSD300 b16 (fc6 at dilation 6, the
  f32 Normalize on conv4_3, 8,732 priors), Faster R-CNN VGG16 b1 and
  R-FCN ResNet-101 b1 at 600x800 with ``im_info`` (Proposal over 17,100
  anchors, ROIPooling and fc6/fc7 on 300 ROIs; stage 5 at dilation 2,
  PSROIPooling and the vote Softmax).  Their agreement holds the head's
  inputs to the port on the CPU (cosine >= 0.999), then the head itself
  on the card's own inputs: DetectionOutput's and Proposal's rows equal
  to the port's on the CPU (image, label, score and order bit for bit,
  boxes within ``BOX_ULPS``), ROIPooling equal, PSROIPooling within 1
  ulp; it prints the kept detections and ROIs; Faster R-CNN then behind
  an in-process ``HttpFrontend`` (``two_stage_http``: 4 ``.npz`` answers
  equal to its outputs, ``decode_detections`` equal on both).  The main
  path, the s2d path and the ladder path are checked node by node
  (``card_nodes``): each node run by the port on the CPU on the card's
  own input values gives the card's int8 outputs (every int8 Eltwise
  among them, and the stem kernel's), cuDNN's s2d stem within 1 LSB.  After
  the first ResNet-50 path, ``fma_check`` holds the port's multiply-add on
  the card (``torch.addcmul``) to its CPU form (``numerics.fma_f32``)
  on ResNet-50's int8 Eltwise inputs: the int8 Eltwise's plain version and
  its ``eltwise_int8`` kernel (0 LSB) and an f32 ``coeffs`` sum (0 ulp).

Phases, each printing its own lines:

1. toolchain: versions, ``nvidia-smi``; the CUDA kernels are built from
   ``feathercnn_tpu_torch/kernels/csrc`` with ``nvcc``.
2. per path: the model is built, calibrated and loaded; one forward runs
   with every kernel's launch count set to 0 just before and read just
   after, against the path's expected counts (``EXPECTED``), every
   int8-edge residual add on ``eltwise_int8`` (none fallen back to
   PyTorch's ops); the output is finite.  The arguments of every launch
   are recorded on the way, and for every kernel whose wrapper counts
   variants the variant (main loop) it took, which must be the one its
   plan names: every int8 GEMM launch
   "wgmma", or "wgmma_ragged" where its rows are not whole 16-byte pieces
   (MobileNet-v2's K = 24 convs, GoogLeNet's 5x5 convs on 24 channels,
   the ShuffleNets' K = 24, 58, 116 and 232 convs; counted as the kernels
   line's ``*_ragged`` entries too, the plan's reasons printed), none on
   "mma_sync"; a bf16 x bf16 GEMM "wgmma_bf16", a bf16 x with an int8
   weight (weight-only) "wgmma_w8", an f32 x "simt"; every depthwise
   launch "k3s1" or "k3s2" by its stride and every chain launch, int8 or
   float, "wgmma".
3. per path, kernels: each launch of that forward is repeated on its own
   tensors and held against the kernel's plain PyTorch version (int8 out:
   equal; bf16 out: within 1 bf16 ulp; f32: within 1e-5 of the largest
   value), and timed (CUDA events, median of 20 behind a spin kernel)
   beside its bound (and the share of it reached) and a library
   yardstick (and the kernel's multiple of it): ``torch._int_mm`` at a GEMM's
   (M, K, N), on operands zero-padded to its rules (M > 16, K and N
   multiples of 8; the padding not timed) where it refuses the shape, the
   row marked so (at a grouped conv's launch the f32
   ``F.conv2d(groups=g)`` it computes, the bf16 one beside it, the bound
   of the grouped work, and for a super-group launch the ops bound of the
   products it runs, A's bytes from L2 in its halos beside those a gather
   of each tap would move, one line per stage), and for the
   depthwise kernels ``F.conv2d(groups=C)`` on
   channels-last bf16 (PyTorch has no int8 grouped conv, so the int8
   kernel's yardstick is that bf16 conv too).  No single PyTorch call
   computes a bottleneck: the chain kernels have no yardstick.  Instead
   each chain call is printed beside the device time that the same blocks'
   nodes take in the profiled forward of the unchained ResNet-50 path of
   its precision (phase 4); each int8 chain call is also timed on the
   plans it did not take ("mma_sync", the first body, and "wgmma" with the
   other number of tiles per thread block), each equal to its output, and
   the sums per forward printed.  The float chain is held to its plain version
   launch by launch (block by block, on the kernel's own input of each
   block): bf16 out, every element within 2 bf16 ulp of the plain value or
   within 1e-2 of the largest, and at most 0.1% more than 1 ulp apart
   (the plain version rounds each sum once from f64, the kernel adds in
   f32 in its own order, and a bf16 store of y1, y2 or the output may
   round the other way); f32 out, within 1e-4 of the largest value.  A GEMM
   launch on float x (its sums f32 of float products) takes the same bf16
   gate.  Each "wgmma_w8" launch is also run and timed on the "simt"
   body (its earlier variant) and, where its plan splits K, on the same
   body unsplit (the plans forced through the C entry point, uncounted),
   each held to the same gate, and each path prints the sums per
   forward; each "wgmma_ragged" launch likewise on "mma_sync" (the body
   those launches took before), equal to plain, and each path prints its
   ragged launches' sums: kernel, bound and share, old body, plain,
   library and multiple.  Each int8 launch whose plan splits K is also run
   and timed unsplit (the plan such launches took before) and on the
   other tile width with its split, each equal to plain, and each path
   prints a ``split launches`` line: launches, splits, ms split and
   unsplit, and any launch more than 3% slower split.  Each "wgmma_bf16"
   launch (the bf16 FC) is held to its split order's plain version
   (``matmul_epilogue_split_plain``) and timed unsplit, within the float
   gate.  R-FCN's three
   stage-5 dilated launches must split.
   ``ident`` is bit-equal, its yardstick ``x.clone()``; ``eltwise_int8``
   equal (0 LSB), its yardstick the PyTorch ops it replaced, on scale
   tensors made once (no host sync timed), and each path prints its
   launches' sums; ``stem_conv_int8`` within 1 LSB of its plain version
   on the card (it sums in the CPU's order, r, s, c; cuDNN's f32 conv
   rounds a few values the other way), its yardstick cuDNN's f32 conv and
   the PyTorch epilogue it replaced (``stem_composition``), and each path
   prints its launch.
   A float GEMM's yardstick is ``torch.matmul`` in x's type, a float
   ``conv2d_implicit_gemm``'s ``F.conv2d`` on channels-last bf16 (the
   weight dequantized once).
4. per path, agreement and speed: images 0-1 (or 0) through the port on
   the CPU (the plain versions) hold top-1 equal and the prob cosine >= 0.999
   against the card (a segmentation path its image 0: the per-pixel top-1
   equal at >= 99.9% of the pixels and the cosine of its probability map
   >= 0.999; a detection path the steps of ``detection_agreement``, and
   the head's share of the node ranges) (bf16 rounds at other places on the two devices, so a
   float edge may differ in its last bit and move an int8 value by one
   step); the classic zoo's paths (``LOGIT_AGREEMENT``) hold the cosine of
   the logits too, and AlexNet's and the Winograd route's that alone, each
   with a witness (the path with every float conv summed in f64, or in
   f32) that holds both (``PROB_WITNESS`` says why); median ms per batch
   and images/s over 10 forwards; one profiled forward's device time
   (``device_spans``: the union of the kernels' spans) by kernel, by graph
   node (the engine names a profiler range after each
   node) and by graph op (the Winograd convs, Concat and LRN are PyTorch
   ops: their time is read here).  The
   Winograd path also holds each Winograd conv's output against
   ``F.conv2d`` (f32, TF32 off) on the same input and dequantized weight:
   RMS error within 6% of the pre-activation output's RMS and the largest
   within 25% of its largest magnitude (F(6,3) on bf16-rounded
   transformed operands; ``tests/test_torch_winograd.py``).
5. ragged cases: stride 2, C not a multiple of a kernel's vector, odd
   sizes, the lo/hi clamp, the float variants, the depthwise kernels'
   tiles (H/W not multiples of the tile, stride 2 on odd inputs, C below
   and not a multiple of the vector, a 5x5 kernel, batch 1) each on its
   planned variant, the GEMM kernels at the
   edges of their variants (M not a multiple of the tile, N = 24 and 1000,
   K = 16, 24, 32, 2048, every output type, misaligned x, each on its
   planned variant, and the refusal of a weight not in ``gemm_layout``;
   ``ragged_rows``: "wgmma_ragged" at K = 24, 58, 116 and 232 and on 5x5
   and 3x3 convs over C = 24 at stride 1 and 2, x at 0, 2, 4 and 8 bytes
   from an aligned base, a conv's x at 2 and 4 and a K of 300 on
   "mma_sync", their reasons printed),
   the chain's ragged shapes and output types (int8 and float modes: tile
   counts that are not a multiple of the tiles a block takes, a one-tile
   int8 launch whose columns the two consumers split, saturated conv2 sums
   on both int8 variants, a misaligned x, each on its planned variant),
   "wgmma_w8" at the edges of its design (``ragged_w8``: M 1 to 300, K 64
   to 25088, N 24 to 4096, split K, bf16 and int8 out, stride 2, C of 8
   and 72, batch 1; a K and a C not a multiple of 8 and a misaligned x
   refused to "simt", their reasons printed), and
   ``ident`` on int8, bf16 and f32 at odd sizes, ``eltwise_int8`` at odd
   sizes, every activation, .5 quotients, saturated sums and pitched
   channel slices (and operands it copies first), then at ResNet-50's
   stage 2-4 shapes at b512 beside its byte bound and the PyTorch ops it
   replaced, against the plain versions, and ``stem_conv_int8`` on the
   zoo's stem forms (every act, .5 quotients; ``STEM_FORMS``) equal to
   the plain version on the CPU where the pad is at most (k - 1) / 2
   (within 1 LSB at FCN's pad 100) and within 1 LSB of it on the card, then
   at the benchmark's two stems (ResNet-50 b512, MobileNet-v1 b2048)
   beside its bound, plain and what it replaced;
   before the rest of the zoo's paths,
   ``conv2d_implicit_gemm`` on block-diagonal weights (4, 8 and 32
   channels a group) and on 1x7, 7x1, 1x3 and 3x1 kernels with their
   pads, stride 1 and 2, each on "wgmma", and on the super-group route
   ("wgmma_halo", halos of one and of four column tiles, six maps a tile
   past the batch; the grouped shapes no q fits on their block-diagonal
   weight), each equal to plain (``ragged_zoo_rest``);
   before the
   segmentation paths, the dilated ``conv2d_implicit_gemm`` at d = 2, 4,
   6 and 12, pad d and 0, C 16, 48 and 64, stride 1 and 2, int8 x on
   "wgmma", a bf16 x with an int8 weight on "wgmma_w8" (A by TMA) and an
   f32 x on "simt", and d = 12 on a map smaller than the kernel's span,
   each equal to plain within its gate (``ragged_dilated``).
6. server (ResNet-50, then GoogLeNet, then ResNeXt-50):
   ``InferenceServer(batch_size=B,
   batch_slots=[8, B])`` with int8 transfer; 8 client threads send 32
   requests; every answer equals the engine's direct output, with no
   fault.
7. boundary: the probe's launches counted and held against their plain
   versions, then each stage's median ms without and with ``ident``, the
   difference, and ``ident``'s own time beside its byte bound and
   ``x.clone()``.

The order: ResNet-50 (phases 2-4) and its node check, the multiply-add
check, the ragged cases (5), the server (6),
the loaded ResNet-50 (2-4) and the CLI over HTTP, ResNet-50 with
``s2d_stem`` (2-4) and its node check, the parallel paths, the tools
phase, ResNet-50 with ``fuse_chains``,
the two bf16 ResNet-50 paths, the
MobileNets, the boundary probe (7), VGG-16 (w8, w8 Winograd, w8a8),
GoogLeNet and its server, AlexNet, SqueezeNet (fp32, w8a8), the rest of
the zoo's ragged cases, DenseNet-121 and with ``concat_dus`` (2-4, its
node check), ResNeXt-50 and its server,
SE-ResNet-50, Inception-v3, ShuffleNet v1 and v2, the dilated cases,
DeepLab-LargeFOV, FCN-8s, FCN-16s, FCN-32s and PSPNet-50, MobileNet-SSD,
VGG16-SSD300, Faster R-CNN (and over HTTP) and R-FCN.  Then the
card's name and power limit, one JSON line of kernel numbers, and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero
before those lines.  Without a GPU, or without the repository beside it,
the script exits nonzero and prints no result.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

BATCH = 128          # ResNet-50
SEED = 0
# Published dense peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12       # float32 outside the tensor cores (FMA)
PEAK_BYTES = 3.35e12
KERNELS = {
    "matmul_epilogue": {
        "source": "feathercnn_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "replaces": "feathercnn_tpu/kernels/matmul.py:96"},
    "conv2d_implicit_gemm": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/conv.py:100"},
    "depthwise_conv2d": {
        "source": "feathercnn_tpu_torch/kernels/csrc/depthwise_conv.cu",
        "replaces": "feathercnn_tpu/kernels/depthwise.py:65"},
    "depthwise_conv2d_int8": {
        "source": "feathercnn_tpu_torch/kernels/csrc/depthwise_conv.cu",
        "replaces": "feathercnn_tpu/kernels/dispatch.py:221 (XLA's int8 "
                    "depthwise conv; no Pallas kernel)"},
    "fused_chain": {
        "source": "feathercnn_tpu_torch/kernels/csrc/fused_chain.cu",
        "replaces": "feathercnn_tpu/kernels/fused_chain.py:264"},
    "fused_chain_float": {
        "source": "feathercnn_tpu_torch/kernels/csrc/fused_chain_float.cu",
        "replaces": "feathercnn_tpu/kernels/fused_chain.py:264 (float "
                    "mode)"},
    "ident": {
        "source": "feathercnn_tpu_torch/kernels/csrc/ident.cu",
        "replaces": "bench/chain_micro.py:187"},
    "eltwise_int8": {
        "source": "feathercnn_tpu_torch/kernels/csrc/eltwise_int8.cu",
        "replaces": "feathercnn_tpu/ops/lowering.py:1837 (the int8-edge "
                    "Eltwise, plain jnp that XLA fuses; no Pallas kernel)"},
    "stem_conv_int8": {
        "source": "feathercnn_tpu_torch/kernels/csrc/stem_conv.cu",
        "replaces": "feathercnn_tpu/kernels/dispatch.py:232-252 (the "
                    "float conv of an int8-emitting stem, XLA's conv; no "
                    "Pallas kernel)"},
    # the dilated launches of conv2d_implicit_gemm (counted on its
    # ``dilated_launches`` too): their own entry of the kernels line
    "conv2d_implicit_gemm_dilated": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/dispatch.py:221 (XLA's dilated "
                    "int8 conv, rhs_dilation; no Pallas kernel)"},
    # the int8 launches whose rows are not whole 16-byte pieces, on the
    # "wgmma_ragged" variant (counted on the wrapper's ``variants`` too):
    # their own entries of the kernels line
    "matmul_epilogue_ragged": {
        "source": "feathercnn_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "replaces": "feathercnn_tpu/kernels/matmul.py:96 (K not a multiple "
                    "of 16)"},
    "conv2d_implicit_gemm_ragged": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/conv.py:100 (C not a multiple "
                    "of 16)"},
    # the grouped launches of conv2d_implicit_gemm on the super-group route
    # (counted on its ``grouped_launches`` too): their own entry
    "conv2d_implicit_gemm_grouped": {
        "source": "feathercnn_tpu_torch/kernels/csrc/conv_implicit_gemm.cu",
        "replaces": "feathercnn_tpu/kernels/dispatch.py:221 (XLA's grouped "
                    "int8 conv, feature_group_count; no Pallas kernel)"},
}
DILATED = "conv2d_implicit_gemm_dilated"
GROUPED = "conv2d_implicit_gemm_grouped"
RAGGED = {"matmul_epilogue": "matmul_epilogue_ragged",
          "conv2d_implicit_gemm": "conv2d_implicit_gemm_ragged"}
# the wrappers, each an attribute of kernels/dispatch.py
WRAPPERS = tuple(k for k in KERNELS
                 if k not in (DILATED, GROUPED) and k not in RAGGED.values())
_ZERO = dict.fromkeys(KERNELS, 0)
# path -> launches of one forward.  A kernel's entry in the kernels line
# takes its numbers from the first path here that launches it.
EXPECTED = {
    # the 13 int8-edge residual adds of stages 2-4 (stage 5's are float)
    "resnet50 b128": {**_ZERO, "matmul_epilogue": 33,
                      "conv2d_implicit_gemm": 16, "eltwise_int8": 13},
    "mobilenet_v1 b256": {**_ZERO, "matmul_epilogue": 14,
                          "depthwise_conv2d_int8": 13},
    "mobilenet_v1 b256 dw override": {**_ZERO, "matmul_epilogue": 14,
                                      "depthwise_conv2d": 13},
    # the two K = 24 1x1 convs ragged; the 10 residual adds (act none)
    "mobilenet_v2 b128 dw override": {**_ZERO, "matmul_epilogue": 35,
                                      "matmul_epilogue_ragged": 2,
                                      "depthwise_conv2d": 17,
                                      "eltwise_int8": 10},
    # one launch per block: 4 calls over 2 + 3 + 5 + 2 identity blocks;
    # the residual adds of the projection blocks res2a, res3a and res4a
    "resnet50 b128 fuse_chains": {**_ZERO, "matmul_epilogue": 9,
                                  "conv2d_implicit_gemm": 4,
                                  "fused_chain": 12, "eltwise_int8": 3},
    # bf16: the convs in PyTorch's float conv, the FC in matmul_epilogue
    "resnet50 b128 bf16": {**_ZERO, "matmul_epilogue": 1},
    # 5 calls over 2 + 3 + 5 + 1 + 1 identity blocks
    "resnet50 b128 bf16 fuse_chains": {**_ZERO, "matmul_epilogue": 1,
                                       "fused_chain_float": 12},
    # per stage 2-5: producer and consumer twice (without and with ident)
    "boundary b128": {**_ZERO, "matmul_epilogue": 16, "ident": 4},
    # weight-only int8: the 12 convs after the float stem and the 3 FCs on
    # "wgmma_w8" (bf16 x int8 weight)
    "vgg16 b128 w8": {**_ZERO, "matmul_epilogue": 3,
                      "conv2d_implicit_gemm": 12},
    # the 13 convs through kernels/winograd.py (PyTorch ops), the FCs as
    # above
    "vgg16 b128 w8 winograd": {**_ZERO, "matmul_epilogue": 3},
    "vgg16 b128 w8a8": {**_ZERO, "matmul_epilogue": 3,
                        "conv2d_implicit_gemm": 12},
    # 1 + 4 per inception (1x1, 3x3_reduce, 5x5_reduce, pool_proj) x 9 +
    # the FC; 1 + 2 per inception (3x3, 5x5) x 9, the 5x5 convs of 4b and
    # 4c on C = 24 ragged
    "googlenet b256": {**_ZERO, "matmul_epilogue": 38,
                       "conv2d_implicit_gemm": 19,
                       "conv2d_implicit_gemm_ragged": 2},
    # conv3 and the FCs; conv2, 4 and 5 are 2-group float convs
    "alexnet b256": {**_ZERO, "matmul_epilogue": 3,
                     "conv2d_implicit_gemm": 1},
    # every conv in cuDNN's f32 conv
    "squeezenet_v11 b1 fp32": dict(_ZERO),
    # squeeze and expand1x1 per fire x 8 + conv10; expand3x3 x 8
    "squeezenet_v11 b128": {**_ZERO, "matmul_epilogue": 17,
                            "conv2d_implicit_gemm": 8},
    # the rest of the zoo (ZOO_REST).  DenseNet-121: each dense layer's 1x1
    # (58), the 3 transitions' and the FC; the 58 growth-32 3x3 convs
    "densenet121 b128": {**_ZERO, "matmul_epilogue": 62,
                         "conv2d_implicit_gemm": 58},
    # 2 x 16 blocks' 1x1 convs, the 4 projections and the FC; the 16
    # grouped 3x3 convs as super-groups (q = 32 / (C/32), BN = S = 32)
    "resnext50 b128": {**_ZERO, "matmul_epilogue": 37,
                       "conv2d_implicit_gemm": 16,
                       "conv2d_implicit_gemm_grouped": 16,
                       "eltwise_int8": 13},
    # ResNet-50's 37, the SE path's down and up 1x1 convs x 16; 16 3x3
    "se_resnet50 b96": {**_ZERO, "matmul_epilogue": 69,
                        "conv2d_implicit_gemm": 16},
    # the 1x1 convs and the FC; every kxk conv but the fp stem, 34 of them
    # 1x7, 7x1, 1x3 or 3x1
    "inception_v3 b128": {**_ZERO, "matmul_epilogue": 38,
                          "conv2d_implicit_gemm": 53},
    # resx1_conv1 (ungrouped) and the FC; the grouped 1x1 and depthwise
    # convs take PyTorch's float grouped conv (its int8_grouped=False)
    # (resx1_conv1 on the stem's 24 channels ragged)
    "shufflenet_v1 b128": {**_ZERO, "matmul_epilogue": 2,
                           "matmul_epilogue_ragged": 1},
    # the 1x1 convs and the FC; the depthwise convs in the float grouped
    # conv (35 of the 1x1 convs ragged: K = 24, 58, 116, 232)
    "shufflenet_v2 b128": {**_ZERO, "matmul_epilogue": 37,
                           "matmul_epilogue_ragged": 35},
    # the main path's model written by save_ftpu, reloaded by
    # Engine.from_path: the main path's launches
    "resnet50 b128 loaded": {**_ZERO, "matmul_epilogue": 33,
                             "conv2d_implicit_gemm": 16, "eltwise_int8": 13},
    # the segmentation family (SEGMENTATION).  DeepLab: fc7 and fc8_voc12
    # (N = 21); the nine 3x3 convs of stages 1-4 but the fp stem, and
    # conv5_1-3 (d = 2) and fc6 (d = 12) dilated
    "deeplab_largefov b16": {**_ZERO, "matmul_epilogue": 2,
                             "conv2d_implicit_gemm": 13,
                             "conv2d_implicit_gemm_dilated": 4},
    # FCN: fc7, score_fr (N = 21) and the skip scores (N = 21; 2 in
    # FCN-8s, 1 in FCN-16s); the twelve 3x3 convs but the fp stem (pad
    # 100) and the 7x7 fc6
    "fcn8s b16": {**_ZERO, "matmul_epilogue": 4, "conv2d_implicit_gemm": 13},
    "fcn16s b16": {**_ZERO, "matmul_epilogue": 3,
                   "conv2d_implicit_gemm": 13},
    "fcn32s b16": {**_ZERO, "matmul_epilogue": 2,
                   "conv2d_implicit_gemm": 13},
    # PSPNet: the bottlenecks' 1x1 convs (the projections merged beside
    # branch2a), the four pyramid 1x1 convs and conv6 (N = 150); the stem's
    # two 3x3 convs after the fp one, stages 2-3's seven, conv5_4, and the
    # six (d = 2) and three (d = 4) dilated of stages 4-5; the 16 residual
    # adds
    "pspnet50 b4": {**_ZERO, "matmul_epilogue": 37,
                    "conv2d_implicit_gemm": 19,
                    "conv2d_implicit_gemm_dilated": 9, "eltwise_int8": 16},
    # the detection families (DETECTION).  MobileNet-SSD: the 13 pointwise
    # convs, conv14_1-conv17_1 and the 12 head convs (loc and conf on 6
    # sources); conv14_2-conv17_2 (3x3 s2); the 13 depthwise convs on the
    # int8 depthwise kernel (the reference's default "xla" branch)
    "mobilenet_ssd b128": {**_ZERO, "matmul_epilogue": 29,
                           "conv2d_implicit_gemm": 4,
                           "depthwise_conv2d_int8": 13},
    # VGG16-SSD300: fc7, the four extras' 1x1 convs and the 12 head convs;
    # the 12 3x3 convs after the fp stem, conv6_2-conv9_2 and fc6 (d = 6)
    "vgg16_ssd300 b16": {**_ZERO, "matmul_epilogue": 17,
                         "conv2d_implicit_gemm": 17,
                         "conv2d_implicit_gemm_dilated": 1},
    # Faster R-CNN: the RPN's two 1x1 heads, fc6 and fc7 on the 300 ROIs,
    # cls_score and bbox_pred; the 12 3x3 convs after the fp stem and the
    # RPN's 3x3
    "faster_rcnn_vgg16 b1": {**_ZERO, "matmul_epilogue": 6,
                             "conv2d_implicit_gemm": 13},
    # R-FCN: ResNet-101's 1x1 convs (the projections merged beside
    # branch2a), the RPN's two heads, conv_new_1, rfcn_cls and rfcn_bbox;
    # its 33 3x3 convs, stage 5's three at d = 2, and the RPN's 3x3; the 33
    # residual adds
    "rfcn_resnet101 b1": {**_ZERO, "matmul_epilogue": 71,
                          "conv2d_implicit_gemm": 34,
                          "conv2d_implicit_gemm_dilated": 3,
                          "eltwise_int8": 33},
    # the rewrite passes.  The main path with ``s2d_stem``: its stem a 4x4
    # s1 conv on 12 channels in PyTorch's (cuDNN's) float conv, as the 7x7
    # one: the main path's launches
    "resnet50 b128 s2d": {**_ZERO, "matmul_epilogue": 33,
                          "conv2d_implicit_gemm": 16, "eltwise_int8": 13},
    # DenseNet-121 with ``concat_dus``: its 58 Concats as 4 ladders of
    # buffer appends (PyTorch copies): DenseNet-121's launches
    "densenet121 b128 concat_dus": {**_ZERO, "matmul_epilogue": 62,
                                    "conv2d_implicit_gemm": 58},
    # the int8 conv forms of the tools phase (CONV_FORM_CASES), one launch
    # each: the 1x1 at stride (2, 1) on B1; the 3x3 ones on B2, the two
    # depthwise-shaped ones (stride 3, act_segments) as super-groups
    "conv forms": {**_ZERO, "matmul_epilogue": 1, "conv2d_implicit_gemm": 5,
                   "conv2d_implicit_gemm_grouped": 2},
}
# Every w8a8 path whose stem (C_in = 3) emits int8 launches stem_conv_int8
# once.  The stems of AlexNet (its LRN on float edges), MobileNet-v2 and
# the ShuffleNets (a float grouped conv reads them) emit bf16, and the s2d
# stem runs on 12 channels: PyTorch's float conv, as in the bf16 paths.
for _path in EXPECTED:
    if _path not in ("mobilenet_v2 b128 dw override", "resnet50 b128 bf16",
                     "resnet50 b128 bf16 fuse_chains", "boundary b128",
                     "vgg16 b128 w8", "vgg16 b128 w8 winograd",
                     "alexnet b256", "squeezenet_v11 b1 fp32",
                     "shufflenet_v1 b128", "shufflenet_v2 b128",
                     "resnet50 b128 s2d", "conv forms"):
        EXPECTED[_path]["stem_conv_int8"] = 1
# The two rewrite-pass paths' graphs: SpaceToDepth nodes, and ladders,
# appends and Concats left (tests/test_ladder.py's counts).
S2D_STEMS = 1
LADDERS = (4, 54, 0)
# The CLI phase: requests sent as .npy (from 8 client threads) and as
# JSON, the images' size before the C++ preprocess takes them to 224x224,
# and ImageNet's mean and std.
HTTP_NPY, HTTP_JSON = 32, 4
RAW_SIZE = (240, 320)
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# Faster R-CNN's requests through an in-process HttpFrontend
HTTP_TWO_STAGE = 4
# path -> device busy ms of its profiled forward (speed_and_profile)
BUSY = {}
# The detection families, w8a8 at bench.py:58-81's batches and the
# deploys' sizes (two-stage with ``im_info`` [h, w, 1]): path -> (model,
# batch, the primary output's shape).
DETECTION = {
    "mobilenet_ssd b128": ("mobilenet_ssd", 128, (128, 100, 7)),
    "vgg16_ssd300 b16": ("vgg16_ssd300", 16, (16, 200, 7)),
    "faster_rcnn_vgg16 b1": ("faster_rcnn_vgg16", 1, (300, 21)),
    "rfcn_resnet101 b1": ("rfcn_resnet101", 1, (300, 1, 1, 21))}
# the data-dependent head ops, held on the card's own inputs
HEAD_OPS = ("DetectionOutput", "Proposal", "ROIPooling", "PSROIPooling")
# a decoded box coordinate on the card against the port's CPU form, in f32
# ulps (the card's exp may differ; the port's is IEEE steps and fma)
BOX_ULPS = 2
# The segmentation family, w8a8 at bench.py:58-81's batches and the
# deploys' sizes: path -> (model, batch, output (H, W, classes)).
SEGMENTATION = {
    "deeplab_largefov b16": ("deeplab_largefov", 16, (321, 321, 21)),
    "fcn8s b16": ("fcn8s", 16, (224, 224, 21)),
    "fcn16s b16": ("fcn16s", 16, (224, 224, 21)),
    "fcn32s b16": ("fcn32s", 16, (224, 224, 21)),
    "pspnet50 b4": ("pspnet50", 4, (473, 473, 150))}
# per-pixel top-1 agreement of a segmentation path's first image, card
# against CPU
PIXEL_AGREEMENT = 0.999
# The rest of the classification zoo, w8a8: path -> (model, batch), the
# batches of bench.py:58-81.
ZOO_REST = {"densenet121 b128": ("densenet121", 128),
            "resnext50 b128": ("resnext50", 128),
            "se_resnet50 b96": ("se_resnet50", 96),
            "inception_v3 b128": ("inception_v3", 128),
            "shufflenet_v1 b128": ("shufflenet_v1", 128),
            "shufflenet_v2 b128": ("shufflenet_v2", 128)}
# the 13 Winograd convs of the Winograd path
WINOGRAD_CONVS = 13
# F(6,3)'s error on bf16-rounded transformed operands against F.conv2d:
# RMS error / RMS of the pre-activation output, and largest error / its
# largest magnitude (tests/test_torch_winograd.py)
WINOGRAD_RMS, WINOGRAD_MAX = 0.06, 0.25
# The classic zoo's paths hold the logits' cosine (the Softmax's input)
# besides the probabilities'.
LOGIT_AGREEMENT = ("vgg16 b128 w8", "vgg16 b128 w8 winograd",
                   "vgg16 b128 w8 winograd f32", "vgg16 b128 w8a8",
                   "googlenet b256", "alexnet b256", "alexnet b256 f64 convs",
                   "squeezenet_v11 b1 fp32", "squeezenet_v11 b128")
# Paths held on the logits' cosine alone, each with its witness: the same
# path with the one change named, held on the probabilities' cosine too.
# (witness label, make_engine arguments, float convs summed in f64)
PROB_WITNESS = {
    # AlexNet's bf16 logits (largest ~16, an ulp of 0.0625) move a
    # probability by ~6% per ulp, and its float convs (the stem and three
    # grouped convs), summed in cuDNN's order and in the CPU's, round some
    # values the other way: prob cosine 0.9986 with every launch equal to
    # its plain version (in f32 too: 0.9987, its FCs keep bf16 outputs).
    # Witness: every float conv summed in f64 and rounded once, one value
    # for every order.
    "alexnet b256": ("alexnet b256 f64 convs", {}, True),
    # F(6,3) rounds transformed tiles (up to ~150|x|) to bf16 and carries
    # each through A^T (entries up to 32); the card's and the CPU's f32
    # sums round some the other way, and over 13 convs the prob cosine
    # reads 0.998-0.99999 by image in every formulation, the logits'
    # 0.9997 (tools/winograd_probe.py).  Witness: the same route in f32.
    "vgg16 b128 w8 winograd": ("vgg16 b128 w8 winograd f32",
                               {"compute_dtype": "float32"}, False),
}
CHAINS = ("fused_chain", "fused_chain_float")
GEMMS = ("matmul_epilogue", "conv2d_implicit_gemm")
# Kernels whose every counted launch must take its main variant: "k3s1"
# or "k3s2" by the stride for the depthwise kernels, "wgmma" for both
# chains.
MAIN_VARIANT = ("depthwise_conv2d", "depthwise_conv2d_int8",
                "fused_chain", "fused_chain_float")
# Cycles of the spin kernel queued before each timed launch: more than
# the host needs to issue the launch.
SPIN_CYCLES = 2_000_000


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def run_cmd(cmd):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (r.stdout or r.stderr).strip()


def median_ms(fn, reps=20, warmup=3):
    """Median device time of one call of ``fn`` over ``reps`` runs (CUDA
    events).  A spin kernel queued before each run keeps the card busy
    while the host issues the launch, so the host's launch overhead does
    not count as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 1
# ----------------------------------------------------------------------
def toolchain():
    import torch
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    say("toolchain", f"python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} triton {triton_v}")
    from feathercnn_tpu_torch.kernels import build
    nvcc = build.nvcc_path()
    say("toolchain", "nvcc: " + run_cmd([nvcc, "--version"]).splitlines()[-1])
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    say("toolchain", f"gpu: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_library()
    say("toolchain", f"kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    log = build.build_log().splitlines()
    for line in log:
        if "registers" in line or ("spill" in line and " 0 bytes spill"
                                   not in line) or "Performance" in line:
            say("toolchain", "ptxas: " + line.split(":", 1)[-1].strip())
    # the int8 chain kernel's "wgmma" builds by name: <columns of conv2's
    # passes, conv2 summed per tap in f32>
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "fused_block_kernel_wg" in line:
            inst = line.split("fused_block_kernel_wgILi")[1]
            bnm, taps = inst.split("ELb")[0], inst.split("ELb")[1][0] == "1"
            spill = next(l for l in log[i + 1:i + 4] if "spill" in l)
            regs = next(l for l in log[i + 1:i + 4] if "registers" in l)
            say("toolchain", f"ptxas fused_block_kernel_wg<{bnm}, "
                f"{str(taps).lower()}>: {regs.split(':', 1)[-1].strip()}; "
                f"{spill.strip()}")
    return smi


# ----------------------------------------------------------------------
# phase 2
# ----------------------------------------------------------------------
def images(g, batch, rng):
    """``batch`` seeded images at the model's input size; with
    ``im_info`` [h, w, 1] rows beside them where the model takes it (the
    two-stage detectors)."""
    x = rng.normal(size=(batch,) + tuple(g.inputs["data"].shape[1:])
                   ).astype(np.float32)
    if "im_info" not in g.inputs:
        return x
    info = np.tile(np.asarray([[x.shape[1], x.shape[2], 1.0]], np.float32),
                   (batch, 1))
    return {"data": x, "im_info": info}


def batch_of(x):
    return len(x["data"]) if isinstance(x, dict) else len(x)


def to_card(x):
    """A path's input (an array, or name -> array) on the card."""
    import torch
    if isinstance(x, dict):
        return {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    return torch.from_numpy(x).cuda()


def first(x, k):
    """The first ``k`` images of a path's input."""
    if isinstance(x, dict):
        return {name: v[:k] for name, v in x.items()}
    return x[:k]


def calibrated(builder, batch, rng):
    """The zoo model at ``batch``, calibrated on 3 seeded batches of 8."""
    from feathercnn_tpu_torch.quant import calibrate
    g = builder(batch=batch, seed=SEED)
    calibrate(g, [images(g, 8, rng) for _ in range(3)], method="max")
    return g


def engine_config(quant="w8a8", compute_dtype="bfloat16", **config):
    """A path's config: the "cuda" backend and the named fields."""
    from feathercnn_tpu_torch import EngineConfig
    return EngineConfig(backend="cuda", compute_dtype=compute_dtype,
                        quant=quant, **config)


def make_engine(label, g, quant="w8a8", compute_dtype="bfloat16", **config):
    from feathercnn_tpu_torch import Engine
    t0 = time.perf_counter()
    cfg = engine_config(quant, compute_dtype, **config)
    eng = Engine(g, cfg)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    what = {"w8a8": f"w8a8 {compute_dtype}, calibrated on 3x8 seeded images",
            "w8": f"w8 (weight-only int8) {compute_dtype}, no calibration"
            }.get(quant, f"{compute_dtype}, no quantization")
    say(label, f"{what}, loaded in {time.perf_counter() - t0:.1f} s")
    return cfg, eng


def dw_override(g):
    """algo_overrides naming every depthwise conv of ``g`` "depthwise"."""
    return tuple((n.name, "depthwise") for n in g.nodes
                 if n.op == "Convolution" and n.attrs.get("group", 1) > 1)


class LaunchRecorder:
    """Wraps the dispatcher's kernel entry points for one forward and
    keeps the arguments of every wrapper call, in order, and for the GEMM
    kernels the variant (main loop) the call took."""

    def __init__(self):
        from feathercnn_tpu_torch.kernels import dispatch
        self.dispatch = dispatch
        self.launches = []

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            record = {"kernel": name, "args": dict(bound.arguments)}
            self.launches.append(record)
            if not hasattr(fn, "variants"):
                return fn(*a, **kw)
            before = dict(fn.variants)
            out = fn(*a, **kw)
            record["variant"] = "+".join(v for v, n in fn.variants.items()
                                         if n != before[v])
            return out
        return rec

    def run(self, forward, *args):
        orig = {n: getattr(self.dispatch, n) for n in WRAPPERS}
        try:
            for n in WRAPPERS:
                setattr(self.dispatch, n, self._wrap(n, orig[n]))
            return forward(*args)
        finally:
            for n in WRAPPERS:
                setattr(self.dispatch, n, orig[n])


def _kernel_fns():
    """name -> (wrapper, plain version)."""
    from feathercnn_tpu_torch.kernels import (conv, depthwise, eltwise,
                                              fused_chain, ident, matmul,
                                              stem)
    return {"matmul_epilogue": (matmul.matmul_epilogue,
                                matmul.matmul_epilogue_plain),
            "conv2d_implicit_gemm": (conv.conv2d_implicit_gemm,
                                     conv.conv2d_implicit_gemm_plain),
            "depthwise_conv2d": (depthwise.depthwise_conv2d,
                                 depthwise.depthwise_conv2d_plain),
            "depthwise_conv2d_int8": (depthwise.depthwise_conv2d_int8,
                                      depthwise.depthwise_conv2d_int8_plain),
            "fused_chain": (fused_chain.fused_chain,
                            fused_chain.fused_chain_plain),
            "fused_chain_float": (fused_chain.fused_chain_float,
                                  fused_chain.fused_chain_plain),
            "ident": (ident.ident, ident.ident_plain),
            "eltwise_int8": (eltwise.eltwise_int8,
                             eltwise.eltwise_int8_plain),
            "stem_conv_int8": (stem.stem_conv_int8, stem.stem_conv_plain)}


def reset_counts():
    for fn, _ in _kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants = dict.fromkeys(fn.variants, 0)
    _kernel_fns()["conv2d_implicit_gemm"][0].dilated_launches = 0
    _kernel_fns()["conv2d_implicit_gemm"][0].grouped_launches = 0
    _kernel_fns()["eltwise_int8"][0].fallbacks = 0
    _kernel_fns()["stem_conv_int8"][0].fallbacks = 0


def gemm_plan_of(kernel, a):
    """The plan the wrapper makes for a recorded GEMM call."""
    from feathercnn_tpu_torch.kernels.matmul import (_default_out_dtype,
                                                     plan_for)
    m, k, n = dims(kernel, a)
    out_dtype = _default_out_dtype(a["x"], a["out_dtype"])
    if kernel != GEMMS[1]:
        return plan_for(m, k, n, a["x"], a["w"], out_dtype)
    nb, oh, ow, _, _, _ = dims("depthwise", a)
    kh, kw, s, _ = a["w"].shape
    return plan_for(m, kh * kw * s, n, a["x"], a["w"], out_dtype,
                    conv_c=a["x"].shape[3], conv_out=(nb, oh, ow),
                    stride=a["stride"], group=a.get("groups", 1))


def gemm_variants_wanted(kernel, a):
    """The variants a GEMM launch may take: "wgmma" or "wgmma_ragged"
    (rows that are not whole 16-byte pieces) for int8 x (int8 w), K split
    or not, or "wgmma_halo" (a grouped 3x3 conv's super-groups);
    "wgmma_w8" for a bf16 x with an int8 weight (weight-only);
    "simt" for an f32 x (f32 on the tensor cores would be TF32) and for
    every other float conv; "wgmma_bf16" for a bf16 x bf16 matrix."""
    import torch
    if a["x"].dtype == torch.int8:
        return ("wgmma", "wgmma_ragged", "wgmma_halo")
    if a["x"].dtype == torch.bfloat16 and a["w"].dtype == torch.int8:
        return ("wgmma_w8",)
    if (a["x"].dtype == a["w"].dtype == torch.bfloat16
            and kernel == "matmul_epilogue"):
        return ("wgmma_bf16",)
    return ("simt",)


def check_variants(label, launches):
    """Every GEMM launch of the forward took the variant its plan names,
    one of those ``gemm_variants_wanted`` allows: every int8 one "wgmma",
    or "wgmma_ragged" where its rows are not whole 16-byte pieces (the
    plan's reasons printed, with their counts), every bf16 x bf16 one
    "wgmma_bf16", every weight-only one (bf16 x, int8 w) "wgmma_w8", every
    f32 x one "simt"; every depthwise launch (all 3x3) "k3s1" or "k3s2" by
    its stride, and every chain launch (int8 or float) "wgmma"."""
    taken, ragged = {}, {}
    for i, r in enumerate(launches):
        if r["kernel"] in MAIN_VARIANT:
            v, a = r["variant"], r["args"]
            want = ("wgmma" if r["kernel"] in CHAINS
                    else f"k3s{a['stride']}")
            check(v == want, f"{label}: launch {i} {r['kernel']} took "
                  f"{v}, expected {want}")
            key = f"{r['kernel']} {v}"
            taken[key] = taken.get(key, 0) + 1
            continue
        if r["kernel"] not in GEMMS:
            continue
        a, v = r["args"], r["variant"]
        taken[v] = taken.get(v, 0) + 1
        want = gemm_variants_wanted(r["kernel"], a)
        plan = gemm_plan_of(r["kernel"], a)
        m, k, n = dims(r["kernel"], a)
        check(v in want and v == plan.variant,
              f"{label}: launch {i} {r['kernel']} M={m} K={k} N={n} took "
              f"{v}, planned {plan.variant} ({plan.reason}), expected one "
              f"of {want}")
        if v == "wgmma_ragged":
            key = f"{r['kernel']} K={k} ({plan.reason})"
            ragged[key] = ragged.get(key, 0) + 1
    planned = "; ".join(f"{key} x{c}" for key, c in ragged.items())
    say(label, f"variants {taken}" + ("; wgmma_ragged, as planned: "
                                      + planned if ragged else ""))


def read_counts():
    """The launches of the counted forward by kernel.  Every int8-edge
    Eltwise of a counted forward takes ``eltwise_int8`` and every
    int8-emitting stem ``stem_conv_int8``: none fell back to PyTorch's
    ops."""
    fns = _kernel_fns()
    fallbacks = fns["eltwise_int8"][0].fallbacks
    check(fallbacks == 0, f"{fallbacks} int8-edge Eltwise nodes fell back "
          f"to PyTorch's ops")
    fallbacks = fns["stem_conv_int8"][0].fallbacks
    check(fallbacks == 0, f"{fallbacks} int8-emitting stems fell back to "
          f"PyTorch's float conv")
    counts = {name: fn.launches for name, (fn, _) in fns.items()}
    counts[DILATED] = fns["conv2d_implicit_gemm"][0].dilated_launches
    counts[GROUPED] = fns["conv2d_implicit_gemm"][0].grouped_launches
    for wrapper, name in RAGGED.items():
        counts[name] = fns[wrapper][0].variants["wgmma_ragged"]
    return counts


def supergroup_of(a):
    """(group, q, S) of a recorded ``conv2d_implicit_gemm`` call on the
    super-group route (``groups`` > 1 at ``supergroup``'s q), else None."""
    from feathercnn_tpu_torch.kernels.matmul import supergroup
    group = a.get("groups", 1)
    if group == 1:
        return None
    kh, kw, s, co = a["w"].shape
    q = supergroup(a["x"].shape[3], co, group, (kh, kw), a["stride"])[0]
    return (group, q, s) if q else None


def row_kernel(launch):
    """The kernels line's name of a recorded launch: a dilated
    ``conv2d_implicit_gemm`` launch is ``DILATED``, a super-group one
    ``GROUPED``."""
    if launch["kernel"] == "conv2d_implicit_gemm":
        if launch["args"].get("dilation", 1) > 1:
            return DILATED
        if supergroup_of(launch["args"]):
            return GROUPED
    return launch["kernel"]


def counted_as(launch):
    """The kernels line's entries whose counts a recorded launch adds to:
    its wrapper's, and ``DILATED``'s for a dilated conv, ``GROUPED``'s for
    a super-group one, the ragged entry of its wrapper for a
    "wgmma_ragged" launch."""
    names = [launch["kernel"]]
    if row_kernel(launch) in (DILATED, GROUPED):
        names.append(row_kernel(launch))
    if launch.get("variant") == "wgmma_ragged":
        names.append(RAGGED[launch["kernel"]])
    return tuple(names)


def rows_of(name, rows):
    """A kernel's rows: those of the launches its count counts
    (``conv2d_implicit_gemm``'s take its dilated and ragged ones too)."""
    return [r for r in rows if name in r["counted"]]


def drive(label, eng, x):
    """One forward with the counts set to 0 just before and read just
    after, held to the path's expected counts; the launches recorded."""
    import torch
    recorder = LaunchRecorder()
    reset_counts()
    out = recorder.run(eng, x)
    torch.cuda.synchronize()
    counts = read_counts()
    say(label, f"one forward at b{batch_of(x)}: launches {counts}")
    check(counts == EXPECTED[label],
          f"{label}: launches {counts}, expected {EXPECTED[label]}")
    n = batch_of(x)
    want = ((n, 1, 1, 1000) if label.startswith("squeezenet")
            else (n,) + SEGMENTATION[label][2] if label in SEGMENTATION
            else DETECTION[label][2] if label in DETECTION
            else (n, 1000))
    check(tuple(out.shape) == want,
          f"{label}: output {tuple(out.shape)}, expected {want}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    recorded = {name: sum(launches_of(r) for r in recorder.launches
                          if name in counted_as(r)) for name in KERNELS}
    check(recorded == counts, f"recorded {recorded} vs counted {counts}")
    return out, recorder.launches


def launches_of(record):
    """CUDA launches of one recorded wrapper call: the chain kernels
    launch once per block of the chain, the others once."""
    if record["kernel"] in CHAINS:
        return record["args"]["w1"].shape[0]
    return 1


# ----------------------------------------------------------------------
# phase 3
# ----------------------------------------------------------------------
def chain_ops(a):
    """Operations of one ``fused_chain`` call: per block and pixel 2 x
    (C*Cm + 9*Cm^2 + Cm*C) multiply-adds."""
    n, h, w, c = a["x"].shape
    nb, _, cm = a["w1"].shape
    return 2.0 * n * h * w * (2 * c * cm + 9 * cm * cm) * nb


def strides(a):
    """(sh, sw) of a recorded conv launch: its ``stride``, an int or a
    pair."""
    s = a["stride"]
    return (s, s) if isinstance(s, int) else tuple(s)


def dims(kernel, a):
    """(M, K, N) of a GEMM-shaped launch, or (N, OH, OW, C, KH, KW) of a
    depthwise one."""
    if kernel == "matmul_epilogue":
        (m, k), n = a["x"].shape, a["w"].shape[1]
        return m, k, n
    x = a["x"] if "x" in a else a["xq"]
    w = a["w"] if "w" in a else a["wq"]
    nb, h, wd, c = x.shape
    kh, kw = w.shape[0], w.shape[1]
    d = a.get("dilation", 1)
    sh, sw = strides(a)
    oh = (h + 2 * a["pad_h"] - d * (kh - 1) - 1) // sh + 1
    ow = (wd + 2 * a["pad_w"] - d * (kw - 1) - 1) // sw + 1
    if kernel == "conv2d_implicit_gemm":
        return nb * oh * ow, kh * kw * c, w.shape[3]
    return nb, oh, ow, c, kh, kw


def x_arg(a):
    """A recorded launch's (first) input: ``x``, a depthwise int8 launch's
    ``xq`` or ``eltwise_int8``'s ``x0``."""
    return next(a[k] for k in ("x", "xq", "x0") if k in a)


def bound_ms(kernel, a, out, group=1):
    """Least time on an H100 SXM: the larger of the bytes the function
    must move (each input read once, the output written once) over the
    memory rate and its operations over the peak for their type (int8 or
    bf16 on the tensor cores by x's type, float32 FMA for f32 x and for the
    float depthwise variant, which computes in f32; ``ident`` and
    ``eltwise_int8`` do no products: bytes bound them; ``stem_conv_int8``
    its conv's multiply-adds on the bf16 peak).
    A conv on a block-diagonal or super-group weight computes a grouped
    conv: its operations are the dense product's over ``group``, and a
    super-group launch's weight bytes the grouped weight's (KH*KW*C/g*Co),
    not its compact layout's.  A dilated conv's
    count only the taps that land in the image (a tap in the padding is a
    structural zero: at d = 12 on a 41x41 map most are)."""
    import torch
    nbytes = out.numel() * out.element_size()
    for t in a.values():
        for u in (t if isinstance(t, (tuple, list)) else (t,)):
            if isinstance(u, torch.Tensor):
                nbytes += u.numel() * u.element_size()
    sg = supergroup_of(a) if kernel == "conv2d_implicit_gemm" else None
    if sg:
        w = a["w"]
        nbytes -= w.numel() - w.numel() * a["x"].shape[3] // sg[0] // sg[2]
    if kernel == "stem_conv_int8" and a["wk"] is not None:
        # its weight counted once, as HWIO
        nbytes -= a["wk"].numel() * a["wk"].element_size()
    if kernel in ("ident", "eltwise_int8"):
        ops = 0.0
    elif kernel == "stem_conv_int8":
        ops = 2.0 * out.numel() * math.prod(a["w"].shape[:3])
    elif kernel in CHAINS:
        ops = chain_ops(a)
    elif a.get("dilation", 1) > 1:
        ops = 2.0 * dilated_taps(a) * a["x"].shape[3] * a["w"].shape[3]
    else:
        ops = 2.0 * math.prod(dims(kernel, a)) / group
    x = x_arg(a)
    peak = {torch.int8: PEAK_INT8_OPS, torch.bfloat16: PEAK_BF16_OPS}.get(
        x.dtype, PEAK_F32_OPS)
    if kernel == "depthwise_conv2d":
        peak = PEAK_F32_OPS
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def dilated_taps(a):
    """The (output pixel, tap) pairs of a dilated conv launch whose input
    pixel lies in the image, over its batch."""
    x, w, s, d = a["x"], a["w"], a["stride"], a["dilation"]
    nb, h, wd, _ = x.shape

    def valid(size, k, pad, out):
        pos = (np.arange(out)[:, None] * s - pad + np.arange(k)[None] * d)
        return int(((pos >= 0) & (pos < size)).sum())

    _, oh, ow, _, _, _ = dims("depthwise", a)
    return nb * valid(h, w.shape[0], a["pad_h"], oh) * valid(
        wd, w.shape[1], a["pad_w"], ow)


def compare(kernel_out, plain_out, gate="exact"):
    """(max |kernel - plain|, within the gate, elements more than 1 bf16 ulp
    apart).  ``gate="bits"``: bit-equal.  ``gate="float"``, for a kernel
    that sums products of float inputs in f32 in another order than the
    plain version (the float chain, a GEMM of float x): bf16 out, every
    element within 2 ulp of the plain value or within 1e-2 of the largest
    |plain|, and at most 0.1% of them more than 1 ulp apart; f32 out,
    within 1e-4 of the largest |plain|.  ``gate="exact"``: int8 equal, bf16
    within 1 ulp of the plain value, f32 within 1e-5 of the output's
    magnitude.  ``gate="lsb1"``, for the stem kernel against its plain
    version on the card (the kernel sums in the CPU's order, cuDNN's f32
    conv in its own): int8 within 1 LSB, the elements that differ
    counted."""
    import torch
    check(kernel_out.dtype == plain_out.dtype
          and kernel_out.shape == plain_out.shape,
          f"kernel gave {kernel_out.dtype}{tuple(kernel_out.shape)}, plain "
          f"{plain_out.dtype}{tuple(plain_out.shape)}")
    if gate == "bits":
        return 0.0, bool(torch.equal(kernel_out, plain_out)), 0
    k, p = kernel_out.double(), plain_out.double()
    err = (k - p).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    top = float(p.abs().max()) if p.numel() else 0.0
    if kernel_out.dtype == torch.int8:
        if gate == "lsb1":
            return max_err, max_err <= 1.0, int((err > 0).sum())
        return max_err, max_err == 0.0, 0
    if kernel_out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            p.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        over = int((err > ulp).sum())
        if gate == "float":
            ok = (bool(((err <= 2 * ulp) | (err <= 1e-2 * top)).all())
                  and over <= 1e-3 * err.numel())
            return max_err, ok, over
        return max_err, over == 0, over
    tol = 1e-4 if gate == "float" else 1e-5
    return max_err, max_err <= tol * top, 0


def per_launch(a, out):
    """A float chain call held against the plain version one launch (one
    block) at a time: each block's kernel output against the plain version
    of that block on the same input, the kernel's output feeding the next
    block, whose last output must equal the whole call's ``out``.  Two
    correct f32 sum orders of a bf16 chain drift apart from block to block
    (a bf16 store that rounds the other way feeds every later block), so
    the gate holds per launch, where both versions start from one input.
    Returns (max err, every launch within the gate, elements more than 1
    ulp apart, elements compared)."""
    import torch
    kernel, plain = _kernel_fns()["fused_chain_float"]
    nb = a["w1"].shape[0]
    act, worst, ok, over, elements = a["x"], 0.0, True, 0, 0
    for j in range(nb):
        blk = {k: a[k][j:j + 1] for k in ("w1", "b1", "w2", "b2", "w3", "b3")}
        blk.update(x=act, out_dtype=a["out_dtype"] if j == nb - 1 else None)
        got = kernel(**blk)
        e, o, v = compare(got, plain(**blk), "float")
        worst, ok, over = max(worst, e), ok and o, over + v
        elements += got.numel()
        act = got
    check(torch.equal(act, out), "a float chain run block by block differs "
          "from the same chain in one call")
    return worst, ok, over, elements


_LIBRARY_MS = {}


def library_ms(kernel, a, group=1):
    """The yardstick, timed once per shape and never called by the port:
    ``torch._int_mm`` (int8 x int8 -> int32, no epilogue) at an int8
    GEMM's (M, K, N), ``torch.matmul`` in x's type at a float one;
    ``F.conv2d(groups=C)`` with its bias on channels-last bf16 at a
    depthwise launch's shape; ``x.clone()`` for ``ident``; for
    ``eltwise_int8`` the PyTorch ops it replaced (``eltwise_composition``);
    for ``stem_conv_int8`` cuDNN's f32 conv and the PyTorch epilogue it
    replaced (``stem_composition``);
    for a grouped
    conv's launch (super-group or block-diagonal) the grouped conv, f32
    ``F.conv2d(groups=group)`` (PyTorch has no int8 conv on the card); for a
    dilated conv bf16 ``F.conv2d(dilation=d)`` on channels-last tensors,
    as a weight-only conv's (the int8 values dequantized)."""
    import torch
    if kernel in CHAINS:            # no single PyTorch call computes it
        return None
    if group > 1:
        x, w = a["x"], a["w"]
        key = ("grouped", tuple(x.shape), tuple(w.shape), a["stride"],
               a["pad_h"], a["pad_w"], group)
        if key not in _LIBRARY_MS:
            _LIBRARY_MS[key] = _time_grouped_conv(
                tuple(x.shape), w.shape[0], w.shape[1], w.shape[3],
                a["stride"], a["pad_h"], a["pad_w"], group)
        return _LIBRARY_MS[key]
    if kernel == "ident":
        x = a["x"]
        key = ("clone", tuple(x.shape), x.dtype)
        if key not in _LIBRARY_MS:
            _LIBRARY_MS[key] = median_ms(x.clone)
        return _LIBRARY_MS[key]
    if kernel == "eltwise_int8":
        key = ("eltwise", tuple(a["x0"].shape), a["x0"].stride(),
               a["x1"].stride(), a["act"])
        if key not in _LIBRARY_MS:
            _LIBRARY_MS[key] = median_ms(eltwise_composition(a))
        return _LIBRARY_MS[key]
    if kernel == "stem_conv_int8":
        key = ("stem", tuple(a["x"].shape), tuple(a["w"].shape),
               tuple(a["stride"]), tuple(a["padding"]), a["activation"])
        if key not in _LIBRARY_MS:
            _LIBRARY_MS[key] = median_ms(stem_composition(a), reps=5)
        return _LIBRARY_MS[key]
    d = dims(kernel, a)
    x = a["x"] if "x" in a else a["xq"]
    dil = a.get("dilation", 1)
    key = (kernel == "depthwise_conv2d" or kernel == "depthwise_conv2d_int8",
           d, a.get("stride"), a.get("pad_h"), a.get("pad_w"), x.dtype, dil)
    if key not in _LIBRARY_MS:
        if kernel == "conv2d_implicit_gemm" and (x.dtype != torch.int8
                                                 or dil > 1):
            w = a["w"]
            _LIBRARY_MS[key] = _time_conv(tuple(x.shape), w.shape[0],
                                          w.shape[3], a["stride"],
                                          a["pad_h"], a["pad_w"], dil)
        elif key[0]:
            _LIBRARY_MS[key] = _time_dw_conv(d, a["stride"], a["pad_h"],
                                             a["pad_w"])
        elif x.dtype == torch.int8:
            _LIBRARY_MS[key] = _time_int_mm(*d)
        else:
            _LIBRARY_MS[key] = _time_matmul(*d, x.dtype)
    return _LIBRARY_MS[key]


def eltwise_composition(a):
    """A callable running the PyTorch ops that ``eltwise_int8`` replaced on
    a recorded launch's operands (``kernels.eltwise.eltwise_int8_sum``:
    the operands cast to f32, a multiply, ``addcmul``, the activation, a
    multiply by the output scale's reciprocal, ``round``, ``clamp``, the
    cast), its three scales made into device tensors once, so that no host
    sync is timed; it returns what the kernel returns."""
    import torch
    from feathercnn_tpu_torch.kernels.eltwise import eltwise_int8_sum
    s0, s1, inv = (torch.tensor(float(v), dtype=torch.float32,
                                device="cuda")
                   for v in (a["s0"], a["s1"], a["inv"]))
    return lambda: eltwise_int8_sum((a["x0"], a["x1"]), (s0, s1), inv,
                                    a["act"])


def stem_composition(a):
    """A callable running what ``stem_conv_int8`` replaced on a recorded
    launch's tensors: the bf16 input cast to f32, cuDNN's f32 conv (TF32
    off), + bias, the activation, a multiply by ``out_scale``, round,
    clamp and the cast to int8, the scale made a device tensor once (no
    host sync timed); it returns what the kernel returns."""
    import torch
    from feathercnn_tpu_torch.numerics import (apply_activation, nchw_conv,
                                               requantize)
    sc = torch.tensor(a["out_scale"], dtype=torch.float32, device="cuda")
    x, w, b = a["x"], a["w"], a["bias"]

    def run():
        y = nchw_conv(x.float(), w.float(), tuple(a["stride"]),
                      tuple(a["padding"]))
        if b is not None:
            y = y + b
        return requantize(apply_activation(y, a["activation"]), sc)
    return run


def _time_matmul(m, k, n, dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    b = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
    return median_ms(lambda: a @ b)


def library_padded(kernel, a, group=1):
    """Whether the launch's library time is ``_int_mm`` on zero-padded
    operands: an int8 GEMM, undilated and not grouped, whose (M, K, N)
    ``_int_mm`` refuses as it stands (it takes M > 16 and K, N multiples
    of 8)."""
    import torch
    if kernel not in GEMMS or a["x"].dtype != torch.int8 or group > 1 \
            or a.get("dilation", 1) > 1:
        return False
    m, k, n = dims(kernel, a)
    return m <= 16 or k % 8 != 0 or n % 8 != 0


def _time_int_mm(m, k, n):
    """``torch._int_mm`` at (M, K, N); where it refuses the shape, on
    operands zero-padded to its rules (M to 17, K and N to multiples of
    8), made padded (the padding is not timed)."""
    import torch
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.zeros(mp, kp, dtype=torch.int8, device="cuda")
    a[:m, :k] = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=gen)
    bt = torch.zeros(np_, kp, dtype=torch.int8, device="cuda")
    bt[:n, :k] = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                               device="cuda", generator=gen)
    try:
        return median_ms(lambda: torch._int_mm(a, bt.t()))
    except RuntimeError as e:       # a yardstick: its absence fails nothing
        say("kernels", f"_int_mm at ({m}, {k}, {n}) refused: {e}")
        return None


def _time_conv(x_shape, k, co, stride, pad_h, pad_w, dilation=1):
    """F.conv2d with its bias on channels-last bf16 at a float or dilated
    implicit-GEMM launch's shape (an int8 weight dequantized once to
    bf16)."""
    import torch
    import torch.nn.functional as F
    nb, h, w, c = x_shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(nb, c, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(co, c, k, k, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(co, device="cuda", generator=gen).to(torch.bfloat16)
    return median_ms(lambda: F.conv2d(x, wt, b, stride=stride,
                                      padding=(pad_h, pad_w),
                                      dilation=dilation))


def _time_grouped_conv(x_shape, kh, kw, co, stride, pad_h, pad_w, group,
                       dtype=None):
    """F.conv2d(groups=group) with its bias in f32 (TF32 off), or in
    ``dtype`` (bf16), on channels-last int8 values, at a grouped conv
    launch's shape."""
    import torch
    import torch.nn.functional as F
    nb, h, w, c = x_shape
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(-127, 128, (nb, c, h, w), device="cuda",
                      generator=gen).to(dtype).contiguous(
                          memory_format=torch.channels_last)
    wt = torch.randint(-127, 128, (co, c // group, kh, kw), device="cuda",
                       generator=gen).to(dtype).contiguous(
                           memory_format=torch.channels_last)
    b = torch.randn(co, device="cuda", generator=gen).to(dtype)
    return median_ms(lambda: F.conv2d(x, wt, b, stride=stride,
                                      padding=(pad_h, pad_w), groups=group))


def _library_bf16_grouped(a, group):
    """bf16 channels-last ``F.conv2d(groups=group)`` at a grouped conv
    launch's shape, beside the f32 call of ``library_ms``; timed once per
    shape."""
    import torch
    x, w = a["x"], a["w"]
    key = ("grouped bf16", tuple(x.shape), tuple(w.shape), a["stride"],
           a["pad_h"], a["pad_w"], group)
    if key not in _LIBRARY_MS:
        _LIBRARY_MS[key] = _time_grouped_conv(
            tuple(x.shape), w.shape[0], w.shape[1], w.shape[3], a["stride"],
            a["pad_h"], a["pad_w"], group, torch.bfloat16)
    return _LIBRARY_MS[key]


def _time_dw_conv(d, stride, pad_h, pad_w):
    import torch
    import torch.nn.functional as F
    nb, oh, ow, c, kh, kw = d
    h = (oh - 1) * stride + kh - 2 * pad_h
    w = (ow - 1) * stride + kw - 2 * pad_w
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(nb, c, h, w, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(c, 1, kh, kw, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(c, device="cuda", generator=gen).to(torch.bfloat16)
    return median_ms(lambda: F.conv2d(x, wt, b, stride=stride,
                                      padding=(pad_h, pad_w), groups=c))


# Tiles at which each depthwise launch shape of a counted path is timed,
# beside the one dw_plan gives it (64 channels by 16 threads along a row
# by 16 rows for "k3s1"; for "k3s2" 64 by 32 by 8 or 64 by 16 by 16, by
# which leaves fewer outputs past the edge): (channels, threads along a
# row, rows) per variant.
DW_OTHER_TILES = {"k3s1": ((32, 16, 16), (64, 32, 8)),
                  "k3s2": ((64, 32, 8), (64, 16, 16), (128, 32, 8)),
                  "tiled": ()}
_DW_TILE_MS = {}


def dw_tile_ms(kernel, a, want):
    """{tile: median ms} of a depthwise launch at its variant's other
    tiles, launched through the C entry point on the same tensors, each
    held bit-equal to ``want`` (the plain version); timed once per shape.
    Not counted: the wrapper is not called."""
    import torch
    from feathercnn_tpu_torch.kernels import depthwise as dw
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.matmul import _ACT_CODES, _DTYPE_CODES
    int8 = kernel == "depthwise_conv2d_int8"
    x = a["xq"] if int8 else a["x"]
    s, ph, pw = a["stride"], a["pad_h"], a["pad_w"]
    w, oh, ow = dw._geometry(x, a["wq"] if int8 else a["w"], s, ph, pw)
    n, h, wd, c = x.shape
    kh, kw = w.shape[0], w.shape[1]
    odt = want.dtype
    key = (kernel, tuple(x.shape), x.dtype, odt, kh, kw, s, ph, pw)
    if key in _DW_TILE_MS:
        return _DW_TILE_MS[key]
    ss = 1 if int8 else (odt if x.dtype == torch.int8 else x.dtype).itemsize
    variant = dw.dw_plan(n, h, wd, c, kh, kw, s, ph, pw, x.element_size(),
                         ss, int8).variant
    lib = load_library()
    bias = a["bias"].data_ptr() if a["bias"] is not None else None
    res = {}
    for tile in DW_OTHER_TILES[variant]:
        plan = dw._tile_plan(variant, *tile, n, oh, ow, c, kh, kw, s,
                             x.element_size(), ss)
        out = torch.empty_like(want)

        def run():
            st = torch.cuda.current_stream().cuda_stream
            if int8:
                rc = lib.fcnn_depthwise_conv2d_int8(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), bias,
                    a["w_scale"].data_ptr(), n, h, wd, c, kh, kw, s, s, ph,
                    pw, _DTYPE_CODES[odt], _ACT_CODES[a["activation"]],
                    float(a["out_scale"]), *plan.args(), st)
            else:
                xs = a["x_scale"]
                rc = lib.fcnn_depthwise_conv2d(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), bias, n, h,
                    wd, c, kh, kw, s, s, ph, pw, _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[odt], _ACT_CODES[a["activation"]],
                    float(xs if xs is not None else 1.0), *plan.args(), st)
            check(rc == 0, f"{kernel} at tile {tile}: CUDA error {rc}")
        run()
        check(torch.equal(out, want), f"{kernel} x{tuple(x.shape)} at tile "
              f"{tile} ({plan}) differs from plain")
        res[tile] = median_ms(run)
    _DW_TILE_MS[key] = res
    return res


def forced_launch(kernel, a, out, plan, what):
    """A callable that launches the GEMM kernel on the recorded call's
    tensors ``a`` into ``out`` (contiguous, as the wrapper makes it) with
    ``plan`` forced, through the C entry point (uncounted: the wrapper is
    not called), with the split-K workspace the plan needs
    (``split_workspace``); a CUDA error fails the run as ``what``."""
    import torch
    from feathercnn_tpu_torch.kernels.build import load_library
    from feathercnn_tpu_torch.kernels.matmul import (launch_args,
                                                     split_workspace)
    check(out.is_contiguous(), f"{what}: the output must be contiguous")
    lib = load_library()
    vecs = {k: a[k] for k in ("bias", "w_scale", "lo", "hi")}
    ptrs, codes, _ = launch_args(a["x"], a["w"], out, vecs, a["activation"],
                                 out.dtype)
    scales = (float(a["x_scale"]), float(a["out_scale"]))
    m, _, n = dims(kernel, a)
    ws = split_workspace(plan, m, n, a["x"].dtype, out.device)
    tail = (*plan.args(), None if ws is None else ws.data_ptr())

    def run():
        st = torch.cuda.current_stream().cuda_stream
        if kernel == "matmul_epilogue":
            k = dims(kernel, a)[1]
            rc = lib.fcnn_matmul_epilogue(*ptrs, m, k, n, *codes, *scales,
                                          *tail, st)
        else:
            nb, h, w, c = a["x"].shape
            kh, kw, _, co = a["w"].shape
            geometry = (nb, h, w, c, kh, kw, co, *strides(a), a["pad_h"],
                        a["pad_w"])
            d = a.get("dilation", 1)
            if d == 1:
                rc = lib.fcnn_conv_implicit_gemm(
                    *ptrs, *geometry, *codes, *scales, *tail, st)
            else:
                rc = lib.fcnn_conv_implicit_gemm_dilated(
                    *ptrs, *geometry, d, *codes, *scales, *tail, st)
        check(rc == 0, f"{what}: CUDA error {rc}")
    return run


_FLOAT_ALT_MS = {}


def float_other_plans_ms(kernel, a, want):
    """{plan: median ms} of a "wgmma_w8" or "wgmma_bf16" GEMM launch on the
    plans it did not take, launched through the C entry point on the same
    tensors with the plan forced (``forced_launch``), each held within the
    float gate of ``want`` (the plain version of the launch's sum order);
    timed once per shape: for "wgmma_w8", "simt", the body these launches
    took before (5 runs: the largest VGG-16 launch takes ~28 ms on it),
    and, for a matrix whose K the plan splits, "unsplit" (the same body on
    its 128 x BN tiles alone, one block each).  (The body "wgmma_bf16"
    replaced is gone from this tree: tools/split_gemm_probe.py --root
    times it in the parent's.)"""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import GemmPlan
    key = (kernel, tuple(a["x"].shape), tuple(a["w"].shape), a.get("stride"),
           want.dtype)
    if key in _FLOAT_ALT_MS:
        return _FLOAT_ALT_MS[key]
    taken = gemm_plan_of(kernel, a)
    plans = ({"simt": GemmPlan("simt", ldw=taken.ldw)}
             if taken.variant == "wgmma_w8" else {})
    if taken.split > 1:
        m, _, n = dims(kernel, a)
        plans["unsplit"] = taken._replace(
            split=1, grid=-(-m // 128) * -(-n // taken.bn))
    res = {}
    for name, plan in plans.items():
        out = torch.empty(want.shape, dtype=want.dtype, device=want.device)
        run = forced_launch(kernel, a, out, plan, f"{kernel} on {name}")
        run()
        err, ok, _ = compare(out, want, "float")
        check(ok, f"{kernel} x{tuple(a['x'].shape)} on {name}: max err {err}")
        res[name] = (median_ms(run, reps=5, warmup=1) if name == "simt"
                     else median_ms(run))
    _FLOAT_ALT_MS[key] = res
    return res


_RAGGED_OLD_MS = {}


def ragged_old_body_ms(kernel, a, want):
    """{"mma_sync": median ms} of a "wgmma_ragged" launch on the body such
    launches took before ("mma_sync", the first body), with the plan
    forced through the C entry point on the same tensors
    (``forced_launch``), held equal to ``want`` (the plain version: int8
    0 LSB, bf16 1 ulp); timed once per shape."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import GemmPlan
    key = (kernel, tuple(a["x"].shape), tuple(a["w"].shape), a.get("stride"),
           a.get("pad_h"), a.get("dilation", 1), want.dtype)
    if key not in _RAGGED_OLD_MS:
        # (the plain conv's output has the f64 conv's permuted strides)
        out = torch.empty(want.shape, dtype=want.dtype, device=want.device)
        plan = GemmPlan("mma_sync", ldw=gemm_plan_of(kernel, a).ldw)
        run = forced_launch(kernel, a, out, plan, f"{kernel} on mma_sync")
        run()
        err, ok, _ = compare(out, want)
        check(ok, f"{kernel} x{tuple(a['x'].shape)} on mma_sync: max err "
              f"{err}")
        _RAGGED_OLD_MS[key] = {"mma_sync": median_ms(run)}
    return _RAGGED_OLD_MS[key]


_SPLIT_ALT_MS = {}


def split_other_plans_ms(kernel, a, want):
    """{plan: median ms} of an int8 launch whose plan splits K, on the
    plans it did not take, forced through the C entry point on the same
    tensors (``forced_launch``), each held equal to ``want`` (the plain
    version: int8 0 LSB, bf16 1 ulp): "unsplit" (the planner's plan
    without the split, the plan such launches took before) and the other
    tile width with as many slices as fill the SMs (``split_k``: "BN 128
    split s", or "BN 64 split s" where the plan's tile is 128 wide; the
    rule's plan with that tile, its stages as many as fit); timed once
    per shape."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import (
        MAX_STAGES, SMEM_LIMIT, _sm_count, _wgmma_plan, split_k, wgmma_smem)
    key = (kernel, tuple(a["x"].shape), tuple(a["w"].shape), a.get("stride"),
           a.get("pad_h"), a.get("dilation", 1), want.dtype)
    if key in _SPLIT_ALT_MS:
        return _SPLIT_ALT_MS[key]
    taken = gemm_plan_of(kernel, a)
    m, k, n = dims(kernel, a)
    sms = _sm_count(a["x"].device.index or 0)
    conv, osize = kernel == "conv2d_implicit_gemm", want.element_size()
    bn, k_steps, row_tiles = (64 if taken.bn == 128 else 128,
                              -(-k // taken.bk), -(-m // 128))
    split = split_k(row_tiles * -(-n // bn), k_steps, sms)

    def smem(stages):
        return wgmma_smem(bn, taken.bk, stages, k_steps, False, osize, conv,
                          0, 0)
    stages = min(MAX_STAGES, (SMEM_LIMIT - smem(0)) // (smem(1) - smem(0)))
    units = row_tiles * -(-n // bn) * split
    other = taken._replace(bn=bn, split=split, stages=stages,
                           smem=smem(stages), grid=units if units <= sms
                           else max(sms // -(-n // bn), 1) * -(-n // bn))
    plans = {"unsplit": _wgmma_plan(taken.variant, m, k, n, osize, conv,
                                    sms, taken.ldw, taken.reason,
                                    split=False),
             f"BN {bn} split {split}": other}
    res = {}
    for name, plan in plans.items():
        # (the plain conv's output has the f64 conv's permuted strides)
        out = torch.empty(want.shape, dtype=want.dtype, device=want.device)
        run = forced_launch(kernel, a, out, plan, f"{kernel} on {name}")
        run()
        err, ok, _ = compare(out, want)
        check(ok, f"{kernel} x{tuple(a['x'].shape)} on {name}: max err "
              f"{err}")
        res[name] = median_ms(run)
    _SPLIT_ALT_MS[key] = res
    return res


_GROUPED_ALT_MS = {}


def ungrouped(wc, group, q):
    """The grouped HWIO weight (KH, KW, C/g, Co) that ``grouped_layout(w,
    group, q)`` compacted into ``wc``."""
    import torch
    kh, kw, s, co = wc.shape
    cgi, cgo = s // q, co // group
    slot = (torch.arange(co, device=wc.device) // cgo) % q
    idx = slot[:, None] * cgi + torch.arange(cgi, device=wc.device)[None, :]
    return wc.permute(3, 0, 1, 2).gather(
        3, idx[:, None, None, :].expand(co, kh, kw, cgi)).permute(1, 2, 3, 0)


def grouped_other_plans_ms(a, want):
    """{plan: median ms} of a super-group launch (group g, q, S) on the
    plan it did not take, forced through the C entry point on the same x
    (``forced_launch``) and held equal to ``want`` (the plain version: int8
    0 LSB, bf16 1 ulp): "block-diagonal", the plan these launches took
    before (the dense block-diagonal weight, made here from the compact
    one, on an ungrouped "wgmma" plan); timed once per shape."""
    import torch
    from feathercnn_tpu_torch.kernels.dispatch import block_diagonal
    from feathercnn_tpu_torch.kernels.matmul import (
        _sm_count, gemm_layout, gemm_plan, grouped_layout)
    key = (tuple(a["x"].shape), tuple(a["w"].shape), a["stride"],
           a["pad_h"], a.get("groups"), want.dtype)
    if key in _GROUPED_ALT_MS:
        return _GROUPED_ALT_MS[key]
    group, q, _ = supergroup_of(a)
    x, wc = a["x"], a["w"]
    c, kh, kw, co = x.shape[3], wc.shape[0], wc.shape[1], wc.shape[3]
    m = dims(GEMMS[1], a)[0]
    wg = ungrouped(wc, group, q)
    check(torch.equal(grouped_layout(wg, group, q), wc),
          "ungrouped() does not invert grouped_layout")
    dense = gemm_layout(block_diagonal(wg, group))
    plan = gemm_plan(m, kh * kw * c, co, x.dtype, dense.dtype, want.dtype,
                     conv_c=c, x_ptr=x.data_ptr(), w_ptr=dense.data_ptr(),
                     sms=_sm_count(x.device.index or 0))
    out = torch.empty(want.shape, dtype=want.dtype, device=want.device)
    run = forced_launch(GEMMS[1], dict(a, w=dense), out, plan,
                        "grouped conv on block-diagonal")
    run()
    err, ok, _ = compare(out, want)
    check(ok, f"grouped conv x{tuple(x.shape)} on block-diagonal ({plan}): "
          f"max err {err}")
    res = {"block-diagonal": median_ms(run)}
    _GROUPED_ALT_MS[key] = res
    return res


def halo_bytes(a, plan):
    """Bytes of x a "wgmma_halo" launch brings from L2: each tile's halo,
    all C channels (its column-tile groups' halos together)."""
    from feathercnn_tpu_torch.kernels.matmul import halo_images
    nb, oh, ow, c, _, _ = dims("depthwise", a)
    st = a["stride"]
    ti = halo_images(plan.th, plan.tw, oh, ow)
    rects = -(-nb // ti) * -(-oh // plan.th) * -(-ow // plan.tw)
    return (rects * ti * ((plan.th - 1) * st + 3) * ((plan.tw - 1) * st + 3)
            * c)


_CHAIN_ALT_MS = {}


def chain_alt_ms(a, want):
    """{plan: median ms} of an int8 chain call on the plans it did not
    take, launched block by block through the C entry point on the same
    tensors (uncounted), each held bit-equal to ``want`` (the call's own
    output): "mma_sync" (the first body, at tile_plan's tile), and "wgmma"
    with the other number of tiles per thread block (two for one, one for
    two), where that fits."""
    import torch
    from feathercnn_tpu_torch.kernels import fused_chain as fc
    x = a["x"]
    n, h, w, c = x.shape
    cm = a["w1"].shape[2]
    out_dtype = fc._out_dtype(x, a["out_dtype"], a["scales"])
    key = (tuple(x.shape), cm, a["w1"].shape[0], out_dtype)
    if key in _CHAIN_ALT_MS:
        return _CHAIN_ALT_MS[key]
    plan = fc.chain_plan(n, h, w, c, cm, 1)
    th, tw = fc.tile_plan(h, w, cm, 1)
    plans = {"mma_sync": fc.ChainPlan(
        "mma_sync", th, tw, 1, 3, 0, False, fc.smem_bytes(th, tw, cm, 1),
        n * -(-h // th) * -(-w // tw), "timed beside wgmma")}
    if plan.variant == "wgmma":
        try:
            plans["wgmma at the other tiles a block"] = fc.chain_plan(
                n, h, w, c, cm, 1, per_cta=3 - plan.tiles_per_cta)
        except ValueError as e:
            say("kernels", f"fused_chain x{tuple(x.shape)}: {e}")
    res = {}
    for name, pl in plans.items():
        def run(pl=pl):
            return fc._launch_blocks(x, a["w1"], a["b1"], a["w2"], a["b2"],
                                     a["w3"], a["b3"], a["w_scales"],
                                     a["scales"], out_dtype,
                                     lambda *_: pl, False)
        check(torch.equal(run(), want), f"fused_chain x{tuple(x.shape)} on "
              f"{pl} differs from its plan's output")
        res[name] = median_ms(run)
    say("kernels", f"fused_chain x{tuple(x.shape)} Cm={cm}: plan "
        f"{plan.variant}, {plan.th}x{plan.tw} tiles, {plan.tiles_per_cta} a "
        f"block, {plan.stages} stages, grid {plan.grid}; timed beside on "
        + "; ".join(f"{name} ({pl.tiles_per_cta} a block, {pl.stages} "
                    f"stages)" for name, pl in plans.items()))
    _CHAIN_ALT_MS[key] = res
    return res


def describe(kernel, a, out):
    dt = str(out.dtype).replace("torch.", "")
    if kernel == "stem_conv_int8":
        kh, kw, _, co = a["w"].shape
        return (f"stem_conv_int8 x{tuple(a['x'].shape)} {kh}x{kw} "
                f"s{tuple(a['stride'])} p{tuple(a['padding'])} Co={co} "
                f"{a['activation']}")
    if kernel == "eltwise_int8":
        from feathercnn_tpu_torch.kernels.eltwise import row_pitch
        c = a["x0"].shape[-1]
        rows = [f"x{i} " + (f"rows at pitch {p}" if p is not None
                            else "copied")
                for i in (0, 1) if not a[f"x{i}"].is_contiguous()
                for p in [row_pitch(a[f"x{i}"], c)]]
        return (f"eltwise_int8 x{tuple(a['x0'].shape)} act={a['act']}"
                + (" (" + ", ".join(rows) + ")" if rows else ""))
    if kernel == "ident":
        return (f"ident x{tuple(a['x'].shape)} "
                f"{str(a['x'].dtype).replace('torch.', '')} "
                f"chunk={a['chunk']}")
    if kernel in CHAINS:
        return (f"{kernel} x{tuple(a['x'].shape)} nb={a['w1'].shape[0]} "
                f"Cm={a['w1'].shape[2]} out={dt}")
    d = dims(kernel, a)
    if kernel in ("matmul_epilogue", "conv2d_implicit_gemm"):
        xdt = str(a["x"].dtype).replace("torch.", "")
        return (f"{kernel} M={d[0]} K={d[1]} N={d[2]} x{tuple(a['x'].shape)} "
                f"{xdt} out={dt}" + (f" stride={a['stride']}" if "stride" in a
                                     else "")
                + (f" dilation={a['dilation']}" if a.get("dilation", 1) > 1
                   else "")
                + (" lo/hi" if a.get("lo") is not None else ""))
    x = a["x"] if "x" in a else a["xq"]
    return (f"{kernel} x{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}"
            f" {d[4]}x{d[5]} s{a['stride']} {a['activation']} out={dt}")


def other_plans_ms(name, a, out, ref, variant, split, sg):
    """{plan or tile: median ms} of a launch on the plans and tiles it did
    not take, each held to ``ref`` (or to ``out``, for a chain); None
    where there are none."""
    if name in ("depthwise_conv2d", "depthwise_conv2d_int8"):
        return dw_tile_ms(name, a, ref)
    if name == "fused_chain":
        return chain_alt_ms(a, out)
    if variant in ("wgmma_w8", "wgmma_bf16"):
        return float_other_plans_ms(name, a, ref) or None
    if variant not in ("wgmma", "wgmma_ragged", "wgmma_halo"):
        return None
    tiles = {}
    if variant == "wgmma_ragged":
        tiles.update(ragged_old_body_ms(name, a, ref))
    if split > 1:
        tiles.update(split_other_plans_ms(name, a, ref))
    if sg:
        tiles.update(grouped_other_plans_ms(a, ref))
    return tiles or None


def launch_rows(label, launches, groups=None, timed=True, detail=True):
    """Every recorded wrapper call of a path's forward, repeated on its own
    tensors, held to its plain version (``check``), bounded and, with
    ``timed``, timed; one row per call.  A row's ``ms`` is one whole call:
    for ``fused_chain`` that is its ``launches`` (one per block of the
    chain).  ``detail`` adds the plain version's, the library call's and
    the other plans' times (None without it).  A grouped int8 conv's
    launch (``groups`` > 1) must take the weight the engine kept for it
    (``groups``: data pointer -> (group, q), ``grouped_weights``); its
    bound counts the grouped conv's operations, its library call is the
    f32 grouped conv, and a super-group launch is also timed on the plans
    it did not take (``grouped_other_plans_ms``)."""
    import torch
    fns = _kernel_fns()
    rows = []
    for i, launch in enumerate(launches):
        name, a = launch["kernel"], launch["args"]
        group = a.get("groups", 1) if name == GEMMS[1] else 1
        sg = supergroup_of(a) if group > 1 else None
        if group > 1 and groups is not None:
            kept = groups.get(a["w"].data_ptr())
            check(kept == (group, sg[1] if sg else 0),
                  f"{label}: launch {i} (groups={group}) took a weight the "
                  f"engine did not keep for it: {kept}")
        float_sums = name == "fused_chain_float" or (
            name in ("matmul_epilogue", "conv2d_implicit_gemm")
            and a["x"].dtype != torch.int8)
        gate = ("bits" if name == "ident" else "float" if float_sums
                else "lsb1" if name == "stem_conv_int8" else "exact")
        kernel, plain = fns[name]
        out = kernel(**a)
        tiles = None
        variant = launch.get("variant")
        split = gemm_plan_of(name, a).split if name in GEMMS else 1
        if name == "fused_chain_float":
            max_err, ok, over, elements = per_launch(a, out)
        else:
            if variant == "wgmma_bf16":   # held to its split order
                from feathercnn_tpu_torch.kernels.matmul import \
                    matmul_epilogue_split_plain
                ref = matmul_epilogue_split_plain(split=split, **a)
            else:
                ref = plain(**a)
            max_err, ok, over = compare(out, ref, gate)
            elements = out.numel()
            if detail:
                tiles = other_plans_ms(name, a, out, ref, variant, split, sg)
            del ref
        desc = describe(name, a, out) + (
            f" super-group g={group} q={sg[1]} S={sg[2]}" if sg
            else f" block-diagonal g={group}" if group > 1 else "")
        check(ok, f"{label}: launch {i}, {desc}: kernel differs from plain, "
              f"max err {max_err}, {over} elements over 1 ulp")
        b_ms, b_by = bound_ms(name, a, out, group)
        rows.append({"path": label, "kernel": row_kernel(launch),
                     "counted": counted_as(launch),
                     "shape": desc,
                     "x_shape": tuple(x_arg(a).shape),
                     "x_bytes": x_arg(a).numel() * x_arg(a).element_size(),
                     "over_1ulp": over, "elements": elements,
                     "float_sums": float_sums,
                     "launches": launches_of(launch),
                     "variant": variant, "split": split,
                     "max_abs_err": max_err,
                     "ms": median_ms(lambda: kernel(**a)) if timed else None,
                     "plain_ms": (median_ms(lambda: plain(**a), reps=3,
                                            warmup=1) if detail else None),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "group": group,
                     "library_ms": (library_ms(name, a, group) if detail
                                    else None),
                     "library_padded": (detail
                                        and library_padded(name, a, group)),
                     "library_bf16_ms": (_library_bf16_grouped(a, group)
                                         if detail and group > 1 else None),
                     # a super-group launch: its products' (zeros too)
                     # bound on the int8 peak, A's bytes from L2 in its
                     # halos, and those a gather of every tap of every row
                     # would move (M * KH * KW * C)
                     "sg_ops_ms": (2.0 * dims(name, a)[0] * a["w"].shape[3]
                                   * math.prod(a["w"].shape[:3])
                                   / PEAK_INT8_OPS * 1e3 if sg else None),
                     "halo_bytes": (halo_bytes(a, gemm_plan_of(name, a))
                                    if sg else None),
                     "gather_bytes": (dims(name, a)[0] * dims(name, a)[1]
                                      if sg else None),
                     "tiles": tiles})
    return rows


def kernels_vs_plain(label, launches, groups=None):
    """``launch_rows`` of a path's forward, timed in full, and what they
    say per launch shape and per kind of launch."""
    rows = launch_rows(label, launches, groups)
    for desc in dict.fromkeys(r["shape"] for r in rows):
        same = [r for r in rows if r["shape"] == desc]
        lib = same[0]["library_ms"]
        med = statistics.median(r["ms"] for r in same)
        over = sum(r["over_1ulp"] for r in same)
        within = ("within the float-sum gates" if same[0]["float_sums"]
                  else "within 1 LSB of plain"
                  if same[0]["kernel"] == "stem_conv_int8"
                  else "equal to plain")
        say("kernels", f"{desc}: {len(same)} calls, "
            f"{sum(r['launches'] for r in same)} launches, every one {within} "
            f"(max err {max(r['max_abs_err'] for r in same)}, {over} of "
            f"{sum(r['elements'] for r in same)} elements over 1 bf16 ulp); "
            f"median {med:.4f} ms per call, bound "
            f"{same[0]['bound_ms']:.4f} ms ({same[0]['bound_by']}, "
            f"{100 * same[0]['bound_ms'] / med:.1f}% of it), plain "
            f"{statistics.median(r['plain_ms'] for r in same):.3f} ms, "
            + _library_name(desc) + f" {lib if lib is None else round(lib, 4)}"
            + (" (on operands zero-padded to its rules)"
               if same[0]["library_padded"] else "")
            + ("" if lib is None else f" ({med / lib:.2f}x library)")
            + ("" if same[0]["library_bf16_ms"] is None else
               f", bf16 F.conv2d(groups) {same[0]['library_bf16_ms']:.4f} "
               f"({med / same[0]['library_bf16_ms']:.2f}x)")
            + (f", variant {same[0]['variant']}" if same[0]["variant"]
               else "")
            + (f" split {same[0]['split']}" if same[0]["split"] > 1 else "")
            + ("" if not same[0]["tiles"] else (
                ", other tiles " if same[0]["kernel"].startswith("depthwise")
                else ", other plans ") + ", ".join(
                f"{t} {ms:.4f}" for t, ms in same[0]["tiles"].items())))
    chains = [r for r in rows if r["kernel"] == "fused_chain" and r["tiles"]]
    if chains:
        other = {}
        for r in chains:
            for t, ms in r["tiles"].items():
                other[t] = other.get(t, 0.0) + ms
        say(label, f"int8 chain calls of one forward: "
            f"{sum(r['ms'] for r in chains):.4f} ms on the plan's "
            f"{'+'.join(dict.fromkeys(r['variant'] for r in chains))}, "
            + ", ".join(f"{v:.4f} on {t}" for t, v in other.items())
            + " (each equal to the plan's output)")
    w8 = [r for r in rows if r["variant"] == "wgmma_w8"]
    for kern in GEMMS:
        mine = [r for r in w8 if r["kernel"] == kern]
        if mine:
            unsplit = [r for r in mine if "unsplit" in r["tiles"]]
            say(label, f"{kern} weight-only launches of one forward: "
                f"{sum(r['ms'] for r in mine):.4f} ms on wgmma_w8, "
                f"{sum(r['tiles']['simt'] for r in mine):.4f} on simt "
                f"(the earlier body, each within the float gate), bound "
                f"{sum(r['bound_ms'] for r in mine):.4f}, library "
                f"{sum(r['library_ms'] for r in mine):.4f}"
                + (f"; the {len(unsplit)} split-K launches "
                   f"{sum(r['ms'] for r in unsplit):.4f} ms, unsplit "
                   f"{sum(r['tiles']['unsplit'] for r in unsplit):.4f}"
                   if unsplit else ""))
    split_lines(label, rows)
    for kern in GEMMS:
        mine = [r for r in rows if RAGGED[kern] in r["counted"]]
        if mine:
            sums = _sums(mine)
            old = sum(r["tiles"]["mma_sync"] for r in mine)
            say(label, f"{kern} ragged launches of one forward: {len(mine)}"
                f", {sums['ms']:.4f} ms on wgmma_ragged, bound "
                f"{sums['bound_ms']:.4f} ms "
                f"({100 * sums['bound_ms'] / sums['ms']:.1f}% of it), "
                f"{old:.4f} on mma_sync (the old body, each equal "
                f"to plain; {old / sums['ms']:.2f}x), plain "
                f"{sums['plain_ms']:.3f}, library _int_mm "
                + ("none" if sums["library_ms"] is None else
                   f"{sums['library_ms']:.4f} "
                   f"({sums['ms'] / sums['library_ms']:.2f}x")
                + f"; {sum(r['library_padded'] for r in mine)} of them on "
                f"zero-padded operands)")
    mine = [r for r in rows if r["kernel"] == "eltwise_int8"]
    if mine:
        sums = _sums(mine)
        say(label, f"eltwise_int8 launches of one forward: {len(mine)}, "
            f"{sums['ms']:.4f} ms, byte bound {sums['bound_ms']:.4f} ms "
            f"({100 * sums['bound_ms'] / sums['ms']:.1f}% of it), the PyTorch "
            f"composition it replaced {sums['library_ms']:.4f} ms "
            f"({sums['library_ms'] / sums['ms']:.1f}x the kernel), plain "
            f"{sums['plain_ms']:.3f} ms")
    mine = [r for r in rows if r["kernel"] == "stem_conv_int8"]
    if mine:
        sums = _sums(mine)
        say(label, f"stem_conv_int8 launches of one forward: {len(mine)}, "
            f"{sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
            f"({mine[0]['bound_by']}, "
            f"{100 * sums['bound_ms'] / sums['ms']:.1f}% of it), cuDNN's f32 "
            f"conv + PyTorch's epilogue {sums['library_ms']:.4f} ms "
            f"({sums['library_ms'] / sums['ms']:.1f}x the kernel), plain "
            f"{sums['plain_ms']:.3f} ms; "
            f"{sum(r['over_1ulp'] for r in mine)} of "
            f"{sum(r['elements'] for r in mine)} int8 values 1 LSB off plain")
    for var in ("k3s1", "k3s2"):
        mine = [r for r in rows if r["tiles"] and r["variant"] == var]
        if not mine:
            continue
        other = {}
        for r in mine:
            for t, ms in r["tiles"].items():
                other[t] = other.get(t, 0.0) + ms
        say(label, f"depthwise {var} launches of one forward: "
            f"{sum(r['ms'] for r in mine):.4f} ms at the plan's tiles, "
            + ", ".join(f"{v:.4f} at {t}" for t, v in other.items()))
    return rows


def split_lines(label, rows):
    """The path's lines for the launches this slice redesigned: its int8
    launches whose plan splits K (launches, splits, ms split and unsplit,
    the other tile width's; each launch more than 3% slower split than
    unsplit named), and its bf16 x bf16 ones on "wgmma_bf16" (ms beside
    unsplit, the bound and ``torch.matmul``)."""
    split = [r for r in rows if r["split"] > 1
             and r["variant"] in ("wgmma", "wgmma_ragged")]
    if split:
        new = sum(r["ms"] for r in split)
        old = sum(r["tiles"]["unsplit"] for r in split)
        alt = sum(ms for r in split for t, ms in r["tiles"].items()
                  if t.startswith("BN "))
        by_kernel = {k: sum(k in r["counted"] for r in split)
                     for k in (*GEMMS, DILATED)}
        splits = {}
        for r in split:
            splits[r["split"]] = splits.get(r["split"], 0) + 1
        slower = [f"{r['shape']} {r['ms']:.4f} vs {r['tiles']['unsplit']:.4f}"
                  for r in split if r["ms"] > 1.03 * r["tiles"]["unsplit"]]
        say(label, f"split launches of one forward: {len(split)} "
            f"({by_kernel}), split {splits}: {new:.4f} ms split, "
            f"{old:.4f} ms unsplit (the earlier plan; each equal to plain; "
            f"{old / new:.2f}x), {alt:.4f} ms on the other tile width; "
            f"more than 3% slower split: {len(slower)}"
            + ("".join(f"; {s}" for s in slower)))
    bf = [r for r in rows if r["variant"] == "wgmma_bf16"]
    if bf:
        sums = _sums(bf)
        unsplit = [r["tiles"]["unsplit"] for r in bf
                   if r["tiles"] and "unsplit" in r["tiles"]]
        say(label, f"bf16 x bf16 launches of one forward: {len(bf)}, split "
            f"{sorted({r['split'] for r in bf})}, {sums['ms']:.4f} ms on "
            f"wgmma_bf16 (each within the float gate of the split-order "
            f"plain)" + (f", unsplit {sum(unsplit):.4f}" if unsplit else "")
            + f", bound {sums['bound_ms']:.4f} ms "
            f"({100 * sums['bound_ms'] / sums['ms']:.1f}% of it), "
            f"torch.matmul {sums['library_ms']:.4f} "
            f"({sums['ms'] / sums['library_ms']:.2f}x)")


def _library_name(desc):
    if desc.startswith("fused_chain"):
        return "library: none"
    if "block-diagonal" in desc or "super-group" in desc:
        return f"f32 F.conv2d(groups={desc.split(' g=')[1].split()[0]})"
    if desc.startswith("ident"):
        return "x.clone()"
    if desc.startswith("eltwise_int8"):
        return "PyTorch's composition"
    if desc.startswith("stem_conv_int8"):
        return "cuDNN's f32 conv + PyTorch's epilogue"
    if "depthwise" in desc:
        return "bf16 F.conv2d(groups=C)"
    if "dilation=" in desc:
        return "bf16 F.conv2d(dilation)"
    if " int8 " in desc:
        return "_int_mm"
    return ("bf16 F.conv2d" if desc.startswith("conv2d_implicit_gemm")
            else "torch.matmul")


# ----------------------------------------------------------------------
# phase 4
# ----------------------------------------------------------------------
def ops_per_batch(graph):
    """2 x the multiply-adds of every conv and FC of the optimized graph
    at its declared batch (the fp stem included), and of every fused
    bottleneck (as feathercnn_tpu/utils/summary.py counts them)."""
    total = 0
    for n in graph.nodes:
        if n.op in ("FusedBottleneck", "FusedChain"):
            bn, oh, ow, c = graph.specs[n.outputs[0]].shape
            cm = graph.params[n.params[0]].shape[-1]
            total += (2 * bn * oh * ow * (2 * c * cm + 9 * cm * cm)
                      * n.attrs.get("nb", 1))
            continue
        if n.op == "Deconvolution":
            # every input pixel times every tap, into each output channel
            inp = graph.specs[n.inputs[0]].shape
            w = graph.params[n.params[0]].shape      # HWIO (kh, kw, cin/g, co)
            total += 2 * int(np.prod(inp[:3])) * int(np.prod(w))
            continue
        if n.op not in ("Convolution", "InnerProduct"):
            continue
        out = graph.specs[n.outputs[0]].shape
        w = graph.params[n.params[0]].shape
        macs_per_out = np.prod(w[:-1])     # HWIO (kh*kw*cin/g) or (in, out)
        total += 2 * int(np.prod(out)) * int(macs_per_out)
    return total


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def agreement(label, g, cfg, eng, x, out):
    """Images 0-1 (0 at batch 1) through the port on the CPU against the
    card: top-1 equal and the prob cosine >= 0.999; on the classic zoo's
    paths (``LOGIT_AGREEMENT``) the cosine of the logits too, and on a
    path of ``PROB_WITNESS`` that alone, the prob cosine printed.  A
    segmentation path (``SEGMENTATION``) holds its first image: the
    per-pixel top-1 class equal at >= ``PIXEL_AGREEMENT`` of the pixels
    and the cosine of the whole probability map >= 0.999."""
    import torch
    from feathercnn_tpu_torch import Engine
    cpu = Engine(g, cfg, device="cpu")
    if label in SEGMENTATION:
        ref = cpu(x[:1]).double().numpy()[0]
        got = out[:1].double().cpu().numpy()[0]
        same = float((ref.argmax(-1) == got.argmax(-1)).mean())
        cos = _cosine(got.ravel(), ref.ravel())
        check(same >= PIXEL_AGREEMENT, f"{label} image 0: per-pixel top-1 "
              f"agreement {same}")
        check(cos >= 0.999, f"{label} image 0: prob cosine {cos}")
        say("agreement", f"{label} image 0: per-pixel top-1 equal at "
            f"{100 * same:.4f}% of {ref.shape[0] * ref.shape[1]} pixels "
            f"(>= {100 * PIXEL_AGREEMENT:.1f}%), prob cosine {cos:.6f} "
            f"(>= 0.999), max |prob diff| {float(np.abs(got - ref).max()):.3e}")
        return
    if label in DETECTION:
        detection_agreement(label, cpu, eng, x)
        return
    k = min(2, len(x))
    ref = cpu(x[:k]).double().numpy().reshape(k, -1)
    got = out[:k].double().cpu().numpy().reshape(k, -1)
    on_logits = label in LOGIT_AGREEMENT
    if on_logits:
        (blob,) = (n.inputs[0] for n in eng.graph.nodes if n.op == "Softmax")
        ref_l = cpu.run(x[:k], extract=[blob])[blob].double().numpy()
        got_l = eng.run(torch.from_numpy(x[:k]).cuda(), extract=[blob])[
            blob].double().cpu().numpy()
        ref_l, got_l = ref_l.reshape(k, -1), got_l.reshape(k, -1)
    for i in range(k):
        cos = _cosine(got[i], ref[i])
        check(got[i].argmax() == ref[i].argmax(),
              f"{label} image {i}: top-1 {got[i].argmax()} on the card, "
              f"{ref[i].argmax()} on the CPU")
        if label in PROB_WITNESS:
            held = (f"prob cosine {cos:.6f} (held on the logits; "
                    f"{PROB_WITNESS[label][0]} holds it)")
        else:
            check(cos >= 0.999, f"{label} image {i}: prob cosine {cos}")
            held = f"prob cosine {cos:.6f} (>= 0.999)"
        if on_logits:
            cos_l = _cosine(got_l[i], ref_l[i])
            check(cos_l >= 0.999, f"{label} image {i}: logit cosine {cos_l}")
            held += (f", logit cosine {cos_l:.6f} (>= 0.999; max |diff| "
                     f"{float(np.abs(got_l[i] - ref_l[i]).max()):.3e})")
        say("agreement", f"{label} image {i}: top-1 {int(got[i].argmax())} "
            f"on both, {held}, max |prob diff| "
            f"{float(np.abs(got[i] - ref[i]).max()):.3e}")


def _kernel_group(key):
    if "fused_float_block_kernel" in key:
        return "fused_chain_float"
    if "fused_block_kernel" in key:
        return "fused_chain"
    if "ident_kernel" in key:
        return "ident"
    if "eltwise_int8_kernel" in key:
        return "eltwise_int8"
    if "stem_conv_kernel" in key:
        return "stem_conv_int8"
    if "dw_kernel" in key:      # dw_kernel<TX, S, INT_W, ...>, mangled or not
        return ("depthwise_conv2d_int8"
                if "Lb1E" in key or ", true," in key else "depthwise_conv2d")
    if "hgemm_kernel" in key:    # the super-group halo kernel: conv only
        return "conv2d_implicit_gemm"
    if any(k in key for k in ("wgemm_kernel", "igemm_kernel",
                              "fgemm_kernel", "w8gemm_kernel",
                              "splitk_reduce_kernel")):
        return ("conv2d_implicit_gemm" if "ConvA" in key
                else "matmul_epilogue")
    if "at::native" in key:
        return "PyTorch's own ops"
    return ("cuDNN/cuBLAS (the float convs; the Winograd path's transforms "
            "and GEMMs)")


def device_spans(prof):
    """(name, µs) of every kernel, copy and set the profiled run put on
    the card, each from its start, or from the end of every one before it
    where that is later, to its end.  A programmatic dependent launch (the
    split-K pass) starts its blocks while the kernel before it runs and
    waits in place for its results: that wait is not the pass's time.  On
    one stream the spans then add up to the union of the kernels'
    intervals, the card's busy time."""
    events = []
    for ev in prof.events():
        if (getattr(ev, "is_user_annotation", False)
                or "CUDA" not in str(getattr(ev, "device_type", ""))):
            continue
        events.append((ev.time_range.start, ev.time_range.end, ev.key))
    spans, end = [], -math.inf
    for start, stop, key in sorted(events):
        spans.append((key, max(0.0, stop - max(start, end))))
        end = max(end, stop)
    return spans


def forward_ms(fn, runs=10, warmup=2):
    """Median host ms of ``fn`` run to a synchronize, over ``runs`` calls
    after ``warmup`` more."""
    import torch
    times = []
    for _ in range(warmup + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warmup:])


def speed_and_profile(label, eng, x, smi):
    """Median ms per batch over 10 synchronized forwards (input on the
    card), images/s, and one profiled forward's device time by kernel.
    Returns the median ms and the profiled forward's device ms by graph
    node (the engine's per-node profiler ranges; {} where not measured)."""
    import torch
    xd = to_card(x)
    ms = forward_ms(lambda: eng(xd))
    ops = ops_per_batch(eng.graph)
    batch = batch_of(x)
    what, kind, peak = {
        "w8a8": ("w8a8 bf16", "int8", PEAK_INT8_OPS),
        "w8": ("w8 bf16", "bf16", PEAK_BF16_OPS)}.get(
            eng.config.quant,
            ("fp32", "f32 (FMA)", PEAK_F32_OPS)
            if eng.config.compute_dtype == "float32"
            else ("no quantization", "bf16", PEAK_BF16_OPS))
    say("speed", f"{label} {what}: median {ms:.2f} ms per batch, "
        f"{batch / ms * 1e3:.1f} images/s, {ops / batch / 1e9:.3f} GOP per "
        f"image, {ops / ms / 1e9:.1f} TOP/s = "
        f"{100 * ops / ms * 1e3 / peak:.2f}% of the dense {kind} "
        f"peak (input on the card; {smi})")

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng(xd)
        torch.cuda.synchronize()
    del xd
    nodes = {n.name for n in eng.graph.nodes}
    node_ms = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        # a node's range as the card ran it: from the start of its first
        # kernel to the end of its last (the host-side range links only
        # PyTorch's own kernels, not the hand kernels)
        if (getattr(ev, "is_user_annotation", False) and ev.key in nodes
                and "CUDA" in str(getattr(ev, "device_type", ""))):
            node_ms[ev.key] = dev_us / 1e3
    by_key = {}
    for key, us in device_spans(prof):
        t, c = by_key.get(key, (0.0, 0))
        by_key[key] = (t + us, c + 1)
    rows = sorted(((t, c, key) for key, (t, c) in by_key.items() if t),
                  reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        say("profile", f"{label}: device time not measured (the profiler "
            "saw no CUDA kernels)")
        return ms, {}
    BUSY[label] = total / 1e3
    groups = {}
    for us, cnt, key in rows:
        grp = _kernel_group(key)
        t, c = groups.get(grp, (0.0, 0))
        groups[grp] = (t + us, c + cnt)
    say("profile", f"{label}: device kernel time of one forward (the "
        "union of its kernels' spans, a split-K pass from the end of its "
        "main loop): "
        f"{total / 1e3:.3f} ms over {sum(r[1] for r in rows)} kernels, busy "
        f"{100 * total / 1e3 / ms:.1f}% of the median forward; "
        + ", ".join(f"{k} {v / 1e3:.3f} ms x{c} ({100 * v / total:.1f}%)"
                    for k, (v, c) in sorted(groups.items(),
                                            key=lambda kv: -kv[1][0])))
    for us, cnt, key in rows[:12]:
        say("profile", f"{us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
            f"x{cnt} {key[:90]}")
    if node_ms:
        say("profile", f"{label}: the card's ranges of {len(node_ms)} of "
            f"{len(nodes)} graph nodes span {sum(node_ms.values()):.3f} ms "
            f"in all, against {total / 1e3:.3f} ms of kernel time")
        by_op = {}
        for n in eng.graph.nodes:
            if n.name not in node_ms:
                continue
            op = n.op
            if n.op == "Convolution" and eng.config.algo_for(n.name):
                op += f" ({eng.config.algo_for(n.name)})"
            t, c = by_op.get(op, (0.0, 0))
            by_op[op] = (t + node_ms[n.name], c + 1)
        say("profile", f"{label}: node ranges by op: " + ", ".join(
            f"{op} {t:.3f} ms x{c}" for op, (t, c) in sorted(
                by_op.items(), key=lambda kv: -kv[1][0])))
    else:
        say("profile", f"{label}: device time by node not measured (no "
            "node range carried device time)")
    return ms, node_ms


def region_nodes(graph, x_val, out_val):
    """Names of the nodes of ``graph`` that compute ``out_val`` from
    ``x_val`` (a fused chain's region on the unchained graph)."""
    producer = {v: n for n in graph.nodes for v in n.outputs}
    names, todo = set(), [out_val]
    while todo:
        v = todo.pop()
        n = producer.get(v)
        if v == x_val or n is None or n.name in names:
            continue
        names.add(n.name)
        todo += n.inputs
    return names


def chains_beside_unchained(rows, chained, unchained, node_ms):
    """Each chain call of a fuse_chains path (a FusedChain or a single
    FusedBottleneck) beside the device time that the same blocks' nodes
    took in the unchained path's profiled forward, and the design's own
    traffic between blocks (computed, not measured: each block but the
    last writes its output, the next reads it)."""
    chains = [n for n in chained.nodes
              if n.op in ("FusedChain", "FusedBottleneck")]
    calls = [r for r in rows if r["kernel"] in CHAINS]
    check(len(chains) == len(calls),
          f"{len(chains)} chain nodes, {len(calls)} chain calls")
    op_of = {n.name: n.op for n in unchained.nodes}
    for node, r in zip(chains, calls):
        region = region_nodes(unchained, node.inputs[0], node.outputs[0])
        by_op = {}          # op -> (nodes, ms, or None where not measured)
        for name in region:
            k, ms = by_op.get(op_of[name], (0, 0.0))
            got = node_ms.get(name)
            by_op[op_of[name]] = (k + 1, None if None in (ms, got)
                                  else ms + got)
        parts = [f"{k} {op} {'not measured' if ms is None else f'{ms:.4f} ms'}"
                 for op, (k, ms) in sorted(by_op.items())]
        times = [ms for _, ms in by_op.values()]
        if None not in times:
            parts.append(f"in all {sum(times):.4f} ms")
        nb, xs = node.attrs.get("nb", 1), r["x_shape"]
        say("chains", f"{node.name} x{xs} nb={nb}: {r['ms']:.4f} ms per call "
            f"({r['launches']} launches), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); the same blocks unchained: "
            + ", ".join(parts)
            + f"; {2 * (nb - 1) * r['x_bytes'] / 1e6:.1f} MB between "
            f"blocks (computed)")


def grouped_weights(eng):
    """{data pointer: (group, q)} of the weights the engine laid out for
    its grouped int8 convs (made at the first forward, kept under
    ``gemm_w/.../g<group>q<q>``): the compact super-group weight, or at q
    0 the block-diagonal one."""
    grouped = {n.name for n in eng.graph.nodes
               if n.op == "Convolution" and n.attrs.get("group", 1) > 1}
    out = {}
    for (node, key), t in eng._ctx._consts.items():
        if node in grouped and key.startswith("gemm_w/"):
            group, q = key.rsplit("/g", 1)[1].split("q")
            out[t.data_ptr()] = (int(group), int(q))
    return out


def run_path(label, g, cfg, eng, x, smi, check_launch=None):
    """Phases 2-4 of one path; returns its kernel rows, its median ms per
    batch and its profiled forward's device ms by graph node."""
    import torch
    out, launches = drive(label, eng, x)
    if check_launch is not None:
        for launch in launches:
            check_launch(launch)
    check_variants(label, launches)
    rows = kernels_vs_plain(label, launches, grouped_weights(eng))
    del launches
    grouped_lines(label, rows)
    for name in KERNELS:
        mine = rows_of(name, rows)
        if mine:
            sums = _sums(mine)
            say(label, f"{name} per forward: {len(mine)} calls, "
                f"{sum(r['launches'] for r in mine)} launches, "
                f"{sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms, "
                f"plain {sums['plain_ms']:.3f} ms, library "
                + ("none" if sums["library_ms"] is None
                   else f"{sums['library_ms']:.4f} ms"))
    agreement(label, g, cfg, eng, x, out)
    del out
    torch.cuda.empty_cache()
    ms, node_ms = speed_and_profile(label, eng, x, smi)
    return rows, ms, node_ms


def grouped_lines(label, rows):
    """A path's grouped int8 launches: their sums (ms, the grouped work's
    bound and its share, the super-group product's ops bound, A's bytes
    from L2 in the halos beside those a gather of each tap would move, both
    library calls, the block-diagonal plan's time and each launch slower
    than it)
    and one line per stage (input channels C)."""
    grouped = [r for r in rows if r["group"] > 1]
    if not grouped:
        return
    sums = _sums(grouped)
    sg = [r for r in grouped if r["sg_ops_ms"] is not None]

    def other(rs):
        tot = {}
        for r in rs:
            for t, ms in (r["tiles"] or {}).items():
                tot[t] = tot.get(t, 0.0) + ms
        return ", ".join(f"{t} {ms:.4f}" for t, ms in tot.items())
    bf16 = sum(r["library_bf16_ms"] for r in grouped)
    slower = [r for r in sg if r["ms"] > r["tiles"]["block-diagonal"]]
    say(label, f"the {len(grouped)} grouped int8 launches of one forward "
        f"({len(sg)} super-group): {sums['ms']:.4f} ms on "
        f"conv2d_implicit_gemm, bound {sums['bound_ms']:.4f} ms for the "
        f"grouped work ({100 * sums['bound_ms'] / sums['ms']:.1f}% of it), "
        f"the super-group product's ops bound "
        f"{sum(r['sg_ops_ms'] for r in sg):.4f} ms, A's bytes from L2 "
        f"{sum(r['halo_bytes'] for r in sg) / 1e9:.3f} GB in halos (a "
        f"gather of each tap: "
        f"{sum(r['gather_bytes'] for r in sg) / 1e9:.3f} GB); f32 "
        f"F.conv2d(groups) {sums['library_ms']:.4f} ms, bf16 "
        f"{bf16:.4f} ms ({sums['ms'] / bf16:.2f}x); the plan not taken "
        f"(equal to plain) {other(sg)}; slower than block-diagonal: "
        f"{len(slower)}"
        + "".join(f"; {r['shape']} {r['ms']:.4f} vs "
                  f"{r['tiles']['block-diagonal']:.4f}" for r in slower)
        + f"; variants {sorted({r['variant'] for r in grouped})}")
    for c in sorted({r["x_shape"][3] for r in sg}):
        mine = [r for r in sg if r["x_shape"][3] == c]
        ms = sum(r["ms"] for r in mine)
        bound = sum(r["bound_ms"] for r in mine)
        hb = sum(r["halo_bytes"] for r in mine) / 1e9
        gb = sum(r["gather_bytes"] for r in mine) / 1e9
        say(label, f"grouped stage C={c} ({mine[0]['shape'].split()[-2]}, "
            f"{len(mine)} launches): {ms:.4f} ms, bound {bound:.4f} "
            f"({100 * bound / ms:.1f}%), products' ops bound "
            f"{sum(r['sg_ops_ms'] for r in mine):.4f}, A's bytes from L2 "
            f"{hb:.3f} GB in halos (a gather of each tap: {gb:.3f} GB), bf16 "
            f"F.conv2d(groups) "
            f"{sum(r['library_bf16_ms'] for r in mine):.4f}; "
            f"{other(mine)}")


def winograd_check(label, eng, x):
    """One forward with the dispatcher's conv entry wrapped: each Winograd
    conv's output against ``F.conv2d`` (f32, TF32 off) on the same input
    and dequantized weight, plus bias and activation, within F(6,3)'s
    error (``WINOGRAD_RMS``, ``WINOGRAD_MAX`` against the pre-activation
    output)."""
    import torch
    import torch.nn.functional as F
    from feathercnn_tpu_torch.kernels import dispatch
    from feathercnn_tpu_torch.numerics import conv_hparams
    orig = dispatch.conv_forward
    worst = []

    def held(node, x, w, bias, ctx):
        out = orig(node, x, w, bias, ctx)
        if ctx.config.algo_for(node.name) != "winograd":
            return out
        _, _, _, _, ph, pw, _, _ = conv_hparams(node)
        wd = w.float()
        if w.dtype == torch.int8:
            wd = wd * torch.as_tensor(np.asarray(ctx.qinfo(node)["w_scale"],
                                                 np.float32), device=w.device)
        pre = F.conv2d(x.float().permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1),
                       padding=(ph, pw)).permute(0, 2, 3, 1)
        if bias is not None:
            pre = pre + bias
        act = node.attrs.get("activation")
        ref = (pre.clamp_min(0) if act == "relu" else
               pre.clamp(0, 6) if act == "relu6" else pre)
        err = (out.float() - ref).double()
        rms = float(err.pow(2).mean().sqrt()
                    / pre.double().pow(2).mean().sqrt())
        top = float(err.abs().max() / pre.abs().max())
        shape = tuple(x.shape) + (w.shape[3],)
        check(rms <= WINOGRAD_RMS and top <= WINOGRAD_MAX,
              f"{label}: Winograd conv x{shape}: RMS error {rms:.4f} of the "
              f"RMS, largest {top:.4f} of the largest (gates {WINOGRAD_RMS}, "
              f"{WINOGRAD_MAX})")
        worst.append((shape, rms, top))
        return out

    dispatch.conv_forward = held
    try:
        eng(x)
    finally:
        dispatch.conv_forward = orig
    torch.cuda.synchronize()
    check(len(worst) == WINOGRAD_CONVS,
          f"{label}: {len(worst)} Winograd convs, expected {WINOGRAD_CONVS}")
    for shape, rms, top in worst:
        say(label, f"Winograd conv x{shape[:4]} Co={shape[4]} vs F.conv2d "
            f"(f32): RMS error {rms:.4f} of the pre-activation RMS, largest "
            f"{top:.4f} of its largest")
    say(label, f"{len(worst)} Winograd convs within F(6,3)'s error (RMS <= "
        f"{WINOGRAD_RMS}, largest <= {WINOGRAD_MAX}); largest relative error "
        f"{max(t for _, _, t in worst):.4f}, largest RMS "
        f"{max(r for _, r, _ in worst):.4f}")


# ----------------------------------------------------------------------
# phase 5
# ----------------------------------------------------------------------
def ragged_cases():
    """Stride 2, C % 16 != 0, odd OW, ragged M/N/K, the lo/hi clamp and
    the float variants: off the main paths' shapes, each against the
    plain version."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import kernel_layout
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout

    fns = _kernel_fns()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def i8(*s, g=gen):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=g)

    def f32(*s, lo=0.5, hi=1.5, g=gen):
        return torch.rand(*s, device="cuda", generator=g) * (hi - lo) + lo

    def held(name, a, what):
        kernel, plain = fns[name]
        err, ok, _ = compare(kernel(**a), plain(**a))
        check(ok, f"{what}: {err}")

    n = 0
    for (nb, h, w, c, co, k, s, p) in [(4, 15, 13, 72, 40, 3, 2, 1),
                                       (2, 11, 7, 64, 64, 3, 2, 1),
                                       (2, 9, 9, 3, 24, 7, 2, 3),
                                       (1, 8, 10, 136, 130, 3, 1, 1)]:
        for out_dtype in (torch.int8, torch.bfloat16):
            a = dict(x=i8(nb, h, w, c), w=gemm_layout(i8(k, k, c, co)),
                     bias=f32(co),
                     w_scale=f32(co) * 1e-3, stride=s, pad_h=p, pad_w=p,
                     activation="relu", out_dtype=out_dtype, x_scale=0.02,
                     out_scale=0.5)
            held("conv2d_implicit_gemm", a,
                 f"conv {(nb, h, w, c, co, k, s)} {out_dtype}")
            n += 1
    for (m, k, nn) in [(1001, 72, 130), (129, 63, 64), (77, 2048, 1000)]:
        lo = torch.full((nn,), -math.inf, device="cuda")
        hi = torch.full((nn,), math.inf, device="cuda")
        lo[: nn // 2] = 0.0
        hi[nn // 4: nn // 2] = 6.0
        for extra in ({}, {"lo": lo, "hi": hi, "x_scale": 1.0}):
            a = dict(x=i8(m, k), w=gemm_layout(i8(k, nn)), bias=f32(nn),
                     w_scale=f32(nn) * 1e-3, activation=None,
                     out_dtype=torch.int8, x_scale=0.02, out_scale=0.6)
            a.update(extra)
            held("matmul_epilogue", a, f"matmul {(m, k, nn)} {sorted(extra)}")
            n += 1
    # the float variants (off the full-int8 path): f32 and bf16 inputs,
    # with weights of the same type or int8 (weight-only)
    for dt in (torch.float32, torch.bfloat16):
        for wt in (dt, torch.int8):
            def weights(*s):
                return i8(*s) if wt == torch.int8 else f32(*s, lo=-1.0,
                                                           hi=1.0).to(dt)
            ws = f32(24, lo=1e-3, hi=2e-3) if wt == torch.int8 else None
            for name, a in [
                    ("matmul_epilogue",
                     dict(x=f32(77, 130, lo=-1.0).to(dt),
                          w=gemm_layout(weights(130, 24)),
                          bias=f32(24), w_scale=ws, activation="relu")),
                    ("conv2d_implicit_gemm",
                     dict(x=f32(2, 9, 9, 20, lo=-1.0).to(dt),
                          w=gemm_layout(weights(3, 3, 20, 24)),
                          bias=f32(24), w_scale=ws,
                          stride=2, pad_h=1, pad_w=1, activation="relu6"))]:
                kernel, plain = fns[name]
                # bf16 x bf16 sums its products on the tensor cores
                err, ok, _ = compare(kernel(**a), plain(**a),
                                     "float" if wt == torch.bfloat16
                                     else "exact")
                check(ok, f"{name} {dt} x {wt}: {err}")
                n += 1
    # the depthwise kernels: C = 3, 8, 24, 30, 36, 40 (not multiples of
    # 16; 3 and 30 not of the 4-channel vector), odd sizes that are not
    # multiples of the tile, stride 1 and 2 (on odd inputs too), pad 0-2,
    # C = 1024, a 5x5 kernel (variant "tiled"), batch 1; every x and out
    # type, each launch on the variant its plan names
    # (the last five cases draw from their own generator, so the first
    # five keep the inputs they were checked with)
    gen_dw = torch.Generator(device="cuda").manual_seed(6)
    for i, (nb, h, w, c, k, s, p) in enumerate([
            (4, 15, 13, 24, 3, 2, 1), (2, 9, 9, 8, 3, 1, 1),
            (3, 11, 7, 40, 3, 2, 0), (2, 9, 7, 1024, 3, 2, 1),
            (2, 10, 12, 64, 3, 1, 0), (1, 37, 29, 36, 3, 1, 1),
            (1, 33, 35, 48, 3, 2, 1), (2, 7, 7, 3, 3, 1, 1),
            (1, 23, 21, 48, 5, 1, 2), (2, 12, 9, 30, 5, 2, 2)]):
        g = gen if i < 5 else gen_dw
        xq, wq = i8(nb, h, w, c, g=g), i8(k, k, c, g=g)
        want = f"k3s{s}" if k == 3 else "tiled"

        def dw_held(name, a, what):
            kernel = fns[name][0]
            before = dict(kernel.variants)
            held(name, a, what)
            took = [v for v, m in kernel.variants.items() if m != before[v]]
            check(took == [want], f"{what}: took {took}, planned {want}")

        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            a = dict(xq=xq, wq=wq, bias=f32(c, g=g),
                     w_scale=f32(c, g=g) * 1e-3, stride=s, pad_h=p,
                     pad_w=p, activation="relu6",
                     out_dtype=out_dtype, out_scale=20.0)
            dw_held("depthwise_conv2d_int8", a,
                    f"depthwise int8 {(nb, h, w, c, k, s, p)} {out_dtype}")
            n += 1
        wf = f32(k, k, c, lo=-1.0, hi=1.0, g=g)
        for x, extra in [(f32(nb, h, w, c, lo=-1.0, g=g), {}),
                         (f32(nb, h, w, c, lo=-1.0, g=g).to(torch.bfloat16),
                          {}),
                         (xq, {"x_scale": 0.013}),
                         (xq, {"x_scale": 0.013,
                               "out_dtype": torch.float32})]:
            a = dict(x=x, w=wf, bias=f32(c, g=g), stride=s, pad_h=p, pad_w=p,
                     activation="relu", **extra)
            dw_held("depthwise_conv2d", a,
                    f"depthwise {x.dtype} {(nb, h, w, c, k, s, p)} {extra}")
            n += 1
    # the fused chain: odd H and W, nb = 1..3, Cm <= 128 and > 128, C not a
    # multiple of 16, every output type (f32 shows both shortcut forms),
    # and a saturated conv2 sum (Cm = 257) whose f32 output pins the
    # per-tap f32 sum; each equal to plain, with no tolerance, and each
    # launch on the variant its plan names
    n += ragged_int8_chain(gen)
    say("kernels", f"{n} stride-2 / ragged / clamp / float / chain cases "
        f"equal to plain (int8 0 LSB, bf16 1 ulp, f32 1e-5 of the largest "
        f"value; the chain cases exactly)")
    n = ragged_gemm(gen)
    say("kernels", f"{n} GEMM cases at the edges of the wgmma, wgmma_ragged "
        f"and wgmma_w8 designs, each on its planned variant and within its "
        f"gate (int8 x "
        f"equal to plain, float x the float gate; 2 of them dot1x1's int8 "
        f"product, torch._int_mm)")
    n = ragged_float_chain(gen) + ragged_ident(gen)
    say("kernels", f"{n} float-chain and ident cases within their gates")
    ragged_eltwise(gen)
    ragged_stem(gen)


def ragged_int8_chain(gen):
    """The int8 chain off the main path, each call equal to the plain
    version (0 LSB int8, bit-equal bf16 and f32) and each launch on the
    variant its plan names: the first ten cases (C or Cm not a multiple of
    16 take "mma_sync"), then from their own generator the "wgmma"
    variant's edges: an odd tile count in pairs (1,127 tiles: the last
    work item's second consumer runs past the last tile), one tile whose
    columns the two consumers split (Cm = 160 > 128: conv2 per tap, each
    tap's K padded to whole ring stages), tile counts that are not a
    multiple of the grid, Cm = 48 (an odd number of conv1 passes), every
    output type; the saturated conv2 sum at Cm = 257 (C = 24: "mma_sync")
    and at Cm = 272 with C = 32 ("wgmma"), whose f32 outputs pin the
    per-tap f32 sum; a misaligned x ("mma_sync", its reason given); and the
    refusal of a weight not in kernel_layout."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import (chain_plan,
                                                          kernel_layout)
    kernel, plain = _kernel_fns()["fused_chain"]
    srng = np.random.default_rng(3)

    def i8(*s, g=gen):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=g)

    def f32(*s, lo=0.5, hi=1.5, g=gen):
        return torch.rand(*s, device="cuda", generator=g) * (hi - lo) + lo

    def chain(n_, h, w, c, cm, nb, out, g=gen):
        def ws(k, cols):
            return f32(nb, cols, lo=0.5e-3 / k ** 0.5, hi=1.5e-3 / k ** 0.5,
                       g=g)
        sc = [tuple(float(v) for v in srng.uniform(lo, hi, nb))
              for lo, hi in ((0.02, 0.05), (5e-4, 2e-3), (5e-4, 2e-3))]
        return dict(x=i8(n_, h, w, c, g=g), w1=i8(nb, c, cm, g=g),
                    b1=f32(nb, cm, lo=-1.0, hi=1.0, g=g),
                    w2=i8(nb, 9 * cm, cm, g=g),
                    b2=f32(nb, cm, lo=-1.0, hi=1.0, g=g),
                    w3=i8(nb, cm, c, g=g), b3=f32(nb, c, lo=-1.0, hi=1.0, g=g),
                    w_scales=(ws(c, cm), ws(9 * cm, cm), ws(cm, c)),
                    scales=(*sc, 0.05 if out == torch.int8 else None),
                    out_dtype=out)

    def saturated(c, cm, g=gen):
        v = torch.randint(100, 128, (cm,), device="cuda", generator=g)
        return dict(
            x=i8(1, 5, 6, c, g=g), w1=i8(1, c, cm, g=g),
            b1=torch.full((1, cm), 1e4, device="cuda"),
            w2=v.to(torch.int8).expand(1, 9 * cm, cm).contiguous(),
            b2=(60.0 - 127.0 * v.double() * 9 * cm).float()[None]
            .contiguous(),
            w3=i8(1, cm, c, g=g), b3=f32(1, c, lo=-1.0, hi=1.0, g=g),
            w_scales=(torch.full((1, cm), 1e-3, device="cuda"),
                      torch.ones(1, cm, device="cuda"),
                      torch.full((1, c), 1e-6, device="cuda")),
            scales=((0.03,), (1.0,), (1.0,), None), out_dtype=torch.float32)

    sat = saturated(24, 257)
    cases = [(2, 9, 11, 64, 32, 2, torch.int8),
             (2, 9, 11, 64, 32, 2, torch.float32),
             (1, 13, 9, 72, 144, 3, torch.bfloat16),
             (3, 7, 7, 48, 144, 1, torch.float32),
             (2, 8, 8, 40, 16, 3, torch.int8),
             (2, 6, 5, 24, 8, 2, torch.int8),
             (2, 15, 15, 256, 64, 2, torch.int8),
             (1, 28, 28, 512, 128, 1, torch.bfloat16),
             (1, 7, 9, 2048, 512, 1, torch.bfloat16)]
    runs = [(f"{case}", lambda case=case: chain(*case)) for case in cases]
    runs.append(("saturated conv2 sum, C=24 Cm=257", lambda: sat))
    gen_c = torch.Generator(device="cuda").manual_seed(8)
    for case in [(23, 56, 56, 64, 32, 2, torch.int8),
                 (1, 7, 7, 256, 160, 2, torch.float32),
                 (3, 17, 20, 32, 48, 3, torch.bfloat16),
                 (2, 30, 30, 128, 64, 2, torch.int8),
                 (1, 7, 9, 2048, 512, 2, torch.float32)]:
        runs.append((f"{case}", lambda case=case: chain(*case, g=gen_c)))
    runs.append(("saturated conv2 sum, C=32 Cm=272",
                 lambda: saturated(32, 272, g=gen_c)))

    def misaligned():      # one block: the next block's x is aligned
        a = chain(2, 9, 9, 32, 48, 1, torch.int8, g=gen_c)
        flat = i8(a["x"].numel() + 1, g=gen_c)
        a["x"] = flat[1:].view(a["x"].shape)
        return a
    runs.append(("misaligned x (2, 9, 9, 32, 48, 1)", misaligned))
    n = 0
    for what, make in runs:
        a = make()
        row_major = a["w1"]
        for k in ("w1", "w2", "w3"):
            a[k] = kernel_layout(a[k])
        nn_, h, w, c = a["x"].shape
        cm = a["w1"].shape[2]
        plan = chain_plan(nn_, h, w, c, cm, 1, a["x"].data_ptr() % 16 == 0)
        before = dict(kernel.variants)
        got = kernel(**a)
        took = [v for v, m in kernel.variants.items() if m != before[v]]
        check(took == [plan.variant], f"fused_chain {what}: took {took}, "
              f"planned {plan.variant}")
        err, _, _ = compare(got, plain(**a))
        check(err == 0.0, f"fused_chain {what}: max err {err}")
        say("kernels", f"fused_chain {what}: {plan.variant}"
            + (f" ({plan.reason})" if plan.reason else
               f", {plan.tiles_per_cta} tile(s) a block, grid {plan.grid}")
            + ", equal to plain")
        n += 1
        try:        # the kernel takes its own weight layout and no other
            kernel(**{**a, "w1": row_major})
            check(False, f"fused_chain {what}: a row-major w1 was taken")
        except ValueError:
            pass
    return n


def ragged_gemm(gen):
    """The GEMM kernels at the edges of their variants, each against the
    plain version and on the variant its plan names: M not a multiple of
    the 128-row tile, N = 24 and 1000, K = 16, 24, 32, 2048, every output
    type, the lo/hi clamp, a persistent grid with several tiles per block,
    stride-2 convs with C = 8, 16, 24, 64, misaligned x (a matrix's on
    "wgmma_ragged", a conv's on "mma_sync"), the ragged rows
    (``ragged_rows``), bf16 x with an even and an odd K; and the refusal of
    a weight not in gemm_layout."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import (
        gemm_layout, matmul_epilogue_split_plain)
    fns = _kernel_fns()

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s, lo=0.5, hi=1.5):
        return torch.rand(*s, device="cuda", generator=gen) * (hi - lo) + lo

    def run(name, a, want, what, split=None):
        kernel, plain = fns[name]
        before = dict(kernel.variants)
        got = kernel(**a)
        v = next(k for k, c in kernel.variants.items() if c != before[k])
        check(v == want, f"{what}: took {v}, planned {want}")
        took = gemm_plan_of(name, a).split
        check(split is None or (took > 1) == split,
              f"{what}: split {took}, expected {'>' if split else '='} 1")
        gate = "exact" if a["x"].dtype == torch.int8 else "float"
        ref = (matmul_epilogue_split_plain(split=took, **a)
               if v == "wgmma_bf16" else plain(**a))
        err, ok, _ = compare(got, ref, gate)
        check(ok, f"{what} ({v}): max err {err}")

    def misaligned(*s):
        flat = i8(math.prod(s) + 1)
        return flat[1:].view(*s)

    n = 0
    for (m, k, nn) in [(1001, 16, 24), (130, 24, 1000), (77, 32, 1000),
                       (129, 2048, 1000), (300, 64, 320), (40000, 128, 256),
                       (257, 96, 144)]:
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            for clamp in (False, True):
                lo = hi = None
                if clamp:
                    lo = torch.full((nn,), -math.inf, device="cuda")
                    hi = torch.full((nn,), math.inf, device="cuda")
                    lo[: nn // 2] = 0.0
                    hi[nn // 4: nn // 2] = 6.0
                a = dict(x=i8(m, k), w=gemm_layout(i8(k, nn)), bias=f32(nn),
                         w_scale=f32(nn) * 1e-3, activation=None if clamp
                         else "relu", out_dtype=out_dtype, x_scale=0.02,
                         out_scale=0.6, lo=lo, hi=hi)
                run("matmul_epilogue", a,
                    "wgmma_ragged" if k % 16 else "wgmma",
                    f"matmul {(m, k, nn)} {out_dtype} clamp={clamp}")
                n += 1
    a = dict(x=misaligned(515, 64), w=gemm_layout(i8(64, 200)),
             bias=f32(200), w_scale=f32(200) * 1e-3, activation="relu",
             out_dtype=torch.int8, x_scale=0.02, out_scale=0.6)
    run("matmul_epilogue", a, "wgmma_ragged", "matmul with misaligned x")
    n += 1
    for (nb, h, w, c, co, k, s, p) in [(3, 17, 15, 64, 96, 3, 2, 1),
                                       (2, 19, 13, 16, 40, 3, 2, 1),
                                       (2, 12, 10, 24, 32, 3, 1, 1),
                                       (2, 9, 11, 8, 64, 3, 2, 1),
                                       (4, 30, 30, 128, 256, 3, 1, 1)]:
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            a = dict(x=i8(nb, h, w, c), w=gemm_layout(i8(k, k, c, co)),
                     bias=f32(co), w_scale=f32(co) * 1e-3, stride=s, pad_h=p,
                     pad_w=p, activation="relu6", out_dtype=out_dtype,
                     x_scale=0.02, out_scale=0.5)
            run("conv2d_implicit_gemm", a,
                "wgmma_ragged" if c % 16 else "wgmma",
                f"conv {(nb, h, w, c, co, k, s)} {out_dtype}")
            n += 1
    a = dict(x=misaligned(2, 9, 9, 32), w=gemm_layout(i8(3, 3, 32, 48)),
             bias=f32(48), w_scale=f32(48) * 1e-3, stride=2, pad_h=1,
             pad_w=1, activation="relu", out_dtype=torch.int8, x_scale=0.02,
             out_scale=0.5)
    run("conv2d_implicit_gemm", a, "mma_sync", "conv with misaligned x")
    n += 1
    n += ragged_rows(run)
    # bf16 x bf16: split K (uneven slices, a partial last step, several
    # row tiles), several tiles a block, odd N, bf16 and f32 out
    for (m, k, nn, want, odt) in [
            (128, 2048, 1000, "wgmma_bf16", torch.bfloat16),
            (128, 2048, 1000, "wgmma_bf16", torch.float32),
            (77, 136, 24, "wgmma_bf16", torch.bfloat16),
            (200, 2600, 999, "wgmma_bf16", torch.bfloat16),
            (77, 4104, 24, "wgmma_bf16", torch.float32),
            (300, 3072, 200, "wgmma_bf16", torch.bfloat16),
            (9000, 256, 200, "wgmma_bf16", torch.bfloat16),
            (300, 130, 72, "simt", torch.bfloat16)]:
        a = dict(x=torch.randn(m, k, device="cuda", generator=gen).to(
                     torch.bfloat16),
                 w=gemm_layout((torch.randn(k, nn, device="cuda", generator=gen)
                                * k ** -0.5).to(torch.bfloat16)),
                 bias=f32(nn), activation="relu", out_dtype=odt)
        run("matmul_epilogue", a, want, f"bf16 matmul {(m, k, nn)} {odt}")
        n += 1
    n += split_cases(run, i8, f32)
    n += ragged_w8(run)
    # the "dot1x1" algo's int8 product on the card (torch._int_mm, not a
    # hand kernel): exact against the f64 product of the int8 grids; a shape
    # outside _int_mm's rules raises (its own generator: the cases after
    # this function keep their inputs)
    from types import SimpleNamespace
    from feathercnn_tpu_torch.kernels.dispatch import _int8_product
    node = SimpleNamespace(name="dot1x1 case")
    g9 = torch.Generator(device="cuda").manual_seed(9)
    for (m, k, nn) in [(1000, 64, 96), (50176, 192, 64)]:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=g9)
        w = gemm_layout(torch.randint(-127, 128, (k, nn), dtype=torch.int8,
                                      device="cuda", generator=g9))
        want = (x.double() @ w.double()).float()
        check(torch.equal(_int8_product(node, x, w), want),
              f"dot1x1 int8 product {(m, k, nn)} differs from the f64 one")
        n += 1
    try:
        _int8_product(node, x[:100, :20].contiguous(),
                      gemm_layout(w[:20, :16].contiguous()))
        check(False, "dot1x1: an int8 product with K=20 was taken")
    except ValueError:
        pass
    for name, a in [("matmul_epilogue", dict(x=i8(64, 64), w=i8(64, 32))),
                    ("conv2d_implicit_gemm",
                     dict(x=i8(1, 8, 8, 16), w=i8(3, 3, 16, 32), pad_h=1,
                          pad_w=1))]:
        try:        # the kernels take gemm_layout and no other layout
            fns[name][0](**a)
            check(False, f"{name}: a weight not in gemm_layout was taken")
        except ValueError:
            pass
    return n


def split_cases(run, i8, f32):
    """int8 launches whose plan splits K, off the paths' shapes, each equal
    to plain on its variant: a matrix at M = 128 and past it (uneven
    slices), a conv at stride 1 and 2, a dilated one, ragged M and N,
    every output type and the lo/hi clamp; and three the rule leaves
    unsplit (a K loop too short to pay for the second pass, a ragged conv
    at C = 40 on "wgmma_ragged", a batch's worth of tiles)."""
    import math
    import torch
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout
    n = 0
    for (m, k, nn, clamp, split) in [(128, 4096, 1000, False, True),
                                     (200, 4096, 264, True, True),
                                     (77, 4096, 96, False, True),
                                     (128, 2048, 1000, False, False)]:
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            lo = hi = None
            if clamp:
                lo = torch.full((nn,), -math.inf, device="cuda")
                hi = torch.full((nn,), math.inf, device="cuda")
                lo[: nn // 2] = 0.0
                hi[nn // 4: nn // 2] = 6.0
            a = dict(x=i8(m, k), w=gemm_layout(i8(k, nn)), bias=f32(nn),
                     w_scale=f32(nn) * 1e-3, activation=None if clamp
                     else "relu", out_dtype=out_dtype, x_scale=0.02,
                     out_scale=5.0, lo=lo, hi=hi)
            run("matmul_epilogue", a, "wgmma", f"split matmul {(m, k, nn)} "
                f"{out_dtype}", split=split)
            n += 1
    for (nb, h, w, c, co, k, s, p, d, split) in [
            (1, 38, 50, 512, 512, 3, 1, 2, 2, True),
            (1, 19, 25, 256, 200, 3, 1, 1, 1, True),
            (2, 10, 10, 256, 128, 3, 2, 1, 1, True),
            (1, 20, 20, 40, 200, 7, 1, 3, 1, False),
            (16, 28, 28, 256, 256, 3, 1, 1, 1, False)]:
        for out_dtype in (torch.int8, torch.bfloat16):
            a = dict(x=i8(nb, h, w, c), w=gemm_layout(i8(k, k, c, co)),
                     bias=f32(co), w_scale=f32(co) * 1e-3, stride=s, pad_h=p,
                     pad_w=p, activation="relu", out_dtype=out_dtype,
                     x_scale=0.02, out_scale=5.0, dilation=d)
            run("conv2d_implicit_gemm", a,
                "wgmma_ragged" if c % 16 else "wgmma",
                f"split conv {(nb, h, w, c, co, k, s, d)} {out_dtype}",
                split=split)
            n += 1
    return n


def ragged_rows(run):
    """"wgmma_ragged" at the launches it was made for, each on its planned
    variant and equal to plain (``run``; int8 0 LSB, bf16 1 ulp), on a
    generator of its own (the cases after keep their inputs): matrices at
    K = 24, 58, 116 and 232 (the ShuffleNets' and MobileNet-v2's 1x1
    convs) with M and N not multiples of the tile, and 5x5 and 3x3 convs on
    C = 24 (GoogLeNet's 5x5 convs) at stride 1 and 2, each with x at 0, 2,
    4 and 8 bytes from an aligned base (a matrix takes any offset; a conv
    gathers 8-byte pieces, so at 2 and 4 it keeps "mma_sync"), bf16 out at
    offset 0; then a ragged K past RAGGED_K_MAX on "mma_sync".  The
    reasons of the launches not on "wgmma_ragged" are printed."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import RAGGED_K_MAX, gemm_layout
    gen = torch.Generator(device="cuda").manual_seed(11)

    def at(off, *shape):        # x at ``off`` bytes past an aligned base
        size = math.prod(shape)
        flat = torch.randint(-127, 128, (size + 16,), dtype=torch.int8,
                             device="cuda", generator=gen)
        return flat[off:off + size].view(*shape)

    def vec(nn):
        return torch.rand(nn, device="cuda", generator=gen) + 0.5

    def epilogue(nn, out_dtype, act):
        return dict(bias=vec(nn), w_scale=vec(nn) * 1e-3, activation=act,
                    out_dtype=out_dtype, x_scale=0.02, out_scale=20.0)

    n, planned = 0, {}
    for (m, k, nn) in [(3001, 24, 144), (1000, 58, 58), (777, 116, 116),
                       (300, 232, 232), (129, 24, 24)]:
        for off in (0, 2, 4, 8):
            for out_dtype in ((torch.int8, torch.bfloat16) if off == 0
                              else (torch.int8,)):
                a = dict(x=at(off, m, k), w=gemm_layout(at(0, k, nn)),
                         **epilogue(nn, out_dtype, "relu"))
                run("matmul_epilogue", a, "wgmma_ragged",
                    f"ragged matmul {(m, k, nn)} x+{off} {out_dtype}")
                n += 1
    for (nb, h, w, co, kk, s) in [(2, 14, 14, 64, 5, 1), (3, 13, 11, 40, 5, 2),
                                  (2, 12, 10, 32, 3, 1), (2, 11, 9, 72, 3, 2)]:
        for off in (0, 2, 4, 8):
            want = "wgmma_ragged" if off % 8 == 0 else "mma_sync"
            for out_dtype in ((torch.int8, torch.bfloat16) if off == 0
                              else (torch.int8,)):
                a = dict(x=at(off, nb, h, w, 24),
                         w=gemm_layout(at(0, kk, kk, 24, co)), stride=s,
                         pad_h=kk // 2, pad_w=kk // 2,
                         **epilogue(co, out_dtype, "relu6"))
                what = f"ragged conv {(nb, h, w, 24, co, kk, s)} x+{off}"
                run("conv2d_implicit_gemm", a, want, f"{what} {out_dtype}")
                if want != "wgmma_ragged":
                    planned[what] = gemm_plan_of("conv2d_implicit_gemm",
                                                 a).reason
                n += 1
    k = RAGGED_K_MAX + 44
    a = dict(x=at(0, 500, k), w=gemm_layout(at(0, k, 64)),
             **epilogue(64, torch.int8, "relu"))
    run("matmul_epilogue", a, "mma_sync", f"ragged matmul K = {k}")
    planned[f"ragged matmul K = {k}"] = gemm_plan_of("matmul_epilogue",
                                                     a).reason
    n += 1
    for what, why in planned.items():
        say("ragged", f"{what}: mma_sync, as planned ({why})")
    return n


def ragged_w8(run):
    """"wgmma_w8" (bf16 x int8 weight) at the edges of its design, each on
    its planned variant and within its gate (``run``), on a generator of
    its own (the cases after keep their inputs).  matmul_epilogue: every M
    of 1, 77, 128, 300 by K of 64, 136 (8-byte weight pieces), 25088 by N
    of 24, 1000, 4096 (split-K where the tiles leave SMs idle), bf16 out
    on normal x (the float gate) and int8 out on integer-valued x (its f32
    sums exact in any order: equal to the plain version), the lo/hi clamp
    on every other pair.  conv2d_implicit_gemm: stride 1 and 2, C of 8, 64,
    72, 128, odd H/W, batch 1: A gathered, A by TMA, 256-wide tiles with N
    not a multiple of 256, bf16, int8 and f32 out (f32: within 1e-4 of the
    largest value).  Then a K and a C not a multiple of 8 and a
    misaligned x, each refused to "simt" with its reason printed."""
    import itertools
    import torch
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout
    gen = torch.Generator(device="cuda").manual_seed(10)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def f32(*s):
        return torch.rand(*s, device="cuda", generator=gen) + 0.5

    def x_of(shape, int8_out):
        if int8_out:   # small integers: exact products and sums
            return torch.randint(-8, 9, shape, device="cuda",
                                 generator=gen).to(torch.bfloat16)
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    def epilogue(nn, k, int8_out, clamp):
        lo = hi = None
        if clamp:
            lo = torch.full((nn,), -math.inf, device="cuda")
            hi = torch.full((nn,), math.inf, device="cuda")
            lo[: nn // 2] = 0.0
            hi[nn // 4: nn // 2] = 6.0
        spread = (0.3 / (360 * math.sqrt(k)) if int8_out
                  else 1e-2 / math.sqrt(k))
        return dict(bias=f32(nn), w_scale=f32(nn) * spread,
                    activation=None if clamp else "relu",
                    out_dtype=torch.int8 if int8_out else torch.bfloat16,
                    x_scale=0.5 if int8_out else 1.0, out_scale=100.0,
                    lo=lo, hi=hi)

    n = 0
    for i, (m, k, nn) in enumerate(itertools.product(
            (1, 77, 128, 300), (64, 136, 25088), (24, 1000, 4096))):
        int8_out, clamp = i % 2 == 1, (i // 2) % 2 == 1
        a = dict(x=x_of((m, k), int8_out), w=gemm_layout(i8(k, nn)),
                 **epilogue(nn, k, int8_out, clamp))
        run("matmul_epilogue", a, "wgmma_w8",
            f"w8 matmul {(m, k, nn)} {a['out_dtype']} clamp={clamp}")
        n += 1
    # gathered A (stride 2, C of 8 or 72), A by TMA over rectangles of
    # output pixels (stride 1, C of 64 or 128), 256-wide tiles (N > 128)
    for (nb, h, w, c, co, s, out) in [
            (1, 17, 15, 8, 64, 2, "bf16"), (1, 13, 11, 64, 96, 1, "int8"),
            (2, 9, 13, 72, 40, 2, "bf16"), (1, 15, 17, 72, 24, 1, "int8"),
            (3, 11, 9, 64, 128, 2, "bf16"), (2, 7, 9, 8, 200, 1, "int8"),
            (1, 9, 7, 128, 320, 1, "bf16"), (2, 11, 13, 64, 200, 1, "int8"),
            (1, 5, 19, 64, 72, 1, "f32"), (1, 6, 6, 128, 512, 1, "f32")]:
        int8_out = out == "int8"
        ep = epilogue(co, 9 * c, int8_out, False)
        ep["activation"] = "relu6"
        if out == "f32":
            ep["out_dtype"] = torch.float32
        a = dict(x=x_of((nb, h, w, c), int8_out),
                 w=gemm_layout(i8(3, 3, c, co)), stride=s, pad_h=1, pad_w=1,
                 **ep)
        run("conv2d_implicit_gemm", a, "wgmma_w8",
            f"w8 conv {(nb, h, w, c, co, s)} {a['out_dtype']}")
        n += 1
    flat = x_of((77 * 64 + 1,), False)
    for name, what, a in [
            ("matmul_epilogue", "K = 20",
             dict(x=x_of((50, 20), False), w=gemm_layout(i8(20, 64)),
                  **epilogue(64, 20, False, False))),
            ("conv2d_implicit_gemm", "C = 12",
             dict(x=x_of((1, 9, 9, 12), False),
                  w=gemm_layout(i8(3, 3, 12, 32)), stride=1, pad_h=1,
                  pad_w=1, **epilogue(32, 108, False, False))),
            ("matmul_epilogue", "misaligned x",
             dict(x=flat[1:].view(77, 64), w=gemm_layout(i8(64, 96)),
                  **epilogue(96, 64, False, False)))]:
        run(name, a, "simt", f"w8 {name} with {what}")
        say("ragged", f"w8 {name} with {what}: simt, as planned "
            f"({gemm_plan_of(name, a).reason})")
        n += 1
    return n


def ragged_float_chain(gen):
    """The float chain off the main path: bf16 and f32 x, C and Cm not
    multiples of a 16-byte vector (C odd once), odd H and W, Cm > 128,
    nb 1-3, an f32 output on the last block, stage 2 and 5 shapes (stage
    5 on three seeds), an f32 block at stage 4; and the refusal of an f32
    block whose tile does not fit shared memory."""
    import torch
    from feathercnn_tpu_torch.kernels.fused_chain import kernel_layout

    kernel = _kernel_fns()["fused_chain_float"][0]

    def args(n_, h, w, c, cm, nb, xdt, out, g=gen):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * scale
        return dict(
            x=rnd(n_, h, w, c).to(xdt),
            w1=kernel_layout(rnd(nb, c, cm, scale=c ** -0.5).to(xdt)),
            b1=rnd(nb, cm, scale=0.1),
            w2=kernel_layout(rnd(nb, 9 * cm, cm, scale=(9 * cm) ** -0.5)
                             .to(xdt)),
            b2=rnd(nb, cm, scale=0.1),
            w3=kernel_layout(rnd(nb, cm, c, scale=cm ** -0.5).to(xdt)),
            b3=rnd(nb, c, scale=0.1), out_dtype=out)

    bf, f4 = torch.bfloat16, torch.float32
    n = 0
    # the first eleven cases, then (from their own generator, so those
    # keep their inputs) the "wgmma" variant's edges: tile counts that are
    # not a multiple of the two tiles a block takes (3, 5 and 15 tiles),
    # more pairs of tiles than the persistent grid's blocks (147 over 132),
    # H and W not multiples of the tile, Cm = 8 and 24 (a K step across
    # taps), C and Cm not multiples of 64 or 128, and both output types.
    # Each launch takes the variant its plan names: "wgmma" for bf16 with C
    # and Cm multiples of 8, "mma_sync" for other bf16, "fma_f32" for f32.
    gen_fc = torch.Generator(device="cuda").manual_seed(7)
    cases = [(2, 9, 11, 64, 32, 2, bf, bf),
             (2, 9, 11, 64, 32, 2, bf, f4),
             (1, 13, 9, 72, 144, 3, bf, bf),
             (2, 6, 5, 20, 12, 2, bf, bf),
             (1, 5, 7, 21, 10, 2, bf, f4),
             (3, 7, 7, 48, 144, 1, f4, f4),
             (2, 9, 11, 64, 32, 2, f4, f4),
             (2, 6, 5, 18, 6, 3, f4, bf),
             (2, 56, 56, 256, 64, 2, bf, bf),
             (2, 7, 7, 2048, 512, 1, bf, bf),
             (2, 14, 14, 1024, 256, 2, f4, f4),
             (1, 21, 7, 40, 24, 2, bf, bf),
             (1, 7, 33, 16, 8, 1, bf, f4),
             (1, 17, 20, 136, 56, 2, bf, bf),
             (6, 56, 56, 64, 32, 1, bf, bf)]
    # and the stage-5 block at three tiles (one per thread block, H and W
    # under the 8x8 tile), from generators seeded 5, 6 and 7: the inputs
    # that tools/float_chain_probe.py draws for it, where the gate is
    # tightest (K = 4608)
    runs = [(case, gen if i < 11 else gen_fc, None)
            for i, case in enumerate(cases)]
    runs += [((3, 7, 7, 2048, 512, 2, bf, bf),
              torch.Generator(device="cuda").manual_seed(seed), seed)
             for seed in (5, 6, 7)]
    for case, g, seed in runs:
        a = args(*case, g=g)
        c, cm, xdt = case[3], case[4], case[6]
        want = ("fma_f32" if xdt == f4 else
                "mma_sync" if c % 8 or cm % 8 else "wgmma")
        before = dict(kernel.variants)
        out = kernel(**a)
        took = [v for v, m in kernel.variants.items() if m != before[v]]
        check(took == [want], f"fused_chain_float {case}: took {took}, "
              f"planned {want}")
        err, ok, over, elements = per_launch(a, out)
        check(ok, f"fused_chain_float {case}: max err {err}, {over} "
              f"elements over 1 ulp")
        if seed is not None:
            say("kernels", f"fused_chain_float {case[:6]} seed {seed}: "
                f"{over} of {elements} elements of its two launches over 1 "
                f"ulp ({100.0 * over / elements:.4f}%; gate 0.1% per "
                f"launch)")
        n += 1
    try:
        kernel(**args(1, 7, 7, 2048, 512, 1, f4, f4))
        check(False, "fused_chain_float: an f32 block with Cm=512 was taken")
    except ValueError:
        pass
    return n


def ragged_ident(gen):
    """``ident`` on int8, bf16 and f32 at odd sizes, chunk 1 and 2, an
    unaligned view (the byte path), bit-equal to ``x.clone()``; and the
    refusal of a batch that is not a multiple of the chunk."""
    import torch
    kernel, plain = _kernel_fns()["ident"]
    n = 0
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        base = torch.randn(5, 7, 9, 13, device="cuda", generator=gen) * 50
        base = base.to(dt)
        for x, chunk in ((base, 1), (base[1:], 2), (base[:2, :1, :1, :1]
                                                    .contiguous(), 2),
                         (base[:3], 3)):
            _, ok, _ = compare(kernel(x, chunk), plain(x, chunk), "bits")
            check(ok, f"ident {dt} {tuple(x.shape)} chunk {chunk}: differs")
            n += 1
    try:
        kernel(base, 2)
        check(False, "ident: a batch of 5 was taken with chunk 2")
    except ValueError:
        pass
    return n


# (s0, s1, y_scale) of the eltwise_int8 cases (each launched with the f32
# reciprocal of y_scale, ``numerics.reciprocal``): calibration-like scales;
# quotients on .5 (half to even: (x0 + x1) / 2, and 0.5 x0 + 1.5 x1);
# sums far past the grid (every value clamped to +-127 but the small); a
# range around relu6's 6
ELTWISE_SCALES = ((0.0123, 0.0456, 0.0789), (0.5, 0.5, 1.0),
                  (0.25, 0.75, 0.5), (1.0, 1.0, 0.25), (0.05, 0.05, 0.05))
# ResNet-50's stage 2-4 residual adds at the benchmark's b512
ELTWISE_B512 = ((512, 56, 56, 256), (512, 28, 28, 512), (512, 14, 14, 1024))


def ragged_eltwise(gen):
    """``eltwise_int8`` off the main path, each call equal to its plain
    version (0 LSB): sizes of 1 to 17 elements and odd NHWC shapes (a
    masked tail after the last 16-byte vector), each activation at each of
    ``ELTWISE_SCALES`` (quotients on .5, saturated sums), the whole int8
    range (-128 too), channel slices at their own pitches beside a
    contiguous operand and beside each other (the merged siblings' form);
    the operands the kernel reads from a contiguous copy (an unaligned view,
    a row shard that is no run of whole rows, a slice of channels not a
    multiple of 16), each launched; then
    ResNet-50's stage 2-4 shapes at b512 (``ELTWISE_B512``), contiguous and
    with x0 a channel slice, timed beside their byte bound and the PyTorch
    composition it replaced (``eltwise_composition``, equal to it)."""
    import torch
    from feathercnn_tpu_torch.numerics import reciprocal
    kernel, plain = _kernel_fns()["eltwise_int8"]
    inv = reciprocal(0.0789)

    def i8(*s):
        return torch.randint(-128, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    def held(a, what):
        _, ok, _ = compare(kernel(**a), plain(**a))
        check(ok, f"eltwise_int8 {what}: differs from plain")

    n = 0
    pairs = [(i8(k), i8(k)) for k in (1, 7, 15, 16, 17)]
    pairs += [(i8(*sh), i8(*sh)) for sh in ((3, 7, 7, 5), (2, 13, 13, 100),
                                           (5, 3, 3, 1003))]
    wide, wider = i8(4, 9, 9, 96), i8(4, 9, 9, 160)
    pairs += [(wide[..., 16:80], i8(4, 9, 9, 64)),
              (i8(4, 9, 9, 64), wide[..., 32:]),
              (wide[..., :64], wider[..., 48:112]),
              (wide[:1, 2:5, :, 16:48], i8(1, 3, 9, 32))]
    for x0, x1 in pairs:
        for s0, s1, y in ELTWISE_SCALES:
            for act in (None, "relu", "relu6"):
                held(dict(x0=x0, x1=x1, s0=s0, s1=s1, inv=reciprocal(y),
                          act=act),
                     f"x{tuple(x0.shape)} strides {x0.stride()} / "
                     f"{x1.stride()} scales {(s0, s1, y)} act {act}")
                n += 1
    copied = 0
    base = i8(4, 9, 9, 64)
    for x0, x1, why in ((i8(1000)[1:17], i8(16), "unaligned"),
                        (base[:, 2:5], i8(4, 3, 9, 64), "a row shard"),
                        (wide[..., 16:40], i8(4, 9, 9, 24), "24 channels"),
                        (wide[..., 16:80], i8(4 * 9 * 9 * 64 + 1)[1:].view(
                            4, 9, 9, 64), "a slice beside an unaligned view")):
        for act in (None, "relu", "relu6"):
            before = kernel.launches
            held(dict(x0=x0, x1=x1, s0=0.0123, s1=0.0456, inv=inv,
                      act=act), f"{why} act {act}")
            check(kernel.launches == before + 1,
                  f"eltwise_int8 did not launch on {why}")
            copied += 1
    say("kernels", f"eltwise_int8: {n} cases (odd sizes, every act, "
        f".5 quotients, saturation, pitched channel slices) equal to plain; "
        f"{copied} cases on an operand it copies first (unaligned, a row "
        f"shard, channels not a multiple of 16), each launched and equal")
    for shape in ELTWISE_B512:
        wide = i8(*shape[:3], shape[3] + 64)
        for x0, form in ((i8(*shape), "contiguous"),
                         (wide[..., 64:], "x0 a channel slice")):
            a = dict(x0=x0, x1=i8(*shape), s0=0.0123, s1=0.0456,
                     inv=inv, act="relu")
            out = kernel(**a)
            check(torch.equal(out, plain(**a)),
                  f"eltwise_int8 x{shape} {form}: differs from plain")
            comp = eltwise_composition(a)
            check(torch.equal(comp(), out), f"eltwise_int8 x{shape}: the "
                  f"PyTorch composition gives another answer")
            ms = median_ms(lambda: kernel(**a))
            b_ms, _ = bound_ms("eltwise_int8", a, out)
            lib = median_ms(comp)
            say("kernels", f"eltwise_int8 x{shape} {form} relu: {ms:.4f} ms,"
                f" byte bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}% of it, "
                f"{3 * out.numel() / ms / 1e9:.3f} TB/s), the PyTorch "
                f"composition {lib:.4f} ms ({lib / ms:.1f}x)")
            del a, out, comp
        del wide, x0
    torch.cuda.empty_cache()


# The stem kernel's forms (kernel, stride, pad, Co, image side): the zoo's
# stems (ResNet-50, MobileNet, VGG's stride 1 on its odd-parity windows,
# AlexNet's 11x11, SqueezeNet v1.0/1.1, ShuffleNet's 24, Inception-v3's
# 299 rows, FCN's pad 100) and an odd one; then the benchmark's two stems
# at their batches, timed
STEM_FORMS = ((7, 2, 3, 64, 224), (3, 2, 1, 32, 224), (3, 1, 1, 64, 224),
              (11, 4, 0, 96, 227), (3, 2, 0, 64, 227), (7, 2, 0, 96, 224),
              (3, 2, 1, 24, 224), (3, 2, 0, 32, 299), (3, 1, 100, 64, 224),
              (5, 3, 2, 32, 41))
STEM_CELLS = ((512, 7, 2, 3, 64, "resnet50_w8a8.offline"),
              (2048, 3, 2, 1, 32, "mobilenet_v1_w8a8.offline"))


def ragged_stem(gen):
    """``stem_conv_int8`` off the main paths, each call launched and within
    1 LSB of its plain version on the card (cuDNN's order), and the relu
    call of each form equal to it on the CPU where the padding is at most
    (k - 1) / 2 (0 LSB: PyTorch's CPU conv sums those in r, s, c order, as
    the kernel does) and within 1 LSB where it is larger (FCN's pad 100
    takes another CPU path): every form of
    ``STEM_FORMS`` at batch 2 with each activation, with and without a
    bias, at a calibration-like scale and at quotients on .5 (quarter
    weights on small integers, at out_scale 2); then the benchmark's two
    stems at their batches (``STEM_CELLS``) timed beside their bound, the
    plain version and what the kernel replaced (``stem_composition``)."""
    import torch
    kernel, plain = _kernel_fns()["stem_conv_int8"]
    n = off = total = cpu_off = 0
    for k, s, p, co, side in STEM_FORMS:
        for exact in (False, True):
            if exact:
                x = torch.randint(-8, 9, (2, side, side, 3), device="cuda",
                                  generator=gen).to(torch.bfloat16)
                w = (torch.randint(-7, 8, (k, k, 3, co), device="cuda",
                                   generator=gen) * 0.25).to(torch.bfloat16)
                scale = 2.0
            else:
                x = torch.randn(2, side, side, 3, device="cuda",
                                generator=gen).to(torch.bfloat16)
                w = (torch.randn(k, k, 3, co, device="cuda", generator=gen)
                     / k).to(torch.bfloat16)
                scale = 127 / 4.0
            for act, bias in ((None, None), ("relu", True), ("relu6", True)):
                b = (torch.randint(-8, 9, (co,), device="cuda",
                                   generator=gen) * 0.25).float() \
                    if bias else None
                a = dict(x=x, w=w, bias=b, stride=(s, s), padding=(p, p),
                         activation=act, out_scale=scale, wk=None)
                before = kernel.launches
                out = kernel(**a)
                err, ok, over = compare(out, plain(**a), "lsb1")
                # the sums are the activations' own: one CPU run a form
                cpu = out.cpu() if act != "relu" else plain(
                    **{k_: v.cpu() if torch.is_tensor(v) else v
                       for k_, v in a.items()})
                off_cpu = (out.cpu().int() - cpu.int()).abs()
                check(ok and kernel.launches == before + 1
                      and int(off_cpu.max()) <= (0 if 2 * p <= k - 1
                                                 else 1),
                      f"stem_conv_int8 {k}x{k} s{s} p{p} Co={co} on "
                      f"{side}x{side} {act} exact={exact}: {err} LSB off "
                      f"plain on the card, {int((off_cpu > 0).sum())} "
                      f"values off it on the CPU, launched "
                      f"{kernel.launches - before}")
                cpu_off += int((off_cpu > 0).sum())
                off += over
                total += 2 * co * ((side + 2 * p - k) // s + 1) ** 2
                n += 1
    say("kernels", f"stem_conv_int8: {n} cases (the zoo's stem forms and "
        f"an odd one, every act, with and without bias, .5 quotients), each "
        f"launched; against the plain version on the CPU equal where the "
        f"pad is at most (k - 1) / 2, {cpu_off} values 1 LSB off at FCN's "
        f"pad 100; on the card (cuDNN) {off} of {total} values 1 LSB off")
    for nb, k, s, p, co, cell in STEM_CELLS:
        x = torch.randn(nb, 224, 224, 3, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = (torch.randn(k, k, 3, co, device="cuda", generator=gen) / k).to(
            torch.bfloat16)
        from feathercnn_tpu_torch.kernels.stem import stem_layout
        a = dict(x=x, w=w, bias=torch.randn(co, device="cuda",
                                            generator=gen) * 0.1,
                 stride=(s, s), padding=(p, p), activation="relu",
                 out_scale=127 / 4.0, wk=stem_layout(w))
        out = kernel(**a)
        err, ok, over = compare(out, plain(**a), "lsb1")
        check(ok, f"stem_conv_int8 b{nb} {k}x{k}: {err} LSB off plain")
        comp = stem_composition(a)
        err2, ok2, _ = compare(out, comp(), "lsb1")
        check(ok2, f"stem_conv_int8 b{nb} {k}x{k}: {err2} LSB off what it "
              f"replaced")
        ms = median_ms(lambda: kernel(**a))
        b_ms, by = bound_ms("stem_conv_int8", a, out)
        lib = median_ms(comp, reps=5)
        plain_ms = median_ms(lambda: plain(**a), reps=5)
        say("kernels", f"stem_conv_int8 b{nb} {k}x{k} s{s} Co={co} ({cell}'s"
            f" stem): {ms:.4f} ms, bound {b_ms:.4f} ms ({by}, "
            f"{100 * b_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
            f"cuDNN's f32 conv + PyTorch's epilogue {lib:.4f} ms "
            f"({lib / ms:.1f}x the kernel); {over} of {out.numel()} values "
            f"1 LSB off plain")
        del a, out, comp, x
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 6
# ----------------------------------------------------------------------
def serve(eng, x, batch=BATCH, label="ResNet-50"):
    from feathercnn_tpu_torch.serve import InferenceServer
    from feathercnn_tpu_torch.serve.server import InferenceFailed

    srv = InferenceServer(eng, batch_size=batch, batch_slots=[8, batch],
                          batch_timeout_us=2000)
    check(srv._transfer_scale is not None, "int8 transfer not engaged")
    imgs = x[:32]
    q = srv._to_transfer(imgs)

    def run(b):
        return eng(b).float().cpu().numpy().reshape(len(b), -1)

    def direct_at(n):
        if n >= len(q):
            pad = np.zeros((n - len(q),) + q.shape[1:], q.dtype)
            return run(np.concatenate([q, pad]))[:len(q)]
        return np.concatenate([run(q[i:i + n])
                               for i in range(0, len(q), n)])

    direct = {n: direct_at(n) for n in (8, 32, batch)}
    diff = {n: float(np.abs(direct[n] - direct[batch]).max())
            for n in (8, 32)}
    say("server", f"{label}: direct output of the 32 images at batch 8 / 32 "
        f"vs {batch}: max |diff| {diff[8]} / {diff[32]}")
    results = [None] * len(imgs)
    errors = []
    srv.start()
    try:
        def client(t):
            for i in range(t, len(imgs), 8):
                try:
                    results[i] = srv.infer(imgs[i], timeout_s=120)
                except InferenceFailed as e:
                    errors.append((i, e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not errors, f"InferenceFailed: {errors}")
        check(all(r is not None for r in results), "a request timed out")
        for i, r in enumerate(results):
            err = float(np.abs(r.ravel() - direct[batch][i]).max())
            check(err == 0.0, f"request {i}: server answer differs from "
                  f"the direct run by {err}")
        m = srv.gauges()
        check(m["faults"] == 0, f"faults {m['faults']}")
        check(srv.healthy(), "server unhealthy")
        say("server", f"{label}: 32 requests from 8 threads in {wall:.2f} s: "
            f"{m['batches']} batches, {m['pad_images']} pad images, "
            f"0 faults, every answer equal to the direct run")
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# phase 7
# ----------------------------------------------------------------------
def boundary(label, smi):
    """The boundary probe at ResNet-50's stages 2-5, b128, chunk 2: one
    untimed run of both variants per stage with the counts set to 0 before
    and read after, every launch held against its plain version; then the
    timed runs.  Returns the kernel rows."""
    import torch
    from feathercnn_tpu_torch.kernels.ident import STAGES, boundary_probe
    recorder = LaunchRecorder()
    reset_counts()
    sums = recorder.run(lambda: [boundary_probe(st, BATCH, 2, reps=0)
                                 for st in STAGES])
    torch.cuda.synchronize()
    counts = read_counts()
    say(label, f"one untimed run of both variants at stages 2-5: launches "
        f"{counts}")
    check(counts == EXPECTED[label],
          f"{label}: launches {counts}, expected {EXPECTED[label]}")
    for r in sums:
        check(r["sum_none"] == r["sum_ident"],
              f"{label} stage {r['stage']}: sums {r['sum_none']} without "
              f"ident, {r['sum_ident']} with")
    check_variants(label, recorder.launches)
    rows = kernels_vs_plain(label, recorder.launches)
    del recorder
    idents = [r for r in rows if r["kernel"] == "ident"]
    for st, row in zip(STAGES, idents):
        p = boundary_probe(st, BATCH, 2)
        say("boundary", f"stage {st} x{p['x_shape']} int8, chunk 2: "
            f"{p['ms_none']:.4f} ms without ident, {p['ms_ident']:.4f} ms "
            f"with, boundary {p['ms_ident'] - p['ms_none']:+.4f} ms; ident "
            f"alone {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), x.clone() {row['library_ms']:.4f} ms; "
            f"sums equal ({p['sum_none']}) ({smi})")
    return rows


# ----------------------------------------------------------------------
# the kernels line
# ----------------------------------------------------------------------
def _sums(rows):
    """ms, plain_ms, bound_ms and library_ms summed over one forward's
    launches (None where a launch has no value)."""
    out = {}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [r[key] for r in rows]
        out[key] = None if any(v is None for v in vals) else sum(vals)
    return out


def kernel_summary(name, rows, counts):
    """One kernel's entry of the ``{"kernels": ...}`` line.  Its numbers
    come from the first path of ``EXPECTED`` that launches it (``path``):
    ``launches`` is that forward's count, and ms, plain_ms, bound_ms and
    library_ms sum every wrapper call of that forward.  ``paths`` gives the
    same per path that launches the kernel, and ``shapes``, per distinct
    call shape of ``path``, the wrapper calls, their CUDA launches (a
    ``fused_chain`` call launches once per block) and the median per call
    (the ``[kernels]`` lines print them for every path).
    ``launches_per_forward`` and ``max_err_vs_plain`` repeat ``launches``
    and ``max_abs_err`` under the names the port's issue tracker asks
    for."""
    paths = [p for p in EXPECTED if p in counts and counts[p][name]]
    main = paths[0]
    mine = rows_of(name, rows)
    main_rows = [r for r in mine if r["path"] == main]
    sums = _sums(main_rows)
    by_bytes = sum(r["bound_ms"] for r in main_rows
                   if r["bound_by"] == "bytes")
    max_err = max(r["max_abs_err"] for r in mine)
    shapes = []
    for desc in dict.fromkeys(r["shape"] for r in main_rows):
        same = [r for r in main_rows if r["shape"] == desc]
        shapes.append({
            "shape": desc, "calls": len(same),
            "variant": same[0]["variant"],
            "library_padded": same[0]["library_padded"],
            "launches": sum(r["launches"] for r in same),
            "bound_by": same[0]["bound_by"],
            "max_abs_err": max(r["max_abs_err"] for r in same),
            **{k: (None if any(r[k] is None for r in same)
                   else statistics.median(r[k] for r in same))
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}})
    library = ("bf16 F.conv2d(groups=C), channels-last"
               + ("; PyTorch has no int8 grouped conv" if name.endswith(
                   "_int8") else "")
               if name.startswith("depthwise") else "torch._int_mm")
    if name == "conv2d_implicit_gemm":
        library += ("; f32 F.conv2d(groups=g) at a grouped conv's "
                    "launches (ResNeXt-50); bf16 F.conv2d(dilation=d) at a "
                    "dilated one")
    old_body = {}
    if name == GROUPED:
        library = ("f32 F.conv2d(groups=g), TF32 off, on the int8 values "
                   "(PyTorch has no int8 conv on the card); bf16 "
                   "channels-last in library_bf16_ms")
        # the same launches on the block-diagonal plan they took before
        old_body = {"old_body": "block-diagonal", "old_body_ms": sum(
            r["tiles"]["block-diagonal"] for r in main_rows),
            "library_bf16_ms": sum(r["library_bf16_ms"] for r in main_rows)}
    if name == DILATED:
        library = ("bf16 F.conv2d(dilation=d), channels-last, on the "
                   "dequantized tensors; PyTorch has no int8 conv on the card")
    if name in RAGGED.values():
        library = ("torch._int_mm at the launch's (M, K, N), on operands "
                   "zero-padded to its rules where it refuses the shape")
        # the same launches on the body they took before this variant
        old_body = {"old_body": "mma_sync", "old_body_ms": sum(
            r["tiles"]["mma_sync"] for r in main_rows)}
    if name in CHAINS:
        library = "none: no single PyTorch call computes a bottleneck"
    elif name == "ident":
        library = "x.clone()"
    elif name == "eltwise_int8":
        library = ("the PyTorch ops it replaced (two casts to f32, a "
                   "multiply, addcmul, the activation, a multiply, round, "
                   "clamp, a cast), on scale tensors made once")
    elif name == "stem_conv_int8":
        library = ("what it replaced: the input cast to f32, cuDNN's f32 "
                   "conv (TF32 off), + bias, the activation, a multiply, "
                   "round, clamp, a cast, the scale a tensor made once")
    return {
        "name": name, "route": "cuda", **KERNELS[name],
        "path": main, "launches": counts[main][name],
        "launches_per_forward": counts[main][name],
        "max_abs_err": max_err, "max_err_vs_plain": max_err,
        **sums,
        "bound_by": "bytes" if 2 * by_bytes >= sums["bound_ms"]
        else "operations",
        "library": library,
        **old_body,
        "paths": [{"path": p, "launches": counts[p][name],
                   **_sums([r for r in mine if r["path"] == p])}
                  for p in paths],
        "shapes": shapes,
    }


def witness(path, g, x, quant, config):
    """The witness of ``path``, held on the logits alone
    (``PROB_WITNESS``): the same graph and batch with the witness's change,
    its images 0-1 held to the CPU on the probabilities too
    (``agreement``)."""
    import torch
    import torch.nn.functional as F
    label, change, f64_convs = PROB_WITNESS[path]
    conv = F.conv2d

    def conv_f64(inp, weight, bias=None, *args, **kw):
        return conv(inp.double(), weight.double(),
                    None if bias is None else bias.double(), *args,
                    **kw).to(inp.dtype)

    if f64_convs:
        F.conv2d = conv_f64
    try:
        cfg, eng = make_engine(label, g, quant=quant, **{**config, **change})
        out = eng(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        agreement(label, g, cfg, eng, x, out)
    finally:
        F.conv2d = conv
    del eng, out


def classic_paths(smi, rng, rows, counts, speed):
    """The classic zoo's paths (phases 2-4 each, and GoogLeNet's server):
    VGG-16 b128 w8, w8 on the Winograd route, w8a8; GoogLeNet and AlexNet
    b256 w8a8; SqueezeNet v1.1 b1 fp32 and b128 w8a8.  Adds to ``rows``,
    ``counts`` and ``speed``."""
    import torch
    from feathercnn_tpu_torch.models import (alexnet, googlenet,
                                             squeezenet_v11, vgg16)

    # VGG-16 b128: weight-only int8 on the default route and on the
    # Winograd route (every conv*_* named "winograd"), then full int8
    g = vgg16(batch=BATCH, seed=SEED)
    x = images(g, BATCH, rng)
    wino = tuple((n.name, "winograd") for n in g.nodes
                 if n.op == "Convolution")
    for label, quant, config in [
            ("vgg16 b128 w8", "w8", {}),
            ("vgg16 b128 w8 winograd", "w8", {"algo_overrides": wino})]:
        cfg, eng = make_engine(label, g, quant=quant, **config)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if config:
            winograd_check(label, eng, x)
        del eng
        if label in PROB_WITNESS:
            witness(label, g, x, quant, config)
        torch.cuda.empty_cache()
    label = "vgg16 b128 w8a8"
    g = calibrated(vgg16, BATCH, rng)
    cfg, eng = make_engine(label, g)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
    rows += r
    del eng, x, g
    torch.cuda.empty_cache()

    # GoogLeNet b256 full int8, then its server; AlexNet b256 full int8
    for label, builder in [("googlenet b256", googlenet),
                           ("alexnet b256", alexnet)]:
        g = calibrated(builder, 256, rng)
        x = images(g, 256, rng)
        cfg, eng = make_engine(label, g)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if builder is googlenet:
            serve(eng, x, 256, "GoogLeNet")
        del eng
        if label in PROB_WITNESS:
            witness(label, g, x, "w8a8", {})
        del x
        torch.cuda.empty_cache()

    # SqueezeNet v1.1: fp32 at batch 1 (no quantization, no hand kernel),
    # then full int8 at batch 128
    label = "squeezenet_v11 b1 fp32"
    g = squeezenet_v11(batch=1, seed=SEED)
    cfg, eng = make_engine(label, g, quant=None, compute_dtype="float32")
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, images(g, 1, rng), smi)
    rows += r
    del eng
    label = "squeezenet_v11 b128"
    g = calibrated(squeezenet_v11, BATCH, rng)
    cfg, eng = make_engine(label, g)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, images(g, BATCH, rng),
                                  smi)
    rows += r
    del eng
    torch.cuda.empty_cache()


def ragged_zoo_rest():
    """The B2 launches of the rest of the zoo off their paths' shapes, each
    on "wgmma" and equal to its plain version (int8 0 LSB, bf16 within 1
    ulp): grouped convs on their block-diagonal weight at 4, 8 and 32
    channels a group, stride 1 and 2, odd H and W; asymmetric kernels 1x7
    pad (0, 3), 7x1 (3, 0), 1x3 (0, 1) and 3x1 (1, 0) at stride 1 and 2;
    the super-group route (``groups``, ``grouped_layout``'s weight; counted
    in ``grouped_launches``) on "wgmma_halo" at 4, 8, 16 and 32 channels a
    group (g = 32, q = 32 / (C/32), S = 32: at stride 1 with an int8
    output halos of four column tiles' channels, 128-byte rows, else of
    one, 32-byte rows; a 5 x 4 output map at stride 2, six maps a tile,
    four of them past the batch) and with three and two column tiles
    (halos of one), at stride 1 and 2; and the grouped shapes no q fits,
    each on its block-diagonal weight with the plan's reason: 64 channels
    a group in and 32 out (g = 2), Co != C (16 outputs a group at g = 4),
    C = 24 (g = 3, 32 outputs a group; "wgmma_ragged") and 12 outputs a
    group.
    A generator of its own.  Returns the number of cases."""
    import torch
    from feathercnn_tpu_torch.kernels.dispatch import block_diagonal
    from feathercnn_tpu_torch.kernels.matmul import (gemm_layout,
                                                     grouped_layout,
                                                     supergroup)
    kernel, plain = _kernel_fns()["conv2d_implicit_gemm"]
    gen = torch.Generator(device="cuda").manual_seed(10)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    cases = []
    for cg, s, (h, w) in [(4, 1, (15, 13)), (4, 2, (15, 13)),
                          (8, 1, (9, 11)), (8, 2, (11, 9)),
                          (32, 1, (7, 9)), (32, 2, (9, 7))]:
        co = 32 * cg
        cases.append((f"block-diagonal Cg={cg} g=32 x(2, {h}, {w}, {co}) "
                      f"s{s}", i8(2, h, w, co),
                      gemm_layout(block_diagonal(i8(3, 3, cg, co), 32)),
                      s, 1, 1))
    for kh, kw, ph, pw in [(1, 7, 0, 3), (7, 1, 3, 0), (1, 3, 0, 1),
                           (3, 1, 1, 0)]:
        for s in (1, 2):
            cases.append((f"{kh}x{kw} pad ({ph}, {pw}) x(2, 17, 15, 160) "
                          f"s{s}", i8(2, 17, 15, 160),
                          gemm_layout(i8(kh, kw, 160, 192)), s, ph, pw))
    # (C/g, g, Co/g, stride, (H, W), the variant)
    sgs = [(cg, 32, cg, s, hw, "wgmma_halo") for cg, hw in
           [(4, (15, 13)), (8, (11, 9)), (16, (9, 11)), (32, (7, 9))]
           for s in (1, 2)]
    sgs += [(64, 2, 32, 1, (9, 11), "wgmma"),
            (64, 2, 32, 2, (13, 9), "wgmma"),
            (32, 3, 32, 1, (9, 7), "wgmma_halo"),
            (32, 2, 32, 2, (11, 9), "wgmma_halo"),
            (8, 4, 16, 1, (13, 11), "wgmma"), (8, 4, 16, 2, (11, 13),
                                                "wgmma"),
            (8, 3, 32, 1, (9, 7), "wgmma_ragged"),
            (8, 4, 12, 1, (9, 11), "wgmma")]
    for cg, g, cgo, s, (h, w), want in sgs:
        c, co = cg * g, cgo * g
        q = supergroup(c, co, g)[0]
        wg = i8(3, 3, cg, co)
        wk = grouped_layout(wg, g, q) if q else gemm_layout(
            block_diagonal(wg, g))
        cases.append((f"{'super-group q=' + str(q) if q else 'no q'} "
                      f"C/g={cg} g={g} Co={co} x(2, {h}, {w}, {c}) s{s}",
                      i8(2, h, w, c), wk, s, 1, 1, g, want))
    n = 0
    for what, x, w, s, ph, pw, *grouped in cases:
        g, want = grouped or (1, "wgmma")
        co = w.shape[3]
        for out_dtype in (torch.int8, torch.bfloat16):
            a = dict(x=x, w=w, bias=torch.randn(co, device="cuda",
                                                generator=gen),
                     w_scale=torch.rand(co, device="cuda", generator=gen)
                     * 1e-3 + 1e-4, stride=s, pad_h=ph, pad_w=pw,
                     activation="relu", out_dtype=out_dtype, x_scale=1.0,
                     out_scale=0.5, groups=g)
            before = dict(kernel.variants)
            routed = kernel.grouped_launches
            got = kernel(**a)
            took = [v for v, m in kernel.variants.items() if m != before[v]]
            check(took == [want], f"{what} {out_dtype}: took {took}")
            route = kernel.grouped_launches - routed
            check(route == int(what.startswith("super-group")),
                  f"{what}: {route} launches on the super-group route")
            if g > 1 and "no q" in what:
                reason = gemm_plan_of(GEMMS[1], a).reason
                check(reason.startswith("block-diagonal: "),
                      f"{what}: plan reason {reason!r}")
            err, ok, _ = compare(got, plain(**a))
            check(ok, f"{what} {out_dtype}: max err {err}")
            n += 1
    return n


def ragged_dilated():
    """The dilated ``conv2d_implicit_gemm`` off its paths' shapes, each
    held against its plain version (int8 out 0 LSB, bf16 out within 1 ulp;
    a float x within the float-sum gate): 3x3 at d = 2, 4, 6 and 12, pad d
    (the zoo's) and pad 0, C of 16, 48 and 64, odd H and W, stride 1 and
    2, int8 x on "wgmma" (the zoo's route), a bf16 x with an int8 weight
    on "wgmma_w8" (C a multiple of 64: A by TMA, one box per tap shifted
    by the dilation) and an f32 x on "simt"; then d = 12 on a map
    smaller than the dilated kernel's span (most taps in the padding,
    DeepLab's fc6).  A generator of its own.  Returns the number of
    cases."""
    import torch
    from feathercnn_tpu_torch.kernels.matmul import gemm_layout
    kernel, plain = _kernel_fns()["conv2d_implicit_gemm"]
    gen = torch.Generator(device="cuda").manual_seed(11)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=gen)

    cases = []      # (what, x, w, stride, pad, dilation, variant)
    for d in (2, 4, 6, 12):
        for pad in (d, 0):
            for c, (h, w) in ((16, (2 * d + 9, 2 * d + 7)),
                              (48, (2 * d + 5, 2 * d + 11)),
                              (64, (2 * d + 15, 2 * d + 13))):
                for s in ((1, 2) if c == 64 else (1,)):
                    cases.append((f"d={d} pad {pad} x(2, {h}, {w}, {c}) s{s}",
                                  i8(2, h, w, c),
                                  gemm_layout(i8(3, 3, c, 96)), s, pad, d,
                                  "wgmma"))
    cases.append(("d=12 pad 12 x(1, 9, 11, 64): taps past the map",
                  i8(1, 9, 11, 64), gemm_layout(i8(3, 3, 64, 160)), 1, 12,
                  12, "wgmma"))
    for d in (2, 4):
        x = torch.randn(2, 17, 19, 128, device="cuda", generator=gen)
        cases.append((f"d={d} pad {d} bf16 x(2, 17, 19, 128) int8 w",
                      x.to(torch.bfloat16), gemm_layout(i8(3, 3, 128, 64)),
                      1, d, d, "wgmma_w8"))
        cases.append((f"d={d} pad {d} f32 x(2, 17, 19, 24) f32 w", x[..., :24]
                      .contiguous(), gemm_layout(torch.randn(
                          3, 3, 24, 40, device="cuda", generator=gen) * 0.1),
                      1, d, d, "simt"))
    n = 0
    for what, x, w, s, pad, d, want in cases:
        co = w.shape[3]
        outs = ((torch.int8, torch.bfloat16) if x.dtype == torch.int8
                else (torch.bfloat16 if x.dtype == torch.bfloat16
                      else torch.float32,))
        for out_dtype in outs:
            a = dict(x=x, w=w, bias=torch.randn(co, device="cuda",
                                                generator=gen),
                     w_scale=(torch.rand(co, device="cuda", generator=gen)
                              * 1e-3 + 1e-4) if w.dtype == torch.int8
                     else None, stride=s, pad_h=pad, pad_w=pad,
                     activation="relu", out_dtype=out_dtype, x_scale=1.0,
                     out_scale=0.5 if out_dtype == torch.int8 else 1.0,
                     dilation=d)
            before = dict(kernel.variants)
            got = kernel(**a)
            took = [v for v, m in kernel.variants.items() if m != before[v]]
            check(took == [want], f"dilated {what} {out_dtype}: took {took}, "
                  f"expected {want}")
            err, ok, _ = compare(got, plain(**a),
                                 "exact" if x.dtype == torch.int8 else "float")
            check(ok, f"dilated {what} {out_dtype}: max err {err}")
            n += 1
    return n


def zoo_rest_paths(smi, rng, rows, counts, speed):
    """The rest of the classification zoo (phases 2-4 each), w8a8:
    DenseNet-121 b128, ResNeXt-50 b128 and its server, SE-ResNet-50 b96,
    Inception-v3 b128, ShuffleNet v1 and v2 b128 (``ZOO_REST``), after the
    ragged cases of the grouped (super-group and block-diagonal) and
    asymmetric
    ``conv2d_implicit_gemm`` launches.  Adds to ``rows``, ``counts`` and
    ``speed``."""
    import functools
    import torch
    from feathercnn_tpu_torch.models import build_model
    n = ragged_zoo_rest()
    say("kernels", f"{n} block-diagonal (Cg 4, 8, 32), asymmetric (1x7, "
        f"7x1, 1x3, 3x1) and grouped (wgmma_halo at C/g 4, 8, 16, 32, "
        f"g = 32, and with 3 and 2 column tiles; block-diagonal where no q "
        f"fits: 64 in / 32 out a group, Co != C at g = 4, C = 24 on "
        f"wgmma_ragged, 12 outputs a group) conv2d_implicit_gemm cases at "
        f"stride 1 and 2, each on its planned variant and equal to plain")
    for label, (name, batch) in ZOO_REST.items():
        g = calibrated(functools.partial(build_model, name), batch, rng)
        x = images(g, batch, rng)
        cfg, eng = make_engine(label, g)
        counts[label] = EXPECTED[label]
        r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if name == "resnext50":
            serve(eng, x, batch, "ResNeXt-50")
        if name == "densenet121":
            concat_ms = {n.name: node_ms[n.name] for n in eng.graph.nodes
                         if n.op == "Concat" and n.name in node_ms}
            del eng
            torch.cuda.empty_cache()
            ladder_path(g, x, concat_ms, smi, rows, counts, speed)
        else:
            del eng
        del x, g
        torch.cuda.empty_cache()


def segmentation_paths(smi, rng, rows, counts, speed):
    """The segmentation family (phases 2-4 each), w8a8 at its deploy sizes
    (``SEGMENTATION``), after the dilated ``conv2d_implicit_gemm`` cases.
    Adds to ``rows``, ``counts`` and ``speed``."""
    import functools
    import torch
    from feathercnn_tpu_torch.models import build_model
    n = ragged_dilated()
    say("kernels", f"{n} dilated conv2d_implicit_gemm cases (d = 2, 4, 6, "
        f"12; pad d and 0; stride 1 and 2; int8 x on wgmma, bf16 x with an "
        f"int8 weight on wgmma_w8, f32 x on simt), each equal to plain "
        f"within its gate")
    for label, (name, batch, _) in SEGMENTATION.items():
        g = calibrated(functools.partial(build_model, name), batch, rng)
        x = images(g, batch, rng)
        cfg, eng = make_engine(label, g)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        del eng, x, g
        torch.cuda.empty_cache()


def loaded_path(g, x, built, smi, rows, counts, speed):
    """The main path's calibrated graph written by the port's ``save_ftpu``
    into a temporary directory, reloaded by ``Engine.from_path`` through
    the native mmap loader (its default; the native library built and the
    loader called), compiled (``compile(batch)``) and run as a path of its
    own (phases 2-4): its output on ``x`` equal to the built engine's
    ``built`` (``torch.equal``), and its ``summary(top=5)`` printed; then
    the same file served by the CLI over HTTP (``cli_http``)."""
    import tempfile
    import torch
    from feathercnn_tpu_torch import Engine, native
    from feathercnn_tpu_torch.model_format import save_ftpu
    label = "resnet50 b128 loaded"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.ftpu")
        save_ftpu(g, path)
        t0 = time.perf_counter()
        cfg = engine_config()
        loads, orig = [], native.load_ftpu_native

        def counted(p):
            loads.append(p)
            return orig(p)

        native.load_ftpu_native = counted
        try:
            eng = Engine.from_path(path, cfg)
        finally:
            native.load_ftpu_native = orig
        check(loads == [path] and native.available(),
              f"Engine.from_path loaded {loads} through the native loader, "
              f"library built: {native.available()}")
        eng.compile(batch=len(x))
        say(label, f"{os.path.getsize(path) / 1e6:.1f} MB .ftpu written by "
            f"save_ftpu, loaded by Engine.from_path through the native "
            f"mmap loader ({native.library_path().name}, built at first "
            f"use) and compiled at b{len(x)} in "
            f"{time.perf_counter() - t0:.1f} s")
        check(eng.device.type == "cuda", f"engine on {eng.device}")
        got = eng(torch.from_numpy(x).cuda())
        check(torch.equal(got, built), f"{label}: output differs from the "
              f"built engine's (max |diff| "
              f"{float((got.float() - built.float()).abs().max())})")
        say(label, f"output equal to the built engine's (torch.equal, "
            f"{tuple(got.shape)} {str(got.dtype).replace('torch.', '')})")
        print(eng.summary(top=5).replace("\n", " | "), flush=True)
        del got
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi)
        rows += r
        cli_http(path, eng, smi)
    del eng
    torch.cuda.empty_cache()


def _ulps32(a, b):
    """Elementwise distance in f32 ulps of two f32 numpy arrays."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def detection_agreement(label, cpu, eng, x):
    """A detection path's agreement, in three steps (its output is
    data-dependent, so a cosine of the rows says little):

    1. the head's inputs (``mbox_loc`` and ``mbox_conf_flatten``, or
       ``rpn_cls_prob_reshape`` and ``rpn_bbox_pred``) of images 0-1 (0 at
       batch 1) on the card against the port on the CPU: cosine >= 0.999;
    2. every head node (DetectionOutput, Proposal, ROIPooling,
       PSROIPooling) of the whole batch run by the port on the CPU on the
       card's own input values: the card's rows equal, image, label,
       score and order bit for bit, each box coordinate within
       ``BOX_ULPS`` f32 ulps; a pooled ROI feature equal (ROIPooling,
       a max) or within 1 ulp of its type (PSROIPooling, f64 sums rounded
       once);
    3. the kept detections or ROIs counted."""
    import torch
    from feathercnn_tpu_torch.ops.lowering import lower_node
    heads = [n for n in cpu.graph.nodes if n.op in HEAD_OPS]
    k = min(2, batch_of(x))
    blobs = list(heads[0].inputs[:2])
    ref = cpu.run(first(x, k), extract=blobs)
    got = eng.run(to_card(first(x, k)), extract=blobs)
    for b in blobs:
        for i in range(k if heads[0].op == "DetectionOutput" else 1):
            r = ref[b][i].double().numpy().ravel()
            t = got[b][i].double().cpu().numpy().ravel()
            cos = _cosine(t, r)
            check(cos >= 0.999, f"{label} image {i}: {b} cosine {cos}")
            say("agreement", f"{label} image {i}: head input {b} cosine "
                f"{cos:.6f} (>= 0.999), max |diff| "
                f"{float(np.abs(t - r).max()):.3e}")
    names = sorted({v for n in heads for v in n.inputs + n.outputs})
    vals = eng.run(to_card(x), extract=names)
    vals = {k_: v.cpu() for k_, v in vals.items()}
    for n in heads:
        with torch.inference_mode():
            (mine,) = lower_node(n, [vals[i] for i in n.inputs], [],
                                 cpu._ctx)
        card = vals[n.outputs[0]]
        if n.op in ("DetectionOutput", "Proposal"):
            c, m = card.numpy(), mine.numpy()
            ids = slice(0, 3) if n.op == "DetectionOutput" else slice(0, 1)
            boxes = slice(3, 7) if n.op == "DetectionOutput" else slice(1, 5)
            same = np.array_equal(c[..., ids], m[..., ids])
            check(same, f"{label} {n.name}: the card's rows differ from the "
                  f"port's on the CPU in image, label or score "
                  f"({int((c[..., ids] != m[..., ids]).any(-1).sum())} rows)")
            u = int(_ulps32(np.ascontiguousarray(c[..., boxes]),
                            np.ascontiguousarray(m[..., boxes])).max())
            check(u <= BOX_ULPS, f"{label} {n.name}: a box {u} ulps off")
            kept = (int((c[..., 1] >= 0).sum()) if n.op == "DetectionOutput"
                    else int((c[:, 0] >= 0).sum()))
            what = ("detections" if n.op == "DetectionOutput"
                    else "ROIs")
            held = ("image, label, score" if n.op == "DetectionOutput"
                    else "image")
            slots = (f"{c.shape[1]} slots x {c.shape[0]} images"
                     if c.ndim == 3 else f"{c.shape[0]}")
            say("agreement", f"{label} {n.name}: the card's {c.shape} rows "
                f"equal the port's on the CPU on the card's inputs ({held} "
                f"and order bit for bit, boxes within {u} ulp); {kept} "
                f"{what} kept of {slots}")
            continue
        if n.op == "ROIPooling":
            check(torch.equal(card, mine),
                  f"{label} {n.name}: differs from the port on the CPU")
            say("agreement", f"{label} {n.name}: {tuple(card.shape)} equal "
                f"to the port's on the CPU on the card's inputs")
            continue
        d = (card.float() - mine.float()).abs()
        tol = (torch.finfo(card.dtype).eps
               * torch.maximum(card.float().abs(), mine.float().abs()))
        check(bool((d <= tol).all()), f"{label} {n.name}: max |diff| "
              f"{float(d.max())} over 1 ulp")
        say("agreement", f"{label} {n.name}: {tuple(card.shape)} within 1 "
            f"ulp of the port's on the CPU on the card's inputs "
            f"({int((d > 0).sum())} values off, max |diff| {float(d.max()):.3e})")


def fma_check(eng, x):
    """The port's multiply-add (``numerics.fma``: ``torch.addcmul`` on
    the card) against its CPU form (``fma_f32``: the f64 product and sum,
    rounded to odd, then to f32) on ResNet-50's own tensors, on the card:
    each int8 Eltwise node's inputs of 32 images through
    ``eltwise_int8_plain`` (0 LSB), and an f32 ``coeffs`` sum (0.3, -1.7)
    of the same inputs dequantized (0 ulp).  The node's own lowering (the
    ``eltwise_int8`` kernel) is held to the f64 form too (0 LSB)."""
    import torch
    from feathercnn_tpu_torch import numerics
    from feathercnn_tpu_torch.kernels.eltwise import eltwise_int8_plain
    from feathercnn_tpu_torch.numerics import reciprocal
    from feathercnn_tpu_torch.ops import lowering
    q = eng.graph.meta["quant"]
    nodes = [n for n in eng.graph.nodes if n.op == "Eltwise"
             and (q.get(n.name) or {}).get("eltwise_int8")]
    vals = eng.run(to_card(x[:32]), extract=sorted(
        {i for n in nodes for i in n.inputs}))
    f32_vals = 0
    for n in nodes:
        ins = [vals[i] for i in n.inputs]
        qn = q[n.name]
        args = (*ins, *qn["in_scales"], reciprocal(qn["y_scale"]),
                n.attrs.get("activation"))
        f32 = [numerics.dequantize(v, s)
               if v.dtype == torch.int8 and s is not None else v.float()
               for v, s in zip(ins, qn["in_scales"])]
        with torch.inference_mode():
            (kernel,) = lowering.lower_node(n, ins, [], eng._ctx)
            card = eltwise_int8_plain(*args)
            coeff = lowering._coeff_sum(n, [0.3, -1.7], f32, eng._ctx)
            orig, numerics.fma = numerics.fma, numerics.fma_f32
            try:
                exact = eltwise_int8_plain(*args)
                coeff_exact = lowering._coeff_sum(n, [0.3, -1.7], f32,
                                                  eng._ctx)
            finally:
                numerics.fma = orig
        for what, got in (("torch.addcmul", card), ("the kernel", kernel)):
            check(got.dtype == torch.int8 and torch.equal(got, exact),
                  f"int8 Eltwise {n.name} through {what}: "
                  f"{int((got != exact).sum())} values off the f64 form")
        check(torch.equal(coeff.view(torch.int32),
                          coeff_exact.view(torch.int32)),
              f"coeffs sum at {n.name}: "
              f"{int((coeff.view(torch.int32) != coeff_exact.view(torch.int32)).sum())}"
              f" values off the f64 form")
        f32_vals += coeff.numel()
    say("fma", f"{len(nodes)} int8 Eltwise nodes of ResNet-50 (32 images): "
        f"eltwise_int8_plain's torch.addcmul on the card and the nodes' "
        f"eltwise_int8 kernel equal to the f64 form rounded once (0 LSB); "
        f"the f32 coeffs sum (0.3, -1.7) of their dequantized inputs, "
        f"{f32_vals} values: 0 ulp")


def ladder_filled(graph):
    """{``__buf`` value: channels filled when its node ran} of a graph's
    concat ladders: later appends write the rest of the one buffer in
    place, so a ``__buf`` value read after the forward is held on these
    channels alone."""
    out = {}
    for n in graph.nodes:
        if n.op in ("LadderInit", "LadderAppend"):
            parts = n.inputs if n.op == "LadderInit" else n.inputs[1:]
            out[n.outputs[0]] = n.attrs.get("offset", 0) + sum(
                graph.specs[p].shape[-1] for p in parts)
    return out


def card_nodes(label, g, cfg, eng, x, compare=True):
    """Node by node: each node of the card's graph run by the port on the
    CPU on the card's own input values (images 0-1), and every int8 output
    held to the card's.  A library float conv (cuDNN's s2d 4x4 stem on 12
    channels) may differ by 1 LSB (the share that differs printed); every
    other int8 output (a hand kernel, or an exact integer op) equal: the
    stem kernel among them, which sums in the CPU's order (these paths'
    7x7 stems pad by 3: PyTorch's CPU conv sums them in r, s, c order).  A conv with no
    ``x_scale`` takes the float conv (the dispatcher's float branch, as
    the reference's); one with an ``x_scale`` takes a hand kernel on int8
    input, quantized first where its input is float.  A ladder's
    ``__buf`` edges are held on their filled channels, and a ladder node
    runs on a copy of its buffer (it writes in place).  ``eng`` may be one
    rank of a sharded engine (its ``extract`` gives the global values):
    every rank of its mesh takes the card's values, and only a rank with
    ``compare`` holds them (``cfg`` then is the unsharded config the CPU
    engine runs)."""
    import torch
    from feathercnn_tpu_torch import Engine
    from feathercnn_tpu_torch.ops.lowering import lower_node
    k = min(2, batch_of(x))
    names = [o for n in eng.graph.nodes for o in n.outputs]
    card = {name: v.cpu() for name, v in
            eng.run(to_card(first(x, k)), extract=names).items()}
    if not compare:
        return
    cpu = Engine(g, cfg, device="cpu")
    check([(n.name, n.op, n.inputs) for n in cpu.graph.nodes]
          == [(n.name, n.op, n.inputs) for n in eng.graph.nodes],
          f"{label}: the CPU engine built another graph")
    cdtype = getattr(torch, cfg.compute_dtype)
    for name, v in (first(x, k) if isinstance(x, dict)
                    else {next(iter(eng.graph.inputs)): x[:k]}).items():
        t = torch.from_numpy(v)
        card[name] = t.to(cdtype) if t.dim() == 4 else t
    params = cpu._prepare_params()
    filled = ladder_filled(eng.graph)
    checked = exact = worst = eltwise = 0
    loose = []
    for n in eng.graph.nodes:
        ins = [card[i].clone() if n.op.startswith("Ladder") else card[i]
               for i in n.inputs]
        with torch.inference_mode():
            outs = lower_node(n, ins, [params[p] for p in n.params],
                              cpu._ctx)
        for o, mine in zip(n.outputs, outs):
            theirs = card[o]
            if theirs.dtype != torch.int8:
                continue
            check(mine.dtype == torch.int8, f"{label} {o}: int8 on the "
                  f"card, {mine.dtype} on the CPU")
            if o in filled:
                theirs, mine = theirs[..., :filled[o]], mine[..., :filled[o]]
            d = (theirs.int() - mine.int()).abs()
            m = int(d.max())
            checked += 1
            exact += m == 0
            eltwise += n.op == "Eltwise"
            worst = max(worst, m)
            q = cpu._ctx.qinfo(n) or {}
            if (n.op == "Convolution" and q.get("x_scale") is None
                    and card[n.inputs[0]].shape[-1] > 4):
                share = float((d > 0).float().mean())
                loose.append(f"{n.name} (library float conv) {m} LSB at "
                             f"{100 * share:.4f}% of {d.numel()}")
                check(m <= 1, f"{label} {n.name}: the card's library float "
                      f"conv {m} LSB off the port on the CPU")
            else:
                check(m == 0, f"{label} {n.name} ({n.op}): "
                      f"{int((d > 0).sum())} int8 values up to {m} LSB off "
                      "the port on the CPU on the card's inputs")
    say("nodes", f"{label}: {checked} nodes' int8 outputs (images 0-{k - 1})"
        f" on the card against the port on the CPU fed the card's inputs: "
        f"{exact} exact ({eltwise} int8 Eltwise nodes among them, each "
        f"exact), largest difference {worst} LSB; "
        + ("; ".join(loose) if loose else "no library float conv"))


def s2d_path(g, x, main_ms, smi, rows, counts, speed):
    """The main path's calibrated graph with ``s2d_stem`` (phases 2-4):
    one SpaceToDepth in front of a 4x4 s1 stem on 12 channels, the main
    path's launches; the stem's device ms beside the main path's 7x7 stem
    (``main_ms``: the main path's node ms), then the node-by-node check."""
    import torch
    label = "resnet50 b128 s2d"
    cfg, eng = make_engine(label, g, s2d_stem=True)
    s2d = [n for n in eng.graph.nodes if n.op == "SpaceToDepth"]
    check(len(s2d) == S2D_STEMS, f"{label}: {len(s2d)} SpaceToDepth nodes")
    stem = next(n for n in eng.graph.nodes if n.inputs == s2d[0].outputs)
    a = stem.attrs
    shape = eng.graph.specs[stem.inputs[0]].shape
    check(stem.op == "Convolution" and (a["kernel_h"], a["kernel_w"],
                                        a["stride"], a["pad"]) == (4, 4, 1, 0)
          and shape[-1] == 12, f"{label}: stem {stem.op} {a} on {shape}")
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    # the stem keeps the main path's 7x7 conv's name
    old = stem.name
    # the two stems' cuDNN f32 convs alone, as the float branch runs them
    # (x upcast from bf16, the weight dequantized), on the path's images
    from feathercnn_tpu_torch.numerics import nchw_conv
    from feathercnn_tpu_torch.ops.lowering import lower_node
    q = eng.graph.meta["quant"][stem.name]
    ws = torch.as_tensor(np.asarray(q["w_scale"], np.float32)).cuda()
    xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
    with torch.inference_mode():
        (xs,) = lower_node(s2d[0], [xb], [], eng._ctx)
    w7 = torch.from_numpy(g.params[stem.params[0]]).cuda().float()
    w4 = torch.from_numpy(eng.graph.params[stem.params[0]]).cuda().float() * ws
    x7, x4 = xb.float(), xs.float()
    ms7 = median_ms(lambda: nchw_conv(x7, w7, (2, 2), (3, 3)))
    ms4 = median_ms(lambda: nchw_conv(x4, w4, (1, 1), (0, 0)))
    say("profile", f"{label}: the stems' cuDNN f32 convs alone (median of "
        f"20): 7x7 s2 on {tuple(x7.shape)} {ms7:.4f} ms, 4x4 s1 on "
        f"{tuple(x4.shape)} {ms4:.4f} ms ({smi})")
    del xb, xs, x7, x4, w7, w4
    # a node whose device range the profiler did not keep in this run (the
    # set of ranges it keeps varies from run to run) is "not measured"
    def range_ms(ms, name):
        return f"{ms[name]:.3f} ms" if name in ms else "not measured"

    both = (node_ms[s2d[0].name] + node_ms[stem.name]
            if s2d[0].name in node_ms and stem.name in node_ms else None)
    say("profile", f"{label}: stem {s2d[0].name} (SpaceToDepth) "
        f"{range_ms(node_ms, s2d[0].name)} + {stem.name} (cuDNN 4x4 s1 on "
        f"{shape}) {range_ms(node_ms, stem.name)} = "
        + ("not measured" if both is None else f"{both:.3f} ms")
        + f", against the main path's 7x7 s2 {old} {range_ms(main_ms, old)}"
        f"; ms per batch {speed[label]:.2f} against "
        f"{speed['resnet50 b128']:.2f}, device busy "
        f"{BUSY.get(label, 0):.3f} against "
        f"{BUSY.get('resnet50 b128', 0):.3f} ms ({smi})")
    card_nodes(label, g, cfg, eng, x)
    del eng
    torch.cuda.empty_cache()


def ladder_path(g, x, concat_ms, smi, rows, counts, speed):
    """DenseNet-121 b128 with ``concat_dus`` (phases 2-4) on the plain
    DenseNet path's graph and images: 4 ladders, 54 appends and no Concat
    left, the plain path's launches; each append wrote in place (the
    buffer's storage the same along a ladder); the ladder nodes' device ms
    by node beside the plain path's Concats (``concat_ms``: each Concat
    node's ms in the plain path's profiled forward), both paths' ms per
    batch and device busy; then the node-by-node check."""
    import torch
    label = "densenet121 b128 concat_dus"
    cfg, eng = make_engine(label, g, concat_dus=True)
    ops = [n.op for n in eng.graph.nodes]
    got = (ops.count("LadderInit"), ops.count("LadderAppend"),
           ops.count("Concat"))
    check(got == LADDERS, f"{label}: ladders, appends, Concats {got}, "
          f"expected {LADDERS}")
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    ladders = []
    for n in eng.graph.nodes:
        if n.op == "LadderInit":
            ladders.append([n.outputs[0]])
        elif n.op == "LadderAppend":
            check(n.inputs[0] == ladders[-1][-1], f"{n.name} appends to "
                  f"{n.inputs[0]}")
            ladders[-1].append(n.outputs[0])
    vals = eng.run(to_card(x[:2]), extract=[b for lad in ladders
                                            for b in lad])
    for lad in ladders:
        ptrs = {vals[b].data_ptr() for b in lad}
        check(len(ptrs) == 1, f"{label}: ladder {lad[0]} in {len(ptrs)} "
              "storages")
    del vals
    cons = eng.graph.consumers()
    views = [n for n in eng.graph.nodes if n.op == "LadderView"]
    strided = [n for n in views
               if n.attrs["channels"] < eng.graph.specs[n.inputs[0]].shape[-1]]
    readers = {}
    for n in strided:
        for u in cons[n.outputs[0]]:
            readers[u.op] = readers.get(u.op, 0) + 1
    copies = sum(c for op, c in readers.items()
                 if op in ("Convolution", "InnerProduct"))
    appends = ", ".join(str(len(lad) - 1) for lad in ladders)
    say(label, f"{len(ladders)} ladders, each one storage from its "
        f"LadderInit through its {appends} appends (data_ptr unchanged); "
        f"{len(strided)} of {len(views)} "
        f"views strided, read by {readers}: {copies} contiguous copies "
        f"in a hand kernel's wrapper")
    if node_ms and concat_ms:
        lad = [(n.name, n.op, node_ms[n.name]) for n in eng.graph.nodes
               if n.op.startswith("Ladder") and n.name in node_ms]
        cat = list(concat_ms.values())
        by_op = {}
        for _, op, ms in lad:
            by_op[op] = by_op.get(op, 0.0) + ms
        say("profile", f"{label}: the {len(lad)} ladder nodes "
            f"{sum(ms for _, _, ms in lad):.3f} ms ("
            + ", ".join(f"{op} {ms:.3f}" for op, ms in sorted(by_op.items()))
            + f") against the plain path's {len(cat)} Concats "
            f"{sum(cat):.3f} ms; ms per batch {speed[label]:.2f} against "
            f"{speed['densenet121 b128']:.2f}, device busy "
            f"{BUSY.get(label, 0):.3f} against "
            f"{BUSY.get('densenet121 b128', 0):.3f} ms ({smi})")
        say("profile", f"{label}: ladder nodes by node (ms): " + ", ".join(
            f"{name} {ms:.4f}" for name, _, ms in lad))
    card_nodes(label, g, cfg, eng, x)
    del eng
    torch.cuda.empty_cache()


def _http(base, path, body=None, ctype=None, timeout=300):
    """(status, content type, body) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _npy(a):
    import io
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _first_diverging(eng, other, x):
    """The first node whose outputs differ between two engines over the
    same graph on ``x`` (both on the card), with its largest difference."""
    names = [o for n in eng.graph.nodes for o in n.outputs]
    a = eng.run(x, extract=names)
    b = other.run(x, extract=names)
    for n in eng.graph.nodes:
        for o in n.outputs:
            d = float((a[o].float() - b[o].float()).abs().max())
            if d:
                return f"{n.name} ({n.op}) {o}: max |diff| {d}"
    return "no node differs in process"


def cli_http(path, eng, smi):
    """``python -m feathercnn_tpu_torch.serve --model <path>`` (ResNet-50
    w8a8, b128) in a subprocess: seeded uint8 pictures of ``RAW_SIZE``
    through the port's C++ ``preprocess`` to 224x224 f32 (against its numpy
    path: under 1% of the int8 values 1 LSB apart, tests/test_serving.py's
    limit, and f32 within half an int8 step: its atol 2e-5 was measured at
    37x53 -> 24x24, and at this size the C++ source's f32 coordinates
    move a value by ~1e-4, in the reference's C++ too,
    tests/test_torch_native.py), ``HTTP_NPY`` of them sent
    as .npy from 8 client threads and ``HTTP_JSON`` as JSON; every answer
    equal to ``eng``'s direct run of the same images at batch 128 (0
    difference), ``/healthz`` 200, ``/metrics`` showing the requests and 0
    faults; the subprocess stopped by SIGTERM and exiting 0, having loaded
    the kernels' library that is already built."""
    import io
    import json
    import queue
    import signal
    import torch
    from feathercnn_tpu_torch import native
    from feathercnn_tpu_torch.kernels import build
    from feathercnn_tpu_torch.serve import InferenceServer, preprocess
    label = "serve CLI"
    rng = np.random.default_rng(SEED + 16)
    n = HTTP_NPY + HTTP_JSON
    raw = rng.integers(0, 256, size=(n,) + RAW_SIZE + (3,), dtype=np.uint8)
    mean, std = IMAGENET
    t0 = time.perf_counter()
    imgs = np.stack([preprocess(im, (224, 224), mean, std) for im in raw])
    t_cc = time.perf_counter() - t0
    ref = np.stack([preprocess(im, (224, 224), mean, std,
                               prefer_native=False) for im in raw])
    check(native.available(), "the native library is not built")
    srv = InferenceServer(eng, batch_size=BATCH)     # not started
    scale = srv._transfer_scale
    check(scale is not None, "int8 transfer not engaged")
    f32_diff = float(np.abs(imgs - ref).max())
    check(f32_diff < scale / 2, f"C++ f32 preprocess {f32_diff} off the "
          f"numpy path, half an int8 step is {scale / 2}")
    i8 = np.stack([preprocess(im, (224, 224), mean, std, quant_scale=scale)
                   for im in raw])
    i8_np = np.stack([preprocess(im, (224, 224), mean, std,
                                 quant_scale=scale, prefer_native=False)
                      for im in raw])
    d8 = np.abs(i8.astype(np.int32) - i8_np)
    off = float((d8 > 0).mean())
    check(off < 0.01 and d8.max() <= 1,
          f"C++ int8 preprocess: {off} of the values differ, by up to "
          f"{d8.max()}")
    say(label, f"{n} seeded uint8 {RAW_SIZE} pictures through the C++ "
        f"preprocess to 224x224 in {t_cc * 1e3:.1f} ms: f32 max |diff| "
        f"{f32_diff:.3e} from the numpy path (held below half an int8 "
        f"step; the C++ source coordinates are f32, the numpy ones f64), "
        f"int8 at the stem's scale {scale:.6g}: {100 * off:.4f}% of the "
        f"values 1 LSB apart (< 1%, tests/test_serving.py's limit)")
    q = srv._to_transfer(imgs)
    pad = np.zeros((BATCH - n,) + q.shape[1:], q.dtype)
    full = torch.from_numpy(np.concatenate([q, pad])).cuda()
    direct = eng(full).float().cpu().numpy()[:n].reshape(n, -1)
    del srv

    lib = build.library_dir() / build._LIB_NAME
    before = (sorted(os.listdir(lib.parent.parent)), lib.stat().st_mtime_ns)
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "feathercnn_tpu_torch.serve", "--model",
           path, "--quant", "w8a8", "--batch-size", str(BATCH), "--host",
           "127.0.0.1", "--port", "0"]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    log = []

    def reader():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=300)
            check(line is not None, "the CLI exited before serving: "
                  + "".join(log))
            log.append(line)
            if line.startswith("serving on 127.0.0.1:"):
                port = int(line.split()[2].rsplit(":", 1)[1])
        t_up = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        answers = [None] * n
        errors = []

        def client(t):
            for i in range(t, HTTP_NPY, 8):
                code, ctype, body = _http(base, "/infer", _npy(imgs[i]),
                                          "application/x-npy")
                if code != 200 or ctype != "application/x-npy":
                    errors.append((i, code, body[:200]))
                    continue
                answers[i] = np.load(io.BytesIO(body))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        for i in range(HTTP_NPY, n):
            body = json.dumps({"data": imgs[i].tolist()}).encode()
            code, ctype, body = _http(base, "/infer", body,
                                      "application/json")
            if code != 200 or ctype != "application/json":
                errors.append((i, code, body[:200]))
                continue
            answers[i] = np.asarray(json.loads(body)["result"], np.float32)
        check(not errors, f"{label}: failed requests {errors}")
        worst = max(float(np.abs(a.ravel() - direct[i]).max())
                    for i, a in enumerate(answers))
        if worst:
            from feathercnn_tpu_torch import Engine
            other = Engine.from_path(path, eng.config)
            check(False, f"{label}: answers up to {worst} off the direct "
                  f"run; in process, from_path against the engine: "
                  + _first_diverging(eng, other, full))
        code, _, body = _http(base, "/healthz")
        check(code == 200, f"{label}: /healthz {code}")
        code, _, body = _http(base, "/metrics")
        text = body.decode()
        check(code == 200 and f"feathercnn_images {n}\n" in text
              and "feathercnn_faults 0\n" in text,
              f"{label}: /metrics {code}: {text}")
        metrics = dict(line.split() for line in text.splitlines())
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    check(rc == 0, f"{label}: the CLI exited {rc}: " + "".join(log[-20:]))
    after = (sorted(os.listdir(lib.parent.parent)), lib.stat().st_mtime_ns)
    check(after == before, f"{label}: the CLI rebuilt the kernels: "
          f"{before} -> {after}")
    say(label, f"python -m feathercnn_tpu_torch.serve --model "
        f"{os.path.basename(path)} --quant w8a8 --batch-size {BATCH}: "
        f"serving on port {port} {t_up:.1f} s after start (the kernels' "
        f"library found built); {HTTP_NPY} .npy requests from 8 threads in "
        f"{wall:.2f} s and {HTTP_JSON} JSON requests, every answer equal "
        f"to the direct run at b{BATCH} (0 difference); /healthz 200; "
        f"/metrics: {metrics['feathercnn_images']} images in "
        f"{metrics['feathercnn_batches']} batches, "
        f"{metrics['feathercnn_faults']} faults; stopped, exit 0 ({smi})")


def two_stage_http(eng, x):
    """Faster R-CNN b1 behind an in-process ``HttpFrontend(port=0)`` over
    an ``InferenceServer`` with ``im_info`` as its extra input:
    ``HTTP_TWO_STAGE`` requests (the path's image and seeded others), each
    ``.npz`` answer equal to the engine's outputs on the same int8-
    transferred image, and ``decode_detections`` on the answer equal to
    it on the direct outputs."""
    import io
    import torch
    from feathercnn_tpu_torch.serve import (HttpFrontend, InferenceServer,
                                            decode_detections)
    label = "two-stage HTTP"
    info = x["im_info"][:1]
    h, w = x["data"].shape[1:3]
    rng = np.random.default_rng(SEED + 17)
    imgs = [x["data"][0]] + [
        rng.normal(size=x["data"].shape[1:]).astype(np.float32)
        for _ in range(HTTP_TWO_STAGE - 1)]
    srv = InferenceServer(eng, batch_size=1, extra_inputs={"im_info": info})
    srv.start()
    front = HttpFrontend(srv, host="127.0.0.1", port=0)
    front.start()
    kept = []
    try:
        base = f"http://127.0.0.1:{front.port}"
        for i, img in enumerate(imgs):
            code, ctype, body = _http(base, "/infer", _npy(img),
                                      "application/x-npy")
            check((code, ctype) == (200, "application/x-npz"),
                  f"{label} request {i}: {code} {ctype} {body[:200]}")
            arch = np.load(io.BytesIO(body))
            out = eng.run({"data": torch.from_numpy(
                srv._to_transfer(img[None])).cuda(),
                "im_info": torch.from_numpy(info).cuda()})
            for k, v in out.items():
                v = v.float().cpu().numpy()
                check(np.array_equal(arch[k], v.reshape(arch[k].shape)),
                      f"{label} request {i}: {k} differs from the direct run")
            args = [arch["cls_prob"], arch["bbox_pred"], arch["proposal"]]
            got = decode_detections(*args, (h, w))
            want = decode_detections(*[
                out[k].float().cpu().numpy().reshape(a.shape)
                for k, a in zip(("cls_prob", "bbox_pred", "proposal"),
                                args)], (h, w))
            check(got.keys() == want.keys() and all(
                np.array_equal(got[c], want[c]) for c in got),
                f"{label} request {i}: decode_detections differs")
            kept.append(sum(len(d) for d in got.values()))
        m = srv.gauges()
        check(m["faults"] == 0 and srv.healthy(), f"{label}: {m}")
    finally:
        front.stop()
        srv.stop()
    say(label, f"Faster R-CNN b1 behind HttpFrontend: {len(imgs)} .npy "
        f"requests, each .npz answer ({', '.join(eng.graph.outputs)}) equal "
        f"to the direct run, decode_detections equal on both ({kept} "
        f"detections kept), 0 faults")


def detection_paths(smi, rng, rows, counts, speed):
    """The detection families (phases 2-4 each), w8a8 at their deploy
    sizes (``DETECTION``), with the head's share of the profiled device
    time by node.  Adds to ``rows``, ``counts`` and ``speed``."""
    import torch
    from feathercnn_tpu_torch.models import build_model
    from feathercnn_tpu_torch.quant import calibrate
    for label, (name, batch, _) in DETECTION.items():
        g = build_model(name, batch=batch, seed=SEED)
        # the RPN's Reshape holds the declared batch: the two-stage
        # models calibrate on 3 single images
        n_cal = batch if "im_info" in g.inputs else 8
        calibrate(g, [images(g, n_cal, rng) for _ in range(3)],
                  method="max")
        x = images(g, batch, rng)
        cfg, eng = make_engine(label, g)
        counts[label] = EXPECTED[label]
        r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
        rows += r
        if label == "faster_rcnn_vgg16 b1":
            two_stage_http(eng, x)
        if label == "rfcn_resnet101 b1":
            # stage 5's dilated convs at batch 1: few tiles, K split
            dil = [q for q in r if q["kernel"] == DILATED]
            check(len(dil) == 3 and all(q["variant"] == "wgmma"
                                        and q["split"] > 1 for q in dil),
                  f"{label}: dilated launches "
                  f"{[(q['variant'], q['split']) for q in dil]}, expected "
                  "3 on a split wgmma plan")
        if node_ms:
            total = sum(node_ms.values())
            heads = [(n.op, n.name, node_ms[n.name]) for n in eng.graph.nodes
                     if n.name in node_ms and n.op in HEAD_OPS + (
                         "Softmax", "PriorBox", "Normalize")]
            say("profile", f"{label}: the head's nodes of {total:.3f} ms of "
                "node ranges: " + ", ".join(
                    f"{nm} ({op}) {ms:.3f} ms {100 * ms / total:.1f}%"
                    for op, nm, ms in heads))
        del eng, x, g
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# parallel paths: parallel/ on torch.distributed
# ----------------------------------------------------------------------
# label -> (mesh shape, shard_spatial, ranks, backend).  The ranks that
# share the one card join over gloo: NCCL refuses two ranks on one device.
PARALLEL = {
    "resnet50 b128 world 1 nccl": ((1, 1), False, 1, "nccl"),
    "resnet50 b128 dp x tp (2, 2)": ((2, 2), False, 4, "gloo"),
    "resnet50 b128 spatial (1, 2)": ((1, 2), True, 2, "gloo"),
}
PARALLEL_NODES = "resnet50 b128 dp x tp (2, 2)"     # rank 0 node by node
PIPELINE = "resnet50 b128 pipeline 2 stages"
PARALLEL_TOP1 = 0.99
PARALLEL_COSINE = 0.9999
PARALLEL_TIMEOUT = 300      # seconds for a spawn; its ranks killed after


def sums_line(rows):
    """Per kernel, the timed ``launch_rows`` of one forward summed:
    launches, ms and bound ms."""
    sums = {}
    for r in rows:
        n, ms, b = sums.get(r["kernel"], (0, 0.0, 0.0))
        sums[r["kernel"]] = (n + r["launches"], ms + r["ms"],
                             b + r["bound_ms"])
    return "; ".join(f"{k} {n} launches {ms:.4f} ms (bound {b:.4f})"
                     for k, (n, ms, b) in sums.items())


def parallel_rank(rank, world, label, path, sharding, x, nodes):
    """One rank of a parallel path (started by ``parallel.launch.spawn``):
    ResNet-50 w8a8 loaded from ``path`` under ``sharding``, driven once at
    the global b128 with the counts set to 0 just before and read just
    after (33 + 16 launches, each rank running its batch slice, its
    output-channel slices or its rows), every launch held to its plain
    version (``launch_rows``; rank 0's timed too, alone on the card, after
    the others') and to its plan's variant; then 5 timed forwards; with
    ``nodes``, the node-by-node check (rank 0 compares).  Under NCCL one
    ``all_reduce`` checks the group first."""
    import torch
    import torch.distributed as dist
    from feathercnn_tpu_torch import Engine
    from feathercnn_tpu_torch.kernels import build
    from feathercnn_tpu_torch.model_format import load_ftpu
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()            # built by the parent: loaded here
    me = f"{label} rank {rank}"
    if dist.get_backend() == "nccl":
        t = torch.full((4,), rank + 1.0, device="cuda")
        dist.all_reduce(t)
        check(bool((t == world * (world + 1) / 2).all()),
              f"{me}: NCCL all_reduce gave {t.tolist()}")
    eng = Engine.from_path(path, engine_config(sharding=sharding))
    check(eng.device.type == "cuda", f"{me}: engine on {eng.device}")
    xs = to_card(x)
    recorder = LaunchRecorder()
    reset_counts()
    out = recorder.run(eng, xs)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == EXPECTED["resnet50 b128"],
          f"{me}: launches {counts}, expected {EXPECTED['resnet50 b128']}")
    check(tuple(out.shape) == (len(x), 1000)
          and bool(torch.isfinite(out.float()).all()),
          f"{me}: output {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out.float()).all())}")
    check_variants(me, recorder.launches)
    # the GEMM launches whose N is not a multiple of 8 (the TP FC's 500)
    odd_n = [(*dims(r["kernel"], r["args"]), r.get("variant"))
             for r in recorder.launches
             if r["kernel"] in GEMMS and r["args"]["w"].shape[-1] % 8]
    kept = grouped_weights(eng)
    if rank:
        rows = launch_rows(me, recorder.launches, kept, timed=False,
                           detail=False)
    dist.barrier()
    ms = forward_ms(lambda: eng(xs), runs=5, warmup=1)
    dist.barrier()      # rank 0 checks and times its launches alone
    if rank == 0:
        rows = launch_rows(me, recorder.launches, kept, detail=False)
    dist.barrier()
    del recorder
    if nodes:
        card_nodes(me, load_ftpu(path), engine_config(), eng, x,
                   compare=rank == 0)
    return {"out": out, "counts": {k: v for k, v in counts.items() if v},
            "calls": len(rows),
            "max_err": max(r["max_abs_err"] for r in rows), "ms": ms,
            "odd_n": odd_n, "sums": None if rank else sums_line(rows)}


def parallel_agreement(label, got, ref, exact=False):
    """A parallel path's global output against the unsharded engine's on
    the card: bit-equal (``exact``), else top-1 equal on >=
    ``PARALLEL_TOP1`` of the images and the prob cosine (all images as
    one vector) >= ``PARALLEL_COSINE``, the least image's printed."""
    if exact:
        check(np.array_equal(got, ref), f"{label}: output differs from the "
              f"unsharded engine's (max |diff| "
              f"{float(np.abs(got - ref).max())})")
        return "bit-equal to the unsharded engine's"
    top1 = float((got.argmax(-1) == ref.argmax(-1)).mean())
    g64, r64 = got.astype(np.float64), ref.astype(np.float64)
    cos = _cosine(g64.ravel(), r64.ravel())
    least = min(_cosine(a, b) for a, b in zip(g64, r64))
    check(top1 >= PARALLEL_TOP1 and cos >= PARALLEL_COSINE,
          f"{label}: top-1 equal on {top1:.4f} of the images, prob cosine "
          f"{cos:.6f}")
    return (f"top-1 equal on {100 * top1:.2f}% of {len(got)} images (>= "
            f"{100 * PARALLEL_TOP1:.0f}%), prob cosine {cos:.7f} (>= "
            f"{PARALLEL_COSINE}; least image {least:.7f}), max |prob diff| "
            f"{float(np.abs(g64 - r64).max()):.3e}")


def parallel_paths(g, x, smi, speed):
    """The main path sharded (``parallel/``): ResNet-50 w8a8 b128, written
    once by ``save_ftpu`` and loaded by every rank, in a process group of
    one over NCCL (mesh (1, 1): bit-equal to the unsharded engine), DP x
    TP (2, 2) on 4 ranks and spatial (1, 2) on 2 ranks that share the card
    over gloo (``PARALLEL``), then a 2-stage ``PipelineEngine`` on
    ["cuda:0", "cuda:0"] with 2 micro-batches in this process (twice the
    path's launches).  The ranks share one H100 in turns: their ms are
    not scaling figures."""
    import tempfile
    import torch
    from feathercnn_tpu_torch import Engine
    from feathercnn_tpu_torch.model_format import save_ftpu
    from feathercnn_tpu_torch.parallel import PipelineEngine, ShardingConfig
    from feathercnn_tpu_torch.parallel.launch import spawn
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.ftpu")
        save_ftpu(g, path)
        eng = Engine.from_path(path, engine_config())
        ref = eng(to_card(x)).float().cpu().numpy()
        del eng
        torch.cuda.empty_cache()
        for label, (shape, spatial, n, backend) in PARALLEL.items():
            t0 = time.perf_counter()
            ranks = spawn(parallel_rank, n, backend=backend, threads=2,
                          timeout=PARALLEL_TIMEOUT, args=(
                              label, path, ShardingConfig(
                                  mesh_shape=shape, shard_spatial=spatial),
                              x, label == PARALLEL_NODES))
            for r, got in enumerate(ranks):
                held = parallel_agreement(f"{label} rank {r}", got["out"],
                                          ref, exact=n == 1)
                say(label, f"rank {r} of {n} ({backend}): launches "
                    f"{got['counts']} (33 + 16 expected), {got['calls']} "
                    f"launches each equal to plain (max err "
                    f"{got['max_err']}), (M, K, N, variant) of those with "
                    f"N not a multiple of 8: {got['odd_n'] or 'none'}; "
                    f"{got['ms']:.2f} ms per batch; output {held}"
                    + (f"; its launches timed alone on the card: "
                       f"{got['sums']}" if got["sums"] else ""))
            speed[label] = max(got["ms"] for got in ranks)
            say(label, f"{n} ranks in {time.perf_counter() - t0:.1f} s")
        pipe = PipelineEngine(g, engine_config(), num_stages=2,
                              devices=["cuda:0", "cuda:0"])
        xs = to_card(x)
        recorder = LaunchRecorder()
        reset_counts()
        out = recorder.run(lambda v: pipe(v, micro_batches=2), xs)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: 2 * v for k, v in EXPECTED["resnet50 b128"].items()}
        check(counts == want, f"{PIPELINE}: launches {counts}, expected "
              f"{want}")
        check_variants(PIPELINE, recorder.launches)
        rows = launch_rows(PIPELINE, recorder.launches, detail=False)
        del recorder
        held = parallel_agreement(PIPELINE, out.float().cpu().numpy(), ref)
        ms = forward_ms(lambda: pipe(xs, micro_batches=2), runs=5,
                        warmup=1)
        speed[PIPELINE] = ms
        say(PIPELINE, f"stages of {[len(st.nodes) for st in pipe.stages]} "
            f"nodes, 2 micro-batches: launches "
            f"{ {k: v for k, v in counts.items() if v} } (2 x (33 + 16)), "
            f"{len(rows)} launches each equal to plain (max err "
            f"{max(r['max_abs_err'] for r in rows)}); {ms:.2f} ms per batch; "
            f"output {held}; its launches timed: {sums_line(rows)}")
        del pipe, out, xs
        torch.cuda.empty_cache()
    say("parallel", f"done in {time.perf_counter() - t_start:.1f} s on "
        f"{smi}; the ranks of a path time-share this one card (their ms "
        f"per batch are not scaling figures) and gloo stages every "
        f"collective through host memory")


# ----------------------------------------------------------------------
# tools path: from a Caffe deploy to an autotuned .ftpu, the timing,
# profiling and cache utilities, and the int8 conv forms that were refused
# ----------------------------------------------------------------------
TOOLS_DEPLOY = os.path.join("tools", "deploys", "resnet50_deploy.prototxt")
TOOLS_IMAGES = 256
TOOLS_VALIDATE = "tools validate int8 leg"
TOOLS_RELOAD = "tools autotuned .ftpu"
CONV_FORMS = "conv forms"
# the new int8 conv forms at full width: (case, x (N, H, W, C), Co, kernel,
# (sh, sw), group, pad, act_segments)
CONV_FORM_CASES = (
    ("3x3 stride (1, 2)", (128, 56, 56, 64), 64, 3, (1, 2), 1, 1, None),
    ("3x3 stride (2, 1)", (128, 56, 56, 64), 64, 3, (2, 1), 1, 1, None),
    ("1x1 stride (2, 1)", (128, 56, 56, 256), 128, 1, (2, 1), 1, 0, None),
    ("3x3 group 32, multiplier 2", (128, 112, 112, 32), 64, 3, (1, 1), 32,
     1, None),
    ("3x3 depthwise stride 3", (128, 112, 112, 64), 64, 3, (3, 3), 64, 1,
     None),
    ("3x3 depthwise act_segments", (256, 112, 112, 32), 32, 3, (1, 1), 32,
     1, (("relu", 16), (None, 16))),
)
TOOLS_CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from feathercnn_tpu_torch import Engine, EngineConfig
from feathercnn_tpu_torch.kernels import build
from feathercnn_tpu_torch.models.builder import GraphBuilder
b = GraphBuilder("cache", seed=0)
x = b.input("data", (1, 8, 8, 16))
g = b.finish([b.conv("c", x, 16, 3, pad=1)])
eng = Engine(g, EngineConfig(backend="cuda", compilation_cache_dir={d!r}))
lib = build.library_dir() / build._LIB_NAME
found = lib.exists()
t0 = time.perf_counter()
build.load_library()
secs = time.perf_counter() - t0
print(json.dumps({{"dir": str(lib.parent), "found": found, "seconds": secs,
                   "mtime": lib.stat().st_mtime_ns,
                   "device": str(eng.device)}}))
"""


def tools_convert(tmp):
    """The deploy's seeded synthetic caffemodel and its ``.ftpu`` at
    BATCH, by the port's ``synth_caffemodel`` and converter CLI; returns
    (deploy, caffemodel, ftpu)."""
    from feathercnn_tpu_torch.tools import convert_caffe
    from feathercnn_tpu_torch.tools.synth_caffemodel import write_synth
    root = os.path.dirname(os.path.abspath(__file__))
    deploy = os.path.join(root, TOOLS_DEPLOY)
    model = os.path.join(tmp, "resnet50.caffemodel")
    path = os.path.join(tmp, "resnet50.ftpu")
    t0 = time.perf_counter()
    size = write_synth(deploy, model, seed=SEED)
    t1 = time.perf_counter()
    check(convert_caffe.main([deploy, model, path, "--batch", str(BATCH)])
          == 0, "convert_caffe failed")
    t2 = time.perf_counter()
    say("tools", f"convert: {TOOLS_DEPLOY} with its seeded synthetic "
        f"caffemodel ({size / 1e6:.1f} MB, written in {t1 - t0:.1f} s) -> "
        f"{os.path.getsize(path) / 1e6:.1f} MB .ftpu at b{BATCH} in "
        f"{t2 - t1:.1f} s")
    return deploy, model, path


def tools_validate(deploy, model, tmp, rng):
    """``validate`` at BATCH on TOOLS_IMAGES seeded ``.npy`` images, its
    fp leg in bf16 and its int8 leg w8a8, labels the fp leg's answers (so
    the int8 leg's drop is its disagreement with fp); every launch of
    both legs recorded and held to its plain version (``launch_rows``),
    the int8 forwards' counts beside the main path's."""
    import torch
    from feathercnn_tpu_torch.tools.validate_real import validate
    paths = []
    for i in range(TOOLS_IMAGES):
        paths.append(os.path.join(tmp, f"img{i:03d}.npy"))
        np.save(paths[-1], rng.normal(0, 50, size=(224, 224, 3)).astype(
            np.float32))
    kw = dict(batch=BATCH, calib_n=BATCH, dtype="bfloat16")
    fp = validate(deploy, model, paths, quant=None, **kw)["fp_top1_pred"]
    labels = {os.path.basename(p): int(v) for p, v in zip(paths, fp)}
    recorder = LaunchRecorder()
    reset_counts()
    t0 = time.perf_counter()
    res = recorder.run(lambda: validate(deploy, model, paths, labels=labels,
                                        **kw))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    forwards = TOOLS_IMAGES // BATCH
    # the converted deploy keeps res5's residual adds on int8 edges too
    want = {"matmul_epilogue": forwards * 34,
            "conv2d_implicit_gemm": forwards * 16,
            "eltwise_int8": forwards * 16, "stem_conv_int8": forwards}
    check(counts == want, f"validate: launches {counts}, expected {want} "
          f"({forwards} bf16 forwards' FC and {forwards} w8a8 forwards' "
          f"33 + 16, 16 residual adds and the stem)")
    check(res["fp_top1_pred"] == fp and len(res["int8_top1_pred"]) ==
          TOOLS_IMAGES and all(0 <= v < 1000 for v in res["int8_top1_pred"])
          and {"fp_top1", "int8_top1", "top1_drop", "gate",
               "gate_pass"} <= set(res), f"validate fields {sorted(res)}")
    rows = launch_rows(TOOLS_VALIDATE, recorder.launches, timed=False,
                       detail=False)
    del recorder
    say("tools", f"validate: {TOOLS_IMAGES} images at b{BATCH} in "
        f"{secs:.1f} s (convert, bf16 fp leg, calibration on {BATCH}, w8a8 "
        f"leg); launches {counts}: per w8a8 forward 33 + 16 as the zoo "
        f"main path's 33 B1 and 16 B2, and the bf16 leg's FC; all "
        f"{len(rows)} launches equal to plain (max err "
        f"{max(r['max_abs_err'] for r in rows)}); fields "
        + json.dumps({k: v for k, v in res.items()
                      if not k.endswith("_pred")})
        + " (random weights: the gate is informational)")


def tools_autotune(path, smi, rng):
    """``tune`` in bf16 (``xla`` is cuDNN's conv, beside B2's float body
    and Winograd) and ``tune_regions`` in w8a8 on the converted model,
    calibrated, both baked into ``path``; the file reloaded by
    ``Engine.from_path`` with ``fuse_chains`` takes both (launches counted
    and held to plain, output bit-equal to an engine built with the same
    choices); then ``tune_flags`` with one round.  Returns the calibrated
    graph."""
    import torch
    from feathercnn_tpu_torch import Engine
    from feathercnn_tpu_torch.model_format import load_ftpu, save_ftpu
    from feathercnn_tpu_torch.quant import calibrate
    from feathercnn_tpu_torch.tools import autotune
    g = load_ftpu(path, mmap_weights=False)
    calibrate(g, [images(g, 8, rng) for _ in range(3)], method="max")
    t0 = time.perf_counter()
    eng = Engine(g, engine_config(quant=None))
    overrides, rows = autotune.tune(eng.graph, "bfloat16", None, iters=10)
    del eng
    t1 = time.perf_counter()
    seen = set()
    for r in rows:
        if "measured_ms" not in r or r["layer"] in seen:
            continue
        sig = (tuple(r["in"]), tuple(r["kernel"]), tuple(r["out"]))
        same = [q["layer"] for q in rows if "measured_ms" in q and (
            tuple(q["in"]), tuple(q["kernel"]), tuple(q["out"])) == sig]
        seen.update(same)
        say("autotune", f"{r['layer']} (x{len(same)}) in {r['in']} k"
            f"{r['kernel']} out {r['out']}: "
            + ", ".join(f"{a} {ms:.4f} ms ({r['kernels'][a]})"
                        for a, ms in r["measured_ms"].items())
            + f" -> {r['best_algo']}; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    say("autotune", f"tune bf16 b{BATCH}: {len(overrides)} non-xla choices "
        f"{overrides} in {t1 - t0:.1f} s ({smi})")
    regions = autotune.tune_regions(g, "bfloat16", "w8a8", iters=10)
    t2 = time.perf_counter()
    say("autotune", f"tune_regions w8a8 b{BATCH}: {regions} in "
        f"{t2 - t1:.1f} s")
    g.meta["algo_overrides"] = overrides
    g.meta["chain_regions"] = regions
    save_ftpu(g, path)
    cfg = engine_config(fuse_chains=True)
    loaded = Engine.from_path(path, cfg)
    check(dict(loaded.config.algo_overrides) == overrides,
          f"baked algo_overrides not taken: {loaded.config.algo_overrides}")
    chains = [n for n in loaded.graph.nodes
              if n.op in ("FusedChain", "FusedBottleneck")]
    check(len({f"{loaded.graph.specs[n.inputs[0]].shape[1]}x"
               f"{loaded.graph.specs[n.inputs[0]].shape[2]}x"
               f"{loaded.graph.specs[n.inputs[0]].shape[3]}"
               for n in chains}) == sum(regions.values()),
          f"baked chain_regions {regions} not taken: {len(chains)} chains")
    x = images(g, BATCH, rng)
    recorder = LaunchRecorder()
    reset_counts()
    out = recorder.run(loaded, to_card(x))
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    want = sum(n.attrs.get("nb", 1) for n in chains)
    check(counts.get("fused_chain", 0) == want,
          f"{TOOLS_RELOAD}: {counts} launches, {want} chain blocks")
    rows = launch_rows(TOOLS_RELOAD, recorder.launches, timed=False,
                       detail=False)
    del recorder
    direct = Engine(g, cfg.replace(algo_overrides=tuple(overrides.items())))
    check(torch.equal(out, direct(to_card(x))),
          f"{TOOLS_RELOAD}: output differs from the directly built engine")
    del direct, loaded
    say("autotune", f"{TOOLS_RELOAD} (Engine.from_path, fuse_chains): "
        f"{len(overrides)} algo_overrides and {len(chains)} chain nodes "
        f"(nb {[n.attrs.get('nb', 1) for n in chains]}) taken; launches "
        f"{counts}, all {len(rows)} equal to plain (max err "
        f"{max(r['max_abs_err'] for r in rows)}); output bit-equal to the "
        f"engine built with the same choices")
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    flags = autotune.tune_flags(g, "bfloat16", "w8a8", rounds=1, iters=2)
    say("autotune", f"tune_flags w8a8 b{BATCH}, 1 round of 2 iterations: "
        f"{flags} in {time.perf_counter() - t3:.1f} s")
    torch.cuda.empty_cache()
    return g


def tools_measure(g, x, path, smi, speed):
    """On the main path's engine: ``engine_loop`` + ``slope_time`` beside
    the phase's own ``forward_ms``, ``layer_timings`` summed beside it,
    ``trace`` writing its file, and ``run_model`` on the autotuned file;
    then ``verify_gpu`` (ResNet-50 w8a8 b4, MobileNet-SSD) and
    ``diff_blobs`` (quant none against w8a8)."""
    import tempfile
    import torch
    from feathercnn_tpu_torch import Engine
    from feathercnn_tpu_torch.models import resnet50
    from feathercnn_tpu_torch.tools import diff_blobs, run_model, verify_gpu
    from feathercnn_tpu_torch.utils.profiling import layer_timings, trace
    from feathercnn_tpu_torch.utils.timing import engine_loop, slope_time
    eng = Engine(g, engine_config())
    xd = to_card(x)
    ms = forward_ms(lambda: eng(xd))
    loop, params, xl = engine_loop(eng, x)
    float(loop(params, xl, 1))
    slopes = [slope_time(loop, params, xl, warm=2, iters=10) * 1e3
              for _ in range(3)]
    lt = layer_timings(eng, x, iters=5)
    top = sorted(lt.items(), key=lambda kv: -kv[1])[:3]
    say("tools", f"resnet50 b{BATCH} w8a8: engine_loop + slope_time "
        f"{statistics.median(slopes):.2f} ms per batch (3 slopes "
        f"{', '.join(f'{v:.2f}' for v in slopes)}), forward_ms {ms:.2f}; "
        f"layer_timings over {len(lt)} nodes sums to "
        f"{sum(lt.values()):.2f} ms (top: "
        + ", ".join(f"{k} {v:.3f}" for k, v in top) + f"; {smi})")
    speed["resnet50 b128 engine_loop"] = statistics.median(slopes)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(os.path.join(tmp, "trace")) as logdir:
            eng(xd)
            torch.cuda.synchronize()
        files = [(f, os.path.getsize(os.path.join(logdir, f)))
                 for f in os.listdir(logdir)]
    check(len(files) == 1 and files[0][0].endswith(".pt.trace.json")
          and files[0][1] > 0, f"trace wrote {files}")
    say("tools", f"trace: {files[0][0]} ({files[0][1] / 1e6:.1f} MB)")
    del eng, xd, loop, params, xl
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check(run_model.main([path, "--batch", str(BATCH), "--dtype",
                          "bfloat16", "--quant", "w8a8", "--loops", "5"])
          == 0, "run_model failed")
    say("tools", f"run_model on the autotuned .ftpu in "
        f"{time.perf_counter() - t0:.1f} s")
    for model, batch in (("resnet50", 4), ("mobilenet_ssd", 4)):
        lines = []
        ok = verify_gpu.verify(model, batch, "w8a8", "bfloat16",
                               log=lines.append)
        say("verify_gpu", " | ".join(lines))
        check(ok, f"verify_gpu {model}: {lines[-1]}")
    rows, out_name = diff_blobs.diff(
        lambda: resnet50(batch=2, with_softmax=False, seed=SEED),
        {"quant": None, "compute_dtype": "bfloat16"},
        {"quant": "w8a8", "compute_dtype": "bfloat16"}, 2, SEED)
    first = next((r for r in rows if r[1] < 0.999), None)
    final = next(c for v, c, _ in rows if v == out_name)
    say("diff_blobs", f"resnet50 b2 bf16 quant none vs w8a8: {len(rows)} "
        f"values; first under 0.999: "
        + (f"{first[0]} (cos {first[1]:.6f}, max|d| {first[2]:.4g})"
           if first else "none")
        + f"; final {out_name!r} cos {final:.6f}")
    torch.cuda.empty_cache()


def tools_cache():
    """Two child processes with ``compilation_cache_dir`` naming one fresh
    directory: the first builds the kernels there, the second finds them
    and builds nothing."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        got = []
        for _ in range(2):
            r = subprocess.run(
                [sys.executable, "-c", TOOLS_CHILD.format(root=root, d=d)],
                capture_output=True, text=True, timeout=600, cwd=root)
            check(r.returncode == 0, f"cache child failed: {r.stderr[-2000:]}")
            got.append(json.loads(r.stdout.strip().splitlines()[-1]))
        first, second = got
        check(first["dir"].startswith(os.path.realpath(d))
              and first["dir"] == second["dir"],
              f"cache dirs {first['dir']}, {second['dir']} not under {d}")
        check(not first["found"] and second["found"]
              and second["mtime"] == first["mtime"],
              f"cache: first {first}, second {second}")
    say("tools", f"cache: compilation_cache_dir built the kernels in a fresh "
        f"directory in {first['seconds']:.1f} s (first child, on "
        f"{first['device']}); the second child found them and loaded them "
        f"in {second['seconds']:.2f} s, rebuilding nothing")


def conv_forms(smi, rows, counts):
    """The int8 conv forms that the port used to refuse, at full width,
    through ``kernels/dispatch.conv_forward`` (``CONV_FORM_CASES``): each
    launch counted, held to its plain version (int8 out, 0 LSB), timed
    beside its bound and bf16 ``F.conv2d(stride=(sh, sw), groups=g)``."""
    import torch
    from feathercnn_tpu_torch.ir import Graph, Node, TensorSpec
    from feathercnn_tpu_torch.kernels import dispatch
    from feathercnn_tpu_torch.ops.lowering import LoweringCtx
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recorder = LaunchRecorder()
    reset_counts()
    kept, cases = {}, []
    for case, shape, co, k, (sh, sw), group, pad, segs in CONV_FORM_CASES:
        n, h, w, c = shape
        attrs = {"num_output": co, "kernel_size": k, "stride_h": sh,
                 "stride_w": sw, "pad": pad, "group": group,
                 "bias_term": True}
        if segs:
            attrs["act_segments"] = segs
        else:
            attrs["activation"] = "relu"
        node = Node(case, "Convolution", ["x"], ["y"], attrs)
        graph = Graph(name=case, inputs={"x": TensorSpec(shape, "int8")},
                      outputs=["y"], nodes=[node], params={}, meta={})
        q = {"x_scale": 0.05, "w_scale": np.full(co, 0.002, np.float32),
             "y_scale": 0.5, "emit_int8": True}
        ctx = LoweringCtx(graph, engine_config(), torch.device("cuda"))
        ctx.qinfo = lambda _, q=q: q
        x = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda",
                          generator=gen)
        wt = torch.randint(-127, 128, (k, k, c // group, co),
                           dtype=torch.int8, device="cuda", generator=gen)
        bias = torch.randn(co, device="cuda", generator=gen)
        y = recorder.run(dispatch.conv_forward, node, x, wt, bias, ctx)
        check(y.dtype == torch.int8, f"{case}: output {y.dtype}")
        for (_, key), t in ctx._consts.items():
            if key.startswith("gemm_w/") and "/g" in key:
                g_, q_ = key.rsplit("/g", 1)[1].split("q")
                kept[t.data_ptr()] = (int(g_), int(q_))
        cases.append((case, shape, co, k, (sh, sw), group, pad))
    torch.cuda.synchronize()
    got = read_counts()
    check(got == EXPECTED[CONV_FORMS],
          f"{CONV_FORMS}: launches {got}, expected {EXPECTED[CONV_FORMS]}")
    counts[CONV_FORMS] = got
    say(CONV_FORMS, f"{len(cases)} convs through the dispatcher: launches "
        f"{ {k: v for k, v in got.items() if v} }")
    check_variants(CONV_FORMS, recorder.launches)
    mine = kernels_vs_plain(CONV_FORMS, recorder.launches, kept)
    grouped_lines(CONV_FORMS, mine)
    for (case, shape, co, k, st, group, pad), r in zip(cases, mine):
        bf16 = _time_grouped_conv(shape, k, k, co, st, pad, pad, group,
                                  torch.bfloat16)
        say(CONV_FORMS, f"{case} x{shape} -> {co}: {r['kernel']} "
            f"{r['variant']}, {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
            f"bf16 F.conv2d(stride={st}, groups={group}) {bf16:.4f} ms "
            f"({r['ms'] / bf16:.2f}x), equal to plain (max err "
            f"{r['max_abs_err']}; {smi})")
    rows += mine


def tools_path(g, x, smi, rows, counts, speed):
    """The phase ``tools_path``: a Caffe deploy to an autotuned ``.ftpu``
    on the card (``tools_convert``, ``tools_validate``,
    ``tools_autotune``), the timing, profiling and comparison tools on
    the main path's engine (``tools_measure``), the build cache
    (``tools_cache``) and the int8 conv forms (``conv_forms``)."""
    import tempfile
    import torch
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    with tempfile.TemporaryDirectory() as tmp:
        deploy, model, path = tools_convert(tmp)
        tools_validate(deploy, model, tmp, rng)
        torch.cuda.empty_cache()
        tools_autotune(path, smi, rng)
        tools_measure(g, x, path, smi, speed)
    tools_cache()
    conv_forms(smi, rows, counts)
    torch.cuda.empty_cache()
    say("tools", f"done in {time.perf_counter() - t_start:.1f} s on {smi}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import feathercnn_tpu_torch  # noqa: F401  (fails without the repo)
    from feathercnn_tpu_torch.models import (mobilenet_v1, mobilenet_v2,
                                             resnet50)

    t_start = time.perf_counter()
    smi = toolchain()
    rng = np.random.default_rng(SEED)
    rows, counts, speed = [], {}, {}

    # ResNet-50 b128, then its server
    label = "resnet50 b128"
    g = calibrated(resnet50, BATCH, rng)
    cfg, eng = make_engine(label, g)
    x = rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32)
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    card_nodes(label, g, cfg, eng, x)
    fma_check(eng, x)
    ragged_cases()
    serve(eng, x)
    unchained = eng.graph
    built = eng(torch.from_numpy(x).cuda())
    del eng
    torch.cuda.empty_cache()
    # the same model through a .ftpu file, then served by the CLI
    loaded_path(g, x, built, smi, rows, counts, speed)
    del built
    # the same model with the space-to-depth stem
    s2d_path(g, x, node_ms, smi, rows, counts, speed)
    # the same model sharded: DP x TP, spatial, world 1, the pipeline
    parallel_paths(g, x, smi, speed)
    # the tools: a Caffe deploy to an autotuned .ftpu, the utilities, the
    # build cache and the int8 conv forms
    tools_path(g, x, smi, rows, counts, speed)

    # ResNet-50 b128 with fuse_chains: the same calibrated graph with the
    # wildcard region table that bench.py --fuse-chains sets
    label = "resnet50 b128 fuse_chains"
    g.meta["chain_regions"] = {"*": True}
    cfg, eng = make_engine(label, g, fuse_chains=True)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _chain_launch_check(label))
    rows += r
    chains_beside_unchained(r, eng.graph, unchained, node_ms)
    del eng
    torch.cuda.empty_cache()

    # ResNet-50 b128 in bf16 (no quantization): unchained, the yardstick of
    # the float chains, then with fuse_chains and the wildcard region table
    g = resnet50(batch=BATCH, seed=SEED)
    label = "resnet50 b128 bf16"
    cfg, eng = make_engine(label, g, quant=None)
    counts[label] = EXPECTED[label]
    r, speed[label], node_ms = run_path(label, g, cfg, eng, x, smi)
    rows += r
    unchained = eng.graph
    del eng
    torch.cuda.empty_cache()
    label = "resnet50 b128 bf16 fuse_chains"
    g.meta["chain_regions"] = {"*": True}
    cfg, eng = make_engine(label, g, quant=None, fuse_chains=True)
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _float_chain_launch_check(label))
    rows += r
    chains_beside_unchained(r, eng.graph, unchained, node_ms)
    del eng, x, unchained
    torch.cuda.empty_cache()

    # MobileNet-v1 b256 on its default route and with the dw override
    g = calibrated(mobilenet_v1, 256, rng)
    x = rng.normal(size=(256, 224, 224, 3)).astype(np.float32)
    for label, config, want in [
            ("mobilenet_v1 b256", {}, None),
            ("mobilenet_v1 b256 dw override",
             {"algo_overrides": dw_override(g)},
             (torch.int8, "relu", torch.bfloat16))]:
        cfg, eng = make_engine(label, g, **config)
        counts[label] = EXPECTED[label]
        r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                      _dw_launch_check(label, want))
        rows += r
        del eng
        torch.cuda.empty_cache()
    del x

    # MobileNet-v2 b128 with the dw override
    label = "mobilenet_v2 b128 dw override"
    g = calibrated(mobilenet_v2, 128, rng)
    x = rng.normal(size=(128, 224, 224, 3)).astype(np.float32)
    cfg, eng = make_engine(label, g, algo_overrides=dw_override(g))
    counts[label] = EXPECTED[label]
    r, speed[label], _ = run_path(label, g, cfg, eng, x, smi,
                                  _dw_launch_check(label, (
                                      torch.bfloat16, "relu6",
                                      torch.bfloat16)))
    rows += r
    del eng, x
    torch.cuda.empty_cache()

    label = "boundary b128"
    counts[label] = EXPECTED[label]
    rows += boundary(label, smi)

    classic_paths(smi, rng, rows, counts, speed)
    zoo_rest_paths(smi, rng, rows, counts, speed)
    segmentation_paths(smi, rng, rows, counts, speed)
    detection_paths(smi, rng, rows, counts, speed)

    say("done", f"every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s (from the start of the "
        f"build); ms per batch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in speed.items()))
    summary = [kernel_summary(name, rows, counts) for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _chain_launch_check(label):
    """A check of the fuse_chains path's chain calls: int8 x (the lowering
    quantizes the bf16 edge into stage 5 with a divide, as the reference
    does), nb 2, 3, 5, 2 in order, int8 out but on the last chain (bf16 for
    the global AVE pool)."""
    import torch
    seen = []

    def check_launch(launch):
        if launch["kernel"] != "fused_chain":
            return
        a = launch["args"]
        check(a["x"].dtype == torch.int8,
              f"{label}: chain input {a['x'].dtype}, expected int8")
        seen.append((a["w1"].shape[0], a["scales"][3] is not None))
        if len(seen) == 4:
            check(seen == [(2, True), (3, True), (5, True), (2, False)],
                  f"{label}: chain calls (nb, int8 out) {seen}")
            say(label, f"4 chain calls, (nb, int8 out) {seen}, every x int8")
    return check_launch


def _float_chain_launch_check(label):
    """A check of the bf16 fuse_chains path's chain calls: bf16 x and
    output, nb 2, 3, 5 (the chains) then 1, 1 (stage 5's single blocks)."""
    import torch
    seen = []

    def check_launch(launch):
        if launch["kernel"] != "fused_chain_float":
            return
        a = launch["args"]
        out = a["out_dtype"] or a["x"].dtype
        check(a["x"].dtype == torch.bfloat16 and out == torch.bfloat16,
              f"{label}: chain call with x {a['x'].dtype}, out {out}; "
              f"expected bfloat16 both")
        seen.append(a["w1"].shape[0])
        if len(seen) == 5:
            check(seen == [2, 3, 5, 1, 1], f"{label}: chain calls nb {seen}")
            say(label, f"5 chain calls, nb {seen}, x and output bf16")
    return check_launch


def _dw_launch_check(label, want):
    """A check of each float depthwise launch of an override path: its x
    type, activation and output type."""
    if want is None:
        return None
    x_dtype, act, out_dtype = want

    def check_launch(launch):
        if launch["kernel"] != "depthwise_conv2d":
            return
        a = launch["args"]
        got = (a["x"].dtype, a["activation"],
               a["out_dtype"] or a["x"].dtype)
        check(got == want, f"{label}: depthwise launch with x "
              f"{got[0]}, {got[1]}, out {got[2]}; expected {x_dtype}, "
              f"{act}, {out_dtype}")
    return check_launch


if __name__ == "__main__":
    try:
        rc = main()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
