// matmul_epilogue: y = epilogue((M, K) x (K, N)) for the 1x1 convs and the
// fully connected layers.
//
// Replaces the Pallas kernel feathercnn_tpu/kernels/matmul.py:96
// (matmul_epilogue; body _matmul_kernel at :49-89).  Same function: a GEMM
// whose epilogue applies, in order, x w_scale[n], x x_scale (skipped at
// 1.0), + bias[n], ReLU/ReLU6 or a per-channel lo/hi clamp, and an optional
// int8 requantization (round half to even, saturate to +-127).  The
// lo/hi clamp is the port's addition: it carries the merged sibling convs
// (act_segments) that the reference leaves to XLA.
//
// What bounds it on an H100 SXM: at the main path's shapes (int8 x int8,
// M = N*H*W up to 3,211,264, K 16..2048, N 16..2560) the bytes are
// M*K + K*N + M*N*out_size against 3.35 TB/s and the work 2*M*N*K int8
// operations against 1,979 TOP/s.  At K <= 256 (stages 2-4 of ResNet-50,
// every MobileNet 1x1 conv) the bytes bound it, most of them the output's;
// only the widest merged convs and stage 5 tip toward the tensor cores.
//
// What the design does about it (gemm_common.cuh has the details): the
// weight is kept (N, K) with K contiguous (gemm_layout, made once per
// node), as wgmma's K-major B wants it.  A persistent block per SM walks
// 128 x BN tiles (BN 32 to 256, weighing padded columns against the
// traffic of the main loop); A and B
// arrive by TMA into a ring of 64- or 128-byte-swizzled stages (B once
// per block where its weight panel fits shared memory), with
// out-of-bounds zero fill taking the ragged M and K edges; two consumer
// warpgroups run wgmma m64nBNk32 with int32 accumulation over the whole K;
// the epilogue stages the tile through shared memory and writes 16-byte
// row pieces, while the producer already loads the next tile.  A K of 16
// to 64 takes a 64-byte step (the bytes past K arrive as zeros).
// A row pitch that is not a multiple of 16 bytes (K = 24: MobileNet-v2) or
// a misaligned pointer takes the mma.sync variant; bf16 x bf16 (the bf16
// FC) the mma.sync m16n8k16 variant, 8 warps over slices of K; f32 x a
// SIMT loop.  The host's plan (gemm_plan in kernels/matmul.py) picks the
// variant, tile, K step and stages.
//
// Weight-only int8 (bf16 x, int8 w: VGG-16 w8's fc6-8, M = 128, K 25088
// and 4096, N 4096 and 1000) is bound by bytes: the int8 weight, 123.6 MB
// over the three, read once, against 3.35 TB/s; the products are ~1% of
// the bf16 peak's time.  Variant "wgmma_w8" streams the weight as int8
// (half the bytes of a bf16 weight; no bf16 copy exists) by cp.async into
// a staging slot of the ring, the consumers convert each tile to bf16 in
// shared memory while the last step's bf16 wgmma runs, and A (bf16) comes
// by TMA.  At M = 128 the 128 x 128 tiles are 8 to 32, so the plan splits
// K until the SMs are full (4 slices for fc6 and fc7, 16 for fc8): each
// slice's f32 sums go to a workspace and a second pass adds the slices
// in index order (no atomics: the same result every run) and applies the
// epilogue.  A K that is not a multiple of 8 or a misaligned pointer takes
// the SIMT loop.
//
// The reference converts the int32 product of each K block to f32 and sums
// the blocks in f32 (matmul.py:63-64); this kernel keeps the whole K in
// int32.  The two agree exactly while |acc| < 2^24.
#include "gemm_common.cuh"

extern "C" int fcnn_matmul_epilogue(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int M, int K,
    int N, int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, int split, int th, int tw, void* ws,
    void* stream) {
  fcnn::MatrixA a;
  a.x = static_cast<const char*>(x);
  a.M = M;
  a.K = K;
  const fcnn::Epilogue e = fcnn::make_epilogue(
      out, bias, w_scale, lo, hi, act, x_scale, out_scale, out_type);
  return fcnn::launch_gemm(
      a, w, N, x_type, w_type, K % 16 == 0 && K >= 16,
      fcnn::make_plan(variant, bn, bk, stages, bres, grid, smem, split, th,
                      tw),
      static_cast<float*>(ws), e,
      static_cast<cudaStream_t>(stream));
}
