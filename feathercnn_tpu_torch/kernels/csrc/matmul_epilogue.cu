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
// A row pitch that is not a multiple of 16 bytes (K = 24, 58, 116, 232:
// MobileNet-v2's and the ShuffleNets' 1x1 convs) or an x that is not
// 16-byte aligned takes "wgmma_ragged", up to K = 256: the same ring,
// consumers and epilogue, the weight's rows padded to a 16-byte pitch
// once per node (gemm_layout) so that B still comes by TMA, and A staged:
// a 128-row tile of a contiguous (M, K) matrix is one run of 128 * K bytes,
// which a bulk copy brings (its 16-byte-aligned middle; the producer's
// threads copy the ends) into a staging ring a few tiles ahead, and the
// producer's threads re-lay it, one row each, into the swizzled K-major
// stage with zeros past K.  These launches are bound by bytes, most of
// them the output's; the staged A moves only the useful bytes, and the
// epilogue stores each 16-byte output piece in the widest stores the
// output row's alignment allows (N = 116 int8: 4 bytes).  The mma.sync
// variant ("mma_sync", the first body) is left for a ragged K past 256;
// f32 x takes a SIMT loop.  The host's plan (gemm_plan in
// kernels/matmul.py) picks the variant, tile, K step, stages and K slices.
//
// A launch whose 128 x BN tiles fill at most a third of the SMs and whose
// blocks' K loops are long (gemm_plan's rule: FCN's and Faster R-CNN's
// score convs at N = 21 and 84, K = 4096) splits K over the grid: each
// block runs one slice of one tile and writes its int32 sums from the
// registers to a (split, M, N) workspace the wrapper allocates; a second
// pass (splitk_reduce_kernel<int>, launched as the main loop's
// programmatic dependent, so its blocks are in place when the main loop
// ends) adds the slices, exactly, and applies the same epilogue
// (epilogue_value and requant_i8, which column_pair's folded clamp equals
// bit for bit).  No resident panel then.  The FCs at M = 128 and K <= 2048
// (ResNet-50's, 32 tiles) keep one slice: their 16-step loops do not pay
// for the second pass.
//
// bf16 x bf16 (the bf16 paths' FC, (128, 2048, 1000)) takes "wgmma_bf16":
// the "wgmma_w8" kernel below with the bf16 weight tile brought by TMA
// beside A (a BN x 64 box, 128-byte swizzle; no staging slot, no
// conversion), f32 sums, K split as "wgmma_w8" splits it and the f32
// slices added in index order by the second pass.  It is bound by bytes
// (the 4 MB weight, read once: 0.0015 ms); at 8 tiles unsplit it kept 124
// SMs idle.  It replaced the first body, mma.sync m16n8k16 with fragments
// loaded from global memory (125 blocks of 128 x 8, each reading all of
// A), which is gone.
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
    int grid, int smem, int split, int th, int tw, int ldw, int sst,
    void* ws, void* stream) {
  fcnn::MatrixA a;
  a.x = static_cast<const char*>(x);
  a.M = M;
  a.K = K;
  const fcnn::Epilogue e = fcnn::make_epilogue(
      out, bias, w_scale, lo, hi, act, x_scale, out_scale, out_type);
  return fcnn::launch_gemm(
      a, w, N, x_type, w_type,
      fcnn::make_plan(variant, bn, bk, stages, bres, grid, smem, split, th,
                      tw, ldw, sst),
      ws, e,
      static_cast<cudaStream_t>(stream));
}
