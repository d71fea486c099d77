// conv_implicit_gemm: NHWC convolution as an implicit GEMM, with the same
// epilogue as matmul_epilogue.
//
// Replaces the Pallas kernel feathercnn_tpu/kernels/conv.py:100
// (conv2d_implicit_gemm; body _conv_kernel at :47-93).  Same function:
// y[n, oh, ow, co] = epilogue(sum over kh, kw, c of
// x[n, oh*s - ph + kh, ow*s - pw + kw, c] * w[kh, kw, c, co]), with zero
// padding.  As a GEMM: M = N*OH*OW output pixels, N = Co, K = KH*KW*C.
//
// What bounds it on an H100 SXM: the main path's convs are the 3x3 stride-1
// int8 convs at 56^2*64, 28^2*128, 14^2*256 and 7^2*512 (batch 128).  They
// do 2*M*Co*9*C int8 operations against 1,979 TOP/s and move
// N*H*W*C + 9*C*Co + M*Co bytes against 3.35 TB/s: about 9*C operations
// per byte at C == Co, so the 64-channel stage sits near the card's balance
// point (~590 operations per byte) and the 128..512-channel stages are
// bound by the tensor cores.
//
// What the design does about it (gemm_common.cuh has the details): no
// im2col is written to memory.  The weight is kept (Co, KH*KW*C) with K
// contiguous in (kh, kw, c) order (gemm_layout, made once per node) and
// arrives by TMA, once per block where its panel fits shared memory.  A persistent block per SM walks 128 x BN output tiles;
// its producer warpgroup gathers the tile's A rows straight from the
// unpadded input with 16-byte cp.async into the swizzled stage (each of
// its threads resolves 128 pixels once per tile and advances its tap by
// counters, so the K loop has no division; a bounds check stands in for
// the zero padding), ahead of two consumer warpgroups running wgmma
// m64nBNk32 with int32 accumulation over the whole K.  The epilogue is
// staged through shared memory and leaves as 16-byte row pieces.  C not a
// multiple of 16 (or C < 16) or a misaligned pointer takes the mma.sync
// variant; float x the SIMT loop.  The Pallas kernel's staging (row slabs,
// batch chunks, stride-2 parity planes, shifted products, lax.map over
// chunks) exists for the TPU's VMEM and (8, 128) tiling and is not carried
// over.
//
// The reference converts each tap's int32 product to f32 and sums the taps
// in f32; this kernel keeps the whole K in int32.  The two agree exactly
// while |acc| < 2^24.
#include "gemm_common.cuh"

extern "C" int fcnn_conv_implicit_gemm(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int N, int H,
    int W, int C, int KH, int KW, int Co, int sh, int sw, int ph, int pw,
    int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, void* stream) {
  fcnn::ConvA a;
  a.x = static_cast<const char*>(x);
  a.H = H;
  a.W = W;
  a.C = C;
  a.KW = KW;
  a.sh = sh;
  a.sw = sw;
  a.ph = ph;
  a.pw = pw;
  a.OH = (H + 2 * ph - KH) / sh + 1;
  a.OW = (W + 2 * pw - KW) / sw + 1;
  if (a.OH <= 0 || a.OW <= 0) return 0;
  a.M = N * a.OH * a.OW;
  a.K = KH * KW * C;
  const fcnn::Epilogue e = fcnn::make_epilogue(
      out, bias, w_scale, lo, hi, act, x_scale, out_scale, out_type);
  return fcnn::launch_gemm(
      a, w, Co, x_type, w_type, C % 16 == 0 && C >= 16,
      fcnn::make_plan(variant, bn, bk, stages, bres, grid, smem), e,
      static_cast<cudaStream_t>(stream));
}
