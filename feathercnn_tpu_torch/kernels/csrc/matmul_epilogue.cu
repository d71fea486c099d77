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
// M = N*H*W up to 401,408, K 64..2048, N 64..2560) the work is
// 2*M*N*K int8 operations against 1,979 TOP/s, and the bytes are
// M*K + K*N + M*N*out_size against 3.35 TB/s.  With int8 in and out and
// M >> K, N that is about 2*K*N / (K + N) operations per byte: ~100 at
// K = 64, N = 256, far below the ~590 that the card needs to be compute
// bound, so most of these layers are bound by memory; only the widest
// merged convs and stage 5 tip toward the tensor cores.
//
// What the simple design does about it: 128 x 64 output tiles; it reads A
// with 16-byte loads where K % 16 == 0 (single bytes otherwise), runs the
// products on the tensor cores (mma.sync, int32 accumulation over the whole
// K), and
// applies the epilogue in registers so the output is written once, as
// int8 where the next layer takes int8.  The ragged M, N and K edges are
// masked in the kernel, so nothing is padded in memory.  Not yet done:
// wgmma, TMA, and a staged (coalesced) output store.
//
// The reference converts the int32 product of each K block to f32 and sums
// the blocks in f32 (matmul.py:63-64); this kernel keeps the whole K in
// int32.  The two agree exactly while |acc| < 2^24.
#include "gemm_common.cuh"

extern "C" int fcnn_matmul_epilogue(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int M, int K,
    int N, int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, void* stream) {
  fcnn::MatrixA a;
  a.x = static_cast<const char*>(x);
  a.M = M;
  a.K = K;
  const int va = (K % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 16 : 1;
  const fcnn::Epilogue e = fcnn::make_epilogue(
      out, bias, w_scale, lo, hi, act, x_scale, out_scale, out_type);
  return fcnn::launch_gemm(a, w, N, x_type, w_type, va, e,
                           static_cast<cudaStream_t>(stream));
}
