// depthwise_conv: per-channel KH x KW convolution (channel multiplier 1) on
// NHWC tensors, in two variants that share one kernel body.
//
// Replaces
//  - the Pallas kernel feathercnn_tpu/kernels/depthwise.py:65
//    (depthwise_conv2d; body _dw_kernel at :32-59) with the float variant,
//    fcnn_depthwise_conv2d.  x is f32 or bf16, w f32 (KH, KW, C), bias f32.
//    It accumulates in f32 tap by tap (kh outer, kw inner, from 0), one FMA
//    per tap (the reference's compiled body contracts the product and the
//    add), then adds the bias, applies ReLU/ReLU6 and stores in x's type.
//    It also takes int8 x with x_scale and turns each element into
//    bf16(float(q) * x_scale) (or f32) as it loads it: bit for bit the
//    separate dequantize of the reference's dispatcher (dispatch.py:74-82),
//    without its full pass over the edge.
//  - XLA's int8 depthwise conv of the reference's "xla" branch
//    (feathercnn_tpu/kernels/dispatch.py:221-253), which has no Pallas
//    kernel, with the int8 variant, fcnn_depthwise_conv2d_int8.  x and w are
//    int8; the accumulator is an exact int32.  The epilogue is the GEMM
//    kernels' (epilogue_value and requant_i8 in gemm_common.cuh): the folded
//    w_scale * x_scale as w_scale, + bias, act, then an int8 store (round
//    half to even, saturated to +-127) or a float one.
//
// What bounds it on an H100 SXM: memory.  A 3x3 depthwise layer does 9
// multiply-adds per output element and moves about 2 bytes per output
// element at stride 1 (int8 in, int8 out): ~9 operations per byte, far
// below the ~590 int8 (or ~20 f32 FMA, 67 TFLOP/s) operations per byte at
// which the card turns compute bound.
//
// What the simple design does about it: one thread per output pixel and
// 16-byte vector of channels (16 int8, 8 bf16 or 4 f32), loaded and stored
// 16 bytes at a time along the contiguous C; neighbouring threads take
// neighbouring vectors of one pixel, then of the next pixel, so a warp reads
// and writes contiguous runs.  Each block keeps the KH*KW weights of its
// channels in shared memory.  A bounds check stands in for the zero padding
// (a padded tap adds +-0 to an accumulator that is never -0, so skipping it
// changes no bit); a C that is not a multiple of the vector, or an unaligned
// pointer, takes single-element loads and stores with the ragged channels
// masked.  The nine reads of each input pixel at stride 1 are left to L1
// and L2.  Not yet done: staging input rows in shared memory, and more
// pixels per thread to reuse a loaded column across neighbouring outputs.
// The TPU kernel's row slabs and its padding of W and OW to multiples of 8
// exist for VMEM and the (8, 128) tiling, and are not carried over.
#include <type_traits>

#include "gemm_common.cuh"

namespace fcnn {
namespace {

constexpr int DW_THREADS = 256;
constexpr int DW_MAX_VECS = 32;            // channel vectors per block
constexpr int DW_MAX_SMEM = 48 * 1024;     // static limit, no opt-in needed

struct DwShape {
  int H, W, C, KH, KW, sh, sw, ph, pw, OH, OW;
  long long P;  // output pixels, N * OH * OW
  int vecs;     // channel vectors per block
  int vec_io;   // 1: 16-byte loads and vector stores (C % V == 0, aligned)
};

// The float that one loaded element of x contributes to the product.
__device__ __forceinline__ float load_f32(float v, float, int) { return v; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 v, float, int) {
  return __bfloat162float(v);
}
// int8 x in the float variant: dequantized to the compute type.
__device__ __forceinline__ float load_f32(int8_t v, float x_scale,
                                          int deq_bf16) {
  const float y = __fmul_rn(static_cast<float>(v), x_scale);
  return deq_bf16 ? __bfloat162float(__float2bfloat16_rn(y)) : y;
}

template <typename T, int V>
union Vec {
  uint4 u[(V * sizeof(T) + 15) / 16];
  T v[V];
};

// V elements of type T to out (V * sizeof(T) bytes, aligned to that size
// or to 16): 16-, 8- or 4-byte stores.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* out, const T (&v)[V]) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
    Vec<T, V> p;
#pragma unroll
    for (int j = 0; j < V; ++j) p.v[j] = v[j];
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      reinterpret_cast<uint4*>(out)[k] = p.u[k];
  } else if constexpr (BYTES == 8) {
    union { uint2 u; T t[V]; } p;
#pragma unroll
    for (int j = 0; j < V; ++j) p.t[j] = v[j];
    *reinterpret_cast<uint2*>(out) = p.u;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = v[j];
  }
}

template <typename T, int V>
__device__ __forceinline__ void put(T* out, const T (&v)[V], int n_valid,
                                    int vec) {
  if (vec) {
    store_vec<T, V>(out, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n_valid) out[j] = v[j];
  }
}

// INT_ACC: the int8 variant (x and w int8, int32 accumulator).  Otherwise
// the float variant (f32 weights, f32 accumulator).
template <typename TX, bool INT_ACC>
__global__ void __launch_bounds__(DW_THREADS)
dw_kernel(const TX* __restrict__ x, const void* __restrict__ w_any,
          DwShape s, float x_scale, int deq_bf16, Epilogue e) {
  using TW = typename std::conditional<INT_ACC, int8_t, float>::type;
  using TA = typename std::conditional<INT_ACC, int, float>::type;
  constexpr int V = 16 / static_cast<int>(sizeof(TX));
  extern __shared__ __align__(16) unsigned char dw_smem[];
  TW* ws = reinterpret_cast<TW*>(dw_smem);
  const TW* w = static_cast<const TW*>(w_any);

  // this block's channels [cb0, cb0 + CB): their weights, tap-major
  const int CB = s.vecs * V;
  const int cb0 = blockIdx.y * CB;
  const int taps = s.KH * s.KW;
  for (int i = threadIdx.x; i < taps * CB; i += DW_THREADS) {
    const int t = i / CB;
    const int c = cb0 + (i - t * CB);
    ws[i] = c < s.C ? w[static_cast<long long>(t) * s.C + c] : TW(0);
  }
  __syncthreads();

  const int ppb = DW_THREADS / s.vecs;   // output pixels per block
  const int lp = threadIdx.x / s.vecs;
  const int pv = threadIdx.x - lp * s.vecs;
  const long long pix = static_cast<long long>(blockIdx.x) * ppb + lp;
  const int c0 = cb0 + pv * V;
  if (lp >= ppb || pix >= s.P || c0 >= s.C) return;
  const int n_valid = s.C - c0 < V ? s.C - c0 : V;
  const int ow = static_cast<int>(pix % s.OW);
  const long long t = pix / s.OW;
  const int oh = static_cast<int>(t % s.OH);
  const long long img = t / s.OH;

  TA acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = TA(0);

  const int ih0 = oh * s.sh - s.ph;
  const int iw0 = ow * s.sw - s.pw;
  for (int kh = 0; kh < s.KH; ++kh) {
    const int ih = ih0 + kh;
    if (ih < 0 || ih >= s.H) continue;
    const TX* row = x + ((img * s.H + ih) * s.W) * s.C + c0;
    for (int kw = 0; kw < s.KW; ++kw) {
      const int iw = iw0 + kw;
      if (iw < 0 || iw >= s.W) continue;
      const TX* px = row + static_cast<long long>(iw) * s.C;
      Vec<TX, V> xv;
      if (s.vec_io) {
        xv.u[0] = __ldg(reinterpret_cast<const uint4*>(px));
      } else {
        xv.u[0] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (j < n_valid) xv.v[j] = px[j];
      }
      Vec<TW, V> wv;
      const uint4* wt = reinterpret_cast<const uint4*>(
          ws + (kh * s.KW + kw) * CB + pv * V);
#pragma unroll
      for (int k = 0; k < static_cast<int>(sizeof(wv.u) / 16); ++k)
        wv.u[k] = wt[k];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (INT_ACC) {
          acc[j] += static_cast<int>(xv.v[j]) * static_cast<int>(wv.v[j]);
        } else {
          acc[j] = __fmaf_rn(load_f32(xv.v[j], x_scale, deq_bf16), wv.v[j],
                             acc[j]);
        }
      }
    }
  }

  float y[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    y[j] = j < n_valid ? epilogue_value(static_cast<float>(acc[j]), c0 + j, e)
                       : 0.0f;
  const long long o = pix * s.C + c0;
  if (e.out_type == DT_I8) {
    int8_t q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = requant_i8(y[j], e.out_scale);
    put<int8_t, V>(static_cast<int8_t*>(e.out) + o, q, n_valid, s.vec_io);
  } else if (e.out_type == DT_BF16) {
    __nv_bfloat16 b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = __float2bfloat16_rn(y[j]);
    put<__nv_bfloat16, V>(static_cast<__nv_bfloat16*>(e.out) + o, b,
                          n_valid, s.vec_io);
  } else {
    put<float, V>(static_cast<float*>(e.out) + o, y, n_valid, s.vec_io);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TX, bool INT_ACC>
int launch_dw(const void* x, const void* w, int N, int H, int W, int C,
              int KH, int KW, int sh, int sw, int ph, int pw, float x_scale,
              int deq_bf16, const Epilogue& e, cudaStream_t stream) {
  using TW = typename std::conditional<INT_ACC, int8_t, float>::type;
  constexpr int V = 16 / static_cast<int>(sizeof(TX));
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || KH <= 0 || KW <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || e.act < ACT_NONE ||
      e.act > ACT_RELU6 || !x || !w || !e.out)
    return bad;
  DwShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.KH = KH;
  s.KW = KW;
  s.sh = sh;
  s.sw = sw;
  s.ph = ph;
  s.pw = pw;
  s.OH = (H + 2 * ph - KH) / sh + 1;
  s.OW = (W + 2 * pw - KW) / sw + 1;
  if (H + 2 * ph < KH || W + 2 * pw < KW) return bad;
  s.P = static_cast<long long>(N) * s.OH * s.OW;
  if (s.P == 0) return 0;
  s.vec_io = (C % V == 0 && aligned16(x) && aligned16(e.out)) ? 1 : 0;
  const int nvec = (C + V - 1) / V;
  int vecs = nvec < DW_MAX_VECS ? nvec : DW_MAX_VECS;
  const long long wbytes = static_cast<long long>(sizeof(TW)) * V * KH * KW;
  while (vecs > 1 && wbytes * vecs > DW_MAX_SMEM) vecs /= 2;
  if (wbytes * vecs > DW_MAX_SMEM) return bad;
  s.vecs = vecs;
  const long long ppb = DW_THREADS / vecs;
  const long long gx = (s.P + ppb - 1) / ppb;
  const long long gy = (nvec + vecs - 1) / vecs;
  if (gx > 0x7fffffffLL || gy > 65535) return bad;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  dw_kernel<TX, INT_ACC><<<grid, DW_THREADS, static_cast<size_t>(wbytes * vecs),
                           stream>>>(static_cast<const TX*>(x), w, s, x_scale,
                                     deq_bf16, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fcnn

// The float variant.  x_type: DT_F32 or DT_BF16 (out_type equal to it), or
// DT_I8 with x_scale (dequantized to out_type, DT_F32 or DT_BF16).
extern "C" int fcnn_depthwise_conv2d(
    const void* x, const float* w, void* out, const float* bias, int N,
    int H, int W, int C, int KH, int KW, int sh, int sw, int ph, int pw,
    int x_type, int out_type, int act, float x_scale, void* stream) {
  using namespace fcnn;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (out_type != DT_F32 && out_type != DT_BF16) return bad;
  if (x_type != DT_I8 && x_type != out_type) return bad;
  const Epilogue e = make_epilogue(out, bias, nullptr, nullptr, nullptr, act,
                                   1.0f, 1.0f, out_type);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == DT_F32)
    return launch_dw<float, false>(x, w, N, H, W, C, KH, KW, sh, sw, ph, pw,
                                   1.0f, 0, e, s);
  if (x_type == DT_BF16)
    return launch_dw<__nv_bfloat16, false>(x, w, N, H, W, C, KH, KW, sh, sw,
                                           ph, pw, 1.0f, 0, e, s);
  if (x_type == DT_I8)
    return launch_dw<int8_t, false>(x, w, N, H, W, C, KH, KW, sh, sw, ph, pw,
                                    x_scale, out_type == DT_BF16 ? 1 : 0, e,
                                    s);
  return bad;
}

// The int8 variant: int8 x and w, w_scale the folded per-channel scale;
// out_type DT_I8 (q = rint(y * out_scale)), DT_BF16 or DT_F32.
extern "C" int fcnn_depthwise_conv2d_int8(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, int N, int H, int W, int C, int KH, int KW, int sh,
    int sw, int ph, int pw, int out_type, int act, float out_scale,
    void* stream) {
  using namespace fcnn;
  if (out_type < DT_F32 || out_type > DT_I8 || !w_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue e = make_epilogue(out, bias, w_scale, nullptr, nullptr, act,
                                   1.0f, out_scale, out_type);
  return launch_dw<int8_t, true>(x, w, N, H, W, C, KH, KW, sh, sw, ph, pw,
                                 1.0f, 0, e, static_cast<cudaStream_t>(stream));
}
