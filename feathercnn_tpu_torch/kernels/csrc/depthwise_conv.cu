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
//    bf16(float(q) * x_scale) (or f32): bit for bit the separate dequantize
//    of the reference's dispatcher (dispatch.py:74-82), without its full
//    pass over the edge.
//  - XLA's int8 depthwise conv of the reference's "xla" branch
//    (feathercnn_tpu/kernels/dispatch.py:221-253), which has no Pallas
//    kernel, with the int8 variant, fcnn_depthwise_conv2d_int8.  x and w are
//    int8 and the sum is exact.  The epilogue is the GEMM kernels': the
//    folded w_scale * x_scale as w_scale, + bias, act, then an int8 store
//    (round half to even, saturated to +-127) or a float one.
//
// What bounds it on an H100 SXM: memory.  A 3x3 layer does 9 multiply-adds
// per output element and must move about 2-3 bytes per output element at
// stride 1 (x read once, the output written once): ~4 operations per byte,
// far below the ~20 f32 FMA operations per byte (67 TFLOP/s over 3.35 TB/s)
// at which the card turns compute bound.  So the design aims at reading x
// once from device memory and keeping the FMA and shared-memory pipes
// below the memory time.
//
// The design (the host's plan, dw_plan in kernels/depthwise.py, gives the
// variant and its fixed tile of at most 64 channels and 256 threads, C and
// the output cut into even tiles; the kernel refuses a plan whose numbers
// it does not reproduce):
//  - A thread block takes a TH x TW tile of output pixels of one image and
//    a slice of CS channels.  It first copies the input window the tile
//    needs, (TH-1)*s+KH rows by (TW-1)*s+KW columns of CS channels, into
//    shared memory, once: 16-byte cp.async for a bf16 or f32 x (zero fill
//    outside the image and past C), or, for an int8 x, 16-byte loads
//    dequantized once per element as they are stored (the same __fmul_rn
//    and round to bf16 as the reference's dequantize; float(q) comes from
//    a byte permute and an exact subtraction, not from the conversion
//    unit, which would take an eighth of the FMA pipe's rate).  The
//    padding is stored as +0: a padded tap then adds +0*w to a sum that is
//    never -0, which changes no bit, so the taps need no bounds checks.
//  - The int8 variant stages its int8 x as it is, by cp.async like a bf16
//    x (half the bytes of a bf16 window, so more blocks fit an SM), reads
//    each 4 channels as float(q) (a byte permute and an exact subtraction
//    each) and sums float(q) * float(w) with FMAs: every product and
//    partial sum is an integer below 2^24 (KH*KW <= 1040 taps of at most
//    127^2), so each step is exact and the f32 sum equals the int32 one.
//    One loop body thus serves both variants, on the full-rate FMA pipe.
//  - Each thread owns 4 channels and RW neighbouring output pixels of one
//    row (variant "k3s1": 3x3, stride 1, RW = 8; "k3s2": 3x3, stride 2,
//    RW = 4).  It slides along the window row: each value it reads from
//    shared memory serves up to KW outputs, and its 4 channels' weights of
//    the row (KW taps) and epilogue constants stay in registers.  Each
//    output still sums its taps kh outer, kw inner, from 0, one FMA each, so the plain
//    versions remain bit-equal targets.  Variant "tiled" (any other kernel
//    size or stride) keeps one output per thread and reads its weights
//    from shared memory, with the same staging.
//  - Neighbouring threads take neighbouring channel quads, then
//    neighbouring output rows: each store is a run of whole channel
//    vectors of one pixel.  The window's pixel pitch carries a 16-byte pad
//    so that a warp's shared-memory reads of neighbouring rows spread over
//    the banks.
// The TPU kernel's row slabs and its padding of W and OW to multiples of 8
// exist for VMEM and the (8, 128) tiling, and are not carried over.
#include <type_traits>

#include "gemm_common.cuh"

namespace fcnn {
namespace {

// The variants, in the order of their codes (DW_VARIANTS in
// kernels/depthwise.py).
enum DwVariant { DW_TILED = 0, DW_K3S1 = 1, DW_K3S2 = 2 };
constexpr int DW_V = 4;   // channels per thread

struct DwShape {
  int H, W, C, KH, KW, s, ph, pw, OH, OW;
  int TH, TW, CS, RW;   // the plan's tile, channel slice, outputs per thread
  int WH, WW;           // the staged window
  int pitch;            // bytes per staged pixel
  int tiles_w, tiles;   // tiles per image row, per image
  int vec_x;            // 16-byte staging loads (C * sizeof(x) % 16 == 0, aligned)
  int vec_out;          // whole 4-channel stores (C % 4 == 0, aligned)
};

// 4 staged values of type S as floats.
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4],
                                      float) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4],
                                      __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// float(q) of byte b of four int8 values, without the conversion unit (16
// results a clock per SM on an H100, against 128 for an add): the byte
// with its sign bit flipped, q + 128, under the exponent of 2^23 is the
// float 2^23 + 128 + q, exactly, and one exact subtraction leaves q.
__device__ __forceinline__ float int8_as_float(uint32_t four, int b) {
  const uint32_t u = __byte_perm(four ^ 0x80808080u, 0x4B000000u, 0x7440u + b);
  return __fsub_rn(__uint_as_float(u), 8388736.0f);
}

// 4 staged int8 values as floats (the int8 variant).
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4],
                                      int8_t) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int b = 0; b < 4; ++b) v[b] = int8_as_float(u, b);
}

template <typename S>
__device__ __forceinline__ S zero_of() {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return __float2bfloat16_rn(0.0f);
  else
    return S(0);
}

// The window of input pixels the block's tile needs, and its channels'
// weights as f32 [tap][CS], into shared memory.  TX: x's type; S: the
// staged type.
template <typename TX, typename S, bool INT_W>
__device__ __forceinline__ void stage(const TX* __restrict__ x,
                                      const void* __restrict__ w_any,
                                      const DwShape& s, int img, int ih0,
                                      int iw0, int cs0, float x_scale,
                                      unsigned char* win, float* ws) {
  using TW = typename std::conditional<INT_W, int8_t, float>::type;
  constexpr int CH = 16 / static_cast<int>(sizeof(TX));   // channels per chunk
  const int nthr = blockDim.x;
  const int cpp = s.CS / CH;                               // chunks per pixel
  const int total = s.WH * s.WW * cpp;
  const long long img_off = static_cast<long long>(img) * s.H * s.W * s.C;
  // chunk i of the window: its source (null outside the image or past C,
  // where it stays zero) and its place in shared memory
  auto locate = [&](int i, const TX*& src, S*& dst, int& c) {
    const int pix = i / cpp;
    const int ch = i - pix * cpp;
    const int wy = pix / s.WW;
    const int wx = pix - wy * s.WW;
    const int ih = ih0 + wy;
    const int iw = iw0 + wx;
    c = cs0 + ch * CH;
    const bool in = static_cast<unsigned>(ih) < static_cast<unsigned>(s.H) &&
                    static_cast<unsigned>(iw) < static_cast<unsigned>(s.W);
    src = (in && c < s.C)
        ? x + img_off + (static_cast<long long>(ih) * s.W + iw) * s.C + c
        : nullptr;
    dst = reinterpret_cast<S*>(win + pix * s.pitch) + ch * CH;
  };
  if constexpr (std::is_same<TX, S>::value) {
    for (int i = threadIdx.x; i < total; i += nthr) {
      const TX* src;
      S* dst;
      int c;
      locate(i, src, dst, c);
      if (s.vec_x) {
        cp_async16(dst, src ? static_cast<const void*>(src)
                            : static_cast<const void*>(x), src != nullptr);
      } else {
#pragma unroll
        for (int j = 0; j < CH; ++j)
          dst[j] = (src && c + j < s.C) ? src[j] : zero_of<S>();
      }
    }
  } else {
    // int8 x, dequantized once, here: four chunks' loads in flight at once
    constexpr int U = 4;
    for (int i0 = threadIdx.x; i0 < total; i0 += U * nthr) {
      union { uint4 u; uint32_t w[4]; int8_t q[16]; } v[U];
      S* dst[U];
      int c[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const TX* src = nullptr;
        dst[u] = nullptr;
        c[u] = 0;
        v[u].u = make_uint4(0u, 0u, 0u, 0u);
        ok[u] = i0 + u * nthr < total;
        if (ok[u]) locate(i0 + u * nthr, src, dst[u], c[u]);
        if (src && s.vec_x) {
          v[u].u = __ldg(reinterpret_cast<const uint4*>(src));
        } else if (src) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (c[u] + j < s.C) v[u].q[j] = src[j];
        }
        ok[u] = ok[u] && src != nullptr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!dst[u]) continue;
        float f[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float q = int8_as_float(v[u].w[j / 4], j % 4);
          f[j] = (ok[u] && c[u] + j < s.C)
              ? (INT_W ? q : __fmul_rn(q, x_scale)) : 0.0f;
        }
        union { uint4 u[16 * sizeof(S) / 16]; uint32_t p[16 * sizeof(S) / 4];
                float e[16]; } o;
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          if constexpr (std::is_same<S, float>::value) {
            o.e[j] = f[j];
            o.e[j + 1] = f[j + 1];
          } else if constexpr (INT_W) {
            // an integer of at most 8 bits: its bf16 is its top half
            o.p[j / 2] = __byte_perm(__float_as_uint(f[j]),
                                     __float_as_uint(f[j + 1]), 0x7632);
          } else {
            const __nv_bfloat162 b = __floats2bfloat162_rn(f[j], f[j + 1]);
            o.p[j / 2] = *reinterpret_cast<const uint32_t*>(&b);
          }
        }
#pragma unroll
        for (int k = 0; k < static_cast<int>(16 * sizeof(S) / 16); ++k)
          reinterpret_cast<uint4*>(dst[u])[k] = o.u[k];
      }
    }
  }
  const TW* w = static_cast<const TW*>(w_any);
  const int taps = s.KH * s.KW;
  for (int i = threadIdx.x; i < taps * s.CS; i += nthr) {
    const int t = i / s.CS;
    const int c = cs0 + (i - t * s.CS);
    ws[i] = c < s.C ? static_cast<float>(w[static_cast<long long>(t) * s.C + c])
                    : 0.0f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// The epilogue of one output pixel's 4 channels and its store.  ``last``
// and ``bias`` hold epilogue_value's steps as one FMA (see column_pair in
// gemm_common.cuh): y = fma(acc, last, bias), bias -0.0 where there is none.
__device__ __forceinline__ void finish(const float (&acc)[4],
                                       const float (&last)[4],
                                       const float (&bias)[4], float lo,
                                       float hi, long long o, int n_valid,
                                       const DwShape& s, const Epilogue& e) {
  float y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    y[q] = fminf(fmaxf(__fmaf_rn(acc[q], last[q], bias[q]), lo), hi);
  if (e.out_type == DT_I8) {
    int8_t* out = static_cast<int8_t*>(e.out) + o;
    if (s.vec_out) {
      // requant_i8's bytes, on the full-rate pipes (requant_byte)
      uint32_t u = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) u |= requant_byte(y[q], e.out_scale) << (8 * q);
      *reinterpret_cast<uint32_t*>(out) = u;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n_valid) out[q] = requant_i8(y[q], e.out_scale);
    }
  } else if (e.out_type == DT_BF16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(e.out) + o;
    if (s.vec_out) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(out) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                     *reinterpret_cast<const uint32_t*>(&b));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n_valid) out[q] = __float2bfloat16_rn(y[q]);
    }
  } else {
    float* out = static_cast<float*>(e.out) + o;
    if (s.vec_out) {
      *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n_valid) out[q] = y[q];
    }
  }
}

// KH_ == 0: variant "tiled" (runtime KH, KW and stride, one output per
// thread); else the 3x3 variants with compile-time stride SS and RW outputs
// per thread.  INT_W: the int8 variant (int8 weights).
// At most 256 threads, and 64 registers a thread, so that four blocks fit
// an SM (PERF.md: faster on the counted routes than 80-odd registers and
// three blocks, the few spilled bytes included).
template <typename TX, typename S, bool INT_W, int KH_, int KW_, int SS, int RW>
__global__ void __launch_bounds__(256, 4)
dw_kernel(const TX* __restrict__ x, const void* __restrict__ w_any,
          DwShape s, float x_scale, Epilogue e) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  unsigned char* win = dw_smem;
  float* ws = reinterpret_cast<float*>(dw_smem + s.WH * s.WW * s.pitch);

  const int img = blockIdx.x / s.tiles;
  const int t = blockIdx.x - img * s.tiles;
  const int ty = t / s.tiles_w;
  const int oh0 = ty * s.TH;
  const int ow0 = (t - ty * s.tiles_w) * s.TW;
  const int cs0 = blockIdx.y * s.CS;
  stage<TX, S, INT_W>(x, w_any, s, img, oh0 * s.s - s.ph, ow0 * s.s - s.pw,
                      cs0, x_scale, win, ws);

  // this thread: channel quad cv, output row py, columns px*RW ..
  const int CV = s.CS / DW_V;
  const int cv = threadIdx.x % CV;
  const int r = threadIdx.x / CV;
  const int py = r % s.TH;
  const int px = r / s.TH;
  const int c0 = cs0 + cv * DW_V;
  if (c0 >= s.C) return;
  const int n_valid = min(DW_V, s.C - c0);

  float acc[RW][4];
#pragma unroll
  for (int o = 0; o < RW; ++o)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[o][q] = 0.0f;

  const float* wq = ws + cv * DW_V;   // tap t's 4 weights at wq + t * CS
  if constexpr (KH_ == 0) {
    const unsigned char* base =
        win + (py * s.s * s.WW + px * s.s) * s.pitch + cv * DW_V * sizeof(S);
    for (int kh = 0; kh < s.KH; ++kh)
      for (int kw = 0; kw < s.KW; ++kw) {
        float xv[4];
        load4(base + (kh * s.WW + kw) * s.pitch, xv, S());
        const float4 wv =
            *reinterpret_cast<const float4*>(wq + (kh * s.KW + kw) * s.CS);
        acc[0][0] = __fmaf_rn(xv[0], wv.x, acc[0][0]);
        acc[0][1] = __fmaf_rn(xv[1], wv.y, acc[0][1]);
        acc[0][2] = __fmaf_rn(xv[2], wv.z, acc[0][2]);
        acc[0][3] = __fmaf_rn(xv[3], wv.w, acc[0][3]);
      }
  } else {
    const unsigned char* base = win + (py * SS * s.WW + px * RW * SS) * s.pitch +
                                cv * DW_V * sizeof(S);
#pragma unroll
    for (int kh = 0; kh < KH_; ++kh) {
      // this row's KW taps of the thread's 4 channels, in registers for
      // its RW outputs
      float wr[KW_][4];
#pragma unroll
      for (int kw = 0; kw < KW_; ++kw) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wq + (kh * KW_ + kw) * s.CS);
        wr[kw][0] = wv.x;
        wr[kw][1] = wv.y;
        wr[kw][2] = wv.z;
        wr[kw][3] = wv.w;
      }
      const unsigned char* row = base + kh * s.WW * s.pitch;
#pragma unroll
      for (int j = 0; j < (RW - 1) * SS + KW_; ++j) {
        float xv[4];
        load4(row + j * s.pitch, xv, S());
        // column j is tap kw = j - o*SS of output o: ascending kw per output
#pragma unroll
        for (int o = 0; o < RW; ++o) {
          const int kw = j - o * SS;
          if (kw >= 0 && kw < KW_) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[o][q] = __fmaf_rn(xv[q], wr[kw][q], acc[o][q]);
          }
        }
      }
    }
  }

  float last[4], bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + (q < n_valid ? q : 0);
    last[q] = e.w_scale ? e.w_scale[c] : 1.0f;
    bias[q] = e.bias ? e.bias[c] : -0.0f;
  }
  const float lo = e.act == ACT_NONE ? -INFINITY : 0.0f;
  const float hi = e.act == ACT_RELU6 ? 6.0f : INFINITY;
  const int oh = oh0 + py;
  if (oh >= s.OH) return;
#pragma unroll
  for (int o = 0; o < RW; ++o) {
    const int ow = ow0 + px * RW + o;
    if (ow < s.OW)
      finish(acc[o], last, bias, lo, hi,
             ((static_cast<long long>(img) * s.OH + oh) * s.OW + ow) * s.C + c0,
             n_valid, s, e);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Shared memory of a plan: the window, then the weights as f32 [tap][CS]
// (dw_smem in kernels/depthwise.py computes the same).
inline long long dw_smem_bytes(const DwShape& s) {
  return static_cast<long long>(s.WH) * s.WW * s.pitch +
         4LL * s.KH * s.KW * s.CS;
}

template <typename TX, typename S, bool INT_W, int KH_, int KW_, int SS, int RW>
int launch_variant(const void* x, const void* w, const DwShape& s, dim3 grid,
                   int threads, int smem, float x_scale, const Epilogue& e,
                   cudaStream_t stream) {
  auto kern = dw_kernel<TX, S, INT_W, KH_, KW_, SS, RW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, threads, smem, stream>>>(static_cast<const TX*>(x), w, s,
                                        x_scale, e);
  return static_cast<int>(cudaGetLastError());
}

// The launch: the plan (variant, TH, TW, CS, pitch, threads, smem) checked
// against what the kernel needs and refused (cudaErrorInvalidValue) where
// it does not fit; never replaced by another plan.
template <typename TX, typename S, bool INT_W>
int launch_dw(const void* x, const void* w, int N, int H, int W, int C,
              int KH, int KW, int sh, int sw, int ph, int pw, float x_scale,
              const int* plan, const Epilogue& e, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int variant = plan[0], TH = plan[1], TW = plan[2], CS = plan[3];
  const int pitch = plan[4], threads = plan[5], smem = plan[6];
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || KH <= 0 || KW <= 0 ||
      sh <= 0 || sh != sw || ph < 0 || pw < 0 || e.act < ACT_NONE ||
      e.act > ACT_RELU6 || !x || !w || !e.out)
    return bad;
  if (H + 2 * ph < KH || W + 2 * pw < KW) return bad;
  if (INT_W && KH * KW > 1040) return bad;   // the f32 sum must stay exact
  DwShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.KH = KH;
  s.KW = KW;
  s.s = sh;
  s.ph = ph;
  s.pw = pw;
  s.OH = (H + 2 * ph - KH) / sh + 1;
  s.OW = (W + 2 * pw - KW) / sw + 1;
  if (static_cast<long long>(N) * s.OH * s.OW == 0) return 0;
  const int RW = variant == DW_K3S1 ? 8 : variant == DW_K3S2 ? 4 : 1;
  constexpr int CH = 16 / static_cast<int>(sizeof(TX));
  if (variant < DW_TILED || variant > DW_K3S2 || TH < 1 || TW < RW ||
      TW % RW || CS < CH || CS % CH || CS % DW_V || pitch % 16 ||
      pitch < CS * static_cast<int>(sizeof(S)))
    return bad;
  if (variant != DW_TILED &&
      (KH != 3 || KW != 3 || sh != (variant == DW_K3S1 ? 1 : 2)))
    return bad;
  s.TH = TH;
  s.TW = TW;
  s.CS = CS;
  s.RW = RW;
  s.WH = (TH - 1) * sh + KH;
  s.WW = (TW - 1) * sh + KW;
  s.pitch = pitch;
  s.tiles_w = (s.OW + TW - 1) / TW;
  s.tiles = ((s.OH + TH - 1) / TH) * s.tiles_w;
  s.vec_x = (C * static_cast<int>(sizeof(TX))) % 16 == 0 && aligned16(x);
  const int osize = out_size(e.out_type);
  s.vec_out = C % DW_V == 0 &&
              reinterpret_cast<uintptr_t>(e.out) % (DW_V * osize) == 0;
  if ((CS / DW_V) * TH * (TW / RW) != threads || threads > 256 ||
      dw_smem_bytes(s) != smem || smem > 227 * 1024)
    return bad;
  const long long gx = static_cast<long long>(N) * s.tiles;
  const long long gy = (C + CS - 1) / CS;
  if (gx > 0x7fffffffLL || gy > 65535) return bad;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (variant == DW_K3S1)
    return launch_variant<TX, S, INT_W, 3, 3, 1, 8>(x, w, s, grid, threads,
                                                    smem, x_scale, e, stream);
  if (variant == DW_K3S2)
    return launch_variant<TX, S, INT_W, 3, 3, 2, 4>(x, w, s, grid, threads,
                                                    smem, x_scale, e, stream);
  return launch_variant<TX, S, INT_W, 0, 0, 1, 1>(x, w, s, grid, threads,
                                                  smem, x_scale, e, stream);
}

}  // namespace
}  // namespace fcnn

// The float variant.  x_type: DT_F32 or DT_BF16 (out_type equal to it), or
// DT_I8 with x_scale (dequantized to out_type, DT_F32 or DT_BF16).  plan:
// variant, TH, TW, CS, pitch, threads, smem (dw_plan in
// kernels/depthwise.py).
extern "C" int fcnn_depthwise_conv2d(
    const void* x, const float* w, void* out, const float* bias, int N,
    int H, int W, int C, int KH, int KW, int sh, int sw, int ph, int pw,
    int x_type, int out_type, int act, float x_scale, int variant, int TH,
    int TW, int CS, int pitch, int threads, int smem, void* stream) {
  using namespace fcnn;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (out_type != DT_F32 && out_type != DT_BF16) return bad;
  if (x_type != DT_I8 && x_type != out_type) return bad;
  const Epilogue e = make_epilogue(out, bias, nullptr, nullptr, nullptr, act,
                                   1.0f, 1.0f, out_type);
  const int plan[7] = {variant, TH, TW, CS, pitch, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == DT_F32)
    return launch_dw<float, float, false>(x, w, N, H, W, C, KH, KW, sh, sw,
                                          ph, pw, 1.0f, plan, e, s);
  if (x_type == DT_BF16)
    return launch_dw<__nv_bfloat16, __nv_bfloat16, false>(
        x, w, N, H, W, C, KH, KW, sh, sw, ph, pw, 1.0f, plan, e, s);
  if (out_type == DT_BF16)
    return launch_dw<int8_t, __nv_bfloat16, false>(
        x, w, N, H, W, C, KH, KW, sh, sw, ph, pw, x_scale, plan, e, s);
  return launch_dw<int8_t, float, false>(x, w, N, H, W, C, KH, KW, sh, sw,
                                         ph, pw, x_scale, plan, e, s);
}

// The int8 variant: int8 x and w, w_scale the folded per-channel scale;
// out_type DT_I8 (q = rint(y * out_scale)), DT_BF16 or DT_F32.  x is staged
// as it is, int8, read as float(q) and summed exactly in f32.
extern "C" int fcnn_depthwise_conv2d_int8(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, int N, int H, int W, int C, int KH, int KW, int sh,
    int sw, int ph, int pw, int out_type, int act, float out_scale,
    int variant, int TH, int TW, int CS, int pitch, int threads, int smem,
    void* stream) {
  using namespace fcnn;
  if (out_type < DT_F32 || out_type > DT_I8 || !w_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue e = make_epilogue(out, bias, w_scale, nullptr, nullptr, act,
                                   1.0f, out_scale, out_type);
  const int plan[7] = {variant, TH, TW, CS, pitch, threads, smem};
  return launch_dw<int8_t, int8_t, true>(
      x, w, N, H, W, C, KH, KW, sh, sw, ph, pw, 1.0f, plan, e,
      static_cast<cudaStream_t>(stream));
}
