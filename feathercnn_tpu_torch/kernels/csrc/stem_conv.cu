// stem_conv: the float stem (a conv on C_in <= 4 image channels, bf16 in,
// int8 out) as one kernel, its bias, activation and requantization in the
// epilogue.
//
// Replaces no Pallas kernel: the reference leaves the stem to XLA's float
// conv (feathercnn_tpu/kernels/dispatch.py:232-252, conv_forward's float
// branch: conv_general_dilated on the bf16 input and the dequantized weight
// with f32 sums, + bias, the activation, then clip(round(y * out_scale))).
// The port adds it because the library route (cuDNN's f32 conv on an f32
// copy of the input, then five f32 passes and a cast over its output, and
// a host sync for the scale) was the largest device item of every
// benchmark cell.  Per output pixel and channel it computes
//
//   acc = 0; for r, s, c in that order: acc = fma(x[ih, iw, c], w[r, s, c, o], acc)
//   y   = act(acc + bias[o])        (none, relu or relu6; the add rounds once)
//   out = clip(round_half_even(y * out_scale), -127, 127)   as int8
//
// which is kernels/stem.py::stem_conv_plain's arithmetic on the CPU to the
// bit wherever PyTorch's CPU conv sums the taps one at a time in that
// order, as it does for a stem padded by at most (k - 1) / 2 (every zoo
// stem but FCN's pad 100): a bf16 x bf16 product is exact in f32, so each
// FMA rounds as that sum does, and the network on the card stays equal
// to the port on the CPU.
// (A tensor-core design, mma.sync bf16 with f32 sums, ran the ResNet-50
// stem at b512 in 0.55 ms, but its sums round in another order: 1 LSB off
// on ~1e-6 of the values, and on random-weight nets such flips cascade,
// which parted five chip_smoke paths from the CPU.)  out_scale and the
// activation are kernel arguments, so a launch needs no device constant.
//
// What bounds it on an H100 SXM.  ResNet-50's 7x7 s2 stem (3 -> 64) reads
// 301 KB of bf16 and writes 803 KB of int8 an image: 0.169 ms at b512
// against 3.35 TB/s; its 118 M multiply-adds an image in f32 FMAs take
// 1.80 ms at 67 TFLOP/s.  So the FMAs bound it, ten times over the bytes.
//
// The design keeps the FMA pipes fed.  A persistent grid; each block keeps
// the whole weight in shared memory as f32, (K, Co) with K over (r, s, c),
// each K row's channels in 16-byte vectors interleaved by lane
// (kernels/stem.py::stem_layout, made once per node), and walks bands of
// TH output rows of one image: the (TH - 1) * sh + KH input rows a band
// reads are staged whole into shared memory as f32, between zero columns
// that stand for the left and right padding; rows above or below the
// image are zeros.  A warp computes PL x P pixels by all Co channels: lane
// (pl, cl) holds P pixels (pl, pl + PL, ...) by Q = Co / CL channels in
// registers, and at each tap loads its P input values (the lanes of one
// pl read one address) and its Q weights (16-byte loads; the CL lanes of a
// quarter-warp read 128 contiguous bytes), then runs P x Q FMAs.  A
// pixel's window of one kernel row is kw * C consecutive floats of a
// staged row, so the tap loop is r, then e = s * C + c.  The epilogue runs
// in registers; lane (pl, cl) stores its Q bytes of each pixel, so a
// warp's store covers whole output pixels, contiguous in the NHWC output.
// Two blocks share an SM, so one block's staging overlaps the other's
// FMAs.
#include "gemm_common.cuh"

namespace fcnn {
namespace {

constexpr int STEM_THREADS = 256;
constexpr int STEM_WARPS = STEM_THREADS / 32;

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A launch's geometry; stem_plan in kernels/stem.py computes the same.
struct StemGeom {
  int h, w, c, oh, ow, kh, kwc, sh, sw, ph, pw;
  int lead;  // zero floats before each staged row's data
  int rp;    // staged row pitch, floats
  int rows;  // input rows a band stages
  int th;    // output rows a band
  int bands_per_image;
  long long bands;
  int act;
  float out_scale;
  int vec_rows;  // rows read as 16-byte vectors
};

// y = acc + bias (rounded once), then y * scale clamped to [lo, hi] and
// converted by cvt.rni.sat (round half to even, saturated to 127).  That
// is clip(round(act(y) * scale), -127, 127) bit for bit: scale > 0, so the
// activation's bounds move through the multiply (lo = 0 and hi = 6 * scale
// rounded for relu6; lo = 0 for relu; lo = -127 for none, an integer, so
// the lower clamp may come before the rounding).  Returns the byte in the
// low 8 bits.
__device__ __forceinline__ uint32_t requant(float acc, float b, float scale,
                                            float lo, float hi) {
  const float v = fminf(fmaxf(__fmul_rn(__fadd_rn(acc, b), scale), lo), hi);
  uint32_t q;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(v));
  return q & 0xffu;
}

// Shared memory of a launch: the weight, the bias, the staged rows
// (stem_plan in kernels/stem.py computes the same).
template <int CO>
long long stem_smem_bytes(const StemGeom& g) {
  return 4LL * g.kh * g.kwc * CO + 4LL * CO + 4LL * g.rows * g.rp;
}

// CL lanes share a pixel, each with Q = CO / CL channels; PL = 32 / CL
// pixel lanes, each with P pixels.
template <int CO, int CL, int P>
__global__ void __launch_bounds__(STEM_THREADS, 2)
stem_conv_kernel(const uint16_t* __restrict__ x,
                 const float4* __restrict__ wk,
                 const float* __restrict__ bias, int8_t* __restrict__ out,
                 const StemGeom g) {
  constexpr int Q = CO / CL;
  constexpr int QV = Q / 4;
  constexpr int PL = 32 / CL;
  constexpr int UNIT = PL * P;  // pixels a warp takes at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = g.kh * g.kwc;
  float4* s_w = reinterpret_cast<float4*>(smem);
  float* s_bias = reinterpret_cast<float*>(s_w + k * QV * CL);
  float* s_x = s_bias + CO;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cl = lane % CL;
  const int pl = lane / CL;

  // Once a block: the weight, the bias, and zeros over the staged rows
  // (their lead and tail columns stay zero).
  for (int i = tid; i < k * QV * CL; i += STEM_THREADS) s_w[i] = wk[i];
  for (int i = tid; i < CO; i += STEM_THREADS)
    s_bias[i] = bias ? bias[i] : 0.0f;
  for (int i = tid; i < g.rows * g.rp; i += STEM_THREADS) s_x[i] = 0.0f;
  __syncthreads();

  const float lo = g.act == ACT_NONE ? -127.0f : 0.0f;
  const float hi = g.act == ACT_RELU6 ? __fmul_rn(6.0f, g.out_scale)
                                      : 127.0f;
  float bq[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) bq[q] = s_bias[cl * Q + q];

  const int rowel = g.w * g.c;
  for (long long b = blockIdx.x; b < g.bands; b += gridDim.x) {
    const int img = static_cast<int>(b / g.bands_per_image);
    const int oh0 = static_cast<int>(b % g.bands_per_image) * g.th;
    const int ih0 = oh0 * g.sh - g.ph;  // the image row of staged row 0
    const uint16_t* x_img = x + static_cast<long long>(img) * g.h * rowel;
    __syncthreads();  // every warp is done with the previous band's rows
    if (g.vec_rows) {
      const int vpr = rowel / 8;
      for (int i = tid; i < g.rows * vpr; i += STEM_THREADS) {
        const int rr = i / vpr;
        const int v = i - rr * vpr;
        const int ih = ih0 + rr;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (ih >= 0 && ih < g.h)
          u = __ldg(reinterpret_cast<const uint4*>(
                        x_img + static_cast<long long>(ih) * rowel) +
                    v);
        float4* d = reinterpret_cast<float4*>(s_x + rr * g.rp + g.lead +
                                              v * 8);
        d[0] = make_float4(__uint_as_float(u.x << 16),
                           __uint_as_float(u.x & 0xffff0000u),
                           __uint_as_float(u.y << 16),
                           __uint_as_float(u.y & 0xffff0000u));
        d[1] = make_float4(__uint_as_float(u.z << 16),
                           __uint_as_float(u.z & 0xffff0000u),
                           __uint_as_float(u.w << 16),
                           __uint_as_float(u.w & 0xffff0000u));
      }
    } else {
      for (int i = tid; i < g.rows * rowel; i += STEM_THREADS) {
        const int rr = i / rowel;
        const int e = i - rr * rowel;
        const int ih = ih0 + rr;
        const uint32_t u =
            ih >= 0 && ih < g.h
                ? x_img[static_cast<long long>(ih) * rowel + e]
                : 0u;
        s_x[rr * g.rp + g.lead + e] = __uint_as_float(u << 16);
      }
    }
    __syncthreads();

    const int band_px = min(g.th, g.oh - oh0) * g.ow;
    const int units = (band_px + UNIT - 1) / UNIT;
    int8_t* out_band =
        out + (static_cast<long long>(img) * g.oh + oh0) * g.ow * CO;
    for (int u = warp; u < units; u += STEM_WARPS) {
      const int p0 = u * UNIT;
      // where each of the lane's pixels' windows starts in the staged
      // rows; a pixel past the band reads the band's last one and is not
      // stored
      int base[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int p = min(p0 + pl + PL * j, band_px - 1);
        const int orow = p / g.ow;
        const int ocol = p - orow * g.ow;
        base[j] = orow * g.sh * g.rp + g.lead + (ocol * g.sw - g.pw) * g.c;
      }
      float acc[P][Q];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[j][q] = 0.0f;
      const float4* wt = s_w + cl;
      for (int r = 0; r < g.kh; ++r) {
        const float* xr = s_x + r * g.rp;
        for (int e = 0; e < g.kwc; ++e) {
          float xv[P];
#pragma unroll
          for (int j = 0; j < P; ++j) xv[j] = xr[base[j] + e];
          float4 wv[QV];
#pragma unroll
          for (int v = 0; v < QV; ++v) wv[v] = wt[v * CL];
          wt += QV * CL;
#pragma unroll
          for (int j = 0; j < P; ++j) {
#pragma unroll
            for (int v = 0; v < QV; ++v) {
              acc[j][4 * v] = __fmaf_rn(xv[j], wv[v].x, acc[j][4 * v]);
              acc[j][4 * v + 1] =
                  __fmaf_rn(xv[j], wv[v].y, acc[j][4 * v + 1]);
              acc[j][4 * v + 2] =
                  __fmaf_rn(xv[j], wv[v].z, acc[j][4 * v + 2]);
              acc[j][4 * v + 3] =
                  __fmaf_rn(xv[j], wv[v].w, acc[j][4 * v + 3]);
            }
          }
        }
      }
      // the epilogue: the lane's Q bytes of each of its pixels, as Q / 4
      // words
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int p = p0 + pl + PL * j;
        if (p >= band_px) continue;
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            out_band + static_cast<long long>(p) * CO + cl * Q);
#pragma unroll
        for (int v = 0; v < QV; ++v) {
          uint32_t word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            word |= requant(acc[j][4 * v + i], bq[4 * v + i], g.out_scale,
                            lo, hi)
                    << (8 * i);
          dst[v] = word;
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1) {
    return 132;
  }
  return sms;
}

template <int CO, int CL, int P>
int launch_stem(const void* x, const void* wk, const void* bias, void* out,
                const StemGeom& g, cudaStream_t stream) {
  const long long smem = stem_smem_bytes<CO>(g);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = stem_conv_kernel<CO, CL, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, STEM_THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const int sms = sm_count();
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > g.bands) grid = g.bands;
  kern<<<static_cast<unsigned>(grid), STEM_THREADS, static_cast<int>(smem),
         stream>>>(static_cast<const uint16_t*>(x),
                   static_cast<const float4*>(wk),
                   static_cast<const float*>(bias),
                   static_cast<int8_t*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fcnn

// out (n, oh, ow, co) int8 NHWC = the stem conv of x (n, h, w, c) bf16
// NHWC with the weight wk (stem_layout's f32 form of the (kh, kw, c, co)
// weight), plus bias (co f32, or null), the activation act (0 none, 1
// relu, 2 relu6), times out_scale, rounded half to even and clamped to
// +-127; each sum taken in the order r, s, c.  th: output rows a band (the
// host's plan).  Refuses (cudaErrorInvalidValue) what the kernel does not
// take: c > 4, co not 24, 32, 64 or 96, kh or kw above 11, a stride
// outside 1-4, shared memory over the SM's, misaligned pointers.  Returns
// the launch's cudaError_t.
extern "C" int fcnn_stem_conv(const void* x, const void* wk,
                              const void* bias, void* out, int n, int h,
                              int w, int c, int kh, int kw, int co, int sh,
                              int sw, int ph, int pw, int th, int act,
                              float out_scale, void* stream) {
  using namespace fcnn;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || h <= 0 || w <= 0 || c < 1 || c > 4 || kh < 1 || kh > 11 ||
      kw < 1 || kw > 11 || sh < 1 || sh > 4 || sw < 1 || sw > 4 || ph < 0 ||
      pw < 0 || th < 1 || act < ACT_NONE || act > ACT_RELU6 || !x || !wk ||
      !out)
    return bad;
  if (h + 2 * ph < kh || w + 2 * pw < kw) return bad;
  StemGeom g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.oh = (h + 2 * ph - kh) / sh + 1;
  g.ow = (w + 2 * pw - kw) / sw + 1;
  g.kh = kh;
  g.kwc = kw * c;
  g.sh = sh;
  g.sw = sw;
  g.ph = ph;
  g.pw = pw;
  g.lead = round_up(pw * c, 8);
  const int last = g.lead + ((g.ow - 1) * sw - pw + kw) * c;
  g.rp = round_up(last > g.lead + w * c ? last : g.lead + w * c, 8);
  g.th = th;
  g.rows = (th - 1) * sh + kh;
  g.bands_per_image = (g.oh + th - 1) / th;
  g.bands = static_cast<long long>(n) * g.bands_per_image;
  g.act = act;
  g.out_scale = out_scale;
  g.vec_rows = (w * c) % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(wk) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4 ||
      reinterpret_cast<uintptr_t>(x) % 2)
    return bad;
  if (g.bands == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 24: return launch_stem<24, 2, 4>(x, wk, bias, out, g, st);
    case 32: return launch_stem<32, 4, 8>(x, wk, bias, out, g, st);
    case 64: return launch_stem<64, 8, 8>(x, wk, bias, out, g, st);
    case 96: return launch_stem<96, 8, 4>(x, wk, bias, out, g, st);
    default: return bad;
  }
}
