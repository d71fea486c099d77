// fused_block_float: one identity bottleneck of a fused chain in the float
// mode.  x and the weights are of one type T (bf16 or f32), the biases f32,
// and every sum is f32:
//
//   y1  = T(relu(x . w1 + b1))                          1x1, C -> Cm
//   y2  = T(relu(conv3x3(y1, pad 1) + b2))              3x3, Cm -> Cm
//   out = relu((y2 . w3 + b3) + f32(x))  -> T, or out_type on the last block
//
// Replaces the Pallas kernel feathercnn_tpu/kernels/fused_chain.py:264
// (fused_chain; bodies _chain_kernel :148-194 and _block_math :54-145) in
// its float mode (the f32 dots at :77-78, :109-111, :124-126, :137-139).
// The wrapper (kernels/fused_chain.py) launches this kernel once per block
// of the chain; between two blocks the activation goes through device
// memory in T, the type the TPU kernel keeps it in VMEM, so no value
// changes.  The bias add and the shortcut add are separate f32 adds, as in
// the reference (there is no product to contract into an FMA).  Conv2 sums
// its nine taps in one f32 sum of the tensor-core (or FMA) products; the
// reference's single dot (Cm <= 128) and nine per-tap dots (above) both sum
// in f32, in other orders, so the two agree to f32 rounding and the bf16
// stores of y1, y2 and the output may differ by one step where a value
// sits on a rounding boundary.
//
// What bounds it on an H100 SXM: 2*H*W*(2*C*Cm + 9*Cm^2) operations a
// pixel against 989 TFLOP/s dense bf16, and x read plus the output written
// (2*|x|) against 3.35 TB/s.  At ResNet-50's stages (C = 4*Cm) a b128 block
// is 55.9 GFLOP at every stage, 0.0565 ms of tensor-core time, and 2*|x| is
// 411 MB at stage 2 (0.123 ms) and 206 MB at stage 3 (0.061 ms): stages 2
// and 3 are bound by bytes (2.125*Cm operations a byte, 136 and 272, under
// the ~295 the card needs), stages 4 and 5 by the tensor cores.  The 12
// blocks of the bf16 ResNet-50 path have a bound of about 0.82 ms.  f32 runs
// on the FMA units (67 TFLOP/s): it is not on the headline path, and a
// simple correct variant is enough there (TF32 would round the inputs).
//
// The design is the int8 kernel's (fused_chain.cu): one thread block per
// (image, TH x TW output tile), 8 x 8 or 7 x 7 (the wrapper's tile_plan,
// which also checks that the type's shared memory fits).  y1 and y2 never
// leave shared memory:
//  1. conv1 runs over the tile's (TH+2) x (TW+2) halo, only at pixels inside
//     the image, and writes y1 in T into shared memory; the halo's pixels
//     outside the image stay 0, conv2's zero padding.
//  2. conv2 reads y1 from shared memory as an implicit im2col (K = 9 taps x
//     Cm, each tap's channels padded to a K step) and writes y2 into shared
//     memory.
//  3. conv3 reads y2 from shared memory, adds the shortcut read from x in
//     device memory (an L2 hit after conv1's read of the same pixels) and
//     stores the output, two neighbouring channels per access.
// Each GEMM runs 8 warps as 2 (M) x 4 (N) over 64-byte K steps.  bf16:
// mma.sync m16n8k16 with f32 accumulation, A fragments by ldmatrix.x4;
// each K step's 32 products go into a fresh tensor-core sum that one
// rounded f32 add takes into the running sum.  Accumulating all of K in
// the tensor cores instead, whose internal adds do not round to nearest,
// put several times more bf16 outputs a step off the plain version than
// an f32 sum in PyTorch's order puts there (measured on an H100 at
// ResNet-50's stage shapes); with the per-step add the two shares match
// (tools/float_chain_probe.py prints both).
// f32: plain FMAs in the same fragment layout, 16-byte shared loads.  The
// weights stream through a 3-stage cp.async ring from L2, where every
// thread block finds them, stored (N, K) with K contiguous (kernel_layout in
// fused_chain.py), so a 16-byte copy lands where the B fragment reads it.
// Shared memory is the limit: a bf16 y1 halo at stage 5 is 9*9*520*2 =
// 84 KB and y2 66 KB, which with the 60 KB ring fits a 7 x 7 tile (8 x 8
// does not); f32 doubles both, so an f32 block with Cm = 512 does not fit
// and the wrapper refuses it.  C and Cm that are multiples of 16 bytes' worth
// of elements take 16-byte copies; others take a masked element path.
// Not yet done: wgmma, TMA, a persistent grid, staged output rows.
#include "gemm_common.cuh"

namespace fcnn {
namespace {

constexpr int FF_THREADS = 256;
constexpr int FF_KB = 64;               // K bytes per step: 32 bf16, 16 f32
constexpr int FF_LDS = FF_KB + 16;      // staged row pitch: 80 bytes
constexpr int FF_MAX_HALO = 128;        // (TH + 2) * (TW + 2)
constexpr int FF_MAX_PIX = 64;          // TH * TW
constexpr int FF_MAX_BM = 128;
constexpr int FF_MAX_BN = 128;
constexpr int FF_STAGES = 3;            // cp.async ring depth

enum { A_GLOBAL = 0, A_IM2COL = 1, A_SMEM = 2 };

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct FloatArgs {
  const T* x;
  void* out;
  const T* w1;     // the weights transposed: (N, K), K contiguous
  const float* b1;
  const T* w2;
  const float* b2;
  const T* w3;
  const float* b3;
  int N, H, W, C, Cm, TH, TW, tiles_w, tiles_per_img;
  int cmp;         // Cm rounded up to a K step: channels a tap holds
  int ld;          // cmp + 16 bytes of elements: row pitch of y1s and y2s
  int halo_elems;  // (TH + 2) * (TW + 2) * ld
  int out_type;
  int vec1, vec2, vec3;  // the conv's operands take 16-byte copies
  int pair;              // conv3's x and output move two channels at a time
};

// One GEMM of the block, as block_gemm of fused_chain.cu: A is rows of x at
// the pixels row_off[m0 + r] (A_GLOBAL, K = C masked past Kreal, staged
// through shared memory), the 3x3 windows of y1 in shared memory
// (A_IM2COL: row r's window starts at halo position row_pos[r], tap t of a
// K step at (t / 3) * pitch + t % 3), or rows of y2 in shared memory
// (A_SMEM).  B is the transposed weight seen through a padded K: padded kp
// is real k (kp / seg) * real + kp % seg where kp % seg < real, else zero.
// K and the offsets count elements of T.
template <typename T>
struct GemmF {
  const T* x;
  const long long* row_off;
  int rows;
  int Kreal;
  const T* as;
  int lda;
  const int* row_pos;
  int pitch;
  int cseg;
  const T* w;
  int N;
  int Kt;
  int seg;
  int real;
  int Kp;
  int m0;
  int n0;
  int vec;
};

// The four 8x8 bf16 matrices of an m16n8k16 A fragment: lane l gives the
// address of row l % 16, k half l / 16 (16 bytes each).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T, int MT, int NT, int AK>
__device__ __forceinline__ void block_gemm_f(const GemmF<T>& g, char* As,
                                             char* Bs,
                                             float (&acc)[MT][NT][4]) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int V = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int BK = FF_KB / sizeof(T);      // elements per K step
  constexpr int BM = 2 * MT * 16;
  constexpr int BN = 4 * NT * 8;
  constexpr int AV = BM / 64;                // A: 16-byte chunks per thread
  constexpr int BV = BN / 64;                // B: 16-byte chunks per thread
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  // A_IM2COL: the halo position of each A row the thread reads (bf16: the
  // ldmatrix row lane % 16; f32: rows gid and gid + 8)
  int rpos[MT][2];
  if constexpr (AK == A_IM2COL) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int base = g.m0 + warp_m * MT * 16 + mt * 16;
      if constexpr (BF16) {
        rpos[mt][0] = g.row_pos[base + (lane & 15)];
        rpos[mt][1] = 0;
      } else {
        rpos[mt][0] = g.row_pos[base + gid];
        rpos[mt][1] = g.row_pos[base + gid + 8];
      }
    }
  }

  // one K step's tiles, global -> shared memory: 16-byte cp.async where
  // the rows are whole 16-byte pieces, else element by element
  auto fetch = [&](int stage, int k0) {
    char* a_st = As + stage * FF_MAX_BM * FF_LDS;
    char* b_st = Bs + stage * FF_MAX_BN * FF_LDS;
    if (g.vec) {
      if constexpr (AK == A_GLOBAL) {
#pragma unroll
        for (int i = 0; i < AV; ++i) {
          const int v = tid + i * FF_THREADS;
          const int r = v >> 2;
          const int k = k0 + (v & 3) * V;
          const bool ok = g.m0 + r < g.rows && k < g.Kreal;
          cp_async16(a_st + r * FF_LDS + (v & 3) * 16,
                     ok ? g.x + g.row_off[g.m0 + r] + k : g.x, ok);
        }
      }
#pragma unroll
      for (int i = 0; i < BV; ++i) {
        const int v = tid + i * FF_THREADS;
        const int nn = v >> 2;
        const int kp = k0 + (v & 3) * V;
        const int s = kp / g.seg;
        const int c = kp - s * g.seg;
        const int n = g.n0 + nn;
        const bool ok = c < g.real && n < g.N;
        cp_async16(b_st + nn * FF_LDS + (v & 3) * 16,
                   ok ? g.w + static_cast<long long>(n) * g.Kt + s * g.real + c
                      : g.w, ok);
      }
    } else {
      if constexpr (AK == A_GLOBAL) {
        for (int e = tid; e < BM * BK; e += FF_THREADS) {
          const int r = e / BK;
          const int kk = e - r * BK;
          const int k = k0 + kk;
          reinterpret_cast<T*>(a_st + r * FF_LDS)[kk] =
              (g.m0 + r < g.rows && k < g.Kreal)
                  ? g.x[g.row_off[g.m0 + r] + k] : from_f32<T>(0.0f);
        }
      }
      for (int e = tid; e < BN * BK; e += FF_THREADS) {
        const int nn = e / BK;
        const int kk = e - nn * BK;
        const int kp = k0 + kk;
        const int s = kp / g.seg;
        const int c = kp - s * g.seg;
        const int n = g.n0 + nn;
        reinterpret_cast<T*>(b_st + nn * FF_LDS)[kk] =
            (c < g.real && n < g.N)
                ? g.w[static_cast<long long>(n) * g.Kt + s * g.real + c]
                : from_f32<T>(0.0f);
      }
    }
  };

  __syncthreads();   // the previous GEMM's tiles are consumed
  const int n_k = g.Kp / BK;
#pragma unroll
  for (int s = 0; s < FF_STAGES - 1; ++s) {
    if (s < n_k) fetch(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<FF_STAGES - 2>();
    __syncthreads();   // step kt's tiles are in; step kt - 1's stage is free
    if (kt + FF_STAGES - 1 < n_k)
      fetch((kt + FF_STAGES - 1) % FF_STAGES, k0 + (FF_STAGES - 1) * BK);
    cp_async_commit();
    const int stage = kt % FF_STAGES;
    const char* a_st = As + stage * FF_MAX_BM * FF_LDS;
    const char* b_st = Bs + stage * FF_MAX_BN * FF_LDS;
    int a_off = 0;   // A_IM2COL: this step's tap offset and channel base
    if constexpr (AK == A_IM2COL) {
      const int tap = k0 / g.cseg;
      a_off = ((tap / 3) * g.pitch + tap % 3) * g.lda + (k0 - tap * g.cseg);
    }
    if constexpr (BF16) {
      // the step's two k16 halves: A fragments by ldmatrix, then per
      // (nt, mt) a fresh sum of the step's 32 products on the tensor
      // cores, added into the running f32 sum with one rounded add
      uint32_t af[2][MT][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = warp_m * MT * 16 + mt * 16 + (lane & 15);
          const int hb = kh * 32 + (lane >> 4) * 16;   // bytes into the step
          const char* p;
          if constexpr (AK == A_GLOBAL)
            p = a_st + r * FF_LDS + hb;
          else if constexpr (AK == A_SMEM)
            p = reinterpret_cast<const char*>(
                    g.as + static_cast<long long>(g.m0 + r) * g.lda + k0) + hb;
          else
            p = reinterpret_cast<const char*>(
                    g.as + rpos[mt][0] * g.lda + a_off) + hb;
          ldmatrix_x4(af[kh][mt], p);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const char* bp = b_st + (warp_n * NT * 8 + nt * 8 + gid) * FF_LDS +
                         tig * 4;
        const uint32_t b00 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b01 = *reinterpret_cast<const uint32_t*>(bp + 16);
        const uint32_t b10 = *reinterpret_cast<const uint32_t*>(bp + 32);
        const uint32_t b11 = *reinterpret_cast<const uint32_t*>(bp + 48);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, af[0][mt], b00, b01);
          mma_bf16(part, af[1][mt], b10, b11);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], part[q]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 av[MT][2], bv[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp_m * MT * 16 + mt * 16 + gid + 8 * h;
            const float* p;
            if constexpr (AK == A_GLOBAL)
              p = reinterpret_cast<const float*>(a_st + r * FF_LDS) + kk;
            else if constexpr (AK == A_SMEM)
              p = reinterpret_cast<const float*>(g.as) +
                  static_cast<long long>(g.m0 + r) * g.lda + k0 + kk;
            else
              p = reinterpret_cast<const float*>(g.as) +
                  rpos[mt][h] * g.lda + a_off + kk;
            av[mt][h] = *reinterpret_cast<const float4*>(p);
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = warp_n * NT * 8 + nt * 8 + tig * 2 + e;
            bv[nt][e] = *reinterpret_cast<const float4*>(
                b_st + col * FF_LDS + kk * 4);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 a = av[mt][q >> 1];
              const float4 b = bv[nt][q & 1];
              float s = acc[mt][nt][q];
              s = fmaf(a.x, b.x, s);
              s = fmaf(a.y, b.y, s);
              s = fmaf(a.z, b.z, s);
              s = fmaf(a.w, b.w, s);
              acc[mt][nt][q] = s;
            }
      }
    }
  }
  cp_async_wait<0>();
}

// The bias of the thread's 2*NT columns of a GEMM (0 past N), loaded once
// ahead of its values; slot j as in for_each_out.
template <int NT>
__device__ __forceinline__ void col_bias(int n0, int N, const float* bias,
                                         float (&b)[2 * NT]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int n = n0 + (warp & 3) * NT * 8 + (j >> 1) * 8 + (lane & 3) * 2 +
                  (j & 1);
    b[j] = n < N ? bias[n] : 0.0f;
  }
}

template <typename T, int MT>
__device__ __forceinline__ void conv1(const FloatArgs<T>& p, GemmF<T> g,
                                      char* As, char* Bs, T* y1s,
                                      const int* hpos, int mv) {
  for (int n0 = 0; n0 < p.cmp; n0 += 64) {
    g.n0 = n0;
    float f[MT][2][4];
    block_gemm_f<T, MT, 2, A_GLOBAL>(g, As, Bs, f);
    float cb[4];
    col_bias<2>(n0, p.Cm, p.b1, cb);
    for_each_out(n0, f, [&](int r, int n, float v, int j) {
      if (r < mv && n < p.Cm)
        y1s[hpos[r] * p.ld + n] = from_f32<T>(fmaxf(__fadd_rn(v, cb[j]), 0.0f));
    });
  }
}

template <typename T, int NT>
__device__ __forceinline__ void conv2(const FloatArgs<T>& p, GemmF<T> g,
                                      char* As, char* Bs, T* y2s, int m2) {
  for (int n0 = 0; n0 < p.cmp; n0 += 32 * NT) {
    g.n0 = n0;
    float f[2][NT][4];
    block_gemm_f<T, 2, NT, A_IM2COL>(g, As, Bs, f);
    float cb[2 * NT];
    col_bias<NT>(n0, p.Cm, p.b2, cb);
    for_each_out(n0, f, [&](int r, int n, float v, int j) {
      if (r < m2 && n < p.Cm)
        y2s[r * p.ld + n] = from_f32<T>(fmaxf(__fadd_rn(v, cb[j]), 0.0f));
    });
  }
}

// Two neighbouring elements of x as f32.
__device__ __forceinline__ float2 load2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

__device__ __forceinline__ void store_out(void* out, long long idx, float y,
                                          int out_type) {
  if (out_type == DT_BF16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[idx] = y;
}

template <typename T, int NT2, int NT3>
__global__ void __launch_bounds__(FF_THREADS, sizeof(T) == 2 ? 2 : 1)
fused_float_block_kernel(FloatArgs<T> p) {
  extern __shared__ __align__(16) char smem[];
  T* y1s = reinterpret_cast<T*>(smem);
  T* y2s = y1s + p.halo_elems;
  char* As = reinterpret_cast<char*>(y2s + FF_MAX_PIX * p.ld);
  char* Bs = As + FF_STAGES * FF_MAX_BM * FF_LDS;
  long long* hoff =
      reinterpret_cast<long long*>(Bs + FF_STAGES * FF_MAX_BN * FF_LDS);
  int* hpos = reinterpret_cast<int*>(hoff + FF_MAX_HALO);
  int* ppos = hpos + FF_MAX_HALO;
  __shared__ int s_mv;
  constexpr int BK = FF_KB / sizeof(T);

  const int tid = threadIdx.x;
  const int img = blockIdx.x / p.tiles_per_img;
  const int t = blockIdx.x - img * p.tiles_per_img;
  const int th = t / p.tiles_w;
  const int oh0 = th * p.TH;
  const int ow0 = (t - th * p.tiles_w) * p.TW;
  const int tile_h = min(p.TH, p.H - oh0);
  const int tile_w = min(p.TW, p.W - ow0);
  const int pitch = p.TW + 2;
  const int npos = (p.TH + 2) * pitch;
  const int m2 = tile_h * tile_w;

  // y1 and y2 start at 0: the halo outside the image is conv2's zero
  // padding, and the padded channels are zero K
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = static_cast<int>(
        (p.halo_elems + FF_MAX_PIX * p.ld) * sizeof(T) / 16);
    for (int i = tid; i < n16; i += FF_THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  chain_tile_rows(img, oh0, ow0, tile_h, tile_w, pitch, npos, p.H, p.W, p.C,
                  FF_MAX_PIX, hoff, hpos, ppos, &s_mv);
  __syncthreads();
  const int mv = s_mv;

  // ---- conv1: x (halo pixels) . w1 -> y1 -----------------------------
  GemmF<T> g;
  g.x = p.x;
  g.row_off = hoff;
  g.rows = mv;
  g.Kreal = p.C;
  g.as = nullptr;
  g.lda = p.ld;
  g.row_pos = ppos;
  g.pitch = pitch;
  g.cseg = p.cmp;
  g.w = p.w1;
  g.N = p.Cm;
  g.Kt = p.C;
  g.Kp = (p.C + BK - 1) / BK * BK;
  g.seg = g.Kp;
  g.real = p.C;
  g.m0 = 0;
  g.n0 = 0;
  g.vec = p.vec1;
  if (mv > 64)
    conv1<T, 4>(p, g, As, Bs, y1s, hpos, mv);
  else
    conv1<T, 2>(p, g, As, Bs, y1s, hpos, mv);

  // ---- conv2: 3x3 over y1 (implicit im2col) -> y2 ---------------------
  g.as = y1s;
  g.w = p.w2;
  g.N = p.Cm;
  g.Kt = 9 * p.Cm;
  g.seg = p.cmp;
  g.real = p.Cm;
  g.Kp = 9 * p.cmp;
  g.vec = p.vec2;
  conv2<T, NT2>(p, g, As, Bs, y2s, m2);

  // ---- conv3: y2 . w3 + shortcut -> out -------------------------------
  g.as = y2s;
  g.w = p.w3;
  g.N = p.C;
  g.Kt = p.Cm;
  g.seg = p.cmp;
  g.real = p.Cm;
  g.Kp = p.cmp;
  g.vec = p.vec3;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int n0 = 0; n0 < p.C; n0 += 32 * NT3) {
    g.n0 = n0;
    float f[2][NT3][4];
    block_gemm_f<T, 2, NT3, A_SMEM>(g, As, Bs, f);
    float cb[2 * NT3];
    col_bias<NT3>(n0, p.C, p.b3, cb);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (warp >> 2) * 32 + mt * 16 + (lane >> 2) + 8 * h;
          const int n = n0 + (warp & 3) * NT3 * 8 + nt * 8 + (lane & 3) * 2;
          if (r >= m2 || n >= p.C) continue;
          const long long idx =
              ((static_cast<long long>(img) * p.H + oh0 + r / tile_w) * p.W +
               ow0 + r % tile_w) * p.C + n;
          const float v0 = __fadd_rn(f[mt][nt][2 * h], cb[nt * 2]);
          const float v1 = __fadd_rn(f[mt][nt][2 * h + 1], cb[nt * 2 + 1]);
          if (p.pair && n + 1 < p.C) {
            const float2 xv = load2(p.x + idx);
            const float y0 = fmaxf(__fadd_rn(v0, xv.x), 0.0f);
            const float y1 = fmaxf(__fadd_rn(v1, xv.y), 0.0f);
            if (p.out_type == DT_BF16)
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(p.out) + idx) =
                  __floats2bfloat162_rn(y0, y1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) =
                  make_float2(y0, y1);
          } else {
            store_out(p.out, idx,
                      fmaxf(__fadd_rn(v0, to_f32(p.x[idx])), 0.0f),
                      p.out_type);
            if (n + 1 < p.C)
              store_out(p.out, idx + 1,
                        fmaxf(__fadd_rn(v1, to_f32(p.x[idx + 1])), 0.0f),
                        p.out_type);
          }
        }
  }
}

template <typename T, int NT2, int NT3>
int launch(const FloatArgs<T>& p, int grid, int smem, cudaStream_t s) {
  auto kern = fused_float_block_kernel<T, NT2, NT3>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, FF_THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_block(const void* x, void* out, const void* w1, const float* b1,
              const void* w2, const float* b2, const void* w3,
              const float* b3, int N, int H, int W, int C, int Cm, int TH,
              int TW, int out_type, cudaStream_t s) {
  constexpr int E = sizeof(T);
  constexpr int V = 16 / E;
  constexpr int BK = FF_KB / E;
  FloatArgs<T> p;
  p.x = static_cast<const T*>(x);
  p.out = out;
  p.w1 = static_cast<const T*>(w1);
  p.b1 = b1;
  p.w2 = static_cast<const T*>(w2);
  p.b2 = b2;
  p.w3 = static_cast<const T*>(w3);
  p.b3 = b3;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cm = Cm;
  p.TH = TH;
  p.TW = TW;
  const int tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  p.tiles_per_img = tiles_h * p.tiles_w;
  p.cmp = (Cm + BK - 1) / BK * BK;
  p.ld = p.cmp + V;
  p.halo_elems = (TH + 2) * (TW + 2) * p.ld;
  p.out_type = out_type;
  p.vec1 = C % V == 0 && aligned(x, 16) && aligned(w1, 16);
  p.vec2 = Cm % V == 0 && aligned(w2, 16);
  p.vec3 = Cm % V == 0 && aligned(w3, 16);
  const int osize = out_type == DT_BF16 ? 2 : 4;
  p.pair = C % 2 == 0 && aligned(x, 2 * E) && aligned(out, 2 * osize);
  const long long smem =
      static_cast<long long>(p.halo_elems + FF_MAX_PIX * p.ld) * E +
      FF_STAGES * (FF_MAX_BM + FF_MAX_BN) * FF_LDS +
      FF_MAX_HALO * (8 + 4) + FF_MAX_PIX * 4;
  const long long grid = static_cast<long long>(N) * p.tiles_per_img;
  if (smem > 227 * 1024 || grid >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide2 = p.cmp >= 128;
  const bool wide3 = C >= 128;
  const int gr = static_cast<int>(grid);
  const int sm = static_cast<int>(smem);
  if (wide2 && wide3) return launch<T, 4, 4>(p, gr, sm, s);
  if (wide2) return launch<T, 4, 2>(p, gr, sm, s);
  if (wide3) return launch<T, 2, 4>(p, gr, sm, s);
  return launch<T, 2, 2>(p, gr, sm, s);
}

}  // namespace
}  // namespace fcnn

// One block of a float chain.  x is (N, H, W, C) of x_type (DT_BF16 or
// DT_F32); w1, w2, w3 are the block's weights of the same type, transposed:
// (Cm, C), (Cm, 9*Cm) with k = (kh*3 + kw)*Cm + c_in, and (C, Cm); b1, b2,
// b3 f32.  out is (N, H, W, C) of out_type (DT_BF16 or DT_F32).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int fcnn_fused_block_float(
    const void* x, void* out, const void* w1, const float* b1,
    const void* w2, const float* b2, const void* w3, const float* b3, int N,
    int H, int W, int C, int Cm, int TH, int TW, int x_type, int out_type,
    void* stream) {
  using namespace fcnn;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0) return 0;
  if (TH < 1 || TW < 1 || (TH + 2) * (TW + 2) > FF_MAX_HALO ||
      TH * TW > FF_MAX_PIX || (out_type != DT_BF16 && out_type != DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == DT_BF16)
    return run_block<__nv_bfloat16>(x, out, w1, b1, w2, b2, w3, b3, N, H, W,
                                    C, Cm, TH, TW, out_type, s);
  if (x_type == DT_F32)
    return run_block<float>(x, out, w1, b1, w2, b2, w3, b3, N, H, W, C, Cm,
                            TH, TW, out_type, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
