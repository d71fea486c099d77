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
// The design, variant "wgmma" (bf16 x, every launch of the bf16 ResNet-50
// path; the host's plan, chain_plan in kernels/fused_chain.py, gives the
// tile, the tiles per thread block, the stages and the rounded-add step,
// and the kernel refuses a plan whose numbers it does not reproduce):
//  - A thread block takes two TH x TW output tiles (8x8 or 7x7) where
//    their y1 and y2 fit shared memory (stages 2-4), else one (stage 5,
//    Cm = 512).  A producer warp streams every operand through a ring of
//    stages by TMA with a 128-byte swizzle and mbarriers: the weights as
//    (N, K) K-contiguous 64-element K steps (kernel_layout), and for conv1
//    each tile's (TH+2) x (TW+2) halo of x as one 4-D box per K step (the
//    box's pixels outside the image arrive as zeros).  Each tile has its
//    own consumer warpgroup; the two share every weight tile, so the L2
//    weight bytes per output pixel are half those of the one-tile block
//    (PERF.md reckons them per launch).
//  - Every GEMM runs wgmma.m64nNk16.f32.bf16.bf16 with A in registers,
//    loaded by ldmatrix.x4 from a per-lane row address: conv1's A rows
//    are the halo pixels in the swizzled stage (two m64 tiles cover up to
//    100 of them), conv2's the 3x3 windows of y1 (a window shifted by one
//    column breaks the 8-row alignment a shared-memory descriptor needs),
//    conv3's the rows of y2; a lane past the K or the rows reads a zero
//    chunk.  B is read by descriptor from the ring.
//  - y1 (over the halo; 0 at pixels outside the image, conv2's padding)
//    and y2 stay in shared memory in T, rows of Cm plus 16 bytes, so the
//    ldmatrix rows fall in distinct banks.  conv3's epilogue adds b3 and
//    the shortcut read from x (an L2 hit after the halo's) and stores two
//    channels per access.
//  - The grid is persistent: one thread block per SM walks over pairs of
//    tiles, so the producer runs on into the next pair's operands while
//    the consumers finish the last pair's epilogue.
//  - Numerics: each slice of 128 products goes into a tensor-core sum of
//    its own, which one rounded f32 add takes into the running sum.  The
//    tensor cores' internal adds truncate; summing all of K in them puts
//    several times more bf16 outputs a step off the plain version.  Where
//    conv2's K is 9 * 512 (ResNet-50's stage 5) even 128-product slices
//    leave some launches over the float gate, so there the slices are 32
//    products and each add's rounding error is where the next slice's
//    tensor-core sum starts (a carried Fast2Sum): the running sum keeps
//    what its rounding drops (tools/float_chain_probe.py prints the
//    shares of each step, carried or not; PERF.md the ones that chose
//    these two).  Every stage ends
//    with its products done, so the slot is freed at once and the block's
//    other consumer keeps the tensor cores busy meanwhile.
// The structure carries over to the int8 mode (fused_chain.cu) as it is:
// its GEMMs take the s8 wgmma form with A in shared memory or registers.
// Not yet done: a cluster sharing the weight tiles by TMA multicast, staged
// 16-byte output stores, overlap of a consumer's consecutive K steps.
//
// Variants "mma_sync" (bf16 x with C or Cm not a multiple of 8, or a
// pointer that is not 16-byte aligned: no TMA) and "fma_f32" (f32 x, on no
// counted path) keep the earlier body: one thread block per tile, the
// GEMMs on 8 warps as 2 (M) x 4 (N), bf16 on mma.sync m16n8k16 with one
// rounded add per 32 products, f32 on FMAs, the weights through a 3-stage
// cp.async ring from L2 (an f32 block with Cm = 512 does not fit and is
// refused).
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
              int TW, int out_type, int plan_smem, cudaStream_t s) {
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
  if (smem != plan_smem || smem > 227 * 1024 || grid >= (1LL << 31))
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

// ---------------------------------------------------------------------
// Variant "wgmma": bf16 x, the counted path (see the note at the top).
// ---------------------------------------------------------------------
constexpr int FW_BK = 64;                // K elements per ring stage (128 B)
constexpr int FW_BN1 = 64;               // conv1's columns per pass
constexpr int FW_BN2 = 128;              // conv2's and conv3's
constexpr int FW_B_BYTES = 128 * 128;    // a stage's weight tile, <= 128 rows
constexpr int FW_THREADS = 384;          // producer + up to 2 consumers
// The rounded-add steps the library builds (gemm_rs): 128 products a
// slice, uncarried, and 32, carried.  chain_plan in kernels/fused_chain.py
// gives each launch one of them by Cm (FLOAT_ADD_STEPS there, which a CPU
// test holds equal to the instantiations below).  A build with
// FCNN_FLOAT_PROBE defined (tools/float_chain_probe.py) takes 32, 64 and
// 128, carried or not, and 0 (all of K in the tensor cores).

struct FloatWgArgs {
  const __nv_bfloat16* x;
  void* out;
  const float* b1;
  const float* b2;
  const float* b3;
  int N, H, W, C, Cm, TH, TW, tiles_w, tiles_per_img, tiles;
  int T;            // tiles per pair = consumer warpgroups
  int pairs;        // groups of T tiles; a persistent block walks over them
  int stages;
  int npos;         // (TH + 2) * (TW + 2): a tile's halo pixels
  int ld;           // y1 / y2 row pitch in bytes: Cm * 2 + 16
  int a_bytes;      // a tile's x halo in a stage, 1024-aligned
  int stage_bytes;  // T * a_bytes + FW_B_BYTES
  int out_type;
};

// Dynamic shared memory of the "wgmma" variant (chain_plan in
// kernels/fused_chain.py computes the same): 1024 bytes of alignment
// slack; the ring; each consumer's y1 over its halo and y2 over its tile;
// the full and empty barriers; a 16-byte zero chunk.
__host__ __device__ constexpr int fw_a_bytes(int npos) {
  return (npos * 128 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int fw_smem(int T, int stages, int npos,
                                          int thw, int ld) {
  return 1024 + stages * (T * fw_a_bytes(npos) + FW_B_BYTES) +
         T * (npos + thw) * ld + 16 * stages + 16;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int R>
__device__ __forceinline__ void fence_f32(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

struct FwRing {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  int b_off;        // the weight tile's offset in a stage
  int stages;
};

// One GEMM pass of a consumer warpgroup over k_steps ring stages: MT m64
// row tiles, BN columns, A from registers (ldmatrix.x4 at the smem address
// a_addr(stage, ks, jj, mt) gives for this lane's row and k half), B the
// stage's swizzled weight tile.  KADD: products per rounded f32 add (each
// KADD-deep slice of K goes into a tensor-core sum of its own that one
// __fadd_rn takes into acc); 0 sums all of K in the tensor cores.  CARRY:
// each add's rounding error (Fast2Sum: exact where |acc| >= |part|, which
// holds but for the first slices) is where the next slice's tensor-core
// sum starts, and the last one is added at the end, so the running sum
// loses almost nothing to its KADD-wise rounding.  Every stage ends with
// its products done (wait 0), so its slot is freed at once; the block's
// other consumer keeps the tensor cores busy meanwhile.
template <int MT, int BN, int KADD, bool CARRY, class AddrFn>
__device__ __forceinline__ void gemm_rs(float (&acc)[MT][BN / 2], int k_steps,
                                        const FwRing& rg, int& s,
                                        uint32_t& ph, AddrFn&& a_addr) {
  constexpr bool SPLIT = KADD != 0;
  constexpr int GROUP = SPLIT ? KADD / 16 : 1;   // k16 slices per add
  static_assert(!SPLIT || GROUP == 2 || GROUP == 4 || GROUP == 8, "KADD");
  float part[MT][SPLIT ? BN / 2 : 1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc[mt][i] = 0.0f;
      if constexpr (SPLIT) part[mt][i] = 0.0f;
    }
  auto add = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = part[mt][SPLIT ? i : 0];
        const float sum = __fadd_rn(acc[mt][i], p);
        if constexpr (CARRY)
          part[mt][SPLIT ? i : 0] = __fsub_rn(p, __fsub_rn(sum, acc[mt][i]));
        acc[mt][i] = sum;
      }
  };
  // one ring stage: its A fragments, its 4 x MT products into acc or, with
  // SPLIT, into part (``fresh``: the stage opens a rounded add's slice; at
  // 32 products a slice the stage's first half is added in the middle;
  // with CARRY no slice starts from zero: part holds the last add's
  // error), then the stage's slot is freed
  auto stage = [&](int ks, bool fresh) {
    mbar_wait(&rg.full[s], ph);
    uint8_t* st = rg.ring + s * rg.stage_bytes;
    const uint32_t st_u = smem_u32(st);
    uint32_t af[4][MT][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[jj][mt], a_addr(st_u, ks, jj, mt));
    const uint64_t db = wg_desc<128>(st + rg.b_off);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (SPLIT) {
          const bool open = !CARRY && (GROUP == 2 ? (jj & 1) == 0
                                                  : (fresh && jj == 0));
          wgmma_bf16_rs<BN>(part[mt], af[jj][mt], db + 2 * jj, open ? 0 : 1);
        } else {
          wgmma_bf16_rs<BN>(acc[mt], af[jj][mt], db + 2 * jj,
                            (ks > 0 || jj > 0) ? 1 : 0);
        }
      }
      if constexpr (SPLIT && GROUP == 2) {
        if (jj == 1) {   // the first 32 products of the stage are summed
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_f32(part[mt]);
          add();
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fence_f32(acc[mt]);
      if constexpr (SPLIT) fence_f32(part[mt]);
    }
    mbar_arrive(&rg.empty[s]);
    if (++s == rg.stages) { s = 0; ph ^= 1; }
  };
  if constexpr (GROUP == 8) {
    // a rounded add's 128 products span two stages
    for (int ks = 0; ks < k_steps; ks += 2) {
      stage(ks, true);
      if (ks + 1 < k_steps) stage(ks + 1, false);
      add();
    }
  } else {
    for (int ks = 0; ks < k_steps; ++ks) {
      stage(ks, true);
      if constexpr (SPLIT) add();
    }
  }
  if constexpr (SPLIT && CARRY) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        acc[mt][i] = __fadd_rn(acc[mt][i], part[mt][i]);
  }
}

template <int KADD, bool CARRY>
__global__ void __launch_bounds__(FW_THREADS, 1)
fused_float_block_kernel_wg(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w1,
                            const __grid_constant__ CUtensorMap map_w2,
                            const __grid_constant__ CUtensorMap map_w3,
                            FloatWgArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int thw = p.TH * p.TW;
  uint8_t* y1s = ring + p.stages * p.stage_bytes;
  uint8_t* y2s = y1s + p.T * p.npos * p.ld;
  uint64_t* full = reinterpret_cast<uint64_t*>(y2s + p.T * thw * p.ld);
  uint64_t* empty = full + p.stages;
  uint8_t* zero = reinterpret_cast<uint8_t*>(empty + p.stages);
  const FwRing rg{ring, full, empty, p.stage_bytes, p.T * p.a_bytes, p.stages};

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int k1 = (p.C + FW_BK - 1) / FW_BK;
  const int n1 = (p.Cm + FW_BN1 - 1) / FW_BN1;
  const int k2 = (9 * p.Cm + FW_BK - 1) / FW_BK;
  const int n2 = (p.Cm + FW_BN2 - 1) / FW_BN2;
  const int k3 = (p.Cm + FW_BK - 1) / FW_BK;
  const int n3 = (p.C + FW_BN2 - 1) / FW_BN2;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * p.T);
    }
    *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t != 0) return;
    int s = 0;
    uint32_t ph = 0;
    auto slot = [&](uint32_t bytes) {
      mbar_wait(&empty[s], ph ^ 1);
      mbar_expect_tx(&full[s], bytes);
      return ring + s * p.stage_bytes;
    };
    auto advance = [&]() { if (++s == p.stages) { s = 0; ph ^= 1; } };
    for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
    for (int np = 0; np < n1; ++np)
      for (int ks = 0; ks < k1; ++ks) {
        uint8_t* st = slot(FW_BN1 * 128 + p.T * p.npos * 128);
        tma_load_2d(st + p.T * p.a_bytes, &map_w1, ks * FW_BK, np * FW_BN1,
                    &full[s]);
        for (int cw = 0; cw < p.T; ++cw) {
          // a consumer past the last tile computes on the last one's halo
          const int tile = min(pair * p.T + cw, p.tiles - 1);
          const int img = tile / p.tiles_per_img;
          const int r = tile - img * p.tiles_per_img;
          const int th = r / p.tiles_w;
          tma_load_4d(st + cw * p.a_bytes, &map_x, ks * FW_BK,
                      (r - th * p.tiles_w) * p.TW - 1, th * p.TH - 1, img,
                      &full[s]);
        }
        advance();
      }
    for (int np = 0; np < n2; ++np)
      for (int ks = 0; ks < k2; ++ks) {
        uint8_t* st = slot(FW_B_BYTES);
        tma_load_2d(st + p.T * p.a_bytes, &map_w2, ks * FW_BK, np * FW_BN2,
                    &full[s]);
        advance();
      }
    for (int np = 0; np < n3; ++np)
      for (int ks = 0; ks < k3; ++ks) {
        uint8_t* st = slot(FW_B_BYTES);
        tma_load_2d(st + p.T * p.a_bytes, &map_w3, ks * FW_BK, np * FW_BN2,
                    &full[s]);
        advance();
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup cw owns tile pair*T + cw ----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  int s = 0;
  uint32_t ph = 0;
  for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
  const int tile = pair * p.T + cw;
  const bool valid = tile < p.tiles;
  const int tl = valid ? tile : p.tiles - 1;
  const int img = tl / p.tiles_per_img;
  const int tr = tl - img * p.tiles_per_img;
  const int tth = tr / p.tiles_w;
  const int oh0 = tth * p.TH;
  const int ow0 = (tr - tth * p.tiles_w) * p.TW;
  const int pitch = p.TW + 2;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int half = lane >> 4;      // the ldmatrix k half this lane addresses
  uint8_t* y1 = y1s + cw * p.npos * p.ld;
  uint8_t* y2 = y2s + cw * thw * p.ld;
  const uint32_t y1u = smem_u32(y1);
  const uint32_t y2u = smem_u32(y2);
  const uint32_t zu = smem_u32(zero);
  const uint32_t a_off = cw * p.a_bytes;

  // ---- conv1: x halo . w1 -> y1 (0 at halo pixels outside the image) ----
  {
    int rowoff[2], rx[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int r = mt * 64 + warp * 16 + (lane & 15);
      r = r < p.npos ? r : 0;
      rowoff[mt] = r * 128;
      rx[mt] = r & 7;
    }
    // this thread's four epilogue rows: inside the halo and the image?
    int inside = 0, hrows = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i >> 1) * 64 + warp * 16 + gid + 8 * (i & 1);
      const int hh = r / pitch;
      const int ih = oh0 - 1 + hh;
      const int iw = ow0 - 1 + (r - hh * pitch);
      if (r < p.npos) hrows |= 1 << i;
      if (valid && r < p.npos && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
        inside |= 1 << i;
    }
    for (int np = 0; np < n1; ++np) {
      float acc[2][FW_BN1 / 2];
      gemm_rs<2, FW_BN1, KADD, CARRY>(acc, k1, rg, s, ph,
          [&](uint32_t st, int, int jj, int mt) {
            return st + a_off + rowoff[mt] +
                   (((2 * jj + half) ^ rx[mt]) << 4);
          });
      float2 bv[FW_BN1 / 8];   // the biases first: sts32 orders memory
#pragma unroll
      for (int j = 0; j < FW_BN1 / 8; ++j) {
        const int n = np * FW_BN1 + j * 8 + tig * 2;
        bv[j] = n < p.Cm ? __ldg(reinterpret_cast<const float2*>(p.b1 + n))
                         : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < FW_BN1 / 8; ++j) {
        const int n = np * FW_BN1 + j * 8 + tig * 2;
        if (n >= p.Cm) continue;
        const float bb0 = bv[j].x, bb1 = bv[j].y;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!(hrows >> i & 1)) continue;
          const int r = (i >> 1) * 64 + warp * 16 + gid + 8 * (i & 1);
          const float a0 = acc[i >> 1][j * 4 + 2 * (i & 1)];
          const float a1 = acc[i >> 1][j * 4 + 2 * (i & 1) + 1];
          const bool in = inside >> i & 1;
          const float v0 = in ? fmaxf(__fadd_rn(a0, bb0), 0.0f) : 0.0f;
          const float v1 = in ? fmaxf(__fadd_rn(a1, bb1), 0.0f) : 0.0f;
          const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
          sts32(y1u + r * p.ld + n * 2, *reinterpret_cast<const uint32_t*>(&b));
        }
      }
    }
  }
  named_sync(1 + cw, 128);

  const int ar = warp * 16 + (lane & 15);   // this lane's A row (output pixel)
  const bool ar_ok = ar < thw;
  // ---- conv2: 3x3 over y1 (implicit im2col, A by ldmatrix) -> y2 --------
  {
    const int hp = (ar / p.TW) * pitch + ar % p.TW;   // window's top-left
    for (int np = 0; np < n2; ++np) {
      // this lane's K position: channel c of tap (kh, kw)
      int c = half * 8, kh = 0, kw = 0;
      while (c >= p.Cm) { c -= p.Cm; if (++kw == 3) { kw = 0; ++kh; } }
      float acc[1][FW_BN2 / 2];
      gemm_rs<1, FW_BN2, KADD, CARRY>(acc, k2, rg, s, ph,
          [&](uint32_t, int, int, int) {
            const uint32_t a = (ar_ok && kh < 3)
                ? y1u + (hp + kh * pitch + kw) * p.ld + c * 2 : zu;
            c += 16;
            while (c >= p.Cm) { c -= p.Cm; if (++kw == 3) { kw = 0; ++kh; } }
            return a;
          });
      float2 bv[FW_BN2 / 8];
#pragma unroll
      for (int j = 0; j < FW_BN2 / 8; ++j) {
        const int n = np * FW_BN2 + j * 8 + tig * 2;
        bv[j] = n < p.Cm ? __ldg(reinterpret_cast<const float2*>(p.b2 + n))
                         : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < FW_BN2 / 8; ++j) {
        const int n = np * FW_BN2 + j * 8 + tig * 2;
        if (n >= p.Cm) continue;
        const float bb0 = bv[j].x, bb1 = bv[j].y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + gid + 8 * h;
          if (r >= thw) continue;
          const __nv_bfloat162 b = __floats2bfloat162_rn(
              fmaxf(__fadd_rn(acc[0][j * 4 + 2 * h], bb0), 0.0f),
              fmaxf(__fadd_rn(acc[0][j * 4 + 2 * h + 1], bb1), 0.0f));
          sts32(y2u + r * p.ld + n * 2, *reinterpret_cast<const uint32_t*>(&b));
        }
      }
    }
  }
  named_sync(1 + cw, 128);

  // ---- conv3: y2 . w3 + b3 + shortcut -> out ----------------------------
  long long orow[2];   // element offset of this thread's two output rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
    const int oh = oh0 + r / p.TW;
    const int ow = ow0 + r % p.TW;
    orow[h] = (valid && r < thw && oh < p.H && ow < p.W)
        ? ((static_cast<long long>(img) * p.H + oh) * p.W + ow) * p.C : -1;
  }
  for (int np = 0; np < n3; ++np) {
    float acc[1][FW_BN2 / 2];
    gemm_rs<1, FW_BN2, KADD, CARRY>(acc, k3, rg, s, ph,
        [&](uint32_t, int ks, int jj, int) {
          const int c = ks * FW_BK + jj * 16 + half * 8;
          return (ar_ok && c < p.Cm) ? y2u + ar * p.ld + c * 2 : zu;
        });
    // every load of the pass first (the shortcut pairs and the biases),
    // so they are in flight together: a store to out may alias x as far
    // as the compiler knows, and would order each load behind the last
    // store
    uint32_t xr[FW_BN2 / 8][2];
    float2 bb[FW_BN2 / 8];
#pragma unroll
    for (int j = 0; j < FW_BN2 / 8; ++j) {
      const int n = np * FW_BN2 + j * 8 + tig * 2;
      const bool nok = n < p.C;
      bb[j] = nok ? __ldg(reinterpret_cast<const float2*>(p.b3 + n))
                  : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xr[j][h] = (nok && orow[h] >= 0)
            ? __ldg(reinterpret_cast<const unsigned int*>(p.x + orow[h] + n))
            : 0u;
    }
#pragma unroll
    for (int j = 0; j < FW_BN2 / 8; ++j) {
      const int n = np * FW_BN2 + j * 8 + tig * 2;
      if (n >= p.C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[h] < 0) continue;
        const long long idx = orow[h] + n;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[j][h]));
        const float y0 = fmaxf(
            __fadd_rn(__fadd_rn(acc[0][j * 4 + 2 * h], bb[j].x), xv.x), 0.0f);
        const float y1v = fmaxf(
            __fadd_rn(__fadd_rn(acc[0][j * 4 + 2 * h + 1], bb[j].y), xv.y),
            0.0f);
        if (p.out_type == DT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + idx) =
              __floats2bfloat162_rn(y0, y1v);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) =
              make_float2(y0, y1v);
      }
    }
  }
  }
}

// A TMA map over bf16 data: rank 2 (a weight (rows, K), K innermost) or 4
// (x as (C, W, H, N)), 128-byte swizzle, zero fill outside.
inline bool make_map_bf16(CUtensorMap* map, const void* base, int rank,
                          const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  cuuint64_t strides[3];
  cuuint64_t st = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    st *= dims[i];
    strides[i] = st;
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KADD, bool CARRY>
int launch_wg(const FloatWgArgs& p, const CUtensorMap* maps, int grid,
              int smem, cudaStream_t s) {
  auto kern = fused_float_block_kernel_wg<KADD, CARRY>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, 128 * (1 + p.T), smem, s>>>(maps[0], maps[1], maps[2],
                                           maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// The "wgmma" launch of one block: the plan (tile, tiles per block,
// stages, rounded-add step and its carry, shared memory, grid) checked
// against the operands and refused (cudaErrorInvalidValue) where it does
// not fit or names a step the library does not build.
int run_block_wg(const void* x, void* out, const void* w1, const float* b1,
                 const void* w2, const float* b2, const void* w3,
                 const float* b3, int N, int H, int W, int C, int Cm, int TH,
                 int TW, int out_type, int T, int stages, int kadd, int carry,
                 int smem, int grid, cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (C % 8 || Cm % 8 || T < 1 || T > 2 || stages < 2 || TW + 2 > 256 ||
      TH + 2 > 256 || !aligned(x, 16) || !aligned(out, 16) ||
      !aligned(w1, 16) || !aligned(w2, 16) || !aligned(w3, 16))
    return bad;
  FloatWgArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = out;
  p.b1 = b1;
  p.b2 = b2;
  p.b3 = b3;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cm = Cm;
  p.TH = TH;
  p.TW = TW;
  p.tiles_w = (W + TW - 1) / TW;
  p.tiles_per_img = ((H + TH - 1) / TH) * p.tiles_w;
  const long long tiles = static_cast<long long>(N) * p.tiles_per_img;
  p.T = T;
  p.stages = stages;
  p.npos = (TH + 2) * (TW + 2);
  p.ld = Cm * 2 + 16;
  p.a_bytes = fw_a_bytes(p.npos);
  p.stage_bytes = T * p.a_bytes + FW_B_BYTES;
  p.out_type = out_type;
  p.pairs = static_cast<int>((tiles + T - 1) / T);
  if (TH * TW > 64 || p.npos > 128 || tiles >= (1LL << 31) || grid < 1 ||
      grid > p.pairs ||
      fw_smem(T, stages, p.npos, TH * TW, p.ld) != smem || smem > 227 * 1024)
    return bad;
  p.tiles = static_cast<int>(tiles);
  CUtensorMap maps[4];
  const cuuint64_t dx[4] = {static_cast<cuuint64_t>(C),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(N)};
  const cuuint32_t bx[4] = {FW_BK, static_cast<cuuint32_t>(TW + 2),
                            static_cast<cuuint32_t>(TH + 2), 1};
  const cuuint64_t d1[2] = {static_cast<cuuint64_t>(C),
                            static_cast<cuuint64_t>(Cm)};
  const cuuint64_t d2[2] = {static_cast<cuuint64_t>(9 * Cm),
                            static_cast<cuuint64_t>(Cm)};
  const cuuint64_t d3[2] = {static_cast<cuuint64_t>(Cm),
                            static_cast<cuuint64_t>(C)};
  const cuuint32_t b1x[2] = {FW_BK, FW_BN1};
  const cuuint32_t b23[2] = {FW_BK, FW_BN2};
  if (!make_map_bf16(&maps[0], x, 4, dx, bx) ||
      !make_map_bf16(&maps[1], w1, 2, d1, b1x) ||
      !make_map_bf16(&maps[2], w2, 2, d2, b23) ||
      !make_map_bf16(&maps[3], w3, 2, d3, b23))
    return bad;
#ifdef FCNN_FLOAT_PROBE
  if (kadd == 0) return launch_wg<0, false>(p, maps, grid, smem, s);
  if (carry) {
    if (kadd == 32) return launch_wg<32, true>(p, maps, grid, smem, s);
    if (kadd == 64) return launch_wg<64, true>(p, maps, grid, smem, s);
    if (kadd == 128) return launch_wg<128, true>(p, maps, grid, smem, s);
  } else {
    if (kadd == 32) return launch_wg<32, false>(p, maps, grid, smem, s);
    if (kadd == 64) return launch_wg<64, false>(p, maps, grid, smem, s);
    if (kadd == 128) return launch_wg<128, false>(p, maps, grid, smem, s);
  }
#else
  if (kadd == 128 && !carry)
    return launch_wg<128, false>(p, maps, grid, smem, s);
  if (kadd == 32 && carry) return launch_wg<32, true>(p, maps, grid, smem, s);
#endif
  return bad;
}

}  // namespace
}  // namespace fcnn

// One block of a float chain.  x is (N, H, W, C) of x_type (DT_BF16 or
// DT_F32); w1, w2, w3 are the block's weights of the same type, transposed:
// (Cm, C), (Cm, 9*Cm) with k = (kh*3 + kw)*Cm + c_in, and (C, Cm); b1, b2,
// b3 f32.  out is (N, H, W, C) of out_type (DT_BF16 or DT_F32).  The plan
// (chain_plan in kernels/fused_chain.py): variant (0 "wgmma", 1
// "mma_sync", 2 "fma_f32"), tiles per block, stages, products per rounded
// add and whether its error is carried, shared memory and grid.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int fcnn_fused_block_float(
    const void* x, void* out, const void* w1, const float* b1,
    const void* w2, const float* b2, const void* w3, const float* b3, int N,
    int H, int W, int C, int Cm, int TH, int TW, int x_type, int out_type,
    int variant, int T, int stages, int kadd, int carry, int smem, int grid,
    void* stream) {
  using namespace fcnn;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0) return 0;
  if (TH < 1 || TW < 1 || (out_type != DT_BF16 && out_type != DT_F32))
    return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0 && x_type == DT_BF16)
    return run_block_wg(x, out, w1, b1, w2, b2, w3, b3, N, H, W, C, Cm, TH,
                        TW, out_type, T, stages, kadd, carry, smem, grid,
                        s);
  if ((TH + 2) * (TW + 2) > FF_MAX_HALO || TH * TW > FF_MAX_PIX) return bad;
  if (variant == 1 && x_type == DT_BF16)
    return run_block<__nv_bfloat16>(x, out, w1, b1, w2, b2, w3, b3, N, H, W,
                                    C, Cm, TH, TW, out_type, smem, s);
  if (variant == 2 && x_type == DT_F32)
    return run_block<float>(x, out, w1, b1, w2, b2, w3, b3, N, H, W, C, Cm,
                            TH, TW, out_type, smem, s);
  return bad;
}
