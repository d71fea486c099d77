// Shared pieces of the two GEMM-shaped kernels (matmul_epilogue.cu and
// conv_implicit_gemm.cu): the fused epilogue, the A-operand row fetchers
// (a plain matrix, or an NHWC image gathered as an implicit im2col), the
// int8 tensor-core main loop and the float SIMT main loop.  The depthwise
// kernels (depthwise_conv.cu) use the epilogue (epilogue_value and
// requant_i8) too, and the two fused-chain kernels (fused_chain.cu,
// fused_chain_float.cu) the cp.async helpers, the fragment walk
// (for_each_out) and the tile's row tables (chain_tile_rows).
//
// Layouts: A is (M, K) with K contiguous, B is the weight (K, N) with N
// contiguous, the output is (M, N) row-major.  For the conv, M runs over
// output pixels (n, oh, ow), K over taps (kh, kw, c) and N over output
// channels, so the output is NHWC.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fcnn {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

struct Epilogue {
  const float* w_scale;  // (N,) per-output-channel dequant scale, or null
  const float* bias;     // (N,), or null
  const float* lo;       // (N,) per-channel clamp bounds, or null (both)
  const float* hi;
  float x_scale;         // per-tensor activation scale; 1.0 skips it
  float out_scale;       // int8 output: q = rint(y * out_scale)
  int act;               // Act
  int out_type;          // DType
  void* out;             // (M, N) row-major
};

// y = act(acc * w_scale[n] * x_scale + bias[n]), then the lo/hi clamp.
// The last multiply of the scale chain and the bias add round once (an
// FMA): the reference's compiled epilogue contracts them the same way, and
// int8 outputs are held to it bit for bit.  Every other step rounds on
// its own (__fmul_rn keeps nvcc from contracting further).
__device__ __forceinline__ float epilogue_value(float acc, int n,
                                                const Epilogue& e) {
  float y = acc;
  float last = 1.0f;
  bool has_last = false;
  if (e.w_scale) {
    last = e.w_scale[n];
    has_last = true;
  }
  if (e.x_scale != 1.0f) {
    if (has_last) y = __fmul_rn(y, last);
    last = e.x_scale;
    has_last = true;
  }
  if (e.bias) {
    y = has_last ? __fmaf_rn(y, last, e.bias[n]) : __fadd_rn(y, e.bias[n]);
  } else if (has_last) {
    y = __fmul_rn(y, last);
  }
  if (e.act == ACT_RELU) {
    y = fmaxf(y, 0.0f);
  } else if (e.act == ACT_RELU6) {
    y = fminf(fmaxf(y, 0.0f), 6.0f);
  }
  if (e.lo) y = fminf(fmaxf(y, e.lo[n]), e.hi[n]);
  return y;
}

// The int8 store: round half to even (rintf, never roundf) of
// y * out_scale, saturated to +-127.
__device__ __forceinline__ int8_t requant_i8(float y, float out_scale) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, out_scale)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ void epilogue_store(float acc, long long m, int n,
                                               int N, const Epilogue& e) {
  const float y = epilogue_value(acc, n, e);
  const long long idx = m * N + n;
  if (e.out_type == DT_I8) {
    static_cast<int8_t*>(e.out)[idx] = requant_i8(y, e.out_scale);
  } else if (e.out_type == DT_BF16) {
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(e.out)[idx] = y;
  }
}

// Two neighbouring columns (c, c + 1) of row m: one 2-byte (int8) or
// 4-byte (bf16) store when both exist and the pair is aligned.
__device__ __forceinline__ void epilogue_store2(float acc0, float acc1,
                                                long long m, int c, int N,
                                                const Epilogue& e) {
  if (c + 1 < N && (N & 1) == 0 && e.out_type != DT_F32) {
    const float y0 = epilogue_value(acc0, c, e);
    const float y1 = epilogue_value(acc1, c + 1, e);
    const long long idx = m * N + c;
    if (e.out_type == DT_I8) {
      const uint16_t lo = static_cast<uint8_t>(requant_i8(y0, e.out_scale));
      const uint16_t hi = static_cast<uint8_t>(requant_i8(y1, e.out_scale));
      *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(e.out) + idx) =
          static_cast<uint16_t>(lo | (hi << 8));
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.out) + idx) =
          __floats2bfloat162_rn(y0, y1);
    }
    return;
  }
  if (c < N) epilogue_store(acc0, m, c, N, e);
  if (c + 1 < N) epilogue_store(acc1, m, c + 1, N, e);
}

// 16 bytes global -> shared memory without a register stop (cp.async);
// valid false writes 16 zero bytes.  Used by the fused-chain kernels'
// weight rings.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The fused-chain kernels' GEMMs run 8 warps as 2 (M) x 4 (N), each warp
// MT x NT tiles of 16 x 8 in the mma accumulator layout.  Calls
// fn(r, n, value, j) for every f32 result the thread holds: fragment
// (mt, nt, q) is local row r = warp_m*MT*16 + mt*16 + gid + 8*(q/2) and
// column n = n0 + warp_n*NT*8 + nt*8 + tig*2 + q%2, the thread's column
// slot j = nt*2 + q%2.
template <int MT, int NT, class Fn>
__device__ __forceinline__ void for_each_out(int n0,
                                             const float (&f)[MT][NT][4],
                                             Fn&& fn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fn((warp >> 2) * MT * 16 + mt * 16 + (lane >> 2) + 8 * (q >> 1),
           n0 + (warp & 3) * NT * 8 + nt * 8 + (lane & 3) * 2 + (q & 1),
           f[mt][nt][q], nt * 2 + (q & 1));
}

// A fused-chain thread block's row tables for its output tile at (oh0,
// ow0) of image img, the tile clipped to tile_h x tile_w inside the image
// (pitch = TW + 2, npos = (TH + 2) * pitch).  conv1's rows: the tile's
// halo pixels inside the image, compacted by warp 0 into hpos (halo
// position) and hoff (element offset of the pixel in x), their count into
// *mv.  conv2's rows: the halo position of each output pixel's 3x3 window,
// into ppos[0, max_pix).  The caller syncs before reading them.
__device__ __forceinline__ void chain_tile_rows(
    int img, int oh0, int ow0, int tile_h, int tile_w, int pitch, int npos,
    int H, int W, int C, int max_pix, long long* hoff, int* hpos, int* ppos,
    int* mv) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    int cnt = 0;
    for (int base = 0; base < npos; base += 32) {
      const int pi = base + tid;
      const int hh = pi / pitch;
      const int hw = pi - hh * pitch;
      const int ih = oh0 - 1 + hh;
      const int iw = ow0 - 1 + hw;
      const bool ok = pi < npos && hh < tile_h + 2 && hw < tile_w + 2 &&
                      ih >= 0 && ih < H && iw >= 0 && iw < W;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int slot = cnt + __popc(m & ((1u << tid) - 1u));
        hpos[slot] = pi;
        hoff[slot] = ((static_cast<long long>(img) * H + ih) * W + iw) *
                     static_cast<long long>(C);
      }
      cnt += __popc(m);
    }
    if (tid == 0) *mv = cnt;
  }
  const int m2 = tile_h * tile_w;
  for (int r = tid; r < max_pix; r += blockDim.x)
    ppos[r] = r < m2 ? (r / tile_w) * pitch + r % tile_w : 0;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------
// A-operand fetchers.  A block resolves each of its rows once into a
// RowInfo (kept in shared memory); ``offset`` then maps (row, k) to an
// element offset into the input, or returns false where the element is
// zero (ragged M or K, or a tap in the conv's zero padding).  A vector of
// V elements at k (k a multiple of V) never straddles a row of A or a tap
// of the conv: the host picks V so that K (matrix) or C (conv) is a
// multiple of it.
// ---------------------------------------------------------------------
struct RowInfo {
  long long base;  // element offset of the row (matrix) or image (conv); <0: row past M
  int ih;          // conv: top-left input row/col of the window (may be <0)
  int iw;
};

struct MatrixA {
  const char* x;
  int M, K;

  __device__ __forceinline__ RowInfo row(long long m) const {
    RowInfo r;
    r.base = m < M ? m * K : -1;
    r.ih = 0;
    r.iw = 0;
    return r;
  }
  __device__ __forceinline__ bool offset(const RowInfo& r, int k,
                                         long long* off) const {
    if (r.base < 0 || k >= K) return false;
    *off = r.base + k;
    return true;
  }
};

struct ConvA {
  const char* x;  // (N, H, W, C)
  int H, W, C, KW, sh, sw, ph, pw, OH, OW;
  int M, K;       // M = N*OH*OW, K = KH*KW*C

  __device__ __forceinline__ RowInfo row(long long m) const {
    RowInfo r;
    if (m >= M) {
      r.base = -1;
      r.ih = 0;
      r.iw = 0;
      return r;
    }
    const int ow = static_cast<int>(m % OW);
    const long long t = m / OW;
    const int oh = static_cast<int>(t % OH);
    const long long n = t / OH;
    r.base = n * H * W * C;
    r.ih = oh * sh - ph;
    r.iw = ow * sw - pw;
    return r;
  }
  __device__ __forceinline__ bool offset(const RowInfo& r, int k,
                                         long long* off) const {
    if (r.base < 0 || k >= K) return false;
    const int tap = k / C;
    const int c = k - tap * C;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    const int ih = r.ih + kh;
    const int iw = r.iw + kw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return false;
    *off = r.base + (static_cast<long long>(ih) * W + iw) * C + c;
    return true;
  }
};

// ---------------------------------------------------------------------
// int8 x int8 -> int32 on the tensor cores (mma.sync m16n8k32).
//
// Block tile 128 (M) x 64 (N), K step 64 bytes, 8 warps as 4 (M) x 2 (N);
// a warp owns 32 x 32.  The whole K accumulates in int32: exact.
//
// VEC (K or C a multiple of 16, N a multiple of 4, aligned pointers): tiles
// go global -> registers -> shared memory, double buffered, so the next
// tile's loads are in flight while the current one is multiplied.  A moves
// as 16-byte vectors; B (K, N) is transposed to (N, K) on its way into
// shared memory by a 4x4 byte transpose per thread, because the mma's B
// fragment wants 4 consecutive k of one column in a register.  Otherwise
// single bytes go straight to shared memory, one tile at a time.  Shared
// rows are padded to 80 bytes so a warp's fragment loads hit 32 distinct
// banks.
// ---------------------------------------------------------------------
constexpr int IG_BM = 128;
constexpr int IG_BN = 64;
constexpr int IG_BK = 64;
constexpr int IG_LDS = IG_BK + 16;
constexpr int IG_THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <class A, bool VEC>
__global__ void __launch_bounds__(IG_THREADS)
igemm_kernel(A a, const int8_t* __restrict__ w, int N, Epilogue e) {
  __shared__ __align__(16) int8_t As[2][IG_BM][IG_LDS];
  __shared__ __align__(16) int8_t Bs[2][IG_BN][IG_LDS];
  __shared__ RowInfo rows[IG_BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const long long m0 = static_cast<long long>(blockIdx.x) * IG_BM;
  const int n0 = blockIdx.y * IG_BN;
  const int K = a.K;

  for (int r = tid; r < IG_BM; r += IG_THREADS) rows[r] = a.row(m0 + r);
  __syncthreads();

  // VEC staging: A, two 16-byte chunks (rows tid/4 and tid/4 + 64, bytes
  // (tid%4)*16); B, one 4 (k) x 4 (n) block (k rows (tid/16)*4..+3,
  // columns (tid%16)*4..+3).
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 16;
  const int b_kb = tid >> 4;
  const int b_nb = tid & 15;
  uint4 ra0, ra1;
  uint32_t rb0, rb1, rb2, rb3;

#define FCNN_LOAD_A(dst, r, k0)                                          \
  do {                                                                   \
    long long off_;                                                      \
    if (a.offset(rows[r], (k0) + a_col, &off_))                          \
      dst = *reinterpret_cast<const uint4*>(a.x + off_);                 \
    else                                                                 \
      dst = make_uint4(0u, 0u, 0u, 0u);                                  \
  } while (0)
#define FCNN_LOAD_B(dst, j, k0)                                          \
  do {                                                                   \
    const int k_ = (k0) + b_kb * 4 + (j);                                \
    const int n_ = n0 + b_nb * 4;                                        \
    dst = (k_ < K && n_ < N)                                             \
        ? *reinterpret_cast<const uint32_t*>(                            \
              w + static_cast<long long>(k_) * N + n_)                   \
        : 0u;                                                            \
  } while (0)

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  const int n_k = (K + IG_BK - 1) / IG_BK;
  if (VEC) {
    FCNN_LOAD_A(ra0, a_row, 0);
    FCNN_LOAD_A(ra1, a_row + 64, 0);
    FCNN_LOAD_B(rb0, 0, 0);
    FCNN_LOAD_B(rb1, 1, 0);
    FCNN_LOAD_B(rb2, 2, 0);
    FCNN_LOAD_B(rb3, 3, 0);
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * IG_BK;
    const int buf = VEC ? (kt & 1) : 0;
    if (VEC) {
      // store the staged tile, then start the next tile's loads
      *reinterpret_cast<uint4*>(&As[buf][a_row][a_col]) = ra0;
      *reinterpret_cast<uint4*>(&As[buf][a_row + 64][a_col]) = ra1;
      // 4x4 byte transpose: word j holds k = kb*4 + j for n = nb*4..+3;
      // column word i holds n = nb*4 + i for k = kb*4..+3.
      const uint32_t t0 = __byte_perm(rb0, rb1, 0x5140);
      const uint32_t t1 = __byte_perm(rb0, rb1, 0x7362);
      const uint32_t t2 = __byte_perm(rb2, rb3, 0x5140);
      const uint32_t t3 = __byte_perm(rb2, rb3, 0x7362);
      *reinterpret_cast<uint32_t*>(&Bs[buf][b_nb * 4 + 0][b_kb * 4]) =
          __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(&Bs[buf][b_nb * 4 + 1][b_kb * 4]) =
          __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(&Bs[buf][b_nb * 4 + 2][b_kb * 4]) =
          __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&Bs[buf][b_nb * 4 + 3][b_kb * 4]) =
          __byte_perm(t1, t3, 0x7632);
      __syncthreads();
      if (kt + 1 < n_k) {
        FCNN_LOAD_A(ra0, a_row, k0 + IG_BK);
        FCNN_LOAD_A(ra1, a_row + 64, k0 + IG_BK);
        FCNN_LOAD_B(rb0, 0, k0 + IG_BK);
        FCNN_LOAD_B(rb1, 1, k0 + IG_BK);
        FCNN_LOAD_B(rb2, 2, k0 + IG_BK);
        FCNN_LOAD_B(rb3, 3, k0 + IG_BK);
      }
    } else {
      __syncthreads();   // the previous tile is consumed
      for (int c = tid; c < IG_BM * IG_BK; c += IG_THREADS) {
        const int r = c / IG_BK;
        const int kk = c % IG_BK;
        long long off;
        As[0][r][kk] = a.offset(rows[r], k0 + kk, &off)
            ? static_cast<int8_t>(a.x[off]) : static_cast<int8_t>(0);
      }
      for (int c = tid; c < IG_BN * IG_BK; c += IG_THREADS) {
        const int kk = c / IG_BN;
        const int nn = c % IG_BN;
        const int k = k0 + kk;
        const int n = n0 + nn;
        Bs[0][nn][kk] = (k < K && n < N)
            ? w[static_cast<long long>(k) * N + n] : static_cast<int8_t>(0);
      }
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < IG_BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + gid;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[buf][r][ks + tig * 4]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][ks + tig * 4]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[buf][r][ks + 16 + tig * 4]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp_n * 32 + nt * 8 + gid;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][ks + tig * 4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][ks + 16 + tig * 4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
      }
    }
  }
#undef FCNN_LOAD_A
#undef FCNN_LOAD_B

  const int M = a.M;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long long r0 = m0 + warp_m * 32 + mt * 16 + gid;
      const int c0 = n0 + warp_n * 32 + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r0 + h * 8;
        if (r < M) epilogue_store2(static_cast<float>(acc[mt][nt][2 * h]),
                                   static_cast<float>(acc[mt][nt][2 * h + 1]),
                                   r, c0, N, e);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Float paths (f32 x f32, bf16 x bf16, and weight-only int8 with f32 or
// bf16 activations): a plain SIMT tile, f32 accumulation.  They are not on
// the full-int8 main path; 64 x 64 tiles, 4 x 4 outputs per thread.
// ---------------------------------------------------------------------
constexpr int FG_BM = 64;
constexpr int FG_BN = 64;
constexpr int FG_BK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <class A, typename TX, typename TW>
__global__ void __launch_bounds__(256)
fgemm_kernel(A a, const TW* __restrict__ w, int N, Epilogue e) {
  __shared__ float As[FG_BK][FG_BM + 4];
  __shared__ float Bs[FG_BK][FG_BN];
  __shared__ RowInfo rows[FG_BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * FG_BM;
  const int n0 = blockIdx.y * FG_BN;
  const int K = a.K;
  const TX* x = reinterpret_cast<const TX*>(a.x);

  for (int r = tid; r < FG_BM; r += 256) rows[r] = a.row(m0 + r);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FG_BK) {
#pragma unroll
    for (int i = 0; i < FG_BM * FG_BK / 256; ++i) {
      const int c = tid + i * 256;
      const int r = c / FG_BK;
      const int kk = c % FG_BK;
      long long off;
      As[kk][r] = a.offset(rows[r], k0 + kk, &off) ? to_f32(x[off]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < FG_BN * FG_BK / 256; ++i) {
      const int c = tid + i * 256;
      const int kk = c / FG_BN;
      const int nn = c % FG_BN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N)
          ? to_f32(w[static_cast<long long>(k) * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FG_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < a.M && c < N) epilogue_store(acc[i][j], r, c, N, e);
    }
  }
}

// ---------------------------------------------------------------------
// Host-side launch over the type combinations.  Returns the launch's
// cudaError_t (0 on success).
// ---------------------------------------------------------------------
// x_type/w_type: DType.  va: 16 when A's rows can move as 16-byte vectors
// (K or C a multiple of 16 and x 16-byte aligned; the caller checks), else 1.
template <class A>
inline int launch_gemm(const A& a, const void* w, int N, int x_type,
                       int w_type, int va, const Epilogue& e,
                       cudaStream_t s) {
  if (a.M <= 0 || N <= 0) return 0;
  if (x_type == DT_I8) {
    if (w_type != DT_I8) return static_cast<int>(cudaErrorInvalidValue);
    const int8_t* wq = static_cast<const int8_t*>(w);
    const bool vec = va == 16 && N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 4 == 0;
    dim3 grid(static_cast<unsigned>((a.M + IG_BM - 1) / IG_BM),
              static_cast<unsigned>((N + IG_BN - 1) / IG_BN));
    if (vec)
      igemm_kernel<A, true><<<grid, IG_THREADS, 0, s>>>(a, wq, N, e);
    else
      igemm_kernel<A, false><<<grid, IG_THREADS, 0, s>>>(a, wq, N, e);
  } else {
    dim3 grid(static_cast<unsigned>((a.M + FG_BM - 1) / FG_BM),
              static_cast<unsigned>((N + FG_BN - 1) / FG_BN));
    if (x_type == DT_F32 && w_type == DT_F32)
      fgemm_kernel<A, float, float><<<grid, 256, 0, s>>>(
          a, static_cast<const float*>(w), N, e);
    else if (x_type == DT_F32 && w_type == DT_I8)
      fgemm_kernel<A, float, int8_t><<<grid, 256, 0, s>>>(
          a, static_cast<const int8_t*>(w), N, e);
    else if (x_type == DT_BF16 && w_type == DT_BF16)
      fgemm_kernel<A, __nv_bfloat16, __nv_bfloat16><<<grid, 256, 0, s>>>(
          a, static_cast<const __nv_bfloat16*>(w), N, e);
    else if (x_type == DT_BF16 && w_type == DT_I8)
      fgemm_kernel<A, __nv_bfloat16, int8_t><<<grid, 256, 0, s>>>(
          a, static_cast<const int8_t*>(w), N, e);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

inline Epilogue make_epilogue(void* out, const float* bias,
                              const float* w_scale, const float* lo,
                              const float* hi, int act, float x_scale,
                              float out_scale, int out_type) {
  Epilogue e;
  e.w_scale = w_scale;
  e.bias = bias;
  e.lo = lo;
  e.hi = hi;
  e.x_scale = x_scale;
  e.out_scale = out_scale;
  e.act = act;
  e.out_type = out_type;
  e.out = out;
  return e;
}

}  // namespace fcnn
