// fused_block: one identity bottleneck of a fused chain, int8 in, int8 (or
// bf16 / f32 on the chain's last block) out:
//
//   y1  = q8(relu(acc(x . w1) * (w1s*sx) + b1) * inv_sy1)          1x1, C -> Cm
//   y2  = q8(relu(acc(conv3x3(y1, pad 1)) * (w2s*sy1) + b2) * inv_sy2)  Cm -> Cm
//   out = relu(acc(y2 . w3) * (w3s*sy2) + b3 + f32(x)*sx) -> q8(. * out_scale)
//
// Replaces the Pallas kernel feathercnn_tpu/kernels/fused_chain.py:264
// (fused_chain; bodies _chain_kernel :148-194 and _block_math :54-145) in
// its int8 mode.  The wrapper (kernels/fused_chain.py) launches this kernel
// once per block of the chain; between two blocks the activation goes
// through device memory as int8 at the next block's input scale, the same
// requant the TPU kernel does in VMEM, so no value changes.
//
// Rounding, step for step as the reference's compiled kernel (the CPU tests
// hold the plain version to it bit for bit): every int8 product sum is
// exact int32; each "acc * s + b" is one FMA (__fmaf_rn) with s the f32
// product w_s[n] * scale; q8 is rintf of one f32 multiply, saturated to
// +-127.  Conv2 turns its int32 sum to f32 once where Cm <= 128; above, the
// reference sums nine per-tap int32 dots in f32 (kh outer, kw inner), so the
// kernel flushes its int32 sums into f32 sums once per tap in that order.
// The shortcut's "+ f32(x)*sx" is a second FMA on the chain's first block
// and a separate product and add on the later ones (shortcut_fma), as the
// reference's compiled code has it.
//
// What bounds it on an H100 SXM: 2*H*W*(2*C*Cm + 9*Cm^2) int8 operations a
// pixel against 1,979 TOP/s, and x read plus the output written against
// 3.35 TB/s.  At ResNet-50's stages (C = 4*Cm) that is 2*Cm*(2*C*Cm +
// 9*Cm^2) / (2*C) = 4.25*Cm operations per byte: 272 at stage 2 (bound by
// bytes), 544 at stage 3, 1,088 and 2,176 at stages 4 and 5 (bound by the
// tensor cores; the card needs ~590 per byte).  A b128 block is 55.9 GOP at
// every stage, 0.0283 ms of tensor-core time; the per-block design also
// moves 2*|x| a block (0.123 ms at stage 2).
//
// The design, variant "wgmma" (C and Cm multiples of 16, 16-byte aligned
// pointers: every launch of the int8 ResNet-50 path).  The host's plan
// (chain_plan in kernels/fused_chain.py) gives the 8x8 or 7x7 output tile,
// the tiles per work item, the ring's stages, the shared memory and the
// grid; the launch refuses a plan whose numbers it does not reproduce.
//  - A producer warp streams every operand through a ring of stages by TMA
//    with a 128-byte swizzle and mbarriers: the weights as (N, K)
//    K-contiguous tiles of 128-byte K steps (kernel_layout), and for conv1
//    each tile's (TH+2) x (TW+2) halo of x as one 4-D box of 128 channels
//    per K step, its pixels outside the image arriving as zeros.
//  - Two consumer warpgroups (288 threads with the producer warp: 168
//    registers a thread).  With at least 8 x 132 tiles in the launch
//    (stages 2-3 at b128) a work item is two tiles, one per consumer,
//    sharing every weight tile (half the L2 weight bytes of one tile per
//    block).  With fewer (stages 4-5: 512 and 128 tiles) a work item is one
//    tile, and the consumers split its columns: each takes every other
//    pass of y1's Cm columns, a barrier, the same of y2's, a barrier, then
//    every other pass of conv3's C; a ring stage then holds one halo and
//    both consumers' weight tiles.
//  - Every GEMM runs wgmma.m64nNk32.s32.s8.s8, B by descriptor from the
//    ring.  conv1's A is the halo in the ring stage itself, whose 128-byte
//    swizzled rows a descriptor reads (two m64 tiles cover 81 or 100 rows);
//    with no A registers, one stage's products stay in flight while the
//    next stage is waited for.  conv2's A rows are the 3x3 windows of y1 (a
//    window shifted by one column breaks the 8-row alignment a descriptor
//    needs) and conv3's the rows of y2, both in registers by ldmatrix.x4
//    (its b16 8x8 pieces are the s8 m16n8k32 A fragment); a lane past the
//    K or the rows reads a zero chunk.  Those stages end with their
//    products done: loading the next stage's A registers under a wgmma in
//    flight makes ptxas serialize every wgmma.  Passes are 64 columns
//    where Cm <= 64, else 128 (conv3: 128).
//  - y1 (0 at halo pixels outside the image: conv2's zero padding, not the
//    q8(relu(b1)) that conv1 of the halo's zero fill gives) and y2 stay in
//    shared memory as int8, rows of Cm + 16 bytes, so the ldmatrix rows
//    fall in distinct banks.  conv3's shortcut rows of x come by cp.async
//    under the pass's GEMM; its outputs leave through the same staged rows,
//    64 columns at a time, as 16-byte row pieces (int8, bf16; f32 in
//    pairs).  The requants of the epilogues take y >= 0 (past the ReLU):
//    min(y*s, 127) + 1.5 * 2^23 leaves rint in the low byte, with no
//    conversion unit.
//  - The grid is persistent: one thread block per SM walks over the work
//    items, so the producer runs on into the next item's operands while
//    the consumers finish this one's epilogue.
//  - Exact sums: every product sum is int32.  Where Cm > 128 (stages 4 and
//    5) conv2's K is cut into taps of whole ring stages (a tap's K padded
//    to 128-byte steps, its A zero past Cm), and each tap's int32 sum goes
//    into a running f32 sum with one __fadd_rn, in the reference's order.
// Not yet done: overlap of conv2's and conv3's consecutive stages (A from
// shared memory by descriptor: y2 in the swizzled layout, y1's windows
// only with 8-wide tiles and a channel-chunk-major layout), a cluster
// sharing the weight tiles by TMA multicast, conv1's halo rows padded from
// 81 or 100 to 128 (1.24x the useful tensor work at 8x8, 1.61x at 7x7),
// more than two consumers (the epilogues bound stage 2).
//
// Variant "mma_sync" (C or Cm not a multiple of 16, or a pointer that is
// not 16-byte aligned: no TMA) keeps the first body: one thread block of
// 8 warps per (image, TH x TW output tile), tile_plan's 8x8 or 7x7.  conv1
// runs over the tile's halo at the pixels inside the image and writes y1
// as int8 into shared memory (the rest of the halo stays 0); conv2 reads y1
// as an implicit im2col (each tap's channels padded to 64), conv3 reads y2
// and adds the shortcut from x in device memory (an L2 hit), its x and
// output rows moving as 16-byte pieces through the idle A ring where C is a
// multiple of 16 and the output int8 or bf16.  Each GEMM is the int8
// mma.sync m16n8k32 path of gemm_common.cuh, 2 (M) x 4 (N) warps, 64
// K-bytes a step, the weights through a 3-stage cp.async ring from L2
// (16-byte copies where C and Cm are multiples of 16, else a masked byte
// path).
#include "gemm_common.cuh"

namespace fcnn {
namespace {

constexpr int FB_THREADS = 256;
constexpr int FB_BK = 64;               // K bytes per step
constexpr int FB_LDS = FB_BK + 16;      // staged row pitch: 80 bytes
constexpr int FB_MAX_HALO = 128;        // (TH + 2) * (TW + 2)
constexpr int FB_MAX_PIX = 64;          // TH * TW
constexpr int FB_MAX_BM = 128;
constexpr int FB_MAX_BN = 128;
constexpr int FB_STAGES = 3;          // cp.async ring depth

enum { A_GLOBAL = 0, A_IM2COL = 1, A_SMEM = 2 };

struct BlockArgs {
  const int8_t* x;
  void* out;
  const int8_t* w1;     // the weights transposed: (N, K), K contiguous
  const float* b1;
  const float* w1s;
  const int8_t* w2;
  const float* b2;
  const float* w2s;
  const int8_t* w3;
  const float* b3;
  const float* w3s;
  int N, H, W, C, Cm, TH, TW, tiles_w, tiles_per_img;
  int cmp;         // Cm rounded up to 64: channels a tap holds in y1s/y2s
  int ld;          // cmp + 16: row pitch of y1s and y2s
  int halo_bytes;  // (TH + 2) * (TW + 2) * ld
  float sx, sy1, sy2, inv_sy1, inv_sy2, out_scale;
  int shortcut_fma;
  int out_type;
  int vec1, vec2, vec3;  // the conv's operands take vector loads
  int staged3;           // conv3's x and output rows move as 16-byte pieces
};

// One GEMM of the block: (BM x Kp) . (Kp x BN) into f32 sums.
//
// A is one of: A_GLOBAL, rows of x at the pixels row_off[m0 + r] (K = C,
// masked past Kreal), staged through shared memory; A_IM2COL, the 3x3
// windows of y1 in shared memory (row r's window starts at halo position
// row_pos[r], tap t of a K step at (t / 3) * pitch + t % 3); A_SMEM, rows of
// y2 in shared memory.
//
// B is the transposed weight (N x Kt, K contiguous) seen through a padded
// K: padded kp is real k (kp / seg) * real + kp % seg where kp % seg < real,
// else zero.  The int32 sums turn into the f32 sums once at the end,
// or (TAPS) are added into them at the end of every tap of conv2.
struct GemmArgs {
  const int8_t* x;
  const long long* row_off;
  int rows;
  int Kreal;
  const int8_t* as;
  int lda;
  const int* row_pos;
  int pitch;
  int cseg;
  const int8_t* w;
  int N;
  int Kt;          // real K: the row length of the transposed weight
  int seg;
  int real;
  int Kp;
  int m0;
  int n0;
  int vec;
};

template <int MT, int NT, int AK, bool TAPS>
__device__ __forceinline__ void block_gemm(const GemmArgs& g, int8_t* As,
                                           int8_t* Bs,
                                           float (&facc)[MT][NT][4]) {
  constexpr int BM = 2 * MT * 16;
  constexpr int BN = 4 * NT * 8;
  constexpr int AV = BM / 64;        // A: 16-byte chunks per thread
  constexpr int BV = BN / 64;        // B: 16-byte chunks per thread
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
  if constexpr (TAPS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) facc[mt][nt][q] = 0.0f;
  }

  int rpos[MT][2];
  if constexpr (AK == A_IM2COL) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rpos[mt][h] = g.row_pos[g.m0 + warp_m * MT * 16 + mt * 16 + gid + 8 * h];
  }

  // one K step's tiles, global -> shared memory: 16-byte cp.async where C
  // and Cm are multiples of 16, else single bytes.  B is the transposed
  // weight (n, k): padded k runs over segments of `seg` of which the first
  // `real` are real rows.
  auto fetch = [&](int stage, int k0) {
    int8_t* a_st = As + stage * FB_MAX_BM * FB_LDS;
    int8_t* b_st = Bs + stage * FB_MAX_BN * FB_LDS;
    if (g.vec) {
      if constexpr (AK == A_GLOBAL) {
#pragma unroll
        for (int i = 0; i < AV; ++i) {
          const int v = tid + i * FB_THREADS;
          const int r = v >> 2;
          const int k = k0 + (v & 3) * 16;
          const bool ok = g.m0 + r < g.rows && k < g.Kreal;
          cp_async16(a_st + r * FB_LDS + (v & 3) * 16,
                     ok ? g.x + g.row_off[g.m0 + r] + k : g.x, ok);
        }
      }
#pragma unroll
      for (int i = 0; i < BV; ++i) {
        const int v = tid + i * FB_THREADS;
        const int nn = v >> 2;
        const int kp = k0 + (v & 3) * 16;
        const int s = kp / g.seg;
        const int c = kp - s * g.seg;
        const int n = g.n0 + nn;
        const bool ok = c < g.real && n < g.N;
        cp_async16(b_st + nn * FB_LDS + (v & 3) * 16,
                   ok ? g.w + static_cast<long long>(n) * g.Kt + s * g.real + c
                      : g.w, ok);
      }
    } else {
      if constexpr (AK == A_GLOBAL) {
        for (int e = tid; e < BM * FB_BK; e += FB_THREADS) {
          const int r = e / FB_BK;
          const int kk = e - r * FB_BK;
          const int k = k0 + kk;
          a_st[r * FB_LDS + kk] = (g.m0 + r < g.rows && k < g.Kreal)
              ? g.x[g.row_off[g.m0 + r] + k] : static_cast<int8_t>(0);
        }
      }
      for (int e = tid; e < BN * FB_BK; e += FB_THREADS) {
        const int nn = e / FB_BK;
        const int kk = e - nn * FB_BK;
        const int kp = k0 + kk;
        const int s = kp / g.seg;
        const int c = kp - s * g.seg;
        const int n = g.n0 + nn;
        b_st[nn * FB_LDS + kk] = (c < g.real && n < g.N)
            ? g.w[static_cast<long long>(n) * g.Kt + s * g.real + c]
            : static_cast<int8_t>(0);
      }
    }
  };

  __syncthreads();   // the previous GEMM's tiles are consumed
  const int n_k = g.Kp / FB_BK;
#pragma unroll
  for (int s = 0; s < FB_STAGES - 1; ++s) {
    if (s < n_k) fetch(s, s * FB_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * FB_BK;
    cp_async_wait<FB_STAGES - 2>();
    __syncthreads();   // step kt's tiles are in; step kt - 1's stage is free
    if (kt + FB_STAGES - 1 < n_k)
      fetch((kt + FB_STAGES - 1) % FB_STAGES, k0 + (FB_STAGES - 1) * FB_BK);
    cp_async_commit();
    const int stage = kt % FB_STAGES;
    const int8_t* a_st = As + stage * FB_MAX_BM * FB_LDS;
    const int8_t* b_st = Bs + stage * FB_MAX_BN * FB_LDS;
    int a_off = 0;   // A_IM2COL: this step's tap offset and channel base
    if constexpr (AK == A_IM2COL) {
      const int tap = k0 / g.cseg;
      a_off = ((tap / 3) * g.pitch + tap % 3) * g.lda + (k0 - tap * g.cseg);
    }
#pragma unroll
    for (int ks = 0; ks < FB_BK; ks += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = warp_m * MT * 16 + mt * 16 + gid;
        const int8_t* p0;
        const int8_t* p1;
        if constexpr (AK == A_GLOBAL) {
          p0 = a_st + r * FB_LDS + ks;
          p1 = p0 + 8 * FB_LDS;
        } else if constexpr (AK == A_SMEM) {
          p0 = g.as + (g.m0 + r) * g.lda + k0 + ks;
          p1 = p0 + 8 * g.lda;
        } else {
          p0 = g.as + rpos[mt][0] * g.lda + a_off + ks;
          p1 = g.as + rpos[mt][1] * g.lda + a_off + ks;
        }
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p0 + tig * 4);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p1 + tig * 4);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 16 + tig * 4);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 16 + tig * 4);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp_n * NT * 8 + nt * 8 + gid;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            b_st + col * FB_LDS + ks + tig * 4);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            b_st + col * FB_LDS + ks + 16 + tig * 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_s8(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
      }
    }
    if constexpr (TAPS) {
      if ((k0 + FB_BK) % g.cseg == 0) {   // the end of a tap
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              facc[mt][nt][q] = __fadd_rn(
                  facc[mt][nt][q], static_cast<float>(acc[mt][nt][q]));
              acc[mt][nt][q] = 0;
            }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!TAPS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          facc[mt][nt][q] = static_cast<float>(acc[mt][nt][q]);
  }
}

// The epilogue's per-column constants of the thread's 2*NT columns, loaded
// once ahead of its values: s[j] = w_s[n] * scale (one f32 product) and
// b[j] = bias[n]; 0 past N.
template <int NT>
__device__ __forceinline__ void col_consts(int n0, int N, const float* ws,
                                           float scale, const float* bias,
                                           float (&s)[2 * NT],
                                           float (&b)[2 * NT]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int n = n0 + (warp & 3) * NT * 8 + (j >> 1) * 8 + (lane & 3) * 2 +
                  (j & 1);
    s[j] = n < N ? __fmul_rn(ws[n], scale) : 0.0f;
    b[j] = n < N ? bias[n] : 0.0f;
  }
}

template <int MT>
__device__ __forceinline__ void conv1(const BlockArgs& p, GemmArgs g,
                                      int8_t* As, int8_t* Bs, int8_t* y1s,
                                      const int* hpos, int mv) {
  for (int n0 = 0; n0 < p.cmp; n0 += 64) {
    g.n0 = n0;
    float f[MT][2][4];
    block_gemm<MT, 2, A_GLOBAL, false>(g, As, Bs, f);
    float cs[4], cb[4];
    col_consts<2>(n0, p.Cm, p.w1s, p.sx, p.b1, cs, cb);
    for_each_out(n0, f, [&](int r, int n, float v, int j) {
      if (r < mv && n < p.Cm) {
        const float y = fmaxf(__fmaf_rn(v, cs[j], cb[j]), 0.0f);
        y1s[hpos[r] * p.ld + n] = requant_i8(y, p.inv_sy1);
      }
    });
  }
}

// conv2's GEMM over y1 and its epilogue into y2; TAPS: the int32 sums go
// into f32 once per tap (Cm > 128), else once at the end.
template <int NT, bool TAPS>
__device__ __forceinline__ void conv2(const BlockArgs& p, GemmArgs g,
                                      int8_t* As, int8_t* Bs, int8_t* y2s,
                                      int m2) {
  for (int n0 = 0; n0 < p.cmp; n0 += 32 * NT) {
    g.n0 = n0;
    float f[2][NT][4];
    block_gemm<2, NT, A_IM2COL, TAPS>(g, As, Bs, f);
    float cs[2 * NT], cb[2 * NT];
    col_consts<NT>(n0, p.Cm, p.w2s, p.sy1, p.b2, cs, cb);
    for_each_out(n0, f, [&](int r, int n, float v, int j) {
      if (r < m2 && n < p.Cm) {
        const float y = fmaxf(__fmaf_rn(v, cs[j], cb[j]), 0.0f);
        y2s[r * p.ld + n] = requant_i8(y, p.inv_sy2);
      }
    });
  }
}

template <int NT2, int NT3>
__global__ void __launch_bounds__(FB_THREADS, 2)
fused_block_kernel(BlockArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* y1s = smem;
  int8_t* y2s = y1s + p.halo_bytes;
  int8_t* As = y2s + FB_MAX_PIX * p.ld;
  int8_t* Bs = As + FB_STAGES * FB_MAX_BM * FB_LDS;
  long long* hoff =
      reinterpret_cast<long long*>(Bs + FB_STAGES * FB_MAX_BN * FB_LDS);
  int* hpos = reinterpret_cast<int*>(hoff + FB_MAX_HALO);
  int* ppos = hpos + FB_MAX_HALO;
  __shared__ int s_mv;

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
    const int n16 = (p.halo_bytes + FB_MAX_PIX * p.ld) / 16;
    for (int i = tid; i < n16; i += FB_THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  chain_tile_rows(img, oh0, ow0, tile_h, tile_w, pitch, npos, p.H, p.W, p.C,
                  FB_MAX_PIX, hoff, hpos, ppos, &s_mv);
  __syncthreads();
  const int mv = s_mv;

  // ---- conv1: x (halo pixels) . w1 -> y1 -----------------------------
  GemmArgs g;
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
  g.Kp = (p.C + FB_BK - 1) / FB_BK * FB_BK;
  g.seg = g.Kp;
  g.real = p.C;
  g.m0 = 0;
  g.n0 = 0;
  g.vec = p.vec1;
  if (mv > 64)
    conv1<4>(p, g, As, Bs, y1s, hpos, mv);
  else
    conv1<2>(p, g, As, Bs, y1s, hpos, mv);

  // ---- conv2: 3x3 over y1 (implicit im2col) -> y2 ---------------------
  g.as = y1s;
  g.w = p.w2;
  g.N = p.Cm;
  g.Kt = 9 * p.Cm;
  g.seg = p.cmp;
  g.real = p.Cm;
  g.Kp = 9 * p.cmp;
  g.vec = p.vec2;
  if (p.Cm > 128)
    conv2<NT2, true>(p, g, As, Bs, y2s, m2);
  else
    conv2<NT2, false>(p, g, As, Bs, y2s, m2);

  // ---- conv3: y2 . w3 + shortcut -> out -------------------------------
  // the element index in x and out of the tile's pixel r, channel n
  auto out_index = [&](int r, int n) {
    return ((static_cast<long long>(img) * p.H + oh0 + r / tile_w) * p.W +
            ow0 + r % tile_w) * p.C + n;
  };
  g.as = y2s;
  g.w = p.w3;
  g.N = p.C;
  g.Kt = p.Cm;
  g.seg = p.cmp;
  g.real = p.Cm;
  g.Kp = p.cmp;
  g.vec = p.vec3;
  float cs[2 * NT3], cb[2 * NT3];
  // the output value from an f32 sum in column slot j and its x
  auto out_value = [&](float v, int j, float xv) {
    const float t3 = __fmaf_rn(v, cs[j], cb[j]);
    const float y = p.shortcut_fma ? __fmaf_rn(xv, p.sx, t3)
                                   : __fadd_rn(t3, __fmul_rn(xv, p.sx));
    return fmaxf(y, 0.0f);
  };
  constexpr int BN3 = 32 * NT3;
  // staged: the chunk's x and output rows move as 16-byte pieces through
  // the (now idle) A ring, so device memory sees whole rows, not bytes
  const int osize = p.out_type == DT_I8 ? 1 : 2;
  const int xld = BN3 + 16;
  const int old = BN3 * osize + 16;
  int8_t* xs_t = As;
  int8_t* os_t = As + FB_MAX_PIX * xld;
  for (int n0 = 0; n0 < p.C; n0 += BN3) {
    g.n0 = n0;
    if (p.staged3) {
      __syncthreads();   // the previous chunk's rows are out
      for (int i = tid; i < m2 * (BN3 / 16); i += FB_THREADS) {
        const int r = i / (BN3 / 16);
        const int c = (i - r * (BN3 / 16)) * 16;
        if (n0 + c < p.C)
          *reinterpret_cast<uint4*>(xs_t + r * xld + c) =
              *reinterpret_cast<const uint4*>(p.x + out_index(r, n0 + c));
      }
    }
    float f[2][NT3][4];
    block_gemm<2, NT3, A_SMEM, false>(g, As, Bs, f);
    col_consts<NT3>(n0, p.C, p.w3s, p.sy2, p.b3, cs, cb);
    if (p.staged3) {
      for_each_out(n0, f, [&](int r, int n, float v, int j) {
        if (r < m2 && n < p.C) {
          const int c = n - n0;
          const float y = out_value(
              v, j, static_cast<float>(xs_t[r * xld + c]));
          if (p.out_type == DT_I8)
            os_t[r * old + c] = requant_i8(y, p.out_scale);
          else
            *reinterpret_cast<__nv_bfloat16*>(os_t + r * old + 2 * c) =
                __float2bfloat16_rn(y);
        }
      });
      __syncthreads();
      const int pieces = BN3 * osize / 16;
      for (int i = tid; i < m2 * pieces; i += FB_THREADS) {
        const int r = i / pieces;
        const int c = (i - r * pieces) * 16;   // bytes into the row
        if (n0 + c / osize < p.C)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) +
                                    out_index(r, n0) * osize + c) =
              *reinterpret_cast<const uint4*>(os_t + r * old + c);
      }
    } else {
      for_each_out(n0, f, [&](int r, int n, float v, int j) {
        if (r < m2 && n < p.C) {
          const long long idx = out_index(r, n);
          const float y = out_value(v, j, static_cast<float>(p.x[idx]));
          if (p.out_type == DT_I8)
            static_cast<int8_t*>(p.out)[idx] = requant_i8(y, p.out_scale);
          else if (p.out_type == DT_BF16)
            static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
          else
            static_cast<float*>(p.out)[idx] = y;
        }
      });
    }
  }
}

template <int NT2, int NT3>
int launch(const BlockArgs& p, int grid, int smem, cudaStream_t s) {
  auto kern = fused_block_kernel<NT2, NT3>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, FB_THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The "mma_sync" launch of one block: the plan's shared memory and grid
// checked against the operands.
int run_block_mma(const BlockArgs& p0, int plan_smem, int plan_grid,
                  cudaStream_t s) {
  BlockArgs p = p0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((p.TH + 2) * (p.TW + 2) > FB_MAX_HALO || p.TH * p.TW > FB_MAX_PIX)
    return bad;
  const int tiles_h = (p.H + p.TH - 1) / p.TH;
  p.tiles_w = (p.W + p.TW - 1) / p.TW;
  p.tiles_per_img = tiles_h * p.tiles_w;
  p.cmp = (p.Cm + 63) / 64 * 64;
  p.ld = p.cmp + 16;
  p.halo_bytes = (p.TH + 2) * (p.TW + 2) * p.ld;
  p.vec1 = p.C % 16 == 0 && aligned(p.x, 16) && aligned(p.w1, 16);
  p.vec2 = p.Cm % 16 == 0 && aligned(p.w2, 16);
  p.vec3 = p.Cm % 16 == 0 && aligned(p.w3, 16);
  p.staged3 = p.C % 16 == 0 && p.out_type != DT_F32 && aligned(p.x, 16) &&
              aligned(p.out, 16);
  const long long smem =
      static_cast<long long>(p.halo_bytes) + FB_MAX_PIX * p.ld +
      FB_STAGES * (FB_MAX_BM + FB_MAX_BN) * FB_LDS +
      FB_MAX_HALO * (8 + 4) + FB_MAX_PIX * 4;
  const long long grid = static_cast<long long>(p.N) * p.tiles_per_img;
  if (smem != plan_smem || grid != plan_grid || smem > 227 * 1024 ||
      grid >= (1LL << 31))
    return bad;
  const bool wide2 = p.cmp >= 128;
  const bool wide3 = p.C >= 128;
  const int gr = static_cast<int>(grid);
  const int sm = static_cast<int>(smem);
  if (wide2 && wide3) return launch<4, 4>(p, gr, sm, s);
  if (wide2) return launch<4, 2>(p, gr, sm, s);
  if (wide3) return launch<2, 4>(p, gr, sm, s);
  return launch<2, 2>(p, gr, sm, s);
}

// ---------------------------------------------------------------------
// Variant "wgmma": C and Cm multiples of 16, 16-byte aligned pointers, the
// counted path (see the note at the top).
// ---------------------------------------------------------------------
constexpr int CW_BK = 128;               // K bytes per ring stage
constexpr int CW_BN3 = 128;              // conv3's columns per pass
constexpr int CW_B_BYTES = 128 * 128;    // a stage's weight tile, <= 128 rows
constexpr int CW_THREADS = 288;          // 2 consumer warpgroups + a producer
                                         // warp (168 registers a thread: one
                                         // register quadrant holds 3 warps)
constexpr int CW_SPITCH = 64 * 2 + 16;   // a staged output row: 64 columns
                                         // of bf16 (or int8) + 16 bytes

struct ChainWgArgs {
  const int8_t* x;
  void* out;
  const float* b1;
  const float* w1s;
  const float* b2;
  const float* w2s;
  const float* b3;
  const float* w3s;
  int N, H, W, C, Cm, TH, TW, tiles_w, tiles_per_img, tiles;
  int T;            // tiles per work item: 2 (one per consumer), or 1 whose
                    // columns the two consumers split
  int items;        // work items; a persistent block walks over them
  int stages;
  int npos;         // (TH + 2) * (TW + 2): a tile's halo pixels
  int thw;          // TH * TW
  int ld;           // y1 / y2 row pitch in bytes: Cm + 16
  int a_bytes;      // a tile's x halo in a stage, 1024-aligned
  int na, nb;       // x halos and weight tiles per stage: (2, 1) or (1, 2)
  int stage_bytes;  // na * a_bytes + nb * CW_B_BYTES
  int n1, n2, n3;   // column passes of conv1 and conv2 (BNM wide), conv3
  int k1, k2, k3;   // ring stages per pass
  int spt;          // conv2's stages per tap where Cm > 128 (each tap's K
                    // padded to whole stages), else 0
  float sx, sy1, sy2, inv_sy1, inv_sy2, out_scale;
  int shortcut_fma;
  int out_type;
};

// Dynamic shared memory of the "wgmma" variant (chain_plan in
// kernels/fused_chain.py computes the same, and the launch refuses a plan
// whose count differs): 1024 bytes of alignment slack; the ring, each stage
// two tiles' x halos and a weight tile (T = 2) or one halo and two weight
// tiles (T = 1); per tile y1 over the halo and y2 over the tile, rows of
// Cm + 16 bytes; each consumer's staged output rows; the full and empty
// barriers; a 16-byte zero chunk.
__host__ __device__ constexpr int cw_a_bytes(int npos) {
  return (npos * 128 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int cw_smem(int T, int stages, int npos,
                                          int thw, int ld) {
  return 1024 + stages * (T * cw_a_bytes(npos) + (3 - T) * CW_B_BYTES) +
         T * (npos + thw) * ld + 2 * thw * CW_SPITCH + 16 * stages + 16;
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two neighbouring per-column constants (read-only, 8-byte aligned).  The
// load is volatile so that the compiler does not hoist every column's pair
// of an unrolled epilogue ahead of its stores, where they would all be
// live at once beside the accumulators.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// q8 of y >= 0 (past a ReLU) at a positive scale, as requant_i8 rounds it
// (rint of one f32 multiply, saturated at 127), for a byte in the low 8
// bits of the result: min(t, 127) first (rint(min(t, 127)) is min(rint(t),
// 127) for an integer bound), then t + 1.5 * 2^23 rounds t half to even
// into the low mantissa bits.  No conversion unit and no masking: pack2
// takes the low bytes.
__device__ __forceinline__ uint32_t q8_relu(float y, float scale) {
  return __float_as_uint(
      __fadd_rn(fminf(__fmul_rn(y, scale), 127.0f), 12582912.0f));
}

// The low bytes of a and b as the two bytes of a 16-bit value.
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x0040;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

struct CwRing {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  int stages;
};

// One GEMM pass of a consumer warpgroup over k_steps ring stages (conv2's
// and conv3's): one m64 row tile, BN columns, A from registers
// (ldmatrix.x4 at the shared address a_addr(ks, jj) gives for this lane's
// row and 16-byte k half), B the stage's swizzled weight tile at b_off.
// The sum is int32, exact.  Every stage ends with its products done, so
// its slot is freed at once; the block's other consumer keeps the tensor
// cores busy meanwhile.  (Loading the next stage's A while this stage's
// products are in flight makes ptxas serialize every wgmma: an A register
// written by another instruction inside a wgmma pipeline stage.)  TAPS
// (conv2 where Cm > 128): every spt stages end a tap, whose int32 sum goes
// into the f32 sum fs with one __fadd_rn (fs starts at 0: 0 + f32(sum) is
// f32(sum)), kh outer and kw inner, as the reference's nine per-tap dots;
// the next tap's first wgmma overwrites the int32 sum (scale_d 0).
template <int BN, bool TAPS, class AddrFn>
__device__ __forceinline__ void gemm_s8(int (&acc)[BN / 2],
                                        float (&fs)[TAPS ? BN / 2 : 1],
                                        int k_steps, int spt, const CwRing& rg,
                                        int b_off, int& s, uint32_t& ph,
                                        AddrFn&& a_addr) {
  // Both sums start at 0 though the first wgmma overwrites acc: read
  // before a write, the compiler would carry them from one call to the
  // next and hold every GEMM's sums live across the whole kernel.
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0;
    if constexpr (TAPS) fs[i] = 0.0f;
  }
  for (int ks = 0; ks < k_steps; ++ks) {
    mbar_wait(&rg.full[s], ph);
    uint8_t* st = rg.ring + s * rg.stage_bytes;
    uint32_t af[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ldsm4(af[jj], a_addr(ks, jj));
    const uint64_t db = wg_desc<128>(st + b_off);
    const int kt = TAPS ? ks % spt : ks;   // the stage's place in its sum
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wgmma_s8_rs<BN>(acc, af[jj], db + 2 * jj, (kt > 0 || jj > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&rg.empty[s]);
    if (++s == rg.stages) { s = 0; ph ^= 1; }
    if constexpr (TAPS) {
      if (kt == spt - 1) {   // the end of a tap: 0 + f32(sum) at the first
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          fs[i] = __fadd_rn(fs[i], static_cast<float>(acc[i]));
      }
    }
  }
}

// conv1's GEMM pass: A is the tile's x halo in the ring stage itself (at
// a_off: 128-byte rows, 128-byte swizzle, 1024-aligned, the layout a wgmma
// descriptor reads), so it takes the descriptor form and no A registers;
// two m64 row tiles cover the 81 or 100 halo rows (the rows past them
// read whatever follows in the stage, and their sums are not used).  With
// no register written under them, one stage's products stay in flight
// while the next stage is waited for; a stage's slot is freed once its
// products are done.
template <int BN>
__device__ __forceinline__ void gemm_s8_halo(int (&acc)[2][BN / 2],
                                             int k_steps, const CwRing& rg,
                                             int a_off, int b_off, int& s,
                                             uint32_t& ph) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;
  int held = -1;   // the slot whose products are in flight
  for (int ks = 0; ks < k_steps; ++ks) {
    mbar_wait(&rg.full[s], ph);
    uint8_t* st = rg.ring + s * rg.stage_bytes;
    const uint64_t da = wg_desc<128>(st + a_off);
    const uint64_t db = wg_desc<128>(st + b_off);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)   // row tile mt: 64 rows = 8192 bytes on
        wgmma_s8<BN>(acc[mt], da + mt * (8192 >> 4) + 2 * jj, db + 2 * jj,
                     (ks > 0 || jj > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) mbar_arrive(&rg.empty[held]);
    held = s;
    if (++s == rg.stages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);
  if (held >= 0) mbar_arrive(&rg.empty[held]);
}

// The places in shared memory of the "wgmma" kernel (cw_smem's order).
struct CwSmem {
  uint8_t* ring;
  uint8_t* y1s;
  uint8_t* y2s;
  uint8_t* stg;
  uint64_t* full;
  uint64_t* empty;
  uint8_t* zero;
};

__device__ __forceinline__ CwSmem cw_layout(const ChainWgArgs& p) {
  extern __shared__ uint8_t smem_raw[];
  CwSmem m;
  m.ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  m.y1s = m.ring + p.stages * p.stage_bytes;
  m.y2s = m.y1s + p.T * p.npos * p.ld;
  m.stg = m.y2s + p.T * p.thw * p.ld;
  m.full = reinterpret_cast<uint64_t*>(m.stg + 2 * p.thw * CW_SPITCH);
  m.empty = m.full + p.stages;
  m.zero = reinterpret_cast<uint8_t*>(m.empty + p.stages);
  return m;
}

// A consumer's tile of the current work item.
struct CwTile {
  int img, oh0, ow0, valid;
};

// The three convs of a consumer; s and ph are its place in the ring (slot,
// phase parity), carried from one GEMM to the next.

// conv1: x halo . w1 -> y1 (0 at halo pixels outside the image).
template <int BN>
__device__ __forceinline__ void cw_conv1(const ChainWgArgs& p, int& s,
                                         uint32_t& ph, CwTile tl) {
  const CwSmem m = cw_layout(p);
  const CwRing rg{m.ring, m.full, m.empty, p.stage_bytes, p.stages};
  const bool split = p.T == 1;
  const int tid = static_cast<int>(threadIdx.x);
  const int cw = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int gid = (tid & 31) >> 2;
  const int tig = tid & 3;
  const int a_off = split ? 0 : cw * p.a_bytes;
  const int b_off = p.na * p.a_bytes + (split ? cw * CW_B_BYTES : 0);
  const uint32_t y1u = smem_u32(m.y1s + (split ? 0 : cw * p.npos * p.ld));
  const int pitch = p.TW + 2;
  const int rounds = split ? (p.n1 + 1) / 2 : p.n1;
  for (int rd = 0; rd < rounds; ++rd) {
    int acc[2][BN / 2];
    gemm_s8_halo<BN>(acc, p.k1, rg, a_off, b_off, s, ph);
    const int np = split ? 2 * rd + cw : rd;
    // this thread's four epilogue rows: inside the halo and the image?
    int inside = 0, hrows = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i >> 1) * 64 + warp * 16 + gid + 8 * (i & 1);
      const int hh = r / pitch;
      const int ih = tl.oh0 - 1 + hh;
      const int iw = tl.ow0 - 1 + (r - hh * pitch);
      if (r < p.npos) hrows |= 1 << i;
      if (tl.valid && r < p.npos && ih >= 0 && ih < p.H && iw >= 0 &&
          iw < p.W)
        inside |= 1 << i;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = np * BN + j * 8 + tig * 2;
      if (n >= p.Cm) continue;       // Cm % 16 == 0: n + 1 < Cm
      const float2 ws = ld_pair(p.w1s + n);
      const float2 bb = ld_pair(p.b1 + n);
      const float s0 = __fmul_rn(ws.x, p.sx);
      const float s1 = __fmul_rn(ws.y, p.sx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(hrows >> i & 1)) continue;
        const int r = (i >> 1) * 64 + warp * 16 + gid + 8 * (i & 1);
        const int a0 = acc[i >> 1][j * 4 + 2 * (i & 1)];
        const int a1 = acc[i >> 1][j * 4 + 2 * (i & 1) + 1];
        uint32_t v = 0;
        if (inside >> i & 1)
          v = pack2(q8_relu(fmaxf(__fmaf_rn(static_cast<float>(a0), s0, bb.x),
                                  0.0f), p.inv_sy1),
                    q8_relu(fmaxf(__fmaf_rn(static_cast<float>(a1), s1, bb.y),
                                  0.0f), p.inv_sy1));
        sts16(y1u + r * p.ld + n, v);
      }
    }
  }
}

// conv2: 3x3 over y1 (implicit im2col, A by ldmatrix) -> y2.  BNM: its
// columns per pass (64 where Cm <= 64, else 128); TAPS: Cm > 128, the sum
// is taken per tap in f32 (a consumer holds an int32 and an f32 sum per
// column).
template <int BNM, bool TAPS>
__device__ __forceinline__ void cw_conv2(const ChainWgArgs& p, int& s,
                                         uint32_t& ph) {
  const CwSmem m = cw_layout(p);
  const CwRing rg{m.ring, m.full, m.empty, p.stage_bytes, p.stages};
  const bool split = p.T == 1;
  const int tid = static_cast<int>(threadIdx.x);
  const int cw = tid >> 7;
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int half = lane >> 4;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const uint32_t y1u = smem_u32(m.y1s + (split ? 0 : cw * p.npos * p.ld));
  const uint32_t y2u = smem_u32(m.y2s + (split ? 0 : cw * p.thw * p.ld));
  const uint32_t zu = smem_u32(m.zero);
  const int b_off = p.na * p.a_bytes + (split ? cw * CW_B_BYTES : 0);
  const int pitch = p.TW + 2;
  const int rounds = split ? (p.n2 + 1) / 2 : p.n2;
  const int ar = warp * 16 + (lane & 15);   // this lane's A row (output pixel)
  const bool ar_ok = ar < p.thw;
  const uint32_t wu = y1u + ((ar / p.TW) * pitch + ar % p.TW) * p.ld;
  for (int rd = 0; rd < rounds; ++rd) {
    int acc[BNM / 2];
    float fs[TAPS ? BNM / 2 : 1];
    if constexpr (TAPS) {
      gemm_s8<BNM, true>(acc, fs, p.k2, p.spt, rg, b_off, s, ph,
          [&](int ks, int jj) {
            const int tap = ks / p.spt;
            const int c = (ks - tap * p.spt) * CW_BK + jj * 32 + half * 16;
            return (ar_ok && c < p.Cm)
                ? wu + ((tap / 3) * pitch + tap % 3) * p.ld + c : zu;
          });
    } else {
      // this lane's K position: channel c of tap (kh, kw)
      int c = half * 16, kh = 0, kw = 0;
      while (c >= p.Cm) { c -= p.Cm; if (++kw == 3) { kw = 0; ++kh; } }
      gemm_s8<BNM, false>(acc, fs, p.k2, 0, rg, b_off, s, ph,
          [&](int, int) {
            const uint32_t a = (ar_ok && kh < 3)
                ? wu + (kh * pitch + kw) * p.ld + c : zu;
            c += 32;
            while (c >= p.Cm) { c -= p.Cm; if (++kw == 3) { kw = 0; ++kh; } }
            return a;
          });
    }
    const int np = split ? 2 * rd + cw : rd;
#pragma unroll
    for (int j = 0; j < BNM / 8; ++j) {
      const int n = np * BNM + j * 8 + tig * 2;
      if (n >= p.Cm) continue;
      const float2 ws = ld_pair(p.w2s + n);
      const float2 bb = ld_pair(p.b2 + n);
      const float s0 = __fmul_rn(ws.x, p.sy1);
      const float s1 = __fmul_rn(ws.y, p.sy1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gid + 8 * h;
        if (r >= p.thw) continue;
        float v0, v1;
        if constexpr (TAPS) {
          v0 = fs[j * 4 + 2 * h];
          v1 = fs[j * 4 + 2 * h + 1];
        } else {
          v0 = static_cast<float>(acc[j * 4 + 2 * h]);
          v1 = static_cast<float>(acc[j * 4 + 2 * h + 1]);
        }
        sts16(y2u + r * p.ld + n,
              pack2(q8_relu(fmaxf(__fmaf_rn(v0, s0, bb.x), 0.0f), p.inv_sy2),
                    q8_relu(fmaxf(__fmaf_rn(v1, s1, bb.y), 0.0f),
                            p.inv_sy2)));
      }
    }
  }
}

// conv3: y2 . w3 + b3 + shortcut -> out.  Each pass's shortcut rows of x
// come into this consumer's staged rows by cp.async under the pass's GEMM;
// int8 and bf16 outputs leave through the same rows, 64 columns at a time,
// as 16-byte row pieces, f32 ones in pairs.
__device__ __forceinline__ void cw_conv3(const ChainWgArgs& p, int& s,
                                         uint32_t& ph, CwTile tl) {
  const CwSmem m = cw_layout(p);
  const CwRing rg{m.ring, m.full, m.empty, p.stage_bytes, p.stages};
  const bool split = p.T == 1;
  const int tid = static_cast<int>(threadIdx.x);
  const int cw = tid >> 7;
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int half = lane >> 4;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const uint32_t y2u = smem_u32(m.y2s + (split ? 0 : cw * p.thw * p.ld));
  uint8_t* sg = m.stg + cw * p.thw * CW_SPITCH;
  const uint32_t sgu = smem_u32(sg);
  const uint32_t zu = smem_u32(m.zero);
  const int osize = out_size(p.out_type);
  const int lp = osize + 1;   // log2 of the 16-byte pieces of 64 outputs
  const int b_off = p.na * p.a_bytes + (split ? cw * CW_B_BYTES : 0);
  const int rounds = split ? (p.n3 + 1) / 2 : p.n3;
  const int ar = warp * 16 + (lane & 15);
  const uint32_t au = ar < p.thw ? y2u + ar * p.ld : zu;
  const long long img_off =
      static_cast<long long>(tl.img) * p.H * p.W * p.C;
  for (int rd = 0; rd < rounds; ++rd) {
    const int n0 = (split ? 2 * rd + cw : rd) * CW_BN3;
    for (int i = t; i < p.thw * (CW_BN3 / 16); i += 128) {
      const int r = i >> 3;
      const int c = (i & 7) * 16;
      const int oh = tl.oh0 + r / p.TW;
      const int ow = tl.ow0 + r % p.TW;
      if (tl.valid && oh < p.H && ow < p.W && n0 + c < p.C)
        cp_async16(sg + r * CW_SPITCH + c,
                   p.x + img_off + (static_cast<long long>(oh) * p.W + ow) *
                                       p.C + n0 + c, true);
    }
    cp_async_commit();
    int acc[CW_BN3 / 2];
    float fs[1];
    gemm_s8<CW_BN3, false>(acc, fs, p.k3, 0, rg, b_off, s, ph,
        [&](int ks, int jj) {
          const int c = ks * CW_BK + jj * 32 + half * 16;
          return (au != zu && c < p.Cm) ? au + c : zu;
        });
    cp_async_wait<0>();
    named_sync(1 + cw, 128);
    // this thread's shortcut pairs: row h's two bytes of column group j in
    // bits 16h .. 16h + 15
    uint32_t xr[CW_BN3 / 8];
    {
      const uint32_t x0 = sgu + min(warp * 16 + gid, p.thw - 1) * CW_SPITCH;
      const uint32_t x1 = sgu + min(warp * 16 + gid + 8, p.thw - 1) * CW_SPITCH;
#pragma unroll
      for (int j = 0; j < CW_BN3 / 8; ++j) {
        uint16_t lo, hi;
        asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(lo)
                     : "r"(x0 + j * 8 + tig * 2));
        asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(hi)
                     : "r"(x1 + j * 8 + tig * 2));
        xr[j] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      }
    }
    named_sync(1 + cw, 128);   // the staged rows are free for the outputs
    // the output of accumulator slot (j, h, e) with its column constants;
    // FMA: the shortcut's form (an FMA on the chain's first block, a
    // rounded product and an add on the later ones), fixed per pass
    auto value = [&](auto fma, int j, int h, int e, float sc, float bi) {
      const float t3 = __fmaf_rn(static_cast<float>(acc[j * 4 + 2 * h + e]),
                                 sc, bi);
      const float xv = static_cast<float>(
          static_cast<int8_t>((xr[j] >> (16 * h + 8 * e)) & 0xFFu));
      const float y = decltype(fma)::value ? __fmaf_rn(xv, p.sx, t3)
                                           : __fadd_rn(t3, __fmul_rn(xv, p.sx));
      return fmaxf(y, 0.0f);
    };
    auto f32_out = [&](auto fma) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gid + 8 * h;
        const int oh = tl.oh0 + r / p.TW;
        const int ow = tl.ow0 + r % p.TW;
        if (!tl.valid || r >= p.thw || oh >= p.H || ow >= p.W) continue;
        float* orow = static_cast<float*>(p.out) + img_off +
                      (static_cast<long long>(oh) * p.W + ow) * p.C;
#pragma unroll
        for (int j = 0; j < CW_BN3 / 8; ++j) {
          const int n = n0 + j * 8 + tig * 2;
          if (n >= p.C) continue;
          const float2 ws = ld_pair(p.w3s + n);
          const float2 bb = ld_pair(p.b3 + n);
          *reinterpret_cast<float2*>(orow + n) = make_float2(
              value(fma, j, h, 0, __fmul_rn(ws.x, p.sy2), bb.x),
              value(fma, j, h, 1, __fmul_rn(ws.y, p.sy2), bb.y));
        }
      }
    };
    // int8 or bf16: 64 columns of the staged rows
    auto staged_out = [&](auto fma, int hf) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = hf * 8 + jj;
        const int n = n0 + j * 8 + tig * 2;
        if (n >= p.C) continue;
        const float2 ws = ld_pair(p.w3s + n);
        const float2 bb = ld_pair(p.b3 + n);
        const float s0 = __fmul_rn(ws.x, p.sy2);
        const float s1 = __fmul_rn(ws.y, p.sy2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + gid + 8 * h;
          if (r >= p.thw) continue;
          const float y0 = value(fma, j, h, 0, s0, bb.x);
          const float y1 = value(fma, j, h, 1, s1, bb.y);
          const int c = jj * 8 + tig * 2;
          if (p.out_type == DT_I8) {
            sts16(sgu + r * CW_SPITCH + c,
                  pack2(q8_relu(y0, p.out_scale), q8_relu(y1, p.out_scale)));
          } else {
            const __nv_bfloat162 b2v = __floats2bfloat162_rn(y0, y1);
            sts32(sgu + r * CW_SPITCH + 2 * c,
                  *reinterpret_cast<const uint32_t*>(&b2v));
          }
        }
      }
    };
    if (p.out_type == DT_F32) {
      if (p.shortcut_fma) f32_out(std::true_type{});
      else f32_out(std::false_type{});
      continue;
    }
    // 64 columns at a time through the staged rows, then out as 16-byte
    // row pieces
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (p.shortcut_fma) staged_out(std::true_type{}, hf);
      else staged_out(std::false_type{}, hf);
      named_sync(1 + cw, 128);
      const int cb = n0 + hf * 64;         // the half's first column
      for (int i = t; i < p.thw << lp; i += 128) {
        const int r = i >> lp;
        const int c = i & ((1 << lp) - 1);
        const int oh = tl.oh0 + r / p.TW;
        const int ow = tl.ow0 + r % p.TW;
        if (!tl.valid || oh >= p.H || ow >= p.W ||
            cb + ((c * 16) >> (osize - 1)) >= p.C)
          continue;
        const uint4 v = lds128u(sgu + r * CW_SPITCH + c * 16);
        *reinterpret_cast<uint4*>(
            static_cast<uint8_t*>(p.out) +
            (img_off + (static_cast<long long>(oh) * p.W + ow) * p.C + cb) *
                osize + c * 16) = v;
      }
      named_sync(1 + cw, 128);
    }
  }
}

template <int BNM, bool TAPS>
__global__ void __launch_bounds__(CW_THREADS, 1)
fused_block_kernel_wg(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_w3,
                      const __grid_constant__ ChainWgArgs p) {
  const CwSmem m = cw_layout(p);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;         // 0, 1: the consumers; 2: the producer
  const bool split = p.T == 1;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&m.full[i], 1);
      mbar_init(&m.empty[i], 256);
    }
    *reinterpret_cast<uint4*>(m.zero) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load --------
    if (tid != 256) return;
    // rounds of each conv: a round is one pass per consumer (split) or
    // one pass for both
    const int r1 = split ? (p.n1 + 1) / 2 : p.n1;
    const int r2 = split ? (p.n2 + 1) / 2 : p.n2;
    const int r3 = split ? (p.n3 + 1) / 2 : p.n3;
    uint8_t* ring = m.ring;
    uint64_t* full = m.full;
    uint64_t* empty = m.empty;
    int s = 0;
    uint32_t ph = 0;
    auto slot = [&](uint32_t bytes) {
      mbar_wait(&empty[s], ph ^ 1);
      mbar_expect_tx(&full[s], bytes);
      return ring + s * p.stage_bytes;
    };
    auto advance = [&]() { if (++s == p.stages) { s = 0; ph ^= 1; } };
    // weight tile b of round r: pass r * nb + b, clamped to the last pass
    // (a consumer past it computes on that pass and stores nothing)
    auto pass = [&](int r, int b, int n) { return min(r * p.nb + b, n - 1); };
    const int wb = p.na * p.a_bytes;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      for (int r = 0; r < r1; ++r)
        for (int ks = 0; ks < p.k1; ++ks) {
          uint8_t* st = slot(p.nb * BNM * 128 + p.na * p.npos * 128);
          for (int b = 0; b < p.nb; ++b)
            tma_load_2d(st + wb + b * CW_B_BYTES, &map_w1, ks * CW_BK,
                        pass(r, b, p.n1) * BNM, &full[s]);
          for (int a = 0; a < p.na; ++a) {
            // a consumer past the last tile computes on the last one's halo
            const int tile = min(item * p.T + a, p.tiles - 1);
            const int img = tile / p.tiles_per_img;
            const int tr = tile - img * p.tiles_per_img;
            const int th = tr / p.tiles_w;
            tma_load_4d(st + a * p.a_bytes, &map_x, ks * CW_BK,
                        (tr - th * p.tiles_w) * p.TW - 1, th * p.TH - 1, img,
                        &full[s]);
          }
          advance();
        }
      for (int r = 0; r < r2; ++r)
        for (int ks = 0; ks < p.k2; ++ks) {
          uint8_t* st = slot(p.nb * BNM * 128);
          // TAPS: each tap's K from its own first column, whole stages
          const int kx = TAPS ? (ks / p.spt) * p.Cm + (ks % p.spt) * CW_BK
                              : ks * CW_BK;
          for (int b = 0; b < p.nb; ++b)
            tma_load_2d(st + wb + b * CW_B_BYTES, &map_w2, kx,
                        pass(r, b, p.n2) * BNM, &full[s]);
          advance();
        }
      for (int r = 0; r < r3; ++r)
        for (int ks = 0; ks < p.k3; ++ks) {
          uint8_t* st = slot(p.nb * CW_BN3 * 128);
          for (int b = 0; b < p.nb; ++b)
            tma_load_2d(st + wb + b * CW_B_BYTES, &map_w3, ks * CW_BK,
                        pass(r, b, p.n3) * CW_BN3, &full[s]);
          advance();
        }
    }
    return;
  }

  // ---------------- consumers ----------------------------------------------
  // y1 and y2 pass between the consumers where they split one tile's
  // columns (barrier 3, both); each consumer's own are barrier 1 + cw
  const int cw = wg;
  const int bar = split ? 3 : 1 + cw;
  const int bar_n = split ? 256 : 128;
  int s = 0;
  uint32_t ph = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int tile = item * p.T + (split ? 0 : cw);
    CwTile tl;
    tl.valid = tile < p.tiles;
    const int tc = tl.valid ? tile : p.tiles - 1;
    tl.img = tc / p.tiles_per_img;
    const int tr = tc - tl.img * p.tiles_per_img;
    const int tth = tr / p.tiles_w;
    tl.oh0 = tth * p.TH;
    tl.ow0 = (tr - tth * p.tiles_w) * p.TW;
    cw_conv1<BNM>(p, s, ph, tl);
    named_sync(bar, bar_n);
    cw_conv2<BNM, TAPS>(p, s, ph);
    named_sync(bar, bar_n);
    cw_conv3(p, s, ph, tl);
  }
}

template <int BNM, bool TAPS>
int launch_wg(const ChainWgArgs& p, const CUtensorMap* maps, int grid,
              int smem, cudaStream_t s) {
  auto kern = fused_block_kernel_wg<BNM, TAPS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, CW_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// x as a 4-D int8 TMA map (C, W, H, N), box 128 channels x (TW + 2) x
// (TH + 2) x 1, 128-byte swizzle, zero fill outside.
inline bool make_map_x(CUtensorMap* map, const void* x, int N, int H, int W,
                       int C, int TH, int TW) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W) * C,
      static_cast<cuuint64_t>(H) * W * C};
  const cuuint32_t box[4] = {CW_BK, static_cast<cuuint32_t>(TW + 2),
                             static_cast<cuuint32_t>(TH + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The "wgmma" launch of one block: the plan (tile, tiles per work item,
// stages, shared memory, grid) checked against the operands and refused
// (cudaErrorInvalidValue) where it does not fit them.
int run_block_wg(const BlockArgs& b, int T, int stages, int smem, int grid,
                 cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (b.C % 16 || b.Cm % 16 || (T != 1 && T != 2) || stages < 2 ||
      b.TW + 2 > 256 || b.TH + 2 > 256 || !aligned(b.x, 16) ||
      !aligned(b.out, 16) || !aligned(b.w1, 16) || !aligned(b.w2, 16) ||
      !aligned(b.w3, 16))
    return bad;
  ChainWgArgs p;
  p.x = b.x;
  p.out = b.out;
  p.b1 = b.b1;
  p.w1s = b.w1s;
  p.b2 = b.b2;
  p.w2s = b.w2s;
  p.b3 = b.b3;
  p.w3s = b.w3s;
  p.N = b.N;
  p.H = b.H;
  p.W = b.W;
  p.C = b.C;
  p.Cm = b.Cm;
  p.TH = b.TH;
  p.TW = b.TW;
  p.tiles_w = (b.W + b.TW - 1) / b.TW;
  p.tiles_per_img = ((b.H + b.TH - 1) / b.TH) * p.tiles_w;
  const long long tiles = static_cast<long long>(b.N) * p.tiles_per_img;
  p.T = T;
  p.stages = stages;
  p.npos = (b.TH + 2) * (b.TW + 2);
  p.thw = b.TH * b.TW;
  p.ld = b.Cm + 16;
  p.a_bytes = cw_a_bytes(p.npos);
  p.na = T;
  p.nb = 3 - T;
  p.stage_bytes = p.na * p.a_bytes + p.nb * CW_B_BYTES;
  const bool taps = b.Cm > 128;
  const int bnm = b.Cm <= 64 ? 64 : 128;
  p.n1 = (b.Cm + bnm - 1) / bnm;
  p.n2 = p.n1;
  p.n3 = (b.C + CW_BN3 - 1) / CW_BN3;
  p.k1 = (b.C + CW_BK - 1) / CW_BK;
  p.spt = taps ? (b.Cm + CW_BK - 1) / CW_BK : 0;
  p.k2 = taps ? 9 * p.spt : (9 * b.Cm + CW_BK - 1) / CW_BK;
  p.k3 = (b.Cm + CW_BK - 1) / CW_BK;
  p.sx = b.sx;
  p.sy1 = b.sy1;
  p.sy2 = b.sy2;
  p.inv_sy1 = b.inv_sy1;
  p.inv_sy2 = b.inv_sy2;
  p.out_scale = b.out_scale;
  p.shortcut_fma = b.shortcut_fma;
  p.out_type = b.out_type;
  p.items = static_cast<int>((tiles + T - 1) / T);
  if (p.thw > 64 || p.npos > 128 || tiles >= (1LL << 31) || grid < 1 ||
      grid > p.items ||
      cw_smem(T, stages, p.npos, p.thw, p.ld) != smem || smem > 227 * 1024)
    return bad;
  p.tiles = static_cast<int>(tiles);
  CUtensorMap maps[4];
  if (!make_map_x(&maps[0], b.x, b.N, b.H, b.W, b.C, b.TH, b.TW) ||
      !make_map(&maps[1], b.w1, b.Cm, b.C, bnm, CW_BK) ||
      !make_map(&maps[2], b.w2, b.Cm, 9 * b.Cm, bnm, CW_BK) ||
      !make_map(&maps[3], b.w3, b.C, b.Cm, CW_BN3, CW_BK))
    return bad;
  if (taps) return launch_wg<128, true>(p, maps, grid, smem, s);
  if (bnm == 128) return launch_wg<128, false>(p, maps, grid, smem, s);
  return launch_wg<64, false>(p, maps, grid, smem, s);
}

}  // namespace
}  // namespace fcnn

// One block of a chain.  w1, w2, w3 are the block's weights transposed,
// (Cm, C), (Cm, 9*Cm) with k = (kh*3 + kw)*Cm + c_in, and (C, Cm); b*, w*s
// its biases and per-channel weight scales.  inv_sy1, inv_sy2 and out_scale
// are reciprocals taken in double by the caller and rounded once to f32.
// The plan (chain_plan in kernels/fused_chain.py): variant (0 "wgmma", 1
// "mma_sync"), tiles per work item, stages, shared memory and grid.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fcnn_fused_block(
    const void* x, void* out, const void* w1, const float* b1,
    const float* w1s, const void* w2, const float* b2, const float* w2s,
    const void* w3, const float* b3, const float* w3s, int N, int H, int W,
    int C, int Cm, int TH, int TW, float sx, float sy1, float sy2,
    float inv_sy1, float inv_sy2, float out_scale, int shortcut_fma,
    int out_type, int variant, int T, int stages, int smem, int grid,
    void* stream) {
  using namespace fcnn;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0) return 0;
  if (TH < 1 || TW < 1 ||
      (out_type != DT_I8 && out_type != DT_BF16 && out_type != DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.out = out;
  p.w1 = static_cast<const int8_t*>(w1);
  p.b1 = b1;
  p.w1s = w1s;
  p.w2 = static_cast<const int8_t*>(w2);
  p.b2 = b2;
  p.w2s = w2s;
  p.w3 = static_cast<const int8_t*>(w3);
  p.b3 = b3;
  p.w3s = w3s;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cm = Cm;
  p.TH = TH;
  p.TW = TW;
  p.sx = sx;
  p.sy1 = sy1;
  p.sy2 = sy2;
  p.inv_sy1 = inv_sy1;
  p.inv_sy2 = inv_sy2;
  p.out_scale = out_scale;
  p.shortcut_fma = shortcut_fma;
  p.out_type = out_type;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) return run_block_wg(p, T, stages, smem, grid, s);
  if (variant == 1 && T == 1) return run_block_mma(p, smem, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
