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
// tensor cores; the card needs ~590 per byte).
//
// The design: one thread block per (image, TH x TW output tile), 8 x 8 or
// 7 x 7 (the wrapper's tile_plan).  y1 and y2 never leave shared memory:
//  1. conv1 runs over the tile's (TH+2) x (TW+2) halo, only at pixels inside
//     the image, and writes y1 as int8 into shared memory; the halo's
//     pixels outside the image stay 0, the conv's zero padding of y1 (not
//     q8(relu(b1)), which conv1 of a zero pixel would give).
//  2. conv2 reads y1 from shared memory as an implicit im2col (K = 9 taps x
//     Cm, each tap's channels padded to 64) and writes y2 to shared memory.
//  3. conv3 reads y2 from shared memory, adds the shortcut read from x in
//     device memory (an L2 hit right after conv1's read of the same pixels)
//     and stores the output.  Where C is a multiple of 16 and the output
//     int8 or bf16, the shortcut rows come in and the output rows go out as
//     16-byte pieces through the idle A ring; element by element, the
//     single-byte loads and stores made this epilogue the kernel's
//     largest part at stage 2.
// Each GEMM is the int8 mma.sync m16n8k32 path of gemm_common.cuh: 8 warps
// as 2 (M) x 4 (N), 64 K-bytes a step.  The weights stream through a
// 3-stage cp.async ring in shared memory from L2, where every thread block
// finds the same weights; a stage's weights do not fit in shared memory
// (stage 4 has 1.1 MB a block, stage 5 4.4 MB).  They are stored
// transposed, (N, K) with K contiguous (kernel_layout in fused_chain.py,
// made once per graph node by the lowering), so a 16-byte copy lands where
// the mma's B fragment reads it with no transpose in the kernel.  C and Cm that
// are multiples of 16 take 16-byte copies; others take a masked byte path.
// Not yet done: wgmma, TMA, a persistent grid, keeping x in shared memory
// for the shortcut.
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

}  // namespace
}  // namespace fcnn

// One block of a chain.  w1, w2, w3 are the block's weights transposed,
// (Cm, C), (Cm, 9*Cm) with k = (kh*3 + kw)*Cm + c_in, and (C, Cm); b*, w*s
// its biases and per-channel weight scales.  inv_sy1, inv_sy2 and out_scale
// are reciprocals taken in double by the caller and rounded once to f32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fcnn_fused_block(
    const void* x, void* out, const void* w1, const float* b1,
    const float* w1s, const void* w2, const float* b2, const float* w2s,
    const void* w3, const float* b3, const float* w3s, int N, int H, int W,
    int C, int Cm, int TH, int TW, float sx, float sy1, float sy2,
    float inv_sy1, float inv_sy2, float out_scale, int shortcut_fma,
    int out_type, void* stream) {
  using namespace fcnn;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0) return 0;
  if (TH < 1 || TW < 1 || (TH + 2) * (TW + 2) > FB_MAX_HALO ||
      TH * TW > FB_MAX_PIX ||
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
  const int tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  p.tiles_per_img = tiles_h * p.tiles_w;
  p.cmp = (Cm + 63) / 64 * 64;
  p.ld = p.cmp + 16;
  p.halo_bytes = (TH + 2) * (TW + 2) * p.ld;
  p.sx = sx;
  p.sy1 = sy1;
  p.sy2 = sy2;
  p.inv_sy1 = inv_sy1;
  p.inv_sy2 = inv_sy2;
  p.out_scale = out_scale;
  p.shortcut_fma = shortcut_fma;
  p.out_type = out_type;
  p.vec1 = C % 16 == 0 && aligned(x, 16) && aligned(w1, 16);
  p.vec2 = Cm % 16 == 0 && aligned(w2, 16);
  p.vec3 = Cm % 16 == 0 && aligned(w3, 16);
  p.staged3 = C % 16 == 0 && out_type != DT_F32 && aligned(x, 16) &&
              aligned(out, 16);
  const long long smem =
      static_cast<long long>(p.halo_bytes) + FB_MAX_PIX * p.ld +
      FB_STAGES * (FB_MAX_BM + FB_MAX_BN) * FB_LDS +
      FB_MAX_HALO * (8 + 4) + FB_MAX_PIX * 4;
  const long long grid = static_cast<long long>(N) * p.tiles_per_img;
  if (smem > 227 * 1024 || grid >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide2 = p.cmp >= 128;
  const bool wide3 = C >= 128;
  if (wide2 && wide3) return launch<4, 4>(p, static_cast<int>(grid), static_cast<int>(smem), s);
  if (wide2) return launch<4, 2>(p, static_cast<int>(grid), static_cast<int>(smem), s);
  if (wide3) return launch<2, 4>(p, static_cast<int>(grid), static_cast<int>(smem), s);
  return launch<2, 2>(p, static_cast<int>(grid), static_cast<int>(smem), s);
}
