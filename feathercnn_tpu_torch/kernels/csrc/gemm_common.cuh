// Shared core of the two GEMM-shaped kernels (matmul_epilogue.cu and
// conv_implicit_gemm.cu): the fused epilogue, the A-operand row fetchers
// (a plain matrix, or an NHWC image gathered as an implicit im2col), the
// int8 main loops and the float ones.  The depthwise kernels
// (depthwise_conv.cu) use the epilogue (epilogue_value and requant_i8) too,
// and the two fused-chain kernels (fused_chain.cu, fused_chain_float.cu)
// the cp.async helpers, the mma.sync forms, the fragment walk
// (for_each_out) and the tile's row tables (chain_tile_rows).
//
// Layouts: A is (M, K) with K contiguous; the weight is stored (N, K) with
// K contiguous (gemm_layout in kernels/matmul.py; for a conv K runs over
// (kh, kw, c), as the im2col row does); the output is (M, N) row-major.
// For the conv, M runs over output pixels (n, oh, ow) and N over output
// channels, so the output is NHWC.
//
// What bounds them on an H100 SXM.  With int8 in and out and M >> K, N a
// launch moves M*K + N*K + M*N*out_size bytes and does 2*M*N*K operations:
// about 2*K*N / (K + N) operations per byte, ~100 at K = 64, N = 256, far
// below the ~590 the card needs to be bound by its int8 tensor cores.  So
// the 1x1 convs at small K (stages 2-3, the MobileNets) are bound by
// bytes, and their output bytes dominate; the 3x3 convs at ResNet-50's
// stages 3-5 (9*C operations per byte) and the widest merged convs are
// bound by operations.
//
// The int8 design (variant "wgmma", wgemm_kernel): a persistent grid, one
// thread block per SM walking 128 x BN output tiles (BN 32 to 256, chosen
// per launch on the host; the grid is a multiple of the column tiles, so a
// block keeps its columns).  A producer warpgroup keeps a ring of stages in
// flight: A by TMA (matrix) or gathered by the producer's 128 threads with
// 16-byte cp.async straight into the swizzled layout (conv: each thread's
// tap advances by counters, no division in the K loop); the weight tile by
// TMA in the same stage, or, where the block's whole weight panel fits
// (bres), loaded once and kept.  Two consumer warpgroups, 64 rows each, run
// wgmma.m64nBNk32.s32.s8.s8 from 64- or 128-byte-swizzled shared memory
// with one K step's group in flight, the K step sized to K (64 bytes for
// K <= 64, else 128; the bytes past K arrive as zeros).  mbarriers carry
// completion both ways, so the next tile's loads run under this tile's
// epilogue.  The epilogue is staged through shared memory: the block's
// per-column constants are made once, each element takes epilogue_value's
// steps as short branch-free code (measured: the branchy per-element code,
// unrolled over up to 128 accumulators a thread, cost more than the whole
// main loop at K = 64), and the tile leaves as 16-byte row pieces.  The
// whole K accumulates in int32: exact.
//
// The shapes it cannot take (the host's plan decides before the launch):
// a row pitch that is not a multiple of 16 bytes (K or C), a pointer that
// is not 16-byte aligned, C < 16.  They take variant "mma_sync"
// (igemm_kernel): mma.sync m16n8k32 over single-byte tiles.  bf16 x bf16
// (variant "mma_bf16", bgemm_kernel) runs mma.sync m16n8k16 with each warp
// summing its own slice of K and a fixed-order reduction across warps.
//
// Weight-only int8, bf16 x int8 w (variant "wgmma_w8", w8gemm_kernel): the
// same persistent grid, producer warpgroup, mbarrier ring and column
// constants, on wgmma.m64nBNk16.f32.bf16.bf16 (BN 32, 64 or 128) with f32
// sums over the whole K.  A K step is 64 bf16 (a 128-byte row, 128-byte
// swizzle).  A comes by TMA: a matrix's 128 x 64 box, or, for a conv at
// stride 1 with C a multiple of 64, one 4-D box per (tap, 64 channels)
// over a th x tw rectangle of output pixels, shifted by the tap, the
// image's edge filled with zeros (the padding); any other conv gathers A
// with 16-byte cp.async, 8 channels a piece.  The int8 weight tile arrives
// by cp.async (16- or 8-byte pieces, by K) into an int8 staging slot of
// the stage; the consumers convert it to the bf16 tile wgmma reads (byte
// permutes and exact f32 subtractions, i8x4_to_bf16) while the last step's
// wgmma runs.  No bf16 copy of the weight exists in device memory: the
// weight streams as int8.  The epilogue leaves from the registers
// (store_direct), which leaves room for a 5th stage at BN = 128.  A matrix
// whose tiles leave SMs idle (the FCs, M = batch) splits K over the grid:
// each slice's f32 sums go to a workspace and a second pass
// (splitk_reduce_kernel) adds the slices in index order and applies the
// epilogue, so the result does not change from run to run.  A row pitch
// that is not 16 bytes' multiple (K or C not a multiple of 8) or a
// misaligned pointer takes "simt"; so do f32 x, f32 or int8 w ("simt",
// fgemm_kernel: f32 on the tensor cores would be TF32).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_ops.cuh"

namespace fcnn {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };
// The main loop a launch runs; the host's plan (gemm_plan in
// kernels/matmul.py) picks it.
enum Variant {
  V_SIMT = 0,
  V_MMA_S8 = 1,
  V_WGMMA_S8 = 2,
  V_MMA_BF16 = 3,
  V_WGMMA_W8 = 4
};

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

// A launch's plan, made on the host: the variant, and for "wgmma" and
// "wgmma_w8" the tile width, the K step in bytes, the ring's stages,
// whether the weight panel stays resident, the grid and the dynamic shared
// memory, which the kernel's own layout must equal, and the K slices
// ("wgmma_w8" matrices: 1, or the split-K slices summed by a second pass).
struct GemmPlan {
  int variant;
  int bn;
  int bk;
  int stages;
  int bres;  // the weight panel stays resident (wgemm_kernel)
  int grid;
  int smem;
  int split;
  int th;  // "wgmma_w8" conv: the output tile's rows and columns of pixels
  int tw;  // when A comes by TMA, one box per tap (0: gathered)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared memory without a register stop (cp.async);
// valid false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// zero (ragged M or K, or a tap in the conv's zero padding).
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
// Variant "wgmma": int8 x int8 -> int32 on wgmma, fed by a TMA / cp.async
// ring (see the note at the top).
// ---------------------------------------------------------------------
constexpr int WG_BM = 128;       // output rows per tile: 2 consumers x 64
constexpr int WG_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One arrival on bar when every cp.async this thread issued so far has
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of the given parity to complete.  A pipeline that
// never completes it (a fault in the protocol) traps after ~2^31 cycles
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// A 4-D box (c0 innermost); coordinates may be negative or past the end,
// where the box fills with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The byte offset ``off`` of a row-major tile with BK-byte rows, as the
// BK-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_{128,64}B, wgmma's layout
// types 1 and 2) stores it: bits [4, 4+B) XOR bits [7, 7+B), B = log2(BK/16).
template <int BK>
__device__ __forceinline__ int swizzle(int off) {
  constexpr int B = BK == 128 ? 3 : 2;
  return off ^ (((off >> 7) & ((1 << B) - 1)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile with BK-byte rows,
// BK-byte swizzled, based on a 1024-byte boundary: start address >> 4,
// leading offset 1 (unused when swizzled), stride 8 rows, layout type.
template <int BK>
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  constexpr uint64_t layout = BK == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>((8 * BK) >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its registers change behind the compiler's back).
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__host__ __device__ constexpr int out_size(int out_type) {
  return out_type == DT_F32 ? 4 : out_type == DT_BF16 ? 2 : 1;
}

// Dynamic shared memory of wgemm_kernel<A, BN, BK> (gemm_plan in
// kernels/matmul.py computes the same): 1024 bytes of alignment slack; the
// ring of (A, B) stages, or of A stages and the resident weight panel
// (bres: k_steps tiles of BN x BK); two barriers per stage and the panel's
// (16 bytes); each consumer's per-column epilogue constants (48 bytes per
// column pair) and staged output tile (64 rows of BN * out_size + 16
// bytes); the conv's row table.
__host__ __device__ constexpr int wgemm_smem(int bn, int bk, int stages,
                                             int k_steps, bool bres,
                                             int osize, bool conv) {
  return 1024 + stages * (WG_BM + (bres ? 0 : bn)) * bk +
         (bres ? k_steps * bn * bk : 0) + 16 * stages + 16 + 2 * 24 * bn +
         2 * 64 * (bn * osize + 16) + (conv ? WG_BM * 16 : 0);
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128u(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128u(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}
__device__ __forceinline__ void sts16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n"
               :: "r"(a), "h"(static_cast<uint16_t>(v)) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts64(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(a), "f"(x), "f"(y) : "memory");
}

// requant_i8's byte without the conversion unit: rint(t) as
// (t + 1.5 * 2^23) - 1.5 * 2^23 (round half to even, exact for
// |t| < 2^22; a larger |t| saturates all the same), clamped to +-127, and
// the integer read from the low byte of q + 1.5 * 2^23.
__device__ __forceinline__ uint32_t requant_byte(float y, float out_scale) {
  constexpr float kMagic = 12582912.0f;
  const float t = __fmul_rn(y, out_scale);
  const float q = fminf(fmaxf(__fsub_rn(__fadd_rn(t, kMagic), kMagic), -127.0f),
                        127.0f);
  return __float_as_uint(__fadd_rn(q, kMagic)) & 0xFFu;
}

// The epilogue constants of output columns n and n + 1 (n even), as
// wgemm_kernel keeps them: y = fma(acc * pre, last, bias), the activation's
// clamp, then [lo, hi].  This is epilogue_value step for step: pre is
// w_scale[n] where both scales apply (else 1, an exact multiply), last the
// scale of the FMA (x_scale, else w_scale[n], else 1) and bias -0.0 where
// there is none (fma(y, s, -0.0) rounds as y * s does); lo/hi are +-inf
// where there is no clamp.
__device__ __forceinline__ void column_pair(const Epilogue& e, int n, int N,
                                            uint32_t dst) {
  float v[10];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float pre = 1.0f, last = 1.0f, bias = -0.0f;
    float lo = -INFINITY, hi = INFINITY;
    if (n + q < N) {
      const float ws = e.w_scale ? e.w_scale[n + q] : 1.0f;
      if (e.x_scale != 1.0f) {
        pre = ws;
        last = e.x_scale;
      } else {
        last = ws;
      }
      if (e.bias) bias = e.bias[n + q];
      if (e.lo) {
        lo = e.lo[n + q];
        hi = e.hi[n + q];
      }
    }
    v[q] = pre;
    v[2 + q] = last;
    v[4 + q] = bias;
    v[6 + q] = lo;
    v[8 + q] = hi;
  }
  sts128(dst, make_float4(v[0], v[1], v[2], v[3]));
  sts128(dst + 16, make_float4(v[4], v[5], v[6], v[7]));
  sts128(dst + 32, make_float4(v[8], v[9], 0.0f, 0.0f));
}

// One consumer warpgroup's 64 x BN tile through the epilogue into its
// shared staging tile at ``os`` (row pitch ``pitch`` bytes), two columns
// per store; ``par`` holds the tile's column constants (column_pair).
// Each step is a single rounded operation in epilogue_value's order, so
// the values are the same bits; the code per element is short and has no
// branch, which matters here: the tile is 16-128 accumulators per thread,
// all unrolled.  SMALL_K (K <= 256, so |acc| <= 128 * 128 * 256 = 2^22):
// the accumulator becomes a float as (acc + 1.5 * 2^23 read as a float) -
// 1.5 * 2^23, exact in that range, on the full-rate pipes.
template <typename OutT, int BN, bool SMALL_K>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2],
                                           uint32_t par, uint32_t os,
                                           int pitch, float act_lo,
                                           float act_hi, float out_scale) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int gid = (t & 31) >> 2;
  const int tig = t & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + tig * 2;
    const uint32_t pp = par + (c >> 1) * 48;
    const float4 p0 = lds128(pp);       // pre0 pre1 last0 last1
    const float4 p1 = lds128(pp + 16);  // bias0 bias1 lo0 lo1
    const float4 p2 = lds128(pp + 32);  // hi0 hi1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int a = acc[j * 4 + 2 * h + q];
        const float f = SMALL_K
            ? __fsub_rn(__int_as_float(a + 0x4B400000), 12582912.0f)
            : static_cast<float>(a);
        float v = __fmaf_rn(__fmul_rn(f, q ? p0.y : p0.x), q ? p0.w : p0.z,
                            q ? p1.y : p1.x);
        v = fminf(fmaxf(v, act_lo), act_hi);
        y[q] = fminf(fmaxf(v, q ? p1.w : p1.z), q ? p2.y : p2.x);
      }
      const uint32_t a = os + (warp * 16 + gid + 8 * h) * pitch +
                         c * static_cast<int>(sizeof(OutT));
      if constexpr (std::is_same<OutT, int8_t>::value) {
        sts16(a, requant_byte(y[0], out_scale) |
                     (requant_byte(y[1], out_scale) << 8));
      } else if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(y[0], y[1]);
        sts32(a, *reinterpret_cast<const uint32_t*>(&b));
      } else {
        sts64(a, y[0], y[1]);
      }
    }
  }
}

template <class A, int BN, int BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgemm_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, A a, int N,
             int stages, int bres, Epilogue e) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  constexpr int A_BYTES = WG_BM * BK;
  constexpr int B_BYTES = BN * BK;
  // Registers per thread after the split, within the 384 * 168 of the
  // launch: a TMA producer needs few; the conv's gathering producer more,
  // as many as the consumers' accumulators leave (128 of them at BN = 256).
  constexpr int P_REGS = !CONV ? 40 : BN == 256 ? 56 : 96;
  constexpr int C_REGS = !CONV ? 232 : BN == 256 ? 224 : 200;
  static_assert(128 * P_REGS + 256 * C_REGS <= WG_THREADS * 168, "registers");
  const int K = a.K;
  const int k_steps = (K + BK - 1) / BK;
  // bres: the block's whole weight panel (k_steps B tiles) stays resident
  // behind the ring, loaded once; the ring then carries A alone.
  const int STAGE = A_BYTES + (bres ? 0 : B_BYTES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bpanel = ring + stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bpanel + (bres ? k_steps * B_BYTES : 0));
  uint64_t* empty = full + stages;
  uint64_t* bready = empty + stages;
  uint8_t* pars = reinterpret_cast<uint8_t*>(bready + 2);
  const int osize = out_size(e.out_type);
  const int pitch = BN * osize + 16;
  uint8_t* outs = pars + 2 * 24 * BN;
  RowInfo* rows = reinterpret_cast<RowInfo*>(outs + 2 * 64 * pitch);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int M = a.M;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + WG_BM - 1) / WG_BM) * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], CONV ? 129 : 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(bready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The grid is a multiple of the column tiles (the host checks it), so a
  // block keeps one column tile: its epilogue constants are made once, and
  // its weight panel can stay resident (bres).
  if (wg == 0) {
    // ---------------- producer: hands registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(P_REGS)
                 : "memory");
    int s = 0;
    uint32_t ph = 0;
    if (bres && t == 0) {
      mbar_expect_tx(bready, k_steps * B_BYTES);
      for (int ks = 0; ks < k_steps; ++ks)
        tma_load_2d(bpanel + ks * B_BYTES, &map_b, ks * BK,
                    (blockIdx.x % n_tiles) * BN, bready);
    }
    if constexpr (CONV) {
      // Thread t fills 16-byte chunk t % CPR of rows t / CPR + p * RPP:
      // neighbouring threads read neighbouring bytes of one pixel's taps.
      constexpr int CPR = BK / 16;
      constexpr int RPP = 128 / CPR;
      const int chunk = t % CPR;
      const int r0 = t / CPR;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile / n_tiles;
        const int nt = tile - mt * n_tiles;
        named_sync(3, 128);  // every load of the last tile is issued
        {  // the row's window origin: its offset in x, and (ih, iw); a row
           // past M gets an ih that fails every bounds check
          RowInfo ri = a.row(static_cast<long long>(mt) * WG_BM + t);
          if (ri.base < 0) {
            ri.base = 0;
            ri.ih = -(1 << 20);
          } else {
            ri.base += (static_cast<long long>(ri.ih) * a.W + ri.iw) * a.C;
          }
          rows[t] = ri;
        }
        named_sync(3, 128);
        // this thread's position in K: channel c of tap (kh, kw)
        int k = chunk * 16, c = k, kh = 0, kw = 0;
        while (c >= a.C) {
          c -= a.C;
          if (++kw == a.KW) { kw = 0; ++kh; }
        }
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* As = ring + s * STAGE;
          if (t == 0) {
            if (bres) {
              mbar_arrive(&full[s]);
            } else {
              mbar_expect_tx(&full[s], B_BYTES);
              tma_load_2d(As + A_BYTES, &map_b, ks * BK, nt * BN, &full[s]);
            }
          }
          // this step's tap, as an offset from a row's window origin
          const long long tap =
              (static_cast<long long>(kh) * a.W + kw) * a.C + c;
#pragma unroll
          for (int p = 0; p < WG_BM / RPP; ++p) {
            const int r = p * RPP + r0;
            const RowInfo ri = rows[r];
            const bool ok =
                k < K &&
                static_cast<unsigned>(ri.ih + kh) < static_cast<unsigned>(a.H) &&
                static_cast<unsigned>(ri.iw + kw) < static_cast<unsigned>(a.W);
            cp_async16(As + swizzle<BK>(r * BK + chunk * 16),
                       ok ? a.x + ri.base + tap : a.x, ok);
          }
          cp_async_arrive(&full[s]);
          k += BK;
          c += BK;
          while (c >= a.C) {
            c -= a.C;
            if (++kw == a.KW) { kw = 0; ++kh; }
          }
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      }
    } else if (t == 0) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile / n_tiles;
        const int nt = tile - mt * n_tiles;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* As = ring + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          tma_load_2d(As, &map_a, ks * BK, mt * WG_BM, &full[s]);
          if (!bres)
            tma_load_2d(As + A_BYTES, &map_b, ks * BK, nt * BN, &full[s]);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup cw owns rows cw*64 .. +63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C_REGS)
               : "memory");
  const int cw = wg - 1;
  const uint32_t par = smem_u32(pars + cw * 24 * BN);  // column constants
  const uint32_t os = smem_u32(outs + cw * 64 * pitch);
  const bool vec_out = (static_cast<long long>(N) * osize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(e.out) % 16 == 0;
  const float act_lo = e.act == ACT_NONE ? -INFINITY : 0.0f;
  const float act_hi = e.act == ACT_RELU6 ? 6.0f : INFINITY;
  const bool small_k = K <= 256;
  int s = 0;
  uint32_t ph = 0;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int i = t; i < BN / 2; i += 128)
    column_pair(e, (blockIdx.x % n_tiles) * BN + 2 * i, N, par + i * 48);
  if (bres) mbar_wait(bready, 0);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles;
    const int nt = tile - mt * n_tiles;
    const long long m0 = static_cast<long long>(mt) * WG_BM + cw * 64;
    const int n0 = nt * BN;
    int prev = 0;
    fence_regs(acc);
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&full[s], ph);
      if constexpr (CONV)  // cp.async wrote A through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint8_t* As = ring + s * STAGE + cw * 64 * BK;
      const uint64_t da = wg_desc<BK>(As);
      const uint64_t db = wg_desc<BK>(bres ? bpanel + ks * B_BYTES
                                           : ring + s * STAGE + A_BYTES);
      // every k32 slice, those past K too: their A and B bytes are zero
      // (TMA's fill, the gather's), and a branch between the wgmmas would
      // make the compiler fence them apart
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 32; ++j)
        wgmma_s8<BN>(acc, da + 2 * j, db + 2 * j, (ks > 0 || j > 0) ? 1 : 0);
      wgmma_commit();
      if (ks > 0) {  // the last step's products are done: free its slot
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // epilogue: column constants in, the tile staged, 16-byte pieces out
    named_sync(1 + cw, 128);  // the last tile's pieces have left os
    const float osc = e.out_scale;
    if (e.out_type == DT_I8) {
      if (small_k)
        stage_tile<int8_t, BN, true>(acc, par, os, pitch, act_lo, act_hi, osc);
      else
        stage_tile<int8_t, BN, false>(acc, par, os, pitch, act_lo, act_hi, osc);
    } else if (e.out_type == DT_BF16) {
      if (small_k)
        stage_tile<__nv_bfloat16, BN, true>(acc, par, os, pitch, act_lo,
                                            act_hi, osc);
      else
        stage_tile<__nv_bfloat16, BN, false>(acc, par, os, pitch, act_lo,
                                             act_hi, osc);
    } else {
      stage_tile<float, BN, false>(acc, par, os, pitch, act_lo, act_hi, osc);
    }
    named_sync(1 + cw, 128);
    const int per = 16 / osize;  // elements per piece
    const int ppr = BN / per;    // pieces per row
    for (int idx = t; idx < 64 * ppr; idx += 128) {
      const int r = idx / ppr;
      const int pc = idx - r * ppr;
      const long long m = m0 + r;
      const int c0 = n0 + pc * per;
      if (m >= M || c0 >= N) continue;
      const uint4 v = lds128u(os + r * pitch + pc * 16);
      uint8_t* dst = static_cast<uint8_t*>(e.out) +
                     (m * N + c0) * static_cast<long long>(osize);
      if (vec_out && c0 + per <= N) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {  // the row's ragged end, or an unaligned row: byte by byte
        const int nb = min(per, N - c0) * osize;
        for (int b = 0; b < nb; ++b) {
          const uint32_t word = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
          dst[b] = static_cast<uint8_t>(word >> (8 * (b & 3)));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Variant "wgmma_w8": bf16 x int8 weight -> f32 sums on bf16 wgmma (see the
// note at the top).
// ---------------------------------------------------------------------
constexpr int W8_BK = 64;                 // K elements (bf16) per step
constexpr int W8_A_BYTES = WG_BM * 128;   // a step's A tile: 128-byte rows

// Dynamic shared memory of w8gemm_kernel<A, BN> (w8_smem in
// kernels/matmul.py computes the same): 1024 bytes of alignment slack; the
// ring of stages, each the A tile, the bf16 weight tile (BN rows of 128
// bytes) and its int8 staging slot (BN rows of 64 bytes), with two
// barriers; each consumer's column constants; the conv's row table.  The
// outputs leave from the registers: a staged tile's room holds a stage.
__host__ __device__ constexpr int w8gemm_smem(int bn, int stages, bool conv) {
  return 1024 + stages * (W8_A_BYTES + bn * 192 + 16) + 2 * 24 * bn +
         (conv ? WG_BM * 16 : 0);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}

// Four int8 weights (the bytes of q, lowest first) as two bf16 pairs, exact:
// each byte, offset by 128, goes into the low mantissa bits of 2^23 by a
// byte permute (0x4B0000xx), 2^23 + 128 is subtracted in f32 (exact), and
// the upper halves of two such f32 values form a bf16 pair (an integer of
// at most 8 significant bits is its f32 value's upper half).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t q, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  constexpr uint32_t kExp = 0x4B000000u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, kExp, 0x7650)), kBias);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, kExp, 0x7651)), kBias);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, kExp, 0x7652)), kBias);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, kExp, 0x7653)), kBias);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The A rows' pitch in elements: K for a matrix, C for a conv.
inline int host_row_pitch(const MatrixA& a) { return a.K; }
inline int host_row_pitch(const ConvA& a) { return a.C; }

// One consumer warpgroup's 64 x BN tile of f32 sums through the epilogue
// straight to the output, a column pair per store, each step a single
// rounded operation in epilogue_value's order (``par``: the column
// constants, as column_pair makes them); tile row r goes to output row
// row_of(r), none where that is negative.
template <typename OutT, int BN, class RowOf>
__device__ __forceinline__ void store_direct(const float (&acc)[BN / 2],
                                             uint32_t par, RowOf row_of,
                                             int n0, int N, float act_lo,
                                             float act_hi, float out_scale,
                                             void* out) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int gid = (t & 31) >> 2;
  const int tig = t & 3;
  const long long m[2] = {row_of(warp * 16 + gid),
                          row_of(warp * 16 + gid + 8)};
  OutT* o = static_cast<OutT*>(out);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + tig * 2;
    const int n = n0 + c;
    const uint32_t pp = par + (c >> 1) * 48;
    const float4 p0 = lds128(pp);       // pre0 pre1 last0 last1
    const float4 p1 = lds128(pp + 16);  // bias0 bias1 lo0 lo1
    const float4 p2 = lds128(pp + 32);  // hi0 hi1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m[h] < 0 || n >= N) continue;
      float y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = __fmaf_rn(__fmul_rn(acc[j * 4 + 2 * h + q], q ? p0.y : p0.x),
                            q ? p0.w : p0.z, q ? p1.y : p1.x);
        v = fminf(fmaxf(v, act_lo), act_hi);
        y[q] = fminf(fmaxf(v, q ? p1.w : p1.z), q ? p2.y : p2.x);
      }
      OutT* dst = o + m[h] * N + n;
      if (n + 1 < N && (N & 1) == 0) {
        if constexpr (std::is_same<OutT, int8_t>::value) {
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
              requant_byte(y[0], out_scale) |
              (requant_byte(y[1], out_scale) << 8));
        } else if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(y[0], y[1]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
        }
      } else {  // an odd N, or the last column
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (n + q >= N) break;
          if constexpr (std::is_same<OutT, int8_t>::value)
            dst[q] = static_cast<int8_t>(requant_byte(y[q], out_scale));
          else if constexpr (std::is_same<OutT, __nv_bfloat16>::value)
            dst[q] = __float2bfloat16_rn(y[q]);
          else
            dst[q] = y[q];
        }
      }
    }
  }
}

// A row tile of a unit: a matrix's (and a gathered conv's) row tile mt
// covers output rows 128 mt .. 128 mt + 127; a conv whose A comes by TMA
// (th > 0) covers a th x tw rectangle of output pixels of one image, tile
// row r at (r / tw, r % tw), row tile mt = (image, rectangle row,
// rectangle column).
struct RowTile {
  long long m0;  // first output row (128-row tiles)
  int img, oh0, ow0;
};

// A build with FCNN_W8_PROBE_NO_CONVERT or FCNN_W8_PROBE_NO_MMA defined
// (tools/w8_gemm_probe.py, timing only: its results are wrong) skips the
// weight tile's conversion or the wgmma.
//
// A unit of work is one row tile, one BN-wide column tile and one slice of
// its K steps: unit u is column tile u % n_tiles, slice (u / n_tiles) %
// split, row tile u / (n_tiles * split).  The grid is a multiple of the
// column tiles, so a block keeps its column tile.  Slice sk runs steps
// [sk * per, min((sk + 1) * per, k_steps)); with split > 1 its f32 sums go
// to ws[sk] (M x N) and splitk_reduce_kernel applies the epilogue.
template <class A, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
w8gemm_kernel(const __grid_constant__ CUtensorMap map_a, A a,
              const int8_t* __restrict__ w, int N, int stages, int split,
              int per, int th, int tw, float* __restrict__ ws, Epilogue e) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  constexpr int BB = BN * 128;  // the bf16 weight tile
  constexpr int BI = BN * 64;   // its int8 staging slot
  constexpr int STAGE = W8_A_BYTES + BB + BI;
  // Registers per thread after the split, within the 384 * 168 of the
  // launch: the producer issues the weight's cp.async (and the conv's
  // gather); a consumer holds at most 64 f32 sums.
  constexpr int P_REGS = 96;
  constexpr int C_REGS = 200;
  static_assert(128 * P_REGS + 256 * C_REGS <= WG_THREADS * 168, "registers");
  const int K = a.K;
  const int k_steps = (K + W8_BK - 1) / W8_BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint8_t* pars = reinterpret_cast<uint8_t*>(empty + stages);
  RowInfo* rows = reinterpret_cast<RowInfo*>(pars + 2 * 24 * BN);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int M = a.M;
  const int n_tiles = (N + BN - 1) / BN;
  // a conv's A by TMA: th x tw rectangles of one image, one box per tap
  const bool tma_conv = CONV && th > 0;
  int rect_h = 1, rect_w = 1, row_tiles = (M + WG_BM - 1) / WG_BM;
  if constexpr (CONV) {
    if (tma_conv) {
      rect_h = (a.OH + th - 1) / th;
      rect_w = (a.OW + tw - 1) / tw;
      row_tiles = M / (a.OH * a.OW) * rect_h * rect_w;
    }
  }
  const int units = row_tiles * split * n_tiles;
  auto row_tile = [&](int mt) {
    RowTile rt;
    rt.m0 = static_cast<long long>(mt) * WG_BM;
    rt.img = mt / (rect_h * rect_w);
    const int q = mt - rt.img * rect_h * rect_w;
    rt.oh0 = (q / rect_w) * th;
    rt.ow0 = (q % rect_w) * tw;
    return rt;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the producer's 128 cp.async arrivals, and the A tile's TMA
      mbar_init(&full[s], CONV && !tma_conv ? 128 : 129);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(P_REGS)
                 : "memory");
    int s = 0;
    uint32_t ph = 0;
    const bool b16 = K % 16 == 0;  // 16-byte weight pieces, else 8
    // the int8 weight rows of column tile nt at step ks into the staging
    // slot: row r at r * 64, zeros past N and K
    auto load_b = [&](uint8_t* bi, int nt, int ks) {
      const int kb = ks * W8_BK;
      if (b16) {
#pragma unroll
        for (int i = t; i < BN * 4; i += 128) {
          const int n = nt * BN + (i >> 2);
          const int k = kb + (i & 3) * 16;
          const bool ok = n < N && k < K;
          cp_async16(bi + i * 16, ok ? w + static_cast<long long>(n) * K + k : w,
                     ok);
        }
      } else {
#pragma unroll
        for (int i = t; i < BN * 8; i += 128) {
          const int n = nt * BN + (i >> 3);
          const int k = kb + (i & 7) * 8;
          const bool ok = n < N && k < K;
          cp_async8(bi + i * 8, ok ? w + static_cast<long long>(n) * K + k : w,
                    ok);
        }
      }
    };
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int nt = u % n_tiles;
      const int mt = u / (n_tiles * split);
      const int sk = (u / n_tiles) % split;
      const int ks0 = sk * per;
      const int ks1 = min(k_steps, ks0 + per);
      // A by TMA: a matrix's 128 x 64 box, or a conv's (64 channels, tw,
      // th, 1) box of the tap's shifted window (zeros outside the image:
      // the padding); the weight by the producer's cp.async
      auto tma_steps = [&]() {
        const RowTile rt = row_tile(mt);
        for (int ks = ks0; ks < ks1; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* As = ring + s * STAGE;
          if (t == 0) {
            if constexpr (CONV) {
              const int cblk = a.C / W8_BK;
              const int tap = ks / cblk;
              const int kh = tap / a.KW;
              const int kw = tap - kh * a.KW;
              mbar_expect_tx(&full[s], th * tw * 128);
              tma_load_4d(As, &map_a, (ks - tap * cblk) * W8_BK,
                          rt.ow0 - a.pw + kw, rt.oh0 - a.ph + kh, rt.img,
                          &full[s]);
            } else {
              mbar_expect_tx(&full[s], W8_A_BYTES);
              tma_load_2d(As, &map_a, ks * W8_BK, mt * WG_BM, &full[s]);
            }
          }
          load_b(As + W8_A_BYTES + BB, nt, ks);
          cp_async_arrive(&full[s]);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      };
      if constexpr (!CONV) {
        tma_steps();
      } else if (tma_conv) {
        tma_steps();
      } else {
        // The gather: thread t fills 16-byte chunk t % 8 (8 channels) of
        // rows t / 8 + 16 p, neighbouring threads on neighbouring bytes of
        // one pixel.
        const int chunk = t & 7;
        const int r0 = t >> 3;
        named_sync(3, 128);  // every load of the last tile is issued
        {
          RowInfo ri = a.row(static_cast<long long>(mt) * WG_BM + t);
          if (ri.base < 0) {
            ri.base = 0;
            ri.ih = -(1 << 20);
          } else {
            ri.base += (static_cast<long long>(ri.ih) * a.W + ri.iw) * a.C;
          }
          rows[t] = ri;
        }
        named_sync(3, 128);
        // this thread's position in K: channel c of tap (kh, kw)
        int k = ks0 * W8_BK + chunk * 8;
        const int tap0 = k / a.C;
        int c = k - tap0 * a.C, kh = tap0 / a.KW, kw = tap0 - kh * a.KW;
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(a.x);
        for (int ks = ks0; ks < ks1; ++ks) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* As = ring + s * STAGE;
          load_b(As + W8_A_BYTES + BB, nt, ks);
          const long long tap =
              (static_cast<long long>(kh) * a.W + kw) * a.C + c;
#pragma unroll
          for (int p = 0; p < WG_BM / 16; ++p) {
            const int r = p * 16 + r0;
            const RowInfo ri = rows[r];
            const bool ok =
                k < K &&
                static_cast<unsigned>(ri.ih + kh) < static_cast<unsigned>(a.H) &&
                static_cast<unsigned>(ri.iw + kw) < static_cast<unsigned>(a.W);
            cp_async16(As + swizzle<128>(r * 128 + chunk * 16),
                       ok ? xb + ri.base + tap : xb, ok);
          }
          cp_async_arrive(&full[s]);
          k += W8_BK;
          c += W8_BK;
          while (c >= a.C) {
            c -= a.C;
            if (++kw == a.KW) { kw = 0; ++kh; }
          }
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup cw owns rows cw*64 .. +63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C_REGS)
               : "memory");
  const int cw = wg - 1;
  const int ct = tid - 128;  // 0 .. 255 over both consumers
  const uint32_t par = smem_u32(pars + cw * 24 * BN);
  const float act_lo = e.act == ACT_NONE ? -INFINITY : 0.0f;
  const float act_hi = e.act == ACT_RELU6 ? 6.0f : INFINITY;
  int s = 0;
  uint32_t ph = 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if (split == 1)
    for (int i = t; i < BN / 2; i += 128)
      column_pair(e, (blockIdx.x % n_tiles) * BN + 2 * i, N, par + i * 48);

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int nt = u % n_tiles;
    const int mt = u / (n_tiles * split);
    const int sk = (u / n_tiles) % split;
    const int ks0 = sk * per;
    const int ks1 = min(k_steps, ks0 + per);
    const int n0 = nt * BN;
    int prev = 0;
    fence_regs(acc);
    for (int ks = ks0; ks < ks1; ++ks) {
      mbar_wait(&full[s], ph);
      uint8_t* As = ring + s * STAGE;
      const uint32_t bb = smem_u32(As + W8_A_BYTES);
      const uint32_t bi = bb + BB;
      // the staged int8 weight tile into the bf16 tile, 128-byte swizzled:
      // input piece i (16 weights of row i / 4) becomes the row's 16-byte
      // chunks 2 (i % 4) and 2 (i % 4) + 1, thread ct taking pieces ct +
      // 256 j, all its loads issued first; the last step's wgmma runs
      // meanwhile
#ifndef FCNN_W8_PROBE_NO_CONVERT
      constexpr int PIECES = (BN * 4 + 255) / 256;  // a thread's, at most
      uint4 q[PIECES];
#pragma unroll
      for (int j = 0; j < PIECES; ++j)
        if (BN * 4 >= 256 || ct + j * 256 < BN * 4)
          q[j] = lds128u(bi + (ct + j * 256) * 16);
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        const int i = ct + j * 256;
        if (BN * 4 < 256 && i >= BN * 4) break;
        uint4 lo, hi;
        i8x4_to_bf16(q[j].x, lo.x, lo.y);
        i8x4_to_bf16(q[j].y, lo.z, lo.w);
        i8x4_to_bf16(q[j].z, hi.x, hi.y);
        i8x4_to_bf16(q[j].w, hi.z, hi.w);
        const int r = i >> 2;
        const int p = i & 3;
        const uint32_t row = bb + r * 128;
        sts128u(row + (((2 * p) ^ (r & 7)) << 4), lo);
        sts128u(row + (((2 * p + 1) ^ (r & 7)) << 4), hi);
      }
#endif
      // the bf16 tile (and the conv's cp.async A) to the async proxy, and
      // both consumers' halves of it written
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(4, 256);
      const uint64_t da = wg_desc<128>(As + cw * 64 * 128);
      const uint64_t db = wg_desc<128>(As + W8_A_BYTES);
      wgmma_fence();
#ifndef FCNN_W8_PROBE_NO_MMA
#pragma unroll
      for (int j = 0; j < W8_BK / 16; ++j)
        wgmma_bf16<BN>(acc, da + 2 * j, db + 2 * j, (ks > ks0 || j > 0) ? 1 : 0);
#endif
      wgmma_commit();
      if (ks > ks0) {  // the last step's products are done: free its slot
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    const RowTile rt = row_tile(mt);
    const int lr0 = cw * 64;  // this consumer's first row in the tile
    if (split > 1) {  // this slice's sums, straight from the registers
      float* dst = ws + static_cast<long long>(sk) * M * N;
      const int warp = t >> 5;
      const int gid = (t & 31) >> 2;
      const int tig = t & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + j * 8 + tig * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = rt.m0 + lr0 + warp * 16 + gid + 8 * h;
          if (m >= M) continue;
          float* p = dst + m * N + c;
          const float v0 = acc[j * 4 + 2 * h];
          const float v1 = acc[j * 4 + 2 * h + 1];
          if (c + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (c < N) p[0] = v0;
            if (c + 1 < N) p[1] = v1;
          }
        }
      }
      continue;
    }
    // the tile's rows in the output: rows of a row tile, or the pixels of
    // a conv's rectangle
    auto row_of = [&](int r) -> long long {
      const int lr = lr0 + r;
      if constexpr (CONV) {
        if (tma_conv) {
          const int oh = rt.oh0 + lr / tw;
          const int ow = rt.ow0 + lr % tw;
          return lr < th * tw && oh < a.OH && ow < a.OW
              ? (static_cast<long long>(rt.img) * a.OH + oh) * a.OW + ow
              : -1ll;
        }
      }
      const long long m = rt.m0 + lr;
      return m < M ? m : -1ll;
    };
    const float osc = e.out_scale;
    if (e.out_type == DT_I8)
      store_direct<int8_t, BN>(acc, par, row_of, n0, N, act_lo, act_hi, osc,
                               e.out);
    else if (e.out_type == DT_BF16)
      store_direct<__nv_bfloat16, BN>(acc, par, row_of, n0, N, act_lo, act_hi,
                                      osc, e.out);
    else
      store_direct<float, BN>(acc, par, row_of, n0, N, act_lo, act_hi, osc,
                              e.out);
  }
}

// The split-K pass: out[m, n] = epilogue(ws[0][m][n] + ws[1][m][n] + ...),
// the slices added in index order with f32 rounding, two columns a thread
// (T = float; a template, so that each unit that includes this defines it).
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const T* __restrict__ ws, int split, int M, int N,
                     Epilogue e) {
  const int half = (N + 1) / 2;
  const long long pairs = static_cast<long long>(M) * half;
  const long long mn = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < pairs;
       i += gridDim.x * 256ll) {
    const long long m = i / half;
    const int c = 2 * static_cast<int>(i - m * half);
    const long long idx = m * N + c;
    const bool two = c + 1 < N;
    T v0 = ws[idx];
    T v1 = two ? ws[idx + 1] : T(0);
    for (int sk = 1; sk < split; ++sk) {
      v0 = __fadd_rn(v0, ws[sk * mn + idx]);
      if (two) v1 = __fadd_rn(v1, ws[sk * mn + idx + 1]);
    }
    epilogue_store2(v0, v1, m, c, N, e);
  }
}

// ---------------------------------------------------------------------
// Variant "mma_sync": int8 x int8 -> int32 on mma.sync m16n8k32, for the
// shapes "wgmma" does not take.  Block tile 128 (M) x 64 (N), K step 64
// bytes, 8 warps as 4 (M) x 2 (N); a warp owns 32 x 32.  Single bytes go
// to shared memory, one tile at a time; shared rows are padded to 80 bytes
// so a warp's fragment loads hit 32 distinct banks.
// ---------------------------------------------------------------------
constexpr int IG_BM = 128;
constexpr int IG_BN = 64;
constexpr int IG_BK = 64;
constexpr int IG_LDS = IG_BK + 16;
constexpr int IG_THREADS = 256;

template <class A>
__global__ void __launch_bounds__(IG_THREADS)
igemm_kernel(A a, const int8_t* __restrict__ w, int N, Epilogue e) {
  __shared__ __align__(16) int8_t As[IG_BM][IG_LDS];
  __shared__ __align__(16) int8_t Bs[IG_BN][IG_LDS];
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

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  for (int k0 = 0; k0 < K; k0 += IG_BK) {
    __syncthreads();  // the row table is written / the last tile consumed
    for (int c = tid; c < IG_BM * IG_BK; c += IG_THREADS) {
      const int r = c / IG_BK;
      const int kk = c % IG_BK;
      long long off;
      As[r][kk] = a.offset(rows[r], k0 + kk, &off)
          ? static_cast<int8_t>(a.x[off]) : static_cast<int8_t>(0);
    }
    for (int c = tid; c < IG_BN * IG_BK; c += IG_THREADS) {
      const int nn = c / IG_BK;
      const int kk = c % IG_BK;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[nn][kk] = (k < K && n < N)
          ? w[static_cast<long long>(n) * K + k] : static_cast<int8_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < IG_BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + gid;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 4]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 4]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + tig * 4]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp_n * 32 + nt * 8 + gid;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + tig * 4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 16 + tig * 4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
      }
    }
  }

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
// Variant "mma_bf16": bf16 x bf16 with f32 sums (the bf16 paths' FC,
// M = batch).  A block owns 128 rows x 8 columns, so N = 1000 gives 125
// blocks (each reads A from L2; at M = 128 that costs less than leaving
// SMs idle).  Its 8 warps each sum their own slice of K on mma.sync
// m16n8k16, fragments loaded straight from global memory as 16-byte
// pieces (K a multiple of 8, 16-byte aligned pointers), every load of a
// K step issued before its products, so a step costs one L2 latency.  In
// each 32-deep K step thread tig feeds the fragment slots of
// k = 2*tig + {0, 1, 8, 9, 16, 17, 24, 25} with the eight consecutive
// k = 8*tig .. 8*tig + 7, for A and B alike, so a warp reads whole
// sectors.  Each step's products go into a fresh tensor-core sum that one
// rounded f32 add takes into the warp's sum, as fused_chain_float.cu does;
// the warps' sums are then added in a fixed order through shared memory
// ((w + w+4), then the four in order): deterministic, no atomics.
// ---------------------------------------------------------------------
constexpr int BG_ROWS = 128;
constexpr int BG_COLS = 8;
constexpr int BG_NT = BG_COLS / 8;
constexpr int BG_WARPS = 8;

template <typename T>  // __nv_bfloat16 (a template: defined in every unit)
__global__ void __launch_bounds__(BG_WARPS * 32)
bgemm_kernel(const T* __restrict__ x, const T* __restrict__ w, int M, int K,
             int N, Epilogue e) {
  __shared__ float red[BG_WARPS / 2][BG_ROWS * BG_COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BG_ROWS;
  const int n0 = blockIdx.x * BG_COLS;
  const int steps = (K + 31) / 32;
  const int s0 = warp * steps / BG_WARPS;
  const int s1 = (warp + 1) * steps / BG_WARPS;
  const uint4* wrow[BG_NT];
  bool nok[BG_NT];
#pragma unroll
  for (int nt = 0; nt < BG_NT; ++nt) {
    const int n = n0 + nt * 8 + gid;
    nok[nt] = n < N;
    wrow[nt] = reinterpret_cast<const uint4*>(
        w + static_cast<long long>(nok[nt] ? n : 0) * K);
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[8][BG_NT][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int nt = 0; nt < BG_NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  for (int st = s0; st < s1; ++st) {
    const int k = st * 32 + 8 * tig;  // this thread's 8 consecutive k
    uint4 b[BG_NT];
#pragma unroll
    for (int nt = 0; nt < BG_NT; ++nt)
      b[nt] = (nok[nt] && k < K) ? wrow[nt][k >> 3] : zero;
    uint4 av[8][2];  // the step's A pieces, all loads in flight at once
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + mt * 16 + gid + 8 * h;
        av[mt][h] = (r < M && k < K)
            ? *reinterpret_cast<const uint4*>(x + r * K + k) : zero;
      }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const uint4 lo = av[mt][0];
      const uint4 hi = av[mt][1];
      // slots (row, k): a[half] = {(r, 2t), (r+8, 2t), (r, 2t+8), (r+8, 2t+8)}
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int nt = 0; nt < BG_NT; ++nt) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(p, a0, b[nt].x, b[nt].y);
        mma_bf16(p, a1, b[nt].z, b[nt].w);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt][q] = __fadd_rn(acc[mt][nt][q], p[q]);
      }
    }
  }
  // warps 4-7 hand their sums to warps 0-3, which add them and publish
  auto slot = [&](int mt, int nt, int q) {
    return (mt * 16 + gid + 8 * (q >> 1)) * BG_COLS + nt * 8 + 2 * tig +
           (q & 1);
  };
  if (warp >= BG_WARPS / 2) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < BG_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[warp - BG_WARPS / 2][slot(mt, nt, q)] = acc[mt][nt][q];
  }
  __syncthreads();
  if (warp < BG_WARPS / 2) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < BG_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& v = red[warp][slot(mt, nt, q)];
          v = __fadd_rn(acc[mt][nt][q], v);
        }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BG_ROWS * BG_COLS; i += BG_WARPS * 32) {
    float v = red[0][i];
#pragma unroll
    for (int wi = 1; wi < BG_WARPS / 2; ++wi) v = __fadd_rn(v, red[wi][i]);
    const long long r = m0 + i / BG_COLS;
    const int c = n0 + i % BG_COLS;
    if (r < M && c < N) epilogue_store(v, r, c, N, e);
  }
}

// ---------------------------------------------------------------------
// Variant "simt" (f32 x f32 or int8 w, and the bf16 x int8 launches the
// "wgmma_w8" plan refuses): a plain SIMT tile, f32 FMA sums, 64 x 64
// tiles, 4 x 4 outputs per thread.  At full width only the f32 witness of
// VGG-16 w8's Winograd route (its FCs, f32 x int8 w) runs it.
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
  __shared__ float Bs[FG_BK][FG_BN + 1];
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
      const int kk = c % FG_BK;
      const int nn = c / FG_BK;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N)
          ? to_f32(w[static_cast<long long>(n) * K + k]) : 0.0f;
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
// Host side.  Every launch returns its cudaError_t (0 on success); a plan
// that does not fit the operands is refused (cudaErrorInvalidValue), never
// replaced by another variant.
// ---------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query: the library links against the runtime alone.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map over the int8 (elem 1) or bf16 (elem 2) (rows, cols) row-major
// matrix at base, box box_rows x box_cols elements (a box row of 128 bytes
// swizzled at 128, of 64 at 64), zero fill outside.  Encoded per launch:
// the caching allocator reuses addresses.
inline bool make_map(CUtensorMap* map, const void* base, long long rows,
                     int cols, int box_rows, int box_cols, int elem = 1) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 static_cast<cuuint64_t>(elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class A, int BN, int BK>
inline int launch_wgemm(const A& a, const int8_t* w, int N, const GemmPlan& p,
                        const Epilogue& e, cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  CUtensorMap ma{}, mb{};
  if (!CONV && !make_map(&ma, a.x, a.M, a.K, WG_BM, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!make_map(&mb, w, N, a.K, BN, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (N + BN - 1) / BN;
  const int smem = wgemm_smem(BN, BK, p.stages, (a.K + BK - 1) / BK, p.bres,
                              out_size(e.out_type), CONV);
  if (smem != p.smem || p.stages < 2 || p.grid < 1 || p.grid % n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wgemm_kernel<A, BN, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, WG_THREADS, smem, s>>>(ma, mb, a, N, p.stages, p.bres, e);
  return static_cast<int>(cudaGetLastError());
}

// A TMA map over the bf16 NHWC image x as (C, W, H, N), box (64 channels,
// bw, bh, 1), 128-byte swizzle, zero fill outside (the conv's padding).
inline bool make_map_nhwc(CUtensorMap* map, const void* base, int C, int W,
                          int H, int N, int bw, int bh) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(W8_BK),
                             static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// "wgmma_w8": refuses (cudaErrorInvalidValue) a plan whose shared memory,
// grid or K slices differ from the kernel's own count, a split without a
// workspace ``ws`` (split x M x N f32) or on a conv, or a conv tile by TMA
// (th x tw) that the conv does not allow.
template <class A, int BN>
inline int launch_w8gemm(const A& a, const int8_t* w, int N,
                         const GemmPlan& p, float* ws, const Epilogue& e,
                         cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma{};
  if constexpr (CONV) {
    // A by TMA: stride 1, whole 64-channel blocks, a rectangle of at most
    // 128 pixels
    if (p.th > 0 &&
        (a.sh != 1 || a.sw != 1 || a.C % W8_BK || p.tw < 1 ||
         p.th * p.tw > WG_BM ||
         !make_map_nhwc(&ma, a.x, a.C, a.W, a.H, a.M / (a.OH * a.OW), p.tw,
                        p.th)))
      return bad;
  } else {
    if (p.th != 0 || !make_map(&ma, a.x, a.M, a.K, WG_BM, W8_BK, 2))
      return bad;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const int k_steps = (a.K + W8_BK - 1) / W8_BK;
  const int split = p.split;
  if (split < 1 || (split > 1 && (CONV || ws == nullptr))) return bad;
  const int per = (k_steps + split - 1) / split;
  if ((split - 1) * per >= k_steps) return bad;  // an empty slice
  const int smem = w8gemm_smem(BN, p.stages, CONV);
  if (smem != p.smem || p.bk != 2 * W8_BK || p.stages < 2 || p.grid < 1 ||
      p.grid % n_tiles)
    return bad;
  auto kern = w8gemm_kernel<A, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, WG_THREADS, smem, s>>>(ma, a, w, N, p.stages, split, per,
                                        p.th, p.tw, ws, e);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(a.M) * ((N + 1) / 2);
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 132 * 8 ? pairs / 256 + 1 : 132 * 8);
  splitk_reduce_kernel<float><<<blocks, 256, 0, s>>>(ws, split, a.M, N, e);
  return static_cast<int>(cudaGetLastError());
}

// x_type/w_type: DType.  ``row_ok``: the A rows' pitch (K for a matrix, C
// for a conv) is a multiple of 16 bytes and at least 16, the caller's
// check of what "wgmma" needs besides aligned pointers.  ``ws``: the
// split-K workspace of a "wgmma_w8" plan with split > 1, else null.
template <class A>
inline int launch_gemm(const A& a, const void* w, int N, int x_type,
                       int w_type, bool row_ok, const GemmPlan& p, float* ws,
                       const Epilogue& e, cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 0 || N <= 0) return 0;
  const bool int8 = x_type == DT_I8 && w_type == DT_I8;
  if (p.variant == V_WGMMA_W8) {
    if (x_type != DT_BF16 || w_type != DT_I8 || host_row_pitch(a) % 8 ||
        !aligned(a.x, 16) || !aligned(w, 16))
      return bad;
    const int8_t* wq = static_cast<const int8_t*>(w);
    switch (p.bn) {
      case 32: return launch_w8gemm<A, 32>(a, wq, N, p, ws, e, s);
      case 64: return launch_w8gemm<A, 64>(a, wq, N, p, ws, e, s);
      case 128: return launch_w8gemm<A, 128>(a, wq, N, p, ws, e, s);
      default: return bad;
    }
  }
  if (p.split != 1 || p.th != 0) return bad;
  if (p.variant == V_WGMMA_S8) {
    if (!int8 || !row_ok || !aligned(a.x, 16) || !aligned(w, 16)) return bad;
    const int8_t* wq = static_cast<const int8_t*>(w);
    switch (p.bn * 1000 + p.bk) {
      case 32064: return launch_wgemm<A, 32, 64>(a, wq, N, p, e, s);
      case 32128: return launch_wgemm<A, 32, 128>(a, wq, N, p, e, s);
      case 64064: return launch_wgemm<A, 64, 64>(a, wq, N, p, e, s);
      case 64128: return launch_wgemm<A, 64, 128>(a, wq, N, p, e, s);
      case 128064: return launch_wgemm<A, 128, 64>(a, wq, N, p, e, s);
      case 128128: return launch_wgemm<A, 128, 128>(a, wq, N, p, e, s);
      case 256064: return launch_wgemm<A, 256, 64>(a, wq, N, p, e, s);
      case 256128: return launch_wgemm<A, 256, 128>(a, wq, N, p, e, s);
      default: return bad;
    }
  }
  if (p.variant == V_MMA_S8) {
    if (!int8) return bad;
    dim3 grid(static_cast<unsigned>((a.M + IG_BM - 1) / IG_BM),
              static_cast<unsigned>((N + IG_BN - 1) / IG_BN));
    igemm_kernel<A><<<grid, IG_THREADS, 0, s>>>(
        a, static_cast<const int8_t*>(w), N, e);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.variant == V_MMA_BF16) {
    if constexpr (CONV) {
      return bad;
    } else {
      if (x_type != DT_BF16 || w_type != DT_BF16 || a.K % 8 ||
          !aligned(a.x, 16) || !aligned(w, 16))
        return bad;
      dim3 grid(static_cast<unsigned>((N + BG_COLS - 1) / BG_COLS),
                static_cast<unsigned>((a.M + BG_ROWS - 1) / BG_ROWS));
      bgemm_kernel<__nv_bfloat16><<<grid, BG_WARPS * 32, 0, s>>>(
          reinterpret_cast<const __nv_bfloat16*>(a.x),
          static_cast<const __nv_bfloat16*>(w), a.M, a.K, N, e);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (p.variant != V_SIMT) return bad;
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
    return bad;
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

inline GemmPlan make_plan(int variant, int bn, int bk, int stages, int bres,
                          int grid, int smem, int split, int th, int tw) {
  GemmPlan p;
  p.split = split;
  p.th = th;
  p.tw = tw;
  p.variant = variant;
  p.bn = bn;
  p.bk = bk;
  p.stages = stages;
  p.bres = bres;
  p.grid = grid;
  p.smem = smem;
  return p;
}

}  // namespace fcnn
