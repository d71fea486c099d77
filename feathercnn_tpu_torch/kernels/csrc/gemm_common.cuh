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
// bound by operations.  A grouped conv (ResNeXt-50's) does 9*C/group
// operations per byte and is bound by bytes at every stage.
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
// main loop at K = 64), with the activation's, the lo/hi and an int8
// output's +-127 clamps folded into one per column (column_pair), and the
// tile leaves as 16-byte row pieces; a tile that spans all of an even N
// whose rows are not 16-byte pieces is staged packed and leaves as one
// run.  At K <= 256 that arithmetic, not the bytes, binds the launch
// (tools/int8_gemm_probe.py --parts).  The whole K accumulates in int32:
// exact.
//
// A grouped 3x3 int8 conv (1 < group < C) runs as super-groups on variant
// "wgmma_halo" (hgemm_kernel below): column tile nt is q whole groups whose
// 32 outputs read only input channels nt*32 .. nt*32 + 31, against a
// compact weight whose rows are zero off each output channel's group (K =
// 9*32; kernels/matmul.py::grouped_layout).  Each tile's input halo comes
// once by TMA and its nine taps are read from it by ldmatrix into
// register-A wgmma, so A's bytes from L2 are the halo's, ~1.4 times x's,
// where a gather of each tap would move nine times x's.  Any other grouped
// conv runs on "wgmma" with its block-diagonal dense weight.
//
// Rows that are not whole 16-byte pieces (K or C not a multiple of 16, or
// a matrix's x not 16-byte aligned) take variant "wgmma_ragged": the same
// kernel, ring, consumers and epilogue with another A path.  The weight's
// rows are padded to a 16-byte pitch once per node (gemm_layout; the
// kernel reads the pitch, ldw, and TMA fills the bytes past K with zeros),
// so B still comes by TMA.  A matrix's 128-row A tile is one run of
// 128 * K bytes (whatever K is): a bulk copy (cp.async.bulk) brings the
// run's 16-byte-aligned middle into a staging ring of its own, a few tiles
// ahead, the producer's threads copy the unaligned head and tail bytes,
// and then each thread re-lays its row into the swizzled K-major stage,
// funnel-shifting aligned 32-bit words into 16-byte pieces and writing
// zeros from K to the K step.  HBM bytes are the useful bytes.  Up to
// K = 256 (RAGGED_K_MAX: the staged tiles fit beside the ring).  A conv
// with C a multiple of 8 gathers A with 8-byte cp.async (a tap's channels
// are whole 8-byte pieces; the src-size 0 form zero-fills the padding and
// the K past its end).  What is left takes variant "mma_sync"
// (igemm_kernel, mma.sync m16n8k32 over single-byte tiles): C not a
// multiple of 8 (the stems' C = 3), a conv x not 8-byte aligned, a ragged
// matrix past K = 256; no zoo launch takes it.  Where a launch's tiles
// fill at most a third of the SMs and its blocks' K loops are long (the
// convs at batch 1, the score convs at N = 21), its K splits over the
// grid: each slice's int32 sums go to a workspace and
// splitk_reduce_kernel<int> adds the slices (exact) and applies the
// epilogue, as "wgmma_w8" below does in f32.
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
//
// bf16 x bf16 (variant "wgmma_bf16", w8gemm_kernel<MatrixA, BN, true>: the
// bf16 FC, M = batch): the same kernel with the bf16 weight tile brought
// by TMA beside A (no staging slot, no conversion), its split-K and its
// second pass.
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
  V_WGMMA_W8 = 3,
  V_WGMMA_RAGGED = 4,
  V_WGMMA_BF16 = 5,
  V_WGMMA_HALO = 6
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

// A launch's plan, made on the host: the variant, and for the wgmma
// variants the tile width, the K step in bytes, the ring's stages,
// whether the weight panel stays resident, the grid and the dynamic shared
// memory, which the kernel's own layout must equal, and the K slices (1,
// or the split-K slices summed by a second pass); the weight's row pitch
// and, for a "wgmma_ragged" matrix, the tiles its staging ring holds.
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
  int ldw;  // elements between the weight's (N, K) rows (0: K)
  int sst;  // "wgmma_ragged" matrix: staged A tiles in flight (>= 2)
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
// 8 bytes, the same way (cp.async.ca: .cg copies 16 bytes only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
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
  int d;          // dilation: tap (kh, kw) reads pixel (kh*d, kw*d) of the
                  // row's window
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
    const int ih = r.ih + kh * d;
    const int iw = r.iw + kw * d;
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

// The TMA descriptor into the cache before its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The main loops' side of programmatic dependent launch: the split-K pass
// (launched with it) may start its blocks once every block of the main
// loop has passed this point; it waits for the main loop's results
// itself (griddepcontrol.wait).  Without a dependent launch it does
// nothing.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// ``bytes`` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the bulk copy engine; completion is counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
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

// A "wgmma_ragged" matrix's K at most: its staged tiles (128 * K bytes
// each, at least two) fit beside the ring.
constexpr int RAGGED_K_MAX = 256;

// One staging buffer of a "wgmma_ragged" matrix: a tile's 128 * K bytes,
// placed at the run's own offset mod 16 (so the bulk copy's aligned middle
// lands aligned), plus the 20 bytes the re-lay's last word loads may read
// past it, in 128-byte units.
__host__ __device__ constexpr int ragged_stage_bytes(int k) {
  return (WG_BM * k + 48 + 127) / 128 * 128;
}

// Dynamic shared memory of wgemm_kernel<A, BN, BK, RAGGED> (gemm_plan in
// kernels/matmul.py computes the same): 1024 bytes of alignment slack; the
// ring of (A, B) stages, or of A stages and the resident weight panel
// (bres: k_steps tiles of BN x BK); a ragged matrix's sst staging buffers
// of sb bytes; two barriers per stage and the panel's (16 bytes), and one
// per staging buffer (16 bytes each); each consumer's per-column epilogue
// constants (48 bytes per column pair) and staged output tile (64 rows of
// BN * out_size + 16 bytes); the conv's row table.
__host__ __device__ constexpr int wgemm_smem(int bn, int bk, int stages,
                                             int k_steps, bool bres,
                                             int osize, bool conv, int sb = 0,
                                             int sst = 0) {
  return 1024 + stages * (WG_BM + (bres ? 0 : bn)) * bk +
         (bres ? k_steps * bn * bk : 0) + sst * (sb + 16) + 16 * stages +
         16 + 2 * 24 * bn + 2 * 64 * (bn * osize + 16) +
         (conv ? WG_BM * 16 : 0);
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
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
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

// clamp(clamp(v, a, b), a2, b2) as the one clamp(v, a, b) it equals
// (fminf(fmaxf(v, a), b), a > b giving b): the intersection where the
// two meet, else the constant the nesting gives (a2 if b < a2, else b2).
__device__ __forceinline__ void fold_clamp(float& a, float& b, float a2,
                                           float b2) {
  a = fminf(a, b);
  a2 = fminf(a2, b2);
  if (fmaxf(a, a2) <= fminf(b, b2)) {
    a = fmaxf(a, a2);
    b = fminf(b, b2);
  } else {
    a = b = b < a2 ? a2 : b2;
  }
}

// The epilogue constants of output columns n and n + 1 (n even), as the
// wgmma kernels keep them: y = fma(acc * pre, last, bias), then one clamp
// to [lo, hi].  This is epilogue_value step for step: pre is w_scale[n]
// where both scales apply (else 1, an exact multiply), last the scale of
// the FMA (x_scale, else w_scale[n], else 1) and bias -0.0 where there is
// none (fma(y, s, -0.0) rounds as y * s does).  [lo, hi] folds the
// activation's clamp and the lo/hi clamp (fold_clamp), and for an int8
// output (out_scale > 0 and finite: launch_wgemm checks it) the
// requantization's +-127 too, as +-127 / out_scale: a y held there gives
// t = y * out_scale within an ulp of +-127, which rounds to +-127, and
// every y inside gives |t| <= 127 + an ulp, so rint(t) needs no clamp of
// its own (requant_i8's bytes, bit for bit; requant_byte's clamp, where
// store_direct applies it, then changes nothing).
__device__ __forceinline__ void column_pair(const Epilogue& e, int n, int N,
                                            uint32_t dst) {
  float v[10];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float pre = 1.0f, last = 1.0f, bias = -0.0f;
    float lo = e.act == ACT_NONE ? -INFINITY : 0.0f;
    float hi = e.act == ACT_RELU6 ? 6.0f : INFINITY;
    if (n + q < N) {
      const float ws = e.w_scale ? e.w_scale[n + q] : 1.0f;
      if (e.x_scale != 1.0f) {
        pre = ws;
        last = e.x_scale;
      } else {
        last = ws;
      }
      if (e.bias) bias = e.bias[n + q];
      if (e.lo) fold_clamp(lo, hi, e.lo[n + q], e.hi[n + q]);
    }
    if (e.out_type == DT_I8 && e.out_scale > 0.0f && e.out_scale < INFINITY) {
      const float bound = __fdiv_rn(127.0f, e.out_scale);
      fold_clamp(lo, hi, -bound, bound);
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
// all unrolled, and at K <= 256 these steps, not the products or the
// bytes, bound the launch (tools/int8_gemm_probe.py --parts).  SMALL_K (K <= 256, so |acc| <= 128 * 128 * 256 = 2^22): the
// accumulator becomes a float as (acc + 1.5 * 2^23 read as a float) -
// 1.5 * 2^23, exact in that range, on the full-rate pipes.  One clamp
// (column_pair's folded bounds); an int8 byte is the low byte of
// t + 1.5 * 2^23, t = y * out_scale (rint, round half to even; |t| <=
// 127 + an ulp by the bounds), two bytes packed by one byte permute.
//
// PRE false: every column's pre is 1 (x_scale 1: column_pair keeps w_scale
// in last), and the multiply by it, exact, is left out.
//
// PACKED: the rows are ``pitch`` = N * sizeof(OutT) bytes apart, so that a
// column at or past ``lim`` = N would land on the next row: its pair goes
// to a scratch slot past the 64 rows instead (a select, not a branch,
// which would break the unrolled loop's schedule; an instantiation of its
// own, since the select also costs the stores their constant offsets).
template <typename OutT, int BN, bool SMALL_K, bool PACKED = false,
          bool PRE = true>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2],
                                           uint32_t par, uint32_t os,
                                           int pitch, float out_scale,
                                           int lim = BN) {
  constexpr float kMagic = 12582912.0f;
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
        const float v = __fmaf_rn(PRE ? __fmul_rn(f, q ? p0.y : p0.x) : f,
                                  q ? p0.w : p0.z, q ? p1.y : p1.x);
        y[q] = fminf(fmaxf(v, q ? p1.w : p1.z), q ? p2.y : p2.x);
      }
      uint32_t a = os + (warp * 16 + gid + 8 * h) * pitch +
                   c * static_cast<int>(sizeof(OutT));
      if constexpr (PACKED) a = c < lim ? a : os + 64 * pitch;
      if constexpr (std::is_same<OutT, int8_t>::value) {
        const uint32_t b0 = __float_as_uint(
            __fadd_rn(__fmul_rn(y[0], out_scale), kMagic));
        const uint32_t b1 = __float_as_uint(
            __fadd_rn(__fmul_rn(y[1], out_scale), kMagic));
        sts16(a, __byte_perm(b0, b1, 0x0040));
      } else if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(y[0], y[1]);
        sts32(a, *reinterpret_cast<const uint32_t*>(&b));
      } else {
        sts64(a, y[0], y[1]);
      }
    }
  }
}

// The bytes of row r of a staged ragged tile (``row``: its first byte in
// shared memory, K bytes, at any alignment) for K step k0, into the
// BK-byte-swizzled A stage ``as``: each 16-byte piece from five aligned
// 32-bit loads and four funnel shifts, the bytes past K zeroed, a row
// past M (``live`` false) all zeros.
__device__ __forceinline__ uint32_t low_bytes(int n) {  // the low n of 4
  return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}
template <int BK>
__device__ __forceinline__ void relay_row(uint32_t row, bool live, int k0,
                                          int K, uint32_t as, int r) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    const int kk = k0 + 16 * j;
    const int nv = min(max(K - kk, 0), 16);  // the same for every row
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (live && nv > 0) {
      const uint32_t p = row + kk;
      const uint32_t wa = p & ~3u;
      const uint32_t sh = (p & 3u) * 8;
      const uint32_t w0 = lds32(wa), w1 = lds32(wa + 4), w2 = lds32(wa + 8),
                     w3 = lds32(wa + 12), w4 = lds32(wa + 16);
      v.x = __funnelshift_r(w0, w1, sh) & low_bytes(nv);
      v.y = __funnelshift_r(w1, w2, sh) & low_bytes(nv - 4);
      v.z = __funnelshift_r(w2, w3, sh) & low_bytes(nv - 8);
      v.w = __funnelshift_r(w3, w4, sh) & low_bytes(nv - 12);
    }
    sts128u(as + swizzle<BK>(r * BK + 16 * j), v);
  }
}

// Word i of a 16-byte piece.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The first nb bytes of a 16-byte output piece to dst, in the widest
// stores dst's alignment allows (a row pitch of N = 116 int8 outputs is
// 4-byte aligned, 58 2-byte aligned): one 16-byte store where it can.
__device__ __forceinline__ void store_piece(uint8_t* dst, const uint4& v,
                                            int nb) {
  const unsigned al = static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst));
  if (nb == 16 && (al & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  if (nb == 16 && (al & 7) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(v.x, v.y);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(v.z, v.w);
    return;
  }
  int b = 0;
  if ((al & 3) == 0) {
    for (; b + 4 <= nb; b += 4)
      *reinterpret_cast<uint32_t*>(dst + b) = word_of(v, b >> 2);
  } else if ((al & 1) == 0) {
    for (; b + 2 <= nb; b += 2)
      *reinterpret_cast<uint16_t*>(dst + b) =
          static_cast<uint16_t>(word_of(v, b >> 2) >> (8 * (b & 3)));
  }
  for (; b < nb; ++b)
    dst[b] = static_cast<uint8_t>(word_of(v, b >> 2) >> (8 * (b & 3)));
}

// Unit u of a launch whose K splits (SPLIT) into ``split`` slices of
// ``per`` steps: column tile u % n_tiles, slice (u / n_tiles) % split, row
// tile u / (n_tiles * split), and the slice's steps [ks0, ks1); without
// SPLIT, tile u and all k_steps.
struct Unit {
  int mt, nt, ks0, ks1;
};
template <bool SPLIT>
__device__ __forceinline__ Unit unit_of(int u, int n_tiles, int split,
                                        int per, int k_steps) {
  Unit w;
  const int q = u / n_tiles;
  w.nt = u - q * n_tiles;
  w.mt = q;
  w.ks0 = 0;
  w.ks1 = k_steps;
  if constexpr (SPLIT) {
    w.mt = q / split;
    w.ks0 = (q - w.mt * split) * per;
    w.ks1 = min(k_steps, w.ks0 + per);
  }
  return w;
}

// RAGGED: variant "wgmma_ragged".  A matrix's A then comes through the
// staging ring (sst buffers), a conv's in 8-byte pieces; otherwise
// ("wgmma") a matrix's by TMA, a conv's in 16-byte pieces.
//
// A build with FCNN_WG_PROBE_NO_MMA, FCNN_WG_PROBE_NO_STAGE or
// FCNN_WG_PROBE_NO_STORE defined (tools/int8_gemm_probe.py --parts,
// timing only: its results are wrong) skips the wgmma, the epilogue's
// arithmetic into the staged tile (stage_tile), or the tile's stores.
//
// SPLIT (split > 1; "wgmma" alone, BK = 128, not with a resident panel; an
// instantiation of its own, so that the split's code leaves the common
// one's epilogue, which bounds the small-K launches, as it was): a unit of
// work is one tile and one slice of its K steps (unit_of), as in
// w8gemm_kernel.  Slice sk runs steps [sk * per, min((sk + 1) * per,
// k_steps)) and writes its int32 sums to ws[sk] (M x N) from the
// registers; splitk_reduce_kernel<int> adds the slices (exact) and applies
// the epilogue.
template <class A, int BN, int BK, bool RAGGED, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgemm_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, A a, int N,
             int stages, int bres, int sst, int split, int per,
             int* __restrict__ ws, Epilogue e) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  constexpr bool STAGED = RAGGED && !CONV;  // A through the staging ring
  constexpr int A_BYTES = WG_BM * BK;
  constexpr int B_BYTES = BN * BK;
  // Registers per thread after the split, within the 384 * 168 of the
  // launch: a TMA producer needs few; the conv's gathering producer and
  // the staged matrix's re-laying one more, as many as the consumers'
  // accumulators leave (128 of them at BN = 256).
  constexpr bool BUSY = CONV || STAGED;
  constexpr int P_REGS = !BUSY ? 40 : BN == 256 ? 56 : 96;
  constexpr int C_REGS = !BUSY ? 232 : BN == 256 ? 224 : 200;
  static_assert(128 * P_REGS + 256 * C_REGS <= WG_THREADS * 168, "registers");
  const int K = a.K;
  const int k_steps = (K + BK - 1) / BK;
  // bres: the block's whole weight panel (k_steps B tiles) stays resident
  // behind the ring, loaded once; the ring then carries A alone.
  const int STAGE = A_BYTES + (bres ? 0 : B_BYTES);
  const int SB = STAGED ? ragged_stage_bytes(K) : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bpanel = ring + stages * STAGE;
  uint8_t* stg = bpanel + (bres ? k_steps * B_BYTES : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + (STAGED ? sst * SB : 0));
  uint64_t* empty = full + stages;
  uint64_t* bready = empty + stages;
  uint64_t* sfull = bready + 2;  // a staging buffer's bulk copy has landed
  uint8_t* pars = reinterpret_cast<uint8_t*>(sfull + (STAGED ? 2 * sst : 0));
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
  const int units = SPLIT ? tiles * split : tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the producer's 128 threads (their cp.async, or their re-laid
      // rows) and thread 0's weight tile; or the TMA of both
      mbar_init(&full[s], BUSY ? 129 : 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(bready, 1);
    if constexpr (STAGED)
      for (int i = 0; i < sst; ++i) mbar_init(&sfull[2 * i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (SPLIT) allow_dependents();

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
      // Thread t fills PW-byte piece t % CPR of rows t / CPR + p * RPP:
      // neighbouring threads read neighbouring bytes of one pixel's taps.
      // A piece never straddles two taps (PW divides C).
      constexpr int PW = RAGGED ? 8 : 16;
      constexpr int CPR = BK / PW;
      constexpr int RPP = 128 / CPR;
      const int chunk = t % CPR;
      const int r0 = t / CPR;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<SPLIT>(u, n_tiles, split, per, k_steps);
        const int mt = w.mt, nt = w.nt, ks0 = w.ks0, ks1 = w.ks1;
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
        int k = ks0 * BK + chunk * PW, c = k, kh = 0, kw = 0;
        while (c >= a.C) {
          c -= a.C;
          if (++kw == a.KW) { kw = 0; ++kh; }
        }
        for (int ks = ks0; ks < ks1; ++ks) {
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
          const int dh = kh * a.d, dw = kw * a.d;
          const long long tap =
              (static_cast<long long>(dh) * a.W + dw) * a.C + c;
#pragma unroll
          for (int p = 0; p < WG_BM / RPP; ++p) {
            const int r = p * RPP + r0;
            const RowInfo ri = rows[r];
            const bool ok =
                k < K &&
                static_cast<unsigned>(ri.ih + dh) < static_cast<unsigned>(a.H) &&
                static_cast<unsigned>(ri.iw + dw) < static_cast<unsigned>(a.W);
            uint8_t* dst = As + swizzle<BK>(r * BK + chunk * PW);
            const char* src = ok ? a.x + ri.base + tap : a.x;
            if constexpr (PW == 16)
              cp_async16(dst, src, ok);
            else
              cp_async8(dst, src, ok);
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
    } else if constexpr (STAGED) {
      // Local tile j (tile blockIdx.x + j * gridDim.x) is staged in buffer
      // j % sst as its run of rows * K bytes, byte i at offset (start %
      // 16) + i: the bulk copy brings the run's 16-byte-aligned middle,
      // the 128 threads copy the bytes before and after it.  Tiles go in
      // sst - 1 ahead of the one being re-laid.
      const uintptr_t xa = reinterpret_cast<uintptr_t>(a.x);
      const int my_tiles =
          tiles > static_cast<int>(blockIdx.x)
              ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
              : 0;
      auto tile_of = [&](int j) { return blockIdx.x + j * gridDim.x; };
      auto issue = [&](int j) {
        const long long m0 = static_cast<long long>(tile_of(j) / n_tiles) *
                             WG_BM;
        const long long rows = min(static_cast<long long>(WG_BM), M - m0);
        const uintptr_t s0 = xa + m0 * K;
        const uintptr_t e0 = s0 + rows * K;
        const uintptr_t a0 = (s0 + 15) & ~uintptr_t(15);
        const uintptr_t b0 = e0 & ~uintptr_t(15);
        uint8_t* run = stg + (j % sst) * SB + (s0 & 15);
        uint64_t* bar = &sfull[2 * (j % sst)];
        const int head = a0 < b0 ? static_cast<int>(a0 - s0)
                                 : static_cast<int>(e0 - s0);
        for (int i = t; i < head; i += 128)
          run[i] = static_cast<uint8_t>(a.x[m0 * K + i]);
        if (a0 < b0) {
          const int tail = static_cast<int>(e0 - b0);
          for (int i = t; i < tail; i += 128)
            run[b0 - s0 + i] = *reinterpret_cast<const uint8_t*>(b0 + i);
          if (t == 0) {
            mbar_expect_tx(bar, static_cast<uint32_t>(b0 - a0));
            bulk_load(run + (a0 - s0), reinterpret_cast<const void*>(a0),
                      static_cast<uint32_t>(b0 - a0), bar);
          }
        } else if (t == 0) {
          mbar_arrive(bar);
        }
      };
      for (int j = 0; j < min(sst - 1, my_tiles); ++j) issue(j);
      for (int j = 0; j < my_tiles; ++j) {
        // tile j - 1 is re-laid (its buffer is free), and the head and
        // tail bytes of tile j, copied when it was issued, are written
        named_sync(3, 128);
        if (j + sst - 1 < my_tiles) issue(j + sst - 1);
        const int tile = tile_of(j);
        const int mt = tile / n_tiles;
        const int nt = tile - mt * n_tiles;
        const long long m0 = static_cast<long long>(mt) * WG_BM;
        const uint32_t row = smem_u32(stg + (j % sst) * SB +
                                      ((xa + m0 * K) & 15) + t * K);
        const bool live = m0 + t < M;
        mbar_wait(&sfull[2 * (j % sst)], (j / sst) & 1);
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
          relay_row<BK>(row, live, ks * BK, K, smem_u32(As), t);
          // the re-laid row to the async proxy (wgmma reads it there)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&full[s]);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      }
    } else if (t == 0) {
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<SPLIT>(u, n_tiles, split, per, k_steps);
        const int mt = w.mt, nt = w.nt;
        for (int ks = w.ks0; ks < w.ks1; ++ks) {
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
  const bool out16 = reinterpret_cast<uintptr_t>(e.out) % 16 == 0;
  const bool vec_out = (static_cast<long long>(N) * osize) % 16 == 0 && out16;
  const bool small_k = K <= 256;
  // A tile that spans every column (one column tile) of an even N whose
  // rows are not whole 16-byte pieces (ShuffleNet's N = 58, 116; K <= 256,
  // int8 or bf16 out) is staged packed, its rows N * osize bytes apart: a
  // consumer's 64 rows are then one run of the output, 16-byte aligned at
  // both ends but the last tile's, and leave as 16-byte pieces.  (An even
  // N keeps each column pair's store aligned in shared memory.)
  const bool packed = !vec_out && out16 && n_tiles == 1 && (N & 1) == 0 &&
                      small_k && e.out_type != DT_F32;
  int s = 0;
  uint32_t ph = 0;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  if constexpr (!SPLIT)
    for (int i = t; i < BN / 2; i += 128)
      column_pair(e, (blockIdx.x % n_tiles) * BN + 2 * i, N, par + i * 48);
  if (bres) mbar_wait(bready, 0);

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of<SPLIT>(u, n_tiles, split, per, k_steps);
    const int mt = w.mt, nt = w.nt, ks0 = w.ks0, ks1 = w.ks1;
    const long long m0 = static_cast<long long>(mt) * WG_BM + cw * 64;
    const int n0 = nt * BN;
    int prev = 0;
    fence_regs(acc);
    for (int ks = ks0; ks < ks1; ++ks) {
      mbar_wait(&full[s], ph);
      if constexpr (BUSY)  // the producer wrote A through the generic proxy
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
#ifndef FCNN_WG_PROBE_NO_MMA
        wgmma_s8<BN>(acc, da + 2 * j, db + 2 * j,
                     (ks > ks0 || j > 0) ? 1 : 0);
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

    if constexpr (SPLIT) {  // this slice's int32 sums, from the registers
      int* dst = ws + static_cast<long long>(ks0 / per) * M * N;
      const int warp = t >> 5;
      const int gid = (t & 31) >> 2;
      const int tig = t & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + j * 8 + tig * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + warp * 16 + gid + 8 * h;
          if (m >= M || c >= N) continue;
          int* p = dst + m * N + c;
          const int v0 = acc[j * 4 + 2 * h];
          const int v1 = acc[j * 4 + 2 * h + 1];
          if (c + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            p[0] = v0;
            if (c + 1 < N) p[1] = v1;
          }
        }
      }
      continue;
    }

    // epilogue: column constants in, the tile staged, 16-byte pieces out
    named_sync(1 + cw, 128);  // the last tile's pieces have left os
#ifndef FCNN_WG_PROBE_NO_STAGE
    const float osc = e.out_scale;
    if (packed) {
      if (e.out_type == DT_I8)
        stage_tile<int8_t, BN, true, true>(acc, par, os, N, osc, N);
      else
        stage_tile<__nv_bfloat16, BN, true, true>(acc, par, os, 2 * N, osc,
                                                  N);
    } else if (e.out_type == DT_I8) {
      if (small_k)
        stage_tile<int8_t, BN, true>(acc, par, os, pitch, osc);
      else
        stage_tile<int8_t, BN, false>(acc, par, os, pitch, osc);
    } else if (e.out_type == DT_BF16) {
      if (small_k)
        stage_tile<__nv_bfloat16, BN, true>(acc, par, os, pitch, osc);
      else
        stage_tile<__nv_bfloat16, BN, false>(acc, par, os, pitch, osc);
    } else {
      stage_tile<float, BN, false>(acc, par, os, pitch, osc);
    }
#endif
    named_sync(1 + cw, 128);
    if (packed) {  // this consumer's rows, one run of the output
      const long long rows = max(0ll, min(64ll, M - m0));
      const int bytes = static_cast<int>(rows) * N * osize;
      uint8_t* dst = static_cast<uint8_t*>(e.out) + m0 * N * osize;
      int i = t * 16;
#ifndef FCNN_WG_PROBE_NO_STORE
      for (; i + 16 <= bytes; i += 128 * 16)
        *reinterpret_cast<uint4*>(dst + i) = lds128u(os + i);
      if (i < bytes) store_piece(dst + i, lds128u(os + i), bytes - i);
#endif
      continue;
    }
    const int per = 16 / osize;  // elements per piece
    const int ppr = BN / per;    // pieces per row
    for (int idx = t; idx < 64 * ppr; idx += 128) {
      const int r = idx / ppr;
      const int pc = idx - r * ppr;
      const long long m = m0 + r;
      const int c0 = n0 + pc * per;
#ifdef FCNN_WG_PROBE_NO_STORE
      continue;
#endif
      if (m >= M || c0 >= N) continue;
      const uint4 v = lds128u(os + r * pitch + pc * 16);
      uint8_t* dst = static_cast<uint8_t*>(e.out) +
                     (m * N + c0) * static_cast<long long>(osize);
      if (vec_out && c0 + per <= N)
        *reinterpret_cast<uint4*>(dst) = v;
      else  // the row's ragged end, or a row not 16-byte aligned
        store_piece(dst, v, min(per, N - c0) * osize);
    }
  }
}

// ---------------------------------------------------------------------
// Variant "wgmma_halo": a grouped 3x3 int8 conv's super-groups with each
// tile's input halo staged once (see the note at the top).
// ---------------------------------------------------------------------

// A super-group's width: its column tile's output channels and the input
// channels they read (HALO_S in kernels/matmul.py).
constexpr int HALO_S = 32;

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A halo tile: ti images (ti > 1 only where the th x tw rectangle is the
// whole output map: as many as 128 rows hold), th x tw output pixels each.
__host__ __device__ constexpr int halo_images(int th, int tw, int OH,
                                              int OW) {
  return th == OH && tw == OW && 2 * th * tw <= WG_BM ? WG_BM / (th * tw)
                                                      : 1;
}

// Column tiles whose channels one halo holds: four (rows of 128 bytes) at
// stride 1 with an int8 output where they divide the launch's n_tiles, else
// one (rows of 32 bytes).  TMA brings a box one row (pixel) at a time:
// 128-byte rows move four times the bytes of 32-byte rows in the same
// time.  (A stride-2 halo of 128-byte rows leaves room for small tiles
// only, and a wider output for few stages.)
__host__ __device__ constexpr int halo_group(int n_tiles, int stride,
                                             int osize) {
  return stride == 1 && osize == 1 && n_tiles % 4 == 0 ? 4 : 1;
}

// Dynamic shared memory of hgemm_kernel<G> (halo_smem in kernels/matmul.py
// computes the same): 1024 bytes of alignment slack; the ring of halos
// (halo_bytes each, in 1024-byte steps); the resident weight panel (g
// column tiles' 3 tiles of 32 x 128 bytes); two barriers and a tile origin
// per stage, the panel's barrier; the tile's row -> pixel table; each of
// the four consumer warpgroups' column constants (g * 32 columns) and
// staged 64-row output tile (g * 32 columns).
__host__ __device__ constexpr int hgemm_smem(int g, int stages,
                                             int halo_bytes, int osize) {
  return 1024 + stages * ((halo_bytes + 1023) / 1024 * 1024) +
         g * ((9 * HALO_S / 32 + 3) / 4) * HALO_S * 128 + 32 * stages + 16 +
         4 * WG_BM + 4 * (24 * g * HALO_S + 64 * (g * HALO_S * osize + 16));
}

// hgemm_kernel<G>: the super-group conv (3x3, any square stride; column
// tile nt's 32 outputs read input channels nt*32 .. +31) on a persistent
// grid whose units are (tile, group of G column tiles, halo_group), the
// group u % (n_tiles / G) as wgemm_kernel takes its column tile, so a block
// keeps its column tiles and their weight panel: the compact weight's rows
// of each, all K = 9*32 bytes, as 128-byte-swizzled 32 x 128 tiles (TMA,
// once per block).  A tile is ti x th x tw output pixels (at most 128
// rows); its input halo, the ti x ((th-1)*sh+3) x ((tw-1)*sw+3) pixels'
// G * 32 channels from the group's first on, comes by one 4-D TMA box
// (zero-filled outside the image: the padding), rows of G * 32 bytes
// (swizzled at 128 bytes, so that ldmatrix's eight rows hit eight bank
// groups), into a ring of halos kept full by one producer thread, which
// also leaves each tile's origin (image, row, column) beside its halo.  A
// pair of consumer warpgroups computes a tile, 64 rows each; the two pairs
// take the block's tiles in turn (pair p the ring's stages p, p + 2, ...),
// so that one pair's epilogue runs under the other's products: a tile's
// work is too short for one pair's warps to hide its latencies.  K slice j
// (32 bytes: tap j) of a warpgroup's rows is ldmatrix.x4 at each row's
// window (lane l: row l % 16 of its warp's 16, 16-byte half l / 16), so the
// nine shifted windows come from the one halo; all nine slices' A
// fragments are loaded before the wgmmas (wgmma_s8_rs, B the panel's
// slice).  The group's column tiles alternate between two accumulators,
// each one's products running under the epilogue of the one before (G is
// a template constant: a branch around a wgmma makes ptxas serialize them
// all).  The epilogue is wgemm_kernel's arithmetic (stage_tile; without
// the unit pre-scale at x_scale 1), the G column tiles staged side by
// side, and the tile leaves as 16-byte row pieces, each row to its pixel
// by a table made once (no division per tile; rows past the map or the
// batch are not stored).
template <int G>
__global__ void __launch_bounds__(WG_THREADS + 256, 1)
hgemm_kernel(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_b, ConvA a, int N,
             int stages, int th, int tw, Epilogue e) {
  constexpr int BN = HALO_S;
  constexpr int S = HALO_S;
  constexpr int NC = 4;                      // consumer warpgroups
  constexpr int NP = NC / 2;                 // pairs
  constexpr int NSL = 9 * S / 32;            // K slices of 32 bytes: taps
  constexpr int K_TILES = (NSL + 3) / 4;     // panel tiles of 128 bytes
  constexpr int B_TILE = BN * 128;
  constexpr int RB = G * S;                  // a halo row's bytes
  constexpr uint32_t smask = RB == 128 ? 7u : 0u;
  const int n_tiles = N / BN;
  const int n_groups = n_tiles / G;
  const int ti = halo_images(th, tw, a.OH, a.OW);
  const int hh = (th - 1) * a.sh + 3;
  const int hw = (tw - 1) * a.sw + 3;
  const int halo_bytes = ti * hh * hw * RB;
  const int HB = (halo_bytes + 1023) / 1024 * 1024;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bpanel = ring + stages * HB;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(bpanel + G * K_TILES * B_TILE);
  uint64_t* empty = full + stages;
  uint64_t* bready = empty + stages;
  int4* origin = reinterpret_cast<int4*>(bready + 2);
  int* rowpix = reinterpret_cast<int*>(origin + stages);
  uint8_t* pars = reinterpret_cast<uint8_t*>(rowpix + WG_BM);
  const int osize = out_size(e.out_type);
  const int pitch = G * BN * osize + 16;
  uint8_t* outs = pars + NC * 24 * G * BN;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int images = a.M / (a.OH * a.OW);
  const int ty_n = (a.OH + th - 1) / th;
  const int tx_n = (a.OW + tw - 1) / tw;
  const int per_group = ty_n * tx_n;
  const int units = (images + ti - 1) / ti * per_group * n_groups;
  const int rows = ti * th * tw;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(bready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < WG_BM) {  // row R of a tile: image i, pixel (y, x); -1 past it
    const int i = tid / (th * tw);
    const int p = tid - i * th * tw;
    rowpix[tid] = tid < rows ? (i << 16) | ((p / tw) << 8) | (p % tw) : -1;
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread's TMA ------------------------
    if (t == 0) {
      prefetch_map(&map_x);
      mbar_expect_tx(bready, G * K_TILES * B_TILE);
      for (int g = 0; g < G; ++g)
        for (int kt = 0; kt < K_TILES; ++kt)
          tma_load_2d(bpanel + (g * K_TILES + kt) * B_TILE, &map_b, kt * 128,
                      ((blockIdx.x % n_groups) * G + g) * BN, bready);
      int s = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int rect = u / n_groups;
        const int grp = u - rect * n_groups;
        const int ig = rect / per_group;
        const int rr = rect - ig * per_group;
        const int ty = rr / tx_n;
        const int tx = rr - ty * tx_n;
        mbar_wait(&empty[s], ph ^ 1);
        origin[s] = make_int4(ig * ti, ty * th, tx * tw, 0);
        mbar_expect_tx(&full[s], halo_bytes);
        tma_load_4d(ring + s * HB, &map_x, grp * RB, tx * tw * a.sw - a.pw,
                    ty * th * a.sh - a.ph, ig * ti, &full[s]);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---------------- consumers: pair pr, rows hf*64 .. +63 of its tiles ---
  const int cw = wg - 1;
  const int pr = cw >> 1;
  const int hf = cw & 1;
  const int nt0 = (blockIdx.x % n_groups) * G;  // the group's first tile
  const uint32_t par = smem_u32(pars + cw * 24 * G * BN);
  const uint32_t os = smem_u32(outs + cw * 64 * pitch);
  const bool out16 = reinterpret_cast<uintptr_t>(e.out) % 16 == 0;
  const bool vec_out = (static_cast<long long>(N) * osize) % 16 == 0 && out16;
  for (int i = t; i < G * BN / 2; i += 128)
    column_pair(e, nt0 * BN + 2 * i, N, par + i * 48);
  // this lane's A row and its window's K slices, as unswizzled byte
  // offsets into a halo, column tile 0 of the group (a row past the tile
  // reads the tile's last row: not stored)
  const int lane = t & 31;
  const int ar = min(hf * 64 + (t >> 5) * 16 + (lane & 15), rows - 1);
  const int ap = rowpix[ar];
  const int p0 = (((ap >> 16) * hh + ((ap >> 8) & 255) * a.sh) * hw +
                  (ap & 255) * a.sw);
  // (its slice j, tap j: a tap row (hw * RB bytes) or a pixel (RB)
  // further, column tile g's channels g * S on)
  const uint32_t a0 = static_cast<uint32_t>(p0 * RB + (lane >> 4) * 16);
  const uint32_t hwrb = static_cast<uint32_t>(hw * RB);
  // the staged tile: the group's G column tiles side by side, 16-byte
  // pieces of rows of G * BN outputs
  const int per = 16 / osize;               // elements per piece
  const int lg = 31 - __clz(G * BN / per);  // log2 of the pieces per row
  int acc0[BN / 2], acc1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0;
  // column tile g of the halo at hb: its A fragments and its products into
  // acc, left in flight
  auto issue = [&](int (&acc)[BN / 2], uint32_t hb, int g) {
    uint32_t af[NSL][4];
#pragma unroll
    for (int j = 0; j < NSL; ++j) {
      const uint32_t o = a0 + (j / 3) * hwrb + (j % 3) * RB + g * S;
      ldmatrix4(af[j], hb + (o ^ (((o >> 7) & smask) << 4)));
    }
    wgmma_fence();
#ifndef FCNN_WG_PROBE_NO_MMA
    const uint8_t* bg = bpanel + g * K_TILES * B_TILE;
#pragma unroll
    for (int j = 0; j < NSL; ++j)
      wgmma_s8_rs<BN>(acc, af[j],
                      wg_desc<128>(bg + (j / 4) * B_TILE) + 2 * (j % 4),
                      j > 0 ? 1 : 0);
#endif
    wgmma_commit();
  };
  // column tile g's sums in acc through the epilogue into its columns of
  // the staged tile
  // (a warp whose 16 rows all lie past the tile has nothing to stage)
  const bool live = hf * 64 + (t >> 5) * 16 < rows;
  auto stage = [&](const int (&acc)[BN / 2], int g) {
#ifndef FCNN_WG_PROBE_NO_STAGE
    if (!live) return;
    const uint32_t pg = par + g * 24 * BN;
    const uint32_t og = os + g * BN * osize;
    const float osc = e.out_scale;
    if (e.out_type == DT_I8) {  // (the engine's grouped convs: x_scale 1)
      if (e.x_scale == 1.0f)
        stage_tile<int8_t, BN, false, false, false>(acc, pg, og, pitch,
                                                    osc);
      else
        stage_tile<int8_t, BN, false>(acc, pg, og, pitch, osc);
    } else if (e.out_type == DT_BF16) {
      stage_tile<__nv_bfloat16, BN, false>(acc, pg, og, pitch, osc);
    } else {
      stage_tile<float, BN, false>(acc, pg, og, pitch, osc);
    }
#endif
  };
  mbar_wait(bready, 0);
  // the pair's tiles: local tiles pr, pr + NP, ... in stages pr, pr + NP,
  // ... of the ring (stages is a multiple of NP)
  int s = pr;
  uint32_t ph = 0;
  auto release = [&]() {  // every column tile's A is read: free the halo
    mbar_arrive(&empty[s]);
    s += NP;
    if (s >= stages) { s -= stages; ph ^= 1; }
  };
  for (int u = blockIdx.x + pr * gridDim.x; u < units;
       u += NP * gridDim.x) {
    mbar_wait(&full[s], ph);
    const int4 org = origin[s];
    const uint32_t hb = smem_u32(ring + s * HB);
    fence_regs(acc0);
    issue(acc0, hb, 0);
    named_sync(1 + cw, 128);  // the last tile's pieces have left os
    // column tile g in acc0, g + 1 in acc1: each one's products run under
    // the epilogue of the one before (G a constant, the loop unrolled: a
    // branch around a wgmma makes ptxas serialize them all)
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      wgmma_wait<0>();
      fence_regs(acc0);
      if (g + 1 < G) {
        fence_regs(acc1);
        issue(acc1, hb, g + 1);
      } else {
        release();
      }
      stage(acc0, g);
      if (g + 1 < G) {
        wgmma_wait<0>();
        fence_regs(acc1);
        if (g + 2 < G) {
          fence_regs(acc0);
          issue(acc0, hb, g + 2);
        } else {
          release();
        }
        stage(acc1, g + 1);
      }
    }
    named_sync(1 + cw, 128);
#ifdef FCNN_WG_PROBE_NO_STORE
    continue;
#endif
    for (int idx = t; idx < (64 << lg); idx += 128) {
      const int r = idx >> lg;
      const int pc = idx & ((1 << lg) - 1);
      const int rp = rowpix[hf * 64 + r];
      const int img = org.x + (rp >> 16);
      const int oy = org.y + ((rp >> 8) & 255);
      const int ox = org.z + (rp & 255);
      if (rp < 0 || img >= images || oy >= a.OH || ox >= a.OW) continue;
      const long long m =
          (static_cast<long long>(img) * a.OH + oy) * a.OW + ox;
      const uint4 v = lds128u(os + r * pitch + pc * 16);
      uint8_t* dst = static_cast<uint8_t*>(e.out) +
                     (m * N + nt0 * BN + pc * per) *
                         static_cast<long long>(osize);
      if (vec_out)
        *reinterpret_cast<uint4*>(dst) = v;
      else
        store_piece(dst, v, 16);
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

// The same for w8gemm_kernel<MatrixA, BN, true> ("wgmma_bf16"; bf16_smem
// in kernels/matmul.py): a stage holds the A tile and the bf16 weight
// tile, both brought by TMA (no staging slot).
__host__ __device__ constexpr int bf16gemm_smem(int bn, int stages) {
  return 1024 + stages * (W8_A_BYTES + bn * 128 + 16) + 2 * 24 * bn;
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
// constants, as column_pair makes them, one clamp); tile row r goes to
// output row row_of(r), none where that is negative.
template <typename OutT, int BN, class RowOf>
__device__ __forceinline__ void store_direct(const float (&acc)[BN / 2],
                                             uint32_t par, RowOf row_of,
                                             int n0, int N, float out_scale,
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
//
// W16 (variant "wgmma_bf16", a bf16 x bf16 matrix): the weight is bf16 and
// comes by TMA (map_b, a BN x 64 box, 128-byte swizzled) into the stage's
// bf16 tile beside A; no staging slot, no conversion, and the producer's
// thread 0 alone issues both loads.
template <class A, int BN, bool W16>
__global__ void __launch_bounds__(WG_THREADS, 1)
w8gemm_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, A a,
              const int8_t* __restrict__ w, int ldw, int N, int stages,
              int split, int per, int th, int tw, float* __restrict__ ws,
              Epilogue e) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  static_assert(!(W16 && CONV), "a bf16 x bf16 launch is a matrix");
  constexpr int BB = BN * 128;          // the bf16 weight tile
  constexpr int BI = W16 ? 0 : BN * 64;  // its int8 staging slot
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
      // the producer's 128 cp.async arrivals, and the A tile's TMA (W16:
      // the TMA of both tiles alone)
      mbar_init(&full[s], W16 ? 1 : CONV && !tma_conv ? 128 : 129);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  allow_dependents();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(P_REGS)
                 : "memory");
    int s = 0;
    uint32_t ph = 0;
    if constexpr (W16) {
      if (t == 0) {
        prefetch_map(&map_a);
        prefetch_map(&map_b);
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const Unit w = unit_of<true>(u, n_tiles, split, per, k_steps);
          for (int ks = w.ks0; ks < w.ks1; ++ks) {
            mbar_wait(&empty[s], ph ^ 1);
            uint8_t* As = ring + s * STAGE;
            mbar_expect_tx(&full[s], STAGE);
            tma_load_2d(As, &map_a, ks * W8_BK, w.mt * WG_BM, &full[s]);
            tma_load_2d(As + W8_A_BYTES, &map_b, ks * W8_BK, w.nt * BN,
                        &full[s]);
            if (++s == stages) { s = 0; ph ^= 1; }
          }
        }
      }
      return;
    }
    // 16-byte weight pieces, else 8 (the plan takes K a multiple of 8)
    const bool b16 = K % 16 == 0 && ldw % 16 == 0;
    // the int8 weight rows (ldw bytes apart) of column tile nt at step ks
    // into the staging slot: row r at r * 64, zeros past N and K
    auto load_b = [&](uint8_t* bi, int nt, int ks) {
      const int kb = ks * W8_BK;
      if (b16) {
#pragma unroll
        for (int i = t; i < BN * 4; i += 128) {
          const int n = nt * BN + (i >> 2);
          const int k = kb + (i & 3) * 16;
          const bool ok = n < N && k < K;
          cp_async16(bi + i * 16,
                     ok ? w + static_cast<long long>(n) * ldw + k : w, ok);
        }
      } else {
#pragma unroll
        for (int i = t; i < BN * 8; i += 128) {
          const int n = nt * BN + (i >> 3);
          const int k = kb + (i & 7) * 8;
          const bool ok = n < N && k < K;
          cp_async8(bi + i * 8,
                    ok ? w + static_cast<long long>(n) * ldw + k : w, ok);
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
                          rt.ow0 - a.pw + kw * a.d, rt.oh0 - a.ph + kh * a.d,
                          rt.img, &full[s]);
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
          const int dh = kh * a.d, dw = kw * a.d;
          const long long tap =
              (static_cast<long long>(dh) * a.W + dw) * a.C + c;
#pragma unroll
          for (int p = 0; p < WG_BM / 16; ++p) {
            const int r = p * 16 + r0;
            const RowInfo ri = rows[r];
            const bool ok =
                k < K &&
                static_cast<unsigned>(ri.ih + dh) < static_cast<unsigned>(a.H) &&
                static_cast<unsigned>(ri.iw + dw) < static_cast<unsigned>(a.W);
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
  int s = 0;
  uint32_t ph = 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if (split == 1) {
    for (int i = t; i < BN / 2; i += 128)
      column_pair(e, (blockIdx.x % n_tiles) * BN + 2 * i, N, par + i * 48);
    named_sync(1 + cw, 128);  // the column constants are written
  }

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
      if constexpr (!W16) {
        // the staged int8 weight tile into the bf16 tile, 128-byte swizzled:
        // input piece i (16 weights of row i / 4) becomes the row's 16-byte
        // chunks 2 (i % 4) and 2 (i % 4) + 1, thread ct taking pieces ct +
        // 256 j, all its loads issued first; the last step's wgmma runs
        // meanwhile
        const uint32_t bb = smem_u32(As + W8_A_BYTES);
        const uint32_t bi = bb + BB;
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
      }
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
      store_direct<int8_t, BN>(acc, par, row_of, n0, N, osc, e.out);
    else if (e.out_type == DT_BF16)
      store_direct<__nv_bfloat16, BN>(acc, par, row_of, n0, N, osc, e.out);
    else
      store_direct<float, BN>(acc, par, row_of, n0, N, osc, e.out);
  }
}

// One slice's sums added to the running sum: f32 with one rounding, int32
// exactly; four columns at once as four such adds.
__device__ __forceinline__ float add_slice(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int add_slice(int a, int b) { return a + b; }
__device__ __forceinline__ float4 add_slice(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ int4 add_slice(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename T> struct Four;  // four T in one 16-byte load
template <> struct Four<float> { typedef float4 V; };
template <> struct Four<int> { typedef int4 V; };

// The split-K pass: out[m, n] = epilogue(ws[0][m][n] + ws[1][m][n] + ...),
// the slices added in index order (add_slice), four columns a thread where
// N is a multiple of 4 (16-byte loads), else two, then epilogue_store2 (the
// int32 sums converted to f32 as the single-pass kernel converts them).
// T = float ("wgmma_w8", "wgmma_bf16") or int ("wgmma");
// A, the main loop's operand (MatrixA or ConvA), only names the instance,
// so that a profile tells a conv's pass from a matrix's.  Launched as the
// main loop's dependent (launch_splitk_reduce): its blocks wait for the
// main loop's sums before they read them.
template <typename T, class A>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const T* __restrict__ ws, int split, int M, int N,
                     Epilogue e) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long mn = static_cast<long long>(M) * N;
  const long long step = gridDim.x * 256ll;
  if (N % 4 == 0) {
    typedef typename Four<T>::V V;
    const V* w4 = reinterpret_cast<const V*>(ws);
    const long long quads = mn / 4;
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < quads;
         i += step) {
      V v = w4[i];
#pragma unroll 4
      for (int sk = 1; sk < split; ++sk) v = add_slice(v, w4[sk * quads + i]);
      const long long m = 4 * i / N;
      const int c = static_cast<int>(4 * i - m * N);
      epilogue_store2(static_cast<float>(v.x), static_cast<float>(v.y), m, c,
                      N, e);
      epilogue_store2(static_cast<float>(v.z), static_cast<float>(v.w), m,
                      c + 2, N, e);
    }
    return;
  }
  const int half = (N + 1) / 2;
  const long long pairs = static_cast<long long>(M) * half;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < pairs; i += step) {
    const long long m = i / half;
    const int c = 2 * static_cast<int>(i - m * half);
    const long long idx = m * N + c;
    const bool two = c + 1 < N;
    T v0 = ws[idx];
    T v1 = two ? ws[idx + 1] : T(0);
    for (int sk = 1; sk < split; ++sk) {
      v0 = add_slice(v0, ws[sk * mn + idx]);
      if (two) v1 = add_slice(v1, ws[sk * mn + idx + 1]);
    }
    epilogue_store2(static_cast<float>(v0), static_cast<float>(v1), m, c, N,
                    e);
  }
}

// splitk_reduce_kernel over ``split`` (M, N) slices at ws, on stream s, as
// a programmatic dependent launch of the main loop just queued there.
template <typename T, class A>
inline int launch_splitk_reduce(const T* ws, int split, int M, int N,
                                const Epilogue& e, cudaStream_t s) {
  const long long items = N % 4 == 0 ? static_cast<long long>(M) * N / 4
                                     : static_cast<long long>(M) * ((N + 1) / 2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      items / 256 + 1 < 132 * 8 ? items / 256 + 1 : 132 * 8));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, splitk_reduce_kernel<T, A>, ws, split, M, N, e));
}

// ---------------------------------------------------------------------
// Variant "mma_sync": int8 x int8 -> int32 on mma.sync m16n8k32, for the
// shapes neither "wgmma" nor "wgmma_ragged" takes (C not a multiple of 8,
// a conv x not 8-byte aligned, a ragged matrix past K = 256): no zoo
// launch.  The first body of the port, kept as it was, and timed beside
// the ragged launches as the plan not taken.  Block tile 128 (M) x 64 (N), K step 64
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
igemm_kernel(A a, const int8_t* __restrict__ w, int ldw, int N,
             Epilogue e) {
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
          ? w[static_cast<long long>(n) * ldw + k] : static_cast<int8_t>(0);
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
fgemm_kernel(A a, const TW* __restrict__ w, int ldw, int N, Epilogue e) {
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
          ? to_f32(w[static_cast<long long>(n) * ldw + k]) : 0.0f;
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
// matrix at base, rows ``pitch`` elements apart (0: cols), box box_rows x
// box_cols elements (a box row of 128 bytes swizzled at 128, of 64 at 64),
// zero fill outside (the columns past cols too).  Encoded per launch: the
// caching allocator reuses addresses.
inline bool make_map(CUtensorMap* map, const void* base, long long rows,
                     int cols, int box_rows, int box_cols, int elem = 1,
                     long long pitch = 0) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch ? pitch : cols) *
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

// "wgmma" and "wgmma_ragged" (RAGGED): refuses (cudaErrorInvalidValue) a
// plan whose shared memory, stages, grid, staging ring or K slices differ
// from the kernel's own count, a split without a workspace ``ws`` (split x
// M x N int32), with a resident panel, on "wgmma_ragged" or at a 64-byte K
// step, a weight pitch ``ldw`` that TMA cannot stride, or an int8 output
// whose out_scale is not positive and finite (column_pair folds +-127 /
// out_scale into the clamp).
template <class A, int BN, int BK, bool RAGGED>
inline int launch_wgemm(const A& a, const int8_t* w, long long ldw, int N,
                        const GemmPlan& p, int* ws, const Epilogue& e,
                        cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  constexpr bool STAGED = RAGGED && !CONV;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma{}, mb{};
  if (!CONV && !STAGED && !make_map(&ma, a.x, a.M, a.K, WG_BM, BK)) return bad;
  if (ldw % 16 || !make_map(&mb, w, N, a.K, BN, BK, 1, ldw)) return bad;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_steps = (a.K + BK - 1) / BK;
  const int split = p.split;
  if (split < 1 || (split > 1 && (ws == nullptr || p.bres || RAGGED)))
    return bad;
  const int per = (k_steps + split - 1) / split;
  if ((split - 1) * per >= k_steps) return bad;  // an empty slice
  const int sb = STAGED ? ragged_stage_bytes(a.K) : 0;
  const int sst = STAGED ? p.sst : 0;
  const int smem = wgemm_smem(BN, BK, p.stages, k_steps, p.bres,
                              out_size(e.out_type), CONV, sb, sst);
  if (smem != p.smem || p.stages < 2 || p.grid < 1 || p.grid % n_tiles ||
      (STAGED ? p.sst < 2 || a.K > RAGGED_K_MAX : p.sst != 0))
    return bad;
  if (e.out_type == DT_I8 && !(e.out_scale > 0.0f && e.out_scale < INFINITY))
    return bad;
  auto kern = wgemm_kernel<A, BN, BK, RAGGED, false>;
  if constexpr (BK == 128 && !RAGGED) {
    if (split > 1) kern = wgemm_kernel<A, BN, BK, RAGGED, true>;
  } else {
    if (split > 1) return bad;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, WG_THREADS, smem, s>>>(ma, mb, a, N, p.stages, p.bres, sst,
                                        split, per, ws, e);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  return launch_splitk_reduce<int, A>(ws, split, a.M, N, e, s);
}

// The plan's tile (BN, BK) of "wgmma" or "wgmma_ragged".
template <class A, bool RAGGED>
inline int launch_wgemm_tile(const A& a, const int8_t* w, long long ldw,
                             int N, const GemmPlan& p, int* ws,
                             const Epilogue& e, cudaStream_t s) {
  switch (p.bn * 1000 + p.bk) {
    case 32064: return launch_wgemm<A, 32, 64, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 32128: return launch_wgemm<A, 32, 128, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 64064: return launch_wgemm<A, 64, 64, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 64128: return launch_wgemm<A, 64, 128, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 128064: return launch_wgemm<A, 128, 64, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 128128: return launch_wgemm<A, 128, 128, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 256064: return launch_wgemm<A, 256, 64, RAGGED>(a, w, ldw, N, p, ws, e, s);
    case 256128: return launch_wgemm<A, 256, 128, RAGGED>(a, w, ldw, N, p, ws, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// "wgmma_w8" and "wgmma_bf16" (W16): refuses (cudaErrorInvalidValue) a
// plan whose shared memory, grid or K slices differ from the kernel's own
// count, a split without a workspace ``ws`` (split x M x N f32) or on a
// conv, or a conv tile by TMA (th x tw) that the conv does not allow.
template <class A, int BN, bool W16>
inline int launch_w8gemm(const A& a, const void* w, int ldw, int N,
                         const GemmPlan& p, float* ws, const Epilogue& e,
                         cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma{}, mb{};
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
    // the bf16 weight's (N, K) rows, ldw elements apart, in BN x 64 boxes
    if (W16 && !make_map(&mb, w, N, a.K, BN, W8_BK, 2, ldw)) return bad;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const int k_steps = (a.K + W8_BK - 1) / W8_BK;
  const int split = p.split;
  if (split < 1 || (split > 1 && (CONV || ws == nullptr))) return bad;
  const int per = (k_steps + split - 1) / split;
  if ((split - 1) * per >= k_steps) return bad;  // an empty slice
  const int smem = W16 ? bf16gemm_smem(BN, p.stages)
                       : w8gemm_smem(BN, p.stages, CONV);
  if (smem != p.smem || p.bk != 2 * W8_BK || p.stages < 2 || p.grid < 1 ||
      p.grid % n_tiles)
    return bad;
  auto kern = w8gemm_kernel<A, BN, W16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, WG_THREADS, smem, s>>>(
      ma, mb, a, static_cast<const int8_t*>(w), ldw, N, p.stages, split, per,
      p.th, p.tw, ws, e);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  return launch_splitk_reduce<float, A>(ws, split, a.M, N, e, s);
}

// A TMA map over the int8 NHWC image x as (C, W, H, N), box (S channels,
// bw, bh, bn), rows of S bytes swizzled at S = 128 (none at 32), zero fill
// outside (the conv's padding, and the images past the batch).
inline bool make_map_halo(CUtensorMap* map, const void* base, int C, int W,
                          int H, int N, int S, int bw, int bh, int bn) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {dims[0], dims[0] * dims[1],
                                 dims[0] * dims[1] * dims[2]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S),
                             static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             S == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Variant "wgmma_halo", the super-group conv: x (N, H, W, C) int8, w the
// compact (Co, 9 * S) int8 weight (grouped_layout), its rows p.ldw bytes
// apart (0: 9 * S).  Refuses (cudaErrorInvalidValue) what is not a 3x3
// int8 conv at dilation 1 and a square stride with S = BN = 32 and Co = C,
// 16-byte aligned x and w, whose halo box fits TMA (each side at most
// 256); a plan whose tile (p.th x p.tw, at most 128 rows), stages (even),
// grid or shared memory differ from the kernel's own count; and an int8
// output whose out_scale is not positive and finite.
inline int launch_hgemm(const ConvA& a, int KH, int S, const void* w, int N,
                        int x_type, int w_type, const GemmPlan& p,
                        const Epilogue& e, cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 0 || N <= 0) return 0;
  const int ldw = p.ldw ? p.ldw : 9 * S;
  const int ti = halo_images(p.th, p.tw, a.OH, a.OW);
  const int hh = (p.th - 1) * a.sh + 3;
  const int hw = (p.tw - 1) * a.sw + 3;
  const int images = a.M / (a.OH * a.OW);
  if (p.variant != V_WGMMA_HALO || x_type != DT_I8 || w_type != DT_I8 ||
      S != HALO_S || p.bn != HALO_S || N != a.C || a.C % HALO_S ||
      KH != 3 || a.KW != 3 || a.d != 1 || a.sh != a.sw || ldw < 9 * S ||
      ldw % 16 || !aligned(a.x, 16) || !aligned(w, 16))
    return bad;
  const int g = halo_group(N / HALO_S, a.sh, out_size(e.out_type));
  if (p.th < 1 || p.tw < 1 || ti * p.th * p.tw > WG_BM || hh > 256 ||
      hw > 256 || p.stages < 2 || p.stages % 2 || p.grid < 1 ||
      p.grid % (N / HALO_S / g) || p.split != 1 || p.bk != 128 ||
      (e.out_type == DT_I8 && !(e.out_scale > 0.0f && e.out_scale < INFINITY)))
    return bad;
  const int smem = hgemm_smem(g, p.stages, ti * hh * hw * g * HALO_S,
                              out_size(e.out_type));
  if (smem != p.smem) return bad;
  CUtensorMap mx{}, mb{};
  if (!make_map_halo(&mx, a.x, a.C, a.W, a.H, images, g * HALO_S, hw, hh,
                     ti) ||
      !make_map(&mb, w, N, 9 * S, HALO_S, 128, 1, ldw))
    return bad;
  auto kern = hgemm_kernel<1>;
  if (g == 4) kern = hgemm_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.grid, 128 * 5, smem, s>>>(mx, mb, a, N, p.stages, p.th, p.tw, e);
  return static_cast<int>(cudaGetLastError());
}

// x_type/w_type: DType.  ``ws``: the split-K workspace of a plan with
// split > 1 (f32 for "wgmma_w8" and "wgmma_bf16", int32 for "wgmma"), else
// null.  The weight's (N, K) rows lie p.ldw
// elements apart (0: K).
template <class A>
inline int launch_gemm(const A& a, const void* w, int N, int x_type,
                       int w_type, const GemmPlan& p, void* ws,
                       const Epilogue& e, cudaStream_t s) {
  constexpr bool CONV = std::is_same<A, ConvA>::value;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 0 || N <= 0) return 0;
  const bool int8 = x_type == DT_I8 && w_type == DT_I8;
  const int ldw = p.ldw ? p.ldw : a.K;
  if (ldw < a.K) return bad;
  // the A rows' pitch in elements: K for a matrix, C for a conv
  const int pitch = host_row_pitch(a);
  const int8_t* wq = static_cast<const int8_t*>(w);
  float* wsf = static_cast<float*>(ws);
  if (p.variant == V_WGMMA_W8) {
    if (x_type != DT_BF16 || w_type != DT_I8 || pitch % 8 || ldw % 8 ||
        !aligned(a.x, 16) || !aligned(w, 16))
      return bad;
    switch (p.bn) {
      case 32: return launch_w8gemm<A, 32, false>(a, w, ldw, N, p, wsf, e, s);
      case 64: return launch_w8gemm<A, 64, false>(a, w, ldw, N, p, wsf, e, s);
      case 128: return launch_w8gemm<A, 128, false>(a, w, ldw, N, p, wsf, e, s);
      default: return bad;
    }
  }
  if (p.variant == V_WGMMA_BF16) {
    if constexpr (CONV) {
      return bad;
    } else {
      if (x_type != DT_BF16 || w_type != DT_BF16 || a.K % 8 || ldw % 8 ||
          !aligned(a.x, 16) || !aligned(w, 16))
        return bad;
      switch (p.bn) {
        case 32: return launch_w8gemm<A, 32, true>(a, w, ldw, N, p, wsf, e, s);
        case 64: return launch_w8gemm<A, 64, true>(a, w, ldw, N, p, wsf, e, s);
        case 128: return launch_w8gemm<A, 128, true>(a, w, ldw, N, p, wsf, e, s);
        default: return bad;
      }
    }
  }
  if (p.th != 0) return bad;
  int* wsi = static_cast<int*>(ws);
  if (p.variant == V_WGMMA_S8) {
    if (!int8 || pitch % 16 || pitch < 16 || !aligned(a.x, 16) ||
        !aligned(w, 16))
      return bad;
    return launch_wgemm_tile<A, false>(a, wq, ldw, N, p, wsi, e, s);
  }
  if (p.variant == V_WGMMA_RAGGED) {
    // a conv's taps in 8-byte pieces; a matrix's rows at any alignment
    if (!int8 || !aligned(w, 16) || (CONV && (pitch % 8 || !aligned(a.x, 8))))
      return bad;
    return launch_wgemm_tile<A, true>(a, wq, ldw, N, p, wsi, e, s);
  }
  if (p.split != 1) return bad;
  if (p.variant == V_MMA_S8) {
    if (!int8) return bad;
    dim3 grid(static_cast<unsigned>((a.M + IG_BM - 1) / IG_BM),
              static_cast<unsigned>((N + IG_BN - 1) / IG_BN));
    igemm_kernel<A><<<grid, IG_THREADS, 0, s>>>(a, wq, ldw, N, e);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.variant != V_SIMT) return bad;
  dim3 grid(static_cast<unsigned>((a.M + FG_BM - 1) / FG_BM),
            static_cast<unsigned>((N + FG_BN - 1) / FG_BN));
  if (x_type == DT_F32 && w_type == DT_F32)
    fgemm_kernel<A, float, float><<<grid, 256, 0, s>>>(
        a, static_cast<const float*>(w), ldw, N, e);
  else if (x_type == DT_F32 && w_type == DT_I8)
    fgemm_kernel<A, float, int8_t><<<grid, 256, 0, s>>>(a, wq, ldw, N, e);
  else if (x_type == DT_BF16 && w_type == DT_BF16)
    fgemm_kernel<A, __nv_bfloat16, __nv_bfloat16><<<grid, 256, 0, s>>>(
        a, static_cast<const __nv_bfloat16*>(w), ldw, N, e);
  else if (x_type == DT_BF16 && w_type == DT_I8)
    fgemm_kernel<A, __nv_bfloat16, int8_t><<<grid, 256, 0, s>>>(a, wq, ldw, N,
                                                                e);
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
                          int grid, int smem, int split, int th, int tw,
                          int ldw, int sst) {
  GemmPlan p;
  p.ldw = ldw;
  p.sst = sst;
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
