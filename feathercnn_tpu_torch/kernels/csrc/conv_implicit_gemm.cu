// conv_implicit_gemm: NHWC convolution as an implicit GEMM, with the same
// epilogue as matmul_epilogue.
//
// Replaces the Pallas kernel feathercnn_tpu/kernels/conv.py:100
// (conv2d_implicit_gemm; body _conv_kernel at :47-93).  Same function:
// y[n, oh, ow, co] = epilogue(sum over kh, kw, c of
// x[n, oh*s - ph + kh*d, ow*s - pw + kw*d, c] * w[kh, kw, c, co]), with
// zero padding.  As a GEMM: M = N*OH*OW output pixels, N = Co, K = KH*KW*C.
// The dilation d (1 but for the dilated int8 convs, which the reference
// leaves to XLA's int8 conv, feathercnn_tpu/kernels/dispatch.py:221-252:
// DeepLab's conv5 at d = 2 and fc6 at d = 12, PSPNet's stages 4-5 at
// d = 2 and 4) only spaces the taps: each tap's offset from a row's
// window origin is (kh*d, kw*d) pixels, the same bounds check zero-fills
// the taps that land in the padding (at d = 12 on a 41x41 map most of
// them), and nothing else of the plan or the tiles changes.
//
// What bounds it on an H100 SXM: the main path's convs are the 3x3 stride-1
// int8 convs at 56^2*64, 28^2*128, 14^2*256 and 7^2*512 (batch 128).  They
// do 2*M*Co*9*C int8 operations against 1,979 TOP/s and move
// N*H*W*C + 9*C*Co + M*Co bytes against 3.35 TB/s: about 9*C operations
// per byte at C == Co, so the 64-channel stage sits near the card's balance
// point (~590 operations per byte) and the 128..512-channel stages are
// bound by the tensor cores.
//
// What the design does about it (gemm_common.cuh has the details): no
// im2col is written to memory.  The weight is kept (Co, KH*KW*C) with K
// contiguous in (kh, kw, c) order (gemm_layout, made once per node) and
// arrives by TMA, once per block where its panel fits shared memory.  A persistent block per SM walks 128 x BN output tiles;
// its producer warpgroup gathers the tile's A rows straight from the
// unpadded input with 16-byte cp.async into the swizzled stage (each of
// its threads resolves 128 pixels once per tile and advances its tap by
// counters, so the K loop has no division; a bounds check stands in for
// the zero padding), ahead of two consumer warpgroups running wgmma
// m64nBNk32 with int32 accumulation over the whole K.  The epilogue is
// staged through shared memory and leaves as 16-byte row pieces.  C a
// multiple of 8 but not of 16 (GoogLeNet's 5x5 convs on C = 24), or an x
// 8- but not 16-byte aligned, takes "wgmma_ragged": the same kernel with
// the gather in 8-byte cp.async pieces (a tap's channels are whole 8-byte
// pieces; the src-size 0 form zero-fills the padding and the K past its
// end) and the weight's rows padded to a 16-byte pitch once per node
// (gemm_layout), so that B still comes by TMA.  C not a multiple of 8 or
// an x not 8-byte aligned takes the mma.sync variant (no zoo launch); f32
// x the SIMT loop.
//
// At batch 1 a conv has few 128-row tiles: R-FCN's stage-5 convs at
// dilation 2 (38x50 maps, M = 1,900, K = 4,608, N = 512) make 15 x 2 = 30
// tiles, and 30 blocks walking all 36 K steps left 102 SMs idle.  Where
// the tiles leave SMs idle the plan (gemm_plan, from the tiles and the SMs
// alone) splits K: each block runs one slice (9 of R-FCN's 36 steps, 120
// blocks) and writes its int32 sums to a workspace, and a second pass adds
// the slices, exactly, and applies the same epilogue, as for a matrix
// (matmul_epilogue.cu).  The producer starts a slice's gather at its tap
// (one division per slice).  The batch-128 convs have hundreds of tiles
// and do not split; nor does "wgmma_ragged" (no zoo launch would).
//
// Weight-only int8 (bf16 x, int8 w: VGG-16 w8's twelve 3x3 convs after the
// stem, C and Co 64 to 512, stride 1) is bound by the bf16 tensor cores
// (9*C*Co / (C + Co) operations per byte of x and output, 288 to 2304).
// What held the design back on the card was the A tile's gather (16-byte
// cp.async from the producer's 128 threads, 8 channels a piece), then the
// conversion of the weight tile and the loads from L2.  Variant
// "wgmma_w8": at stride 1 with C a multiple of 64, A comes by TMA, one
// (64 channels, tw, th, 1) box per tap over a rectangle of at most 128
// output pixels of one image (conv_tile in kernels/matmul.py: the fewest
// rectangles per image), the box shifted by the tap and zero-filled
// outside the image; otherwise the producer gathers A with cp.async (C a
// multiple of 8).  The int8 weight tile comes by cp.async into the ring's
// staging slot and the two consumers convert it to the 128-byte-swizzled
// bf16 tile (byte permutes and exact f32 subtractions, four weights in
// eleven instructions) while the last step's wgmma m64nBNk16 bf16 runs,
// with f32 sums over the whole K; the epilogue leaves from the registers.
// The tile is as wide as Co, at most 128 (a 256-wide tile's 128 sums a
// thread spilled and ran slower).
//
// A grouped int8 conv (1 < group < C; ResNeXt-50's sixteen cardinality-32
// 3x3 convs, C = Co = 128 to 1024, 4 to 32 channels a group), which the
// reference leaves to XLA's int8 conv with feature_group_count
// (feathercnn_tpu/kernels/dispatch.py:221-231), is memory-bound: x in and
// y out are its bytes, 2*M*Co*9*C/group its operations (9*Cg per byte).
// Run on its block-diagonal dense weight it was a dense product group
// times larger, bound by the tensor cores and by A's gather (each column
// tile re-gathering all 9*C bytes of a row).  Entry
// fcnn_conv_implicit_gemm_grouped runs it as super-groups on variant
// "wgmma_halo" (hgemm_kernel, gemm_common.cuh): a column tile is q whole
// groups (kernels/matmul.py::supergroup: 32 outputs reading S = 32 input
// channels, q = 32/Cg for ResNeXt), against the compact weight
// (grouped_layout: Co rows of 9*S, zero off each output channel's group).
// Each tile of at most 128 output pixels has its input halo (the 32
// channels of each of four column tiles, 128-byte rows, at stride 1; of
// one at stride 2) brought once by one 4-D TMA box, and the nine taps are
// read from it by ldmatrix into register-A wgmma, two pairs of consumer
// warpgroups taking tiles in turn; what binds it then is the tile's
// epilogue (PERF.md).  The grid is a multiple of the column-tile groups
// and unit u's group is u's remainder, so the blocks reading one tile's
// disjoint channel slices run side by side and its pixels stay in L2.
// Any other grouped conv runs on the plain entry with its block-diagonal
// weight.
//
// The Pallas kernel's staging (row slabs,
// batch chunks, stride-2 parity planes, shifted products, lax.map over
// chunks) exists for the TPU's VMEM and (8, 128) tiling and is not carried
// over.
//
// The reference converts each tap's int32 product to f32 and sums the taps
// in f32; this kernel keeps the whole K in int32.  The two agree exactly
// while |acc| < 2^24.
#include "gemm_common.cuh"

namespace {

fcnn::ConvA conv_a(const void* x, int N, int H, int W, int C, int KH, int KW,
                   int sh, int sw, int ph, int pw, int d) {
  fcnn::ConvA a;
  a.x = static_cast<const char*>(x);
  a.H = H;
  a.W = W;
  a.C = C;
  a.KW = KW;
  a.sh = sh;
  a.sw = sw;
  a.ph = ph;
  a.pw = pw;
  a.d = d;
  a.OH = (H + 2 * ph - d * (KH - 1) - 1) / sh + 1;
  a.OW = (W + 2 * pw - d * (KW - 1) - 1) / sw + 1;
  a.M = N * a.OH * a.OW;
  a.K = KH * KW * C;
  return a;
}

int conv_implicit_gemm(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int N, int H,
    int W, int C, int KH, int KW, int Co, int sh, int sw, int ph, int pw,
    int d, int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, int split, int th, int tw, int ldw, int sst,
    void* ws, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the dilated kernel spans d*(K-1)+1 pixels; a span past the padded
  // input leaves no output
  if (H + 2 * ph < d * (KH - 1) + 1 || W + 2 * pw < d * (KW - 1) + 1)
    return 0;
  const fcnn::ConvA a = conv_a(x, N, H, W, C, KH, KW, sh, sw, ph, pw, d);
  const fcnn::Epilogue e = fcnn::make_epilogue(
      out, bias, w_scale, lo, hi, act, x_scale, out_scale, out_type);
  return fcnn::launch_gemm(
      a, w, Co, x_type, w_type,
      fcnn::make_plan(variant, bn, bk, stages, bres, grid, smem, split, th,
                      tw, ldw, sst),
      ws, e,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// The undilated conv (d = 1).
extern "C" int fcnn_conv_implicit_gemm(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int N, int H,
    int W, int C, int KH, int KW, int Co, int sh, int sw, int ph, int pw,
    int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, int split, int th, int tw, int ldw, int sst,
    void* ws, void* stream) {
  return conv_implicit_gemm(x, w, out, bias, w_scale, lo, hi, N, H, W, C,
                            KH, KW, Co, sh, sw, ph, pw, 1, x_type, w_type,
                            out_type, act, x_scale, out_scale, variant, bn,
                            bk, stages, bres, grid, smem, split, th, tw, ldw,
                            sst, ws, stream);
}

// The same conv at dilation d: tap (kh, kw) reads pixel (kh*d, kw*d) of
// the output pixel's window.
extern "C" int fcnn_conv_implicit_gemm_dilated(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int N, int H,
    int W, int C, int KH, int KW, int Co, int sh, int sw, int ph, int pw,
    int d, int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, int split, int th, int tw, int ldw, int sst,
    void* ws, void* stream) {
  return conv_implicit_gemm(x, w, out, bias, w_scale, lo, hi, N, H, W, C,
                            KH, KW, Co, sh, sw, ph, pw, d, x_type, w_type,
                            out_type, act, x_scale, out_scale, variant, bn,
                            bk, stages, bres, grid, smem, split, th, tw, ldw,
                            sst, ws, stream);
}

// A grouped conv as super-groups of S = 32 channels ("wgmma_halo"): column
// tile nt (32 output channels) reads input channels nt*S .. nt*S + S - 1
// of each tap; w is the compact (Co, 9*S) weight (grouped_layout).
extern "C" int fcnn_conv_implicit_gemm_grouped(
    const void* x, const void* w, void* out, const float* bias,
    const float* w_scale, const float* lo, const float* hi, int N, int H,
    int W, int C, int KH, int KW, int Co, int sh, int sw, int ph, int pw,
    int S, int x_type, int w_type, int out_type, int act, float x_scale,
    float out_scale, int variant, int bn, int bk, int stages, int bres,
    int grid, int smem, int split, int th, int tw, int ldw, int sst,
    void* ws, void* stream) {
  if (ws != nullptr || sst != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H + 2 * ph < KH || W + 2 * pw < KW) return 0;
  const fcnn::ConvA a = conv_a(x, N, H, W, C, KH, KW, sh, sw, ph, pw, 1);
  return fcnn::launch_hgemm(
      a, KH, S, w, Co, x_type, w_type,
      fcnn::make_plan(variant, bn, bk, stages, bres, grid, smem, split, th,
                      tw, ldw, sst),
      fcnn::make_epilogue(out, bias, w_scale, lo, hi, act, x_scale,
                          out_scale, out_type),
      static_cast<cudaStream_t>(stream));
}
