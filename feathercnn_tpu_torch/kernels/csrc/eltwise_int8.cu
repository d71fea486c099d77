// eltwise_int8: the int8-edge residual add, one pass over its operands.
//
// Replaces no Pallas kernel: the reference's int8 Eltwise is plain jnp
// (feathercnn_tpu/ops/lowering.py:1837-1851, `_lower_eltwise`'s
// `eltwise_int8` branch), which XLA fuses into one loop.  Per element:
//
//   acc = x0 * s0 + x1 * s1     (f32; the first product fused into the add)
//   acc = act(acc)              (none, relu or relu6)
//   y   = clip(round_half_even(acc * y_inv), -127, 127)   as int8
//
// in that order and with the same roundings as the port's plain version
// (kernels/eltwise.py: `eltwise_int8_plain`, i.e. `torch.addcmul` over
// `x1 * s1`, then a multiply by the f32 reciprocal of the output scale, as
// XLA compiles the reference's division by that constant): the explicit
// `_rn` intrinsics keep nvcc's `--fmad` from contracting any other
// product.
//
// What bounds it on an H100 SXM: bytes.  Two int8 reads and one int8 write
// an element, 3 bytes against 3.35 TB/s; its arithmetic (two int8 -> f32
// conversions, a multiply, an FMA, the activation, a multiply, the
// rounding, the clamp, the cast) stays well under the SMs' instruction
// rate at that byte rate.
//
// The design: each thread moves whole 16-byte vectors (16 elements of each
// operand and of the output), neighbouring threads on neighbouring vectors,
// in a grid-stride loop over a grid sized to fill every SM at full
// occupancy.  Contiguous operands run flat, the n % 16 elements after the
// last whole vector a masked byte tail.  An operand may also be rows of C
// channels at a row pitch of its own (a channel slice of a wider tensor: a
// merged sibling conv's output, passes.merge_sibling_convs), with C and
// the pitches multiples of 16: vector i is then vector i % (C / 16) of row
// i / (C / 16).  The output is contiguous.  The scales are kernel
// arguments, so a launch needs nothing from the device but its operands.
#include <cuda_runtime.h>
#include <stdint.h>

namespace fcnn {
namespace {

constexpr int EW_THREADS = 256;
constexpr int EW_BLOCKS_PER_SM = 2048 / EW_THREADS;

struct Requant {
  float s0, s1, y_inv;
  int act;  // 0 none, 1 relu, 2 relu6 (matmul_epilogue's codes)

  __device__ __forceinline__ uint32_t operator()(uint32_t a,
                                                 uint32_t b) const {
    return static_cast<uint8_t>(one(static_cast<int8_t>(a),
                                    static_cast<int8_t>(b)));
  }

  __device__ __forceinline__ int8_t one(int8_t a, int8_t b) const {
    float acc = __fmaf_rn(static_cast<float>(a), s0,
                          __fmul_rn(static_cast<float>(b), s1));
    if (act == 1) {
      acc = fmaxf(acc, 0.0f);
    } else if (act == 2) {
      acc = fminf(fmaxf(acc, 0.0f), 6.0f);
    }
    float q = rintf(__fmul_rn(acc, y_inv));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return static_cast<int8_t>(__float2int_rn(q));
  }

  // four int8 lanes of a 32-bit word
  __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) const {
    uint32_t r = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r |= (*this)(a >> (8 * k), b >> (8 * k)) << (8 * k);
    }
    return r;
  }
};

// PITCHED: the operands are rows of vpr vectors at pitches ld0, ld1 (in
// vectors), n a multiple of 16 and n / 16 under 2^32; else contiguous.
template <bool PITCHED>
__global__ void __launch_bounds__(EW_THREADS)
eltwise_int8_kernel(const int8_t* __restrict__ x0,
                    const int8_t* __restrict__ x1, int8_t* __restrict__ out,
                    long long n, unsigned vpr, long long ld0, long long ld1,
                    Requant rq) {
  const long long stride = static_cast<long long>(gridDim.x) * EW_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * EW_THREADS +
                       threadIdx.x;
  const long long vecs = n / 16;
  const uint4* v0 = reinterpret_cast<const uint4*>(x0);
  const uint4* v1 = reinterpret_cast<const uint4*>(x1);
  uint4* vo = reinterpret_cast<uint4*>(out);
  for (long long i = t0; i < vecs; i += stride) {
    long long i0 = i;
    long long i1 = i;
    if (PITCHED) {
      const unsigned row = static_cast<unsigned>(i) / vpr;
      const unsigned col = static_cast<unsigned>(i) - row * vpr;
      i0 = row * ld0 + col;
      i1 = row * ld1 + col;
    }
    const uint4 a = __ldg(v0 + i0);
    const uint4 b = __ldg(v1 + i1);
    uint4 r;
    r.x = rq.word(a.x, b.x);
    r.y = rq.word(a.y, b.y);
    r.z = rq.word(a.z, b.z);
    r.w = rq.word(a.w, b.w);
    vo[i] = r;
  }
  if (!PITCHED) {
    for (long long i = vecs * 16 + t0; i < n; i += stride) {
      out[i] = rq.one(x0[i], x1[i]);
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

}  // namespace
}  // namespace fcnn

// out[i] = clip(rint(act(x0[i] * s0 + x1[i] * s1) * y_inv), -127, 127)
// for i < n, on int8 x0, x1 and a contiguous int8 out, each 16-byte
// aligned.  c > 0: each operand is rows of c elements at its own pitch
// (ld0, ld1 elements; c, ld0, ld1 multiples of 16); c = 0: both are
// contiguous.  act: 0 none, 1 relu, 2 relu6.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int fcnn_eltwise_int8(const void* x0, const void* x1, void* out,
                                 long long n, long long c, long long ld0,
                                 long long ld1, float s0, float s1,
                                 float y_inv, int act, void* stream) {
  using namespace fcnn;
  if (n <= 0) return 0;
  const bool pitched = c > 0;
  if (act < 0 || act > 2 || reinterpret_cast<uintptr_t>(x0) % 16 ||
      reinterpret_cast<uintptr_t>(x1) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      (pitched && (c % 16 || ld0 % 16 || ld1 % 16 || ld0 < c || ld1 < c ||
                   n % c || n / 16 >= (1LL << 32)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int sms = sm_count();
  long long blocks = (n / 16 + EW_THREADS - 1) / EW_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > static_cast<long long>(sms) * EW_BLOCKS_PER_SM) {
    blocks = static_cast<long long>(sms) * EW_BLOCKS_PER_SM;
  }
  const Requant rq{s0, s1, y_inv, act};
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(x0);
  const int8_t* b = static_cast<const int8_t*>(x1);
  int8_t* o = static_cast<int8_t*>(out);
  if (pitched) {
    eltwise_int8_kernel<true><<<grid, EW_THREADS, 0, st>>>(
        a, b, o, n, static_cast<unsigned>(c / 16), ld0 / 16, ld1 / 16, rq);
  } else {
    eltwise_int8_kernel<false><<<grid, EW_THREADS, 0, st>>>(
        a, b, o, n, 0u, 0, 0, rq);
  }
  return static_cast<int>(cudaGetLastError());
}
