// ident: a copy of x, chunk by chunk of images.
//
// Replaces the Pallas kernel `ident` inside bench/chain_micro.py:main
// (:180-196, pallas_call at :187): an identity kernel over (N // chunk)
// chunks of `chunk` images each, which the chain probe's idctx mode puts
// between a producer conv and a consumer conv to measure what one more
// custom-kernel boundary costs.  Here it measures what one more hand-kernel
// launch through ctypes costs between two kernels of a path.
//
// What bounds it on an H100 SXM: bytes, |x| read and |x| written against
// 3.35 TB/s; it does no arithmetic.
//
// The design: grid (blocks, chunks), one row of blocks per chunk of images
// as the reference's grid is one step per chunk.  Where x and out share
// their alignment mod 16, each chunk moves as a byte head up to the first
// 16-byte boundary, 16-byte vectors (a grid-stride loop, neighbouring
// threads on neighbouring vectors) and a masked byte tail; otherwise byte
// by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace fcnn {
namespace {

constexpr int ID_THREADS = 256;

__global__ void __launch_bounds__(ID_THREADS)
ident_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
             long long chunk_bytes, int vec) {
  const long long start = static_cast<long long>(blockIdx.y) * chunk_bytes;
  const uint8_t* src = x + start;
  uint8_t* dst = out + start;
  const long long stride = static_cast<long long>(gridDim.x) * ID_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * ID_THREADS +
                       threadIdx.x;
  long long head = chunk_bytes;
  long long body = 0;
  if (vec) {
    head = (16 - reinterpret_cast<uintptr_t>(src) % 16) % 16;
    if (head > chunk_bytes) head = chunk_bytes;
    body = (chunk_bytes - head) / 16;
  }
  for (long long i = t0; i < head; i += stride) dst[i] = src[i];
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  for (long long i = t0; i < body; i += stride) vd[i] = vs[i];
  const long long done = head + body * 16;
  for (long long i = done + t0; i < chunk_bytes; i += stride) dst[i] = src[i];
}

}  // namespace
}  // namespace fcnn

// Copies chunks * chunk_bytes bytes from x to out.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int fcnn_ident(const void* x, void* out, long long chunk_bytes,
                          int chunks, void* stream) {
  using namespace fcnn;
  if (chunks <= 0 || chunk_bytes <= 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 ==
                  reinterpret_cast<uintptr_t>(out) % 16;
  // enough blocks for ~4 vectors a thread, at most 4096 a chunk
  long long blocks = (chunk_bytes / 16 + 4LL * ID_THREADS - 1) /
                     (4LL * ID_THREADS);
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  ident_kernel<<<grid, ID_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), chunk_bytes,
      vec);
  return static_cast<int>(cudaGetLastError());
}
