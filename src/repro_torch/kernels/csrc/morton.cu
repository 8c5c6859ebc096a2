// Morton (Z-address) encoding for Hopper (sm_90a): 30-bit integer (x, y)
// grid coordinates -> (hi, lo) int32 limbs.
//
// Replaces morton_encode_pallas (repro/kernels/morton.py). Each limb is an
// independent 15x15-bit interleave (bits [0, 15) of x and y give the low
// limb, bits [15, 30) the high one), so no 64-bit arithmetic is needed. The
// TPU kernel worked on (8, 128) tiles; here one thread encodes one element,
// in a grid-stride loop.
//
// Bound: bytes — 8 bytes read and 8 written per element, a few dozen integer
// operations in between.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// spread the low 16 bits of v over the even bit positions
__device__ inline uint32_t part1by1(uint32_t v) {
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__global__ void __launch_bounds__(kThreads)
morton_kernel(const int* __restrict__ qx, const int* __restrict__ qy,
              int* __restrict__ hi, int* __restrict__ lo, int n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int x = qx[i], y = qy[i];
    lo[i] = static_cast<int>(part1by1(static_cast<uint32_t>(x & 0x7FFF)) |
                             (part1by1(static_cast<uint32_t>(y & 0x7FFF)) << 1));
    // arithmetic shifts, as the reference's int32 `>> 15`
    hi[i] = static_cast<int>(part1by1(static_cast<uint32_t>(x >> 15)) |
                             (part1by1(static_cast<uint32_t>(y >> 15)) << 1));
  }
}

}  // namespace

extern "C" {

int glin_morton_encode(const void* qx, const void* qy, void* hi, void* lo, int n,
                       void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n) + kThreads - 1) / kThreads < 132 * 64
          ? (static_cast<int64_t>(n) + kThreads - 1) / kThreads
          : 132 * 64);
  morton_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qx), static_cast<const int*>(qy), static_cast<int*>(hi),
      static_cast<int*>(lo), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
