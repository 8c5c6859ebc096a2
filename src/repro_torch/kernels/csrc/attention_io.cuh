// Loads and stores shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): 16-byte vector loads of fp32 or bf16 rows converted
// to fp32, the output cast (round to nearest even, as torch's .to()), and
// the asynchronous 16-byte copies (cp.async) that stage K/V tiles in shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn_io {

constexpr float kNegInf = -1e30f;  // the reference's mask fill (not -inf)

// elements of T in one 16-byte load
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16 bytes at p (16-byte aligned) -> kVec<T> floats
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously; with
// full = false nothing is read and the 16 bytes are zero-filled. No memory
// clobber (loads may move across this instruction); cp_async_wait and the
// barriers order the shared memory it writes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace attn_io
