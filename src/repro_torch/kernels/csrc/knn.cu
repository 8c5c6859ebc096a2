// kNN top-k for Hopper (sm_90a): per row of squared distances and record
// ids, the k smallest pairs in ascending (distance, id) order.
//
// Replaces knn_topk_pallas (repro/kernels/refine.py). The reference sorts
// the operand pair [d, ids] with a two-key sort and keeps k columns; this
// kernel returns exactly that, duplicates included: one block per row runs
// k rounds of a block-wide argmin over the lexicographic triple
// (distance, id, lane), each round taking the least triple strictly above
// the one the last round took. (The Pallas body masks every lane equal to
// the selected pair at once, which drops duplicate pairs; the sort keeps
// them, and the lane breaks the tie between them.) Distances order as the
// two-key sort orders them: -0 equals +0, and every NaN sorts after +inf.
// Rounds past the row's width write (+inf, INT32_MAX), the sort's padding.
//
// Each thread holds the least triple of its own lanes (a strided slice of
// the row) above the last pick. A pick is the least triple above the last
// one, so every other thread's candidate stays valid: after the first pass
// only the thread that owned the pick rescans its slice. A round is then
// one rescan of B / 256 lanes and one block reduction (warp shuffles, then
// the eight warp winners through shared memory, double-buffered so a round
// needs one barrier).
//
// Bound: bytes, each (distance, id) pair read once and the (k) outputs
// written once. This design reads the row once, plus k slices of B / 256
// lanes; its rounds are serial, so a row's time grows with k.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNoKey = ~0ull;

// Order-preserving unsigned key of a distance (the two-key sort's total
// order): -0 -> +0, every NaN -> the largest key.
__device__ inline uint32_t dist_key(float d) {
  if (d != d) return 0xFFFFFFFFu;
  uint32_t b = __float_as_uint(d);
  if (d == 0.0f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (distance, id) as one unsigned 64-bit key; the id's sign bit is flipped so
// signed ids order as unsigned keys.
__device__ inline unsigned long long pair_key(float d, int id) {
  return (static_cast<unsigned long long>(dist_key(d)) << 32) |
         (static_cast<uint32_t>(id) ^ 0x80000000u);
}

__device__ inline bool triple_less(unsigned long long ka, int la, unsigned long long kb,
                                   int lb) {
  return ka < kb || (ka == kb && la < lb);
}

// the least triple of lanes [first, b) step kThreads above (t_key, t_lane)
__device__ inline void least_above(const float* __restrict__ rd,
                                   const int* __restrict__ ri, int first, int b,
                                   unsigned long long t_key, int t_lane,
                                   unsigned long long& best_key, int& best_lane) {
  best_key = kNoKey;
  best_lane = INT_MAX;
  for (int l = first; l < b; l += kThreads) {
    const unsigned long long key = pair_key(rd[l], ri[l]);
    if (triple_less(t_key, t_lane, key, l) && triple_less(key, l, best_key, best_lane)) {
      best_key = key;
      best_lane = l;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                float* __restrict__ out_d, int* __restrict__ out_i, int b, int k) {
  __shared__ unsigned long long warp_key[2][kWarps];
  __shared__ int warp_lane[2][kWarps];
  const int64_t row = blockIdx.x;
  const float* rd = d + row * b;
  const int* ri = ids + row * b;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long mine_key;
  int mine_lane;
  least_above(rd, ri, threadIdx.x, b, 0ull, -1, mine_key, mine_lane);
  for (int j = 0; j < k; ++j) {
    unsigned long long best_key = mine_key;
    int best_lane = mine_lane;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ok = __shfl_down_sync(0xffffffffu, best_key, o);
      const int ol = __shfl_down_sync(0xffffffffu, best_lane, o);
      if (triple_less(ok, ol, best_key, best_lane)) {
        best_key = ok;
        best_lane = ol;
      }
    }
    const int buf = j & 1;
    if (lane == 0) {
      warp_key[buf][warp] = best_key;
      warp_lane[buf][warp] = best_lane;
    }
    __syncthreads();
    best_key = warp_key[buf][0];
    best_lane = warp_lane[buf][0];
    for (int w = 1; w < kWarps; ++w) {
      if (triple_less(warp_key[buf][w], warp_lane[buf][w], best_key, best_lane)) {
        best_key = warp_key[buf][w];
        best_lane = warp_lane[buf][w];
      }
    }
    if (best_lane == INT_MAX) {  // the row is exhausted (k > b)
      for (int r = j + threadIdx.x; r < k; r += kThreads) {
        od[r] = __int_as_float(0x7f800000);
        oi[r] = INT_MAX;
      }
      return;
    }
    if (threadIdx.x == 0) {
      od[j] = rd[best_lane];
      oi[j] = ri[best_lane];
    }
    if (mine_lane == best_lane)  // the owner of the pick moves past it
      least_above(rd, ri, threadIdx.x, b, best_key, best_lane, mine_key, mine_lane);
  }
}

}  // namespace

extern "C" {

int glin_knn_topk(const void* d, const void* ids, void* out_d, void* out_i, int q,
                  int b, int k, void* stream) {
  if (q < 1 || k < 1 || b < 0) return static_cast<int>(cudaErrorInvalidValue);
  knn_topk_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int*>(ids),
      static_cast<float*>(out_d), static_cast<int*>(out_i), b, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
