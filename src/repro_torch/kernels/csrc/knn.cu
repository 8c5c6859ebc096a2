// kNN top-k for Hopper (sm_90a): per row of squared distances and record
// ids, the k smallest pairs in ascending (distance, id) order.
//
// Replaces knn_topk_pallas (repro/kernels/refine.py). The reference sorts
// the operand pair [d, ids] with a two-key sort and keeps k columns; both
// kernels here return exactly that, duplicates included, in the order of
// a stable sort (equal pairs by column). (The Pallas body masks every lane
// equal to the selected pair at once, which drops duplicate pairs; the
// sort keeps them.) Distances order as the two-key sort orders them: -0
// equals +0, and every NaN sorts after +inf. Rounds past the row's width
// write (+inf, INT32_MAX), the sort's padding.
//
// Bound: bytes, each (distance, id) pair read once and the (k) outputs
// written once. Two routes (the wrapper's knn_plan picks by width):
//
// - knn_warp_kernel<E>, rows of up to 32 E columns (E = 1, 2, 4 .. 32):
//   one warp a row, 8 rows a block, no block barrier. Lane l holds columns
//   l E .. l E + E - 1 in registers as (pair key, distance bits), sorted
//   stably by key (odd-even transposition). A round takes the warp's least
//   head with two __reduce_min_sync (the key's high word, then the low
//   word among the lanes that hold that high word) and a __ballot_sync:
//   the lowest lane holding the least key pops its head (so equal pairs
//   leave in column order, one a round). A lane whose real columns are
//   spent takes no part, so the row's padding never passes a real pair.
// - knn_topk_kernel, any wider row: one block of 256 threads a row, k
//   rounds of a block-wide argmin over the lexicographic triple
//   (distance, id, column), each round taking the least triple strictly
//   above the one the last round took. Each thread holds the least triple
//   of its own columns (a strided slice of the row) above the last pick;
//   after the first pass only the thread that owned the pick rescans its
//   slice. A round is one rescan of B / 256 columns and one block
//   reduction (warp shuffles, then the eight warp winners through shared
//   memory, double-buffered so a round needs one barrier).
//
// Both read the row once (the block route plus k slices of B / 256); their
// rounds are serial, so a row's time grows with k. The block route's k
// barrier-bound rounds per row were its cost at the kNN rank's rows; a
// warp round is a few warp instructions.
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

constexpr int kRowsPerBlock = 8;     // warp route: one row a warp

// The least of the live lanes' keys: the minimum of the high words, then of
// the low words among the lanes that hold that high word; the lowest such
// lane wins. Returns the winning lane (-1 when no lane is live) to every
// lane.
__device__ __forceinline__ int warp_least(bool live, unsigned long long key) {
  const uint32_t hi = live ? static_cast<uint32_t>(key >> 32) : 0xFFFFFFFFu;
  const uint32_t m_hi = __reduce_min_sync(0xffffffffu, hi);
  const uint32_t lo = (live && hi == m_hi) ? static_cast<uint32_t>(key) : 0xFFFFFFFFu;
  const uint32_t m_lo = __reduce_min_sync(0xffffffffu, lo);
  const unsigned who = __ballot_sync(0xffffffffu, live && hi == m_hi && lo == m_lo);
  return who ? __ffs(who) - 1 : -1;
}

template <int E>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
knn_warp_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                float* __restrict__ out_d, int* __restrict__ out_i, int q, int b,
                int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= q) return;                        // a whole warp leaves
  const float* rd = d + row * b;
  const int* ri = ids + row * b;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  const int lane = threadIdx.x & 31;
  unsigned long long key[E];
  uint32_t bits[E];
  const int first = lane * E;
  int left = min(max(b - first, 0), E);        // this lane's real columns
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool ok = e < left;
    const float v = ok ? rd[first + e] : __int_as_float(0x7f800000);
    key[e] = ok ? pair_key(v, ri[first + e]) : kNoKey;
    bits[e] = __float_as_uint(v);
  }
  // stable sort of the lane's columns: odd-even transposition, swapping
  // only a strictly greater key forward (padding stays behind real pairs)
#pragma unroll
  for (int r = 0; r < E; ++r)
#pragma unroll
    for (int e = r & 1; e + 1 < E; e += 2)
      if (key[e + 1] < key[e]) {
        const unsigned long long tk = key[e];
        key[e] = key[e + 1];
        key[e + 1] = tk;
        const uint32_t tb = bits[e];
        bits[e] = bits[e + 1];
        bits[e + 1] = tb;
      }
  int j = 0;
  for (; j < k; ++j) {
    const int w = warp_least(left > 0, key[0]);
    if (w < 0) break;                          // every real pair is out
    if (lane == w) {
      od[j] = __uint_as_float(bits[0]);
      oi[j] = static_cast<int>(static_cast<uint32_t>(key[0]) ^ 0x80000000u);
#pragma unroll
      for (int e = 0; e + 1 < E; ++e) {
        key[e] = key[e + 1];
        bits[e] = bits[e + 1];
      }
      --left;
    }
  }
  for (int r = j + lane; r < k; r += 32) {     // the sort's padding
    od[r] = __int_as_float(0x7f800000);
    oi[r] = INT_MAX;
  }
}

template <int E>
cudaError_t launch_warp(const void* d, const void* ids, void* out_d, void* out_i, int q, int b,
                        int k, cudaStream_t stream) {
  knn_warp_kernel<E><<<(q + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const float*>(d), static_cast<const int*>(ids), static_cast<float*>(out_d),
      static_cast<int*>(out_i), q, b, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The route (kernels.knn.knn_plan): per_lane 1, 2, 4, 8, 16 or 32 (at least
// ceil(b / 32)) for a warp a row; per_lane 0 for a block a row.
int glin_knn_topk(const void* d, const void* ids, void* out_d, void* out_i, int q,
                  int b, int k, int per_lane, void* stream) {
  if (q < 1 || k < 1 || b < 0 || (per_lane > 0 && 32LL * per_lane < b))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (per_lane == 0) {
    knn_topk_kernel<<<q, kThreads, 0, cs>>>(static_cast<const float*>(d),
                                            static_cast<const int*>(ids),
                                            static_cast<float*>(out_d),
                                            static_cast<int*>(out_i), b, k);
    return static_cast<int>(cudaGetLastError());
  }
  switch (per_lane) {
    case 1: return static_cast<int>(launch_warp<1>(d, ids, out_d, out_i, q, b, k, cs));
    case 2: return static_cast<int>(launch_warp<2>(d, ids, out_d, out_i, q, b, k, cs));
    case 4: return static_cast<int>(launch_warp<4>(d, ids, out_d, out_i, q, b, k, cs));
    case 8: return static_cast<int>(launch_warp<8>(d, ids, out_d, out_i, q, b, k, cs));
    case 16: return static_cast<int>(launch_warp<16>(d, ids, out_d, out_i, q, b, k, cs));
    case 32: return static_cast<int>(launch_warp<32>(d, ids, out_d, out_i, q, b, k, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
