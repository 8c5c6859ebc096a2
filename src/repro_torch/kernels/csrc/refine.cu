// GLIN refine kernels for Hopper (sm_90a): count, compact, fused and mask.
//
// Count, compact and fused are per-query walks over the query's own slot
// run [start, end) of the Z-sorted record table, one thread block per query.
// The reference TPU kernels (repro/kernels/refine.py) sweep the WHOLE slot
// table for every query tile and mask slots outside the run, and build a
// one-hot (rows, slots, budget) scatter because the TPU vector unit has no
// scatter. Here each block reads only its run and places survivors with a
// block-wide exclusive prefix sum (warp ballot + popcount, then per-warp
// offsets in shared memory). The survivor set, its ascending slot order and
// the total count are the same, because the reference's in-run test zeroes
// every slot outside the run. The compact kernel writes its survivors
// straight to device memory, so its budget has no bound of its own; the
// fused kernel keeps them in shared memory (kMaxBudget).
//
// The mask kernel (the kernel-level ops entry point) writes the whole
// (Q, N) int8 mask, as refine_mask_pallas did: it is bound by those Q * N
// output bytes.
//
// Bound: bytes. The work is fp32 compares on 16-byte MBR rows, one pass over
// each run (count: the record MBR; compact/fused: leaf + record MBR), plus,
// for the fused kernel, the survivors' vertex pods. Loads are float4, and
// neighbouring threads read neighbouring rows, so each run streams in
// 512-byte coalesced transactions per warp.
//
// Built with --fmad=false: the probe's `slope * key + icpt` and every cross
// product in geometry.cuh round as separate operations, as the plain torch
// versions do.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch (a refused launch never runs, and a
// later synchronize would not report it).
#include <cuda_runtime.h>

#include <cstdint>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBudget = 1024;  // fused survivor list: 4 KB of shared memory

__device__ inline bool mbr_meets(const float4 m, const float4 w) {
  return m.x <= w.z && w.x <= m.z && m.y <= w.w && w.y <= m.w;
}

// record MBR covers the window (the "contains" prefilter, e.g. within)
__device__ inline bool mbr_covers(const float4 m, const float4 w) {
  return m.x <= w.x && m.y <= w.y && w.z <= m.z && w.w <= m.w;
}

__device__ inline bool z_less(int a_hi, int a_lo, int b_hi, int b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo < b_lo);
}

// Exclusive prefix of `flag` over the block in thread order; `total` gets
// the block's count. Every thread of the block must call it.
__device__ inline int block_exclusive_scan(bool flag, int* warp_sums,
                                           int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int within = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_sums[w];
      warp_sums[w] = acc;
      acc += c;
    }
    warp_sums[kWarps] = acc;
  }
  __syncthreads();
  const int pos = warp_sums[warp] + within;
  total = warp_sums[kWarps];
  __syncthreads();  // warp_sums is reused by the next call
  return pos;
}

__device__ inline int block_sum(int v, int* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;  // valid in thread 0
}

// ------------------------------------------------------------------ count
__global__ void __launch_bounds__(kThreads)
count_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
             const float4* __restrict__ mbrs, int* __restrict__ out, int n) {
  __shared__ int warp_sums[kWarps];
  const int q = blockIdx.x;
  const float4 w = win[q];
  const int2 b = bounds[q];
  const int lo = max(b.x, 0), hi = min(b.y, n);
  int c = 0;
  for (int s = lo + threadIdx.x; s < hi; s += kThreads) c += mbr_meets(mbrs[s], w);
  const int total = block_sum(c, warp_sums);
  if (threadIdx.x == 0) out[q] = total;
}

// ------------------------------------------------------------------ mask
// The (Q, N) int8 candidate mask: slot in [start, end) AND record MBR meets
// the window. Blocks tile the slots along x and a group of kMaskRows query
// rows along y: each thread reads its slot's MBR once and writes one byte
// per row, neighbouring threads on neighbouring bytes.
constexpr int kMaskRows = 16;

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
            const float4* __restrict__ mbrs, int8_t* __restrict__ out, int q, int n) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float4 m = mbrs[s];
  const int r1 = min(q, (static_cast<int>(blockIdx.y) + 1) * kMaskRows);
  for (int r = blockIdx.y * kMaskRows; r < r1; ++r) {
    const int2 b = bounds[r];
    out[static_cast<int64_t>(r) * n + s] =
        static_cast<int8_t>(s >= b.x && s < b.y && mbr_meets(m, win[r]));
  }
}

// ------------------------------------------------------------------ compact
// One pass over the run: survivors (leaf MBR meets the probe window and the
// record MBR meets or covers it) go to column = running count + block prefix,
// written only below the budget; the count is the TOTAL, which may exceed it.
template <bool kCovers>
__device__ inline int compact_run(const float4 w, int lo, int hi,
                                  const float4* __restrict__ lmbr,
                                  const float4* __restrict__ rmbr, int* out,
                                  int budget, int* warp_sums) {
  int running = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int s = base + threadIdx.x;
    bool keep = false;
    if (s < hi) {
      const float4 r = rmbr[s];
      keep = mbr_meets(lmbr[s], w) && (kCovers ? mbr_covers(r, w) : mbr_meets(r, w));
    }
    int total;
    const int pos = running + block_exclusive_scan(keep, warp_sums, total);
    if (keep && pos < budget) out[pos] = s;
    running += total;
  }
  return running;
}

template <bool kCovers>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
               const float4* __restrict__ lmbr, const float4* __restrict__ rmbr,
               int* __restrict__ slots, int* __restrict__ counts, int n,
               int budget) {
  __shared__ int warp_sums[kWarps + 1];
  const int q = blockIdx.x;
  const int2 b = bounds[q];
  int* out = slots + static_cast<int64_t>(q) * budget;
  const int total = compact_run<kCovers>(win[q], max(b.x, 0), min(b.y, n), lmbr,
                                         rmbr, out, budget, warp_sums);
  for (int j = min(total, budget) + threadIdx.x; j < budget; j += kThreads) out[j] = -1;
  if (threadIdx.x == 0) counts[q] = total;
}

// ------------------------------------------------------------------ fused
struct FusedArgs {
  const float4* windows;  // (Q, 4) raw windows
  const float4* probe_w;  // (Q, 4) relation-padded probe windows
  const int4* qkeys;      // (Q, 4) [zmin_hi, zmin_lo, ub_hi, ub_lo]
  const int2* keys;       // (N, 2) slot key limbs
  const int* recs;        // (N,) record id of each slot
  const int* leaf_i;      // (L+1, 5) [start, dlo_hi, dlo_lo, k0_hi, k0_lo]
  const float* leaf_f;    // (L+1, 2) [slope, icpt]
  const int4* node_i;     // (M, 4) [dlo_hi, dlo_lo, fanout, child_base]
  const float* node_f;    // (M,) scale
  const int* codes;       // (C,) child codes
  const int4* pw;         // (P, 4) [zmax_hi, zmax_lo, sufmin_hi, sufmin_lo]
  const int4* pod_i;      // (R, 4) [off, nv, kind, bucket]
  const float* pool;      // (V, 2) vertex pods
  const float4* lmbr;     // (N, 4) slot-aligned leaf MBRs
  const float4* rmbr;     // (N, 4) slot-aligned record MBRs
  int* hits;              // (Q, budget)
  int* counts;            // (Q,)
  int n, num_leaves, num_pieces, aug_steps, pool_rows;
  int budget, covers_prefilter, code;
  float dist2;
  int augment, search_steps, depth;
};

// Suffix-min piecewise augmentation of the probe key (core.device._augment).
__device__ void augment_key(const FusedArgs& a, int& qh, int& ql) {
  const int p = a.num_pieces;
  int lo = 0, hi = p;
  for (int k = 0; k < a.aug_steps; ++k) {
    const int mid = (lo + hi) >> 1;
    const int4 e = a.pw[min(mid, p - 1)];  // the reference clamps gathers
    if (z_less(e.x, e.y, qh, ql)) lo = mid + 1; else hi = mid;
  }
  const bool in_range = lo < p;
  const int4 e = a.pw[min(lo, p - 1)];
  const int m_hi = in_range ? e.z : (1 << 30);
  const int m_lo = in_range ? e.w : 0;
  if (z_less(m_hi, m_lo, qh, ql)) {
    qh = m_hi;
    ql = m_lo;
  }
}

// Model traversal + the two-pass integer leaf fix-up (core.device._find_leaf).
__device__ int find_leaf(const FusedArgs& a, int qh, int ql) {
  int node = 0, leaf = 0;
  bool done = false;
  for (int d = 0; d < a.depth; ++d) {
    const int4 nd = a.node_i[node];
    const float dh = static_cast<float>(qh - nd.x);
    const float dl = static_cast<float>(ql - nd.y);
    const float key_f = dh * 1073741824.0f + dl;
    const float cell_f = fminf(fmaxf(floorf(key_f * a.node_f[node]), 0.0f),
                               static_cast<float>(nd.z - 1));
    const int code = a.codes[nd.w + static_cast<int>(cell_f)];
    const bool is_leaf = code < 0;
    if (is_leaf && !done) leaf = -code - 1;
    if (!(is_leaf || done)) node = code;
    done = done || is_leaf;
  }
  for (int k = 0; k < 2; ++k) {
    const bool too_low = z_less(qh, ql, a.leaf_i[5 * leaf + 1], a.leaf_i[5 * leaf + 2]);
    leaf = max(leaf - static_cast<int>(too_low), 0);
    const bool too_high = !z_less(qh, ql, a.leaf_i[5 * (leaf + 1) + 1],
                                  a.leaf_i[5 * (leaf + 1) + 2]);
    leaf = min(leaf + static_cast<int>(too_high), a.num_leaves - 1);
  }
  return leaf;
}

// lower_bound of the key: leaf model prediction, then a bounded binary
// search of search_steps + 2 trips (core.device.batch_probe).
__device__ int probe_key(const FusedArgs& a, int qh, int ql) {
  const int leaf = find_leaf(a, qh, ql);
  const int start = a.leaf_i[5 * leaf], size = a.leaf_i[5 * (leaf + 1)] - start;
  const float key_f = static_cast<float>(qh - a.leaf_i[5 * leaf + 3]) * 1073741824.0f +
                      static_cast<float>(ql - a.leaf_i[5 * leaf + 4]);
  float pf = rintf(a.leaf_f[2 * leaf] * key_f + a.leaf_f[2 * leaf + 1]);
  // saturate in fp32 before the cast (fmaxf maps NaN to the lower bound,
  // which the clip below sends to 0, as the reference's cast does)
  pf = fminf(fmaxf(pf, -2147483648.0f), 2147483520.0f);
  const int pred = min(max(static_cast<int>(pf), 0), max(size - 1, 0));
  const int err = (1 << a.search_steps) / 2 + 2;
  int lo = max(pred - err, 0) + start;
  int hi = min(pred + err, size) + start;
  for (int k = 0; k < a.search_steps + 2 && lo < hi; ++k) {
    const int mid = (lo + hi) >> 1;
    const int2 key = a.keys[mid];
    if (z_less(key.x, key.y, qh, ql)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) fused_kernel(const FusedArgs a) {
  __shared__ int surv[kMaxBudget];
  __shared__ int warp_sums[kWarps + 1];
  __shared__ int run[2];
  const int q = blockIdx.x;

  // (a) probe: thread 0 finds start (augmented zmin), thread 1 end (ub)
  if (threadIdx.x < 2) {
    const int4 k = a.qkeys[q];
    int qh = threadIdx.x == 0 ? k.x : k.z;
    int ql = threadIdx.x == 0 ? k.y : k.w;
    if (threadIdx.x == 0 && a.augment) augment_key(a, qh, ql);
    run[threadIdx.x] = probe_key(a, qh, ql);
  }
  __syncthreads();

  // (b) filter + compact the run into the shared survivor list
  const float4 pw = a.probe_w[q];
  const int lo = max(run[0], 0), hi = min(run[1], a.n);
  const int total =
      a.covers_prefilter
          ? compact_run<true>(pw, lo, hi, a.lmbr, a.rmbr, surv, a.budget, warp_sums)
          : compact_run<false>(pw, lo, hi, a.lmbr, a.rmbr, surv, a.budget, warp_sums);
  __syncthreads();

  // (c) exact predicate over the survivors, column for column
  const int taken = min(total, a.budget);
  const float4 wv = a.windows[q];
  const glin::Rect r{wv.x, wv.y, wv.z, wv.w};
  int* out = a.hits + static_cast<int64_t>(q) * a.budget;
  int found = 0;
  for (int j = threadIdx.x; j < a.budget; j += kThreads) {
    int h = -1;
    if (j < taken) {
      const int rec = a.recs[surv[j]];
      const int4 hd = a.pod_i[rec];
      const glin::Ring g{a.pool, hd.x, hd.y, hd.z, a.pool_rows};
      if (glin::eval_predicate(a.code, r, g, a.dist2)) {
        h = rec;
        ++found;
      }
    }
    out[j] = h;
  }
  const int exact_hits = block_sum(found, warp_sums);
  if (threadIdx.x == 0) a.counts[q] = total > a.budget ? -total - 1 : exact_hits;
}

}  // namespace

extern "C" {

const char* glin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int glin_refine_count(const void* windows, const void* bounds, const void* mbrs,
                      void* out, int q, int n, void* stream) {
  count_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(windows), static_cast<const int2*>(bounds),
      static_cast<const float4*>(mbrs), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_mask(const void* windows, const void* bounds, const void* mbrs,
                     void* out, int q, int n, void* stream) {
  if (q < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, (q + kMaskRows - 1) / kMaskRows);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(windows), static_cast<const int2*>(bounds),
      static_cast<const float4*>(mbrs), static_cast<int8_t*>(out), q, n);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_compact(const void* windows, const void* bounds, const void* lmbr,
                        const void* rmbr, void* slots, void* counts, int q, int n,
                        int budget, int covers_prefilter, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float4*>(windows);
  auto b = static_cast<const int2*>(bounds);
  auto l = static_cast<const float4*>(lmbr);
  auto r = static_cast<const float4*>(rmbr);
  if (covers_prefilter)
    compact_kernel<true><<<q, kThreads, 0, s>>>(w, b, l, r, static_cast<int*>(slots),
                                                static_cast<int*>(counts), n, budget);
  else
    compact_kernel<false><<<q, kThreads, 0, s>>>(w, b, l, r, static_cast<int*>(slots),
                                                 static_cast<int*>(counts), n, budget);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_fused(const void* windows, const void* probe_w, const void* qkeys,
                      const void* keys, const void* recs, const void* leaf_i,
                      const void* leaf_f, const void* node_i, const void* node_f,
                      const void* codes, const void* pw, const void* pod_i,
                      const void* pool, const void* lmbr, const void* rmbr,
                      void* hits, void* counts, int q, int n, int num_leaves,
                      int num_pieces, int aug_steps, int pool_rows, int budget,
                      int covers_prefilter, int code, float dist2, int augment,
                      int search_steps, int depth, void* stream) {
  if (budget < 1 || budget > kMaxBudget) return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a;
  a.windows = static_cast<const float4*>(windows);
  a.probe_w = static_cast<const float4*>(probe_w);
  a.qkeys = static_cast<const int4*>(qkeys);
  a.keys = static_cast<const int2*>(keys);
  a.recs = static_cast<const int*>(recs);
  a.leaf_i = static_cast<const int*>(leaf_i);
  a.leaf_f = static_cast<const float*>(leaf_f);
  a.node_i = static_cast<const int4*>(node_i);
  a.node_f = static_cast<const float*>(node_f);
  a.codes = static_cast<const int*>(codes);
  a.pw = static_cast<const int4*>(pw);
  a.pod_i = static_cast<const int4*>(pod_i);
  a.pool = static_cast<const float*>(pool);
  a.lmbr = static_cast<const float4*>(lmbr);
  a.rmbr = static_cast<const float4*>(rmbr);
  a.hits = static_cast<int*>(hits);
  a.counts = static_cast<int*>(counts);
  a.n = n;
  a.num_leaves = num_leaves;
  a.num_pieces = num_pieces;
  a.aug_steps = aug_steps;
  a.pool_rows = pool_rows;
  a.budget = budget;
  a.covers_prefilter = covers_prefilter;
  a.code = code;
  a.dist2 = dist2;
  a.augment = augment;
  a.search_steps = search_steps;
  a.depth = depth;
  fused_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
