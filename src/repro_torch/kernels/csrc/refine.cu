// GLIN refine kernels for Hopper (sm_90a): count, compact, fused and mask.
//
// compact_kernel replaces refine_compact_pallas and fused_kernel replaces
// refine_fused_pallas (repro/kernels/refine.py); count_kernel and mask_kernel
// replace refine_count_pallas and refine_mask_pallas. The TPU kernels sweep
// the WHOLE slot table for every query tile, mask the slots outside the
// query's run and place survivors by a one-hot (rows, slots, budget) scatter:
// a TPU has neither a cheap data-dependent loop nor a scatter.
//
// Count, compact and fused are one thread block per query, walking the
// query's slot run [start, end) of the Z-sorted record table group -> leaf
// -> slot (walk_run below). A run averages ~23,000 leaves of ~18 slots at
// the main path's selectivity, and most of them miss the window: the walk
// tests the group rows (32 leaves each) of the run, then the leaves of the
// groups that meet, then the record MBRs of the run slots inside the leaves
// that meet.
// What bounds it: latency, one block barrier chain per 256 groups, per 8
// meeting groups and per 256 slots tested; its bytes are those rows only.
// The survivor set, its ascending slot order, the total and the overflow
// code equal a per-slot pass over the run (the reference's in-run test
// zeroes every slot outside it). The compact kernel writes survivors
// straight to device memory, so its budget has no bound of its own; the
// fused kernel keeps them in shared memory (kMaxBudget) and then runs the
// exact predicate over the survivors' vertex pods, ordered by pod width:
// narrow pods one a thread, wide ones one a warp (geometry.cuh's warp_*
// forms), so no warp waits on one lane's 64-vertex loop.
//
// Count walks each run as compact does and keeps only the total (no
// survivor list): its bytes are the walk's rows, not every run slot. The
// per-slot definition it must equal tests record MBRs alone, with no leaf
// test, so skipping a leaf whose MBR misses is exact only because every
// real slot's record MBR lies inside its leaf's MBR, as a snapshot builds
// them (count_kernel states the condition).
//
// The mask kernel writes the whole (Q, N) int8 mask, as refine_mask_pallas
// did: it is bound by those Q * N output bytes, written 16 a thread and row
// in one streaming store, with rows whose run misses a thread's slots
// written as zeros untested.
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
constexpr int kBins = 64;         // (pod width bucket, kind) keys of the exact stage
constexpr int kWideBucket = 4;    // pods of 16+ vertices: one warp a survivor

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

// ------------------------------------------------------------------ mask
// The (Q, N) int8 candidate mask: slot in [start, end) AND record MBR meets
// the window. A block holds a tile of kMaskTile slots and kMaskRows query
// rows. Its threads stage the tile's record MBRs (and the kMaskSlots before
// it) through shared memory with coalesced loads, each row read once per
// block, then each thread takes kMaskSlots consecutive slots into
// registers and, for every row, writes their kMaskSlots bytes in one
// 16-byte streaming store: a warp fills four whole 128-byte lines. A row
// whose run misses the thread's slots writes zeros untested. A row whose
// base is not 16-byte aligned (n not a multiple of 16) shifts every store
// d bytes down to an aligned address: the previous thread's last d bytes
// (a shuffle; for lane 0 a ballot of the warp's tests of those slots) with
// its own first 16 - d. Only the row's first thread (its first 16 - d
// bytes) and the last lane before the row's end (its last d) write byte by
// byte, as does every lane of a warp that holds the row's last slot.
constexpr int kMaskThreads = 128;
constexpr int kMaskSlots = 16;                            // slots a thread
constexpr int kMaskTile = kMaskThreads * kMaskSlots;      // 2048: 32 KB of MBRs
constexpr int kMaskRows = 64;                             // query rows a block

// Shared slot of staged element e (slot t0 - kMaskSlots + e): thread t
// reads elements 16 (t + 1) .. 16 (t + 1) + 15, so without the swizzle the
// eight threads of a 16-byte access phase would all hit the same bank group.
__device__ inline int mask_swizzle(int e) { return e ^ ((e >> 4) & 7); }

__device__ inline int8_t mask_byte(const uint32_t (&v)[4], int i) {
  return static_cast<int8_t>((v[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

// The 16 bytes that start d (1..15) bytes before this lane's first slot:
// the previous lane's last d bytes, then this lane's first 16 - d. As the
// 256-bit little-endian (cur:prev), shifted right by 128 - 8 d bits.
__device__ inline int4 straddle(const uint32_t (&prev)[4], const uint32_t (&cur)[4],
                                int d) {
  const uint32_t w[8] = {prev[0], prev[1], prev[2], prev[3],
                         cur[0],  cur[1],  cur[2],  cur[3]};
  const int bits = 128 - 8 * d, k = bits >> 5, r = bits & 31;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t lo = w[j], hi = w[j + 1];  // w[j + k], w[j + k + 1] by selects
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (k == c) {
        lo = w[j + c];
        hi = w[j + c + 1];
      }
    o[j] = __funnelshift_r(lo, hi, r);
  }
  return make_int4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kMaskThreads)
mask_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
            const float4* __restrict__ mbrs, int8_t* __restrict__ out, int q, int n) {
  __shared__ float4 tile[kMaskTile + kMaskSlots];
  __shared__ float4 sw[kMaskRows];
  __shared__ int2 sb[kMaskRows];
  const int r0 = blockIdx.x * kMaskRows, rows = min(kMaskRows, q - r0);
  const int t0 = blockIdx.y * kMaskTile;
  if (threadIdx.x < rows) {
    sw[threadIdx.x] = win[r0 + threadIdx.x];
    const int2 b = bounds[r0 + threadIdx.x];
    sb[threadIdx.x] = make_int2(max(b.x, 0), min(b.y, n));  // runs clipped to [0, n)
  }
  for (int e = threadIdx.x; e < kMaskTile + kMaskSlots; e += kMaskThreads) {
    const int s = t0 - kMaskSlots + e;
    if (s >= 0 && s < n) tile[mask_swizzle(e)] = mbrs[s];
  }
  __syncthreads();
  // no early exit past n: every lane meets the shuffles below
  const int lane = threadIdx.x & 31;
  const int s0 = t0 + threadIdx.x * kMaskSlots;
  const int cnt = max(0, min(kMaskSlots, n - s0));
  // whether every lane of this warp (of the next warp) holds kMaskSlots
  // slots below n, by arithmetic: warp-uniform without a vote
  const int warp_end = t0 + ((static_cast<int>(threadIdx.x) | 31) + 1) * kMaskSlots;
  const bool full = warp_end <= n;
  const bool next_full = warp_end + 32 * kMaskSlots <= n;
  float4 m[kMaskSlots];
#pragma unroll
  for (int i = 0; i < kMaskSlots; ++i)
    m[i] = tile[mask_swizzle((threadIdx.x + 1) * kMaskSlots + i)];  // past n: never kept
  for (int r = 0; r < rows; ++r) {
    const int2 b = sb[r];
    const float4 w = sw[r];
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (b.x < s0 + cnt && s0 < b.y) {
#pragma unroll
      for (int i = 0; i < kMaskSlots; ++i) {  // slot s0 + i is byte i of the store
        const int s = s0 + i;
        const bool keep = s >= b.x && s < b.y && mbr_meets(m[i], w);
        v[i >> 2] |= static_cast<uint32_t>(keep) << (8 * (i & 3));
      }
    }
    int8_t* p = out + static_cast<int64_t>(r0 + r) * n + s0;
    const int d = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);  // one per row
    if (full && d == 0) {
      __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
      continue;
    }
    if (!full) {
#pragma unroll
      for (int i = 0; i < kMaskSlots; ++i)
        if (i < cnt) p[i] = mask_byte(v, i);
      continue;
    }
    uint32_t prev[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) prev[k] = __shfl_up_sync(0xffffffffu, v[k], 1);
    // lane 0's previous thread sits in another warp (or tile): the warp
    // tests those 16 staged slots a lane each and takes their ballot
    const int wbase = s0 - lane * kMaskSlots;  // the warp's first slot
    const int sp = wbase - kMaskSlots + lane;
    const bool kept = lane < kMaskSlots && sp >= b.x && sp < b.y &&
                      mbr_meets(tile[mask_swizzle(sp - t0 + kMaskSlots)], w);
    const uint32_t bits = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t x = bits >> (4 * k);  // slots 4 k .. 4 k + 3 as bytes
        prev[k] = (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
      }
    }
    if (s0 > 0) __stcs(reinterpret_cast<int4*>(p - d), straddle(prev, v, d));
    const bool head = s0 == 0, tail = lane == 31 && !next_full;
#pragma unroll
    for (int i = 0; i < kMaskSlots; ++i)
      if (head ? i < kMaskSlots - d : tail && i >= kMaskSlots - d) p[i] = mask_byte(v, i);
  }
}

// ------------------------------------------------------------------ walk
// A query's slot run [lo, hi) is walked leaf first: slot_lmbr[s] is
// leaf_mbr[rec_leaf[s]] by construction (core.device.snapshot_from_capture),
// so a leaf whose MBR misses the probe window has no survivor in any of its
// slots, and a group of kGroup leaves whose MBR union misses holds no leaf
// that meets. Three levels, each in thread order, so the survivors come out
// in ascending slot order at the running offset, as a per-slot pass would
// place them:
//   groups  - one per thread, 256 at a time: the group rows of the run;
//   leaves  - a warp per meeting group, a lane per leaf: in the run, holding
//             slots of the run (clipped to [lo, hi)), MBR meets the window;
//   slots   - the meeting leaves' run slots, flattened by an exclusive sum of
//             their sizes and tested 256 at a time against the record MBR.
// Slot-as-leaf mode (kSlotLeaf: the compact and count kernels under the
// kernel-level entry point, which has only slot-aligned tables) takes leaf
// l = slot l and leaf_mbr = a slot-aligned MBR table (compact: the leaf
// MBRs; count: the record MBRs), with the group rows over 32 slots each.
constexpr int kGroup = 32;  // leaves per group row: the warp width

struct Walk {
  const int* rec_leaf;      // (N,) leaf of each slot (unread in slot mode)
  const int* leaf_start;    // (L+1,) slot offsets (unread in slot mode)
  const float4* leaf_mbr;   // (L, 4) leaf MBRs (slot mode: (N, 4))
  const float4* group_mbr;  // (ceil(L / kGroup), 4) unions of kGroup leaves
  const float4* rmbr;       // (N, 4) record MBRs
  int num_leaves;           // L (slot mode: N)
};

struct WalkSmem {
  int groups[kThreads];      // meeting groups of one 256-group chunk
  int first[kThreads];       // per thread of a leaf chunk: its leaf's first run slot
  int offset[kThreads];      // exclusive prefix of the leaves' run slots
  int warp_sums[kWarps + 1];
};

// Exclusive prefix of `v` over the block in thread order; `total` gets the
// block's sum. Every thread of the block must call it.
__device__ inline int block_exclusive_sum(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
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
  const int pos = warp_sums[warp] + inc - v;
  total = warp_sums[kWarps];
  __syncthreads();
  return pos;
}

// Survivors of the run [lo, hi) (leaf MBR meets the probe window, record MBR
// meets or covers it) go to column = running count, written only below the
// budget; returns the TOTAL, which may exceed it.
template <bool kCovers, bool kSlotLeaf>
__device__ int walk_run(const float4 w, int lo, int hi, const Walk& t, int* out,
                        int budget, WalkSmem& sm) {
  if (lo >= hi || t.num_leaves < 1) return 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l0 = max(kSlotLeaf ? lo : t.rec_leaf[lo], 0);
  const int l1 = min(kSlotLeaf ? hi - 1 : t.rec_leaf[hi - 1], t.num_leaves - 1);
  const int g1 = l1 / kGroup;
  int running = 0;
  for (int gb = l0 / kGroup; gb <= g1; gb += kThreads) {
    // groups: exact fp32 min/max unions, so a miss rules out every leaf
    const int g = gb + threadIdx.x;
    const bool gm = g <= g1 && mbr_meets(t.group_mbr[g], w);
    int ng;
    const int gpos = block_exclusive_scan(gm, sm.warp_sums, ng);
    if (gm) sm.groups[gpos] = g;
    __syncthreads();
    for (int gc = 0; gc < ng; gc += kWarps) {
      // leaves: the same test as the per-slot pass's on slot_lmbr; an empty
      // leaf (or one the run's bounds clip to nothing) never counts, whatever
      // its MBR row holds
      int a = 0, size = 0;
      if (gc + warp < ng) {
        const int l = sm.groups[gc + warp] * kGroup + lane;
        if (l >= l0 && l <= l1) {
          const float4 m = t.leaf_mbr[l];
          a = max(kSlotLeaf ? l : t.leaf_start[l], lo);
          const int b = min(kSlotLeaf ? l + 1 : t.leaf_start[l + 1], hi);
          if (a < b && mbr_meets(m, w)) size = b - a;
        }
      }
      int ns;
      const int off = block_exclusive_sum(size, sm.warp_sums, ns);
      sm.first[threadIdx.x] = a;
      sm.offset[threadIdx.x] = off;
      __syncthreads();
      // slots: flattened index j lies in the leaf of the last thread whose
      // offset is <= j (threads without a meeting leaf add 0 and never win)
      for (int j0 = 0; j0 < ns; j0 += kThreads) {
        const int j = j0 + threadIdx.x;
        bool keep = false;
        int s = 0;
        if (j < ns) {
          int k = 0;
#pragma unroll
          for (int step = kThreads / 2; step > 0; step >>= 1)
            if (sm.offset[k + step] <= j) k += step;
          s = sm.first[k] + (j - sm.offset[k]);
          const float4 r = t.rmbr[s];
          keep = kCovers ? mbr_covers(r, w) : mbr_meets(r, w);
        }
        int total;
        const int pos = running + block_exclusive_scan(keep, sm.warp_sums, total);
        if (keep && pos < budget) out[pos] = s;
        running += total;
      }
    }
  }
  return running;
}

// ------------------------------------------------------------------ compact
template <bool kCovers, bool kSlotLeaf>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
               const Walk t, int* __restrict__ slots, int* __restrict__ counts,
               int n, int budget) {
  __shared__ WalkSmem sm;
  const int q = blockIdx.x;
  const int2 b = bounds[q];
  int* out = slots + static_cast<int64_t>(q) * budget;
  const int total = walk_run<kCovers, kSlotLeaf>(win[q], max(b.x, 0), min(b.y, n),
                                                 t, out, budget, sm);
  for (int j = min(total, budget) + threadIdx.x; j < budget; j += kThreads) out[j] = -1;
  if (threadIdx.x == 0) counts[q] = total;
}

// ------------------------------------------------------------------ count
// The walk with no survivor list (out unread at budget 0): the total only,
// which equals the per-slot count of record MBRs meeting the window when
// every real slot's record MBR lies inside leaf_mbr[rec_leaf[s]] (true of a
// snapshot: leaf MBRs are unions of their records' fp64 MBRs, and rounding
// to fp32 keeps containment) and no padding slot (past leaf_start[L]) of a
// run meets its window (a snapshot pads with far-away MBRs). In
// slot-as-leaf mode the leaf rows ARE the record MBRs, so no such condition
// is needed.
template <bool kSlotLeaf>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float4* __restrict__ win, const int2* __restrict__ bounds,
             const Walk t, int* __restrict__ counts, int n) {
  __shared__ WalkSmem sm;
  const int q = blockIdx.x;
  const int2 b = bounds[q];
  const int total = walk_run<false, kSlotLeaf>(win[q], max(b.x, 0), min(b.y, n), t,
                                               nullptr, 0, sm);
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
  Walk walk;              // the leaf tables of the walk
  int* hits;              // (Q, budget)
  int* counts;            // (Q,)
  int n, num_leaves, num_pieces, aug_steps, pool_rows;
  int budget, code;
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

template <bool kCovers>
__global__ void __launch_bounds__(kThreads) fused_kernel(const FusedArgs a) {
  __shared__ int surv[kMaxBudget];
  __shared__ WalkSmem sm;
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

  // (b) walk the run into the shared survivor list
  const int lo = max(run[0], 0), hi = min(run[1], a.n);
  const int total =
      walk_run<kCovers, false>(a.probe_w[q], lo, hi, a.walk, surv, a.budget, sm);
  __syncthreads();

  // (c) exact predicate over the survivors, column for column. The
  // survivors are first ordered by (pod width bucket, kind), so a warp's
  // lanes take rings of one width and kind: narrow ones (under
  // 1 << kWideBucket vertices) one a thread, wide ones one a warp, the
  // lanes splitting its vertices. Each verdict lands in its own column.
  const int taken = min(total, a.budget);
  const float4 wv = a.windows[q];
  const glin::Rect r{wv.x, wv.y, wv.z, wv.w};
  int* out = a.hits + static_cast<int64_t>(q) * a.budget;
  __shared__ int keys[kMaxBudget];
  __shared__ int order[kMaxBudget];
  __shared__ int bins[kBins];
  __shared__ int narrow;
  for (int i = threadIdx.x; i < kBins; i += kThreads) bins[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < taken; j += kThreads) {
    const int rec = a.recs[surv[j]];
    const int4 hd = a.pod_i[rec];
    surv[j] = rec;
    keys[j] = min(max(hd.w, 0), kBins / 2 - 1) * 2 + (hd.z & 1);
    atomicAdd(&bins[keys[j]], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < kBins; ++i) {
      if (i == 2 * kWideBucket) narrow = acc;
      const int c = bins[i];
      bins[i] = acc;
      acc += c;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < taken; j += kThreads)
    order[atomicAdd(&bins[keys[j]], 1)] = j;
  __syncthreads();
  int found = 0;
  for (int t = threadIdx.x; t < narrow; t += kThreads) {
    const int j = order[t], rec = surv[j];
    const int4 hd = a.pod_i[rec];
    const glin::Ring g{a.pool, hd.x, hd.y, hd.z, a.pool_rows};
    const bool ok = glin::eval_predicate(a.code, r, g, a.dist2);
    out[j] = ok ? rec : -1;
    found += ok;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = narrow + warp; t < taken; t += kWarps) {
    const int j = order[t], rec = surv[j];
    const int4 hd = a.pod_i[rec];
    const glin::Ring g{a.pool, hd.x, hd.y, hd.z, a.pool_rows};
    const bool ok = glin::warp_eval_predicate(a.code, r, g, a.dist2);
    if (lane == 0) {
      out[j] = ok ? rec : -1;
      found += ok;
    }
  }
  for (int j = taken + threadIdx.x; j < a.budget; j += kThreads) out[j] = -1;
  const int exact_hits = block_sum(found, sm.warp_sums);
  if (threadIdx.x == 0) a.counts[q] = total > a.budget ? -total - 1 : exact_hits;
}

}  // namespace

extern "C" {

const char* glin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int glin_refine_count(const void* windows, const void* bounds, const void* rec_leaf,
                      const void* leaf_start, const void* leaf_mbr, const void* group_mbr,
                      const void* rmbr, void* counts, int q, int n, int num_leaves,
                      int slot_leaf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float4*>(windows);
  auto b = static_cast<const int2*>(bounds);
  const Walk t{static_cast<const int*>(rec_leaf), static_cast<const int*>(leaf_start),
               static_cast<const float4*>(leaf_mbr),
               static_cast<const float4*>(group_mbr), static_cast<const float4*>(rmbr),
               num_leaves};
  auto c = static_cast<int*>(counts);
  if (slot_leaf)
    count_kernel<true><<<q, kThreads, 0, s>>>(w, b, t, c, n);
  else
    count_kernel<false><<<q, kThreads, 0, s>>>(w, b, t, c, n);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_mask(const void* windows, const void* bounds, const void* mbrs,
                     void* out, int q, int n, void* stream) {
  if (q < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // row chunks along x, so the blocks that share a tile run together and
  // read its MBRs from L2 after the first
  const dim3 grid((q + kMaskRows - 1) / kMaskRows, (n + kMaskTile - 1) / kMaskTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  mask_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(windows), static_cast<const int2*>(bounds),
      static_cast<const float4*>(mbrs), static_cast<int8_t*>(out), q, n);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_compact(const void* windows, const void* bounds, const void* rec_leaf,
                        const void* leaf_start, const void* leaf_mbr,
                        const void* group_mbr, const void* rmbr, void* slots,
                        void* counts, int q, int n, int num_leaves, int budget,
                        int covers_prefilter, int slot_leaf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float4*>(windows);
  auto b = static_cast<const int2*>(bounds);
  const Walk t{static_cast<const int*>(rec_leaf), static_cast<const int*>(leaf_start),
               static_cast<const float4*>(leaf_mbr),
               static_cast<const float4*>(group_mbr), static_cast<const float4*>(rmbr),
               num_leaves};
  auto o = static_cast<int*>(slots);
  auto c = static_cast<int*>(counts);
  if (covers_prefilter && slot_leaf)
    compact_kernel<true, true><<<q, kThreads, 0, s>>>(w, b, t, o, c, n, budget);
  else if (covers_prefilter)
    compact_kernel<true, false><<<q, kThreads, 0, s>>>(w, b, t, o, c, n, budget);
  else if (slot_leaf)
    compact_kernel<false, true><<<q, kThreads, 0, s>>>(w, b, t, o, c, n, budget);
  else
    compact_kernel<false, false><<<q, kThreads, 0, s>>>(w, b, t, o, c, n, budget);
  return static_cast<int>(cudaGetLastError());
}

int glin_refine_fused(const void* windows, const void* probe_w, const void* qkeys,
                      const void* keys, const void* recs, const void* leaf_i,
                      const void* leaf_f, const void* node_i, const void* node_f,
                      const void* codes, const void* pw, const void* pod_i,
                      const void* pool, const void* rec_leaf, const void* leaf_start,
                      const void* leaf_mbr, const void* group_mbr, const void* rmbr,
                      void* hits, void* counts, int q, int n, int num_leaves,
                      int num_pieces, int aug_steps, int pool_rows, int budget,
                      int covers_prefilter, int code, float dist2, int augment,
                      int search_steps, int depth, int walk_leaves, void* stream) {
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
  a.walk = Walk{static_cast<const int*>(rec_leaf), static_cast<const int*>(leaf_start),
                static_cast<const float4*>(leaf_mbr),
                static_cast<const float4*>(group_mbr), static_cast<const float4*>(rmbr),
                walk_leaves};
  a.hits = static_cast<int*>(hits);
  a.counts = static_cast<int*>(counts);
  a.n = n;
  a.num_leaves = num_leaves;
  a.num_pieces = num_pieces;
  a.aug_steps = aug_steps;
  a.pool_rows = pool_rows;
  a.budget = budget;
  a.code = code;
  a.dist2 = dist2;
  a.augment = augment;
  a.search_steps = search_steps;
  a.depth = depth;
  auto s = static_cast<cudaStream_t>(stream);
  if (covers_prefilter)
    fused_kernel<true><<<q, kThreads, 0, s>>>(a);
  else
    fused_kernel<false><<<q, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
