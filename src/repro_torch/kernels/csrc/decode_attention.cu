// One-token decode attention over a ring KV cache for Hopper (sm_90a).
//
// Replaces decode_attention_pallas (repro/kernels/decode_attention.py). Same
// function: q (B, Hq, D) — one query token per batch row — against k/v
// (B, Hkv, W, D) ring slots whose absolute positions abs_pos (B, W) say which
// are live: a slot counts where 0 <= abs_pos <= pos[b] and, with a window,
// pos[b] - abs_pos < window; every other slot takes the score -1e30 (so a
// row with no live slot averages all W values, as the reference does).
// Scores (q . k) * scale, fp32 softmax, denominator clamped at 1e-30, output
// in q's dtype. k/v are read through their element strides, so the model's
// (B, W, Hkv, D) cache goes in as a transposed view, without a copy.
//
// Bound on this card: bytes — the live slots' K and V (15.2 MB a layer at
// 8 rows x 8 kv heads x 7,438 live of 8,192 slots x 64 x bf16, ~4.5 us at
// 3.35 TB/s). Two things keep a kernel from it: too few blocks (one per
// (kv head, row) is 64 at 8 rows, on 132 SMs) and too few bytes in flight
// per SM. So the W slots of each (row, kv head) are split over `split`
// blocks (grid (split, Hkv, B); the wrapper doubles the split until there
// is a block for every SM: 4 at 8 rows, 256 blocks). A block first reads
// its run's abs_pos at once and compacts the live slots' offsets in shared
// memory (a block prefix sum), then streams only those through a
// two-stage ring with cp.async (16 KB of K and V a stage, so a block keeps
// up to 32 KB in flight without spending registers): a dead slot's weight
// exp(-1e30 - m) is exactly 0 in fp32, so skipping it changes nothing. The
// group's query heads, four at a time, sit in registers; a slot's D
// elements are split over a few lanes (16 bytes each), which form the
// slot's dot products and reduce them with shuffles, four slots at a time,
// and fold them into their running max / denominator / accumulator with
// one rescale. The block merges its threads' states (shuffles in a warp,
// then shared memory) into one partial (m, l, acc[D]) per head and writes
// it, with a flag saying whether it saw a live slot, to a scratch tensor;
// the last block of the row to finish (a counter per (row, kv head),
// __threadfence before the atomicAdd) rescales every partial by
// exp(m_i - m) and writes the output, and sets the counter back to 0 for
// the next launch: one launch. Where asked, that block also writes each
// head's log-sum-exp over the live slots (m + log l of the merged state; -inf
// in a row with no live slot), so that partial softmaxes over disjoint slot
// ranges merge (the sharded decode's slots over the model axis). A row with
// no live slot at all (every flag 0) averages all W values, as the
// reference's softmax of equal -1e30 scores does. Any W, also W < split (a
// block with no slot leaves an empty partial). At most 128 registers a
// thread keep four blocks an SM.
//
// A thread block cluster merging the partials through distributed shared
// memory was tried first and was slower at the serving shape on an H100:
// the cluster launch, its two cluster barriers and the remote reads cost
// more than the scratch round trip, and at split 8 the card could not hold
// all 64 clusters of 8 at once, so the grid ran in two waves.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include <math_constants.h>

#include "attention_io.cuh"

namespace {

using attn_io::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;             // query heads per pass
constexpr int kSteps = 4;             // slots a group takes per step
constexpr int kRun = 1024;            // slots of a run compacted at a time
constexpr int kStageBytes = 16384;    // K and V of one stage of slots
constexpr int kMaxSplit = 8;          // blocks that share a row's slots, at most

template <typename T, int D>
struct Layout {
  static constexpr int V = attn_io::kVec<T>;           // elements per 16-byte copy
  static constexpr int E = D / 32 > V ? D / 32 : V;    // elements per lane
  static constexpr int LPS = D / E;                    // lanes per slot
  static constexpr int NG = kThreads / LPS;            // slot groups
  static constexpr int CH = kStageBytes / (2 * D * static_cast<int>(sizeof(T)));  // slots a stage
  static constexpr int CPR = D / V;                    // 16-byte pieces of a row
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "unsupported head dim");
  static_assert(kWarps * kHeads * (D + 2) * 4 <= 2 * kStageBytes, "merge scratch > ring");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 4)  // four blocks an SM
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ abs_pos, const int* __restrict__ pos,
                    T* __restrict__ out, float* __restrict__ part, int* __restrict__ done,
                    float* __restrict__ lse, int group, int w, int window, float scale, int64_t sqb, int64_t sqh,
                    int64_t skb, int64_t skh, int64_t skw, int64_t sab) {
  using L = Layout<T, D>;
  constexpr int E = L::E, LPS = L::LPS, NG = L::NG, V = L::V, CH = L::CH, CPR = L::CPR;
  // the ring of two stages; after the slots, the warps' merge scratch
  __shared__ __align__(16) unsigned char s_ring[2 * kStageBytes];
  __shared__ short s_idx[kRun];  // live slots of the run's chunk (offsets)
  __shared__ int s_warp[kWarps], s_last;

  const int split = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y, row = b * gridDim.y + kvh;
  const int sub = lane % LPS, grp = tid / LPS, d0 = sub * E;
  const unsigned gmask = LPS == 32 ? 0xffffffffu : ((1u << LPS) - 1u) << (lane / LPS * LPS);
  const int p = pos[b];
  const int* ap = abs_pos + b * sab;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * skb + kvh * skh;
  const int h0 = kvh * group;
  const int lo = static_cast<int>(static_cast<int64_t>(rank) * w / split);
  const int hi = static_cast<int>(static_cast<int64_t>(rank + 1) * w / split);
  // this (row, kv head)'s partials: per block, per head (acc[D], m, l),
  // then the block's live flag
  const int64_t pstride = static_cast<int64_t>(group) * (D + 2) + 1;
  float* prow = part + static_cast<int64_t>(row) * split * pstride;
  auto live_at = [&](int a) { return a >= 0 && a <= p && (window <= 0 || p - a < window); };
  auto stage_k = [&](int st) { return reinterpret_cast<T*>(s_ring + st * kStageBytes); };

  // the live slots of [cbase, cbase + cn), cn <= kRun, in order: their
  // offsets from cbase into s_idx (abs_pos read once, all at a time; a
  // block prefix sum over the threads' counts); returns how many
  auto compact = [&](int cbase, int cn) {
    constexpr int PER = kRun / kThreads;
    const int i0 = tid * PER;
    bool f[PER];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      f[i] = i0 + i < cn && live_at(__ldg(ap + cbase + i0 + i));
      cnt += f[i];
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int at = incl - cnt, total = 0;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      at += x < warp ? s_warp[x] : 0;
      total += s_warp[x];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (f[i]) s_idx[at++] = static_cast<short>(i0 + i);
    __syncthreads();
    return total;
  };
  // copy live slots [sb, sb + CH) of the compacted run into a stage: a
  // thread takes one 16-byte piece of NPT slots
  constexpr int SPI = kThreads / CPR, NPT = (CH + SPI - 1) / SPI;
  const int j0 = tid / CPR, c0 = (tid % CPR) * V;
  auto copy_stage = [&](int st, int cbase, int sb, int nl) {
    T* dk = stage_k(st);
    T* dv = dk + CH * D;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int j = j0 + i * SPI;
      if (j < CH && sb + j < nl) {
        const int64_t off = (cbase + s_idx[sb + j]) * skw + c0;
        attn_io::cp_async16(dk + j * D + c0, kb + off);
        attn_io::cp_async16(dv + j * D + c0, vb + off);
      }
    }
  };

  const bool one_chunk = hi - lo <= kRun;
  int nl = one_chunk ? compact(lo, hi - lo) : 0;
  bool seen = nl > 0;  // a live slot in this block's run
  for (int g0 = 0; g0 < group; g0 += kHeads) {
    float qr[kHeads][E];
#pragma unroll
    for (int c = 0; c < kHeads; ++c) {
      if (g0 + c < group) {
#pragma unroll
        for (int e = 0; e < E; e += V) attn_io::load16(q + b * sqb + (h0 + g0 + c) * sqh + d0 + e, qr[c] + e);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qr[c][e] = 0.f;
      }
    }
    float m[kHeads], l[kHeads], acc[kHeads][E];
#pragma unroll
    for (int c = 0; c < kHeads; ++c) {
      m[c] = kNegInf;
      l[c] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[c][e] = 0.f;
    }
    for (int cbase = lo; cbase < hi; cbase += kRun) {
      if (!one_chunk) {
        nl = compact(cbase, min(kRun, hi - cbase));
        seen |= nl > 0;
      }
      if (nl > 0) copy_stage(0, cbase, 0, nl);
      attn_io::cp_async_commit();
      for (int sb = 0, st = 0; sb < nl; sb += CH, st ^= 1) {
        if (sb + CH < nl) copy_stage(st ^ 1, cbase, sb + CH, nl);
        attn_io::cp_async_commit();
        attn_io::cp_async_wait<1>();
        __syncthreads();
        const T* sk = stage_k(st);
        const T* sv = sk + CH * D;
        const int n = min(CH, nl - sb);
        // kSteps slots a step, NG apart: their dot products and shuffles
        // interleave, and one softmax update takes all of them
        for (int js = grp; js < n; js += NG * kSteps) {  // a slot's lanes agree on every branch
          bool ok[kSteps];
#pragma unroll
          for (int i = 0; i < kSteps; ++i) ok[i] = js + i * NG < n;
          float sc[kSteps][kHeads];
#pragma unroll
          for (int i = 0; i < kSteps; ++i) {
            float kf[E];
#pragma unroll
            for (int e = 0; e < E; e += V) {
              if (ok[i]) {
                attn_io::load16(sk + (js + i * NG) * D + d0 + e, kf + e);
              } else {
#pragma unroll
                for (int x = 0; x < V; ++x) kf[e + x] = 0.f;
              }
            }
#pragma unroll
            for (int c = 0; c < kHeads; ++c) {
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < E; ++e) dot = fmaf(qr[c][e], kf[e], dot);
              sc[i][c] = dot;
            }
          }
#pragma unroll
          for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
            for (int i = 0; i < kSteps; ++i)
#pragma unroll
              for (int c = 0; c < kHeads; ++c) sc[i][c] += __shfl_xor_sync(gmask, sc[i][c], off);
          // a step past the stage's slots weighs 0
#pragma unroll
          for (int c = 0; c < kHeads; ++c) {
            float m_new = m[c];
#pragma unroll
            for (int i = 0; i < kSteps; ++i) {
              sc[i][c] = ok[i] ? sc[i][c] * scale : -CUDART_INF_F;
              m_new = fmaxf(m_new, sc[i][c]);
            }
            const float alpha = expf(m[c] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < kSteps; ++i) {
              sc[i][c] = expf(sc[i][c] - m_new);
              sum += sc[i][c];
            }
            l[c] = l[c] * alpha + sum;
            m[c] = m_new;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[c][e] *= alpha;
          }
#pragma unroll
          for (int i = 0; i < kSteps; ++i) {
            if (!ok[i]) continue;
            float vf[E];
#pragma unroll
            for (int e = 0; e < E; e += V) attn_io::load16(sv + (js + i * NG) * D + d0 + e, vf + e);
#pragma unroll
            for (int c = 0; c < kHeads; ++c)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[c][e] = fmaf(sc[i][c], vf[e], acc[c][e]);
          }
        }
        __syncthreads();  // this stage's readers are done before it is refilled
      }
      attn_io::cp_async_wait<0>();
    }

    // merge the slot groups of a warp (lanes with the same d0) ...
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < kHeads; ++c) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[c], off);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[c], off);
        const float mm = fmaxf(m[c], mo);
        const float fa = expf(m[c] - mm), fb = expf(mo - mm);
        l[c] = l[c] * fa + lo_ * fb;
        m[c] = mm;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[c][e], off);
          acc[c][e] = acc[c][e] * fa + ao * fb;
        }
      }
    }
    // ... then the warps, through the ring's memory, into the block's
    // partial in device memory
    float* w_acc = reinterpret_cast<float*>(s_ring);  // [kWarps][kHeads][D]
    float* w_m = w_acc + kWarps * kHeads * D;         // [kWarps][kHeads]
    float* w_l = w_m + kWarps * kHeads;
    if (lane < LPS) {
#pragma unroll
      for (int c = 0; c < kHeads; ++c) {
        if (sub == 0) {
          w_m[warp * kHeads + c] = m[c];
          w_l[warp * kHeads + c] = l[c];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) w_acc[(warp * kHeads + c) * D + d0 + e] = acc[c][e];
      }
    }
    __syncthreads();
    float* pb = prow + rank * pstride;
    for (int i = tid; i < kHeads * D; i += kThreads) {
      const int c = i / D, d = i % D;
      if (g0 + c >= group) continue;
      float mm = kNegInf;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) mm = fmaxf(mm, w_m[x * kHeads + c]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        const float f = expf(w_m[x * kHeads + c] - mm);
        den += w_l[x * kHeads + c] * f;
        num += w_acc[(x * kHeads + c) * D + d] * f;
      }
      float* ph = pb + (g0 + c) * (D + 2);
      ph[d] = num;
      if (d == 0) {
        ph[D] = mm;
        ph[D + 1] = den;
      }
    }
    __syncthreads();  // the scratch is read before the next pass's copies
  }

  // the last block of the row to finish merges every block's partial
  if (tid == 0) prow[rank * pstride + pstride - 1] = seen ? 1.f : 0.f;
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done + row, 1) == split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) done[row] = 0;  // ready for the next launch
  // the blocks' live flags and partials are read together; the merged
  // output is written where some block saw a live slot
  float live = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r)
    if (r < split) live += __ldcg(prow + r * pstride + pstride - 1);
  T* ob = out + (static_cast<int64_t>(b) * gridDim.y * group + h0) * D;
  // the heads' log-sum-exp over the live slots, where it is asked for
  float* lb = lse == nullptr ? nullptr : lse + static_cast<int64_t>(b) * gridDim.y * group + h0;
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float pm[kMaxSplit], pl[kMaxSplit], pa[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      pm[r] = kNegInf;
      pl[r] = pa[r] = 0.f;
      if (r < split) {
        const float* ph = prow + r * pstride + g * (D + 2);
        pm[r] = __ldcg(ph + D);
        pl[r] = __ldcg(ph + D + 1);
        pa[r] = __ldcg(ph + d);
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) mm = fmaxf(mm, pm[r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const float f = expf(pm[r] - mm);
      den += pl[r] * f;
      num += pa[r] * f;
    }
    if (live > 0.f) {
      attn_io::store(ob + i, num / fmaxf(den, 1e-30f));
      if (lb != nullptr && d == 0) lb[g] = mm + logf(den);
    }
  }
  if (live > 0.f) return;
  if (lb != nullptr)
    for (int g = tid; g < group; g += kThreads) lb[g] = -CUDART_INF_F;
  // no live slot in the row: every slot scores -1e30, so every head
  // averages all W values (the reference's softmax of equal scores)
  float* w_sum = reinterpret_cast<float*>(s_ring);  // [ROWS_][D] partial sums
  constexpr int COLS = D < kThreads ? D : kThreads, ROWS_ = kThreads / COLS;
  for (int d = tid % COLS; d < D; d += COLS) {
    float sum = 0.f;
    for (int x = tid / COLS; x < w; x += ROWS_) {
      float f[V];
      const int dv0 = d / V * V;
      attn_io::load16(vb + x * skw + dv0, f);
      sum += f[d - dv0];
    }
    w_sum[(tid / COLS) * D + d] = sum;
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int d = i % D;
    float sum = 0.f;
    for (int y = 0; y < ROWS_; ++y) sum += w_sum[y * D + d];
    attn_io::store(ob + i, sum / static_cast<float>(w));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* abs_pos,
                   const void* pos, void* out, void* part, void* done, void* lse, int b, int hkv,
                   int group, int w, int window, float scale, int split, const int64_t* st,
                   cudaStream_t stream) {
  decode_split_kernel<T, D><<<dim3(split, hkv, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(abs_pos), static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(done), static_cast<float*>(lse), group, w,
      window, scale, st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* abs_pos,
                     const void* pos, void* out, void* part, void* done, void* lse, int b,
                     int hkv, int group, int w, int window, float scale, int split,
                     const int64_t* st, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, group, w, window, scale, split, st, stream);
    case 32: return launch<T, 32>(q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, group, w, window, scale, split, st, stream);
    case 64: return launch<T, 64>(q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, group, w, window, scale, split, st, stream);
    case 128: return launch<T, 128>(q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, group, w, window, scale, split, st, stream);
    case 256: return launch<T, 256>(q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, group, w, window, scale, split, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, D) through strides (batch, head), k/v (B, Hkv, W, D) through
// shared strides (batch, head, slot), abs_pos (B, W) int32 with row stride
// sab (slots contiguous), pos (B,) int32 contiguous, out (B, Hq, D)
// contiguous. is_bf16: 1 for bf16 q/k/v/out, 0 for fp32. split: blocks
// that share a row's slots, 1..8. part: fp32 scratch of
// B * Hkv * split * (Hq / Hkv * (D + 2) + 1) floats; done: B * Hkv int32
// counters, 0 before the launch and 0 again after it. lse: null, or fp32
// (B, Hq) contiguous, each (row, head)'s log-sum-exp of its scaled scores
// over the live slots (-inf where none is live).
int glin_decode_attention(const void* q, const void* k, const void* v, const void* abs_pos,
                          const void* pos, void* out, void* part, void* done, int b, int hq,
                          int hkv, int w, int d, int window, float scale, int is_bf16, int split,
                          long long sqb, long long sqh, long long skb, long long skh,
                          long long skw, long long sab, void* lse, void* stream) {
  if (b < 1 || w < 1 || hkv < 1 || hq % hkv || split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {sqb, sqh, skb, skh, skw, sab};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, abs_pos, pos, out, part, done, lse, b,
                                        hkv, hq / hkv, w, window, scale, split, st, cs)
              : dispatch<float>(d, q, k, v, abs_pos, pos, out, part, done, lse, b, hkv, hq / hkv,
                                w, window, scale, split, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
