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
// Design: one block per (kv head, batch row); the group's Hq / Hkv query
// heads share one pass over the W slots, four heads at a time. A slot's D
// elements are split over a few lanes (16 bytes each, one load), which hold
// the heads' matching q elements in registers: the lanes form the slot's
// dot products and reduce them with shuffles, so K and V go from device
// memory straight to registers, each byte once per four heads. Each slot
// group takes four slots a step (eight loads in flight per lane) and keeps
// its own running max / denominator / accumulator; the groups' states are
// merged at the end, first within a warp by shuffles, then across warps in
// shared memory. Any W.
//
// Bound on this card: bytes — the slots' K and V (16.8 MB a layer at 8
// rows x 8 kv heads x 1024 slots x 64 x bf16, ~5 us at 3.35 TB/s; less
// where slots are empty, whose K/V a kernel need not read). This first
// kernel reads every slot and launches B * Hkv blocks (64 at 8 slots), half
// the card's SMs.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include <math_constants.h>

#include "attention_io.cuh"

namespace {

using attn_io::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;  // query heads per pass
constexpr int kSteps = 4;  // slots a group takes per step

template <typename T, int D>
struct Layout {
  static constexpr int V = attn_io::kVec<T>;
  static constexpr int E = D / 32 > V ? D / 32 : V;  // elements per lane
  static constexpr int LPS = D / E;                   // lanes per slot
  static constexpr int NG = kThreads / LPS;           // slot groups
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "unsupported head dim");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ abs_pos, const int* __restrict__ pos, T* __restrict__ out,
              int group, int w, int window, float scale, int64_t sqb, int64_t sqh, int64_t skb,
              int64_t skh, int64_t skw, int64_t sab) {
  using L = Layout<T, D>;
  constexpr int E = L::E, LPS = L::LPS, NG = L::NG, V = L::V;
  __shared__ float s_m[kWarps][kHeads], s_l[kWarps][kHeads];
  __shared__ float s_acc[kWarps][kHeads][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, kvh = blockIdx.x;
  const int sub = lane % LPS, grp = tid / LPS, d0 = sub * E;
  const unsigned gmask = LPS == 32 ? 0xffffffffu : ((1u << LPS) - 1u) << (lane / LPS * LPS);
  const int p = pos[b];
  const int* ap = abs_pos + b * sab;
  const T* kb = k + b * skb + kvh * skh + d0;
  const T* vb = v + b * skb + kvh * skh + d0;
  const int h0 = kvh * group;

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

    for (int w0 = grp * kSteps; w0 < w; w0 += NG * kSteps) {
      float kf[kSteps][E], vf[kSteps][E];
      int a[kSteps];
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int slot = w0 + i;
        if (slot < w) {
          a[i] = ap[slot];
#pragma unroll
          for (int e = 0; e < E; e += V) {
            attn_io::load16(kb + slot * skw + e, kf[i] + e);
            attn_io::load16(vb + slot * skw + e, vf[i] + e);
          }
        } else {
          a[i] = -1;
#pragma unroll
          for (int e = 0; e < E; ++e) kf[i][e] = vf[i][e] = 0.f;
        }
      }
      float sc[kSteps][kHeads];
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
#pragma unroll
        for (int c = 0; c < kHeads; ++c) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[c][e], kf[i][e], dot);
          sc[i][c] = dot;
        }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < kSteps; ++i)
#pragma unroll
          for (int c = 0; c < kHeads; ++c) sc[i][c] += __shfl_xor_sync(gmask, sc[i][c], off);
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const bool ok = a[i] >= 0 && a[i] <= p && (window <= 0 || p - a[i] < window);
#pragma unroll
        for (int c = 0; c < kHeads; ++c)
          // a slot past W is no slot at all: -inf gives it weight 0 always
          sc[i][c] = w0 + i >= w ? -CUDART_INF_F : (ok ? sc[i][c] * scale : kNegInf);
      }
#pragma unroll
      for (int c = 0; c < kHeads; ++c) {
        float m_new = m[c];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) m_new = fmaxf(m_new, sc[i][c]);
        const float alpha = expf(m[c] - m_new);
        float pr[kSteps], sum = 0.f;
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          pr[i] = expf(sc[i][c] - m_new);
          sum += pr[i];
        }
        l[c] = l[c] * alpha + sum;
        m[c] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float x = acc[c][e] * alpha;
#pragma unroll
          for (int i = 0; i < kSteps; ++i) x = fmaf(pr[i], vf[i][e], x);
          acc[c][e] = x;
        }
      }
    }

    // merge the slot groups of a warp (lanes with the same d0)
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < kHeads; ++c) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[c], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[c], off);
        const float mm = fmaxf(m[c], mo);
        const float fa = expf(m[c] - mm), fb = expf(mo - mm);
        l[c] = l[c] * fa + lo * fb;
        m[c] = mm;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[c][e], off);
          acc[c][e] = acc[c][e] * fa + ao * fb;
        }
      }
    }
    if (lane < LPS) {
#pragma unroll
      for (int c = 0; c < kHeads; ++c) {
        if (sub == 0) {
          s_m[warp][c] = m[c];
          s_l[warp][c] = l[c];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) s_acc[warp][c][d0 + e] = acc[c][e];
      }
    }
    __syncthreads();
    // ... then across warps
    for (int i = tid; i < kHeads * D; i += kThreads) {
      const int c = i / D, d = i % D;
      if (g0 + c >= group) continue;
      float mm = kNegInf;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) mm = fmaxf(mm, s_m[x][c]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        const float f = expf(s_m[x][c] - mm);
        den += s_l[x][c] * f;
        num += s_acc[x][c][d] * f;
      }
      attn_io::store(out + (static_cast<int64_t>(b) * gridDim.x * group + h0 + g0 + c) * D + d,
                     num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* abs_pos,
                   const void* pos, void* out, int b, int hkv, int group, int w, int window,
                   float scale, const int64_t* st, cudaStream_t stream) {
  decode_kernel<T, D><<<dim3(hkv, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(abs_pos), static_cast<const int*>(pos), static_cast<T*>(out), group,
      w, window, scale, st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* abs_pos,
                     const void* pos, void* out, int b, int hkv, int group, int w, int window,
                     float scale, const int64_t* st, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, abs_pos, pos, out, b, hkv, group, w, window, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, abs_pos, pos, out, b, hkv, group, w, window, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, abs_pos, pos, out, b, hkv, group, w, window, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, abs_pos, pos, out, b, hkv, group, w, window, scale, st, stream);
    case 256: return launch<T, 256>(q, k, v, abs_pos, pos, out, b, hkv, group, w, window, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, D) through strides (batch, head), k/v (B, Hkv, W, D) through
// shared strides (batch, head, slot), abs_pos (B, W) int32 with row stride
// sab (slots contiguous), pos (B,) int32 contiguous, out (B, Hq, D)
// contiguous. is_bf16: 1 for bf16 q/k/v/out, 0 for fp32.
int glin_decode_attention(const void* q, const void* k, const void* v, const void* abs_pos,
                          const void* pos, void* out, int b, int hq, int hkv, int w, int d,
                          int window, float scale, int is_bf16, long long sqb, long long sqh,
                          long long skb, long long skh, long long skw, long long sab,
                          void* stream) {
  if (b < 1 || w < 1 || hkv < 1 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {sqb, sqh, skb, skh, skw, sab};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, abs_pos, pos, out, b, hkv, hq / hkv, w,
                                        window, scale, st, cs)
              : dispatch<float>(d, q, k, v, abs_pos, pos, out, b, hkv, hq / hkv, w, window,
                                scale, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
