// Causal / sliding-window GQA attention for Hopper (sm_90a): the prefill's
// full-sequence attention, online softmax in fp32.
//
// Replaces flash_attention_pallas (repro/kernels/flash_attention.py). Same
// function: q (B, Hq, S, D), k/v (B, Hkv, S, D), query head h reads kv head
// h / (Hq / Hkv); scores (q . k) * scale, masked to -1e30 where the key lies
// in the future or (window > 0) at or past `window` keys back; fp32 softmax
// with the running max / denominator, the denominator clamped at 1e-30; the
// output in q's dtype. Every tensor is read through its element strides
// (the last dimension contiguous), so the model's (B, S, H, D) activations
// go in as transposed views, without a copy.
//
// Design: one block per (query tile, kv head, batch row). The block's 64
// query rows are the group's Hq / Hkv heads times BQ = 64 / group tokens, so
// each 64-key K/V tile, staged in shared memory as fp32, is read once for
// the whole group. 16 x 16 threads; each holds a 4 x 4 tile of scores and a
// 4-row slice of the accumulator in registers. Key tiles that lie wholly in
// the future of every row, or wholly outside every row's window, are never
// loaded (the Pallas kernel's pl.when(live)). Any S: the ragged last tile
// is zero-filled and masked.
//
// Bound on this card: at the prefill's shapes (one 512-token prompt, 32
// query heads, 8 kv heads, D = 64, bf16) bytes — 5.2 MB a layer (q, k, v
// read once, the output written once) against ~1.08 GFLOP, 1.6 us against
// 1.1 us at the tensor cores' bf16 rate. This first kernel computes on the
// fp32 cores (no tensor cores yet), so operations set its time.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include "attention_io.cuh"

namespace {

using attn_io::kNegInf;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // query rows of a block (group x BQ tokens)
constexpr int kKeys = 64;      // keys of a tile

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles (rows padded by 4 floats: conflict-free float4 reads of
  // 16 different rows), the V tile, the probabilities
  return sizeof(float) *
         (static_cast<size_t>(kRows) * (D + 4) + static_cast<size_t>(kKeys) * (D + 4) +
          static_cast<size_t>(kKeys) * D + static_cast<size_t>(kRows) * (kKeys + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int group, int bq, int s, int window, float scale,
             int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb, int64_t skh, int64_t sks,
             int64_t sob, int64_t soh, int64_t sos) {
  constexpr int QS = D + 4;
  constexpr int PS = kKeys + 4;
  constexpr int V = attn_io::kVec<T>;
  constexpr int VPR = D / V;                  // vector loads per row
  constexpr int CPT = D >= 64 ? D / 64 : 1;   // float4 columns per thread in P.V
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kRows * QS;
  float* sv = sk + kKeys * QS;
  float* sp = sv + kKeys * D;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q_lo = blockIdx.x * bq;
  const int rows = group * bq;                // row r = g * bq + t
  const T* qb = q + b * sqb + static_cast<int64_t>(kvh) * group * sqh;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * skb + kvh * skh;

  for (int i = tid; i < kRows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    const int g = r / bq, t = q_lo + r % bq;
    float f[V];
    if (r < rows && t < s) {
      attn_io::load16(qb + g * sqh + t * sqs + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) sq[r * QS + c + e] = f[e];
  }

  int qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = q_lo + r % bq;
    live[i] = r < rows && qpos[i] < s;
  }
  float m[4], l[4], acc[4][4 * CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CPT; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q_lo + bq, s) - 1;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  for (int k_lo = (k_first / kKeys) * kKeys; k_lo <= q_last; k_lo += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * V;
      const int kp = k_lo + j;
      float fk[V], fv[V];
      if (kp < s) {
        attn_io::load16(kb + kp * sks + c, fk);
        attn_io::load16(vb + kp * sks + c, fv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sk[j * QS + c + e] = fk[e];
        sv[j * D + c + e] = fv[e];
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qa[i].x, kv[j].x, a);
          a = fmaf(qa[i].y, kv[j].y, a);
          a = fmaf(qa[i].z, kv[j].z, a);
          a = fmaf(qa[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, then the online softmax of each row (its 64 keys lie on the 16
    // lanes of one half-warp: shuffles over lane bits 0-3)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_lo + tx + 16 * j;
        const bool ok = kp <= qpos[i] && (window <= 0 || qpos[i] - kp < window);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * i) * PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * PS + j);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = (tx + 16 * cc) * 4;
        if (col < D) {
          const float4 v0 = *reinterpret_cast<const float4*>(sv + (j + 0) * D + col);
          const float4 v1 = *reinterpret_cast<const float4*>(sv + (j + 1) * D + col);
          const float4 v2 = *reinterpret_cast<const float4*>(sv + (j + 2) * D + col);
          const float4 v3 = *reinterpret_cast<const float4*>(sv + (j + 3) * D + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i] + 4 * cc;
            a[0] = fmaf(pa[i].w, v3.x, fmaf(pa[i].z, v2.x, fmaf(pa[i].y, v1.x, fmaf(pa[i].x, v0.x, a[0]))));
            a[1] = fmaf(pa[i].w, v3.y, fmaf(pa[i].z, v2.y, fmaf(pa[i].y, v1.y, fmaf(pa[i].x, v0.y, a[1]))));
            a[2] = fmaf(pa[i].w, v3.z, fmaf(pa[i].z, v2.z, fmaf(pa[i].y, v1.z, fmaf(pa[i].x, v0.z, a[2]))));
            a[3] = fmaf(pa[i].w, v3.w, fmaf(pa[i].z, v2.w, fmaf(pa[i].y, v1.w, fmaf(pa[i].x, v0.w, a[3]))));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = ty + 16 * i;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + b * sob + static_cast<int64_t>(kvh * group + r / bq) * soh + qpos[i] * sos;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = (tx + 16 * cc) * 4;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) attn_io::store(o + col + e, acc[i][4 * cc + e] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hkv,
                   int group, int s, int window, float scale, const int64_t* st,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int bq = kRows / group;
  const dim3 grid((s + bq - 1) / bq, hkv, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), group, bq, s, window, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* out, int b,
                     int hkv, int group, int s, int window, float scale, const int64_t* st,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, hkv, group, s, window, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, hkv, group, s, window, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, hkv, group, s, window, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, hkv, group, s, window, scale, st, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, hkv, group, s, window, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k/v (B, Hkv, S, D), out (B, Hq, S, D), each through its
// element strides (batch, head, position; the last dimension contiguous; k
// and v share strides). is_bf16: 1 for bf16 tensors, 0 for fp32.
int glin_flash_attention(const void* q, const void* k, const void* v, void* out, int b, int hq,
                         int hkv, int s, int d, int window, float scale, int is_bf16,
                         long long sqb, long long sqh, long long sqs, long long skb,
                         long long skh, long long sks, long long sob, long long soh,
                         long long sos, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || hq % hkv || hq / hkv > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqh, sqs, skb, skh, sks, sob, soh, sos};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, b, hkv, hq / hkv, s, window, scale, st, cs)
              : dispatch<float>(d, q, k, v, out, b, hkv, hq / hkv, s, window, scale, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
