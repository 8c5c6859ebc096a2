// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (repro/kernels/ssd_scan.py). Same function:
// x (B, S, H, P), dt (B, S, H) fp32 (after softplus), a (H,) fp32 (< 0),
// b/c (B, S, N) -> y (B, S, H, P) in x's dtype, the output of the recurrence
//   state_t = e^{dt_t a} state_{t-1} + dt_t b_t x_t^T,   y_t = c_t . state_t,
// computed chunk by chunk as the state-space duality gives it: inside a tile
// of steps, y = ((C B^T) o Gamma o dt) X + (C state) o e^g with
// g = cumsum(dt a) and Gamma_ij = e^{g_i - g_j} (i >= j); across tiles the
// (N, P) state carries, state' = e^{g_tot} state + B^T (e^{g_tot - g} dt X).
// Unlike the Pallas kernel it also writes the final state (B, H, N, P) fp32,
// which the decode cache needs.
//
// Design. The TPU kernel's grid (B, H, S / chunk) runs the chunk axis in
// order and keeps the state in VMEM; here a loop inside the block walks the
// tiles in order and keeps the state in shared memory. The recurrence is
// independent across the P columns of x and of the state, so one block owns
// (batch row, head, 32 columns of P): 160 blocks at B = 1, H = 80, P = 64
// on the card's 132 SMs, where one block per (row, head) would give 80. The
// tile is 64 steps whatever the caller's chunk (the chunked algorithm gives
// the same function for any tile length), so B and C of a tile fit in fp32
// (2 x 64 x N floats, 64 KB at N = 128) beside the 64 x 64 weight tile, x's
// columns and the state: 112 KB at N = 128, N <= 256. The last tile may be
// partial: its missing steps read as dt = 0 and zero x, B, C, which leave
// the state and every real output unchanged, so any S is taken.
//
// All exponentials have non-positive arguments except Gamma's upper
// triangle, where g_i - g_j > 0 can overflow: the mask selects -inf before
// the exponential (as models/ssm.py's ssd_chunked does), so a masked weight
// is exactly 0 and never inf * 0. expf, not __expf. Arithmetic is fp32 on
// the CUDA cores; inputs are upcast from bf16 or fp32 as they are staged.
//
// Bound on this card at the serving shape (1, 512, 80, 64), N = 128, chunk
// 128: operations — C B^T once per chunk plus, per head and chunk, W X
// (both over the causal lower triangle), C state and the state update:
// 1.69 GFLOP, 0.0252 ms at 67 TFLOP/s fp32; the bytes (x, y, the state,
// dt, B, C: ~13.5 MB) take 0.0040 ms. This first
// kernel recomputes C B^T in every block (2 x 80 times per chunk, not once)
// and uses no tensor cores.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // steps per tile
constexpr int kCols = 32;          // columns of P per block (one per lane)
constexpr int kRowT = kTile + 4;   // row stride of the transposed B / C tiles
constexpr int kMaxN = 256;
constexpr int kSub = kTile / 4;    // 4 x 4 sub-tiles per side of the weight tile
constexpr int kLower = kSub * (kSub + 1) / 2;  // sub-tiles on or below the diagonal
static_assert(kLower + kSub * (kSub - 1) / 2 == kThreads, "one sub-tile per thread");
static_assert(kTile == kWarps * 8, "8 rows of y per warp");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_bytes(int n) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * kRowT + kTile * kTile + kTile * kCols +
                          static_cast<size_t>(n) * kCols + 4 * kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ state_out, int s, int h, int p, int n, int64_t sxb, int64_t sxs,
           int64_t sxh, int64_t sdb, int64_t sds, int64_t sbb, int64_t sbs, int64_t scb,
           int64_t scs) {
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);   // (N, kRowT): B of the tile, transposed
  float* ct = bt + n * kRowT;                    // (N, kRowT): C, transposed
  float* wt = ct + n * kRowT;                    // (kTile, kTile): masked weights
  float* xs = wt + kTile * kTile;                // (kTile, kCols): x, then x * coef
  float* sts = xs + kTile * kCols;               // (N, kCols): the carried state
  float* dts = sts + n * kCols;                  // (kTile,) dt
  float* gs = dts + kTile;                       // (kTile,) g = cumsum(dt a)
  float* egs = gs + kTile;                       // (kTile,) e^g
  float* coef = egs + kTile;                     // (kTile,) e^{g_tot - g} dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kCols, hh = blockIdx.y, b = blockIdx.z;
  const int col = p0 + lane;
  const bool col_ok = col < p;
  const float ah = a[hh];
  const T* xb = x + b * sxb + hh * sxh;
  const float* dtb = dt + b * sdb + hh;
  const T* bb = bm + b * sbb;
  const T* cb = cm + b * scb;

  // this thread's 4 x 4 sub-tile of the weight tile: the first kLower
  // threads take the lower triangle, the others zero the upper one
  int ti = 0, tj = 0;
  if (tid < kLower) {
    while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
    tj = tid - ti * (ti + 1) / 2;
  } else {
    int u = tid - kLower;
    while (u >= kSub - 1 - ti) {
      u -= kSub - 1 - ti;
      ++ti;
    }
    tj = ti + 1 + u;
  }

  for (int i = tid; i < n * kCols; i += kThreads) sts[i] = 0.f;

  for (int t0 = 0; t0 < s; t0 += kTile) {
    // ---- stage the tile (missing steps of a partial tile read as zeros)
    if (tid < kTile) dts[tid] = t0 + tid < s ? dtb[(t0 + tid) * sds] : 0.f;
    for (int i = tid; i < kTile * n; i += kThreads) {
      const int r = i / n, k = i - r * n;
      const bool ok = t0 + r < s;
      bt[k * kRowT + r] = ok ? ld(bb + (t0 + r) * sbs + k) : 0.f;
      ct[k * kRowT + r] = ok ? ld(cb + (t0 + r) * scs + k) : 0.f;
    }
    for (int r = warp; r < kTile; r += kWarps)
      xs[r * kCols + lane] = (t0 + r < s && col_ok) ? ld(xb + (t0 + r) * sxs + col) : 0.f;
    __syncthreads();
    if (tid == 0) {  // in order, as torch.cumsum sums
      float g = 0.f;
      for (int r = 0; r < kTile; ++r) {
        g += dts[r] * ah;
        gs[r] = g;
      }
    }
    __syncthreads();
    const float gtot = gs[kTile - 1];
    if (tid < kTile) {
      egs[tid] = expf(gs[tid]);
      coef[tid] = expf(gtot - gs[tid]) * dts[tid];
    }

    // ---- weights: W_ij = (c_i . b_j) e^{g_i - g_j} dt_j for i >= j, else 0
    {
      const int i0 = ti * 4, j0 = tj * 4;
      float acc[4][4] = {};
      if (tid < kLower) {
        for (int k = 0; k < n; ++k) {
          const float4 c4 = *reinterpret_cast<const float4*>(ct + k * kRowT + i0);
          const float4 b4 = *reinterpret_cast<const float4*>(bt + k * kRowT + j0);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + r, j = j0 + c;
            // mask before the exponential: e^{positive} may overflow
            const float d = i >= j ? gs[i] - gs[j] : -CUDART_INF_F;
            acc[r][c] = acc[r][c] * expf(d) * dts[j];
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(wt + (i0 + r) * kTile + j0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();

    // ---- y rows warp*8 .. +7, column lane: W X + (C state) e^g
    {
      const int i0 = warp * 8;
      float yd[8] = {}, yc[8] = {};
      for (int j = 0; j < i0 + 8; ++j) {
        const float xv = xs[j * kCols + lane];
#pragma unroll
        for (int r = 0; r < 8; ++r) yd[r] = fmaf(wt[(i0 + r) * kTile + j], xv, yd[r]);
      }
      for (int k = 0; k < n; ++k) {
        const float sv = sts[k * kCols + lane];
        const float4 c0 = *reinterpret_cast<const float4*>(ct + k * kRowT + i0);
        const float4 c1 = *reinterpret_cast<const float4*>(ct + k * kRowT + i0 + 4);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) yc[r] = fmaf(cv[r], sv, yc[r]);
      }
      if (col_ok) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = t0 + i0 + r;
          if (i < s)
            st(y + ((static_cast<int64_t>(b) * s + i) * h + hh) * p + col,
               yd[r] + yc[r] * egs[i0 + r]);
        }
      }
    }
    __syncthreads();

    // ---- carry: state' = e^{g_tot} state + B^T (coef o X)
    for (int r = warp; r < kTile; r += kWarps) xs[r * kCols + lane] *= coef[r];
    __syncthreads();
    const float decay = expf(gtot);
    for (int k0 = warp; k0 < n; k0 += 4 * kWarps) {
      int rows[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) rows[q] = min(k0 + q * kWarps, n - 1);
      float u[4] = {};
      for (int j = 0; j < kTile; j += 4) {
        const float xv[4] = {xs[j * kCols + lane], xs[(j + 1) * kCols + lane],
                             xs[(j + 2) * kCols + lane], xs[(j + 3) * kCols + lane]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b4 = *reinterpret_cast<const float4*>(bt + rows[q] * kRowT + j);
          u[q] = fmaf(b4.x, xv[0], u[q]);
          u[q] = fmaf(b4.y, xv[1], u[q]);
          u[q] = fmaf(b4.z, xv[2], u[q]);
          u[q] = fmaf(b4.w, xv[3], u[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + q * kWarps;
        if (k < n) sts[k * kCols + lane] = sts[k * kCols + lane] * decay + u[q];
      }
    }
    __syncthreads();
  }

  // ---- the final state: this thread's rows of its column
  if (col_ok)
    for (int k = warp; k < n; k += kWarps)
      state_out[((static_cast<int64_t>(b) * h + hh) * n + k) * p + col] = sts[k * kCols + lane];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                   void* y, void* state, int bsz, int s, int h, int p, int n, const int64_t* st,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(n);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((p + kCols - 1) / kCols, h, bsz);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), s, h, p, n, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, H, P) through strides (batch, step, head), last dim contiguous;
// dt (B, S, H) fp32 through strides (batch, step), heads contiguous; a (H,)
// fp32 contiguous; b/c (B, S, N) through strides (batch, step), last dim
// contiguous; y (B, S, H, P) contiguous in x's dtype; state (B, H, N, P)
// fp32 contiguous. is_bf16: 1 for bf16 x / b / c / y, 0 for fp32.
int glin_ssd_scan(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                  void* y, void* state, int bsz, int s, int h, int p, int n, int is_bf16,
                  long long sxb, long long sxs, long long sxh, long long sdb, long long sds,
                  long long sbb, long long sbs, long long scb, long long scs, void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || p < 1 || n < 1 || n > kMaxN || h > 65535 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sxb, sxs, sxh, sdb, sds, sbb, sbs, scb, scs};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, bsz, s, h, p, n, st, cs)
              : launch<float>(x, dt, a, bm, cm, y, state, bsz, s, h, p, n, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
