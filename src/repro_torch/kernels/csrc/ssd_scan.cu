// Mamba-2 SSD chunked scan for Hopper (sm_90a), chunk-parallel on the
// tensor cores.
//
// Replaces ssd_scan_pallas (repro/kernels/ssd_scan.py). Same function:
// x (B, S, H, P), dt (B, S, H) fp32 (after softplus), a (H,) fp32 (< 0),
// b/c (B, S, N) -> y (B, S, H, P) in x's dtype, the output of the recurrence
//   h_t = e^{dt_t a} h_{t-1} + dt_t b_t x_t^T,   y_t = c_t . h_t,
// computed as the state-space duality gives it, in chunks of kL = 64 steps
// with g = cumsum(dt a) inside a chunk:
//   y = ((C B^T) o Gamma o dt) X + (C prev) o e^g,   Gamma_ij = e^{g_i - g_j} (i >= j),
//   U = B^T (e^{g_tot - g} dt o X),   prev_{c+1} = e^{g_tot} prev_c + U_c,
// and the final state (B, H, N, P) fp32, which the decode cache needs.
//
// Bound on an H100 SXM at the serving shape (1, 512, 80, 64), N = 128,
// counted at the 64-step chunk: bytes (x, y, the state, dt, B, C move
// ~13.5 MB, 0.0040 ms at 3.35 TB/s), since the products run on the tensor
// cores (split as below, 3.03 GFLOP, ~0.003 ms at 989 TFLOP/s bf16; on
// the CUDA cores in fp32 they would be 1.52 GFLOP, 0.0226 ms at 67
// TFLOP/s). The first kernel of the port ran one
// block per (row, head, 32 columns of P) through the chunks in order,
// recomputed C B^T in every block and multiplied on the CUDA cores. This
// design runs the chunks in parallel in three launches on the caller's
// stream, Mamba-2's own GPU split:
//   1. ssd_state_kernel: first one block per (row, chunk) for C B^T, once
//      for every head (one B/C group), to fp32 scratch (B, NC, kL, kL);
//      then one block per (row, head, chunk, 64 columns of P) for the
//      chunk's state contribution U_c, to fp32 scratch laid out
//      (B, H, NC, P, N16) (N16: N rounded up to 16), and its g_tot;
//   2. ssd_pass_kernel, one block per (row, head, 32 x 32 of (P, N16)):
//      prev_c over the chunks in order, written over U_c in place as
//      bf16 hi + lo words (the loads of 8 chunks in flight at once), and
//      the final state in fp32;
//   3. ssd_scan_kernel, one block per (row, head, chunk, 64 columns of P):
//      y = W X + (C prev_c) o e^g, written once in x's dtype.
// 648 + 640 + 640 blocks of 4 warps (the pass: 8) at the serving shape.
// Every product is mma.sync m16n8k16, bf16 operands with fp32
// accumulation, each warp 16 rows. Tiles sit in shared memory as the rows
// of steps they are in device memory; the operands that a product needs
// transposed (X, coef o X and B along the steps) are read with
// ldmatrix.trans. bf16 views whose rows are 16-byte aligned (the model's)
// are staged by cp.async, as are the fp32 C B^T and prev_c tiles of the
// scan; fp32 inputs and other views element by element, each thread's
// loads of 64 columns in flight before it stores any. g is a warp scan of
// dt a (its summation order is not the sequential one; the
// chunk-invariance tolerance covers it). Measured on the card and not kept
// (each within the tolerance, each slower): an ordered look-back that
// passed the state from chunk to chunk inside the first launch, in place
// of the pass (its serial chain of device-memory round trips grows with
// S); the scan reading prev_c's fragments from L2 instead of staging them;
// e^{g_i - g_j} factored through each 16-step block's last step;
// element-by-element staging of every tile (the first versions, where
// staging C and X took about half of the scan kernel's time). prev is
// split once, in the pass, not by each of the scan's four warps: a few
// percent faster.
//
// Numerics. A product of two bf16 values is exact in fp32, so a bf16
// operand (x, B, C of a bf16 call) goes in as it is. An fp32 operand (W,
// e^{g_tot - g} dt o X, prev; and x, B, C of an fp32 call) is split into
// bf16 hi = bf16(v) and lo = bf16(v - hi), whose residual is at most
// 2^-16 |v|, and each part is a product of its own: against a bf16 operand
// two products, and with both operands fp32, hi.hi + lo.hi + hi.lo (lo.lo
// is of the residuals' order), so fp32 inputs stay on the tensor cores too.
// The chunk's causal mask selects -inf before the exponential (as
// models/ssm.py's ssd_chunked does), so a masked weight is exactly 0 and
// never inf * 0; expf, not __expf. Any S: the missing steps of the last
// chunk read as dt = 0 and zero x, B, C, which leave the state and every
// real output unchanged.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after the launches. The caller allocates the
// scratch (sizes in glin_ssd_scan's comment).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "attention_io.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int kL = 64;          // steps per chunk
constexpr int kPs = 64;         // columns of P per block
constexpr int kLd = kL + 8;     // row stride (bf16) of the tiles over a chunk's steps
constexpr int kMaxN = 256;
constexpr int kPassTile = 32;   // the pass kernel's (P, N16) tile side
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
constexpr int kParts = std::is_same<T, float>::value ? 2 : 1;  // bf16 planes of an input

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// v into bf16 planes: hi at t[i] and, with two planes, lo at t[plane + i]
// (a bf16 input has one plane and is exact in it)
template <int Parts>
__device__ __forceinline__ void put(bf16* t, int i, int plane, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  t[i] = hi;
  if (Parts == 2) t[plane + i] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// two fp32 values -> registers of two bf16 each: hi and lo (a in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// v as one word for the scan's carry: bf16(v) in the low half, bf16(v -
// bf16(v)) in the high half; the scan pairs the halves of two words into
// its hi and lo fragment registers with __byte_perm
__device__ __forceinline__ float split_word(float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  const bf16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
                         static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}

__device__ __forceinline__ uint32_t u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major).
// Fragments (PTX ISA, m16n8k16): lane = 4 g + t holds a's rows g, g + 8 at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; b's column g at rows 2t, 2t + 1
// and 2t + 8, 2t + 9; c's rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a's 16 x 16 fragment at (r0, k0) of a tile stored row by row (k contiguous)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld, int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = (threadIdx.x & 3) * 2;
  a[0] = u32(t + (r0 + g) * ld + k0 + q);
  a[1] = u32(t + (r0 + g + 8) * ld + k0 + q);
  a[2] = u32(t + (r0 + g) * ld + k0 + q + 8);
  a[3] = u32(t + (r0 + g + 8) * ld + k0 + q + 8);
}

// b's 16 x 8 fragment at (k0, n0) of a tile stored column by column (k contiguous)
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const bf16* t, int ld, int k0,
                                       int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = (threadIdx.x & 3) * 2;
  b0 = u32(t + (n0 + g) * ld + k0 + q);
  b1 = u32(t + (n0 + g) * ld + k0 + q + 8);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(attn_io::smem_addr(p)));
}

// b's 16 x 8 fragments at (k0, n0) (r[0], r[1]) and (k0, n0 + 8) (r[2],
// r[3]) of a tile stored row by row along k (n contiguous): ldmatrix.trans
__device__ __forceinline__ void frag_b2_trans(uint32_t (&r)[4], const bf16* t, int ld, int k0,
                                              int n0) {
  const int i = threadIdx.x & 31;
  ldsm_x4_trans(r, t + (k0 + ((i >> 3) & 1) * 8 + (i & 7)) * ld + n0 + (i >> 4) * 8);
}

// a's 16 x 16 fragment at (r0, k0) of a tile stored row by row along k
// (a's rows contiguous): ldmatrix.trans
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], const bf16* t, int ld, int r0,
                                             int k0) {
  const int i = threadIdx.x & 31;
  ldsm_x4_trans(a, t + (k0 + ((i >> 4) & 1) * 8 + (i & 7)) * ld + r0 + ((i >> 3) & 1) * 8);
}

// dt and g = cumsum(dt a) of the chunk at t0 into dts / gs (warp 0: two
// steps a lane, then a warp scan)
__device__ __forceinline__ void chunk_g(const float* dtb, int64_t sds, int t0, int s, float ah,
                                        float* dts, float* gs) {
  const int lane = threadIdx.x, i0 = 2 * lane;
  const float d0 = t0 + i0 < s ? dtb[(t0 + i0) * sds] : 0.f;
  const float d1 = t0 + i0 + 1 < s ? dtb[(t0 + i0 + 1) * sds] : 0.f;
  const float v0 = d0 * ah, v1 = v0 + d1 * ah;
  float run = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, run, o);
    if (lane >= o) run += u;
  }
  float before = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) before = 0.f;
  dts[i0] = d0;
  dts[i0 + 1] = d1;
  gs[i0] = before + v0;
  gs[i0 + 1] = before + v1;
}

// kL rows x `cols` columns of a strided T matrix (row r at src + r * rs;
// rows from `rows_ok` on and columns from `valid` on read as 0, times
// scale[r] when given) into bf16 planes at t[r * ldt + c], element by
// element. A warp takes 32 columns and every fourth row; each thread issues
// the loads of 64 columns before it stores any.
template <typename T, int Parts>
__device__ __forceinline__ void stage(bf16* t, int ldt, int plane, const T* src, int64_t rs,
                                      int rows_ok, int cols, int valid,
                                      const float* scale = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < cols; c0 += 64) {
    float v[2][kL / 4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 32 * hh + lane;
#pragma unroll
      for (int j = 0; j < kL / 4; ++j) {
        const int r = warp + 4 * j;
        v[hh][j] = (c < valid && r < rows_ok) ? ld(src + r * rs + c) : 0.f;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 32 * hh + lane;
      if (c >= cols) continue;
#pragma unroll
      for (int j = 0; j < kL / 4; ++j) {
        const int r = warp + 4 * j;
        put<Parts>(t, r * ldt + c, plane, scale ? v[hh][j] * scale[r] : v[hh][j]);
      }
    }
  }
}

// the same tile of a bf16 matrix as it is, by 16-byte asynchronous copies
// (rows 16-byte aligned, `cols` and `valid` multiples of 8; missing rows and
// columns zero-filled); the caller commits and waits
__device__ __forceinline__ void stage_async(bf16* t, int ldt, const bf16* src, int64_t rs,
                                            int rows_ok, int cols, int valid) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < kL * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    const bool ok = r < rows_ok && c < valid;
    attn_io::cp_async16(t + r * ldt + c, ok ? src + r * rs + c : src, ok);
  }
}

// an input tile: asynchronously where `vec` (bf16 views whose rows are
// 16-byte aligned), else element by element
template <typename T, int Parts>
__device__ __forceinline__ void stage_in(bool vec, bf16* t, int ldt, int plane, const T* src,
                                         int64_t rs, int rows_ok, int cols, int valid) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) {
      stage_async(t, ldt, src, rs, rows_ok, cols, valid);
      return;
    }
  }
  stage<T, Parts>(t, ldt, plane, src, rs, rows_ok, cols, valid);
}

// `rows` rows of `cols` fp32 (a multiple of 4; rows 16-byte aligned) from
// src (row stride cols) to t (row stride ldt), asynchronously; the caller
// commits and waits
__device__ __forceinline__ void copy_rows(float* t, int ldt, const float* src, int rows, int cols) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    attn_io::cp_async16(t + r * ldt + c, src + static_cast<int64_t>(r) * cols + c);
  }
}

// ------------------------------------------------ 1. C B^T once per chunk
template <typename T>
__device__ __forceinline__ void cb_block(const T* __restrict__ bm, const T* __restrict__ cm,
                                         float* __restrict__ cb, bf16* smem, bool vec, int c,
                                         int b, int s, int n, int n16, int nc, int64_t sbb,
                                         int64_t sbs, int64_t scb, int64_t scs) {
  constexpr int P = kParts<T>;
  const int ldn = n16 + 8, plane = kL * ldn;
  bf16* cs = smem;             // P planes x (kL, ldn): C of the chunk
  bf16* bs = cs + P * plane;   // P planes x (kL, ldn): B
  const int t0 = c * kL;
  stage_in<T, P>(vec, cs, ldn, plane, cm + b * scb + t0 * scs, scs, s - t0, n16, n);
  stage_in<T, P>(vec, bs, ldn, plane, bm + b * sbb + t0 * sbs, sbs, s - t0, n16, n);
  attn_io::cp_async_commit();
  attn_io::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, r0 = warp * 16;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < n16; k0 += 16) {
    uint32_t a[P][4];
#pragma unroll
    for (int u = 0; u < P; ++u) frag_a(a[u], cs + u * plane, ldn, r0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j > r0 + 15) continue;   // above the diagonal: never read
      uint32_t b0, b1;
      frag_b(b0, b1, bs, ldn, k0, 8 * j);
      mma(acc[j], a[0], b0, b1);
      if (P == 2) {
        mma(acc[j], a[P - 1], b0, b1);
        frag_b(b0, b1, bs + plane, ldn, k0, 8 * j);
        mma(acc[j], a[0], b0, b1);
      }
    }
  }
  const int g = (threadIdx.x & 31) >> 2, q = (threadIdx.x & 3) * 2;
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * kL * kL;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + (r0 + g) * kL + 8 * j + q) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (r0 + g + 8) * kL + 8 * j + q) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// ------------------------------- 2. the chunk's state contribution U_c
template <typename T>
__device__ __forceinline__ void state_block(const T* __restrict__ x, const float* __restrict__ dt,
                                            const float* __restrict__ a,
                                            const T* __restrict__ bm, float* __restrict__ ut,
                                            float* __restrict__ gtot_out, float4* smem4, bool vec,
                                            int c, int p0, int hh, int b, int s, int h, int p,
                                            int n, int n16, int nc, int64_t sxb, int64_t sxs,
                                            int64_t sxh, int64_t sdb, int64_t sds, int64_t sbb,
                                            int64_t sbs) {
  constexpr int P = kParts<T>;
  const int ldn = n16 + 8;
  float* dts = reinterpret_cast<float*>(smem4);   // (kL,) dt
  float* gs = dts + kL;                           // (kL,) g
  float* coef = gs + kL;                          // (kL,) e^{g_tot - g} dt
  bf16* xc = reinterpret_cast<bf16*>(coef + kL);  // 2 planes x (kL, kLd): coef o X
  bf16* bs = xc + 2 * kL * kLd;                   // P planes x (kL, ldn): B
  bf16* xr = bs + P * kL * ldn;                   // (kL, kLd): X as given (vec)
  const int t0 = c * kL, tid = threadIdx.x, cols = min(kPs, p - p0);
  const T* xb = x + b * sxb + hh * sxh + t0 * sxs + p0;
  stage_in<T, P>(vec, bs, ldn, kL * ldn, bm + b * sbb + t0 * sbs, sbs, s - t0, n16, n);
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) stage_async(xr, kLd, xb, sxs, s - t0, kPs, cols);
  }
  attn_io::cp_async_commit();
  if (tid < 32) chunk_g(dt + b * sdb + hh, sds, t0, s, a[hh], dts, gs);
  __syncthreads();
  const float gtot = gs[kL - 1];
  if (tid < kL) coef[tid] = expf(gtot - gs[tid]) * dts[tid];
  attn_io::cp_async_wait<0>();
  __syncthreads();
  if (vec) {   // coef o X, split into two planes
    for (int i = tid; i < kL * kPs; i += kThreads) {
      const int m = i / kPs, col = i - m * kPs;
      put<2>(xc, m * kLd + col, kL * kLd, __bfloat162float(xr[m * kLd + col]) * coef[m]);
    }
  } else {
    stage<T, 2>(xc, kLd, kL * kLd, xb, sxs, s - t0, kPs, cols, coef);
  }
  __syncthreads();
  if (p0 == 0 && tid == 0) gtot_out[(static_cast<int64_t>(b) * h + hh) * nc + c] = gtot;
  // U_c^T (P, N) = (coef o X)^T (P, kL) . B (kL, N): warp w its rows 16w..
  const int warp = tid >> 5, r0 = warp * 16;
  if (p0 + r0 >= p) return;
  uint32_t af[4][2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    frag_a_trans(af[ks][0], xc, kLd, r0, 16 * ks);
    frag_a_trans(af[ks][1], xc + kL * kLd, kLd, r0, 16 * ks);
  }
  const int g = (tid & 31) >> 2, q = (tid & 3) * 2;
  const int row0 = p0 + r0 + g, row1 = row0 + 8;
  float* out = ut + ((static_cast<int64_t>(b) * h + hh) * nc + c) * p * n16;
  for (int n0 = 0; n0 < n16; n0 += 64) {
    float acc[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {   // n16 is a multiple of 16: both tiles or none
        if (n0 + 8 * j >= n16) continue;
        uint32_t bq[4];
        frag_b2_trans(bq, bs, ldn, 16 * ks, n0 + 8 * j);
        mma(acc[j], af[ks][0], bq[0], bq[1]);
        mma(acc[j], af[ks][1], bq[0], bq[1]);
        mma(acc[j + 1], af[ks][0], bq[2], bq[3]);
        mma(acc[j + 1], af[ks][1], bq[2], bq[3]);
        if (P == 2) {
          frag_b2_trans(bq, bs + kL * ldn, ldn, 16 * ks, n0 + 8 * j);
          mma(acc[j], af[ks][0], bq[0], bq[1]);
          mma(acc[j + 1], af[ks][0], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + q;
      if (col >= n16) continue;
      if (row0 < p)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(row0) * n16 + col) =
            make_float2(acc[j][0], acc[j][1]);
      if (row1 < p)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(row1) * n16 + col) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// one launch for 1 and 2: the first B * NC blocks are C B^T's (they start
// first, and the scan needs them last), the rest the chunk states'
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ cb,
                 float* __restrict__ ut, float* __restrict__ gtot_out, int vec, int bsz, int s,
                 int h, int p, int n, int n16, int nc, int nps, int64_t sxb, int64_t sxs,
                 int64_t sxh, int64_t sdb, int64_t sds, int64_t sbb, int64_t sbs, int64_t scb,
                 int64_t scs) {
  extern __shared__ float4 smem4[];
  int blk = blockIdx.x;
  if (blk < bsz * nc) {
    cb_block<T>(bm, cm, cb, reinterpret_cast<bf16*>(smem4), vec, blk % nc, blk / nc, s, n, n16,
                nc, sbb, sbs, scb, scs);
    return;
  }
  blk -= bsz * nc;
  const int c = blk % nc, ps = blk / nc % nps, hh = blk / (nc * nps) % h, b = blk / (nc * nps * h);
  state_block<T>(x, dt, a, bm, ut, gtot_out, smem4, vec, c, ps * kPs, hh, b, s, h, p, n, n16, nc,
                 sxb, sxs, sxh, sdb, sds, sbb, sbs);
}

// ---------------- 3. state passing: prev_c over U_c in place, final state
constexpr int kPassBatch = 8;   // chunks whose loads are in flight together

__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ ut, const float* __restrict__ gtot,
                float* __restrict__ state, int h, int p, int n, int n16, int nc) {
  __shared__ float tile[kPassTile][kPassTile + 1];
  const int tiles_n = (n16 + kPassTile - 1) / kPassTile;
  const int n0 = blockIdx.x % tiles_n * kPassTile, pr0 = blockIdx.x / tiles_n * kPassTile;
  const int hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, row = tid >> 5;      // 8 rows of 32 a pass
  const int64_t bh = static_cast<int64_t>(b) * h + hh;
  float* base = ut + bh * nc * p * n16;
  const float* gt = gtot + bh * nc;
  constexpr int kRows = kPassTile / 8;
  float sv[kRows] = {};
  bool ok[kRows];
  int64_t off[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int pr = pr0 + row + 8 * i, col = n0 + lane;
    ok[i] = pr < p && col < n16;
    off[i] = static_cast<int64_t>(pr) * n16 + col;
  }
  const int64_t step = static_cast<int64_t>(p) * n16;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float u[kPassBatch][kRows];
#pragma unroll
    for (int cc = 0; cc < kPassBatch; ++cc)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        u[cc][i] = (c0 + cc < nc && ok[i]) ? base[(c0 + cc) * step + off[i]] : 0.f;
#pragma unroll
    for (int cc = 0; cc < kPassBatch; ++cc) {
      if (c0 + cc >= nc) break;
      const float decay = expf(gt[c0 + cc]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        // the state before the chunk, split once here for the scan's warps
        if (ok[i]) base[(c0 + cc) * step + off[i]] = split_word(sv[i]);
        sv[i] = sv[i] * decay + u[cc][i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) tile[row + 8 * i][lane] = sv[i];
  __syncthreads();
  // (P, N) -> the state's (N, P): lanes along P
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int k = n0 + row + 8 * i, pr = pr0 + lane;
    if (k < n && pr < p) state[(bh * n + k) * p + pr] = tile[lane][row + 8 * i];
  }
}

// ------------------------------ 4. y = W X + (C prev_c) o e^g, per chunk
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
                const T* __restrict__ cm, const float* __restrict__ cb,
                const float* __restrict__ ut, T* __restrict__ y, int vec, int s, int h, int p,
                int n, int n16, int nc, int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb,
                int64_t sds, int64_t scb, int64_t scs) {
  extern __shared__ float4 smem4[];
  constexpr int P = kParts<T>;
  const int ldn = n16 + 8;
  float* dts = reinterpret_cast<float*>(smem4);   // (kL,) dt
  float* gs = dts + kL;                           // (kL,) g
  float* egs = gs + kL;                           // (kL,) e^g
  float* cbs = egs + kL;                          // (kL, kLd) C B^T of the chunk
  float* pvs = cbs + kL * kLd;                    // (kPs, ldn) prev_c^T, split words
  bf16* xs = reinterpret_cast<bf16*>(pvs + kPs * ldn);  // P planes x (kL, kLd): X
  bf16* cs = xs + P * kL * kLd;                   // P planes x (kL, ldn): C
  const int c = blockIdx.x % nc, p0 = blockIdx.x / nc * kPs, hh = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kL, tid = threadIdx.x;
  const int cols = min(kPs, p - p0);
  const int64_t bh = static_cast<int64_t>(b) * h + hh;
  // the fp32 scratch tiles land asynchronously while the inputs are staged
  copy_rows(cbs, kLd, cb + (static_cast<int64_t>(b) * nc + c) * kL * kL, kL, kL);
  if (c > 0) copy_rows(pvs, ldn, ut + (bh * nc + c) * p * n16 + static_cast<int64_t>(p0) * n16,
                       cols, n16);
  stage_in<T, P>(vec, xs, kLd, kL * kLd, x + b * sxb + hh * sxh + t0 * sxs + p0, sxs, s - t0,
                 kPs, cols);
  if (c > 0)
    stage_in<T, P>(vec, cs, ldn, kL * ldn, cm + b * scb + t0 * scs, scs, s - t0, n16, n);
  attn_io::cp_async_commit();
  if (tid < 32) chunk_g(dt + b * sdb + hh, sds, t0, s, a[hh], dts, gs);
  __syncthreads();
  if (tid < kL) egs[tid] = expf(gs[tid]);
  attn_io::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, r0 = warp * 16;
  const int g = (tid & 31) >> 2, q = (tid & 3) * 2;
  const int ra = r0 + g, rb = ra + 8;             // this lane's two rows
  // W X over the causal blocks of columns 0 .. r0 + 15: W's fragment built
  // in registers from C B^T, g and dt, and split hi + lo
  float yd[8][4] = {};
  for (int k0 = 0; k0 <= r0; k0 += 16) {
    float wv[8];
    const int rows[2] = {ra, rb};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rows[rr], m = k0 + q + 8 * half;
        const float2 v = *reinterpret_cast<const float2*>(cbs + i * kLd + m);
        // mask before the exponential: e^{positive} may overflow
        const float d0 = i >= m ? gs[i] - gs[m] : -CUDART_INF_F;
        const float d1 = i >= m + 1 ? gs[i] - gs[m + 1] : -CUDART_INF_F;
        wv[4 * half + 2 * rr] = v.x * expf(d0) * dts[m];
        wv[4 * half + 2 * rr + 1] = v.y * expf(d1) * dts[m + 1];
      }
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split2(wv[2 * u], wv[2 * u + 1], ahi[u], alo[u]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {   // tiles past cols are zero and never stored
      if (8 * j >= cols) continue;
      uint32_t bq[4];
      frag_b2_trans(bq, xs, kLd, k0, 8 * j);
      mma(yd[j], ahi, bq[0], bq[1]);
      mma(yd[j], alo, bq[0], bq[1]);
      mma(yd[j + 1], ahi, bq[2], bq[3]);
      mma(yd[j + 1], alo, bq[2], bq[3]);
      if (P == 2) {
        frag_b2_trans(bq, xs + kL * kLd, kLd, k0, 8 * j);
        mma(yd[j], ahi, bq[0], bq[1]);
        mma(yd[j + 1], ahi, bq[2], bq[3]);
      }
    }
  }
  // C prev_c (chunk 0 starts from zero): prev's hi and lo fragments paired
  // from the pass's split words
  float yc[8][4] = {};
  if (c > 0) {
    for (int k0 = 0; k0 < n16; k0 += 16) {
      uint32_t ca[P][4];
#pragma unroll
      for (int u = 0; u < P; ++u) frag_a(ca[u], cs + u * kL * ldn, ldn, r0, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= cols) continue;
        const float* pr = pvs + (8 * j + g) * ldn + k0 + q;   // rows past cols: never stored
        const uint2 v0 = *reinterpret_cast<const uint2*>(pr);
        const uint2 v1 = *reinterpret_cast<const uint2*>(pr + 8);
        const uint32_t h0 = __byte_perm(v0.x, v0.y, 0x5410), l0 = __byte_perm(v0.x, v0.y, 0x7632);
        const uint32_t h1 = __byte_perm(v1.x, v1.y, 0x5410), l1 = __byte_perm(v1.x, v1.y, 0x7632);
        mma(yc[j], ca[0], h0, h1);
        mma(yc[j], ca[0], l0, l1);
        if (P == 2) mma(yc[j], ca[P - 1], h0, h1);
      }
    }
  }
  const float ea = egs[ra], eb = egs[rb];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= cols) continue;
      if (t0 + ra < s)
        st(y + ((static_cast<int64_t>(b) * s + t0 + ra) * h + hh) * p + p0 + col + e,
           yd[j][e] + yc[j][e] * ea);
      if (t0 + rb < s)
        st(y + ((static_cast<int64_t>(b) * s + t0 + rb) * h + hh) * p + p0 + col + e,
           yd[j][2 + e] + yc[j][2 + e] * eb);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                   void* y, void* state, void* cb, void* ut, void* gtot, int bsz, int s, int h,
                   int p, int n, bool vec, const int64_t* st, cudaStream_t stream) {
  constexpr int P = kParts<T>;
  const int nc = (s + kL - 1) / kL, n16 = (n + 15) / 16 * 16, nps = (p + kPs - 1) / kPs;
  const size_t cb_bytes = sizeof(bf16) * 2 * P * kL * (n16 + 8);
  const size_t state_bytes = std::max(
      cb_bytes, sizeof(float) * 3 * kL + sizeof(bf16) * (3 * kL * kLd + P * kL * (n16 + 8)));
  const size_t scan_bytes = sizeof(float) * (3 * kL + kL * kLd + kPs * (n16 + 8)) +
                            sizeof(bf16) * P * (kL * kLd + kL * (n16 + 8));
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(state_bytes))) ||
      (e = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(scan_bytes))))
    return e;
  const T* xs = static_cast<const T*>(x);
  const T* bs = static_cast<const T*>(bm);
  const T* cs = static_cast<const T*>(cm);
  const float* dts = static_cast<const float*>(dt);
  const float* as = static_cast<const float*>(a);
  float* cbf = static_cast<float*>(cb);
  float* utf = static_cast<float*>(ut);
  float* gtf = static_cast<float*>(gtot);
  const int64_t blocks = static_cast<int64_t>(bsz) * nc * (1 + nps * h);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_state_kernel<T><<<static_cast<unsigned>(blocks), kThreads, state_bytes, stream>>>(
      xs, dts, as, bs, cs, cbf, utf, gtf, vec, bsz, s, h, p, n, n16, nc, nps, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  if ((e = cudaGetLastError())) return e;
  const int tiles = ((n16 + kPassTile - 1) / kPassTile) * ((p + kPassTile - 1) / kPassTile);
  ssd_pass_kernel<<<dim3(tiles, h, bsz), 256, 0, stream>>>(utf, gtf, static_cast<float*>(state),
                                                           h, p, n, n16, nc);
  if ((e = cudaGetLastError())) return e;
  ssd_scan_kernel<T><<<dim3(nc * nps, h, bsz), kThreads, scan_bytes, stream>>>(
      xs, dts, as, cs, cbf, utf, static_cast<T*>(y), vec, s, h, p, n, n16, nc, st[0], st[1],
      st[2], st[3], st[4], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, H, P) through strides (batch, step, head), last dim contiguous;
// dt (B, S, H) fp32 through strides (batch, step), heads contiguous; a (H,)
// fp32 contiguous; b/c (B, S, N) through strides (batch, step), last dim
// contiguous; y (B, S, H, P) contiguous in x's dtype; state (B, H, N, P)
// fp32 contiguous. Scratch, fp32 contiguous, with NC = ceil(S / 64) and
// N16 = N rounded up to 16: cb (B, NC, 64, 64), ut (B, H, NC, P, N16),
// gtot (B, H, NC). is_bf16: 1 for bf16 x / b / c / y, 0 for fp32.
int glin_ssd_scan(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                  void* y, void* state, void* cb, void* ut, void* gtot, int bsz, int s, int h,
                  int p, int n, int is_bf16, long long sxb, long long sxs, long long sxh,
                  long long sdb, long long sds, long long sbb, long long sbs, long long scb,
                  long long scs, void* stream) {
  if (bsz < 1 || s < 1 || h < 1 || p < 1 || n < 1 || n > kMaxN || h > 65535 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sxb, sxs, sxh, sdb, sds, sbb, sbs, scb, scs};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // bf16 views whose rows (of x, B, C) start 16-byte aligned are staged by
  // cp.async; any other view element by element
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = is_bf16 && a16(x) && a16(bm) && a16(cm) && p % 8 == 0 && n % 8 == 0 &&
                   (sxb | sxs | sxh | sbb | sbs | scb | scs) % 8 == 0;
  const cudaError_t e =
      is_bf16
          ? launch<bf16>(x, dt, a, bm, cm, y, state, cb, ut, gtot, bsz, s, h, p, n, vec, st, cs)
          : launch<float>(x, dt, a, bm, cm, y, state, cb, ut, gtot, bsz, s, h, p, n, vec, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
