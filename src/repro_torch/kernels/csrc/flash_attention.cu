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
// Bound on this card at the prefill's shape (one 512-token prompt, 32 query
// heads over 8 kv heads, D = 64, bf16): bytes, 5.2 MB a layer (q, k, v
// read once, the output written once) in 1.6 us against the causal half of
// 2.15 GFLOP, 1.1 us at the tensor cores' bf16 rate; the CUDA cores' fp32
// rate would need 16 us for the same products. One entry point per dtype.
//
// bf16, on the tensor cores, FlashAttention-2 style. The block's 64 rows
// are the group's heads times a run of 64 / group tokens, so each K/V tile
// leaves device memory once per group; key tiles that every row has masked
// are never loaded (the Pallas kernel's pl.when(live)). A 1-D grid walks
// the query tiles from the last (the longest causal row) to the first, so
// the longest blocks start first: 256 blocks of 128 threads at the
// prefill's shape. K/V tiles stream through a ring in shared memory with
// cp.async, the next tiles' copies overlapping this tile's products; a
// ragged last tile is zero-filled. The scores stay in the accumulator
// registers, where the mask and the online softmax act on them (row max
// and row sum over the 4 lanes of a quad, by shuffles; p = 2^(s scale
// log2(e) - m scale log2(e)) in one FMA and one ex2.approx, the scale
// applied to the fp32 scores, not to a bf16-rounded q); P is rounded to
// bf16 and repacked in registers as the A operand of P.V, never through
// shared memory. Two kernels:
// - D = 64 (the served models'): flash_wgmma_kernel, one warpgroup whose
//   wgmma products read K and V from 128-byte-swizzled shared memory once
//   a block (its own comment below).
// - the other head dims: flash_mma_kernel, 4 warps of 16 rows with
//   mma.sync.m16n8k16, K to fragments by ldmatrix and V by ldmatrix.trans
//   from shared-memory rows padded by 16 bytes (8 consecutive rows land in
//   8 different 16-byte bank groups: conflict-free). Every warp reads the
//   whole K/V tile from shared memory: at D = 64 that read, not the
//   products, set its time (measured on the card), hence wgmma there.
//
// fp32: flash_fp32_kernel, on the CUDA cores (TF32 tensor cores would miss
// the fp32 tolerance of 2e-5). The served models are bf16; fp32 runs in the
// end-to-end rounding checks. Same packing of the block's 64 rows; 16 x 16
// threads, each with a 4 x 4 tile of scores and a 4-row slice of the
// accumulator in registers, the tiles staged in shared memory as fp32.
//
// C interface: plain functions, every pointer and the stream as void*, a
// cudaError_t returned after each launch.
#include "attention_io.cuh"

namespace {

using attn_io::kNegInf;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // query rows of a block (group x tokens), every kernel

// ------------------------------------------------- bf16 kernel, mma.sync
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes of the mma.sync kernel at head dim D: 4 warps of 16 query
// rows; key tiles of 128 keys at D <= 64 (half the per-tile softmax and
// rescale work of 64), 64 at D = 128, 32 at D = 256 (for registers, Q then
// read from shared memory).
template <int D>
struct MmaTile {
  static constexpr int NW = kRows / 16;             // warps of a block
  static constexpr int THREADS = 32 * NW;
  static constexpr int KEYS = D <= 64 ? 128 : (D <= 128 ? 64 : 32);  // keys per tile
  static constexpr int LD = D + 8;                  // shared row stride (elements)
  static constexpr bool Q_REGS = D <= 128;          // Q fragments held in registers
  // K/V tiles in the ring: where a tile is small (KEYS x D <= 4096) three
  // are in flight while one is computed; above, one
  static constexpr int STAGES = KEYS * D <= 4096 ? 4 : 2;
  // Q, then the ring's K and V tiles
  static constexpr size_t SMEM =
      sizeof(bf16) * static_cast<size_t>(kRows + 2 * STAGES * KEYS) * LD;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(attn_io::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(attn_io::smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error ~2^-22, far below the bf16
// rounding of P; subnormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half, as the
// fragments order columns)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout of m16n8k16 (PTX ISA): lane = 4 * g + t holds, of a
// 16 x 8 accumulator, rows g and g + 8 at columns 2t and 2t + 1 (c[0], c[1]
// row g; c[2], c[3] row g + 8). The scores' tile j (keys 8j .. 8j + 7) is
// such an accumulator, so lane (g, t) holds keys 8j + 2t + {0, 1} of its
// warp's rows g and g + 8.
template <int D>
__global__ void __launch_bounds__(MmaTile<D>::THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int nb, int hkv, int group,
                 int bq, int n_tiles, int s, int window, float scale, int64_t sqb, int64_t sqh,
                 int64_t sqs, int64_t skb, int64_t skh, int64_t sks, int64_t sob, int64_t soh,
                 int64_t sos) {
  using Tile = MmaTile<D>;
  constexpr int KEYS = Tile::KEYS, LD = Tile::LD, STAGES = Tile::STAGES;
  constexpr int THREADS = Tile::THREADS;
  constexpr int CPR = D / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kRows * LD;          // stage i at sk + i * KEYS * LD
  bf16* sv = sk + STAGES * KEYS * LD;  // likewise

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = nb * hkv;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / per;  // longest first
  const int kvh = static_cast<int>(blockIdx.x) % hkv;
  const int b = (static_cast<int>(blockIdx.x) / hkv) % nb;
  const int q_lo = tile * bq;
  const int rows = group * bq;  // row r = g * bq + t
  const bf16* qb = q + b * sqb + static_cast<int64_t>(kvh) * group * sqh;
  const bf16* kb = k + b * skb + kvh * skh;
  const bf16* vb = v + b * skb + kvh * skh;

  // the Q tile (zero rows past the group or the sequence) ...
  for (int i = tid; i < kRows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = q_lo + r % bq;
    const bool ok = r < rows && t < s;
    attn_io::cp_async16(sq + r * LD + c, ok ? qb + (r / bq) * sqh + t * sqs + c : qb, ok);
  }
  // ... and a K/V tile (zero rows past the sequence)
  auto load_kv = [&](int stage, int k_lo) {
    bf16* dk = sk + stage * KEYS * LD;
    bf16* dv = sv + stage * KEYS * LD;
    for (int i = tid; i < KEYS * CPR; i += THREADS) {
      const int j = i / CPR, c = (i % CPR) * 8;
      const int kp = k_lo + j;
      const bool ok = kp < s;
      const int64_t off = ok ? kp * sks + c : 0;
      attn_io::cp_async16(dk + j * LD + c, kb + off, ok);
      attn_io::cp_async16(dv + j * LD + c, vb + off, ok);
    }
  };

  // this lane's rows, g and g + 8 of its warp's 16, and their tokens
  const int r0 = warp * 16 + (lane >> 2);
  const int tq[2] = {q_lo + r0 % bq, q_lo + (r0 + 8) % bq};
  const int q_last = min(q_lo + bq, s) - 1;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt_first = k_first / KEYS, kt_last = q_last / KEYS;
  const float sl2 = scale * kLog2e;

  // one commit group per tile (empty past the last), the Q tile in the first
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_first + i <= kt_last) load_kv(i, (kt_first + i) * KEYS);
    attn_io::cp_async_commit();
  }

  uint32_t qf[Tile::Q_REGS ? D / 16 : 1][4];
  float o[D / 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // running max (raw scores), sum
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const bf16* qs = sq + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int stage = (kt - kt_first) % STAGES;
    if (kt + STAGES - 1 <= kt_last)
      load_kv((kt - kt_first + STAGES - 1) % STAGES, (kt + STAGES - 1) * KEYS);
    attn_io::cp_async_commit();
    attn_io::cp_async_wait<STAGES - 1>();  // this tile (and Q) have landed
    __syncthreads();
    const bf16* ks = sk + stage * KEYS * LD;
    const bf16* vs = sv + stage * KEYS * LD;
    if constexpr (Tile::Q_REGS) {
      if (kt == kt_first) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], qs + kk * 16);
      }
    }

    // S = Q K^T: 16 rows x KEYS keys per warp
    float sc[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Tile::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qs + kk * 16);
      }
#pragma unroll
      for (int nn = 0; nn < KEYS / 16; ++nn) {
        // keys 16 nn + (0..7 | 8..15), depth 16 kk + (0..7 | 8..15)
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nn], a, kf[0], kf[1]);
        mma_bf16(sc[2 * nn + 1], a, kf[2], kf[3]);
      }
    }

    // mask where some row of the block needs it: raw scores to -1e30
    const int k_lo = kt * KEYS;
    if (k_lo + KEYS - 1 > q_lo || (window > 0 && q_last - k_lo >= window)) {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k_lo + j * 8 + 2 * (lane & 3) + (e & 1);
          const int t = tq[e >> 1];
          if (!(kp <= t && (window <= 0 || t - kp < window))) sc[j][e] = kNegInf;
        }
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1): a row's max over
    // its quad's 4 lanes, its sum kept per lane until the end;
    // p = 2^(s sl2 - m sl2) in one FMA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx((m[h] - mx) * sl2);
      m[h] = mx;
      // a row with every key so far masked: its p are 0, not 2^(rounding)
      const float msc = mx == kNegInf ? 0.f : -mx * sl2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        sc[j][2 * h] = exp2_approx(__fmaf_rn(sc[j][2 * h], sl2, msc));
        sc[j][2 * h + 1] = exp2_approx(__fmaf_rn(sc[j][2 * h + 1], sl2, msc));
        rs += sc[j][2 * h] + sc[j][2 * h + 1];
      }
      l[h] = l[h] * alpha + rs;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's score tiles 2kk and 2kk + 1 are the A fragment of keys
    // 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        // keys 16 kk + (0..7 | 8..15), columns 16 nn + (0..7 | 8..15)
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  nn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * nn], pa, vf[0], vf[1]);
        mma_bf16(o[2 * nn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  attn_io::cp_async_wait<0>();

  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int r = r0 + 8 * h, t = tq[h];
    if (r < rows && t < s) {
      bf16* dst = out + b * sob + static_cast<int64_t>(kvh * group + r / bq) * soh + t * sos;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + col) =
            __floats2bfloat162_rn(o[n][2 * h] / den, o[n][2 * h + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int hkv,
                        int group, int bq, int s, int window, float scale, const int64_t* st,
                        cudaStream_t stream) {
  using Tile = MmaTile<D>;
  if (group * bq > kRows) return cudaErrorInvalidValue;
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Tile::SMEM));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_tiles = (s + bq - 1) / bq;
  flash_mma_kernel<D><<<n_tiles * hkv * b, Tile::THREADS, Tile::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), b, hkv, group, bq, n_tiles, s, window, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// ----------------------------------------------- bf16 kernel, D = 64: wgmma
// The served head dim takes Hopper's warpgroup products: the block's 64
// query rows are one warpgroup, and wgmma.m64n128k16 (Q.K^T) and
// wgmma.m64n64k16 (P.V) read K and V straight from shared memory, once per
// warpgroup, where mma.sync needs each warp to ldmatrix the whole tile
// (four reads of it a block). Q and P are the A operands in registers (the
// m16n8k16 A fragment of each warp's 16 rows); the accumulators have the
// m16n8k16 layout per 8 columns, so the mask and softmax are the mma.sync
// kernel's. K and V tiles (128 keys x 128 bytes) sit in the 128-byte
// swizzled layout that wgmma reads without bank conflicts: the 16-byte
// chunk c of row r at r * 128 + (c ^ (r % 8)) * 16, each tile 1024-byte
// aligned; K is read K-major, V MN-major (transposed by the instruction).
namespace wg {

constexpr int D = 64;
constexpr int KEYS = 128;                 // keys per tile
constexpr int STAGES = 2;                 // K/V tiles in the ring
constexpr int TILE = KEYS * 128;          // bytes of a K or V tile
constexpr int QLD = D + 8;                // Q's padded row stride (elements)
constexpr size_t SMEM = 1024 + 2 * STAGES * TILE + sizeof(bf16) * kRows * QLD;

__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// shared-memory matrix descriptor: 128-byte swizzle, 8-row groups `sbo`
// bytes apart, `lbo` the leading byte offset
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are not read or written across the asynchronous products
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128) (+)= a (64 x 16, registers) . b (16 x 128, K-major in shared memory)
__device__ __forceinline__ void qk(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace wg

__global__ void __launch_bounds__(128)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int nb, int hkv,
                   int group, int bq, int n_tiles, int s, int window, float scale, int64_t sqb,
                   int64_t sqh, int64_t sqs, int64_t skb, int64_t skh, int64_t sks, int64_t sob,
                   int64_t soh, int64_t sos) {
  using namespace wg;
  constexpr int THREADS = 128, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = attn_io::smem_addr(smem_raw);
  unsigned char* sk = smem_raw + (((raw + 1023) & ~1023u) - raw);  // K tiles, then V tiles
  unsigned char* sv = sk + STAGES * TILE;
  bf16* sq = reinterpret_cast<bf16*>(sv + STAGES * TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = nb * hkv;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / per;  // longest first
  const int kvh = static_cast<int>(blockIdx.x) % hkv;
  const int b = (static_cast<int>(blockIdx.x) / hkv) % nb;
  const int q_lo = tile * bq;
  const int rows = group * bq;  // row r = g * bq + t
  const bf16* qb = q + b * sqb + static_cast<int64_t>(kvh) * group * sqh;
  const bf16* kb = k + b * skb + kvh * skh;
  const bf16* vb = v + b * skb + kvh * skh;

  for (int i = tid; i < kRows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = q_lo + r % bq;
    const bool ok = r < rows && t < s;
    attn_io::cp_async16(sq + r * QLD + c, ok ? qb + (r / bq) * sqh + t * sqs + c : qb, ok);
  }
  auto load_kv = [&](int stage, int k_lo) {
    unsigned char* dk = sk + stage * TILE;
    unsigned char* dv = sv + stage * TILE;
    for (int i = tid; i < KEYS * CPR; i += THREADS) {
      const int j = i / CPR, c = i % CPR;
      const int kp = k_lo + j;
      const bool ok = kp < s;
      const int64_t off = ok ? kp * sks + c * 8 : 0;
      attn_io::cp_async16(dk + swizzle(j, c), kb + off, ok);
      attn_io::cp_async16(dv + swizzle(j, c), vb + off, ok);
    }
  };

  const int r0 = warp * 16 + (lane >> 2);
  const int tq[2] = {q_lo + r0 % bq, q_lo + (r0 + 8) % bq};
  const int q_last = min(q_lo + bq, s) - 1;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt_first = k_first / KEYS, kt_last = q_last / KEYS;
  const float sl2 = scale * kLog2e;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_first + i <= kt_last) load_kv(i, (kt_first + i) * KEYS);
    attn_io::cp_async_commit();
  }

  uint32_t qf[D / 16][4];
  float o[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // running max (raw scores), sum
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int stage = (kt - kt_first) % STAGES;
    if (kt + STAGES - 1 <= kt_last)
      load_kv((kt - kt_first + STAGES - 1) % STAGES, (kt + STAGES - 1) * KEYS);
    attn_io::cp_async_commit();
    attn_io::cp_async_wait<STAGES - 1>();  // this tile (and Q) have landed
    // the copies' writes are seen by the products' (asynchronous) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt == kt_first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * QLD + (lane >> 4) * 8 + kk * 16);
    }
    const uint32_t ka = attn_io::smem_addr(sk + stage * TILE);
    const uint32_t va = attn_io::smem_addr(sv + stage * TILE);

    // S = Q K^T: 64 rows x 128 keys a warpgroup; s[4j + e] is the
    // mma.sync layout's tile j, element e
    float s_[64];
    fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) qk(s_, qf[kk], desc(ka + kk * 32, 16, 1024), kk);
    commit();
    wait_all();
    hold(s_);

    const int k_lo = kt * KEYS;
    if (k_lo + KEYS - 1 > q_lo || (window > 0 && q_last - k_lo >= window)) {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k_lo + j * 8 + 2 * (lane & 3) + (e & 1);
          const int t = tq[e >> 1];
          if (!(kp <= t && (window <= 0 || t - kp < window))) s_[4 * j + e] = kNegInf;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) mx = fmaxf(mx, fmaxf(s_[4 * j + 2 * h], s_[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx((m[h] - mx) * sl2);
      m[h] = mx;
      // a row with every key so far masked: its p are 0, not 2^(rounding)
      const float msc = mx == kNegInf ? 0.f : -mx * sl2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        s_[4 * j + 2 * h] = exp2_approx(__fmaf_rn(s_[4 * j + 2 * h], sl2, msc));
        s_[4 * j + 2 * h + 1] = exp2_approx(__fmaf_rn(s_[4 * j + 2 * h + 1], sl2, msc));
        rs += s_[4 * j + 2 * h] + s_[4 * j + 2 * h + 1];
      }
      l[h] = l[h] * alpha + rs;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 2 * h] *= alpha;
        o[4 * n + 2 * h + 1] *= alpha;
      }
    }

    // O += P V, P's tiles 2kk and 2kk + 1 the A operand of keys 16 kk ..
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      pa[kk][0] = pack_bf16(s_[8 * kk], s_[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s_[8 * kk + 2], s_[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s_[8 * kk + 4], s_[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s_[8 * kk + 6], s_[8 * kk + 7]);
    }
    fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) pv(o, pa[kk], desc(va + kk * 2048, TILE, 1024));
    commit();
    wait_all();
    hold(o);
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  attn_io::cp_async_wait<0>();

  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int r = r0 + 8 * h, t = tq[h];
    if (r < rows && t < s) {
      bf16* dst = out + b * sob + static_cast<int64_t>(kvh * group + r / bq) * soh + t * sos;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / den, o[4 * n + 2 * h + 1] / den);
    }
  }
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int hkv,
                         int group, int bq, int s, int window, float scale, const int64_t* st,
                         cudaStream_t stream) {
  if (group * bq > kRows) return cudaErrorInvalidValue;
  static bool attr_set = false;  // once per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(wg::SMEM));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_tiles = (s + bq - 1) / bq;
  flash_wgmma_kernel<<<n_tiles * hkv * b, 128, wg::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), b, hkv, group, bq, n_tiles, s, window, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// ------------------------------------------------------------ fp32 kernel
constexpr int kThreads = 256;  // 16 x 16
constexpr int kKeys = 64;      // keys of a tile

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles (rows padded by 4 floats: conflict-free float4 reads of
  // 16 different rows), the V tile, the probabilities
  return sizeof(float) *
         (static_cast<size_t>(kRows) * (D + 4) + static_cast<size_t>(kKeys) * (D + 4) +
          static_cast<size_t>(kKeys) * D + static_cast<size_t>(kRows) * (kKeys + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int group, int bq, int s,
                  int window, float scale, int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,
                  int64_t skh, int64_t sks, int64_t sob, int64_t soh, int64_t sos) {
  constexpr int QS = D + 4;
  constexpr int PS = kKeys + 4;
  constexpr int V = 4;                        // floats per 16-byte load
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
  const float* qb = q + b * sqb + static_cast<int64_t>(kvh) * group * sqh;
  const float* kb = k + b * skb + kvh * skh;
  const float* vb = v + b * skb + kvh * skh;

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
    float* o = out + b * sob + static_cast<int64_t>(kvh * group + r / bq) * soh + qpos[i] * sos;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = (tx + 16 * cc) * 4;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[col + e] = acc[i][4 * cc + e] / denom;
      }
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int b, int hkv,
                        int group, int bq, int s, int window, float scale, const int64_t* st,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((s + bq - 1) / bq, hkv, b);
  flash_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), group, bq, s, window, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int, int,
                               int, int, float, const int64_t*, cudaStream_t);

int run(Launch fn, const void* q, const void* k, const void* v, void* out, int b, int hq,
        int hkv, int s, int window, float scale, int bq, long long sqb, long long sqh,
        long long sqs, long long skb, long long skh, long long sks, long long sob,
        long long soh, long long sos, void* stream) {
  if (fn == nullptr || b < 1 || s < 1 || hkv < 1 || hq % hkv || bq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqh, sqs, skb, skh, sks, sob, soh, sos};
  return static_cast<int>(fn(q, k, v, out, b, hkv, hq / hkv, bq, s, window, scale, st,
                             static_cast<cudaStream_t>(stream)));
}

Launch bf16_for(int d) {
  switch (d) {
    case 16: return launch_bf16<16>;
    case 32: return launch_bf16<32>;
    case 64: return launch_wgmma;
    case 128: return launch_bf16<128>;
    case 256: return launch_bf16<256>;
    default: return nullptr;
  }
}

template <int D>
cudaError_t launch_fp32_checked(const void* q, const void* k, const void* v, void* out, int b,
                                int hkv, int group, int bq, int s, int window, float scale,
                                const int64_t* st, cudaStream_t stream) {
  if (group * bq > kRows) return cudaErrorInvalidValue;
  return launch_fp32<D>(q, k, v, out, b, hkv, group, bq, s, window, scale, st, stream);
}

Launch fp32_for(int d) {
  switch (d) {
    case 16: return launch_fp32_checked<16>;
    case 32: return launch_fp32_checked<32>;
    case 64: return launch_fp32_checked<64>;
    case 128: return launch_fp32_checked<128>;
    case 256: return launch_fp32_checked<256>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k/v (B, Hkv, S, D), out (B, Hq, S, D), each through its
// element strides (batch, head, position; the last dimension contiguous; k
// and v share strides). bq: tokens per block, with (Hq / Hkv) * bq <= 64
// query rows. One entry point per dtype.
int glin_flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int b,
                              int hq, int hkv, int s, int d, int window, float scale, int bq,
                              long long sqb, long long sqh, long long sqs, long long skb,
                              long long skh, long long sks, long long sob, long long soh,
                              long long sos, void* stream) {
  return run(bf16_for(d), q, k, v, out, b, hq, hkv, s, window, scale, bq, sqb, sqh, sqs, skb,
             skh, sks, sob, soh, sos, stream);
}

int glin_flash_attention_fp32(const void* q, const void* k, const void* v, void* out, int b,
                              int hq, int hkv, int s, int d, int window, float scale, int bq,
                              long long sqb, long long sqh, long long sqs, long long skb,
                              long long skh, long long sks, long long sob, long long soh,
                              long long sos, void* stream) {
  return run(fp32_for(d), q, k, v, out, b, hq, hkv, s, window, scale, bq, sqb, sqh, sqs, skb,
             skh, sks, sob, soh, sos, stream);
}

// dynamic shared memory of the bf16 kernel's block at head dim d (0 for a
// head dim it does not take)
int glin_flash_attention_bf16_smem(int d) {
  switch (d) {
    case 16: return static_cast<int>(MmaTile<16>::SMEM);
    case 32: return static_cast<int>(MmaTile<32>::SMEM);
    case 64: return static_cast<int>(wg::SMEM);
    case 128: return static_cast<int>(MmaTile<128>::SMEM);
    case 256: return static_cast<int>(MmaTile<256>::SMEM);
    default: return 0;
  }
}

}  // extern "C"
