// Flash-attention backward (dQ, dK, dV; causal or not, GQA) over contiguous
// Q/K/V, for Hopper (sm_90a), plain C interface.
//
// The reference has no backward kernel: every config trains with
// attention_impl="flash_xla" and differentiates the XLA scan
// (src/repro/models/layers.py:99).  The port's forward on the card is the
// hand-written kernel of flash_attention.cu (which replaces
// `flash_attention_pallas`, src/repro/kernels/flash_attention/kernel.py:64),
// so training needs this gradient of it.  It is held against the plain
// version (kernels/flash_attention/ops.py `flash_attention_backward_plain`,
// itself held against autograd over `flash_attention_plain`).
//
// q (b, sq, hq, d); k, v (b, skv, hkv, d); o, dO (b, sq, hq, d), all of one
// type; lse (b, hq, sq) f32, the forward's m + log(l) (-inf for a row that
// sees no key).  dq, dk, dv come out in q's type.  With P = exp(S - lse)
// the softmax of the scaled scores S = q k^T / sqrt(d), masked as the
// forward masks:
//   D = rowsum(dO o), dV = P^T dO, dS = P (dO v^T - D),
//   dQ = dS k / sqrt(d), dK = dS^T q / sqrt(d),
// dK and dV summed over the query group of their kv head.
//
// FlashAttention-2's split, deterministic (no atomics: every output element
// is summed by one thread in a fixed order, so a rerun gives the same bits):
//   (a) `dsum_kernel`: D in f32, one warp per (batch row, query, head).
//   (b) dK/dV: one block per 64-key tile (bf16; 32 keys in f32) of one
//       (batch row, kv head) and, in bf16, one column half of dK and dV
//       past head dim 128 (below).  It walks the packed query rows (query
//       position, group member: the forward's packing) that see the tile,
//       32 at a time, recomputes S^T, P^T and dP^T = V dO^T, and sums
//       dV += P^T dO and dK += dS^T Q in registers, so the GQA group is
//       summed inside the block.  The causal walk starts at the first query
//       that sees the tile's first key.
//   (c) dQ: one block per 64 packed query rows (bf16; 32 query rows of one
//       head in f32) and column half, the forward's grid; it walks the K/V
//       tiles up to the causal bound through a 2-stage cp.async ring and
//       sums dQ += dS K.
// Past head dim 128 the bf16 blocks split their output columns: the
// accumulators of dK and dV (and of dQ) take d / 2 f32 registers a thread
// each at width d, which at d 160 and over would not fit beside the score
// tiles without spilling.  So the grid's z holds two column halves
// (`col_splits`), and a block sums only its d / 2 output columns while it
// still loads full-width Q, dO, K and V and recomputes S and dP over all
// of d (both reduce over it): the two halves recompute the scores twice,
// for the same registers per thread as at d / 2 <= 128.
// S, P and dS are f32; in bf16, P and dS are rounded to bf16 before the
// tensor-core products (mma.sync m16n8k16, bf16 in, f32 out), as the
// forward rounds p before P V.  f32 runs on CUDA cores (tensor cores
// would make it TF32, which the port never uses).  Masked elements, rows
// past the packed rows and rows whose lse is -inf give P = 0, so a row
// that sees no key gets zero gradient, never NaN.
//
// Bound: the backward does 2.5x the forward's FLOPs (S recomputed, dP, dV,
// dK, dQ: five d-deep products against the forward's two), halved when
// causal, on reads of q, k, v, o, dO and lse and writes of dq, dk, dv; at
// internlm2's training shape (s 2048) that is far above the card's ~295
// flop/byte ridge, so the tensor cores bound it.
//
// Known limits, left for later work: no wgmma or TMA; bf16 head dims are
// multiples of 16 up to 128 and of 32 from 160 to 256 (a column half must
// be a multiple of 16); past 128 both halves recompute S and dP; the dK/dV
// kernel reloads its K and V fragments from shared memory for every query
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_fab {

constexpr int kThreads = 128;   // 4 warps
enum DTypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------- (a) D = rowsum(dO o)

// one warp per row of (b, sq, hq); dsum is (b, hq, sq)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
            long long n_rows, int sq, int hq, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(orow[c]), to_f(drow[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long per_b = (long long)sq * hq;
    const long long bi = row / per_b;
    const long long rem = row - bi * per_b;
    const long long qi = rem / hq, h = rem - qi * hq;
    dsum[(bi * hq + h) * sq + qi] = acc;
  }
}

// ------------------------------------------------ tensor-core design (bf16)

namespace tc {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;     // dK/dV: keys per block, 16 per warp
constexpr int kQ = 32;        // dK/dV: packed query rows per step
constexpr int kRows = 64;     // dQ: packed query rows per block, 16 per warp
constexpr int kTok = 64;      // dQ: keys per K/V tile
constexpr int kStages = 2;    // cp.async rings
constexpr int kPad = 8;       // bf16 elements of row padding (16 bytes)

__host__ __device__ constexpr int ld(int d) { return d + kPad; }

// column halves of the output per block row (grid z): 1 up to d 128, 2
// past it, each of d / 2 columns; mirrored by kernels/flash_attention/ops.py
// `bwd_col_splits`
__host__ __device__ constexpr int col_splits(int d) { return d <= 128 ? 1 : 2; }

// Shared memory, mirrored by kernels/flash_attention/ops.py
// `bwd_smem_bytes`: K and V [64][d + 8], the Q and dO ring [2][32][d + 8]
// bf16, then the ring's lse and D [2][32] f32.
__host__ __device__ constexpr size_t dkdv_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(2 * kKeys + 2 * kStages * kQ) * ld(d) +
         sizeof(float) * 2 * kStages * kQ;
}

// Q and dO [64][d + 8], then the K/V ring [2][64][d + 8], bf16
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(2 * kRows + 2 * kStages * kTok) * ld(d);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int hq,
               int hkv, int q_offset, int causal) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;     // 16-byte copies per row
  constexpr int NT = kQ / 8;     // S^T n-tiles per warp (query columns)
  constexpr int DC = D / col_splits(D);   // the block's output columns
  constexpr int OT = DC / 8;     // dK / dV n-tiles per warp
  static_assert(DC % 16 == 0, "a column half is a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeys * LD;
  bf16* qs = vs + kKeys * LD;                 // [2][kQ][LD]
  bf16* dos = qs + kStages * kQ * LD;         // [2][kQ][LD]
  float* lses = reinterpret_cast<float*>(dos + kStages * kQ * LD);   // [2][kQ]
  float* dss = lses + kStages * kQ;                                   // [2][kQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int rows = sq * group;
  const int t0 = blockIdx.y * kKeys;
  // the block's first output column (0, as a constant, without a split)
  const int c0 = col_splits(D) > 1 ? static_cast<int>(blockIdx.z) * DC : 0;
  // the first packed row that sees the tile's first key: q_offset + qi >= t0
  const int r_begin = causal ? min(rows, max(0, t0 - q_offset) * group) : 0;
  const int n_q = (rows - r_begin + kQ - 1) / kQ;

  const long long tok_stride = (long long)hkv * D;
  const bf16* kb = k + ((long long)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((long long)b * skv * hkv + hk) * D;
  // the block's K/V tile; keys past skv are zeros
  for (int i = tid; i < kKeys * CPR; i += kThreads) {
    const int tt = i / CPR, e = (i - tt * CPR) * 8;
    const bool live = t0 + tt < skv;
    const long long off = (live ? t0 + tt : 0) * tok_stride + e;
    cp_async16(ks + tt * LD + e, kb + off, live);
    cp_async16(vs + tt * LD + e, vb + off, live);
  }

  // Q, dO, lse and D of query step j into ring stage s; rows past the
  // packed rows are zeros (lse and D plain loads: the packed rows of a
  // step are not contiguous in (b, hq, sq))
  auto issue = [&](int j, int s) {
    const int rq0 = r_begin + j * kQ;
    bf16* qd = qs + s * kQ * LD;
    bf16* dd = dos + s * kQ * LD;
    for (int i = tid; i < kQ * CPR; i += kThreads) {
      const int r = i / CPR, e = (i - r * CPR) * 8;
      const int rr = rq0 + r;
      const bool live = rr < rows;
      long long off = 0;
      if (live) {
        const int qi = rr / group, gi = rr - qi * group;
        off = (((long long)b * sq + qi) * hq + hk * group + gi) * D + e;
      }
      cp_async16(qd + r * LD + e, q + off, live);
      cp_async16(dd + r * LD + e, dout + off, live);
    }
    if (tid < kQ) {
      const int rr = rq0 + tid;
      float lv = -CUDART_INF_F, dv_ = 0.f;
      if (rr < rows) {
        const int qi = rr / group, gi = rr - qi * group;
        const long long idx = ((long long)b * hq + hk * group + gi) * sq + qi;
        lv = lse[idx];
        dv_ = dsum[idx];
      }
      lses[s * kQ + tid] = lv;
      dss[s * kQ + tid] = dv_;
    }
  };

  if (n_q > 0) issue(0, 0);
  cp_async_commit();

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const int g = lane >> 2, qd = lane & 3;
  // this thread's two keys: rows g and g + 8 of its warp's 16
  const int key0 = t0 + warp * 16 + g, key1 = key0 + 8;

  for (int j = 0; j < n_q; ++j) {
    const int s = j & 1;
    if (j + 1 < n_q) issue(j + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int rq0 = r_begin + j * kQ;
    const bf16* qt = qs + s * kQ * LD;
    const bf16* dt = dos + s * kQ * LD;
    const float* lt = lses + s * kQ;
    const float* Dt = dss + s * kQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 packed rows per warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ks + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
      ldsm_x4(av, vs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        // (rows 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        const int boff = (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                         ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qt + boff);
        ldsm_x4(bd, dt + boff);
        mma_bf16(st[2 * nn], ak, bq[0], bq[1]);
        mma_bf16(st[2 * nn + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[2 * nn], av, bd[0], bd[1]);
        mma_bf16(dpt[2 * nn + 1], av, bd[2], bd[3]);
      }
    }

    // P^T and dS^T = P^T (dP^T - D), in place (element e of n-tile n: key
    // row g + 8 (e / 2), packed row rq0 + 8 n + 2 qd + e % 2)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = n * 8 + 2 * qd + c2;
        const int rr = rq0 + c;
        const float lv = lt[c], dd = Dt[c];
        // the last key this row sees (rows past the packed rows: none)
        const int lim = rr >= rows || lv == -CUDART_INF_F
                            ? -1
                            : (causal ? min(skv - 1, q_offset + rr / group) : skv - 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 2 * hh + c2;
          const int key = hh ? key1 : key0;
          const float p = key <= lim ? __expf(st[n][e] * scale - lv) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dd);
        }
      }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the C fragments of two
    // n-tiles are the A fragment of one 16-row step
#pragma unroll
    for (int kt2 = 0; kt2 < NT / 2; ++kt2) {
      uint32_t ap[4], ad[4];
      ap[0] = pack_bf16(st[2 * kt2][0], st[2 * kt2][1]);
      ap[1] = pack_bf16(st[2 * kt2][2], st[2 * kt2][3]);
      ap[2] = pack_bf16(st[2 * kt2 + 1][0], st[2 * kt2 + 1][1]);
      ap[3] = pack_bf16(st[2 * kt2 + 1][2], st[2 * kt2 + 1][3]);
      ad[0] = pack_bf16(dpt[2 * kt2][0], dpt[2 * kt2][1]);
      ad[1] = pack_bf16(dpt[2 * kt2][2], dpt[2 * kt2][3]);
      ad[2] = pack_bf16(dpt[2 * kt2 + 1][0], dpt[2 * kt2 + 1][1]);
      ad[3] = pack_bf16(dpt[2 * kt2 + 1][2], dpt[2 * kt2 + 1][3]);
#pragma unroll
      for (int dn = 0; dn < OT / 2; ++dn) {
        // (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        const int toff = (kt2 * 16 + (lane & 15)) * LD + c0 + dn * 16 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, dt + toff);
        ldsm_x4_trans(bq, qt + toff);
        mma_bf16(dva[2 * dn], ap, bo[0], bo[1]);
        mma_bf16(dva[2 * dn + 1], ap, bo[2], bo[3]);
        mma_bf16(dka[2 * dn], ad, bq[0], bq[1]);
        mma_bf16(dka[2 * dn + 1], ad, bq[2], bq[3]);
      }
    }
    // every warp is done with stage s before the next iteration refills it
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: every key of the tile below skv, zeros where no row saw it
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = hh ? key1 : key0;
    if (key >= skv) continue;
    const long long base = (((long long)b * skv + key) * hkv + hk) * D + c0 + 2 * qd;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * hh] * scale, dka[n][2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * hh], dva[n][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dq, int sq, int skv, int hq, int hkv, int q_offset,
             int causal) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;
  constexpr int NT = kTok / 8;   // score n-tiles per warp
  constexpr int DC = D / col_splits(D);   // the block's output columns
  constexpr int OT = DC / 8;     // dQ n-tiles per warp
  static_assert(DC % 16 == 0, "a column half is a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * LD;
  bf16* ks = dos + kRows * LD;
  bf16* vs = ks + kStages * kTok * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int rows = sq * group;
  // causal: the last packed tile walks the most keys, and runs first
  const int z = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = z * kRows;
  // the block's first output column (0, as a constant, without a split)
  const int c0 = col_splits(D) > 1 ? static_cast<int>(blockIdx.z) * DC : 0;
  const int r_last = min(r0 + kRows, rows) - 1;
  const int kv_end = causal ? min(skv, q_offset + r_last / group + 1) : skv;
  const int n_kv = (kv_end + kTok - 1) / kTok;

  const int g = lane >> 2, qd = lane & 3;
  // this thread's two rows, the last key each sees (-1: none), lse and D
  int lim[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r0 + warp * 16 + g + 8 * hh;
    lim[hh] = -1;
    lrow[hh] = 0.f;
    drow[hh] = 0.f;
    if (rr < rows) {
      const int qi = rr / group, gi = rr - qi * group;
      const long long idx = ((long long)b * hq + hk * group + gi) * sq + qi;
      lrow[hh] = lse[idx];
      drow[hh] = dsum[idx];
      if (lrow[hh] != -CUDART_INF_F)
        lim[hh] = causal ? min(skv - 1, q_offset + qi) : skv - 1;
    }
  }
  const int lim_lo = causal ? min(skv - 1, q_offset + r0 / group) : skv - 1;
  // the warp's last key: tiles past it are skipped (dead rows have -1)
  int warp_lim = max(lim[0], lim[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    warp_lim = max(warp_lim, __shfl_xor_sync(0xffffffffu, warp_lim, off));

  const long long tok_stride = (long long)hkv * D;
  const bf16* kb = k + ((long long)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((long long)b * skv * hkv + hk) * D;

  auto issue = [&](int j, int s) {
    const int t0 = j * kTok;
    bf16* kd = ks + s * kTok * LD;
    bf16* vd = vs + s * kTok * LD;
    for (int i = tid; i < kTok * CPR; i += kThreads) {
      const int tt = i / CPR, e = (i - tt * CPR) * 8;
      const bool live = t0 + tt < kv_end;
      const long long off = (live ? t0 + tt : 0) * tok_stride + e;
      cp_async16(kd + tt * LD + e, kb + off, live);
      cp_async16(vd + tt * LD + e, vb + off, live);
    }
  };

  // prologue: Q and dO (rows past the packed rows are zeros) with tile 0
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, e = (i - r * CPR) * 8;
    const int rr = r0 + r;
    long long off = 0;
    if (rr < rows) {
      const int qi = rr / group, gi = rr - qi * group;
      off = (((long long)b * sq + qi) * hq + hk * group + gi) * D + e;
    }
    cp_async16(qs + r * LD + e, q + off, rr < rows);
    cp_async16(dos + r * LD + e, dout + off, rr < rows);
  }
  if (n_kv > 0) issue(0, 0);
  cp_async_commit();

  float dqa[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1;
    if (j + 1 < n_kv) issue(j + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int kv0 = j * kTok;
    if (kv0 <= warp_lim) {
      const bf16* kt = ks + s * kTok * LD;
      const bf16* vt = vs + s * kTok * LD;

      // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t aq[4], ao[4];
        const int aoff = (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8;
        ldsm_x4(aq, qs + aoff);
        ldsm_x4(ao, dos + aoff);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          // (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          const int boff = (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                           ((lane >> 3) & 1) * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, kt + boff);
          ldsm_x4(bv, vt + boff);
          mma_bf16(sc[2 * nn], aq, bk[0], bk[1]);
          mma_bf16(sc[2 * nn + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * nn], ao, bv[0], bv[1]);
          mma_bf16(dp[2 * nn + 1], ao, bv[2], bv[3]);
        }
      }

      // P and dS = P (dP - D) in place (element e of n-tile n: row g +
      // 8 (e / 2), key kv0 + 8 n + 2 qd + e % 2); only tiles that cross a
      // row's limit test the keys
      const bool masked = kv0 + kTok - 1 > lim_lo || lim[0] < 0 || lim[1] < 0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int key = kv0 + n * 8 + 2 * qd + (e & 1);
          const float p =
              !masked || key <= lim[hh] ? __expf(sc[n][e] * scale - lrow[hh]) : 0.f;
          sc[n][e] = p * (dp[n][e] - drow[hh]);
        }

      // dQ += bf16(dS) K (K by ldmatrix.trans)
#pragma unroll
      for (int kt2 = 0; kt2 < NT / 2; ++kt2) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kt2][0], sc[2 * kt2][1]);
        a[1] = pack_bf16(sc[2 * kt2][2], sc[2 * kt2][3]);
        a[2] = pack_bf16(sc[2 * kt2 + 1][0], sc[2 * kt2 + 1][1]);
        a[3] = pack_bf16(sc[2 * kt2 + 1][2], sc[2 * kt2 + 1][3]);
#pragma unroll
        for (int dn = 0; dn < OT / 2; ++dn) {
          uint32_t bk[4];   // (keys 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(bk, kt + (kt2 * 16 + (lane & 15)) * LD + c0 + dn * 16 +
                                (lane >> 4) * 8);
          mma_bf16(dqa[2 * dn], a, bk[0], bk[1]);
          mma_bf16(dqa[2 * dn + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r0 + warp * 16 + g + 8 * hh;
    if (rr >= rows) continue;
    const int qi = rr / group, gi = rr - qi * group;
    bf16* drow_out =
        dq + (((long long)b * sq + qi) * hq + hk * group + gi) * D + c0 + 2 * qd;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow_out + n * 8) =
          __floats2bfloat162_rn(dqa[n][2 * hh] * scale, dqa[n][2 * hh + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dsum, void* dq, void* dk, void* dv, int b,
                   int sq, int skv, int hq, int hkv, int q_offset, int causal,
                   cudaStream_t stream) {
  const size_t s1 = dkdv_smem_bytes(D), s2 = dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  dkdv_tc_kernel<D><<<dim3(b * hkv, (skv + kKeys - 1) / kKeys, col_splits(D)), kThreads, s1,
                      stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, skv, hq, hkv, q_offset, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (sq * (hq / hkv) + kRows - 1) / kRows;
  dq_tc_kernel<D><<<dim3(b * hkv, tiles, col_splits(D)), kThreads, s2, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dq), sq, skv, hq, hkv,
      q_offset, causal);
  return cudaGetLastError();
}

// head dims 16, 32, ..., 128, then 160, 192, 224, 256 (column halves of
// 80 ... 128), each its own register layout
template <int D = 16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dsum, void* dq, void* dk, void* dv, int b,
                     int sq, int skv, int hq, int hkv, int d, int q_offset, int causal,
                     cudaStream_t stream) {
  if (d == D)
    return launch<D>(q, k, v, dout, lse, dsum, dq, dk, dv, b, sq, skv, hq, hkv, q_offset,
                     causal, stream);
  if constexpr (D < 256)
    return dispatch<(D < 128 ? D + 16 : D + 32)>(q, k, v, dout, lse, dsum, dq, dk, dv, b,
                                                 sq, skv, hq, hkv, d, q_offset, causal,
                                                 stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ------------------------------------------------- CUDA-core design (f32)

namespace f32 {

constexpr int kB = 32;        // keys per dK/dV block, rows per step and per dQ block
constexpr int kPadF = 4;      // row padding of the d-wide tiles
constexpr int kLdS = kB + 1;  // row stride of the 32 x 32 score tiles

__host__ __device__ inline size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// dK/dV: K, V, Q, dO, dK, dV [32][d + 4]; P^T, dS^T [32][33]; lse, D [32].
// dQ: Q, dO, K, V, dQ [32][d + 4]; dS [32][33]; lse, D [32].  Mirrored by
// kernels/flash_attention/ops.py `bwd_smem_bytes`.
__host__ __device__ inline size_t smem_bytes(int d, int tiles, int score_tiles) {
  return tiles * round128(sizeof(float) * kB * (d + kPadF)) +
         score_tiles * round128(sizeof(float) * kB * kLdS) + 2 * round128(sizeof(float) * kB);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// `rows` rows of d floats into shared memory at stride ld, row r read from
// src + offset(r) (a row whose offset is negative is zeros); d % 4 == 0
template <typename Off>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int d,
                                          Off offset) {
  const int per_row = d / 4;
  for (int i = threadIdx.x; i < kB * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    const long long off = offset(r);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0) val = *reinterpret_cast<const float4*>(src + off + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int hq,
                int hkv, int d, int q_offset, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + kPadF;
  const size_t tile = round128(sizeof(float) * kB * ldt);
  const size_t stile = round128(sizeof(float) * kB * kLdS);
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + tile);
  float* qs = reinterpret_cast<float*>(smem + 2 * tile);
  float* dos = reinterpret_cast<float*>(smem + 3 * tile);
  float* dks = reinterpret_cast<float*>(smem + 4 * tile);
  float* dvs = reinterpret_cast<float*>(smem + 5 * tile);
  float* ps = reinterpret_cast<float*>(smem + 6 * tile);
  float* dss = reinterpret_cast<float*>(smem + 6 * tile + stile);
  float* ls = reinterpret_cast<float*>(smem + 6 * tile + 2 * stile);
  float* Ds = ls + 32;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int rows = sq * group;
  const int t0 = blockIdx.y * kB;
  const float scale = 1.f / sqrtf(static_cast<float>(d));

  load_rows(ks, ldt, k, d, [&](int r) -> long long {
    return t0 + r < skv ? (((long long)b * skv + t0 + r) * hkv + hk) * d : -1;
  });
  load_rows(vs, ldt, v, d, [&](int r) -> long long {
    return t0 + r < skv ? (((long long)b * skv + t0 + r) * hkv + hk) * d : -1;
  });
  for (int i = tid; i < kB * ldt; i += kThreads) dks[i] = dvs[i] = 0.f;
  const int r_begin = causal ? min(rows, max(0, t0 - q_offset) * group) : 0;

  for (int rq0 = r_begin; rq0 < rows; rq0 += kB) {
    auto row_off = [&](int r) -> long long {
      const int rr = rq0 + r;
      if (rr >= rows) return -1;
      const int qi = rr / group, gi = rr - qi * group;
      return (((long long)b * sq + qi) * hq + hk * group + gi) * d;
    };
    load_rows(qs, ldt, q, d, row_off);
    load_rows(dos, ldt, dout, d, row_off);
    if (tid < kB) {
      const int rr = rq0 + tid;
      float lv = -CUDART_INF_F, dd = 0.f;
      if (rr < rows) {
        const int qi = rr / group, gi = rr - qi * group;
        const long long idx = ((long long)b * hq + hk * group + gi) * sq + qi;
        lv = lse[idx];
        dd = dsum[idx];
      }
      ls[tid] = lv;
      Ds[tid] = dd;
    }
    __syncthreads();
    // P^T and dS^T: one (key, packed row) pair per thread per pass
    for (int i = tid; i < kB * kB; i += kThreads) {
      const int r = i / kB, c = i - r * kB;
      const int key = t0 + r, rr = rq0 + c;
      bool ok = key < skv && rr < rows && ls[c] != -CUDART_INF_F;
      if (ok && causal) ok = key <= q_offset + rr / group;
      float p = 0.f, ds = 0.f;
      if (ok) {
        p = expf(dot(ks + r * ldt, qs + c * ldt, d) * scale - ls[c]);
        ds = p * (dot(vs + r * ldt, dos + c * ldt, d) - Ds[c]);
      }
      ps[r * kLdS + c] = p;
      dss[r * kLdS + c] = ds;
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
    for (int i = tid; i < kB * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      float av = dvs[r * ldt + c], ak = dks[r * ldt + c];
      for (int t = 0; t < kB; ++t) {
        av = fmaf(ps[r * kLdS + t], dos[t * ldt + c], av);
        ak = fmaf(dss[r * kLdS + t], qs[t * ldt + c], ak);
      }
      dvs[r * ldt + c] = av;
      dks[r * ldt + c] = ak;
    }
    __syncthreads();
  }

  for (int i = tid; i < kB * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    if (t0 + r >= skv) continue;
    const long long off = (((long long)b * skv + t0 + r) * hkv + hk) * d + c;
    dk[off] = dks[r * ldt + c] * scale;
    dv[off] = dvs[r * ldt + c];
  }
}

__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, int sq, int skv, int hq, int hkv, int d, int q_offset,
              int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + kPadF;
  const size_t tile = round128(sizeof(float) * kB * ldt);
  const size_t stile = round128(sizeof(float) * kB * kLdS);
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + tile);
  float* ks = reinterpret_cast<float*>(smem + 2 * tile);
  float* vs = reinterpret_cast<float*>(smem + 3 * tile);
  float* dqs = reinterpret_cast<float*>(smem + 4 * tile);
  float* dss = reinterpret_cast<float*>(smem + 5 * tile);
  float* ls = reinterpret_cast<float*>(smem + 5 * tile + stile);
  float* Ds = ls + 32;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int n_rows = min(kB, sq - q0);
  const float scale = 1.f / sqrtf(static_cast<float>(d));

  auto qrow = [&](int r) -> long long {
    return r < n_rows ? (((long long)b * sq + q0 + r) * hq + h) * d : -1;
  };
  load_rows(qs, ldt, q, d, qrow);
  load_rows(dos, ldt, dout, d, qrow);
  for (int i = tid; i < kB * ldt; i += kThreads) dqs[i] = 0.f;
  if (tid < kB) {
    float lv = -CUDART_INF_F, dd = 0.f;
    if (tid < n_rows) {
      const long long idx = ((long long)b * hq + h) * sq + q0 + tid;
      lv = lse[idx];
      dd = dsum[idx];
    }
    ls[tid] = lv;
    Ds[tid] = dd;
  }
  // the causal walk stops at the last key the tile's last row can see
  const int kv_end = causal ? min(skv, q0 + n_rows + q_offset) : skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kB) {
    auto krow = [&](int r) -> long long {
      return kv0 + r < skv ? (((long long)b * skv + kv0 + r) * hkv + hk) * d : -1;
    };
    load_rows(ks, ldt, k, d, krow);
    load_rows(vs, ldt, v, d, krow);
    __syncthreads();
    for (int i = tid; i < kB * kB; i += kThreads) {
      const int r = i / kB, t = i - r * kB;
      const int key = kv0 + t;
      bool ok = key < skv && r < n_rows && ls[r] != -CUDART_INF_F;
      if (ok && causal) ok = key <= q0 + r + q_offset;
      float ds = 0.f;
      if (ok) {
        const float p = expf(dot(qs + r * ldt, ks + t * ldt, d) * scale - ls[r]);
        ds = p * (dot(dos + r * ldt, vs + t * ldt, d) - Ds[r]);
      }
      dss[r * kLdS + t] = ds;
    }
    __syncthreads();
    for (int i = tid; i < kB * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      float a = dqs[r * ldt + c];
      for (int t = 0; t < kB; ++t) a = fmaf(dss[r * kLdS + t], ks[t * ldt + c], a);
      dqs[r * ldt + c] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < n_rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dq[(((long long)b * sq + q0 + r) * hq + h) * d + c] = dqs[r * ldt + c] * scale;
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dsum, void* dq, void* dk, void* dv, int b,
                   int sq, int skv, int hq, int hkv, int d, int q_offset, int causal,
                   cudaStream_t stream) {
  const size_t s1 = smem_bytes(d, 6, 2), s2 = smem_bytes(d, 5, 1);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  dkdv_f32_kernel<<<dim3(b * hkv, (skv + kB - 1) / kB), kThreads, s1, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dk), static_cast<float*>(dv), sq, skv, hq, hkv, d, q_offset, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<<<dim3((sq + kB - 1) / kB, b * hq), kThreads, s2, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dq), sq, skv, hq, hkv, d, q_offset, causal);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace repro_fab

// q (b, sq, hq, d), k and v (b, skv, hkv, d), o, dout and dq (b, sq, hq, d),
// dk and dv (b, skv, hkv, d), all f32 or all bf16 (dtype code 0 / 1),
// contiguous and 16-byte aligned; lse and dsum (b, hq, sq) f32, dsum
// scratch written here; d a multiple of 16 up to 128 or (bf16) of 32 up to
// 256, (f32) of 16 up to 256; sq, skv > 0.  Three
// launches on `stream`: D, then dK/dV, then dQ.  Returns the first CUDA
// error.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dsum, void* dq, void* dk, void* dv, int b,
                                         int sq, int skv, int hq, int hkv, int d, int q_offset,
                                         int causal, int dtype, void* stream) {
  using namespace repro_fab;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)b * sq * hq;
  const dim3 grid(static_cast<unsigned>((n_rows + kThreads / 32 - 1) / (kThreads / 32)));
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == kBF16) {
    dsum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), ds,
        n_rows, sq, hq, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(tc::dispatch(q, k, v, dout, l, ds, dq, dk, dv, b, sq, skv, hq,
                                         hkv, d, q_offset, causal, s));
  }
  if (dtype == kF32) {
    dsum_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(o),
                                                 static_cast<const float*>(dout), ds, n_rows,
                                                 sq, hq, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(f32::launch(q, k, v, dout, l, ds, dq, dk, dv, b, sq, skv, hq, hkv,
                                        d, q_offset, causal, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
