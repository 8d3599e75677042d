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
// is summed by one thread, or by the reduce below, in a fixed order, so a
// rerun gives the same bits):
//   (a) `dsum_kernel`: D in f32, one warp per (batch row, query, head).
//   (b) dK/dV: one block per key tile of one (batch row, kv head).  It
//       walks the packed query rows (query position, group member: the
//       forward's packing) that see the tile, recomputes S^T, P^T and dP^T
//       = V dO^T, and sums dV += P^T dO and dK += dS^T Q in registers, so
//       the GQA group is summed inside the block.  The causal walk starts
//       at the first query that sees the tile's first key.
//   (c) dQ: one block per tile of packed query rows; it walks the K/V
//       tiles up to the causal bound and sums dQ += dS K; causal blocks
//       run longest walk first.
// S, P and dS are f32; in bf16, P and dS are rounded to bf16 before the
// tensor-core products (bf16 in, f32 out), as the forward rounds p before
// P V.  Masked elements, rows past the packed rows and rows whose lse is
// -inf give P = 0, so a row that sees no key gets zero gradient, never NaN.
//
// bf16 has two designs, chosen by the head dim alone (ops.py `bwd_design`):
// * d 64, 80, 96, 112, 128 (`namespace wg`): wgmma.  A block is two
//   consumer warpgroups and one producer warpgroup (setmaxnreg gives the
//   consumers 232 registers, the producers 40).  The producer streams its
//   operands through a 3-stage ring of 128-byte-swizzled shared-memory
//   tiles by cp.async, each stage's arrival and release tracked by
//   mbarriers.  dK/dV: a block owns 128 keys (64 a warpgroup) with K and V
//   loaded once; each 64-row step's S^T = K Q^T and dP^T = V dO^T are SS
//   wgmma (m64n64k16), and dV += P^T dO and dK += dS^T Q are RS wgmma whose
//   A is the previous product's accumulator, rounded to bf16 in registers,
//   and whose B is the same Q / dO tile read down its rows (MN-major): one
//   copy of a step's tiles feeds both warpgroups and all four products.
//   dQ: a block owns 128 packed rows (64 a warpgroup), holds their Q and
//   dO as A fragments, and walks 64-key K/V tiles: S and dP as RS wgmma, dQ
//   += dS K with K read down its rows.  When the key tiles alone give
//   fewer than two blocks an SM (a large GQA group at a small batch), each
//   tile's walk is split over `splits` blocks (grid y = tile * splits +
//   chunk, equal shares of its steps), which write f32 partials; the
//   reduce kernel sums them in chunk order and rounds each sum once.
//   Head dims 80, 96 and 112 pad the tiles to 128 columns with zeros.
// * the rest (16, 32, 48, 160 ... 256; `namespace tc`): mma.sync m16n8k16
//   from ldmatrix fragments, 4 warps a block.  dK/dV blocks of 64 keys walk
//   32 packed rows a step, dQ blocks of 64 rows walk 64-key tiles, both
//   through 2-stage cp.async rings.  Past head dim 128 the blocks split
//   their output columns: the accumulators of dK and dV (and of dQ) take
//   d / 2 f32 registers a thread each at width d, which at d 160 and over
//   would not fit beside the score tiles without spilling.  So the grid's
//   z holds two column halves (`col_splits`), and a block sums only its
//   d / 2 output columns while it still loads full-width Q, dO, K and V
//   and recomputes S and dP over all of d (both reduce over it).
// f32 runs on CUDA cores (tensor cores would make it TF32, which the port
// never uses).
//
// Bound: the backward does 2.5x the forward's FLOPs (S recomputed, dP, dV,
// dK, dQ: five d-deep products against the forward's two), halved when
// causal, on reads of q, k, v, o, dO and lse and writes of dq, dk, dv; at
// internlm2's training shape (s 2048) that is far above the card's ~295
// flop/byte ridge, so the tensor cores bound it.  The split adds two
// products (dQ recomputes S and dP); the wgmma design runs the seven at
// ~420 TFLOP/s at internlm2's training microbatch on an H100 SXM (80 GB,
// 700 W).
//
// Known limits, left for later work: cp.async, not TMA (a packed tile
// starts at any row of a query position's group); head dims past 128 and
// below 64 stay on mma.sync, and past 128 both column halves recompute S
// and dP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace repro_fab {

constexpr int kThreads = 128;   // 4 warps
enum DTypeCode { kF32 = 0, kBF16 = 1 };
// the passes of one call, bits of `passes` (mirrored by
// kernels/flash_attention/ops.py `BWD_PASSES`): D, dK/dV, the group
// split's reduce, dQ
enum Pass { kPassD = 1, kPassDkdv = 2, kPassReduce = 4, kPassDq = 8 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// four consecutive elements as floats (8 bytes of bf16, 16 of f32)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ---------------------------------------------------- (a) D = rowsum(dO o)

// one warp per row of (b, sq, hq), four elements a lane at a time (d is a
// multiple of 16); dsum is (b, hq, sq)
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
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 x = load4(orow + c), y = load4(drow + c);
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long per_b = (long long)sq * hq;
    const long long bi = row / per_b;
    const long long rem = row - bi * per_b;
    const long long qi = rem / hq, h = rem - qi * hq;
    dsum[(bi * hq + h) * sq + qi] = acc;
  }
}

// ------------------------------------------- wgmma design (bf16, d 64, 128)

namespace wg {

using namespace ::repro_wg;
using ::repro_mma::cp_async16;
using ::repro_mma::cp_async_commit;
using ::repro_mma::cp_async_wait;
using ::repro_mma::ldsm_x4;
using ::repro_mma::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                      // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);   // and one producer warpgroup
constexpr int kKeys = 64 * kConsumers;   // dK/dV: keys per block, 64 per warpgroup
constexpr int kQ = 64;                   // dK/dV: packed query rows per step
constexpr int kRows = 64 * kConsumers;   // dQ: packed query rows per block
constexpr int kTok = 64;                 // dQ: keys per K/V tile
// registers a thread after setmaxnreg: ptxas gives each of the block's
// 384 threads 168 at entry (65536 / 384), the producers give back 128 each
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "setmaxnreg asks more registers than the block holds");
constexpr float kLog2e = 1.4426950408889634f;

// the head dims this design takes, multiples of 16 from 64 to 192 (the
// dispatch offers it 64 ... 128, 160 and 192); mirrored by
// kernels/flash_attention/ops.py `bwd_design`.  A tile is whole 64-column
// panels: d 80, 96, 112 and 160 fill the last one with zero columns
// (`padded`), which the products over d skip and dK, dV and dQ leave
// unstored
__host__ __device__ constexpr bool takes(int d) { return d % 16 == 0 && d >= 64 && d <= 192; }
__host__ __device__ constexpr int padded(int d) { return (d + 63) / 64 * 64; }
// Past 128 columns a consumer cannot hold both dK and dV (2 x 96 f32)
// beside S^T and dP^T: each dK/dV tile takes two blocks (grid z), one
// summing dV (from S^T alone), one dK, and the ring has 2 stages, not 3,
// to fit shared memory.  dQ keeps Q and dO in shared memory, not as A
// fragments.
__host__ __device__ constexpr bool wide(int d) { return padded(d) > 128; }
__host__ __device__ constexpr int stages(int d) { return wide(d) ? 2 : 3; }

// Shared memory, mirrored by ops.py `bwd_wg_smem_bytes`: 1024 bytes to
// align the panels, then (dK/dV) K and V [kKeys][d], the ring's Q and dO
// [stages][2][kQ][d] in bf16, its lse, D and key limits [stages][kQ] in 4
// bytes each, and the ring's 2 stages mbarriers; (dQ) Q and dO [kRows][d],
// the ring's K and V [stages][2][kTok][d], the mbarriers.  d padded.
__host__ __device__ constexpr int dkdv_tiles_bytes(int d) {
  return 2 * (2 * kKeys + stages(d) * 2 * kQ) * padded(d);
}
__host__ __device__ constexpr int dkdv_smem_bytes(int d) {
  return 1024 + dkdv_tiles_bytes(d) + stages(d) * kQ * 12 + stages(d) * 16;
}
__host__ __device__ constexpr int dq_tiles_bytes(int d) {
  return 2 * (2 * kRows + stages(d) * 2 * kTok) * padded(d);
}
__host__ __device__ constexpr int dq_smem_bytes(int d) {
  return 1024 + dq_tiles_bytes(d) + stages(d) * 16;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// what a dK/dV consumer sums: dV and dK, or (past 128 columns) one of them
enum Role { kDv = 0, kDk = 1, kBoth = 2 };

// One consumer warpgroup's walk of a dK/dV block: steps j0 .. j1 - 1 of
// ring stages, S^T = K Q^T (and dP^T = V dO^T), then dV += P^T dO (and dK
// += dS^T Q); returns its sums in dva / dka (dK unscaled)
template <int D, int ROLE>
__device__ __forceinline__ void dkdv_walk(float (&dva)[padded(D) / 2],
                                          float (&dka)[padded(D) / 2], unsigned char* smem,
                                          const float* lses, const float* dss, const int* lims,
                                          uint64_t* full, uint64_t* empty, int j0, int j1,
                                          int w, int key0) {
  constexpr int DP = padded(D), ST = stages(D);
  constexpr int KV_BYTES = 2 * kKeys * DP;      // K (or V)
  constexpr int QT_BYTES = 2 * kQ * DP;         // one stage's Q (or dO)
  constexpr uint32_t K_PANEL = kKeys * 128, Q_PANEL = kQ * 128;
  const int lane = threadIdx.x & 31, qd = lane & 3;
  const float c = kLog2e / sqrtf(static_cast<float>(D));
  const int key1 = key0 + 8;
  const uint32_t ka = smem_u32(smem) + 64 * w * 128, va = ka + KV_BYTES;
  int stage = 0, phase = 0;
  for (int j = j0; j < j1; ++j) {
    mbar_wait(&full[stage], phase);
    fence_proxy_async();
    const uint32_t qa = smem_u32(smem) + 2 * KV_BYTES + stage * 2 * QT_BYTES;
    const uint32_t oa = qa + QT_BYTES;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 packed rows
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(st, desc_k(ka + (kk >> 2) * K_PANEL + (kk & 3) * 32),
                         desc_k(qa + (kk >> 2) * Q_PANEL + (kk & 3) * 32));
    if constexpr (ROLE != kDv) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<0, 0>(dpt, desc_k(va + (kk >> 2) * K_PANEL + (kk & 3) * 32),
                           desc_k(oa + (kk >> 2) * Q_PANEL + (kk & 3) * 32));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T = P^T (dP^T - D), in place (element 4 n + e: key row
    // g + 8 (e / 2), packed row 8 n + 2 qd + e % 2 of the step)
    const float* lt = lses + stage * kQ;
    const float* Dt = dss + stage * kQ;
    const int* Lt = lims + stage * kQ;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = n * 8 + 2 * qd + c2;
        const float l2 = lt[col], dd = Dt[col];
        const int lim = Lt[col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * n + 2 * hh + c2;
          const float p = (hh ? key1 : key0) <= lim ? exp2f(fmaf(st[e], c, -l2)) : 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dd);
        }
      }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the accumulators of two
    // 8-row blocks are the A fragment of one 16-row step; dO and Q are
    // read down their rows (MN-major)
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kt][i] = pack_bf16(st[8 * kt + 2 * i], st[8 * kt + 2 * i + 1]);
        sa[kt][i] = pack_bf16(dpt[8 * kt + 2 * i], dpt[8 * kt + 2 * i + 1]);
      }
    fence_regs(dva);
    fence_regs(dka);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if constexpr (ROLE != kDk) wgmma_rs<DP, 1>(dva, pa[kt], desc_mn(oa + kt * 2048, Q_PANEL));
      if constexpr (ROLE != kDv) wgmma_rs<DP, 1>(dka, sa[kt], desc_mn(qa + kt * 2048, Q_PANEL));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == ST) { stage = 0; phase ^= 1; }
  }
}

// dK/dV of one 128-key tile of one (batch row, kv head), over steps j0 ..
// j1 - 1 of its walk (the whole walk unless the group is split, grid y =
// tile * splits + chunk; past 128 columns grid z is the role, dV or dK).
// Warpgroup w owns keys 64 w .. 64 w + 63; the producer warpgroup streams
// the steps' Q, dO, lse, D and key limits.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
               int sq, int skv, int hq, int hkv, int q_offset, int causal, int splits) {
  static_assert(takes(D), "the wgmma design takes d 64 to 192");
  constexpr int DP = padded(D), ST = stages(D);
  constexpr int CPR = DP / 8;                   // 16-byte chunks a tile row
  constexpr int KV_BYTES = 2 * kKeys * DP;      // K (or V)
  constexpr int QT_BYTES = 2 * kQ * DP;         // one stage's Q (or dO)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // K at 0, V at KV_BYTES; stage s's Q at 2 KV_BYTES + 2 s QT_BYTES, its
  // dO QT_BYTES on
  float* lses = reinterpret_cast<float*>(smem + dkdv_tiles_bytes(D));   // [ST][kQ]
  float* dss = lses + ST * kQ;                                           // [ST][kQ]
  int* lims = reinterpret_cast<int*>(dss + ST * kQ);                     // [ST][kQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(lims + ST * kQ);          // [ST]
  uint64_t* empty = full + ST;                                           // [ST]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int tile = blockIdx.y / splits, chunk = blockIdx.y - tile * splits;
  const int group = hq / hkv;
  const int rows = sq * group;
  const int t0 = tile * kKeys;
  // the first packed row that sees the tile's first key, the walk's
  // steps, and this block's equal share of them
  const int r_begin = causal ? min(rows, max(0, t0 - q_offset) * group) : 0;
  const int n_q = (rows - r_begin + kQ - 1) / kQ;
  const int j0 = static_cast<int>((long long)n_q * chunk / splits);
  const int j1 = static_cast<int>((long long)n_q * (chunk + 1) / splits);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  // the block's K and V; keys past skv and columns past d are zeros
  const long long tok_stride = (long long)hkv * D;
  const bf16* kb = k + ((long long)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((long long)b * skv * hkv + hk) * D;
  for (int i = tid; i < kKeys * CPR; i += kThreads) {
    const int tt = i / CPR, ch = i - tt * CPR;
    const bool live = t0 + tt < skv && ch < D / 8;
    const long long off = (live ? t0 + tt : 0) * tok_stride + ch * 8;
    cp_async16(smem + sw128(kKeys, tt, ch), kb + off, live);
    cp_async16(smem + KV_BYTES + sw128(kKeys, tt, ch), vb + off, live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer warpgroup: step j's rows into ring stage j % ST, rows
    // 16 pw .. 16 pw + 15 by warp pw
    reg_dealloc<kProducerRegs>();
    const int pw = warp - 4 * kConsumers;
    int stage = 0, phase = 0;
    for (int j = j0; j < j1; ++j) {
      mbar_wait(&empty[stage], phase ^ 1);
      // lanes 0-15, row 16 pw + lane: its offset in q and dout (-1: past
      // the packed rows), lse in log2 units, D, and the last key it sees
      // (-1: none, also where lse is -inf)
      const int r = 16 * pw + (lane & 15), rr = r_begin + j * kQ + r;
      long long off = -1;
      if (lane < 16) {
        float l2 = 0.f, dd = 0.f;
        int lim = -1;
        if (rr < rows) {
          const int qi = rr / group, gi = rr - qi * group;
          off = (((long long)b * sq + qi) * hq + hk * group + gi) * D;
          const long long idx = ((long long)b * hq + hk * group + gi) * sq + qi;
          const float l = lse[idx];
          dd = dsum[idx];
          if (l != -CUDART_INF_F) {
            l2 = l * kLog2e;
            lim = causal ? min(skv - 1, q_offset + qi) : skv - 1;
          }
        }
        lses[stage * kQ + r] = l2;
        dss[stage * kQ + r] = dd;
        lims[stage * kQ + r] = lim;
      }
      unsigned char* qd = smem + 2 * KV_BYTES + stage * 2 * QT_BYTES;
      // 16 * CPR is a multiple of 32; not unrolled, to stay within the
      // producers' 40 registers (ptxas spills otherwise)
#pragma unroll 1
      for (int i = lane; i < 16 * CPR; i += 32) {
        const int rl = i / CPR, ch = i - rl * CPR;
        const long long o = __shfl_sync(0xffffffffu, off, rl);
        const bool live = o >= 0 && ch < D / 8;
        const long long e = live ? o + ch * 8 : 0;
        cp_async16(qd + sw128(kQ, 16 * pw + rl, ch), q + e, live);
        cp_async16(qd + QT_BYTES + sw128(kQ, 16 * pw + rl, ch), dout + e, live);
      }
      cp_async_arrive(&full[stage]);
      mbar_arrive(&full[stage]);
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    // ---- consumer warpgroups
    reg_alloc<kConsumerRegs>();
    const int w = warp >> 2, wl = warp & 3, g = lane >> 2, qd = lane & 3;
    // this thread's two keys: rows g and g + 8 of its warp's 16
    const int key0 = t0 + 64 * w + 16 * wl + g;
    // dV in dva, dK in dka; past 128 columns one of them, in dva
    float dva[DP / 2], dka[wide(D) ? 1 : DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (wide(D) ? 1 : DP / 2); ++i) dka[i] = 0.f;
    int role = kBoth;
    if constexpr (wide(D)) {
      role = blockIdx.z;
      if (role == kDv)
        dkdv_walk<D, kDv>(dva, dva, smem, lses, dss, lims, full, empty, j0, j1, w, key0);
      else
        dkdv_walk<D, kDk>(dva, dva, smem, lses, dss, lims, full, empty, j0, j1, w, key0);
    } else {
      dkdv_walk<D, kBoth>(dva, dka, smem, lses, dss, lims, full, empty, j0, j1, w, key0);
    }

    // epilogue: every key of the tile below skv (zeros where no row saw
    // it); with a split, f32 partials (splits, 2, b, skv, hkv, d) for the
    // reduce, dK first and unscaled
    const float scale = 1.f / sqrtf(static_cast<float>(D));
    const long long n_el = (long long)(gridDim.x / hkv) * skv * hkv * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= skv) continue;
      const long long base = (((long long)b * skv + key) * hkv + hk) * D + 2 * qd;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float v0 = dva[4 * n + 2 * hh], v1 = dva[4 * n + 2 * hh + 1];
        if (splits == 1) {
          bf16* out = role == kDk ? dk : dv;
          const float sv = role == kDk ? scale : 1.f;
          *reinterpret_cast<__nv_bfloat162*>(out + base + n * 8) =
              __floats2bfloat162_rn(v0 * sv, v1 * sv);
          if constexpr (!wide(D))
            *reinterpret_cast<__nv_bfloat162*>(dk + base + n * 8) = __floats2bfloat162_rn(
                dka[4 * n + 2 * hh] * scale, dka[4 * n + 2 * hh + 1] * scale);
        } else {
          float* pk = part + 2LL * chunk * n_el + base;
          *reinterpret_cast<float2*>(pk + (role == kDk ? 0 : n_el) + n * 8) =
              make_float2(v0, v1);
          if constexpr (!wide(D))
            *reinterpret_cast<float2*>(pk + n * 8) =
                make_float2(dka[4 * n + 2 * hh], dka[4 * n + 2 * hh + 1]);
        }
      }
    }
  }
}

// dK and dV from the group split's f32 partials (splits, 2, n_el): each
// element summed over the splits in order, then rounded once
__global__ void __launch_bounds__(256)
dkdv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, long long n_el, int splits, float scale) {
  const long long n4 = n_el / 4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * 256) {
    const int which = i >= n4;                  // 0: dK, 1: dV
    const long long e = (i - which * n4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < splits; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(part + (2LL * c + which) * n_el + e);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float s = which ? 1.f : scale;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * s, acc.y * s);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * s, acc.w * s);
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo);
    out.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>((which ? dv : dk) + e) = out;
  }
}

// dQ of 128 packed query rows of one (batch row, kv head); warpgroup w
// owns rows 64 w .. 64 w + 63 and holds their Q and dO as A fragments
// (past 128 columns it reads them from shared memory); the producer
// warpgroup streams the K/V tiles up to the causal bound
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dq, int sq, int skv, int hq, int hkv, int q_offset,
             int causal) {
  static_assert(takes(D), "the wgmma design takes d 64 to 192");
  constexpr int DP = padded(D), ST = stages(D);
  constexpr bool A_REGS = !wide(D);             // Q and dO as A fragments
  constexpr int CPR = DP / 8;                   // 16-byte chunks a tile row
  constexpr int QS_BYTES = 2 * kRows * DP;      // Q (or dO)
  constexpr int KT_BYTES = 2 * kTok * DP;       // one stage's K (or V)
  constexpr uint32_t QS_PANEL = kRows * 128, KT_PANEL = kTok * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // Q at 0, dO at QS_BYTES; stage s's K at 2 QS_BYTES + 2 s KT_BYTES, its
  // V KT_BYTES on
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + dq_tiles_bytes(D));   // [ST]
  uint64_t* empty = full + ST;                                               // [ST]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int rows = sq * group;
  // causal: the last packed tile walks the most keys, and runs first
  const int z = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = z * kRows;
  const int r_last = min(r0 + kRows, rows) - 1;
  const int kv_end = causal ? min(skv, q_offset + r_last / group + 1) : skv;
  const int n_kv = (kv_end + kTok - 1) / kTok;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  // Q and dO of the block's rows; rows past the packed rows and columns
  // past d are zeros
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, ch = i - r * CPR;
    const int rr = r0 + r;
    const bool live = rr < rows && ch < D / 8;
    long long off = 0;
    if (live) {
      const int qi = rr / group, gi = rr - qi * group;
      off = (((long long)b * sq + qi) * hq + hk * group + gi) * D + ch * 8;
    }
    cp_async16(smem + sw128(kRows, r, ch), q + off, live);
    cp_async16(smem + QS_BYTES + sw128(kRows, r, ch), dout + off, live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer warpgroup: K/V tile j into ring stage j % ST, keys 16
    // pw .. 16 pw + 15 by warp pw; keys at or past kv_end are zeros
    reg_dealloc<kProducerRegs>();
    const int pw = warp - 4 * kConsumers;
    const long long tok_stride = (long long)hkv * D;
    const bf16* kb = k + ((long long)b * skv * hkv + hk) * D;
    const bf16* vb = v + ((long long)b * skv * hkv + hk) * D;
    int stage = 0, phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* kd = smem + 2 * QS_BYTES + stage * 2 * KT_BYTES;
#pragma unroll 1
      for (int i = lane; i < 16 * CPR; i += 32) {   // as above: no spill
        const int tt = 16 * pw + i / CPR, ch = i % CPR;
        const bool live = j * kTok + tt < kv_end && ch < D / 8;
        const long long off = (live ? j * kTok + tt : 0) * tok_stride + ch * 8;
        cp_async16(kd + sw128(kTok, tt, ch), kb + off, live);
        cp_async16(kd + KT_BYTES + sw128(kTok, tt, ch), vb + off, live);
      }
      cp_async_arrive(&full[stage]);
      mbar_arrive(&full[stage]);
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    // ---- consumer warpgroups
    reg_alloc<kConsumerRegs>();
    const int w = warp >> 2, wl = warp & 3, g = lane >> 2, qd = lane & 3;
    const int rw0 = r0 + 64 * w;                 // the warpgroup's first row
    // Q and dO as the A fragments of the warp's 16 rows, over all of d
    uint32_t qa[A_REGS ? D / 16 : 1][4], oa[A_REGS ? D / 16 : 1][4];
    if constexpr (A_REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = 64 * w + 16 * wl + (lane & 15), ch = 2 * kk + (lane >> 4);
        ldsm_x4(qa[kk], smem + sw128(kRows, r, ch));
        ldsm_x4(oa[kk], smem + QS_BYTES + sw128(kRows, r, ch));
      }
    }
    const uint32_t qs = smem_u32(smem) + 64 * w * 128, os = qs + QS_BYTES;
    // this thread's rows g and g + 8: the last key each sees (-1: none),
    // lse in log2 units and D
    int lim[2];
    float l2[2], dd[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = rw0 + 16 * wl + g + 8 * hh;
      lim[hh] = -1;
      l2[hh] = 0.f;
      dd[hh] = 0.f;
      if (rr < rows) {
        const int qi = rr / group, gi = rr - qi * group;
        const long long idx = ((long long)b * hq + hk * group + gi) * sq + qi;
        const float l = lse[idx];
        dd[hh] = dsum[idx];
        if (l != -CUDART_INF_F) {
          l2[hh] = l * kLog2e;
          lim[hh] = causal ? min(skv - 1, q_offset + qi) : skv - 1;
        }
      }
    }
    // the warpgroup's last key (its last live row's; -1 without rows):
    // tiles past it are skipped
    const int wg_lim = rw0 >= rows ? -1
                       : causal    ? min(skv - 1, q_offset + (min(rw0 + 63, rows - 1)) / group)
                                   : skv - 1;
    float dqa[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
    const float c = kLog2e / sqrtf(static_cast<float>(D));
    int stage = 0, phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      mbar_wait(&full[stage], phase);
      const int kv0 = j * kTok;
      if (kv0 <= wg_lim) {
        fence_proxy_async();
        const uint32_t ka = smem_u32(smem) + 2 * QS_BYTES + stage * 2 * KT_BYTES;
        const uint32_t va = ka + KT_BYTES;

        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t bk = desc_k(ka + (kk >> 2) * KT_PANEL + (kk & 3) * 32);
          if constexpr (A_REGS)
            wgmma_rs<64, 0>(sc, qa[kk], bk);
          else
            wgmma_ss_n64<0, 0>(sc, desc_k(qs + (kk >> 2) * QS_PANEL + (kk & 3) * 32), bk);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t bv = desc_k(va + (kk >> 2) * KT_PANEL + (kk & 3) * 32);
          if constexpr (A_REGS)
            wgmma_rs<64, 0>(dp, oa[kk], bv);
          else
            wgmma_ss_n64<0, 0>(dp, desc_k(os + (kk >> 2) * QS_PANEL + (kk & 3) * 32), bv);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // dS = P (dP - D) in place (element 4 n + e: row g + 8 (e / 2),
        // key kv0 + 8 n + 2 qd + e % 2)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const int key = kv0 + n * 8 + 2 * qd + (e & 1);
            const float p = key <= lim[hh] ? exp2f(fmaf(sc[4 * n + e], c, -l2[hh])) : 0.f;
            sc[4 * n + e] = p * (dp[4 * n + e] - dd[hh]);
          }

        // dQ += bf16(dS) K, K read down its rows (MN-major)
        uint32_t sa[4][4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sa[kt][i] = pack_bf16(sc[8 * kt + 2 * i], sc[8 * kt + 2 * i + 1]);
        fence_regs(dqa);
        wg_fence();
#pragma unroll
        for (int kt = 0; kt < 4; ++kt)
          wgmma_rs<DP, 1>(dqa, sa[kt], desc_mn(ka + kt * 2048, KT_PANEL));
        wg_commit();
        wg_wait<0>();
        fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }

    const float scale = 1.f / sqrtf(static_cast<float>(D));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = rw0 + 16 * wl + g + 8 * hh;
      if (rr >= rows) continue;
      const int qi = rr / group, gi = rr - qi * group;
      bf16* drow = dq + (((long long)b * sq + qi) * hq + hk * group + gi) * D + 2 * qd;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8) =
            __floats2bfloat162_rn(dqa[4 * n + 2 * hh] * scale, dqa[4 * n + 2 * hh + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dsum, float* part, void* dq, void* dk,
                   void* dv, int b, int sq, int skv, int hq, int hkv, int q_offset, int causal,
                   int splits, int passes, cudaStream_t stream) {
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
  cudaError_t err = cudaSuccess;
  if (passes & kPassDkdv) {
    const int s1 = dkdv_smem_bytes(D);
    err = cudaFuncSetAttribute(dkdv_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
    if (err != cudaSuccess) return err;
    dkdv_wg_kernel<D><<<dim3(b * hkv, (skv + kKeys - 1) / kKeys * splits, wide(D) ? 2 : 1),
                        kThreads, s1, stream>>>(qb, kb, vb, ob, lse, dsum,
                                                static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                part, sq, skv, hq, hkv, q_offset, causal, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (splits > 1 && (passes & kPassReduce)) {
    const long long n_el = (long long)b * skv * hkv * D;
    const long long blocks = (2 * (n_el / 4) + 255) / 256;
    dkdv_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_el, splits,
        1.f / sqrtf(static_cast<float>(D)));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & kPassDq) {
    const int s2 = dq_smem_bytes(D);
    err = cudaFuncSetAttribute(dq_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
    if (err != cudaSuccess) return err;
    dq_wg_kernel<D><<<dim3(b * hkv, (sq * (hq / hkv) + kRows - 1) / kRows), kThreads, s2,
                      stream>>>(qb, kb, vb, ob, lse, dsum, static_cast<bf16*>(dq), sq, skv, hq,
                                hkv, q_offset, causal);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace wg

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
                   int sq, int skv, int hq, int hkv, int q_offset, int causal, int passes,
                   cudaStream_t stream) {
  const size_t s1 = dkdv_smem_bytes(D), s2 = dq_smem_bytes(D);
  cudaError_t err = cudaSuccess;
  if (passes & kPassDkdv) {
    err = cudaFuncSetAttribute(dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s1));
    if (err != cudaSuccess) return err;
    dkdv_tc_kernel<D><<<dim3(b * hkv, (skv + kKeys - 1) / kKeys, col_splits(D)), kThreads, s1,
                        stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, skv, hq, hkv, q_offset, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & kPassDq) {
    err = cudaFuncSetAttribute(dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
    if (err != cudaSuccess) return err;
    const int tiles = (sq * (hq / hkv) + kRows - 1) / kRows;
    dq_tc_kernel<D><<<dim3(b * hkv, tiles, col_splits(D)), kThreads, s2, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dq), sq, skv, hq, hkv,
        q_offset, causal);
    err = cudaGetLastError();
  }
  return err;
}

// head dims 16, 32, ..., 128, then 160, 192, 224, 256 (column halves of
// 80 ... 128), each its own register layout; the head dims the wgmma
// design takes (`wg::takes`) go to it, and only they split the group
template <int D = 16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dsum, float* part, void* dq, void* dk,
                     void* dv, int b, int sq, int skv, int hq, int hkv, int d, int q_offset,
                     int causal, int splits, int passes, cudaStream_t stream) {
  if (d == D) {
    if constexpr (wg::takes(D)) {
      return wg::launch<D>(q, k, v, dout, lse, dsum, part, dq, dk, dv, b, sq, skv, hq, hkv,
                           q_offset, causal, splits, passes, stream);
    } else {
      if (splits != 1) return cudaErrorInvalidValue;
      return launch<D>(q, k, v, dout, lse, dsum, dq, dk, dv, b, sq, skv, hq, hkv, q_offset,
                       causal, passes, stream);
    }
  }
  if constexpr (D < 256)
    return dispatch<(D < 128 ? D + 16 : D + 32)>(q, k, v, dout, lse, dsum, part, dq, dk, dv,
                                                 b, sq, skv, hq, hkv, d, q_offset, causal,
                                                 splits, passes, stream);
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
                   int passes, cudaStream_t stream) {
  const size_t s1 = smem_bytes(d, 6, 2), s2 = smem_bytes(d, 5, 1);
  cudaError_t err = cudaSuccess;
  if (passes & kPassDkdv) {
    err = cudaFuncSetAttribute(dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s1));
    if (err != cudaSuccess) return err;
    dkdv_f32_kernel<<<dim3(b * hkv, (skv + kB - 1) / kB), kThreads, s1, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
        static_cast<float*>(dk), static_cast<float*>(dv), sq, skv, hq, hkv, d, q_offset,
        causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & kPassDq) {
    err = cudaFuncSetAttribute(dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
    if (err != cudaSuccess) return err;
    dq_f32_kernel<<<dim3((sq + kB - 1) / kB, b * hq), kThreads, s2, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
        static_cast<float*>(dq), sq, skv, hq, hkv, d, q_offset, causal);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace f32

}  // namespace repro_fab

// q (b, sq, hq, d), k and v (b, skv, hkv, d), o, dout and dq (b, sq, hq, d),
// dk and dv (b, skv, hkv, d), all f32 or all bf16 (dtype code 0 / 1),
// contiguous and 16-byte aligned; lse and dsum (b, hq, sq) f32, dsum
// scratch written here; d a multiple of 16 up to 128 or (bf16) of 32 up to
// 256, (f32) of 16 up to 256; sq, skv > 0.  `splits` > 1 (bf16 at the
// head dims of the wgmma design only) splits each dK/dV tile's walk into
// that many blocks, which write f32 partials (splits, 2, b, skv, hkv, d)
// to `part` for the reduce.  Launches on `stream` the passes whose bits
// are set in `passes` (`Pass`; all four: D, dK/dV, the reduce where
// splits > 1, then dQ).  Returns the first CUDA error.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dsum, void* part, void* dq, void* dk, void* dv,
                                         int b, int sq, int skv, int hq, int hkv, int d,
                                         int q_offset, int causal, int splits, int dtype,
                                         int passes, void* stream) {
  using namespace repro_fab;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)b * sq * hq;
  const dim3 grid(static_cast<unsigned>((n_rows + kThreads / 32 - 1) / (kThreads / 32)));
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (splits < 1 || (dtype != kBF16 && splits != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (passes & kPassD) {
      dsum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), ds,
          n_rows, sq, hq, d);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(tc::dispatch(q, k, v, dout, l, ds, static_cast<float*>(part), dq,
                                         dk, dv, b, sq, skv, hq, hkv, d, q_offset, causal,
                                         splits, passes, s));
  }
  if (dtype == kF32) {
    if (passes & kPassD) {
      dsum_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(o),
                                                   static_cast<const float*>(dout), ds, n_rows,
                                                   sq, hq, d);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(f32::launch(q, k, v, dout, l, ds, dq, dk, dv, b, sq, skv, hq, hkv,
                                        d, q_offset, causal, passes, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
