// Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `ssd_intra_chunk_pallas`
// (src/repro/kernels/ssd_scan/kernel.py:55, body `_ssd_kernel` :27).
// Per (batch*head, chunk) it computes, with seg = inclusive cumsum of
// dt * A over the chunk:
//
//   y[i]  = sum_{j<=i} round_x((C_i . B_j) exp(seg_i - seg_j) dt_j) x_j
//   s     = sum_j B_j^T round_x(round_x(exp(seg_last - seg_j) dt_j) x_j)
//   cd    = exp(seg_last)
//
// where round_x rounds to x's type (bf16 or f32) exactly where the TPU
// kernel casts (kernel.py:46, :50); every dot product accumulates in f32
// and every output is f32.  The causal mask is applied before exp (no
// inf * 0).
//
// Bound: per (batch*head, chunk) the work is about l^2 (n + p) + 2 l n p
// flops on 2 l n + l p input elements and l p + n p f32 outputs.  At
// zamba2's prefill shapes (80 heads, head dim p 64, state n 64, chunks
// of 64 to 256) that is 18 flops per byte at l 64 and 58 at l 256:
// below the card's bf16 tensor-core ridge (~295), so the bound is the
// bytes, and the design keeps the (l x l) scores and the (n x p) state
// out of device memory.  Two designs, fixed by the dtype (the wrapper,
// kernels/ssd_scan/ops.py `route`, mirrors it):
//
// * bf16 (every served configuration): `tc::ssd_tc_kernel`.  The y part
//   is causal flash attention in all but name (C the query, B the key,
//   x the value, the decay weight in place of the softmax, with no
//   running max and no normaliser), and it runs on flash_attention.cu's
//   parts.  A block of 4 warps owns one 64-row slab of one chunk: a y
//   slab (16 output rows a warp), or a state slab (16 rows of n a warp).
//   So a chunk of l rows and state n is ceil(l / 64) + ceil(n / 64)
//   blocks, not one (mamba2-130m's 48 chunks: 288 blocks on 132 SMs),
//   with no float atomics: each output element has one writer, and
//   reruns are byte-identical.  Each block scans seg over its chunk
//   itself (a warp-shuffle scan, two tokens a thread; the sum's order
//   differs from a serial cumsum by f32 rounding, which the plain
//   version's tolerance holds).  B and x move in 64-token tiles by
//   16-byte cp.async copies through a 2-stage ring (a y slab stages its
//   64 rows of C once beside it); rows past l are zero-filled by the
//   copy's source size and never stored, and p or n that is not a
//   multiple of 16 is zero-padded in shared memory.  A y slab walks only
//   the tiles at or below its diagonal (a warp skips tiles past its last
//   row): S = C B^T by mma.sync m16n8k16 (bf16 in, f32 out) from ldmatrix
//   loads of rows padded by 16 bytes; each score is scaled in registers
//   by exp(seg_i - seg_j) dt_j, zeroed where j > i, rounded to bf16 as
//   the A fragment of S x (x by ldmatrix.trans, as V in flash), and y
//   stays in f32 registers (the score's exp is __expf, ex2 on the SFU:
//   its error, 2 + 1.16 |x| f32 ulps, is far below the bf16 rounding
//   that follows).  A state slab walks every tile: it rounds
//   w_j x_j to bf16 in place in the x tile (w rounded first), then
//   multiplies B^T (ldmatrix.trans over B's [token][n] rows) by it.  The
//   state slabs and the longest y slabs are launched first.  y and s go
//   from the fragments to memory as float2.  Shared memory: seg and dt
//   [256] f32, C [64][n16 + 8], B [2][64][n16 + 8], x [2][64][p16 + 8]
//   bf16 (n16, p16: n and p rounded up to 16): 48,160 bytes at
//   p = n = 64, 72,736 at mamba2-130m's n 128.  p16 is a template
//   parameter (y's registers); n is a loop bound.
// * f32 (taken only by the parity checks; on tensor cores it would be
//   TF32, which the port never uses): `ssd_f32_kernel`, one block per
//   (batch*head, chunk), on CUDA cores: B and x staged whole, the
//   output rows in tiles of 16, a score tile then those rows of y, then
//   the state; one thread runs the cumsum.
//
// Known limits, left for later work: no wgmma or TMA; a block's fixed
// latency (dt's load, the first tile's copy, the stores at its end) is
// not overlapped with another of its own, and a y slab re-reads the B
// and x tiles below its diagonal (from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_ssd {

enum DTypeCode { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------ tensor-core design (bf16)

namespace tc {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kSlab = 64;       // rows per block (y rows or state rows), 16 per warp
constexpr int kTok = 64;        // tokens per B / x tile
constexpr int kStages = 2;      // B / x ring
constexpr int kPad = 8;         // bf16 elements of row padding (16 bytes)
constexpr int kMaxChunk = 256;  // l <= 256: two tokens a thread in the scan

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }

// Shared memory, mirrored by kernels/ssd_scan/ops.py `tc_smem_bytes`:
// seg and dt [256] f32 and the scan's warp totals [8] f32, then C
// [64][n16 + 8], B [2][64][n16 + 8] and x [2][64][p16 + 8] bf16.
__host__ __device__ constexpr size_t smem_bytes(int p, int n) {
  return sizeof(float) * (2 * kMaxChunk + 8) +
         sizeof(bf16) * ((size_t)(1 + kStages) * kSlab * (pad16(n) + kPad) +
                         (size_t)kStages * kTok * (pad16(p) + kPad));
}

// Blocks of one chunk: its y slabs and its state slabs.
__host__ __device__ constexpr int slabs(int l, int n) {
  return (l + kSlab - 1) / kSlab + (n + kSlab - 1) / kSlab;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// four blocks an SM up to p 64 (every served head dim): at most 128
// registers a thread
template <int PP>
__global__ void __launch_bounds__(kThreads, PP <= 64 ? 4 : 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ B,
              const bf16* __restrict__ Cm, float* __restrict__ y, float* __restrict__ s,
              float* __restrict__ cd, int chunks, int nc, int l, int p, int n) {
  constexpr int LDP = PP + kPad;
  constexpr int OT = PP / 8;           // output n-tiles per warp (y or s)
  constexpr int NT = kTok / 8;         // score n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* seg = reinterpret_cast<float*>(smem_raw);
  float* dts = seg + kMaxChunk;        // dt, then (state slabs) round(w)
  float* wtot = dts + kMaxChunk;
  const int NP = pad16(n), LDN = NP + kPad;
  bf16* cs = reinterpret_cast<bf16*>(wtot + 8);
  bf16* bs = cs + kSlab * LDN;
  bf16* xs = bs + kStages * kTok * LDN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  // slots slowest, chunks fastest; the state slabs and then the y slabs
  // from the last (the longest walks) come first
  const int chunk = blockIdx.x % chunks, slot = blockIdx.x / chunks;
  const int ny = (l + kSlab - 1) / kSlab, nstate = (n + kSlab - 1) / kSlab;
  const bool state = slot < nstate;
  const int slab = state ? slot : ny - 1 - (slot - nstate);
  const int r0 = slab * kSlab;         // first y row, or first state row
  const int n_tiles = state ? (l + kTok - 1) / kTok : slab + 1;
  const long long tok0 = (long long)chunk * l;
  const bf16* xb = x + tok0 * p;
  const bf16* Bb = B + tok0 * n;

  // tile j of B and x into ring stage st: rows past l, and the columns
  // padding n and p to 16, are zeros
  auto issue = [&](int j, int st) {
    const int t0 = j * kTok, cpn = NP / 8, cpp = PP / 8;
    bf16* bd = bs + st * kTok * LDN;
    bf16* xd = xs + st * kTok * LDP;
    for (int i = tid; i < kTok * cpn; i += kThreads) {
      const int tt = i / cpn, e = (i - tt * cpn) * 8;
      const bool live = t0 + tt < l && e < n;
      cp_async16(bd + tt * LDN + e, Bb + (live ? (long long)(t0 + tt) * n + e : 0), live);
    }
    for (int i = tid; i < kTok * cpp; i += kThreads) {
      const int tt = i / cpp, e = (i - tt * cpp) * 8;
      const bool live = t0 + tt < l && e < p;
      cp_async16(xd + tt * LDP + e, xb + (live ? (long long)(t0 + tt) * p + e : 0), live);
    }
  };

  // prologue: a y slab's rows of C with tile 0, then tiles 1 ..
  // kStages - 2, one group each
  if (!state) {
    const bf16* Cb = Cm + tok0 * n;
    const int cpn = NP / 8;
    for (int i = tid; i < kSlab * cpn; i += kThreads) {
      const int r = i / cpn, e = (i - r * cpn) * 8;
      const bool live = r0 + r < l && e < n;
      cp_async16(cs + r * LDN + e, Cb + (live ? (long long)(r0 + r) * n + e : 0), live);
    }
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) issue(j, j);
    cp_async_commit();
  }

  // seg = inclusive cumsum of dt * A while the copies fly: each thread
  // sums its two tokens, a warp scan, then the earlier warps' totals
  {
    const float a = A[chunk / nc];
    const float* dtc = dt + tok0;
    const int i0 = 2 * tid;
    const float d0 = i0 < l ? dtc[i0] : 0.f, d1 = i0 + 1 < l ? dtc[i0 + 1] : 0.f;
    const float v0 = d0 * a, v1 = d1 * a;
    float incl = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    float prev = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) prev = 0.f;
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    float base = 0.f;
    for (int w = 0; w < warp; ++w) base += wtot[w];
    seg[i0] = (base + prev) + v0;
    seg[i0 + 1] = ((base + prev) + v0) + v1;
    dts[i0] = d0;
    dts[i0 + 1] = d1;
    __syncthreads();
    if (state) {
      // w_j = round(exp(seg_last - seg_j) dt_j), 0 past l, in dt's place
      // (each thread its own two tokens; read after the loop's barrier)
      const float last = seg[l - 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (i0 + h < l) dts[i0 + h] = round_bf16(expf(last - seg[i0 + h]) * dts[i0 + h]);
      if (slab == 0 && tid == 0) cd[chunk] = expf(last);
    }
  }

  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  // this thread's two y rows (quad row g and g + 8 of its warp's 16) and
  // the last token the warp's rows see
  const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
  const int warp_last = min(r0 + warp * 16 + 15, l - 1);
  const bool warp_live = state ? r0 + warp * 16 < NP : r0 + warp * 16 < l;
  const float seg_a = !state && row_a < l ? seg[row_a] : 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    // refill the stage tile j - 1 used (every warp left it at the barrier)
    if (j + kStages - 1 < n_tiles) issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int t0 = j * kTok;
    const bf16* bt = bs + st * kTok * LDN;
    bf16* xt = xs + st * kTok * LDP;

    if (!state) {
      if (warp_live && t0 <= warp_last) {
        // S = C B^T: 16 rows x 64 tokens per warp
        float sc[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
        for (int kk = 0; kk < NP; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LDN + kk + (lane >> 4) * 8);
#pragma unroll
          for (int nn = 0; nn < NT / 2; ++nn) {
            uint32_t bk[4];   // (tokens 0-7, n 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
            ldsm_x4(bk, bt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN + kk +
                            ((lane >> 3) & 1) * 8);
            mma_bf16(sc[2 * nn], a, bk[0], bk[1]);
            mma_bf16(sc[2 * nn + 1], a, bk[2], bk[3]);
          }
        }
        // scores: (C_i . B_j) exp(seg_i - seg_j) dt_j where j <= i < l,
        // else 0 (masked before exp), rounded to bf16 as P's A fragments
        // (element e of n-tile t: row g + 8 (e / 2), token t0 + 8 t + 2 qd + e % 2)
        const float seg_b = row_b < l ? seg[row_b] : 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + t * 8 + 2 * qd + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const float sr = e < 2 ? seg_a : seg_b;
            sc[t][e] = key <= row && row < l ? sc[t][e] * __expf(sr - seg[key]) * dts[key] : 0.f;
          }
        // y += bf16(S) x
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt) {
          uint32_t a[4];
          a[0] = pack_bf16(sc[2 * kt][0], sc[2 * kt][1]);
          a[1] = pack_bf16(sc[2 * kt][2], sc[2 * kt][3]);
          a[2] = pack_bf16(sc[2 * kt + 1][0], sc[2 * kt + 1][1]);
          a[3] = pack_bf16(sc[2 * kt + 1][2], sc[2 * kt + 1][3]);
#pragma unroll
          for (int dn = 0; dn < OT / 2; ++dn) {
            uint32_t bv[4];   // (tokens 0-7, p 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
            ldsm_x4_trans(bv, xt + (kt * 16 + (lane & 15)) * LDP + dn * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dn], a, bv[0], bv[1]);
            mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
          }
        }
      }
    } else {
      // x tile -> round(round(w_j) x_j) in place (rows past l are zeros)
      for (int i = tid; i < kTok * (PP / 2); i += kThreads) {
        const int tt = i / (PP / 2), c = (i - tt * (PP / 2)) * 2;
        const float w = t0 + tt < l ? dts[t0 + tt] : 0.f;
        __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xt + tt * LDP + c);
        const float2 v = __bfloat1622float2(*px);
        *px = __floats2bfloat162_rn(w * v.x, w * v.y);
      }
      __syncthreads();
      if (warp_live) {
        // s += B^T (w x): A = B^T by ldmatrix.trans over B's [token][n] rows
#pragma unroll
        for (int kk = 0; kk < kTok; kk += 16) {
          uint32_t a[4];      // (n 0-7, tokens 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(a, bt + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDN + r0 +
                               warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int dn = 0; dn < OT / 2; ++dn) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, xt + (kk + (lane & 15)) * LDP + dn * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dn], a, bv[0], bv[1]);
            mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    // every warp is done with stage st before an iteration refills it
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: rows row_a, row_b of y (past l: not stored) or of s (past n:
  // not stored), float2 per fragment pair
  const int rows = state ? n : l;
  float* out = state ? s + (long long)chunk * n * p : y + tok0 * p;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = hh ? row_b : row_a;
    if (r >= rows) continue;
    float* orow = out + (long long)r * p + 2 * qd;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      if (t * 8 < p)
        *reinterpret_cast<float2*>(orow + t * 8) = make_float2(o[t][2 * hh], o[t][2 * hh + 1]);
  }
}

template <int PP>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   void* y, void* s, void* cd, int bh, int nc, int l, int p, int n,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p, n);
  auto kern = ssd_tc_kernel<PP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int chunks = bh * nc;
  kern<<<chunks * slabs(l, n), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C), static_cast<float*>(y),
      static_cast<float*>(s), static_cast<float*>(cd), chunks, nc, l, p, n);
  return cudaGetLastError();
}

// head dims p rounded up to 16: 16, 32, ..., 128, each its own registers
template <int PP = 16>
cudaError_t dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                     void* y, void* s, void* cd, int bh, int nc, int l, int p, int n,
                     cudaStream_t stream) {
  if (pad16(p) == PP) return launch<PP>(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, stream);
  if constexpr (PP < 128)
    return dispatch<PP + 16>(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ------------------------------------------------- CUDA-core design (f32)

constexpr int kThreadsF = 256;
constexpr int kTileRows = 16;

// Shared memory, mirrored by kernels/ssd_scan/ops.py `smem_bytes`:
// seg, dt, w [l] and a score tile [16][l + 1], then B [l + 16][n + 1]
// (its last 16 rows hold the tile of C) and x [l][p + 1].
__host__ __device__ inline size_t smem_bytes_f32(int l, int p, int n) {
  return sizeof(float) * (3 * (size_t)l + (size_t)kTileRows * (l + 1) +
                          (size_t)(l + kTileRows) * (n + 1) + (size_t)l * (p + 1));
}

__global__ void __launch_bounds__(kThreadsF)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ s,
               float* __restrict__ cd, int nc, int l, int p, int n) {
  extern __shared__ float smem[];
  const int blk = blockIdx.x;               // (batch*head) * nc + chunk
  const int bh = blk / nc;
  const long long row0 = (long long)blk * l;
  const int ldn = n + 1, ldp = p + 1, lds = l + 1;
  float* seg = smem;
  float* dtv = seg + l;
  float* wv = dtv + l;
  float* sc = wv + l;                       // [kTileRows][l + 1] score tile
  float* Bs = sc + kTileRows * lds;
  float* Cs = Bs + l * ldn;                 // [kTileRows][ldn] rows of C
  float* Xs = Cs + kTileRows * ldn;

  for (int i = threadIdx.x; i < l; i += kThreadsF) dtv[i] = dt[row0 + i];
  for (int i = threadIdx.x; i < l * n; i += kThreadsF) {
    const int r = i / n, c = i - (i / n) * n;
    Bs[r * ldn + c] = B[(row0 + r) * n + c];
  }
  for (int i = threadIdx.x; i < l * p; i += kThreadsF) {
    const int r = i / p, c = i - (i / p) * p;
    Xs[r * ldp + c] = x[(row0 + r) * p + c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[bh];
    float acc = 0.f;
    for (int i = 0; i < l; ++i) {
      acc += dtv[i] * a;
      seg[i] = acc;
    }
    cd[blk] = expf(acc);
  }
  __syncthreads();
  const float last = seg[l - 1];
  for (int i = threadIdx.x; i < l; i += kThreadsF) wv[i] = expf(last - seg[i]) * dtv[i];

  // y, one tile of kTileRows output rows at a time
  for (int i0 = 0; i0 < l; i0 += kTileRows) {
    for (int idx = threadIdx.x; idx < kTileRows * n; idx += kThreadsF) {
      const int ii = idx / n, c = idx - (idx / n) * n;
      if (i0 + ii < l) Cs[ii * ldn + c] = Cm[(row0 + i0 + ii) * n + c];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileRows * l; idx += kThreadsF) {
      const int ii = idx / l, j = idx - (idx / l) * l, i = i0 + ii;
      float v = 0.f;                        // masked before exp
      if (i < l && j <= i) {
        float cb = 0.f;
        for (int k = 0; k < n; ++k) cb = fmaf(Cs[ii * ldn + k], Bs[j * ldn + k], cb);
        v = cb * expf(seg[i] - seg[j]) * dtv[j];
      }
      sc[ii * lds + j] = v;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileRows * p; idx += kThreadsF) {
      const int ii = idx / p, c = idx - (idx / p) * p, i = i0 + ii;
      if (i >= l) continue;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(sc[ii * lds + j], Xs[j * ldp + c], acc);
      y[(row0 + i) * p + c] = acc;
    }
    __syncthreads();
  }

  // the chunk state, (n, p)
  for (int idx = threadIdx.x; idx < n * p; idx += kThreadsF) {
    const int nn = idx / p, c = idx - (idx / p) * p;
    float acc = 0.f;
    for (int j = 0; j < l; ++j) acc = fmaf(Bs[j * ldn + nn], wv[j] * Xs[j * ldp + c], acc);
    s[((long long)blk * n + nn) * p + c] = acc;
  }
}

cudaError_t launch_f32(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, void* y, void* s, void* cd, int bh, int nc, int l, int p,
                       int n, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(l, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_f32_kernel<<<bh * nc, kThreadsF, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(s), static_cast<float*>(cd), nc, l, p, n);
  return cudaGetLastError();
}

}  // namespace repro_ssd

// x (bh, nc, l, p), B and C (bh, nc, l, n), all f32 or all bf16 (dtype
// code 0 / 1); dt (bh, nc, l) and A (bh,) f32; all contiguous, bf16
// bases 16-byte aligned.  Writes y (bh, nc, l, p), s (bh, nc, n, p) and
// cd (bh, nc), f32.  Returns the CUDA error of the launch.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* dt, const void* A,
                                     const void* B, const void* C, void* y, void* s,
                                     void* cd, int bh, int nc, int l, int p, int n,
                                     int dtype, void* stream) {
  using namespace repro_ssd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (l < 1 || l > tc::kMaxChunk || p > 128) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::dispatch(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, st));
  }
  if (dtype == kF32)
    return static_cast<int>(launch_f32(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
