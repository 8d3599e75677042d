// Backward of the Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a),
// plain C interface.
//
// The gradient of the function the TPU kernel `ssd_intra_chunk_pallas`
// (src/repro/kernels/ssd_scan/kernel.py:55) computes (ssd_scan.cu):
// per (batch*head, chunk), with seg the inclusive cumsum of dt * A,
// L_ij = exp(seg_i - seg_j) for i >= j, scores_ij = (C_i . B_j) L_ij dt_j
// and w_j = exp(seg_last - seg_j) dt_j,
//
//   y_i = sum_{j<=i} scores_ij x_j          s = sum_j w_j B_j x_j^T (n, p)
//
// given dy (l, p) and ds (n, p) in f32.  The reference has no backward
// kernel (it differentiates its XLA branch), so this is the port's own.
// With dsc_ij = dy_i . x_j and dcb_ij = dsc_ij L_ij dt_j it writes
//
//   dx_j    = sum_{i>=j} scores_ij dy_i + w_j (B_j . ds)
//   dC_i    = sum_{j<=i} dcb_ij B_j
//   dB_j    = sum_{i>=j} dcb_ij C_i + w_j (ds x_j)
//   ddt_j   = sum_{i>=j} dsc_ij (C_i . B_j) L_ij + dw_j exp(seg_last - seg_j)
//   dseg_q_i = sum_{j<=i} dsc_ij scores_ij            (through L, as row)
//   dseg_k_j = -sum_{i>=j} dsc_ij scores_ij - dw_j w_j (as column, and w)
//   dww_j   = dw_j w_j, with dw_j = B_j . (ds x_j)
//   dA_j    = sum_{i>=j} dsc_ij scores_ij (cs_i - cs_j) + dww_j (cs_last - cs_j)
//
// all f32, with cs the inclusive cumsum of dt (d seg_i / dA = cs_i).
// The host (ssd_scan/ops.py `ssd_intra_chunk_backward`) adds sum_j dww_j
// to the last position's d(seg) (seg_last enters every w_j), turns d(seg)
// into d(dt) by a reverse cumsum over the chunk, and sums dA_j over each
// batch*head's chunks: cheap elementwise work on (bh, nc, l).  dA is
// taken in that form, each pair's term times the positive cs_i - cs_j,
// and not as sum_k dt_k revcumsum(dseg)_k, where the row and column sums
// of the same terms cancel and leave f32 noise of their size.
//
// Like the flash backward, it saves nothing but the inputs: seg, the
// decay and C . B are recomputed here.  It is the gradient of the
// unrounded function in f32 at the inputs as given (bf16 x, B and C are
// exact), which the plain version (`ssd_intra_chunk_backward_plain`)
// computes with the same formulas.
//
// Bound: per chunk about l^2 / 2 pairs, each 4 (n + p) + 2 (n + p) flops
// between the two passes, on l (2 n + 2 p) inputs and as many outputs:
// at mamba2-130m's training shapes (l 256, p 64, n 128) ~150 flops per
// byte, under the bf16 tensor-core ridge (~295): the bytes bound it, and
// the design keeps the l x l products out of device memory.  The work
// splits over 64-row slabs (the f32 l x l tile of l 256 would not fit a
// block) into two passes, each one block per (batch*head, chunk, slab):
// a column pass over 64 columns j (dx, dB, ddt, dA, the column sums of
// d(seg) and the state terms) and a row pass over 64 rows i (dC and the
// row sums of d(seg)).  Each output element has one writer and a fixed
// order of sums (no atomics: reruns are bit-identical).  Two designs,
// fixed by x's dtype as the forward's (ops.py `route` mirrors it):
//
// * bf16 (every SSM and hybrid training step): namespace `tc`, on tensor
//   cores (mma.sync m16n8k16, bf16 in, f32 out), 4 warps a block, 16 slab
//   rows a warp, 32-token tiles of the other side walked on or past the
//   diagonal (a warp skips tiles wholly above or below its own).
//   - `tc::col_kernel` stages its 64 rows of B and x once, then walks
//     the tiles of ds (32 rows of n each: the state terms B_j . ds and
//     ds x_j, then dw_j from the latter's fragments) and of C and dy
//     (i >= j0) through a 2-stage cp.async ring.  Per tile it forms the
//     transposed products S^T = B C^T and dSC^T = x dy^T with the slab's
//     rows as the A operand, scales and masks them in registers (mask
//     before exp), then dx += (S^T o L^T dt) dy and dB += dCB^T C take
//     the f32 accumulators as A fragments in registers, with no shared-
//     memory round trip (the flash backward's dV = P^T dO).
//   - `tc::row_kernel` stages its 64 rows of C and of dy (split once),
//     walks the B and x tiles up to its last row through the ring, forms
//     S = C B^T and dSC = dy x^T and sums dC += dCB B.
//   Both passes form each score and dsc from the same products summed in
//   the same order, so the row and column sums of d(seg) add the same
//   terms.  Row and column sums of d(seg), ddt and dA are reduced from
//   the fragments by quad shuffles in a fixed order; dx, dB and dC go
//   from the fragments to memory as float2.  p and n are rounded up to
//   an instance's width (16, 32, 64 or 128: `width`, 16 width pairs, 33
//   kernels with the split below, for a build that stays within seconds)
//   and zero-padded in shared memory (rows padded by 16 bytes for
//   conflict-free ldmatrix).  Per 32-token tile a warp issues, at p 64
//   and n 128, 192 mma (column) and 144 (row).  Registers: both kernels
//   declare one block an SM (`__launch_bounds__(128, 1)`), so ptxas takes
//   up to 255 registers rather than spill for a higher occupancy, as it
//   did without; where
//   the dx and dB accumulators together would not fit (p = n = 128,
//   `col_splits`), the column pass is two launches, one summing dx and
//   the per-column scalars (it needs S^T and dSC^T), one dB (dSC^T
//   alone), each with half the accumulators.  seg and cs are scanned in
//   f64 (`scan`): seg reaches ~200 at l 256, where an f32 ulp of it is
//   a tenth of the rtol in exp(seg_i - seg_j); each difference is
//   rounded to f32 once, for expf.
//   Precision: round nothing that the plain version does not round.
//   Every f32 operand enters the tensor cores as a sum of bf16 pieces,
//   each piece times an exact bf16 operand (or another piece) exact in
//   f32, summed in f32:
//     dy: three pieces, hi + mid + lo, |dy - hi - mid - lo| <= 2^-24 |dy|
//       (`split3`, once per tile in shared memory): dSC = dy x^T is the
//       f32 product up to the order of its sums;
//     scores and dcb (f32 accumulators): two, |v - hi - lo| <= 2^-16 |v|
//       (`split2`, in registers); dB += dcb C and dC += dcb B as lo + hi;
//       dx += scores dy as scores_lo dy_hi + scores_hi dy_mid +
//       scores_hi dy_hi, which drops terms below 2^-16 |scores dy|;
//     ds: two pieces, |ds - hi - mid| <= 2^-16 |ds| (the state terms).
//   So each product term is off by at most ~3 x 2^-16 of its size, in
//   random directions: a sum of many such terms by about 2^-16 of its
//   terms' root-sum-square, against BWD_TOLERANCE's 1e-4 (~2^-13.3) of
//   |plain| plus 1e-4 of the row's largest.  Emulated in plain torch at
//   mamba2-130m's widths against the f64 gradient, the worst element is
//   0.12 of that bound (the f32 plain version's: 0.07; bf16 operands
//   rounded once: 200x over it); tests/test_torch_family_backward.py
//   holds the emulation to it.  The decay is expf (not __expf): L enters
//   dA and ddt unrounded.
// * f32 (taken only by the parity checks; on tensor cores it would be
//   TF32, which the port never uses): `q_kernel` and `k_kernel`, on CUDA
//   cores, 256 threads:
//   - `q_kernel` (a slab of 64 rows i): stages its C and dy rows, walks
//     the 32-row tiles of B and x at or below its last row, builds dcb in
//     shared memory and accumulates dC and the row sums of d(seg).
//   - `k_kernel` (a slab of 64 columns j): stages its B and x rows, first
//     the state terms (ds staged 32 rows of n at a time), then walks the
//     32-row tiles of C and dy at or past its first column, builds scores
//     and dcb and accumulates dx, dB, ddt and the column sums of d(seg).
//   In both, a thread computes one slab row against eight tile rows, so
//   each tile row it loads serves eight products.  Shared memory: (96 (n
//   + 1) + 96 (p + 1)) floats and small arrays, 110,592 / 138,880 bytes
//   at p = n = 128.  seg is a warp scan (eight tokens a lane), whose
//   order differs from a serial cumsum by f32 rounding.
//
// Shared memory of the bf16 design (`tc::col_smem_bytes`,
// `tc::row_smem_bytes`, mirrored by ops.py `bwd_smem_bytes`): 80,448 and
// 74,816 bytes at mamba2-130m's p 64, n 128 (two column blocks an SM);
// 64,064 and 58,432 at zamba2's p = n = 64 (three).
//
// Known limits, left for later work: no wgmma or TMA; both passes
// recompute S and dSC (the flash backward's split); a block's dy (row
// pass) and ds tiles (column pass) are split into pieces by the block
// itself, once per slab; f32 keeps the first design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_ssdb {

constexpr int kThreads = 256;
constexpr int kSlab = 64, kTile = 32, kMaxChunk = 256, kMaxDim = 128;
constexpr int kPer = kTile * kSlab / kThreads;  // products a thread makes per tile (8)
constexpr int kCols = kMaxDim / 4;              // output columns a thread holds, at most
constexpr int LDT = kSlab + 1;                  // row stride of the k kernel's score tiles
constexpr int LDQ = kTile + 1;                  // row stride of the q kernel's dcb tile
enum DTypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// rows r0 .. r0 + R - 1 of a (l, d) matrix into s [R][d + 1] as f32, rows
// past l as zeros
template <typename T>
__device__ __forceinline__ void stage(float* s, const T* g, int r0, int R, int l, int d) {
  for (int i = threadIdx.x; i < R * d; i += kThreads) {
    const int r = i / d, c = i % d;
    s[r * (d + 1) + c] = r0 + r < l ? to_f(g[(long long)(r0 + r) * d + c]) : 0.f;
  }
}

// the inclusive cumsum over the chunk of dt * a into out, warp 0, eight
// tokens a lane
__device__ __forceinline__ void warp_cumsum(float* out, const float* dt, float a, int l) {
  const int lane = threadIdx.x;
  float v[8], run = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = lane * 8 + q;
    run += (i < l ? dt[i] : 0.f) * a;
    v[q] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += y;
  }
  const float base = tot - run;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (lane * 8 + q < l) out[lane * 8 + q] = base + v[q];
}

// seg = inclusive cumsum of dt * A over the chunk, dt itself and (cs
// given) the inclusive cumsum of dt, into shared memory; warp 0
__device__ __forceinline__ void scan_seg(float* seg, float* dts, float* cs, const float* dt,
                                         float a, int l) {
  if (threadIdx.x >= 32) return;
  for (int i = threadIdx.x; i < l; i += 32) dts[i] = dt[i];
  warp_cumsum(seg, dt, a, l);
  if (cs != nullptr) warp_cumsum(cs, dt, 1.f, l);
}

size_t q_smem_floats(int p, int n) {
  return 96 * (n + 1) + 96 * (p + 1) + 2 * kMaxChunk + kSlab * LDQ + kThreads;
}

size_t k_smem_floats(int p, int n) {
  return 96 * (n + 1) + 128 * (p + 1) + 3 * kMaxChunk + 2 * kTile * LDT + 3 * kThreads + 2 * kSlab;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
q_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
         const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ dy,
         float* __restrict__ dC, float* __restrict__ dseg_q, int nc, int l, int p, int n,
         int slabs) {
  extern __shared__ __align__(16) float sm[];
  const int n1 = n + 1, p1 = p + 1;
  float* sC = sm;                       // [64][n1]  this slab's C rows
  float* sDy = sC + kSlab * n1;         // [64][p1]  and dy rows
  float* sB = sDy + kSlab * p1;         // [32][n1]  a tile of B rows
  float* sX = sB + kTile * n1;          // [32][p1]  and x rows
  float* seg = sX + kTile * p1;         // [256]
  float* dts = seg + kMaxChunk;         // [256]
  float* sD = dts + kMaxChunk;          // [64][33]  dcb of the tile
  float* red = sD + kSlab * LDQ;        // [256]
  const int slab = blockIdx.x % slabs;
  const long long ch = blockIdx.x / slabs;     // batch*head x nc + chunk
  const int i0 = slab * kSlab;
  const T* xc = x + ch * l * p;
  const T* Bc = B + ch * l * n;
  scan_seg(seg, dts, nullptr, dt + ch * l, A[ch / nc], l);
  stage(sC, C + ch * l * n, i0, kSlab, l, n);
  stage(sDy, dy + ch * l * p, i0, kSlab, l, p);

  const int pi = threadIdx.x % kSlab, pj = threadIdx.x / kSlab;   // products: row pi, tile rows pj + 4 q
  const int ai = threadIdx.x / 4, as = threadIdx.x % 4;           // dC: row ai, columns as + 4 k
  const int i = i0 + pi;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  float rowp = 0.f;
  const int j_end = min(l, i0 + kSlab);
  for (int j0 = 0; j0 < j_end; j0 += kTile) {
    __syncthreads();                    // the last tile's readers are done (and seg is in)
    stage(sB, Bc, j0, kTile, l, n);
    stage(sX, xc, j0, kTile, l, p);
    __syncthreads();
    float cb[kPer], dsc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) cb[q] = dsc[q] = 0.f;
    for (int c = 0; c < n; ++c) {
      const float ci = sC[pi * n1 + c];
#pragma unroll
      for (int q = 0; q < kPer; ++q) cb[q] = fmaf(ci, sB[(pj + 4 * q) * n1 + c], cb[q]);
    }
    for (int c = 0; c < p; ++c) {
      const float di = sDy[pi * p1 + c];
#pragma unroll
      for (int q = 0; q < kPer; ++q) dsc[q] = fmaf(di, sX[(pj + 4 * q) * p1 + c], dsc[q]);
    }
    const float seg_i = i < l ? seg[i] : 0.f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int jj = pj + 4 * q, j = j0 + jj;
      float dcb = 0.f;
      if (i < l && j <= i) {
        // the k kernel's expressions, so the row and column sums of
        // d(seg) add the same terms
        const float L = expf(seg_i - seg[j]), dt_j = dts[j];
        dcb = dsc[q] * L * dt_j;
        rowp = fmaf(dsc[q], cb[q] * L * dt_j, rowp);
      }
      sD[pi * LDQ + jj] = dcb;
    }
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float d = sD[ai * LDQ + jj];
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (as + 4 * k < n) acc[k] = fmaf(d, sB[jj * n1 + as + 4 * k], acc[k]);
    }
  }
  if (i0 + ai < l) {
    float* o = dC + (ch * l + i0 + ai) * n;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (as + 4 * k < n) o[as + 4 * k] = acc[k];
  }
  red[threadIdx.x] = rowp;
  __syncthreads();
  if (threadIdx.x < kSlab && i0 + threadIdx.x < l) {
    const float* r = red + threadIdx.x;
    dseg_q[ch * l + i0 + threadIdx.x] = ((r[0] + r[kSlab]) + r[2 * kSlab]) + r[3 * kSlab];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
         const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ dy,
         const float* __restrict__ ds, float* __restrict__ dx, float* __restrict__ dB,
         float* __restrict__ ddt, float* __restrict__ dseg_k, float* __restrict__ dww,
         float* __restrict__ dA, int nc, int l, int p, int n, int slabs) {
  extern __shared__ __align__(16) float sm[];
  const int n1 = n + 1, p1 = p + 1;
  float* sB = sm;                       // [64][n1]  this slab's B rows
  float* sX = sB + kSlab * n1;          // [64][p1]  and x rows
  float* sC = sX + kSlab * p1;          // [32][n1]  a tile of C rows
  float* sDy = sC + kTile * n1;         // [32][p1]  and dy rows
  float* sDs = sDy + kTile * p1;        // [32][p1]  32 rows of ds
  float* seg = sDs + kTile * p1;        // [256]
  float* dts = seg + kMaxChunk;         // [256]
  float* cs = dts + kMaxChunk;          // [256]     cumsum of dt
  float* sS = cs + kMaxChunk;           // [32][65]  scores of the tile
  float* sD = sS + kTile * LDT;         // [32][65]  dcb of the tile
  float* red = sD + kTile * LDT;        // [3][256]
  float* sw = red + 3 * kThreads;       // [2][64]   dw_j exp(seg_last - seg_j), dw_j w_j
  const int slab = blockIdx.x % slabs;
  const long long ch = blockIdx.x / slabs;
  const int j0 = slab * kSlab;
  scan_seg(seg, dts, cs, dt + ch * l, A[ch / nc], l);
  stage(sB, B + ch * l * n, j0, kSlab, l, n);
  stage(sX, x + ch * l * p, j0, kSlab, l, p);

  const int aj = threadIdx.x / 4, as = threadIdx.x % 4;   // dx, dB: row aj, columns as + 4 k
  float gx[kCols], gb[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) gx[k] = gb[k] = 0.f;
  // the state terms: B_j . ds into gx, ds x_j into gb, dw_j
  float dwp = 0.f;
  const float* dsc_ = ds + ch * n * p;
#pragma unroll
  for (int nb = 0; nb < kMaxDim / kTile; ++nb) {
    const int n0 = nb * kTile;
    if (n0 >= n) continue;            // uniform over the block
    __syncthreads();
    stage(sDs, dsc_, n0, kTile, n, p);
    __syncthreads();
    const int rn = min(kTile, n - n0);
    for (int r = 0; r < rn; ++r) {
      const float b = sB[aj * n1 + n0 + r];
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (as + 4 * k < p) gx[k] = fmaf(b, sDs[r * p1 + as + 4 * k], gx[k]);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 4; ++kk) {
      const int r = as + 4 * kk;
      if (r < rn) {
        float v = 0.f;
        for (int c = 0; c < p; ++c) v = fmaf(sDs[r * p1 + c], sX[aj * p1 + c], v);
        gb[nb * (kTile / 4) + kk] = v;
        dwp = fmaf(sB[aj * n1 + n0 + r], v, dwp);
      }
    }
  }
  const int ja = j0 + aj;
  const float seg_last = seg[l - 1];
  const float ej = ja < l ? expf(seg_last - seg[ja]) : 0.f;
  const float wj = ja < l ? ej * dts[ja] : 0.f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    gx[k] *= wj;
    gb[k] *= wj;
  }
  // dw_j: the four threads of row aj are one quad of lanes
  dwp += __shfl_xor_sync(0xffffffffu, dwp, 1);
  dwp += __shfl_xor_sync(0xffffffffu, dwp, 2);
  if (as == 0) {
    sw[aj] = dwp * ej;
    sw[kSlab + aj] = dwp * wj;
  }

  const int pj = threadIdx.x % kSlab, pi = threadIdx.x / kSlab;  // products: column pj, tile rows pi + 4 q
  const int j = j0 + pj;
  const float seg_j = j < l ? seg[j] : 0.f, dt_j = j < l ? dts[j] : 0.f;
  const float cs_j = j < l ? cs[j] : 0.f;
  float colp = 0.f, ddtp = 0.f, dap = 0.f;
  for (int i0 = j0; i0 < l; i0 += kTile) {
    __syncthreads();
    stage(sC, C + ch * l * n, i0, kTile, l, n);
    stage(sDy, dy + ch * l * p, i0, kTile, l, p);
    __syncthreads();
    float cb[kPer], dsc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) cb[q] = dsc[q] = 0.f;
    for (int c = 0; c < n; ++c) {
      const float bj = sB[pj * n1 + c];
#pragma unroll
      for (int q = 0; q < kPer; ++q) cb[q] = fmaf(sC[(pi + 4 * q) * n1 + c], bj, cb[q]);
    }
    for (int c = 0; c < p; ++c) {
      const float xj = sX[pj * p1 + c];
#pragma unroll
      for (int q = 0; q < kPer; ++q) dsc[q] = fmaf(sDy[(pi + 4 * q) * p1 + c], xj, dsc[q]);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int ii = pi + 4 * q, i = i0 + ii;
      float sc = 0.f, dcb = 0.f;
      if (j < l && i < l && i >= j) {
        const float L = expf(seg[i] - seg_j);
        sc = cb[q] * L * dt_j;
        dcb = dsc[q] * L * dt_j;
        colp = fmaf(dsc[q], sc, colp);
        dap = fmaf(dsc[q] * sc, cs[i] - cs_j, dap);
        ddtp = fmaf(dsc[q], cb[q] * L, ddtp);
      }
      sS[ii * LDT + pj] = sc;
      sD[ii * LDT + pj] = dcb;
    }
    __syncthreads();
    for (int ii = 0; ii < kTile; ++ii) {
      const float s = sS[ii * LDT + aj], d = sD[ii * LDT + aj];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (as + 4 * k < p) gx[k] = fmaf(s, sDy[ii * p1 + as + 4 * k], gx[k]);
        if (as + 4 * k < n) gb[k] = fmaf(d, sC[ii * n1 + as + 4 * k], gb[k]);
      }
    }
  }
  if (ja < l) {
    float* ox = dx + (ch * l + ja) * p;
    float* ob = dB + (ch * l + ja) * n;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (as + 4 * k < p) ox[as + 4 * k] = gx[k];
      if (as + 4 * k < n) ob[as + 4 * k] = gb[k];
    }
  }
  red[threadIdx.x] = colp;
  red[kThreads + threadIdx.x] = ddtp;
  red[2 * kThreads + threadIdx.x] = dap;
  __syncthreads();
  if (threadIdx.x < kSlab && j0 + threadIdx.x < l) {
    auto sum4 = [&](const float* r) {
      return ((r[0] + r[kSlab]) + r[2 * kSlab]) + r[3 * kSlab];
    };
    const int jj = j0 + threadIdx.x;
    const long long o = ch * l + jj;
    const float ww = sw[kSlab + threadIdx.x];
    ddt[o] = sum4(red + kThreads + threadIdx.x) + sw[threadIdx.x];
    dseg_k[o] = -sum4(red + threadIdx.x) - ww;
    dww[o] = ww;
    dA[o] = sum4(red + 2 * kThreads + threadIdx.x) + ww * (cs[l - 1] - cs[jj]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* dy, const void* ds, void* dx, void* dB, void* dC, void* ddt,
                   void* dseg_q, void* dseg_k, void* dww, void* dA, int bh, int nc, int l, int p,
                   int n, cudaStream_t st) {
  const int slabs = (l + kSlab - 1) / kSlab;
  const long long blocks = (long long)bh * nc * slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t qs = q_smem_floats(p, n) * sizeof(float), ks = k_smem_floats(p, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(q_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(qs));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ks));
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  k_kernel<T><<<static_cast<unsigned>(blocks), kThreads, ks, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<const float*>(ds), static_cast<float*>(dx),
      static_cast<float*>(dB), static_cast<float*>(ddt), static_cast<float*>(dseg_k),
      static_cast<float*>(dww), static_cast<float*>(dA), nc, l, p, n, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<T><<<static_cast<unsigned>(blocks), kThreads, qs, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<float*>(dC), static_cast<float*>(dseg_q), nc, l, p,
      n, slabs);
  return cudaGetLastError();
}

// ------------------------------------------------ tensor-core design (bf16)

namespace tc {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps, 16 slab rows each
constexpr int kSlab = 64;       // rows (columns j or rows i) per block
constexpr int kTok = 32;        // tokens per walked tile
constexpr int kPad = 8;         // bf16 elements of row padding (16 bytes)
constexpr int kPadF = 4;        // f32 elements of row padding (16 bytes)
constexpr int kMaxChunk = 256;  // two tokens a thread in the scan

// p and n rounded up to an instance's width: 16, 32, 64 or 128
__host__ __device__ constexpr int width(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// Shared memory of the column kernel, mirrored by kernels/ssd_scan/ops.py
// `bwd_smem_bytes`: seg and cs [256] and the scan's warp totals [8] f64,
// dt [256] and the dy / ds ring [2][32][pw + 4] f32, then B [64][nw + 8],
// the C ring [2][32][nw + 8], x [64][pw + 8] and the ring tile's three
// pieces [3][32][pw + 8] bf16.
__host__ __device__ constexpr size_t col_smem_bytes(int pw, int nw) {
  return sizeof(double) * (2 * kMaxChunk + 8) +
         sizeof(float) * (kMaxChunk + (size_t)2 * kTok * (pw + kPadF)) +
         sizeof(bf16) * ((size_t)(kSlab + 2 * kTok) * (nw + kPad) +
                         (size_t)(kSlab + 3 * kTok) * (pw + kPad));
}

// The row kernel's: seg [256] and the warp totals [8] f64, dt [256] f32,
// then C [64][nw + 8], the B ring [2][32][nw + 8], dy's three pieces
// [3][64][pw + 8] and the x ring [2][32][pw + 8] bf16.
__host__ __device__ constexpr size_t row_smem_bytes(int pw, int nw) {
  return sizeof(double) * (kMaxChunk + 8) + sizeof(float) * kMaxChunk +
         sizeof(bf16) * ((size_t)(kSlab + 2 * kTok) * (nw + kPad) +
                         (size_t)(3 * kSlab + 2 * kTok) * (pw + kPad));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair (a, b) of f32 as two bf16 pieces, packed as one fragment
// register each: hi = bf16(v), lo = bf16(v - hi), |v - hi - lo| <= 2^-16 |v|
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// a pair of f32 as three bf16 pieces into p0, p1, p2 (each a bf16 pair):
// v - hi and v - hi - mid are exact in f32, |v - hi - mid - lo| <= 2^-24 |v|
__device__ __forceinline__ void split3(float2 v, bf16* p0, bf16* p1, bf16* p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  *reinterpret_cast<__nv_bfloat162*>(p0) = h;
  *reinterpret_cast<__nv_bfloat162*>(p1) = m;
  *reinterpret_cast<__nv_bfloat162*>(p2) = __floats2bfloat162_rn(r.x - mf.x, r.y - mf.y);
}

// seg = inclusive cumsum of dt * a over the chunk, cs (if given) that of
// dt, in f64, and dt itself (0 past l), into shared memory: two tokens a
// thread, a warp scan, then the earlier warps' totals.  Ends with a
// barrier.  f64 because the pairs take differences of the sums: seg
// reaches |A| sum dt ~ 200 at l 256, where an f32 ulp (1.5e-5) is
// already a tenth of BWD_TOLERANCE's rtol in exp(seg_i - seg_j); in f64
// the difference is exact to f32 before it is rounded for expf.
__device__ __forceinline__ void scan(double* seg, double* cs, float* dts, double* wtot,
                                     const float* __restrict__ dtc, float a, int l) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, i0 = 2 * tid;
  const float d0 = i0 < l ? dtc[i0] : 0.f, d1 = i0 + 1 < l ? dtc[i0 + 1] : 0.f;
  const double v0 = (double)d0 * a, v1 = (double)d1 * a;   // exact products
  double s = v0 + v1, c = (double)d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ts = __shfl_up_sync(0xffffffffu, s, off);
    const double tcs = __shfl_up_sync(0xffffffffu, c, off);
    if (lane >= off) {
      s += ts;
      c += tcs;
    }
  }
  double ps = __shfl_up_sync(0xffffffffu, s, 1), pc = __shfl_up_sync(0xffffffffu, c, 1);
  if (lane == 0) ps = pc = 0.0;
  if (lane == 31) {
    wtot[warp] = s;
    wtot[4 + warp] = c;
  }
  __syncthreads();
  double bs = 0.0, bc = 0.0;
  for (int w = 0; w < warp; ++w) {
    bs += wtot[w];
    bc += wtot[4 + w];
  }
  seg[i0] = (bs + ps) + v0;
  seg[i0 + 1] = ((bs + ps) + v0) + v1;
  if (cs != nullptr) {
    cs[i0] = (bc + pc) + d0;
    cs[i0 + 1] = ((bc + pc) + d0) + d1;
  }
  dts[i0] = d0;
  dts[i0 + 1] = d1;
  __syncthreads();
}

// exp of the difference of two f64 sums, rounded to f32 once
__device__ __forceinline__ float exp_diff(double a, double b) {
  return expf(__double2float_rn(a - b));
}

// What a column block sums: everything (`kAll`), or, where the
// accumulators of dx and dB together would spill (`col_splits`), dx with
// the per-column scalars (`kDx`) or dB (`kDb`) in a launch of its own.
enum ColPart { kAll = 0, kDx = 1, kDb = 2 };

// column launches per call: 2 where p's and n's widths add up past 192
// (p = n = 128), else 1; mirrored by kernels/ssd_scan/ops.py `bwd_col_splits`
__host__ __device__ constexpr int col_splits(int pw, int nw) { return pw + nw > 192 ? 2 : 1; }

// The column pass: one block per 64 columns j of one chunk, 16 a warp.
// dx, dB, ddt, dseg_k, dww and dA of its columns (PART: all, or one side).
// One block an SM is enough occupancy: ptxas may take every register it
// needs rather than spill for a higher one.
template <int PW, int NW, int PART>
__global__ void __launch_bounds__(kThreads, 1)
col_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const bf16* __restrict__ B, const bf16* __restrict__ Cm, const float* __restrict__ dy,
           const float* __restrict__ ds, float* __restrict__ dx, float* __restrict__ dB,
           float* __restrict__ ddt, float* __restrict__ dseg_k, float* __restrict__ dww,
           float* __restrict__ dA, int chunks, int nc, int l, int p, int n) {
  constexpr bool DX = PART != kDb, DB = PART != kDx;
  constexpr int LDP = PW + kPad, LDN = NW + kPad, LDF = PW + kPadF;
  constexpr int XT = DX ? PW / 8 : 2, BT = DB ? NW / 8 : 2;   // dx and dB n-tiles per warp
  constexpr int NDS = (NW + kTok - 1) / kTok;   // ds tiles (32 rows of n each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* seg = reinterpret_cast<double*>(smem_raw);
  double* cs = seg + kMaxChunk;
  double* wtot = cs + kMaxChunk;
  float* dts = reinterpret_cast<float*>(wtot + 8);
  float* dyf = dts + kMaxChunk;                               // [2][32][LDF] dy or ds rows
  bf16* bsm = reinterpret_cast<bf16*>(dyf + 2 * kTok * LDF);  // [64][LDN] the slab's B
  bf16* cst = bsm + kSlab * LDN;                              // [2][32][LDN] C rows
  bf16* xsm = cst + 2 * kTok * LDN;                           // [64][LDP] the slab's x
  bf16* dyp = xsm + kSlab * LDP;                              // [3][32][LDP] pieces

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  // slabs slowest, chunks fastest: slab 0, the longest walk, first
  const int chunk = blockIdx.x % chunks, slab = blockIdx.x / chunks;
  const int j0 = slab * kSlab;
  const long long tok0 = (long long)chunk * l;
  const int T = NDS + (l - j0 + kTok - 1) / kTok;   // ds tiles, then i tiles from j0

  // the slab's rows of B and x; rows past l and columns past n or p: zeros
  for (int i = tid; i < kSlab * (NW / 8); i += kThreads) {
    const int r = i / (NW / 8), e = (i - r * (NW / 8)) * 8;
    const bool live = j0 + r < l && e < n;
    cp_async16(bsm + r * LDN + e, B + (live ? (tok0 + j0 + r) * n + e : 0), live);
  }
  for (int i = tid; i < kSlab * (PW / 8); i += kThreads) {
    const int r = i / (PW / 8), e = (i - r * (PW / 8)) * 8;
    const bool live = j0 + r < l && e < p;
    cp_async16(xsm + r * LDP + e, x + (live ? (tok0 + j0 + r) * p + e : 0), live);
  }
  // tile t into ring stage t & 1: rows 32 t .. of ds (t < NDS), else
  // rows i0 .. i0 + 31 of dy (f32) and C (bf16), i0 = j0 + 32 (t - NDS)
  auto issue = [&](int t) {
    const int st = t & 1;
    const float* src = ds + (long long)chunk * n * p;
    int r0 = t * kTok, rows = n;
    if (t >= NDS) {
      src = dy + tok0 * p;
      r0 = j0 + (t - NDS) * kTok;
      rows = l;
      bf16* cd = cst + st * kTok * LDN;
      for (int i = tid; i < kTok * (NW / 8); i += kThreads) {
        const int r = i / (NW / 8), e = (i - r * (NW / 8)) * 8;
        const bool live = r0 + r < l && e < n;
        cp_async16(cd + r * LDN + e, Cm + (live ? (tok0 + r0 + r) * n + e : 0), live);
      }
    }
    float* fd = dyf + st * kTok * LDF;
    for (int i = tid; i < kTok * (PW / 4); i += kThreads) {
      const int r = i / (PW / 4), e = (i - r * (PW / 4)) * 4;
      const bool live = r0 + r < rows && e < p;
      cp_async16(fd + r * LDF + e, src + (live ? (long long)(r0 + r) * p + e : 0), live);
    }
  };
  issue(0);
  cp_async_commit();
  scan(seg, cs, dts, wtot, dt + tok0, A[chunk / nc], l);

  // wait for tile t, start tile t + 1 into the other stage (its last
  // readers passed the barrier), and split tile t's f32 rows into dyp
  auto head = [&](int t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < T) issue(t + 1);
    cp_async_commit();
    const float* fs = dyf + (t & 1) * kTok * LDF;
    for (int i = tid; i < kTok * (PW / 2); i += kThreads) {
      const int r = i / (PW / 2), c = (i - r * (PW / 2)) * 2;
      bf16* d = dyp + r * LDP + c;
      split3(*reinterpret_cast<const float2*>(fs + r * LDF + c), d, d + kTok * LDP,
             d + 2 * kTok * LDP);
    }
    __syncthreads();
  };

  const int jw0 = j0 + warp * 16;              // the warp's first column
  const bool warp_live = jw0 < l;
  const int jr[2] = {jw0 + g, jw0 + g + 8};    // this thread's two columns
  const bf16* aB = bsm + (warp * 16 + (lane & 15)) * LDN + (lane >> 4) * 8;
  const bf16* aX = xsm + (warp * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  // B operands: non-transposed over [col][k] rows, transposed over [k][col]
  const int nt_off = (lane & 7) + ((lane >> 4) << 3), nt_k = ((lane >> 3) & 1) * 8;
  const int tr_row = lane & 15, tr_col = (lane >> 4) * 8;

  float gx[XT][4], gb[BT][4];
#pragma unroll
  for (int t = 0; t < XT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) gx[t][e] = 0.f;
#pragma unroll
  for (int t = 0; t < BT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) gb[t][e] = 0.f;

  // the state terms: B_j . ds into gx and ds x_j into gb, ds in two
  // pieces, and dw_j = B_j . (ds x_j) from each ds tile's fragments
  float dwp[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NDS; ++t) {
    head(t);
    if (!warp_live) continue;
    if constexpr (DX) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = t * kTok + h * 16;   // n of the tile's rows h * 16 ..
        if (kk < NW) {
          uint32_t a[4];
          ldsm_x4(a, aB + kk);
#pragma unroll
          for (int dn = 0; dn < XT / 2; ++dn)
#pragma unroll
            for (int pc = 1; pc >= 0; --pc) {
              uint32_t bv[4];
              ldsm_x4_trans(bv, dyp + pc * kTok * LDP + (h * 16 + tr_row) * LDP + dn * 16 + tr_col);
              mma_bf16(gx[2 * dn], a, bv[0], bv[1]);
              mma_bf16(gx[2 * dn + 1], a, bv[2], bv[3]);
            }
        }
      }
    }
    // ds x_j over the tile's n columns: into gb, or (kDx) a scratch tile
    float tmp[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[u][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PW; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, aX + kk);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        if (t * kTok + nn * 16 < NW) {
#pragma unroll
          for (int pc = 1; pc >= 0; --pc) {
            uint32_t bk[4];
            ldsm_x4(bk, dyp + pc * kTok * LDP + (nn * 16 + nt_off) * LDP + kk + nt_k);
            if constexpr (DB) {
              mma_bf16(gb[t * 4 + 2 * nn], a, bk[0], bk[1]);
              mma_bf16(gb[t * 4 + 2 * nn + 1], a, bk[2], bk[3]);
            } else {
              mma_bf16(tmp[2 * nn], a, bk[0], bk[1]);
              mma_bf16(tmp[2 * nn + 1], a, bk[2], bk[3]);
            }
          }
        }
      }
    }
    if constexpr (DX) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, c = (t * 4 + u) * 8 + 2 * qd + (e & 1);
          if ((t * 4 + u) * 8 < NW) {
            float v;
            if constexpr (DB) v = gb[t * 4 + u][e];
            else v = tmp[u][e];
            dwp[hh] = fmaf(__bfloat162float(bsm[(warp * 16 + g + 8 * hh) * LDN + c]), v, dwp[hh]);
          }
        }
    }
  }
  dwp[0] = quad_sum(dwp[0]);
  dwp[1] = quad_sum(dwp[1]);
  const double seg_last = seg[l - 1], cs_last = cs[l - 1];
  double seg_j[2], cs_j[2];
  float dt_j[2], ej[2], wj[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool live = jr[hh] < l;
    seg_j[hh] = live ? seg[jr[hh]] : 0.0;
    dt_j[hh] = live ? dts[jr[hh]] : 0.f;
    cs_j[hh] = live ? cs[jr[hh]] : 0.0;
    ej[hh] = live ? exp_diff(seg_last, seg_j[hh]) : 0.f;
    wj[hh] = ej[hh] * dt_j[hh];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (DX) {
#pragma unroll
      for (int t = 0; t < XT; ++t) gx[t][e] *= wj[e >> 1];
    }
    if constexpr (DB) {
#pragma unroll
      for (int t = 0; t < BT; ++t) gb[t][e] *= wj[e >> 1];
    }
  }

  // the walk over i >= j0: S^T = B C^T and dSC^T = x dy^T (dy in three
  // pieces), then dx += (S^T o L^T dt) dy and dB += dCB^T C from the
  // accumulators as A fragments (two pieces each)
  float colp[2] = {0.f, 0.f}, ddtp[2] = {0.f, 0.f}, dap[2] = {0.f, 0.f};
  for (int t = NDS; t < T; ++t) {
    head(t);
    const int i0 = j0 + (t - NDS) * kTok;
    if (!warp_live || i0 + kTok - 1 < jw0) continue;   // the tile is above the warp's diagonal
    const bf16* ct = cst + (t & 1) * kTok * LDN;
    float sT[4][4], dT[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[u][e] = dT[u][e] = 0.f;
    if constexpr (DX) {
#pragma unroll
      for (int kk = 0; kk < NW; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, aB + kk);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t bk[4];
          ldsm_x4(bk, ct + (nn * 16 + nt_off) * LDN + kk + nt_k);
          mma_bf16(sT[2 * nn], a, bk[0], bk[1]);
          mma_bf16(sT[2 * nn + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < PW; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, aX + kk);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
          uint32_t bk[4];
          ldsm_x4(bk, dyp + pc * kTok * LDP + (nn * 16 + nt_off) * LDP + kk + nt_k);
          mma_bf16(dT[2 * nn], a, bk[0], bk[1]);
          mma_bf16(dT[2 * nn + 1], a, bk[2], bk[3]);
        }
    }
    // element e of n-tile u: column jr[e / 2], row i0 + 8 u + 2 qd + e % 2;
    // masked before exp, and the row kernel's expressions, so the row and
    // column sums of d(seg) add the same terms
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, i = i0 + u * 8 + 2 * qd + (e & 1);
        float sc = 0.f, dcb = 0.f;
        if (i < l && i >= jr[hh]) {
          const float L = exp_diff(seg[i], seg_j[hh]);
          const float dsc = dT[u][e];
          dcb = dsc * L * dt_j[hh];
          if constexpr (DX) {
            const float cbL = sT[u][e] * L;
            sc = cbL * dt_j[hh];
            colp[hh] = fmaf(dsc, sc, colp[hh]);
            dap[hh] = fmaf(dsc * sc, __double2float_rn(cs[i] - cs_j[hh]), dap[hh]);
            ddtp[hh] = fmaf(dsc, cbL, ddtp[hh]);
          }
        }
        sT[u][e] = sc;
        dT[u][e] = dcb;
      }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if constexpr (DX) {
        uint32_t sh[4], sl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // fragment register r: n-tile 2 kt + r / 2, elements 2 (r % 2) ..
          const int u = 2 * kt + (r >> 1), e = 2 * (r & 1);
          split2(sT[u][e], sT[u][e + 1], sh[r], sl[r]);
        }
#pragma unroll
        for (int dn = 0; dn < XT / 2; ++dn) {
          uint32_t b0[4], b1[4];
          const int off = (kt * 16 + tr_row) * LDP + dn * 16 + tr_col;
          ldsm_x4_trans(b0, dyp + off);
          ldsm_x4_trans(b1, dyp + kTok * LDP + off);
          mma_bf16(gx[2 * dn], sl, b0[0], b0[1]);
          mma_bf16(gx[2 * dn + 1], sl, b0[2], b0[3]);
          mma_bf16(gx[2 * dn], sh, b1[0], b1[1]);
          mma_bf16(gx[2 * dn + 1], sh, b1[2], b1[3]);
          mma_bf16(gx[2 * dn], sh, b0[0], b0[1]);
          mma_bf16(gx[2 * dn + 1], sh, b0[2], b0[3]);
        }
      }
      if constexpr (DB) {
        uint32_t dh[4], dl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = 2 * kt + (r >> 1), e = 2 * (r & 1);
          split2(dT[u][e], dT[u][e + 1], dh[r], dl[r]);
        }
#pragma unroll
        for (int dn = 0; dn < BT / 2; ++dn) {
          uint32_t bc[4];
          ldsm_x4_trans(bc, ct + (kt * 16 + tr_row) * LDN + dn * 16 + tr_col);
          mma_bf16(gb[2 * dn], dl, bc[0], bc[1]);
          mma_bf16(gb[2 * dn + 1], dl, bc[2], bc[3]);
          mma_bf16(gb[2 * dn], dh, bc[0], bc[1]);
          mma_bf16(gb[2 * dn + 1], dh, bc[2], bc[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: dx and dB rows (columns j < l), float2 per fragment pair;
  // the row sums of each quad in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    colp[hh] = quad_sum(colp[hh]);
    ddtp[hh] = quad_sum(ddtp[hh]);
    dap[hh] = quad_sum(dap[hh]);
    const int j = jr[hh];
    if (j >= l) continue;
    if constexpr (DX) {
      float* ox = dx + (tok0 + j) * p + 2 * qd;
#pragma unroll
      for (int t = 0; t < XT; ++t)
        if (t * 8 < p)
          *reinterpret_cast<float2*>(ox + t * 8) = make_float2(gx[t][2 * hh], gx[t][2 * hh + 1]);
      if (qd == 0) {
        const long long o = tok0 + j;
        const float ww = dwp[hh] * wj[hh];
        ddt[o] = ddtp[hh] + dwp[hh] * ej[hh];
        dseg_k[o] = -colp[hh] - ww;
        dww[o] = ww;
        dA[o] = dap[hh] + ww * __double2float_rn(cs_last - cs_j[hh]);
      }
    }
    if constexpr (DB) {
      float* ob = dB + (tok0 + j) * n + 2 * qd;
#pragma unroll
      for (int t = 0; t < BT; ++t)
        if (t * 8 < n)
          *reinterpret_cast<float2*>(ob + t * 8) = make_float2(gb[t][2 * hh], gb[t][2 * hh + 1]);
    }
  }
}

// The row pass: one block per 64 rows i of one chunk, 16 a warp.  dC and
// dseg_q of its rows.  One block an SM is enough occupancy, as above.
template <int PW, int NW>
__global__ void __launch_bounds__(kThreads, 1)
row_kernel(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const bf16* __restrict__ B, const bf16* __restrict__ Cm, const float* __restrict__ dy,
           float* __restrict__ dC, float* __restrict__ dseg_q, int chunks, int nc, int l, int p,
           int n) {
  constexpr int LDP = PW + kPad, LDN = NW + kPad;
  constexpr int OT = NW / 8;                   // dC n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* seg = reinterpret_cast<double*>(smem_raw);
  double* wtot = seg + kMaxChunk;
  float* dts = reinterpret_cast<float*>(wtot + 8);
  bf16* csm = reinterpret_cast<bf16*>(dts + kMaxChunk);   // [64][LDN] the slab's C
  bf16* bst = csm + kSlab * LDN;                   // [2][32][LDN] B rows
  bf16* dyp = bst + 2 * kTok * LDN;                // [3][64][LDP] the slab's dy pieces
  bf16* xst = dyp + 3 * kSlab * LDP;               // [2][32][LDP] x rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  // slabs slowest, chunks fastest: the last slab, the longest walk, first
  const int chunk = blockIdx.x % chunks;
  const int slab = (l + kSlab - 1) / kSlab - 1 - static_cast<int>(blockIdx.x / chunks);
  const int i0 = slab * kSlab;
  const long long tok0 = (long long)chunk * l;
  const int T = (min(l, i0 + kSlab) + kTok - 1) / kTok;   // j tiles up to the slab's last row

  for (int i = tid; i < kSlab * (NW / 8); i += kThreads) {
    const int r = i / (NW / 8), e = (i - r * (NW / 8)) * 8;
    const bool live = i0 + r < l && e < n;
    cp_async16(csm + r * LDN + e, Cm + (live ? (tok0 + i0 + r) * n + e : 0), live);
  }
  // tile t (rows 32 t ..) of B and x into ring stage t & 1
  auto issue = [&](int t) {
    const int r0 = t * kTok, st = t & 1;
    bf16* bd = bst + st * kTok * LDN;
    bf16* xd = xst + st * kTok * LDP;
    for (int i = tid; i < kTok * (NW / 8); i += kThreads) {
      const int r = i / (NW / 8), e = (i - r * (NW / 8)) * 8;
      const bool live = r0 + r < l && e < n;
      cp_async16(bd + r * LDN + e, B + (live ? (tok0 + r0 + r) * n + e : 0), live);
    }
    for (int i = tid; i < kTok * (PW / 8); i += kThreads) {
      const int r = i / (PW / 8), e = (i - r * (PW / 8)) * 8;
      const bool live = r0 + r < l && e < p;
      cp_async16(xd + r * LDP + e, x + (live ? (tok0 + r0 + r) * p + e : 0), live);
    }
  };
  issue(0);
  cp_async_commit();
  // the slab's dy rows in three pieces, while the copies fly (rows past l
  // and columns past p: zeros)
  for (int i = tid; i < kSlab * (PW / 2); i += kThreads) {
    const int r = i / (PW / 2), c = (i - r * (PW / 2)) * 2;
    const float2 v = i0 + r < l && c < p
                         ? *reinterpret_cast<const float2*>(dy + (tok0 + i0 + r) * p + c)
                         : make_float2(0.f, 0.f);
    bf16* d = dyp + r * LDP + c;
    split3(v, d, d + kSlab * LDP, d + 2 * kSlab * LDP);
  }
  scan(seg, nullptr, dts, wtot, dt + tok0, A[chunk / nc], l);

  const int iw0 = i0 + warp * 16;              // the warp's first row
  const bool warp_live = iw0 < l;
  const int ir[2] = {iw0 + g, iw0 + g + 8};    // this thread's two rows
  double seg_i[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) seg_i[hh] = ir[hh] < l ? seg[ir[hh]] : 0.0;
  const bf16* aC = csm + (warp * 16 + (lane & 15)) * LDN + (lane >> 4) * 8;
  const bf16* aD = dyp + (warp * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  const int nt_off = (lane & 7) + ((lane >> 4) << 3), nt_k = ((lane >> 3) & 1) * 8;
  const int tr_row = lane & 15, tr_col = (lane >> 4) * 8;

  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float rowp[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    cp_async_wait<0>();
    __syncthreads();          // tile t is in; every warp is done with tile t - 1
    if (t + 1 < T) issue(t + 1);
    cp_async_commit();
    const int jt0 = t * kTok;
    if (!warp_live || jt0 > iw0 + 15) continue;   // the tile is past the warp's diagonal
    const bf16* bt = bst + (t & 1) * kTok * LDN;
    const bf16* xt = xst + (t & 1) * kTok * LDP;
    float S[4][4], D[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[u][e] = D[u][e] = 0.f;
    // S = C B^T and dSC = dy x^T, each element summed in the column
    // kernel's order (k ascending; dy's pieces in order within a k step)
#pragma unroll
    for (int kk = 0; kk < NW; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, aC + kk);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t bk[4];
        ldsm_x4(bk, bt + (nn * 16 + nt_off) * LDN + kk + nt_k);
        mma_bf16(S[2 * nn], a, bk[0], bk[1]);
        mma_bf16(S[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PW; kk += 16) {
      uint32_t bk[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) ldsm_x4(bk[nn], xt + (nn * 16 + nt_off) * LDP + kk + nt_k);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
        uint32_t a[4];
        ldsm_x4(a, aD + pc * kSlab * LDP + kk);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          mma_bf16(D[2 * nn], a, bk[nn][0], bk[nn][1]);
          mma_bf16(D[2 * nn + 1], a, bk[nn][2], bk[nn][3]);
        }
      }
    }
    // element e of n-tile u: row ir[e / 2], column jt0 + 8 u + 2 qd + e % 2
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, j = jt0 + u * 8 + 2 * qd + (e & 1);
        float dcb = 0.f;
        if (ir[hh] < l && j <= ir[hh]) {
          const float L = exp_diff(seg_i[hh], seg[j]);
          const float dsc = D[u][e];
          dcb = dsc * L * dts[j];
          rowp[hh] = fmaf(dsc, S[u][e] * L * dts[j], rowp[hh]);
        }
        D[u][e] = dcb;
      }
    // dC += dCB B, dCB in two pieces
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t dh[4], dl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int u = 2 * kt + (r >> 1), e = 2 * (r & 1);
        split2(D[u][e], D[u][e + 1], dh[r], dl[r]);
      }
#pragma unroll
      for (int dn = 0; dn < OT / 2; ++dn) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, bt + (kt * 16 + tr_row) * LDN + dn * 16 + tr_col);
        mma_bf16(o[2 * dn], dl, bb[0], bb[1]);
        mma_bf16(o[2 * dn + 1], dl, bb[2], bb[3]);
        mma_bf16(o[2 * dn], dh, bb[0], bb[1]);
        mma_bf16(o[2 * dn + 1], dh, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rowp[hh] = quad_sum(rowp[hh]);
    const int i = ir[hh];
    if (i >= l) continue;
    float* oc = dC + (tok0 + i) * n + 2 * qd;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      if (t * 8 < n)
        *reinterpret_cast<float2*>(oc + t * 8) = make_float2(o[t][2 * hh], o[t][2 * hh + 1]);
    if (qd == 0) dseg_q[tok0 + i] = rowp[hh];
  }
}

template <int PW, int NW>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* dy, const void* ds, void* dx, void* dB, void* dC, void* ddt,
                   void* dseg_q, void* dseg_k, void* dww, void* dA, int bh, int nc, int l, int p,
                   int n, cudaStream_t st) {
  const long long blocks = (long long)bh * nc * ((l + kSlab - 1) / kSlab);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t cs = col_smem_bytes(PW, NW), rs = row_smem_bytes(PW, NW);
  constexpr int kSplits = col_splits(PW, NW);
  auto ck = col_kernel<PW, NW, kSplits == 1 ? kAll : kDx>;
  auto rk = row_kernel<PW, NW>;
  cudaError_t err = cudaFuncSetAttribute(ck, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(cs));
  if (err != cudaSuccess) return err;
  if constexpr (kSplits > 1) {
    err = cudaFuncSetAttribute(col_kernel<PW, NW, kDb>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(cs));
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(rk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(rs));
  if (err != cudaSuccess) return err;
  const int chunks = bh * nc;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* Bt = static_cast<const bf16*>(B);
  const bf16* Ct = static_cast<const bf16*>(C);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  ck<<<static_cast<unsigned>(blocks), kThreads, cs, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<const float*>(ds), static_cast<float*>(dx),
      static_cast<float*>(dB), static_cast<float*>(ddt), static_cast<float*>(dseg_k),
      static_cast<float*>(dww), static_cast<float*>(dA), chunks, nc, l, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kSplits > 1) {
    col_kernel<PW, NW, kDb><<<static_cast<unsigned>(blocks), kThreads, cs, st>>>(
        xt, dtf, Af, Bt, Ct, dyf, static_cast<const float*>(ds), static_cast<float*>(dx),
        static_cast<float*>(dB), static_cast<float*>(ddt), static_cast<float*>(dseg_k),
        static_cast<float*>(dww), static_cast<float*>(dA), chunks, nc, l, p, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rk<<<static_cast<unsigned>(blocks), kThreads, rs, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<float*>(dC), static_cast<float*>(dseg_q), chunks,
      nc, l, p, n);
  return cudaGetLastError();
}

// the instance of p's and n's widths (16, 32, 64, 128)
template <int PW = 16, int NW = 16>
cudaError_t dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                     const void* dy, const void* ds, void* dx, void* dB, void* dC, void* ddt,
                     void* dseg_q, void* dseg_k, void* dww, void* dA, int bh, int nc, int l,
                     int p, int n, cudaStream_t st) {
  if (width(p) == PW && width(n) == NW)
    return launch<PW, NW>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k, dww, dA, bh,
                          nc, l, p, n, st);
  if constexpr (NW < 128)
    return dispatch<PW, NW * 2>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k, dww,
                                dA, bh, nc, l, p, n, st);
  else if constexpr (PW < 128)
    return dispatch<PW * 2, 16>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k, dww,
                                dA, bh, nc, l, p, n, st);
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace repro_ssdb

// x, B, C (bh, nc, l, p | n) f32 or bf16 (dtype code 0 / 1); dt (bh, nc,
// l), A (bh,), dy (bh, nc, l, p) and ds (bh, nc, n, p) f32; all
// contiguous, in bf16 every base 16-byte aligned.  Writes dx (bh, nc, l,
// p), dB and dC (bh, nc, l, n), ddt, dseg_q, dseg_k, dww and dA (bh, nc,
// l), all f32 (see the top of the file).
// l <= 256, p and n <= 128.  Two launches; returns the first CUDA error.
extern "C" int repro_ssd_intra_chunk_bwd(const void* x, const void* dt, const void* A,
                                         const void* B, const void* C, const void* dy,
                                         const void* ds, void* dx, void* dB, void* dC, void* ddt,
                                         void* dseg_q, void* dseg_k, void* dww, void* dA, int bh,
                                         int nc, int l, int p, int n, int dtype, void* stream) {
  using namespace repro_ssdb;
  if (l < 1 || l > kMaxChunk || p < 1 || p > kMaxDim || n < 1 || n > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(tc::dispatch(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k,
                                         dww, dA, bh, nc, l, p, n, st));
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k,
                                          dww, dA, bh, nc, l, p, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
