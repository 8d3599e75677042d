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
// decay and C . B are recomputed here.  The arithmetic is f32 from the
// inputs as given (bf16 x, B and C widened exactly); it is the gradient
// of the unrounded function, which the plain version
// (`ssd_intra_chunk_backward_plain`) computes with the same formulas.
//
// Bound: per chunk about l^2 / 2 pairs, each 4 (n + p) + 2 (n + p) flops
// between the two kernels, on l (2 n + 2 p) inputs and as many outputs:
// at mamba2-130m's training shapes (l 256, p 64, n 128) ~150 flops per
// byte, under the bf16 tensor-core ridge but above the CUDA cores'.
// This first design is the simple one, on CUDA cores: the l x l products
// stay in shared memory a 32-wide tile at a time, and the work splits
// over 64-row slabs (the f32 l x l tile of l 256 would not fit a block),
// two kernels of 256 threads and one block per (batch*head, chunk, slab):
//
// * `q_kernel` (a slab of 64 rows i): stages its C and dy rows, walks
//   the 32-row tiles of B and x at or below its last row, builds dcb in
//   shared memory and accumulates dC and the row sums of d(seg).
// * `k_kernel` (a slab of 64 columns j): stages its B and x rows, first
//   the state terms (ds staged 32 rows of n at a time), then walks the
//   32-row tiles of C and dy at or past its first column, builds scores
//   and dcb and accumulates dx, dB, ddt and the column sums of d(seg).
//
// In both, a thread computes one slab row against eight tile rows,
// so each tile row it loads serves eight products; each output element
// has one writer and a fixed order of sums (no atomics: reruns are
// bit-identical).  Shared memory: (96 (n + 1) + 96 (p + 1)) floats and
// small arrays, 110,592 / 138,880 bytes at p = n = 128.  seg is a warp
// scan (eight tokens a lane), whose order differs from a serial cumsum
// by f32 rounding.  Left for later work: tensor cores (mma.sync or
// wgmma) for the five l x l products, as the forward runs them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace repro_ssdb

// x, B, C (bh, nc, l, p | n) f32 or bf16 (dtype code 0 / 1); dt (bh, nc,
// l), A (bh,), dy (bh, nc, l, p) and ds (bh, nc, n, p) f32; all
// contiguous.  Writes dx (bh, nc, l, p), dB and dC (bh, nc, l, n), ddt,
// dseg_q, dseg_k, dww and dA (bh, nc, l), all f32 (see the top of the
// file).
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
    return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q,
                                                  dseg_k, dww, dA, bh, nc, l, p, n, st));
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, dt, A, B, C, dy, ds, dx, dB, dC, ddt, dseg_q, dseg_k,
                                          dww, dA, bh, nc, l, p, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
