// Backward of the grouped (per-expert) matmul for Hopper (sm_90a), plain
// C interface.
//
// The gradient of the function the TPU kernel `grouped_matmul_pallas`
// (src/repro/kernels/grouped_matmul/kernel.py:36) computes, y[e] =
// x[e] @ w[e] over each expert's live rows (grouped_matmul.cu), for an
// output gradient dy (E, C, F) f32:
//
//   dx[e][r] = dy[e][r] @ w[e]^T          r < rows[e]; zeros past it
//   dw[e]    = x[e][:rows[e]]^T @ dy[e][:rows[e]]
//
// dx (E, C, K) and dw (E, K, F) in the operands' type (bf16: the f32
// sums rounded once where they are stored).  The reference has no
// backward kernel (it differentiates its einsum twin), so this is the
// port's own.  Rows past rows[e] are never read: dy there is the
// gradient of an output the forward wrote as zeros, and x there is no
// input of a live row.
//
// Bound: at qwen3-moe-30b-a3b's training microbatch (4,096 tokens, top-8
// of 128 experts, capacity 320, d 2048, expert width 768) each of the two
// products is about 2 x 33k live rows x 2048 x 768 = 103 GFLOP against
// ~0.3 GB of operands and 0.4 GB of bf16 dw: above the bf16 ridge, so
// the tensor cores bound it, and the design keeps both products on
// them without materialising w^T or x^T:
//
// * dx (`dx_bf16_kernel`) is the forward's mainloop (grouped_matmul.cu,
//   `gm_bf16_kernel`) with its B operand read transposed: grid
//   (K / 64, E, C / 64), a block owns an (expert, 64-column k tile,
//   64-row range), multiplies only the m16 tiles holding live rows, and
//   walks F in 32-deep slices through a 3-stage cp.async ring.  w's rows
//   [k][f] land in shared memory as they lie in device memory; as the
//   col-major B of mma.sync they are read by plain ldmatrix (as flash
//   reads K for Q K^T), so w^T is never formed.  A row range with no
//   live row writes its zeros and exits.
// * dw (`dw_bf16_kernel`) reduces over rows, so it has a kernel of its
//   own: grid (F / 64, K / 64, E), a block owns one 64 x 64 (k, f) tile
//   of one expert and walks that expert's live rows 32 at a time through
//   the same kind of ring; x is the A operand read transposed
//   (ldmatrix.trans over its [row][k] slices), dy the B operand.  An
//   expert with no live row writes a tile of zeros.
// * dy arrives in f32 (the forward's output type).  It moves into shared
//   memory as f32 by cp.async and is rounded to bf16 (round to nearest
//   even) once, where its fragments are built: the tensor cores take
//   bf16, and the einsum twin's autograd sees a bf16 dy too.  The plain
//   version (grouped_matmul/ops.py `grouped_matmul_backward_plain`)
//   rounds it at the same place.  f32 row strides of 40 (dx) and 68 (dw)
//   words keep those fragment loads free of bank conflicts.
// * f32 (`bwd_f32_kernel`, taken only by the parity checks; tensor cores
//   would make it TF32): one CUDA-core kernel for both products over
//   strided operands, 64 x 64 tiles, each thread a 4 x 8 patch.
//
// Each output element has one writer and a fixed order of sums: no
// atomics, and reruns are bit-identical.  bf16 takes K and F multiples
// of 8 and 16-byte aligned x, w and dy (the wrapper checks).  Left for
// later work: wgmma and TMA, and a dw that stages each x slice once for
// all of an expert's f tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_gmb {

using namespace ::repro_mma;

constexpr int kThreads = 128;
constexpr int TM = 64, TN = 64;          // a block's output tile
constexpr int MT = TM / 16;              // m16 tiles of a tile
constexpr int WN = TN / 4, NJ = WN / 8;  // a warp's columns and n8 tiles
constexpr int kStages = 3;
enum DTypeCode { kF32 = 0, kBF16 = 1 };

// dx ring: 32-deep slices of F; dy [64 rows][40] f32, w [64 k][40] bf16
constexpr int KS = 32, LDY = KS + 8, LDW = KS + 8;
constexpr int kDyStage = TM * LDY, kWStage = TN * LDW;
// dw ring: 32 rows a slice; x [32 rows][72] bf16, dy [32 rows][68] f32
constexpr int RS = 32, LDX = TM + 8, LDD = TN + 4;
constexpr int kXStage = RS * LDX, kDStage = RS * LDD;

// f32 staging
constexpr int BKF = 32, LDAF = BKF + 1, LDBF = TN + 4;

__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : min(C, max(0, rows[e]));
}

// ------------------------------------------------------------------ dx

// One stage: f32 dy rows of the first mt live m16 tiles (rows at or past
// `live` zero-filled) and w rows k0 .. k0 + 63 (past K zero-filled), at
// depths f0 .. f0 + 31 (past F zero-filled).
__device__ __forceinline__ void dx_issue(float* ys, __nv_bfloat16* ws, const float* dyr,
                                         const __nv_bfloat16* wr, int live, int mt, int f0,
                                         int F, int nk) {
  for (int i = threadIdx.x; i < mt * 16 * (KS / 4); i += kThreads) {
    const int r = i / (KS / 4), f = f0 + (i % (KS / 4)) * 4;
    const bool in = r < live && f < F;
    cp_async16(ys + r * LDY + (f - f0), in ? dyr + (long long)r * F + f : dyr, in);
  }
#pragma unroll
  for (int it = 0; it < TN * (KS / 8) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / (KS / 8), f = f0 + (i % (KS / 8)) * 8;
    const bool in = r < nk && f < F;
    cp_async16(ws + r * LDW + (f - f0), in ? wr + (long long)r * F + f : wr, in);
  }
}

// zeros over rows r0 .. r0 + 63 (below C) and columns c0 .. c0 + 63
// (below N) of o, a row-major (C, N) bf16 matrix with N % 4 == 0
__device__ __forceinline__ void zero_tile(__nv_bfloat16* o, int r0, int c0, int C, int N) {
  constexpr int Q = TN / 4;
  for (int i = threadIdx.x; i < TM * Q; i += kThreads) {
    const int r = r0 + i / Q, c = c0 + (i % Q) * 4;
    if (r < C && c < N) *reinterpret_cast<uint2*>(o + (long long)r * N + c) = make_uint2(0u, 0u);
  }
}

// two accumulators rounded to bf16 (round to nearest even) at p, an
// even element offset
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__global__ void __launch_bounds__(kThreads)
dx_bf16_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ dy,
               __nv_bfloat16* __restrict__ dx, const int* __restrict__ rows, int C, int K, int F) {
  __shared__ __align__(128) float ysm[kStages * kDyStage];
  __shared__ __align__(128) __nv_bfloat16 wsm[kStages * kWStage];
  const int e = blockIdx.y, r0 = blockIdx.z * TM, k0 = blockIdx.x * TN;
  __nv_bfloat16* o = dx + (long long)e * C * K;
  const int live = live_rows(rows, e, C) - r0;
  if (live <= 0) {
    zero_tile(o, r0, k0, C, K);
    return;
  }
  const int mt = min(MT, (live + 15) / 16);
  const float* dyr = dy + ((long long)e * C + r0) * F;
  const __nv_bfloat16* wr = w + ((long long)e * K + k0) * F;
  const int nk = min(TN, K - k0);
  const int slices = (F + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) dx_issue(ysm + s * kDyStage, wsm + s * kWStage, dyr, wr, live, mt, s * KS, F, nk);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) * WN;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NJ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int j = 0, stage = 0; j < slices; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = j + kStages - 1;
    if (next < slices)
      dx_issue(ysm + (next % kStages) * kDyStage, wsm + (next % kStages) * kWStage, dyr, wr,
               live, mt, next * KS, F, nk);
    cp_async_commit();
    const float* ys = ysm + stage * kDyStage;
    const __nv_bfloat16* ws = wsm + stage * kWStage;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      // w rows are the col-major B: (k 0-7, f 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
      uint32_t b[4];
      ldsm_x4(b, ws + (wn + (lane & 7) + ((lane >> 4) << 3)) * LDW + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          // the A fragment of dy rows, rounded to bf16 here
          const float* ar = ys + (i * 16 + g) * LDY + kk + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(ar);
          const float2 v1 = *reinterpret_cast<const float2*>(ar + 8 * LDY);
          const float2 v2 = *reinterpret_cast<const float2*>(ar + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(ar + 8 * LDY + 8);
          const uint32_t a[4] = {pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y),
                                 pack_bf16(v2.x, v2.y), pack_bf16(v3.x, v3.y)};
          mma_bf16(acc[i][0], a, b[0], b[1]);
          mma_bf16(acc[i][1], a, b[2], b[3]);
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // accumulator element q of (i, j): row 16 i + g + 8 (q / 2), column
  // wn + 8 j + 2 t + q % 2
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + 8 * h;
      if (r0 + r >= C) continue;
      const bool keep = r < live;
      __nv_bfloat16* p = o + (long long)(r0 + r) * K + k0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = wn + 8 * j + 2 * t;
        if (c < nk)
          store_bf16x2(p + c, keep ? acc[i][j][2 * h] : 0.f, keep ? acc[i][j][2 * h + 1] : 0.f);
      }
    }
}

// ------------------------------------------------------------------ dw

// One stage: x rows c0 .. c0 + 31 at columns k0 .. k0 + 63 and dy rows
// c0 .. c0 + 31 at columns f0 .. f0 + 63; rows at or past `live` and
// columns past K or F zero-filled.
__device__ __forceinline__ void dw_issue(__nv_bfloat16* xs, float* ds, const __nv_bfloat16* xe,
                                         const float* dye, int live, int c0, int k0, int K,
                                         int f0, int F) {
#pragma unroll
  for (int it = 0; it < RS * (TM / 8) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / (TM / 8), k = k0 + (i % (TM / 8)) * 8;
    const bool in = c0 + r < live && k < K;
    cp_async16(xs + r * LDX + (k - k0), in ? xe + (long long)(c0 + r) * K + k : xe, in);
  }
#pragma unroll
  for (int it = 0; it < RS * (TN / 4) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / (TN / 4), f = f0 + (i % (TN / 4)) * 4;
    const bool in = c0 + r < live && f < F;
    cp_async16(ds + r * LDD + (f - f0), in ? dye + (long long)(c0 + r) * F + f : dye, in);
  }
}

__global__ void __launch_bounds__(kThreads)
dw_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dy,
               __nv_bfloat16* __restrict__ dw, const int* __restrict__ rows, int C, int K, int F) {
  __shared__ __align__(128) __nv_bfloat16 xsm[kStages * kXStage];
  __shared__ __align__(128) float dsm[kStages * kDStage];
  const int e = blockIdx.z, k0 = blockIdx.y * TM, f0 = blockIdx.x * TN;
  const int live = live_rows(rows, e, C);
  const __nv_bfloat16* xe = x + (long long)e * C * K;
  const float* dye = dy + (long long)e * C * F;
  const int slices = (live + RS - 1) / RS;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) dw_issue(xsm + s * kXStage, dsm + s * kDStage, xe, dye, live, s * RS, k0, K, f0, F);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) * WN;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NJ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int j = 0, stage = 0; j < slices; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = j + kStages - 1;
    if (next < slices)
      dw_issue(xsm + (next % kStages) * kXStage, dsm + (next % kStages) * kDStage, xe, dye, live,
               next * RS, k0, K, f0, F);
    cp_async_commit();
    const __nv_bfloat16* xs = xsm + stage * kXStage;
    const float* ds = dsm + stage * kDStage;
#pragma unroll
    for (int kk = 0; kk < RS; kk += 16) {
      // dy's B fragments (rows kk + 2 t .., column wn + 8 j + g), rounded to bf16 here
      uint32_t b[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float* bc = ds + (kk + 2 * t) * LDD + wn + 8 * jj + g;
        b[jj][0] = pack_bf16(bc[0], bc[LDD]);
        b[jj][1] = pack_bf16(bc[8 * LDD], bc[9 * LDD]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // x^T's A fragment: (k 0-7, rows 0-7), (k 8-15, rows 0-7),
        // (k 0-7, rows 8-15), (k 8-15, rows 8-15), each 8 x 8 transposed
        uint32_t a[4];
        ldsm_x4_trans(a, xs + (kk + ((lane >> 4) << 3) + (lane & 7)) * LDX + i * 16 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) mma_bf16(acc[i][jj], a, b[jj][0], b[jj][1]);
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  __nv_bfloat16* o = dw + (long long)e * K * F;
  const int nf = min(TN, F - f0);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = k0 + i * 16 + g + 8 * h;
      if (r >= K) continue;
      __nv_bfloat16* p = o + (long long)r * F + f0;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = wn + 8 * jj + 2 * t;
        if (c < nf) store_bf16x2(p + c, acc[i][jj][2 * h], acc[i][jj][2 * h + 1]);
      }
    }
}

// ----------------------------------------------------------------- f32

// out[e] (M, N) = A[e] (M, R) @ B[e] (R, N) over strided operands
// (element (e, m, r) of A at e * a_e + m * a_m + r * a_r, likewise B).
// The live count of expert e bounds the output rows (`live_on_m`: dx,
// whose rows past it are zeros) or the reduction (dw).
__global__ void __launch_bounds__(kThreads)
bwd_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ out,
               const int* __restrict__ rows, int M, int N, int R, long long a_e, int a_m, int a_r,
               long long b_e, int b_r, int b_n, int live_on_m) {
  __shared__ float As[TM * LDAF];
  __shared__ float Bs[BKF * LDBF];
  const int e = blockIdx.y, r0 = blockIdx.z * TM, c0 = blockIdx.x * TN;
  const int live = live_rows(rows, e, live_on_m ? M : R);
  const int mlim = live_on_m ? live : M, rlim = live_on_m ? R : live;
  float* o = out + (long long)e * M * N;
  const float* Ae = A + e * a_e;
  const float* Be = B + e * b_e;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (r0 < mlim) {
    for (int k0 = 0; k0 < rlim; k0 += BKF) {
      for (int i = threadIdx.x; i < TM * BKF; i += kThreads) {
        const int r = i / BKF, k = i % BKF;
        As[r * LDAF + k] = (r0 + r < mlim && k0 + k < rlim)
                               ? Ae[(long long)(r0 + r) * a_m + (long long)(k0 + k) * a_r] : 0.f;
      }
      for (int i = threadIdx.x; i < BKF * TN; i += kThreads) {
        const int k = i / TN, c = i % TN;
        Bs[k * LDBF + c] = (k0 + k < rlim && c0 + c < N)
                               ? Be[(long long)(k0 + k) * b_r + (long long)(c0 + c) * b_n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BKF; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(tr * 4 + i) * LDAF + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[k * LDBF + tc * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + tr * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = c0 + tc * 8 + j;
      if (gc < N) o[(long long)gr * N + gc] = gr < mlim ? acc[i][j] : 0.f;
    }
  }
}

cudaError_t launch(const void* fn, dim3 grid, void** args, cudaStream_t st) {
  cudaError_t err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace repro_gmb

// x (E, C, K), w (E, K, F), both f32 or both bf16 (dtype code 0 / 1);
// dy (E, C, F) f32; rows (E,) int32 or null; all contiguous.  Writes dx
// (E, C, K) and dw (E, K, F) in x's type.  bf16 wants K and F multiples
// of 8 and x, w, dy, dx, dw 16-byte aligned.  Two launches (dx, then dw); returns
// the first CUDA error.
extern "C" int repro_grouped_matmul_bwd(const void* x, const void* w, const void* dy, void* dx,
                                        void* dw, const void* rows, int E, int C, int K, int F,
                                        int dtype, void* stream) {
  using namespace repro_gmb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gdx((K + TN - 1) / TN, E, (C + TM - 1) / TM);
  if (dtype == kBF16) {
    if (K % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
    void* a1[] = {&w, &dy, &dx, &rows, &C, &K, &F};
    cudaError_t err = launch(reinterpret_cast<const void*>(dx_bf16_kernel), gdx, a1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 gdw((F + TN - 1) / TN, (K + TM - 1) / TM, E);
    void* a2[] = {&x, &dy, &dw, &rows, &C, &K, &F};
    return static_cast<int>(launch(reinterpret_cast<const void*>(dw_bf16_kernel), gdw, a2, st));
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(bwd_f32_kernel);
  // dx[e] (C, K) = dy[e] (C, F) @ w[e]^T: B(f, k) = w[e][k][f]
  long long a_e = (long long)C * F, b_e = (long long)K * F;
  int a_m = F, a_r = 1, b_r = 1, b_n = F, on_m = 1;
  void* a1[] = {&dy, &w, &dx, &rows, &C, &K, &F, &a_e, &a_m, &a_r, &b_e, &b_r, &b_n, &on_m};
  cudaError_t err = launch(fn, gdx, a1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dw[e] (K, F) = x[e]^T (K, C) @ dy[e] (C, F): A(k, c) = x[e][c][k]
  long long xa_e = (long long)C * K, da_e = (long long)C * F;
  int xa_m = 1, xa_r = K, db_r = F, db_n = 1, off_m = 0;
  const dim3 gdw((F + TN - 1) / TN, E, (K + TM - 1) / TM);
  void* a2[] = {&x, &dy, &dw, &rows, &K, &F, &C, &xa_e, &xa_m, &xa_r, &da_e, &db_r, &db_n, &off_m};
  return static_cast<int>(launch(fn, gdw, a2, st));
}
