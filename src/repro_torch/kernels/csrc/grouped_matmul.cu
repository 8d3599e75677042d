// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `grouped_matmul_pallas`
// (src/repro/kernels/grouped_matmul/kernel.py:36): out[e] = x[e] @ w[e]
// for every expert e, x (E, C, K), w (E, K, F), f32 accumulation and an
// f32 (E, C, F) output.  An optional `rows` (E,) int32 gives the live
// rows of each expert (the dropless MoE dispatch's per-expert counts):
// rows at or past rows[e] are written as zeros, and a row tile holding
// no live row reads neither x nor w[e].  In the dropless buffer those
// rows are exact zeros, so the output is the same function.
//
// Bound: on the MoE serving path the live work is small (a decode step
// fills at most 64 of qwen3's 128 experts with one row each), so the
// kernel is bound by the bytes of the live experts' weights, plus the
// zeros of the dead rows it must still write.  The design reads each
// live expert's weight tile once per 64-row tile and skips dead experts
// and dead row tiles outright.
//
// Grid (F / 64, C / 64, E), 128 threads (4 warps).  A block owns one
// 64 x 64 output tile and loops over K in 32-deep slices staged in
// shared memory.  bf16: each warp holds a 16 x 64 strip of f32
// accumulators as four nvcuda::wmma 16x16x16 fragments (tensor cores).
// f32: each thread holds a 4 x 8 patch and runs CUDA-core FMAs (f32 is
// taken only by the parity checks).  Ragged C, K and F edges are
// masked.  Known limits, left for later work: no wgmma, no TMA or
// cp.async pipelining of the next slice, and no persistent schedule
// over the ragged live tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace repro_gm {

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64, BK = 32;
// shared-memory row strides (elements), padded against bank conflicts
// and kept at the multiples wmma needs (8 for bf16, 4 for f32)
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int LDAF = BK + 1;
constexpr int LDBF = BN + 4;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : min(C, max(0, rows[e]));
}

// A dead row tile: zeros, without reading x or w.
__device__ __forceinline__ void zero_tile(float* o, int r0, int c0, int C, int F) {
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = r0 + i / BN, c = c0 + i % BN;
    if (r < C && c < F) o[(long long)r * F + c] = 0.f;
  }
}

// 8 consecutive bf16 of one row into shared memory: one 16-byte load
// when the row is 8-aligned in memory (vec) and wholly inside, else
// element by element with the ragged edge masked to zero.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       bool row_ok, int col, int ncols, bool vec) {
  if (row_ok && vec && col + 8 <= ncols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j] = (row_ok && col + j < ncols) ? src[j] : __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(kThreads)
gm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               float* __restrict__ out, const int* __restrict__ rows, int C, int K, int F,
               int vec) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  const int e = blockIdx.z, r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int live = live_rows(rows, e, C);
  float* o = out + (long long)e * C * F;
  if (r0 >= live) {
    zero_tile(o, r0, c0, C, F);
    return;
  }
  const __nv_bfloat16* xe = x + (long long)e * C * K;
  const __nv_bfloat16* we = w + (long long)e * K * F;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: 64 rows x 32 = 256 chunks of 8; B: 32 rows x 64 = 256 chunks
    for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), kc = (i % (BK / 8)) * 8;
      stage8(As + r * LDA + kc, xe + (long long)(r0 + r) * K + k0 + kc,
             r0 + r < live, k0 + kc, K, vec != 0);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {
      const int kr = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      stage8(Bs + kr * LDB + cc, we + (long long)(k0 + kr) * F + c0 + cc,
             k0 + kr < K, c0 + cc, F, vec != 0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int gr = r0 + r, gc = c0 + c;
    if (gr < C && gc < F) o[(long long)gr * F + gc] = gr < live ? Cs[r * LDC + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
gm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, const int* __restrict__ rows, int C, int K, int F) {
  __shared__ float As[BM * LDAF];
  __shared__ float Bs[BK * LDBF];
  const int e = blockIdx.z, r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int live = live_rows(rows, e, C);
  float* o = out + (long long)e * C * F;
  if (r0 >= live) {
    zero_tile(o, r0, c0, C, F);
    return;
  }
  const float* xe = x + (long long)e * C * K;
  const float* we = w + (long long)e * K * F;
  // thread t owns rows tr*4 .. tr*4+3 and columns tc*8 .. tc*8+7
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, k = i % BK;
      As[r * LDAF + k] = (r0 + r < live && k0 + k < K)
                             ? xe[(long long)(r0 + r) * K + k0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
      const int k = i / BN, c = i % BN;
      Bs[k * LDBF + c] = (k0 + k < K && c0 + c < F)
                             ? we[(long long)(k0 + k) * F + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + tr * 4 + i;
    if (gr >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = c0 + tc * 8 + j;
      if (gc < F) o[(long long)gr * F + gc] = gr < live ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace repro_gm

// x (E, C, K) and w (E, K, F), both f32 or both bf16 (dtype code 0 / 1),
// contiguous; out (E, C, F) f32; rows (E,) int32 or null.  vec = 1 when
// K and F are multiples of 8 and x, w are 16-byte aligned (bf16 rows
// then load as 16-byte vectors).  Returns the CUDA error of the launch.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out,
                                    const void* rows, int E, int C, int K, int F,
                                    int dtype, int vec, void* stream) {
  using namespace repro_gm;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    gm_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<float*>(out), static_cast<const int*>(rows), C, K, F, vec);
  } else if (dtype == kF32) {
    gm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<const int*>(rows), C, K, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
