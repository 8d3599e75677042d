// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `grouped_matmul_pallas`
// (src/repro/kernels/grouped_matmul/kernel.py:36): out[e] = x[e] @ w[e]
// for every expert e, x (E, C, K), w (E, K, F), f32 accumulation and an
// f32 (E, C, F) output.  An optional `rows` (E,) int32 gives the live
// rows of each expert (the dropless MoE dispatch's per-expert counts):
// rows at or past rows[e] are written as zeros and never read.  In the
// dropless buffer those rows are exact zeros, so the output is the same
// function.
//
// Bound: on the MoE serving path the live work is small.  A decode step
// routes 8 tokens x top-8 over qwen3's 128 experts, about 52 live
// experts with one or two rows each in a C = 64 buffer, so the kernel
// only streams the live experts' weights; the (E, C, F) f32 output must
// still be written whole, and at prefill's C 4096 (about 32 live rows an
// expert) its zero rows are most of the bytes.  The TPU kernel is
// weight-stationary at expert granularity (each expert's weight tile
// fetched once, every row tile streamed past it); here:
//
// * Grid (F / BN, E, C / RB), 128 threads (4 warps).  A block owns one
//   (expert, BN-column n tile, RB-row range) and reads rows[e] itself.
//   A row range with no live row (r0 >= live) writes its zeros as
//   16-byte stores and exits without reading x or w: as fast as a
//   memset of the same bytes.  Row ranges are the slowest grid
//   dimension, so every expert's first range (at prefill's C 4096 it
//   holds the expert's ~32 live rows) starts first, the weight streams
//   run beside one another, and the short dead-range blocks fill in
//   behind them instead of trailing the last expert's weight stream.
// * bf16 (`gm_bf16_kernel`): the block multiplies only the m16 tiles of
//   its range that hold live rows (at decode one, not four).  KS-deep
//   slices of w (KS x BN) and of those x rows (live m16 tiles x KS) land
//   in shared memory by 16-byte cp.async copies into a ring of kStages
//   stages; x rows past the live count are zero-filled by the copy's
//   source size, so the kernel never reads them.  One barrier per slice:
//   right after slice j's barrier the producer issues slice
//   j + kStages - 1 into the stage slice j - 1 left, so the weight
//   stream never drains.  Every weight slice serves all of the block's
//   live m16 tiles.  Warp q owns columns WN q .. WN q + WN - 1 of the n
//   tile (WN = BN / 4) for every m16 tile: ldmatrix + mma.sync m16n8k16
//   with the f32 sums in registers, stored straight from the fragments
//   as float2.  Unaligned shapes (`vec` 0: K or F not a multiple of 8,
//   or x, w not 16-byte aligned) take element copies into the same
//   ring, done before the stage's barrier.  Ragged K and F are
//   zero-filled by the copy.
// * f32 (`gm_f32_kernel`, taken only by the parity checks): the same
//   grid and dead-range stores; CUDA-core FMAs over 32-deep slices staged
//   synchronously, each thread a 4 x 8 patch.
//
// No atomics and no split over K: reruns are bit-identical.  Shared
// memory (bf16): kStages x (RB x (KS + 8) + KS x (BN + 8)) bf16, 38,912
// bytes, so five blocks share an SM (grouped_matmul/ops.py mirrors it:
// `smem_bytes`, `blocks_per_sm`) and decode's ~624 live blocks (52
// experts x 12 n tiles of the gate/up shape) run in one wave.  Deeper
// rings, 64-deep slices and BN 128 were no faster at qwen3's shapes.
// Left for later work: wgmma and TMA, and a compact per-expert layout
// that would not write the dead rows at all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_gm {

using namespace ::repro_mma;

constexpr int kThreads = 128;
constexpr int RB = 64, BN = 64;          // a block's row range and n tile
constexpr int MT = RB / 16;              // m16 tiles in a row range
constexpr int WN = BN / 4, NJ = WN / 8;  // a warp's columns and n8 tiles
enum DTypeCode { kF32 = 0, kBF16 = 1 };

// bf16 ring: KS-deep slices, row strides padded by 16 bytes (ldmatrix
// rows then fall on distinct banks; cp.async targets stay 16-byte aligned)
constexpr int KS = 32, kStages = 4;
constexpr int LDX = KS + 8, LDW = BN + 8;
constexpr int kXStage = RB * LDX, kWStage = KS * LDW;   // elements
constexpr int kMinBlocks = 5;            // __launch_bounds__: <= 96 registers,
                                         // as many blocks as shared memory holds

// f32 staging
constexpr int BKF = 32, LDAF = BKF + 1, LDBF = BN + 4;

__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : min(C, max(0, rows[e]));
}

// A row range without live rows: rows r0 .. r0 + RB - 1 (below C) and
// columns c0 .. c0 + BN - 1 (below F) of o become zeros, as float4 where
// F is a multiple of 4 (o's rows then 16-byte aligned: c0 is a multiple
// of 64 and out comes from the allocator), else element by element.
__device__ __forceinline__ void zero_range(float* o, int r0, int c0, int C, int F) {
  if (F % 4 == 0) {
    constexpr int Q = BN / 4;
    for (int i = threadIdx.x; i < RB * Q; i += kThreads) {
      const int r = r0 + i / Q, c = c0 + (i % Q) * 4;
      if (r < C && c < F)
        *reinterpret_cast<float4*>(o + (long long)r * F + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < RB * BN; i += kThreads) {
    const int r = r0 + i / BN, c = c0 + i % BN;
    if (r < C && c < F) o[(long long)r * F + c] = 0.f;
  }
}

// One ring stage: the x rows of the first mt live m16 tiles (rows at or
// past `live` zero-filled) and the (KS x BN) w slice at k0, columns past
// F and depths past K zero-filled.  kVec: one cp.async per 8 bf16 (K and
// F multiples of 8 make each chunk wholly in or out); else element
// copies, done when this returns.
template <bool kVec>
__device__ __forceinline__ void issue(__nv_bfloat16* xs, __nv_bfloat16* ws,
                                      const __nv_bfloat16* xr, const __nv_bfloat16* wc,
                                      int live, int mt, int k0, int K, int nc, int F) {
  const __nv_bfloat16 z = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < mt * 16 * (KS / 8); i += kThreads) {
    const int r = i / (KS / 8), k = k0 + (i % (KS / 8)) * 8;
    __nv_bfloat16* d = xs + r * LDX + (k - k0);
    const __nv_bfloat16* s = xr + (long long)r * K + k;
    if constexpr (kVec) {
      const bool in = r < live && k < K;
      cp_async16(d, in ? s : xr, in);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = (r < live && k + j < K) ? s[j] : z;
    }
  }
#pragma unroll
  for (int it = 0; it < KS * (BN / 8) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int kr = i / (BN / 8), c = (i % (BN / 8)) * 8;
    __nv_bfloat16* d = ws + kr * LDW + c;
    const __nv_bfloat16* s = wc + (long long)(k0 + kr) * F + c;
    if constexpr (kVec) {
      const bool in = k0 + kr < K && c < nc;
      cp_async16(d, in ? s : wc, in);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = (k0 + kr < K && c + j < nc) ? s[j] : z;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               float* __restrict__ out, const int* __restrict__ rows, int C, int K, int F) {
  __shared__ __align__(128) __nv_bfloat16 smem[kStages * (kXStage + kWStage)];
  const int e = blockIdx.y, r0 = blockIdx.z * RB, c0 = blockIdx.x * BN;
  float* o = out + (long long)e * C * F;
  const int live = live_rows(rows, e, C) - r0;     // live rows of this range
  if (live <= 0) {
    zero_range(o, r0, c0, C, F);
    return;
  }
  const int mt = min(MT, (live + 15) / 16);        // m16 tiles holding live rows
  const __nv_bfloat16* xr = x + ((long long)e * C + r0) * K;
  const __nv_bfloat16* wc = w + (long long)e * K * F + c0;
  const int nc = min(BN, F - c0);
  auto xs = [&](int s) { return smem + s * kXStage; };
  auto ws = [&](int s) { return smem + kStages * kXStage + s * kWStage; };
  const int slices = (K + KS - 1) / KS;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) issue<kVec>(xs(s), ws(s), xr, wc, live, mt, s * KS, K, nc, F);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) * WN;
  float acc[MT][NJ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int j = 0, stage = 0; j < slices; ++j) {
    cp_async_wait<kStages - 2>();                  // slice j has landed ...
    __syncthreads();                               // ... for all; slice j - 1 is done
    const int next = j + kStages - 1;
    if (next < slices)
      issue<kVec>(xs(next % kStages), ws(next % kStages), xr, wc, live, mt, next * KS, K, nc, F);
    cp_async_commit();
    const __nv_bfloat16* xsj = xs(stage);
    const __nv_bfloat16* wsj = ws(stage);
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      // per 16 columns: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t b[NJ / 2][4];
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj)
        ldsm_x4_trans(b[jj], wsj + (kk + (lane & 15)) * LDW + wn + jj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          uint32_t a[4];
          ldsm_x4(a, xsj + (i * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
            mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
          }
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // accumulator element q of (i, j): row 16 i + lane / 4 + 8 (q / 2),
  // column wn + 8 j + 2 (lane % 4) + q % 2 (the PTX m16n8 C layout)
  const bool pairs = F % 2 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + (lane >> 2) + 8 * h;
      if (r0 + r >= C) continue;
      const bool keep = r < live;
      float* p = o + (long long)(r0 + r) * F + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = wn + 8 * j + 2 * (lane & 3);
        const float v0 = keep ? acc[i][j][2 * h] : 0.f, v1 = keep ? acc[i][j][2 * h + 1] : 0.f;
        if (pairs && c < nc) {
          *reinterpret_cast<float2*>(p + c) = make_float2(v0, v1);
        } else {
          if (c < nc) p[c] = v0;
          if (c + 1 < nc) p[c + 1] = v1;
        }
      }
    }
}

__global__ void __launch_bounds__(kThreads)
gm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, const int* __restrict__ rows, int C, int K, int F) {
  __shared__ float As[RB * LDAF];
  __shared__ float Bs[BKF * LDBF];
  const int e = blockIdx.y, r0 = blockIdx.z * RB, c0 = blockIdx.x * BN;
  const int live = live_rows(rows, e, C);
  float* o = out + (long long)e * C * F;
  if (r0 >= live) {
    zero_range(o, r0, c0, C, F);
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

  for (int k0 = 0; k0 < K; k0 += BKF) {
    for (int i = threadIdx.x; i < RB * BKF; i += kThreads) {
      const int r = i / BKF, k = i % BKF;
      As[r * LDAF + k] = (r0 + r < live && k0 + k < K)
                             ? xe[(long long)(r0 + r) * K + k0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < BKF * BN; i += kThreads) {
      const int k = i / BN, c = i % BN;
      Bs[k * LDBF + c] = (k0 + k < K && c0 + c < F)
                             ? we[(long long)(k0 + k) * F + c0 + c] : 0.f;
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

// The kernel of a dtype and vec, its shared memory carved out in full
// (the bf16 kernel's five blocks per SM take 195 KB of it); null for an
// unknown dtype.
const void* kernel_of(int dtype, int vec, cudaError_t* err) {
  const void* fn = nullptr;
  if (dtype == kBF16)
    fn = vec ? reinterpret_cast<const void*>(gm_bf16_kernel<true>)
             : reinterpret_cast<const void*>(gm_bf16_kernel<false>);
  else if (dtype == kF32)
    fn = reinterpret_cast<const void*>(gm_f32_kernel);
  *err = fn == nullptr ? cudaErrorInvalidValue
                       : cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                              cudaSharedmemCarveoutMaxShared);
  return fn;
}

}  // namespace repro_gm

// x (E, C, K) and w (E, K, F), both f32 or both bf16 (dtype code 0 / 1),
// contiguous; out (E, C, F) f32; rows (E,) int32 or null.  vec = 1 when
// K and F are multiples of 8 and x, w are 16-byte aligned (bf16 then
// copies 16 bytes at a time).  Returns the CUDA error of the launch.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out,
                                    const void* rows, int E, int C, int K, int F,
                                    int dtype, int vec, void* stream) {
  using namespace repro_gm;
  cudaError_t err;
  const void* fn = kernel_of(dtype, vec, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + BN - 1) / BN, E, (C + RB - 1) / RB);
  void* args[] = {&x, &w, &out, &rows, &C, &K, &F};
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of the bf16 kernel a call with this vec runs that fit an SM
// together, from the occupancy API, into *blocks.  Returns the CUDA error.
extern "C" int repro_grouped_blocks_per_sm(int vec, int* blocks) {
  using namespace repro_gm;
  cudaError_t err;
  const void* fn = kernel_of(kBF16, vec, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0));
}
