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
// port's own.  Rows past rows[e] of x and dy are never read: dy there is
// the gradient of an output the forward wrote as zeros, and x there is no
// input of a live row.
//
// Bound: at qwen3-moe-30b-a3b's training microbatch (4,096 tokens, top-8
// of 128 experts, capacity 320, d 2048, expert width 768) each of the two
// products is about 2 x 33k live rows x 2048 x 768 = 103 GFLOP against
// ~0.3 GB of operands and 0.4 GB of bf16 dw, above the bf16 ridge: the
// tensor cores bound it.  There dX and dW each run those products at
// ~330-360 TFLOP/s on an H100 SXM (80 GB, 700 W), the rounding pass at
// the card's memory rate.  bf16 is three passes (bits of `passes`):
//
// (a) `round_dy_kernel`: dy's live rows rounded to bf16 (round to nearest
//     even) once, into a bf16 (E, C, F) scratch; rows past the live count
//     are not read, and those the TMA boxes below reach (up to the next
//     multiple of 64) are written as zeros.  The tensor cores take bf16, and the einsum twin's
//     autograd sees a bf16 dy too; the plain versions
//     (grouped_matmul/ops.py `round_dy_plain`,
//     `grouped_matmul_backward_plain`) round at the same place.
// (b, c) `wg::dx_wg_kernel`, `wg::dw_wg_kernel`: wgmma (m64n256k16, both
//     operands from 128-byte-swizzled shared memory, csrc/wgmma_common.cuh).
//     Both are persistent: one block per SM (197,696 bytes of shared
//     memory) walks work items b, b + blocks, ... in expert-major order,
//     so one expert's operands stay in L2 while its items run.  A block is
//     two consumer warpgroups and one producer warpgroup (setmaxnreg 232 /
//     40); the producer streams 64-deep steps of both operands through a
//     4-stage mbarrier ring, across item boundaries, so the next item's
//     loads run under this item's epilogue.  The bf16 dY scratch and w
//     arrive by TMA (3-d tensor maps, 64 x 64 boxes in the ring's
//     swizzle; past C, K or F they read as zeros); x by cp.async.  An
//     item's output is a 128 x 256 tile, 64 rows a consumer warpgroup (128
//     f32 accumulators a thread); the warpgroup rounds it to bf16 and
//     stores it from
//     registers, 16 bytes a lane after a transpose within each quad of
//     lanes, so the ring keeps the shared memory a staged tile would take;
//     the stores drain under the next item's products.
//     dX = dY W^T: an item is (expert, 128-row range, 256-column k tile);
//     it walks F.  The bf16 dY rows [r][f] and the w rows [k][f] both run
//     along the reduction, so both are K-major operands and w^T is never
//     formed.  A warpgroup whose 64 rows are all past the live count
//     loads and multiplies nothing and stores zeros.
//     dW = X^T dY: an item is (expert, 128-row k tile, 256-column f tile);
//     it walks the expert's live rows only.  x's rows [r][k] are X^T with M
//     contiguous and dY's rows [r][f] are B with N contiguous: both
//     MN-major operands (wgmma's transpose bits).  x's rows past the live
//     count are zero-filled as they land (cp.async with source size 0),
//     and the scratch's are zeros, so no NaN there reaches a sum.
// * f32 (`bwd_f32_kernel`, taken only by the parity checks; tensor cores
//   would make it TF32): one CUDA-core kernel for both products over
//   strided operands, 64 x 64 tiles, each thread a 4 x 8 patch.
//
// Each output element has one writer and a fixed order of sums: no
// atomics, and reruns are bit-identical.  bf16 takes K and F multiples
// of 8 and 16-byte aligned x, w, dy, dx, dw (the wrapper checks).  Left
// for later work: x by TMA with the rows past the live count zeroed in
// shared memory, an epilogue that overlaps the next item's products, and
// dX rows in granules finer than a warpgroup's 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace repro_gmb {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int TM = 64, TN = 64;          // the f32 kernel's output tile
enum DTypeCode { kF32 = 0, kBF16 = 1 };
// the passes of one call, bits of `passes` (mirrored by
// kernels/grouped_matmul/ops.py `BWD_PASSES`): dY rounded, dX, dW
enum Pass { kPassRound = 1, kPassDx = 2, kPassDw = 4 };

// f32 staging
constexpr int BKF = 32, LDAF = BKF + 1, LDBF = TN + 4;

__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : min(C, max(0, rows[e]));
}

// ---------------------------------------------------- (a) dY in bf16, once

constexpr int kRoundThreads = 256;

// chunk i: elements 8 i .. 8 i + 7 of dy, all in row i / (F / 8) of the
// E x C rows.  Rows past their expert's live count are not read; up to
// the next multiple of 64 they are written as zeros (the TMA boxes of dX
// and dW cross the live count, and a dW product must not meet a NaN of
// uninitialised memory there); no box reaches further.
__global__ void __launch_bounds__(kRoundThreads)
round_dy_kernel(const float* __restrict__ dy, bf16* __restrict__ dy16,
                const int* __restrict__ rows, int C, int F, long long chunks) {
  const long long i = (long long)blockIdx.x * kRoundThreads + threadIdx.x;
  if (i >= chunks) return;
  const long long row = i / (F / 8);
  const int e = static_cast<int>(row / C), r = static_cast<int>(row - (long long)e * C);
  const int live = live_rows(rows, e, C);
  if (r >= live) {
    if (r < (live + 63) / 64 * 64)
      *reinterpret_cast<uint4*>(dy16 + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const float4 a = *reinterpret_cast<const float4*>(dy + 8 * i);
  const float4 b = *reinterpret_cast<const float4*>(dy + 8 * i + 4);
  *reinterpret_cast<uint4*>(dy16 + 8 * i) =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                 pack_bf16(b.z, b.w));
}

// ------------------------------------------------ (b, c) dX and dW on wgmma

namespace wg {

using namespace ::repro_wg;

constexpr int kConsumers = 2;                      // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);   // and one producer warpgroup
// registers a thread after setmaxnreg: ptxas gives each of the block's
// 384 threads 168 at entry (65536 / 384), the producers give back 128 each
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "setmaxnreg asks more registers than the block holds");
constexpr int kStep = 64;                 // a ring step: F (dX) or rows (dW)
constexpr int kStages = 4;
constexpr int kTileM = 64 * kConsumers;   // an item's output rows, 64 a warpgroup
constexpr int kTileN = 256;               // an item's output columns
constexpr int kABytes = 2 * kTileM * kStep;   // a stage's A: dX dY [128][64], dW x [64][128]
constexpr int kBBytes = 2 * kTileN * kStep;   // its B: dX w [256][64], dW dY [64][256]
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64 * 64 * 2;             // one TMA box: 64 rows x 64 columns
// Shared memory, mirrored by ops.py `bwd_smem_bytes`: 1024 bytes to align
// the panels, the ring (4 x 49,152) and its 2 x 4 mbarriers: 197,696 bytes
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

enum Kind { kDx = 0, kDw = 1 };

// the work items of a call, expert-major (mirrored by ops.py
// `bwd_work_items`): dX (expert, k tile, row range), row range fastest;
// dW (expert, k tile, f tile), f tile fastest
__host__ __device__ constexpr int row_ranges(int C) { return (C + kTileM - 1) / kTileM; }
__host__ __device__ constexpr int num_items(int kind, int E, int C, int K, int F) {
  return kind == kDx ? E * ((K + kTileN - 1) / kTileN) * row_ranges(C)
                     : E * ((K + kTileM - 1) / kTileM) * ((F + kTileN - 1) / kTileN);
}

struct Item {
  int e, live, m0, n0, steps;   // output rows m0 .., columns n0 ..; ring steps
};

template <int KIND>
__device__ __forceinline__ Item item_of(int i, const int* rows, int C, int K, int F) {
  Item it;
  if constexpr (KIND == kDx) {
    const int nr = row_ranges(C), per = nr * ((K + kTileN - 1) / kTileN);
    it.e = i / per;
    const int rem = i - it.e * per;
    it.n0 = rem / nr * kTileN;
    it.m0 = rem % nr * kTileM;
    it.live = live_rows(rows, it.e, C);
    it.steps = it.m0 < it.live ? (F + kStep - 1) / kStep : 0;
  } else {
    const int nf = (F + kTileN - 1) / kTileN, per = nf * ((K + kTileM - 1) / kTileM);
    it.e = i / per;
    const int rem = i - it.e * per;
    it.m0 = rem / nf * kTileM;
    it.n0 = rem % nf * kTileN;
    it.live = live_rows(rows, it.e, C);
    it.steps = (it.live + kStep - 1) / kStep;
  }
  return it;
}

// Step j of an item into ring stage `st` (its full barrier `bar`), by the
// producer's thread pt (0 .. 127).  TMA boxes of 64 columns x 64 rows
// (`kBox` bytes, one 128-byte-swizzled panel slice each) come from the
// 3-d tensor maps of the bf16 dY scratch (F, C, E) and of w (F, K, E);
// coordinates past F, C or K read as zeros, and the scratch's rows past
// the live count are zeros.  dX: A = dY rows m0 .. m0 + 127 (the boxes
// of warpgroups with a live row) at f 64 j .., one 128-row panel; B = w
// rows (k) n0 .. n0 + 255 at the same f, one 256-row panel.  dW: A = x
// rows 64 j .. at k m0 .. m0 + 127, two 64-row panels, by cp.async,
// rows past the live count zero-filled and not read (x is the caller's:
// a NaN there must not meet a zero of dY); B = dY rows 64 j .. at f n0
// .. n0 + 255, four panels.  The copy loop stays rolled (the producers'
// 40 registers).
template <int KIND>
__device__ __forceinline__ void issue(unsigned char* st, uint64_t* bar, const Item& it, int j,
                                      const CUtensorMap* dy_map, const CUtensorMap* w_map,
                                      const bf16* x, int C, int K, int pt) {
  if constexpr (KIND == kDx) {
    if (pt == 0) {
      const int f0 = j * kStep, na = min(2, (it.live - it.m0 + 63) / 64);
      mbar_expect_tx(bar, (na + kTileN / 64) * kBox);
      for (int q = 0; q < na; ++q) tma_load_3d(st + q * kBox, dy_map, f0, it.m0 + 64 * q, it.e, bar);
      for (int q = 0; q < kTileN / 64; ++q)
        tma_load_3d(st + kABytes + q * kBox, w_map, f0, it.n0 + 64 * q, it.e, bar);
    }
  } else {
    const int c0 = j * kStep;
    if (pt == 0) {
      mbar_expect_tx(bar, kTileN / 64 * kBox);
      for (int q = 0; q < kTileN / 64; ++q)
        tma_load_3d(st + kABytes + q * kBox, dy_map, it.n0 + 64 * q, c0, it.e, bar);
    }
    const bf16* xr = x + ((long long)it.e * C + c0) * K + it.m0;
#pragma unroll 1
    for (int i = pt; i < kStep * (kTileM / 8); i += 128) {
      const int r = i >> 4, ch = i & 15;
      const bool in = c0 + r < it.live && it.m0 + 8 * ch < K;
      cp_async16(st + sw128(kStep, r, ch), in ? xr + (long long)r * K + 8 * ch : x, in);
    }
  }
}

// lane t of each quad of lanes holds v[i] of row-block i; after the 4 x 4
// transpose within the quad it holds, as v[j], lane j's v[t]
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? v[2 * b] : v[2 * b + 1], 1);
    if (odd) v[2 * b] = r; else v[2 * b + 1] = r;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, high ? v[k] : v[2 + k], 2);
    if (high) v[k] = r; else v[2 + k] = r;
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// A persistent dX (KIND kDx, out = dx) or dW (kDw, out = dw) block:
// items blockIdx.x, + gridDim.x, ...
template <int KIND>
__device__ __forceinline__ void wg_body(const CUtensorMap* dy_map, const CUtensorMap* w_map,
                                        const bf16* __restrict__ x, bf16* __restrict__ out,
                                        const int* __restrict__ rows, int C, int K, int F,
                                        int n_items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);   // [kStages]
  uint64_t* empty = full + kStages;                                              // [kStages]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer warpgroup: every step of every item of the block
    reg_dealloc<kProducerRegs>();
    const int pt = tid - 128 * kConsumers;
    int stage = 0, phase = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it = item_of<KIND>(i, rows, C, K, F);
      for (int j = 0; j < it.steps; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        issue<KIND>(ring + stage * kStageBytes, &full[stage], it, j, dy_map, w_map, x, C, K, pt);
        cp_async_arrive(&full[stage]);
        mbar_arrive(&full[stage]);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  // ---- consumer warpgroups: warpgroup w owns output rows m0 + 64 w ..
  reg_alloc<kConsumerRegs>();
  const int w = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int m_lim = KIND == kDx ? C : K;   // the output's rows a matrix
  const int n_lim = KIND == kDx ? K : F;   // and its columns
  int stage = 0, phase = 0;
  float acc[128];
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_of<KIND>(i, rows, C, K, F);
    const int r0 = it.m0 + 64 * w;
    // dX: a warpgroup with no live row; dW: one past K
    const bool mine = KIND == kDx ? r0 < it.live : r0 < K;
#pragma unroll
    for (int q = 0; q < 128; ++q) acc[q] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int j = 0; j < it.steps; ++j) {
      mbar_wait(&full[stage], phase);
      if (mine) {
        fence_proxy_async();
        wg_fence();
        const uint32_t sa = smem_u32(ring + stage * kStageBytes), sb = sa + kABytes;
        // dW: 16-row blocks wholly past the live count hold zeros only
        const int nk = KIND == kDx ? kStep / 16 : min(kStep / 16, (it.live - j * kStep + 15) / 16);
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk) {
          if (kk >= nk) break;
          if constexpr (KIND == kDx)
            wgmma_ss_n256<0, 0>(acc, desc_k(sa + 64 * w * 128 + kk * 32), desc_k(sb + kk * 32));
          else
            wgmma_ss_n256<1, 1>(acc, desc_mn(sa + w * kStep * 128 + kk * 2048, kStep * 128),
                                desc_mn(sb + kk * 2048, kStep * 128));
        }
        wg_commit();
        wg_wait<1>();   // the previous step's products are done with its stage
      }
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
    if (mine) wg_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: the warpgroup's 64 x 256 tile in bf16, straight to device
    // memory.  A thread holds columns 8 n + 2 t, + 1 of two rows
    // (accumulator element 4 n + q: row 16 wl + g + 8 (q / 2), column
    // 8 n + 2 t + q % 2); a 4 x 4 transpose within each quad of lanes
    // gives lane t the 8 columns of block 4 m + t, so a warp stores 64
    // contiguous bytes of each of its 8 rows, 16 a lane.  dX rows at or
    // past the live count are zeros.  The stores drain under the next
    // item's products.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * wl + g + 8 * h;
      const bool keep = KIND == kDw || row < it.live;
      bf16* orow = out + ((long long)it.e * m_lim + row) * n_lim + it.n0;
#pragma unroll
      for (int m = 0; m < kTileN / 32; ++m) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * m + i;
          v[i] = keep ? pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]) : 0u;
        }
        quad_transpose(v, t);
        const int col = 32 * m + 8 * t;
        if (row < m_lim && it.n0 + col < n_lim)
          *reinterpret_cast<uint4*>(orow + col) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dx_wg_kernel(const __grid_constant__ CUtensorMap dy_map, const __grid_constant__ CUtensorMap w_map,
             bf16* __restrict__ dx, const int* __restrict__ rows, int C, int K, int F,
             int n_items) {
  wg_body<kDx>(&dy_map, &w_map, nullptr, dx, rows, C, K, F, n_items);
}

__global__ void __launch_bounds__(kThreads, 1)
dw_wg_kernel(const __grid_constant__ CUtensorMap dy_map, const bf16* __restrict__ x,
             bf16* __restrict__ dw, const int* __restrict__ rows, int C, int K, int F,
             int n_items) {
  wg_body<kDw>(&dy_map, nullptr, x, dw, rows, C, K, F, n_items);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// the tensor map of a bf16 (E, rows, F) array, boxes of 64 x 64, the
// 128-byte swizzle of the ring's panels
cudaError_t map_of(CUtensorMap* map, const void* base, int E, int rows, int F) {
  EncodeTiled fn;
  cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)rows * F * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

const void* kernel_of(int kind) {
  return kind == kDx ? reinterpret_cast<const void*>(dx_wg_kernel)
                     : reinterpret_cast<const void*>(dw_wg_kernel);
}

// one block per SM, at most one per item (ops.py `bwd_grid`)
cudaError_t launch(int kind, void** args, int items, int sms, cudaStream_t st) {
  if (items == 0) return cudaSuccess;
  const void* fn = kernel_of(kind);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, dim3(items < sms ? items : sms), dim3(kThreads), args,
                         kSmemBytes, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wg

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
// of 8, x, w, dy, dx, dw 16-byte aligned, and dy16, a bf16 (E, C, F)
// scratch for dy's rounded live rows; its dX and dW blocks are
// persistent, min(items, sms) each.  Launches on `stream` the passes
// whose bits are set in `passes` (`Pass`; bf16: dy rounded, dX, dW; f32:
// dX, dW); returns the first CUDA error.
extern "C" int repro_grouped_matmul_bwd(const void* x, const void* w, const void* dy, void* dy16,
                                        void* dx, void* dw, const void* rows, int E, int C, int K,
                                        int F, int dtype, int sms, int passes, void* stream) {
  using namespace repro_gmb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (K % 8 || F % 8 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (passes & kPassRound) {
      const long long chunks = (long long)E * C * (F / 8);
      if (chunks > 0) {
        const unsigned blocks = static_cast<unsigned>((chunks + kRoundThreads - 1) / kRoundThreads);
        round_dy_kernel<<<blocks, kRoundThreads, 0, st>>>(
            static_cast<const float*>(dy), static_cast<bf16*>(dy16),
            static_cast<const int*>(rows), C, F, chunks);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    if (!(passes & (kPassDx | kPassDw))) return 0;
    CUtensorMap dy_map, w_map;
    err = wg::map_of(&dy_map, dy16, E, C, F);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (passes & kPassDx) {
      err = wg::map_of(&w_map, w, E, K, F);
      if (err != cudaSuccess) return static_cast<int>(err);
      int items = wg::num_items(wg::kDx, E, C, K, F);
      void* a1[] = {&dy_map, &w_map, &dx, &rows, &C, &K, &F, &items};
      err = wg::launch(wg::kDx, a1, items, sms, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (passes & kPassDw) {
      int items = wg::num_items(wg::kDw, E, C, K, F);
      void* a2[] = {&dy_map, &x, &dw, &rows, &C, &K, &F, &items};
      err = wg::launch(wg::kDw, a2, items, sms, st);
    }
    return static_cast<int>(err);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(bwd_f32_kernel);
  if (passes & kPassDx) {
    // dx[e] (C, K) = dy[e] (C, F) @ w[e]^T: B(f, k) = w[e][k][f]
    const dim3 gdx((K + TN - 1) / TN, E, (C + TM - 1) / TM);
    long long a_e = (long long)C * F, b_e = (long long)K * F;
    int a_m = F, a_r = 1, b_r = 1, b_n = F, on_m = 1;
    void* a1[] = {&dy, &w, &dx, &rows, &C, &K, &F, &a_e, &a_m, &a_r, &b_e, &b_r, &b_n, &on_m};
    cudaError_t err = launch(fn, gdx, a1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDw) {
    // dw[e] (K, F) = x[e]^T (K, C) @ dy[e] (C, F): A(k, c) = x[e][c][k]
    long long xa_e = (long long)C * K, da_e = (long long)C * F;
    int xa_m = 1, xa_r = K, db_r = F, db_n = 1, off_m = 0;
    const dim3 gdw((F + TN - 1) / TN, E, (K + TM - 1) / TM);
    void* a2[] = {&x, &dy, &dw, &rows, &K, &F, &C, &xa_e, &xa_m, &xa_r, &da_e, &db_r, &db_n, &off_m};
    return static_cast<int>(launch(fn, gdw, a2, st));
  }
  return 0;
}

// Blocks of the bf16 dX (kind 0) or dW (kind 1) kernel that share an SM,
// from the card's occupancy API (ops.py `bwd_blocks_per_sm` mirrors it)
extern "C" int repro_grouped_bwd_blocks_per_sm(int kind, int* blocks) {
  using namespace repro_gmb::wg;
  const void* fn = kernel_of(kind);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, kSmemBytes));
}
