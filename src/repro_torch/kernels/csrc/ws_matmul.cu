// Weight-stationary and output-stationary blocked matmul for Hopper
// (sm_90a), plain C interface: out = x @ w, x (M, K) and w (K, N)
// row-major, contiguous, both f32 or both bf16; out (M, N) f32.
//
// Replaces the TPU kernels `ws_matmul_pallas`
// (src/repro/kernels/ws_matmul/kernel.py:49) and `os_matmul_pallas`
// (kernel.py:87), the paper's weight-stationary dataflow and its
// output-stationary twin.  What each keeps is WHICH OPERAND STAYS
// RESIDENT, since that is what the ablation measures, and both run one
// shared mainloop (`mainloop`), so nothing else differs:
//
// * The mainloop.  A block owns one n tile (bn <= 128 columns) and a
//   range of M tiles (bm <= 128 rows each) and walks the positions
//   (k tile, M tile, slice), slice fastest: each k tile is cut into
//   KS-deep slices (KS 64 in bf16, 32 in f32).  The slices of x, and of
//   w where they are not already resident, land in shared memory by
//   16-byte cp.async copies into a ring of kStages = 3 stages: slice
//   j + 2's copies are issued right after slice j's barrier, one barrier
//   per slice, and the producer runs on across M-tile and k-tile
//   boundaries, so the ring never drains between tiles.  Rows and
//   columns past bm, bn or the k tile's end are zero-filled by the
//   copy's source size.  Unaligned shapes (`vec` 0) take element copies
//   with zero-fill into the same ring, done before the stage's barrier.
//   The product of one slice is `Tile::slice`: bf16 on tensor cores
//   (ldmatrix + mma.sync m16n8k16, f32 sums in registers), f32 on CUDA
//   cores in f32 FMA (never TF32).
// * repro_os_matmul: grid (M / bm, N / bn), M tiles fastest, so the M
//   tiles of one n tile run together and re-read w from L2.  A block
//   owns one output tile: one k tile of depth K, each ring stage holds an
//   x slice and a w slice, the sums stay in registers and are written
//   once.  The weights are read once per M tile.
// * repro_ws_matmul: grid (N / bn, S).  The M tiles of one n tile are
//   split over S blocks (ws_matmul/ops.py `ws_splits`), each owning
//   disjoint output tiles: no atomics, reruns bit-identical, the
//   weights read S times.  With several M tiles in a block's range, the
//   (bk x bn) weight tile is resident in shared memory for the whole M
//   sweep: its slices arrive by cp.async with the first M tile's x
//   slices, into max(slices per k tile, kStages) weight slots, so the
//   next k tile's slices stream in as the last M tile frees their slots
//   (the whole next tile where the extra slots allow).  Only x streams
//   through the ring after the first M tile.  The f32 sums are
//   read-modify-written at each k tile (the traffic model's many-M-block
//   case): loaded back into the accumulators (zero at k tile 0), the
//   slices go on from there, and they are stored, as float2 on the
//   accumulator fragment's column pairs, without waiting on the stores:
//   tile mt + 1's sums load while tile mt's stores drain, and tile
//   mt + 1's first x slices are already in the ring.  With one
//   M tile in a block's range the weight tile has no second user: it
//   streams through kStages slots slice by slice, as in OS, and the sums
//   stay in registers (the model's m_blocks == 1 case).
//
// Both dataflows walk k in the same KS-deep slices with the same
// arithmetic, and WS's reload loses nothing, so with bk a multiple of KS
// the two kernels give bit-identical outputs.
//
// Shared memory (Layout, mirrored by ops.py `smem_bytes`): the x ring,
// then the weight slots, each rounded up to 128 bytes.  In bf16 the ring
// and three slots take 105 KB, so two blocks share an SM where the sums
// stay in registers (OS, WS with one M tile; at most 128 registers, no
// spills).  WS's read-modify-write kernel is bounded to one block per SM
// instead: the registers of one block (up to 255) let its 64 KB of sums
// and its copies be in flight at once.  Bounded to two blocks at 128
// registers it spilled and ran 1.3-1.7x slower at bk 128 (NVIDIA H100
// 80GB HBM3, 700 W).  A resident tile of bk 640 is the largest that fits
// a block beside the ring (f32: bk 320).
//
// Bound on this card: each input read once and the f32 output written
// once, over 3.35 TB/s, or 2 M N K operations over 989 TFLOP/s (bf16) or
// 67 TFLOP/s (f32).  WS cannot beat the bytes its dataflow moves: the
// read-modify-write of the f32 sums, 2 (K / bk) - 1 passes over the
// output.  Left for later work: wgmma, TMA and mbarriers, warp
// specialisation and a persistent schedule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_ws {

using namespace ::repro_mma;

constexpr int kThreads = 256;            // 8 warps
// __launch_bounds__ minimum blocks per SM: two (at most 128 registers)
// where the sums stay in registers; one for WS's read-modify-write, which
// spills at 128 (see the header)
constexpr int kMinBlocks = 2, kMinBlocksRmw = 1;
constexpr int TM = 128, TN = 128;        // the largest bm x bn a block holds
constexpr int kStages = 3;               // the ring's depth

enum DTypeCode { kF32 = 0, kBF16 = 1 };

// KS: depth of one slice; PAD: shared row padding against bank
// conflicts, keeping rows 16-byte aligned; VEC: elements per 16 bytes.
template <typename T> struct Geo;
template <> struct Geo<__nv_bfloat16> { static constexpr int KS = 64, PAD = 8, VEC = 8; };
template <> struct Geo<float> { static constexpr int KS = 32, PAD = 4, VEC = 4; };

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory: kStages x slices (TM x KS), then `w_slots` w slices
// (KS x TN).  Mirrored by ws_matmul/ops.py `smem_bytes`.
template <typename T> struct Layout {
  static constexpr int KS = Geo<T>::KS;
  static constexpr int LDX = KS + Geo<T>::PAD;
  static constexpr int LDW = TN + Geo<T>::PAD;
  static constexpr size_t kXStage = round128(sizeof(T) * TM * LDX);
  static constexpr size_t kWSlot = round128(sizeof(T) * KS * LDW);
  static constexpr size_t kWOff = kStages * kXStage;
  __host__ __device__ static constexpr size_t bytes(int w_slots) {
    return kWOff + static_cast<size_t>(w_slots) * kWSlot;
  }
  // a resident weight tile (several M tiles share it) or a streamed one
  static int w_slots(int bk, bool resident) {
    const int slices = (bk + KS - 1) / KS;
    return resident && slices > kStages ? slices : kStages;
  }
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Fill an (R x C) region of shared memory (row stride ldd) from a
// row-major global region (row stride lds): rows at or past rows_ok and
// columns at or past cols_ok become zeros.  kVec: one cp.async per VEC
// elements (the caller's alignment makes each chunk wholly in or out;
// the copy's source size zero-fills the out ones); else element copies,
// done when the call returns.  kUnroll: the chunks whose addresses are
// live at once (registers against copies in flight).
template <typename T, int R, int C, bool kVec, int kUnroll>
__device__ __forceinline__ void fill(T* dst, int ldd, const T* src, long long lds, int rows_ok,
                                     int cols_ok) {
  constexpr int V = Geo<T>::VEC, PER_ROW = C / V;
  static_assert(R * PER_ROW % kThreads == 0, "whole chunks per thread");
#pragma unroll kUnroll
  for (int it = 0; it < R * PER_ROW / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * V;
    T* d = dst + r * ldd + c;
    const T* s = src + r * lds + c;
    if constexpr (kVec) {
      const bool in = r < rows_ok && c + V <= cols_ok;
      cp_async16(d, in ? s : src, in);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = (r < rows_ok && c + j < cols_ok) ? s[j] : zero_of<T>();
    }
  }
}

// ------------------------------------------------------------ bf16 tile

// The block's 128 x 128 f32 sums on tensor cores: warp (wm, wn) = (warp
// / 2, warp % 2) holds rows 32 wm .. +32 and columns 64 wn .. +64 as
// 2 x 8 m16n8 accumulators.  Accumulator element e of (i, j) sits at row
// 32 wm + 16 i + lane / 4 + 8 (e / 2), column 64 wn + 8 j + 2 (lane % 4)
// + e % 2 (the PTX m16n8 C layout).
struct TileBF16 {
  using T = __nv_bfloat16;
  float c[2][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }

  // sums += xs (TM x KS) @ ws (KS x TN), both in shared memory
  __device__ __forceinline__ void slice(const T* xs, const T* ws) {
    constexpr int LDX = Layout<T>::LDX, LDW = Layout<T>::LDW;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int kk = 0; kk < Geo<T>::KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], xs + (wm * 32 + i * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];   // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        ldsm_x4_trans(b, ws + (kk + (lane & 15)) * LDW + wn * 64 + jj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(c[i][2 * jj], a[i], b[0], b[1]);
          mma_bf16(c[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // load (kLoad) or store the sums at o (row stride N), masked to bm x
  // bn; `pairs` (N and bn even): one float2 per column pair
  template <bool kLoad>
  __device__ __forceinline__ void move(float* o, long long N, int bm, int bn, bool pairs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32 + (lane >> 2), c0 = (warp & 1) * 64 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + i * 16 + h * 8, col = c0 + j * 8;
          float* p = o + r * N + col;
          float* v = &c[i][j][2 * h];
          if (r >= bm) continue;
          if (pairs) {
            if (col >= bn) continue;
            if (kLoad) {
              const float2 t = *reinterpret_cast<const float2*>(p);
              v[0] = t.x;
              v[1] = t.y;
            } else {
              *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < bn) {
                if (kLoad)
                  v[e] = p[e];
                else
                  p[e] = v[e];
              }
          }
        }
  }
};

// ------------------------------------------------------------- f32 tile

// The block's 128 x 128 f32 sums on CUDA cores: thread (tr, tc) = (tid /
// 16, tid % 16) holds rows tr + 16 i and columns tc + 16 j, i, j < 8, and
// runs one fmaf per product, k in order.  Its loads and stores cover 64
// contiguous bytes per row and half-warp: whole sectors already.
struct TileF32 {
  using T = float;
  float c[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void slice(const T* xs, const T* ws) {
    constexpr int LDX = Layout<T>::LDX, LDW = Layout<T>::LDW;
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < Geo<T>::KS; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[(tr + 16 * i) * LDX + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[k * LDW + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <bool kLoad>
  __device__ __forceinline__ void move(float* o, long long N, int bm, int bn, bool) {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tr + 16 * i, col = tc + 16 * j;
        if (r < bm && col < bn) {
          if (kLoad)
            c[i][j] = o[r * N + col];
          else
            o[r * N + col] = c[i][j];
        }
      }
  }
};

// --------------------------------------------------------- the mainloop

// The block owns n tile n0 and the P M tiles from mt0 on, and walks the
// positions (k tile, M tile, slice), slice fastest, k in k tiles of bk
// (OS: one k tile of K).  kRmw (several M tiles share each weight tile):
// the sums are read-modify-written at each k tile, and the weight slices
// of k tile kt, numbered kt * slices + i, take slot number mod w_slots,
// with the first M tile's x slices.  A slot is refilled w_slots slices
// later, after its last reader (the last M tile's products at
// (kt, P - 1, i)) has passed a barrier, since w_slots >= kStages and
// w_slots >= slices.  Else (P = 1) each stage's weight slice sits beside
// its x slice, and the sums stay in registers, written once at the end.
template <typename Tile, bool kVec, bool kRmw>
__device__ __forceinline__ void mainloop(const typename Tile::T* __restrict__ x,
                                         const typename Tile::T* __restrict__ w,
                                         float* __restrict__ out, int N, int K, int bm, int bn,
                                         int bk, int n0, int mt0, int P, int w_slots) {
  using T = typename Tile::T;
  using L = Layout<T>;
  constexpr int KS = Geo<T>::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  auto xs = [&](int s) { return reinterpret_cast<T*>(smem + s * L::kXStage); };
  auto ws = [&](int s) { return reinterpret_cast<T*>(smem + L::kWOff + s * L::kWSlot); };
  const int slices = (bk + KS - 1) / KS;
  if (!kRmw) P = 1;
  x += (long long)mt0 * bm * K;
  w += n0;
  out += (long long)mt0 * bm * N + n0;

  // the producer: k tile start pk, M tile pm, slice pi, weight slot pw.
  // Its copies' addresses are unrolled in full only where the kernel has
  // registers to spare (kRmw's one block per SM); the rest keeps two live,
  // which holds the two-block kernels within 128 registers, unspilled.
  constexpr int kUnroll = kRmw && kVec ? 4 : 2;
  int pk = 0, pm = 0, pi = 0, pw = 0;
  auto issue = [&](int stage) {
    const int k = pk + pi * KS, k_ok = min(KS, bk - pi * KS);
    fill<T, TM, KS, kVec, kUnroll>(xs(stage), L::LDX, x + (long long)pm * bm * K + k, K, bm,
                                   k_ok);
    if (!kRmw || pm == 0) {                // later M tiles find it resident
      fill<T, KS, TN, kVec, kUnroll>(ws(kRmw ? pw : stage), L::LDW, w + (long long)k * N, N,
                                     k_ok, bn);
      if (kRmw) pw = pw + 1 == w_slots ? 0 : pw + 1;
    }
    if (++pi < slices) return;
    pi = 0;
    if (++pm < P) return;
    pm = 0;
    pk += bk;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (pk < K) issue(s);
    cp_async_commit();
  }
  Tile acc;
  acc.zero();
  // the consumer: k tile start ck, M tile cm, slice ci, slot of (ck, 0) cw0
  int ck = 0, cm = 0, ci = 0, cw0 = 0, stage = 0;
  while (ck < K) {
    cp_async_wait<kStages - 2>();           // this slice's copies have landed ...
    __syncthreads();                        // ... for every thread; the last one is done
    if (pk < K) issue(stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();
    float* o = out + (long long)cm * bm * N;
    if (kRmw && ci == 0) {
      if (ck == 0)
        acc.zero();
      else
        acc.template move<true>(o, N, bm, bn, kVec);
    }
    const int cw = !kRmw ? stage : cw0 + ci < w_slots ? cw0 + ci : cw0 + ci - w_slots;
    acc.slice(xs(stage), ws(cw));
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (++ci < slices) continue;
    ci = 0;
    if (kRmw) acc.template move<false>(o, N, bm, bn, kVec);
    if (++cm < P) continue;
    cm = 0;
    ck += bk;
    cw0 = cw0 + slices < w_slots ? cw0 + slices : cw0 + slices - w_slots;
  }
  if (!kRmw) acc.template move<false>(out, N, bm, bn, kVec);
}

// --------------------------------------------------------------- kernels

// Grid (N / bn, S): block (ni, s) owns n tile ni and M tiles
// s * per .. min(M / bm, (s + 1) * per) - 1.  kRmw: per > 1.
template <typename Tile, bool kVec, bool kRmw>
__global__ void __launch_bounds__(kThreads, kRmw ? kMinBlocksRmw : kMinBlocks)
ws_kernel(const typename Tile::T* __restrict__ x, const typename Tile::T* __restrict__ w,
          float* __restrict__ out, int M, int N, int K, int bm, int bn, int bk, int per,
          int w_slots) {
  const int mt0 = blockIdx.y * per;
  mainloop<Tile, kVec, kRmw>(x, w, out, N, K, bm, bn, bk, blockIdx.x * bn, mt0,
                             min(M / bm - mt0, per), w_slots);
}

// Grid (M / bm, N / bn): block (mt, ni) owns one output tile.
template <typename Tile, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
os_kernel(const typename Tile::T* __restrict__ x, const typename Tile::T* __restrict__ w,
          float* __restrict__ out, int N, int K, int bm, int bn) {
  mainloop<Tile, kVec, false>(x, w, out, N, K, bm, bn, K, blockIdx.y * bn, blockIdx.x, 1,
                              kStages);
}

template <typename Tile, bool kVec> const void* kernel_of(bool os, bool rmw) {
  if (os) return reinterpret_cast<const void*>(os_kernel<Tile, kVec>);
  return rmw ? reinterpret_cast<const void*>(ws_kernel<Tile, kVec, true>)
             : reinterpret_cast<const void*>(ws_kernel<Tile, kVec, false>);
}

// The kernel a call runs (OS, or WS with `per` M tiles per block at bk;
// vec: 16-byte copies) and its dynamic shared memory.
template <typename Tile> struct Launch {
  using T = typename Tile::T;
  const void* fn;
  int w_slots;
  size_t smem;
  Launch(bool os, bool vec, int bk, int per)
      : fn(vec ? kernel_of<Tile, true>(os, per > 1) : kernel_of<Tile, false>(os, per > 1)),
        w_slots(os ? kStages : Layout<T>::w_slots(bk, per > 1)),
        smem(Layout<T>::bytes(w_slots)) {}
  cudaError_t prepare() const {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  cudaError_t run(dim3 grid, void** args, cudaStream_t stream) const {
    cudaError_t err = prepare();
    if (err == cudaSuccess) err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

template <typename Tile>
cudaError_t launch_ws(const void* x, const void* w, void* out, int M, int N, int K, int bm,
                      int bn, int bk, int splits, int vec, cudaStream_t stream) {
  int m_tiles = M / bm;
  int per = (m_tiles + splits - 1) / splits;
  const Launch<Tile> l(false, vec != 0, bk, per);
  int w_slots = l.w_slots;
  void* args[] = {&x, &w, &out, &M, &N, &K, &bm, &bn, &bk, &per, &w_slots};
  return l.run(dim3(N / bn, (m_tiles + per - 1) / per), args, stream);
}

template <typename Tile>
cudaError_t launch_os(const void* x, const void* w, void* out, int M, int N, int K, int bm,
                      int bn, int vec, cudaStream_t stream) {
  const Launch<Tile> l(true, vec != 0, 0, 1);
  void* args[] = {&x, &w, &out, &N, &K, &bm, &bn};
  return l.run(dim3(M / bm, N / bn), args, stream);
}

template <typename Tile> cudaError_t occupancy(bool os, int bk, int per, int* blocks) {
  const Launch<Tile> l(os, true, bk, per);
  cudaError_t err = l.prepare();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, l.fn, kThreads, l.smem);
}

}  // namespace repro_ws

// x (M, K) and w (K, N), both f32 or both bf16 (dtype code 0 / 1),
// contiguous; out (M, N) f32.  bm <= 128 and bn <= 128 divide M and N,
// bk divides K; `splits` is S, the blocks that share one n tile's M
// tiles.  vec = 1 when K, N, bk and bn are multiples of 16 bytes' worth
// of elements and x, w are 16-byte aligned.  The wrapper
// (ws_matmul/ops.py) checks all of this and the shared memory.  Returns
// the CUDA error of the launch.
extern "C" int repro_ws_matmul(const void* x, const void* w, void* out, int M, int N, int K,
                               int bm, int bn, int bk, int splits, int dtype, int vec,
                               void* stream) {
  using namespace repro_ws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(launch_ws<TileBF16>(x, w, out, M, N, K, bm, bn, bk, splits, vec, s));
  if (dtype == kF32)
    return static_cast<int>(launch_ws<TileF32>(x, w, out, M, N, K, bm, bn, bk, splits, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same contract without bk and S (the OS kernel walks k in KS-deep
// slices whatever bk is; bk moves none of its bytes).
extern "C" int repro_os_matmul(const void* x, const void* w, void* out, int M, int N, int K,
                               int bm, int bn, int dtype, int vec, void* stream) {
  using namespace repro_ws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(launch_os<TileBF16>(x, w, out, M, N, K, bm, bn, vec, s));
  if (dtype == kF32)
    return static_cast<int>(launch_os<TileF32>(x, w, out, M, N, K, bm, bn, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of one kernel that fit an SM together, as the launch above would
// configure it (os 1: the OS kernel; else WS at bk with `per` M tiles per
// block), into *blocks.  Returns the CUDA error.
extern "C" int repro_matmul_blocks_per_sm(int os, int dtype, int bk, int per, int* blocks) {
  using namespace repro_ws;
  if (dtype == kBF16) return static_cast<int>(occupancy<TileBF16>(os != 0, bk, per, blocks));
  if (dtype == kF32) return static_cast<int>(occupancy<TileF32>(os != 0, bk, per, blocks));
  return static_cast<int>(cudaErrorInvalidValue);
}
