// Weight-stationary and output-stationary blocked matmul for Hopper
// (sm_90a), plain C interface: out = x @ w, x (M, K) and w (K, N)
// row-major, contiguous, both f32 or both bf16; out (M, N) f32.
//
// Replaces the TPU kernels `ws_matmul_pallas`
// (src/repro/kernels/ws_matmul/kernel.py:49) and `os_matmul_pallas`
// (kernel.py:87), the paper's weight-stationary dataflow and its
// output-stationary twin.  What each keeps is WHICH OPERAND STAYS
// RESIDENT, since that is what the ablation measures:
//
// * repro_ws_matmul: a block loads a (bk x bn) weight tile into shared
//   memory once, then streams every M tile of its range past it (x in
//   KS-deep slices: a 512 x 128 bf16 weight tile is already 136 KB of a
//   block's 227 KB) before it loads the next k-tile.  The k loop runs
//   inside the block, in the TPU's order.  With one M tile in the range
//   the f32 output tile stays in registers across k (the traffic model's
//   m_blocks == 1 case); with more, it is written at k-tile 0 and
//   read-modified-written at each later k-tile (`_ws_kernel`): the sums
//   are loaded back into the accumulators and the product goes on from
//   there.  Blocks run in parallel, so the M tiles of one n tile are
//   split over S blocks (grid (N / bn, S)), each owning disjoint output
//   tiles: no atomics, and reruns are bit-identical.  S is chosen by the
//   wrapper (ws_matmul/ops.py `ws_splits`): the least S with
//   (N / bn) * S >= 2 * SMs, at most the number of M tiles; the weights
//   are then read S times, not once.
// * repro_os_matmul: a block owns one (bm x bn) output tile (grid
//   (M / bm, N / bn)), keeps its f32 sums in registers over the whole k
//   loop, stages x and w in KS-deep slices, and writes once.  The
//   weights are read once per M tile.
//
// Both walk k in the same KS-deep slices with the same arithmetic, so
// with bk a multiple of KS the two kernels give bit-identical outputs.
//
// Bound on this card: each input read once and the f32 output written
// once, over 3.35 TB/s, or 2 M N K operations over 989 TFLOP/s (bf16) or
// 67 TFLOP/s (f32).  At the decode shapes (M 128 to 1024, K 8192, N
// 22016) the weights' bytes or a few hundred FLOPs per byte set it; at
// the prefill and training shapes the operations do.  This first design
// is simple and right: one register tile of at most 128 x 128 per block,
// bf16 on tensor cores (ldmatrix + mma.sync m16n8k16, f32 sums), f32 on
// CUDA cores in f32 FMA (never TF32), ragged bm, bn and bk zero-filled
// in shared memory and masked at the store.  Left for later work: wgmma,
// TMA or cp.async pipelining of the next slice, and a persistent
// schedule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_ws {

constexpr int kThreads = 256;            // 8 warps
constexpr int TM = 128, TN = 128;        // the largest bm x bn a block holds

enum DTypeCode { kF32 = 0, kBF16 = 1 };

// KS: depth of one staged slice of x (and, for OS, of w); PAD: shared
// row padding against bank conflicts, keeping rows 16-byte aligned; VEC:
// elements per 16-byte load.
template <typename T> struct Geo;
template <> struct Geo<__nv_bfloat16> { static constexpr int KS = 64, PAD = 8, VEC = 8; };
template <> struct Geo<float> { static constexpr int KS = 32, PAD = 4, VEC = 4; };

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory: one (TM x KS) slice of x, then `w_rows` rows of w
// (WS: the whole k-tile, rounded up to KS; OS: one KS-deep slice).
// Mirrored by ws_matmul/ops.py `smem_bytes`.
template <typename T> struct Layout {
  static constexpr int LDX = Geo<T>::KS + Geo<T>::PAD;
  static constexpr int LDW = TN + Geo<T>::PAD;
  size_t w_off, total;
  __host__ __device__ explicit Layout(int w_rows)
      : w_off(round128(sizeof(T) * TM * LDX)),
        total(w_off + round128(sizeof(T) * (size_t)w_rows * LDW)) {}
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copy an (R x C) region of a row-major global array (row stride lds)
// into shared memory (row stride ldd): rows at or past rows_ok and
// columns at or past cols_ok become zeros.  One 16-byte load per VEC
// elements where `vec` says the rows are aligned and the chunk lies
// wholly inside, else element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, long long lds, int R,
                                      int C, int rows_ok, int cols_ok, bool vec) {
  constexpr int V = Geo<T>::VEC;
  const int per_row = C / V;
  for (int i = threadIdx.x; i < R * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    T* d = dst + r * ldd + c;
    if (r < rows_ok && vec && c + V <= cols_ok) {
      *reinterpret_cast<uint4*>(d) =
          __ldg(reinterpret_cast<const uint4*>(src + r * lds + c));
      continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      d[j] = (r < rows_ok && c + j < cols_ok) ? src[r * lds + c + j] : zero_of<T>();
  }
}

// ------------------------------------------------------------ bf16 tile

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

  // load (kLoad) or store the sums at o (row stride N), masked to bm x bn
  template <bool kLoad>
  __device__ __forceinline__ void move(float* o, long long N, int bm, int bn) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32 + (lane >> 2), c0 = (warp & 1) * 64 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + i * 16 + (e >> 1) * 8, col = c0 + j * 8 + (e & 1);
          if (r < bm && col < bn) {
            if (kLoad)
              c[i][j][e] = o[r * N + col];
            else
              o[r * N + col] = c[i][j][e];
          }
        }
  }
};

// ------------------------------------------------------------- f32 tile

// The block's 128 x 128 f32 sums on CUDA cores: thread (tr, tc) = (tid /
// 16, tid % 16) holds rows tr + 16 i and columns tc + 16 j, i, j < 8, and
// runs one fmaf per product, k in order.
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
  __device__ __forceinline__ void move(float* o, long long N, int bm, int bn) {
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

// --------------------------------------------------------------- kernels

// Grid (N / bn, S): block (ni, s) owns n tile ni and M tiles
// s * per .. min(M / bm, (s + 1) * per) - 1.
template <typename Tile>
__global__ void __launch_bounds__(kThreads, 2)
ws_kernel(const typename Tile::T* __restrict__ x, const typename Tile::T* __restrict__ w,
          float* __restrict__ out, int M, int N, int K, int bm, int bn, int bk, int per,
          int vec) {
  using T = typename Tile::T;
  constexpr int KS = Geo<T>::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int w_rows = (bk + KS - 1) / KS * KS;
  const Layout<T> L(w_rows);
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + L.w_off);
  const int n0 = blockIdx.x * bn;
  const int mt0 = blockIdx.y * per, mt1 = min(M / bm, mt0 + per);
  const bool resident = mt1 - mt0 == 1;     // the output tile stays in registers
  Tile acc;
  if (resident) acc.zero();
  for (int k0 = 0; k0 < K; k0 += bk) {
    __syncthreads();                          // every warp is done with the last tile
    stage(ws, L.LDW, w + (long long)k0 * N + n0, N, w_rows, TN, bk, bn, vec != 0);
    for (int mt = mt0; mt < mt1; ++mt) {      // every M tile streams past the weights
      float* o = out + (long long)mt * bm * N + n0;
      if (!resident) {
        if (k0 == 0)
          acc.zero();
        else
          acc.template move<true>(o, N, bm, bn);
      }
      for (int ks = 0; ks < bk; ks += KS) {
        __syncthreads();
        stage(xs, L.LDX, x + (long long)mt * bm * K + k0 + ks, K, TM, KS, bm,
              min(KS, bk - ks), vec != 0);
        __syncthreads();
        acc.slice(xs, ws + ks * L.LDW);
      }
      if (!resident) acc.template move<false>(o, N, bm, bn);
    }
  }
  if (resident) acc.template move<false>(out + (long long)mt0 * bm * N + n0, N, bm, bn);
}

// Grid (M / bm, N / bn): block (mt, ni) owns one output tile.
template <typename Tile>
__global__ void __launch_bounds__(kThreads, 2)
os_kernel(const typename Tile::T* __restrict__ x, const typename Tile::T* __restrict__ w,
          float* __restrict__ out, int M, int N, int K, int bm, int bn, int vec) {
  using T = typename Tile::T;
  constexpr int KS = Geo<T>::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(KS);
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + L.w_off);
  const long long m0 = (long long)blockIdx.x * bm;
  const int n0 = blockIdx.y * bn;
  Tile acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();
    stage(xs, L.LDX, x + m0 * K + k0, K, TM, KS, bm, min(KS, K - k0), vec != 0);
    stage(ws, L.LDW, w + (long long)k0 * N + n0, N, KS, TN, min(KS, K - k0), bn, vec != 0);
    __syncthreads();
    acc.slice(xs, ws);
  }
  acc.template move<false>(out + m0 * N + n0, N, bm, bn);
}

template <typename Tile>
cudaError_t launch_ws(const void* x, const void* w, void* out, int M, int N, int K, int bm,
                      int bn, int bk, int splits, int vec, cudaStream_t stream) {
  using T = typename Tile::T;
  constexpr int KS = Geo<T>::KS;
  const Layout<T> L((bk + KS - 1) / KS * KS);
  auto kern = ws_kernel<Tile>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const int m_tiles = M / bm;
  const int per = (m_tiles + splits - 1) / splits;
  const dim3 grid(N / bn, (m_tiles + per - 1) / per);
  kern<<<grid, kThreads, L.total, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<float*>(out), M, N, K, bm, bn, bk, per,
                                            vec);
  return cudaGetLastError();
}

template <typename Tile>
cudaError_t launch_os(const void* x, const void* w, void* out, int M, int N, int K, int bm,
                      int bn, int vec, cudaStream_t stream) {
  using T = typename Tile::T;
  const Layout<T> L(Geo<T>::KS);
  auto kern = os_kernel<Tile>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid(M / bm, N / bn);
  kern<<<grid, kThreads, L.total, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<float*>(out), M, N, K, bm, bn, vec);
  return cudaGetLastError();
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
