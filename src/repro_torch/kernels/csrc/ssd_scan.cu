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
// kernel casts; every dot product accumulates in f32 and every output is
// f32.  The causal mask is applied before exp (no inf * 0).
//
// Bound: per (batch*head, chunk) the kernel does about l^2 (n + p) +
// 2 l n p flops on 2 l n + l p input elements and l p + n p f32
// outputs.  At zamba2's prefill shapes (80 heads, head dim p 64, state
// n 64, chunk l 8 to 256) that is 18 flops per byte at l 64 and 58 at
// l 256: below the card's bf16 tensor-core ridge (~295), so the bound
// is the bytes.  The design moves each byte once: one block per
// (batch*head, chunk), like the TPU grid cell, stages the chunk's B and
// x in shared memory, so the (l x l) score matrix and the (n x p) state
// never touch device memory; the block walks its output rows in tiles
// of 16, staging those rows of C, computing a score tile and then those
// rows of y.  Only a tile of C is held, so that l 256 with n 128 in f32
// (mamba2-130m's prefill chunk) fits one block's shared memory.  Known
// limits, left for later work: the products run on CUDA cores (no
// mma), whose f32 rate (67 TFLOP/s, ridge ~20) is what this design hits
// at l 256; the cumsum is one thread's loop; at l 256 in f32 the staged
// tiles fill the SM's shared memory (one block per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_ssd {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to T's precision (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// shared-memory row padding (elements): one 4-byte bank per row step
template <typename T> __host__ __device__ constexpr int row_pad() { return sizeof(T) == 4 ? 1 : 2; }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int l, int p, int n) {
  const size_t pad = row_pad<T>();
  return sizeof(float) * (3 * (size_t)l + (size_t)kTileRows * (l + 1)) +
         sizeof(T) * ((size_t)(l + kTileRows) * (n + pad) + (size_t)l * (p + pad));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ s, float* __restrict__ cd, int nc, int l,
                       int p, int n) {
  extern __shared__ float smem[];
  const int blk = blockIdx.x;               // (batch*head) * nc + chunk
  const int bh = blk / nc;
  const long long row0 = (long long)blk * l;
  const int ldn = n + row_pad<T>(), ldp = p + row_pad<T>(), lds = l + 1;
  float* seg = smem;
  float* dtv = seg + l;
  float* wv = dtv + l;
  float* sc = wv + l;                       // [kTileRows][l + 1] score tile
  T* Bs = reinterpret_cast<T*>(sc + kTileRows * lds);
  T* Cs = Bs + l * ldn;                     // [kTileRows][ldn] rows of C
  T* Xs = Cs + kTileRows * ldn;

  for (int i = threadIdx.x; i < l; i += kThreads) dtv[i] = dt[row0 + i];
  for (int i = threadIdx.x; i < l * n; i += kThreads) {
    const int r = i / n, c = i - (i / n) * n;
    Bs[r * ldn + c] = B[(row0 + r) * n + c];
  }
  for (int i = threadIdx.x; i < l * p; i += kThreads) {
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
  for (int i = threadIdx.x; i < l; i += kThreads)
    wv[i] = round_to<T>(expf(last - seg[i]) * dtv[i]);

  // y, one tile of kTileRows output rows at a time
  for (int i0 = 0; i0 < l; i0 += kTileRows) {
    for (int idx = threadIdx.x; idx < kTileRows * n; idx += kThreads) {
      const int ii = idx / n, c = idx - (idx / n) * n;
      if (i0 + ii < l) Cs[ii * ldn + c] = Cm[(row0 + i0 + ii) * n + c];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileRows * l; idx += kThreads) {
      const int ii = idx / l, j = idx - (idx / l) * l, i = i0 + ii;
      float v = 0.f;                        // masked before exp
      if (i < l && j <= i) {
        float cb = 0.f;
        for (int k = 0; k < n; ++k)
          cb = fmaf(to_f32(Cs[ii * ldn + k]), to_f32(Bs[j * ldn + k]), cb);
        v = round_to<T>(cb * expf(seg[i] - seg[j]) * dtv[j]);
      }
      sc[ii * lds + j] = v;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileRows * p; idx += kThreads) {
      const int ii = idx / p, c = idx - (idx / p) * p, i = i0 + ii;
      if (i >= l) continue;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(sc[ii * lds + j], to_f32(Xs[j * ldp + c]), acc);
      y[(row0 + i) * p + c] = acc;
    }
    __syncthreads();
  }

  // the chunk state, (n, p)
  for (int idx = threadIdx.x; idx < n * p; idx += kThreads) {
    const int nn = idx / p, c = idx - (idx / p) * p;
    float acc = 0.f;
    for (int j = 0; j < l; ++j)
      acc = fmaf(to_f32(Bs[j * ldn + nn]), round_to<T>(wv[j] * to_f32(Xs[j * ldp + c])), acc);
    s[((long long)blk * n + nn) * p + c] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, void* s, void* cd, int bh, int nc, int l,
                   int p, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(l, p, n);
  auto kern = ssd_intra_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<bh * nc, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(s), static_cast<float*>(cd), nc, l, p, n);
  return cudaGetLastError();
}

}  // namespace repro_ssd

// x (bh, nc, l, p), B and C (bh, nc, l, n), all f32 or all bf16 (dtype
// code 0 / 1); dt (bh, nc, l) and A (bh,) f32; all contiguous.  Writes
// y (bh, nc, l, p), s (bh, nc, n, p) and cd (bh, nc), f32.  Returns the
// CUDA error of the launch.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* dt, const void* A,
                                     const void* B, const void* C, void* y, void* s,
                                     void* cd, int bh, int nc, int l, int p, int n,
                                     int dtype, void* stream) {
  using namespace repro_ssd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, st));
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, dt, A, B, C, y, s, cd, bh, nc, l, p, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
