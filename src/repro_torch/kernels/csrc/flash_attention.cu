// Flash attention (causal or not, GQA) over contiguous Q/K/V, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:64, body `_fa_kernel`
// :24).  q (b, sq, hq, d); k, v (b, skv, hkv, d); out (b, sq, hq, d) in
// q's type.  Query row i of head h sits at absolute position
// q_offset + i and attends over kv head h / (hq / hkv) — no repeated K/V
// is materialised — at the positions j < skv with, when causal,
// j <= q_offset + i.  Scores are f32 (the TPU kernel's preferred f32
// dot, times 1/sqrt(d)), the running max, normaliser and accumulator
// are f32, l sums the f32 probabilities, p is rounded to V's type before
// the PV product (kernel.py:57), and the output is acc / max(l, 1e-30).
//
// Where it differs from the TPU kernel, with the same result: any sq
// (the TPU kernel asserts sq % block_q == 0; here the tail rows of the
// last query tile are computed on zeros and never written), any skv (no
// padding: keys past skv are masked), and kv tiles wholly above the
// causal diagonal are skipped rather than folded in with p = 0.
//
// Bound: prefill over a prompt of s tokens does 4 s^2 d hq / 2 flops
// (causal) on 2 s d (hq + 2 hkv) bytes; at internlm2's shapes (hq 16,
// hkv 8, d 128) that is ~s / 2 flops per byte, above the card's ~295
// flop/byte ridge from s ~ 600, so long prompts are bound by the tensor
// cores and short ones by the bytes.  The design: one block of 4 warps
// per (query tile, batch row x query head).  bf16: 64-row query tiles,
// 64-key kv tiles, QK^T and PV on tensor cores (nvcuda::wmma 16x16x16,
// f32 accumulators), each warp owning 16 query rows; the accumulator
// lives in shared memory so the online-softmax rescale can reach each
// row.  f32 (taken only by the parity checks): 32 x 32 tiles on CUDA
// cores.  Known limits, left for later work: no wgmma, no TMA or
// cp.async pipelining of the next kv tile, K/V re-read by each query
// head of a group, and block-wide barriers between the phases.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace repro_fa {

constexpr int kThreads = 128;   // 4 warps
constexpr float kNegInf = -1e30f;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

// tile rows and shared-memory row padding (elements of T; 16 bytes)
template <typename T> struct Tiles;
template <> struct Tiles<__nv_bfloat16> {
  static constexpr int BQ = 64, BKV = 64, PAD = 8;
};
template <> struct Tiles<float> {
  static constexpr int BQ = 32, BKV = 32, PAD = 4;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ inline size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory carve-up; every array starts on a 128-byte boundary and
// every wmma tile pointer on a 32-byte one.
template <typename T>
struct Layout {
  int ldq, lds, ldp, ldo;      // row strides: Q/K/V (T), S (f32), P (T), O (f32)
  size_t q, k, v, s, p, o, m, l, total;

  __host__ __device__ explicit Layout(int d) {
    constexpr int BQ = Tiles<T>::BQ, BKV = Tiles<T>::BKV, PAD = Tiles<T>::PAD;
    ldq = d + PAD;
    lds = BKV + 4;
    ldp = BKV + PAD;
    ldo = d + 4;
    q = 0;
    k = q + round128(sizeof(T) * BQ * ldq);
    v = k + round128(sizeof(T) * BKV * ldq);
    s = v + round128(sizeof(T) * BKV * ldq);
    p = s + round128(sizeof(float) * BQ * lds);
    o = p + round128(sizeof(T) * BQ * ldp);
    m = o + round128(sizeof(float) * BQ * ldo);
    l = m + round128(sizeof(float) * BQ);
    total = l + round128(sizeof(float) * BQ);
  }
};

// `rows` rows of d elements, `row_stride` apart in device memory, into
// shared memory at stride ld, 16 bytes per copy; rows past `valid` are
// zeros.  d * sizeof(T) % 16 == 0 and 16-byte aligned bases (wrapper).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long row_stride,
                                          int rows, int valid, int d) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T (raw dots, f32) for the whole tile.
template <typename T>
__device__ __forceinline__ void qk_tile(const T* qs, const T* ks, float* ss,
                                        const Layout<T>& L, int d);

template <>
__device__ __forceinline__ void qk_tile<__nv_bfloat16>(const __nv_bfloat16* qs,
                                                       const __nv_bfloat16* ks, float* ss,
                                                       const Layout<__nv_bfloat16>& L,
                                                       int d) {
  using namespace nvcuda;
  constexpr int NJ = Tiles<__nv_bfloat16>::BKV / 16;
  const int warp = threadIdx.x / 32;        // owns query rows 16 * warp ...
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + warp * 16 * L.ldq + kk, L.ldq);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // K^T's (kk.., 16 j..) block: K row-major read as column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
      wmma::load_matrix_sync(bk, ks + j * 16 * L.ldq + kk, L.ldq);
      wmma::mma_sync(acc[j], a, bk, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(ss + warp * 16 * L.lds + j * 16, acc[j], L.lds,
                            wmma::mem_row_major);
}

template <>
__device__ __forceinline__ void qk_tile<float>(const float* qs, const float* ks, float* ss,
                                               const Layout<float>& L, int d) {
  constexpr int BQ = Tiles<float>::BQ, BKV = Tiles<float>::BKV;
  for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
    const int r = i / BKV, t = i - r * BKV;
    const float* qr = qs + r * L.ldq;
    const float* kr = ks + t * L.ldq;
    float dot = 0.f;
    for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
    ss[r * L.lds + t] = dot;
  }
}

// O += P V for the whole tile (O already rescaled by this tile's corr).
template <typename T>
__device__ __forceinline__ void pv_tile(const T* ps, const T* vs, float* os,
                                        const Layout<T>& L, int d);

template <>
__device__ __forceinline__ void pv_tile<__nv_bfloat16>(const __nv_bfloat16* ps,
                                                       const __nv_bfloat16* vs, float* os,
                                                       const Layout<__nv_bfloat16>& L,
                                                       int d) {
  using namespace nvcuda;
  constexpr int BKV = Tiles<__nv_bfloat16>::BKV;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[BKV / 16];
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wmma::load_matrix_sync(a[kk], ps + warp * 16 * L.ldp + kk * 16, L.ldp);
  for (int j = 0; j < d; j += 16) {
    float* o = os + warp * 16 * L.ldo + j;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, L.ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::load_matrix_sync(bv, vs + kk * 16 * L.ldq + j, L.ldq);
      wmma::mma_sync(acc, a[kk], bv, acc);
    }
    wmma::store_matrix_sync(o, acc, L.ldo, wmma::mem_row_major);
  }
}

template <>
__device__ __forceinline__ void pv_tile<float>(const float* ps, const float* vs, float* os,
                                               const Layout<float>& L, int d) {
  constexpr int BQ = Tiles<float>::BQ, BKV = Tiles<float>::BKV;
  for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const float* pr = ps + r * L.ldp;
    float a = os[r * L.ldo + c];
    for (int t = 0; t < BKV; ++t) a = fmaf(pr[t], vs[t * L.ldq + c], a);
    os[r * L.ldo + c] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int sq, int skv, int hq, int hkv, int d, int q_offset,
             int causal) {
  constexpr int BQ = Tiles<T>::BQ, BKV = Tiles<T>::BKV;
  static_assert(BKV <= 64, "the softmax fold gives each lane two kv columns at most");
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(d);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* ps = reinterpret_cast<T*>(smem + L.p);
  float* os = reinterpret_cast<float*>(smem + L.o);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);

  const int q0 = blockIdx.x * BQ;
  const int bhq = blockIdx.y;
  const int b = bhq / hq, h = bhq - b * hq;
  const int hk = h / (hq / hkv);
  const int rows = min(BQ, sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = 1.f / sqrtf(static_cast<float>(d));

  load_rows<T>(qs, L.ldq, q + (((long long)b * sq + q0) * hq + h) * d,
               (long long)hq * d, BQ, rows, d);
  for (int i = tid; i < BQ * L.ldo; i += kThreads) os[i] = 0.f;
  if (tid < BQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  // the causal walk stops at the last key the tile's last row can see
  const int kv_end = causal ? min(skv, q0 + rows + q_offset) : skv;
  const T* kb = k + ((long long)b * skv * hkv + hk) * d;
  const T* vb = v + ((long long)b * skv * hkv + hk) * d;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    const int valid = min(BKV, skv - kv0);
    load_rows<T>(ks, L.ldq, kb + (long long)kv0 * hkv * d, (long long)hkv * d, BKV,
                 valid, d);
    load_rows<T>(vs, L.ldq, vb + (long long)kv0 * hkv * d, (long long)hkv * d, BKV,
                 valid, d);
    __syncthreads();
    qk_tile<T>(qs, ks, ss, L, d);
    __syncthreads();

    // fold the tile into (m, l) and rescale O: one warp per query row,
    // each lane two kv columns; masked p is exactly 0
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qpos = q0 + r + q_offset;
      float sv[2];
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = lane + 32 * u;
        const int kvpos = kv0 + t;
        ok[u] = t < BKV && kvpos < skv && (!causal || kvpos <= qpos);
        sv[u] = ok[u] ? ss[r * L.lds + t] * scale : kNegInf;
        mx = fmaxf(mx, sv[u]);
      }
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = lane + 32 * u;
        const float p = ok[u] ? expf(sv[u] - m_new) : 0.f;
        sum += p;
        if (t < BKV) ps[r * L.ldp + t] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      for (int c = lane; c < d; c += 32) os[r * L.ldo + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    pv_tile<T>(ps, vs, os, L, d);
    __syncthreads();
  }

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    out[(((long long)b * sq + q0 + r) * hq + h) * d + c] =
        from_f32<T>(os[r * L.ldo + c] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                   int skv, int hq, int hkv, int d, int q_offset, int causal,
                   cudaStream_t stream) {
  const Layout<T> L(d);
  auto kern = flash_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Tiles<T>::BQ - 1) / Tiles<T>::BQ, b * hq);
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, d, q_offset, causal);
  return cudaGetLastError();
}

}  // namespace repro_fa

// q (b, sq, hq, d), k and v (b, skv, hkv, d), out (b, sq, hq, d), all f32
// or all bf16 (dtype code 0 / 1), contiguous and 16-byte aligned, d a
// multiple of 16.  Returns the CUDA error of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int sq, int skv, int hq, int hkv, int d,
                                     int q_offset, int causal, int dtype, void* stream) {
  using namespace repro_fa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, d,
                                                  q_offset, causal, s));
  if (dtype == kF32)
    return static_cast<int>(launch<float>(q, k, v, out, b, sq, skv, hq, hkv, d, q_offset,
                                          causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
