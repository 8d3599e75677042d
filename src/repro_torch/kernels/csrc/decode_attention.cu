// Split-KV decode attention (flash-decoding) over a contiguous KV cache,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py:51, body `_dec_kernel`
// :27).  q (b, hq, d); caches (b, S, hkv, d); positions (b,) int32, the
// inclusive newest index of each row.  Block (b * hkv + h, split) takes
// the `group` = hq / hkv query heads that share kv head h and the cache
// rows [split * split_len, (split + 1) * split_len) of batch row b, and
// writes that split's f32 online-softmax summary: m and l (group,) and
// acc (group, d), at [(b * hkv + h) * splits + split].  A second kernel,
// `combine_kernel`, merges the splits by log-sum-exp into out (b, hq, d)
// in q's type: the reference computes that merge outside Pallas, in XLA
// (kernel.py:94 `combine_splits`); the port runs it as one launch so a
// decode step's attention is two launches and no PyTorch arithmetic.
//
// Only the rows kv_pos <= positions[b] are read: the rest of the split
// is skipped, so an empty split writes m = -1e30, l = 0, acc = 0, which
// the combine weights by exp(-1e30 - m_max) = 0.  A position at or past
// S sees every row (an idle engine row whose write was clamped to
// S - 1).  Any S is taken; the last split is the shorter one.  Scores
// are f32, l sums the f32 probabilities, and p is rounded to the
// cache's type before the PV product, as the TPU kernel does.
//
// Bound: decode reads each visible K/V row once and does 4 flops per
// element pair and query head: about group flops per byte, far below
// the card's ~295 flop/byte ridge, so the bytes of the live rows bound
// it.  The design reads each live row once per (row, kv head) with
// 16-byte vector loads, shares it across the whole GQA group, never
// touches a row past the position, and splits the sequence so that a
// decode batch of 8 x 8 kv heads launches 8 x 64 blocks instead of 64.
// Known limits, left for later work: CUDA cores (no mma) for the scores
// and the PV product, and no asynchronous copy overlapping the next
// tile's load with compute.  The combine reads the f32 summaries once
// (splits x group x (d + 2) floats per block) and writes the output once:
// bound by those bytes, and at decode sizes by its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_dec {

constexpr int kThreads = 128;
// query rows x head_dim held per block as f32 accumulators in registers
constexpr int kAccPerThread = 32;
// cache rows per shared-memory tile: one per lane in the softmax fold
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to T's precision (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive elements -> f32 as 16-byte loads (d % 8 == 0, 16-byte
// aligned base, checked by the wrapper)
template <typename T> __device__ __forceinline__ void load8(const T* p, float* o);
template <> __device__ __forceinline__ void load8<float>(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
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

inline size_t smem_bytes(int R, int d) {
  return sizeof(float) *
         (size_t)(R * (d + 1) + kTile * (d + 1) + kTile * d + R * kTile + 3 * R);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ positions,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int hq, int hkv, int S, int d,
                    int splits, int split_len) {
  static_assert(kTile == 32, "the softmax fold gives each lane one row");
  extern __shared__ float smem[];
  const int bh = blockIdx.x, si = blockIdx.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const int R = hq / hkv;
  const int ldk = d + 1;          // K and q rows: stride d + 1 (no bank conflicts)
  float* qs = smem;               // [R][d + 1] f32 query rows
  float* ks = qs + R * ldk;       // [kTile][d + 1]
  float* vs = ks + kTile * ldk;   // [kTile][d]
  float* ps = vs + kTile * d;     // [R][kTile] scores, then probabilities
  float* ms = ps + R * kTile;     // [R] running max
  float* ls = ms + R;             // [R] running normaliser
  float* cs = ls + R;             // [R] this tile's rescale of the carry
  const int tid = threadIdx.x;
  const long long row0 = ((long long)bh * splits + si) * R;   // first out row

  const int limit = min(positions[b], S - 1);
  const int s0 = si * split_len;
  const int s1 = min(s0 + split_len, limit + 1);               // exclusive
  if (s1 <= s0) {                 // nothing visible in this split
    for (int e = tid; e < R * d; e += kThreads) acc_out[row0 * d + e] = 0.f;
    if (tid < R) {
      m_out[row0 + tid] = kNegInf;
      l_out[row0 + tid] = 0.f;
    }
    return;
  }

  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    qs[r * ldk + c] = to_f32<T>(q[((long long)b * hq + h * R + r) * d + c]);
  }
  if (tid < R) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;
  const float sqrt_d = sqrtf(static_cast<float>(d));
  const int vec_per_row = d / 8;
  __syncthreads();

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int n = min(kTile, s1 - t0);
    // K/V rows -> shared f32; rows past n become zeros
    for (int vi = tid; vi < kTile * vec_per_row; vi += kThreads) {
      const int tt = vi / vec_per_row;
      const int c = (vi - tt * vec_per_row) * 8;
      float kv[8], vv[8];
      if (tt < n) {
        const long long off = (((long long)b * S + t0 + tt) * hkv + h) * d + c;
        load8<T>(k + off, kv);
        load8<T>(v + off, vv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[tt * ldk + c + i] = kv[i];
        vs[tt * d + c + i] = vv[i];
      }
    }
    __syncthreads();

    // scores, one thread per (query row, cache row) pair
    for (int pi = tid; pi < R * kTile; pi += kThreads) {
      const int r = pi / kTile, tt = pi - r * kTile;
      float s = kNegInf;
      if (tt < n) {
        const float* qr = qs + r * ldk;
        const float* kr = ks + tt * ldk;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot / sqrt_d;
      }
      ps[pi] = s;
    }
    __syncthreads();

    // fold the tile into (m, l): one warp per query row, one lane per
    // cache row; l sums the f32 p, the PV product takes p rounded to T
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = ps + r * kTile;
      const float m_old = ms[r];
      const float s = sr[lane];
      const float m_new = fmaxf(m_old, warp_max(lane < n ? s : kNegInf));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      sr[lane] = round_to<T>(p);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V, each thread owning fixed (row, column)s
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < R * d) {
        const int r = e / d, c = e - r * d;
        const float* pr = ps + r * kTile;
        float a = acc[j] * cs[r];
        for (int tt = 0; tt < n; ++tt) a = fmaf(pr[tt], vs[tt * d + c], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < R * d) acc_out[row0 * d + e] = acc[j];
  }
  if (tid < R) {
    m_out[row0 + tid] = ms[tid];
    l_out[row0 + tid] = ls[tid];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* positions,
                   void* m, void* l, void* acc, int b, int hq, int hkv, int S, int d,
                   int splits, int split_len, cudaStream_t stream) {
  const size_t smem = smem_bytes(hq / hkv, d);
  auto kern = split_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(b * hkv, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(positions), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), hq, hkv, S, d, splits,
      split_len);
  return cudaGetLastError();
}

// The log-sum-exp merge of the splits (reference kernel.py:94), one block
// per (batch row, kv head), threads over group x d: m_max over the splits,
// corr = exp(m - m_max), l_tot = sum l corr, acc_tot = sum acc corr, out =
// acc_tot / max(l_tot, 1e-30).  An empty split (m = -1e30, l = 0, acc = 0)
// gets weight exp(-1e30 - m_max) = 0, or adds 0 where every split is empty.
// Shared memory: corr [splits][group], then l_tot [group], f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ acc, T* __restrict__ out, int group, int d,
               int splits) {
  extern __shared__ float csm[];
  float* corr = csm;
  float* l_tot = csm + splits * group;
  const long long bh = blockIdx.x;
  const float* mb = m + bh * splits * group;
  const float* lb = l + bh * splits * group;
  for (int gi = threadIdx.x; gi < group; gi += kThreads) {
    float m_max = kNegInf;
    for (int s = 0; s < splits; ++s) m_max = fmaxf(m_max, mb[s * group + gi]);
    float lt = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float c = expf(mb[s * group + gi] - m_max);
      corr[s * group + gi] = c;
      lt += lb[s * group + gi] * c;
    }
    l_tot[gi] = lt;
  }
  __syncthreads();
  const float* ab = acc + bh * splits * group * d;
  for (int e = threadIdx.x; e < group * d; e += kThreads) {
    const int gi = e / d;
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += ab[(long long)s * group * d + e] * corr[s * group + gi];
    out[bh * group * d + e] = from_f32<T>(a / fmaxf(l_tot[gi], 1e-30f));
  }
}

template <typename T>
cudaError_t launch_combine(const void* m, const void* l, const void* acc, void* out, int bh,
                           int group, int d, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(splits + 1) * group;
  auto kern = combine_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, smem, stream>>>(static_cast<const float*>(m),
                                       static_cast<const float*>(l),
                                       static_cast<const float*>(acc), static_cast<T*>(out),
                                       group, d, splits);
  return cudaGetLastError();
}

}  // namespace repro_dec

// q (b, hq, d) and caches (b, S, hkv, d), all f32 or all bf16 (dtype
// code 0 / 1), contiguous and 16-byte aligned, d % 8 == 0; positions
// (b,) int32.  m, l (b * hkv, splits, hq / hkv) and acc (b * hkv,
// splits, hq / hkv, d) f32.  Returns the CUDA error of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* positions,
                                      void* m, void* l, void* acc, int b, int hq, int hkv,
                                      int S, int d, int splits, int split_len, int dtype,
                                      void* stream) {
  using namespace repro_dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k_cache, v_cache, positions, m, l,
                                                  acc, b, hq, hkv, S, d, splits,
                                                  split_len, s));
  if (dtype == kF32)
    return static_cast<int>(launch<float>(q, k_cache, v_cache, positions, m, l, acc, b,
                                          hq, hkv, S, d, splits, split_len, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// m, l (bh, splits, group) and acc (bh, splits, group, d) f32, as
// repro_decode_attention writes them; out (bh * group, d) = (b, hq, d) in
// the dtype of code 0 / 1 (f32 / bf16).  Returns the CUDA error of the
// launch.
extern "C" int repro_combine_splits(const void* m, const void* l, const void* acc,
                                    void* out, int bh, int group, int d, int splits,
                                    int dtype, void* stream) {
  using namespace repro_dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(
        launch_combine<__nv_bfloat16>(m, l, acc, out, bh, group, d, splits, s));
  if (dtype == kF32)
    return static_cast<int>(launch_combine<float>(m, l, acc, out, bh, group, d, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
