// Shared device code of the two paged-attention kernels (decode and
// chunk prefill) for Hopper (sm_90a).
//
// Both kernels are one machine: a thread block owns R query rows of one
// (batch row, kv head) pair, walks that batch row's block table through
// the page arena tile by tile, and folds each tile into an f32 online
// softmax carry (m, l, acc).  Decode is the R = group case with one
// limit for every row; prefill packs (chunk position, group member)
// rows densely and gives each row its own causal limit.  What differs
// between the kernels is only how rows map to queries and limits, which
// each kernel writes into shared memory before calling `attend_rows`.
//
// Bound: both kernels are bound by the bytes of the live K/V pages they
// read (decode does 4 flops per K/V element pair and per query row, far
// below the card's ~295 flop/byte ridge).  The design reads each live
// page once per (batch row, kv head) block with 16-byte vector loads
// (bf16; 2 x 16 B for f32, 8 B for int8/fp8) and stops at the last page
// any of its rows can see, so no byte past the causal limit moves; the
// whole GQA group (or chunk tile) shares every page it loads.  Known
// limits, left for later work: no tensor cores (scores and the PV
// product run on CUDA cores from shared memory), no split over the KV
// length (decode at batch 8 launches 8 x 8 = 64 blocks on 132 SMs), and
// no asynchronous copy overlapping the next tile's load with compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 128;
// query rows x head_dim held per block, as f32 accumulators in
// registers: rows * d <= kThreads * kAccPerThread
constexpr int kAccPerThread = 32;
constexpr int kMaxRowElems = kThreads * kAccPerThread;
// kv tokens per shared-memory tile (whole pages; one page if larger)
constexpr int kTileTokens = 64;
constexpr float kNegInf = -1e30f;
// page-position sentinel for non-resident table slots (kernel.py POS_PAD)
constexpr int kPosPad = 1 << 30;

// element-type codes shared with the Python wrappers
enum DTypeCode { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__host__ __device__ inline int tile_pages(int page) {
  return page >= kTileTokens ? 1 : kTileTokens / page;
}

// ----------------------------------------------------------- conversions

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements -> f32, as one or two vector loads.  The
// caller guarantees 8-element alignment (d % 8 == 0, 16-byte base).
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

template <> __device__ __forceinline__ void load8<int8_t>(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(e[i]);
}

template <> __device__ __forceinline__ void load8<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p,
                                                                 float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(e[i]);
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

// ------------------------------------------------------- shared memory
//
// f32 q rows and K rows use a stride of d + 1 so the score loop (one
// thread per (row, token) pair) reads K without bank conflicts; V keeps
// stride d (the PV loop walks columns across threads).
struct Smem {
  float* q;      // [R][d + 1]
  float* k;      // [T][d + 1]
  float* v;      // [T][d]
  float* s;      // [R][T] scores, then probabilities
  float* m;      // [R] running max
  float* l;      // [R] running normaliser
  float* corr;   // [R] this tile's rescale of the carry
  int* lim;      // [R] largest visible kv position (-1: row sees nothing)
  int* rid;      // [R] flat query-row index (-1: padding row, no output)
  int* slot;     // [tp] physical page of each tile column (-1: skipped)
  int* base;     // [tp] absolute kv position of each tile column
  int T, tp;

  __device__ Smem(float* p, int R, int d, int page) {
    tp = tile_pages(page);
    T = tp * page;
    q = p;
    k = q + R * (d + 1);
    v = k + T * (d + 1);
    s = v + T * d;
    m = s + R * T;
    l = m + R;
    corr = l + R;
    lim = reinterpret_cast<int*>(corr + R);
    rid = lim + R;
    slot = rid + R;
    base = slot + tp;
  }
};

inline size_t smem_bytes(int R, int d, int page) {
  const int tp = tile_pages(page);
  const int T = tp * page;
  return sizeof(float) * (size_t)(R * (d + 1) + T * (d + 1) + T * d + R * T + 5 * R + 2 * tp);
}

// ------------------------------------------------------------ machine
//
// Preconditions: the caller has written sm.rid and sm.lim for its R rows
// and synchronised.  Row r attends over every kv position p with
// p <= lim[r] reached through the table row (page_positions give each
// column's first position; nullptr means column j holds positions
// j*page ...).  Writes the normalised row (or, with `partials`, the raw
// f32 carry acc, m, l) at flat row rid[r].
template <typename TQ, typename TKV>
__device__ void attend_rows(const Smem& sm, const TQ* __restrict__ q,
                            const TKV* __restrict__ kp, const TKV* __restrict__ vp,
                            const float* __restrict__ ks, const float* __restrict__ vs,
                            const int* __restrict__ bt_row, const int* __restrict__ ppos_row,
                            int R, int d, int page, int hkv, int h, int max_pages,
                            TQ* __restrict__ out, float* __restrict__ acc_out,
                            float* __restrict__ m_out, float* __restrict__ l_out,
                            bool partials) {
  const int tid = threadIdx.x;
  const int ldk = d + 1;
  const int T = sm.T, tp = sm.tp;
  const float sqrt_d = sqrtf(static_cast<float>(d));

  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int rid = sm.rid[r];
    sm.q[r * ldk + c] = rid >= 0 ? to_f32<TQ>(q[(long long)rid * d + c]) : 0.f;
  }
  if (tid < R) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }
  int max_lim = -1;
  for (int r = 0; r < R; ++r) max_lim = max(max_lim, sm.lim[r]);
  // the causal walk: default positions stop at the last page any row
  // can see; explicit positions walk every column, skipping those whose
  // first position is past every row's limit (POS_PAD holes included)
  const int n_cols = ppos_row != nullptr ? max_pages
                     : (max_lim < 0 ? 0 : min(max_pages, max_lim / page + 1));

  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int col0 = 0; col0 < n_cols; col0 += tp) {
    if (tid < tp) {
      const int col = col0 + tid;
      int slot = -1, base = kPosPad;
      if (col < n_cols) {
        const int b0 = ppos_row != nullptr ? ppos_row[col] : col * page;
        if (b0 <= max_lim) {
          slot = bt_row[col];
          base = b0;
        }
      }
      sm.slot[tid] = slot;
      sm.base[tid] = base;
    }
    __syncthreads();

    // K/V tile -> shared f32, dequantising int8/fp8 with the per-token
    // scale as it lands; skipped columns become zeros
    const int vec_per_row = d / 8;
    for (int vi = tid; vi < T * vec_per_row; vi += kThreads) {
      const int tt = vi / vec_per_row;
      const int c = (vi - tt * vec_per_row) * 8;
      const int pj = tt / page, t = tt - pj * page;
      const int slot = sm.slot[pj];
      float kv[8], vv[8];
      if (slot >= 0) {
        const long long row = ((long long)slot * page + t) * hkv + h;
        load8<TKV>(kp + row * d + c, kv);
        load8<TKV>(vp + row * d + c, vv);
        if (ks != nullptr) {
          const float a = ks[row], bsc = vs[row];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            kv[i] *= a;
            vv[i] *= bsc;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sm.k[tt * ldk + c + i] = kv[i];
        sm.v[tt * d + c + i] = vv[i];
      }
    }
    __syncthreads();

    // masked scores, one thread per (row, token) pair
    for (int pi = tid; pi < R * T; pi += kThreads) {
      const int r = pi / T, tt = pi - r * T;
      const int pj = tt / page;
      const int kv_pos = sm.base[pj] + (tt - pj * page);
      float s = kNegInf;
      if (sm.slot[pj] >= 0 && kv_pos <= sm.lim[r]) {
        const float* qr = sm.q + r * ldk;
        const float* kr = sm.k + tt * ldk;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot / sqrt_d;
      }
      sm.s[pi] = s;
    }
    __syncthreads();

    // fold the tile into (m, l): one warp per row.  p is masked to 0
    // explicitly, so a fully masked tile leaves the carry untouched
    // (kernel.py accumulate_block)
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = sm.s + r * T;
      float mx = kNegInf;
      for (int tt = lane; tt < T; tt += 32) mx = fmaxf(mx, sr[tt]);
      mx = warp_max(mx);
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int tt = lane; tt < T; tt += 32) {
        const float s = sr[tt];
        const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
        sr[tt] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sm.l[r] = sm.l[r] * corr + sum;
        sm.m[r] = m_new;
        sm.corr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V, each thread owning fixed (row, column)s
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < R * d) {
        const int r = e / d, c = e - r * d;
        const float* pr = sm.s + r * T;
        float a = acc[j] * sm.corr[r];
        for (int tt = 0; tt < T; ++tt) a = fmaf(pr[tt], sm.v[tt * d + c], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < R * d) {
      const int r = e / d, c = e - r * d;
      const int rid = sm.rid[r];
      if (rid >= 0) {
        const long long o = (long long)rid * d + c;
        if (partials) {
          acc_out[o] = acc[j];
        } else {
          // zero-l rows (fully masked) emit exact zeros
          out[o] = from_f32<TQ>(acc[j] / fmaxf(sm.l[r], 1e-30f));
        }
      }
    }
  }
  if (partials && tid < R && sm.rid[tid] >= 0) {
    m_out[sm.rid[tid]] = sm.m[tid];
    l_out[sm.rid[tid]] = sm.l[tid];
  }
}

// ------------------------------------------------------------ dispatch
//
// Calls fn.template operator()<TQ, TKV>() for the (q, kv) element codes;
// returns cudaErrorInvalidValue for a pair no kernel is built for.
template <typename Fn>
cudaError_t dispatch_types(int q_dtype, int kv_dtype, Fn&& fn) {
  if (q_dtype == kF32) {
    if (kv_dtype == kF32) return fn.template operator()<float, float>();
    if (kv_dtype == kI8) return fn.template operator()<float, int8_t>();
    if (kv_dtype == kFP8) return fn.template operator()<float, __nv_fp8_e4m3>();
  } else if (q_dtype == kBF16) {
    if (kv_dtype == kBF16) return fn.template operator()<__nv_bfloat16, __nv_bfloat16>();
    if (kv_dtype == kI8) return fn.template operator()<__nv_bfloat16, int8_t>();
    if (kv_dtype == kFP8) return fn.template operator()<__nv_bfloat16, __nv_fp8_e4m3>();
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro
