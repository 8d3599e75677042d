// Split-KV decode attention (flash-decoding) over a contiguous KV cache,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py:51, body `_dec_kernel`
// :27).  q (b, hq, d); caches (b, S, hkv, d); positions (b,) int32, the
// inclusive newest index of each row.  Block (b * hkv + h, split) takes
// the `group` = hq / hkv query heads that share kv head h and the cache
// rows [split * split_len, (split + 1) * split_len) of batch row b, and
// reduces them to that split's f32 online-softmax summary: m and l
// (group,) and acc (group, d).  The reference merges the summaries by
// log-sum-exp outside Pallas, in XLA (kernel.py:94 `combine_splits`).
//
// Only the rows kv_pos <= positions[b] are visible: an empty split's
// summary is m = -1e30, l = 0, acc = 0, which a merge weights by 0.  A
// position at or past S sees every row (an idle engine row whose write
// was clamped to S - 1).  Any S is taken; the last split is the shorter
// one.  Scores are f32, l sums the f32 probabilities, and p is rounded
// to the cache's type before the PV product, as the TPU kernel does.
//
// Bound: decode reads each visible K/V row once and does 4 flops per
// element pair and query head: about group flops per byte, far below
// the card's ~295 flop/byte ridge, so the bytes of the live rows bound
// it.  Two designs, fixed by the element type (`repro_decode_attention`;
// the wrapper, kernels/decode_attention/ops.py `route`, mirrors it):
//
// * bf16: `dec_tc::decode_tc_kernel<D>`, one launch per call.
//   - Grid (b * hkv, splits), 4 warps.  A split that starts past
//     min(positions[b], S - 1) exits at once (split 0 stays, to write an
//     empty row); the host never reads positions.
//   - K/V come in 64-row bf16 tiles through a 2-stage cp.async ring at
//     row stride hkv * d: a 128-row split is in flight at once.  Rows
//     past the position or past S are zero-filled by the copy's source
//     size and never read, so a NaN in an unread cache row cannot reach
//     the output through p = 0 times V.
//   - Tensor cores over the query group: its rows (1, 2 or 8 served; at
//     most 16) are one m16 tile, padded with zero rows.  Each warp takes
//     16 rows of a tile: S = Q K^T (D / 16 mma.sync steps), the online
//     softmax in registers, p rounded to bf16 and reused as the A
//     operand of O += P V (D / 8 n-tiles).  Each warp keeps its own (m,
//     l, O) in registers; after the walk the 4 warps merge through
//     shared memory (the ring's space).
//   - The splits merge in the same launch: each live split writes its
//     f32 carry to a scratch buffer, fences, and takes a ticket from
//     its (batch row, kv head) counter; the last to arrive merges the
//     live splits by log-sum-exp (reads through L2), writes the output
//     in bf16 and resets the counter to 0 for the next call.  A row with
//     one live split writes its output directly.  With `partials` every
//     split writes its own summary in the reference's layout instead
//     (an empty split the empty one) and no merge runs.
// * f32: `split_decode_kernel`, the first design on CUDA cores (K/V
//   staged in f32 shared memory 32 rows a tile, one thread per (query
//   row, cache row) score and per output element), writing the
//   summaries; `combine_kernel`, a second launch, merges them.  The
//   combine reads the f32 summaries once (splits x group x (d + 2)
//   floats per block) and writes the output once: bound by those bytes,
//   and at decode sizes by its launch.
//
// Left for later work: wgmma and TMA, and f32 on the tensor-core design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tc.cuh"

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

// the CUDA-core split kernel's element type: f32 only (bf16 takes dec_tc)
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

// round an f32 value to T's precision (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }

// 8 consecutive elements -> f32 as 16-byte loads (d % 8 == 0, 16-byte
// aligned base, checked by the wrapper)
template <typename T> __device__ __forceinline__ void load8(const T* p, float* o);
template <> __device__ __forceinline__ void load8<float>(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
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

// ------------------------------------------------ tensor-core design (bf16)

namespace dec_tc {

using namespace ::repro_mma;
using ::repro::tc::kTok;   // cache rows per tile (64)
using ::repro::tc::ld;     // shared-memory row stride: d + 8 bf16
using bf16 = __nv_bfloat16;

constexpr int kRows = 16;               // query group rows, one m16 tile
constexpr int kWarps = kThreads / 32;   // each takes 16 rows of a tile
constexpr int kStages = 2;              // K/V ring

// Shared memory, mirrored by kernels/decode_attention/ops.py
// `tc_smem_bytes`: Q [16][d + 8] bf16; the K and V ring [2][64][d + 8]
// bf16, whose space the merges take after the walk (floats: the warps'
// O [4][16][d], m, l and weights [4][16], the block's m and l [16]; then
// the splits' m (then weights) and l [splits][16], the merged m and l
// [16]).
__host__ __device__ constexpr size_t merge_floats(int d, int splits) {
  return (size_t)kWarps * kRows * (d + 3) + 2 * kRows > (size_t)(2 * splits + 2) * kRows
             ? (size_t)kWarps * kRows * (d + 3) + 2 * kRows
             : (size_t)(2 * splits + 2) * kRows;
}
__host__ __device__ constexpr size_t ring_bytes(int d) {
  return sizeof(bf16) * (size_t)2 * kStages * kTok * ld(d);
}
__host__ __device__ constexpr size_t smem_bytes(int d, int splits) {
  return sizeof(bf16) * (size_t)kRows * ld(d) +
         (ring_bytes(d) > sizeof(float) * merge_floats(d, splits)
              ? ring_bytes(d)
              : sizeof(float) * merge_floats(d, splits));
}

// out: (b, hq, D) bf16, written unless `partials`.  m_out, l_out
// [b * hkv][splits][group] and acc_out [b * hkv][splits][group][D] f32:
// with `partials`, every split's own summary.  part: the splits' f32
// scratch, 16-byte aligned: acc [b * hkv][splits][group][D], then m and
// l [b * hkv][splits][group].  tickets: [b * hkv] int32, 0 between
// calls.  Neither is touched with `partials`.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ positions,
                 bf16* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out, float* part,
                 int* tickets, int hq, int hkv, int S, int split_len, int partials) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;           // 16-byte copies per row
  constexpr int OT = D / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kStages * kTok * LD;
  float* mrg = reinterpret_cast<float*>(ks);          // after the walk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const int group = hq / hkv;
  const long long row0 = (long long)b * hq + h * group;   // first output row
  const long long mine = ((long long)bh * splits + split) * group;   // first summary row

  // the last visible row; splits that start at or before it take part in
  // the merge (split 0 always, to write a row that sees nothing)
  const int lim = min(positions[b], S - 1);
  const int n_live = lim < 0 ? 1 : min(splits, lim / split_len + 1);
  const int s0 = split * split_len;
  const int s1 = split < n_live ? min(s0 + split_len, lim + 1) : s0;   // exclusive
  const int n_tiles = s1 > s0 ? (s1 - s0 + kTok - 1) / kTok : 0;
  if (partials && n_tiles == 0) {      // the empty summary
    for (int e = tid; e < group * D; e += kThreads) acc_out[mine * D + e] = 0.f;
    if (tid < group) {
      m_out[mine + tid] = kNegInf;
      l_out[mine + tid] = 0.f;
    }
    return;
  }
  if (split >= n_live) return;

  // K/V copies of tile j into ring stage st: rows of (b, h) at stride
  // hkv * D; rows at or past s1 are zero-filled without a read
  const long long stride = (long long)hkv * D;
  const bf16* kb = k + ((long long)b * S * hkv + h) * D;
  const bf16* vb = v + ((long long)b * S * hkv + h) * D;
  auto issue = [&](int j, int st) {
    const int t0 = s0 + j * kTok;
    bf16* kd = ks + st * kTok * LD;
    bf16* vd = vs + st * kTok * LD;
    for (int i = tid; i < kTok * CPR; i += kThreads) {
      const int tt = i / CPR, e = (i - tt * CPR) * 8;
      const bool live = t0 + tt < s1;
      const long long off = live ? (t0 + tt) * stride + e : 0;
      cp_async16(kd + tt * LD + e, kb + off, live);
      cp_async16(vd + tt * LD + e, vb + off, live);
    }
  };

  const int g = lane >> 2, qd = lane & 3;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // prologue: Q (rows past the group zero-filled) with tile 0, one group
    for (int i = tid; i < kRows * CPR; i += kThreads) {
      const int r = i / CPR, e = (i - r * CPR) * 8;
      const long long off = r < group ? (row0 + r) * D + e : 0;
      cp_async16(qs + r * LD + e, q + off, r < group);
    }
    issue(0, 0);
    cp_async_commit();
    const float scale = 1.f / sqrtf(static_cast<float>(D));

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      if (j + 1 < n_tiles) issue(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      // this warp's 16 rows of the tile (element e of n-tile n: query
      // row g + 8 (e / 2), cache row w0 + 8 n + 2 qd + e % 2)
      const int w0 = s0 + j * kTok + warp * 16;
      if (w0 < s1) {
        const bf16* kt = ks + (st * kTok + warp * 16) * LD;
        const bf16* vt = vs + (st * kTok + warp * 16) * LD;

        // S = Q K^T: 16 query rows x 16 cache rows
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[4], bk[4];
          ldsm_x4(a, qs + (lane & 15) * LD + kk + (lane >> 4) * 8);
          // (rows 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          ldsm_x4(bk, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[0], a, bk[0], bk[1]);
          mma_bf16(sc[1], a, bk[2], bk[3]);
        }

        // scale, mask the rows at or past s1, online softmax
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = w0 + 8 * n + 2 * qd + (e & 1) < s1 ? sc[n][e] * scale : kNegInf;
            sc[n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
          corr[hh] = __expf(m[hh] - m_new);
          m[hh] = m_new;
          l[hh] *= corr[hh];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[n][e];
            const float p = x > 0.5f * kNegInf ? __expf(x - m[e >> 1]) : 0.f;
            sc[n][e] = p;
            l[e >> 1] += p;
          }
#pragma unroll
        for (int n = 0; n < OT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

        // O += bf16(P) V: P's two C fragments are one 16-row A fragment
        uint32_t a[4];
        a[0] = pack_bf16(sc[0][0], sc[0][1]);
        a[1] = pack_bf16(sc[0][2], sc[0][3]);
        a[2] = pack_bf16(sc[1][0], sc[1][1]);
        a[3] = pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
        for (int dn = 0; dn < OT / 2; ++dn) {
          uint32_t bv[4];   // (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(bv, vt + (lane & 15) * LD + dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
      __syncthreads();                 // every warp is done with stage st before it refills
    }
    cp_async_wait<0>();
  }
  __syncthreads();                     // the ring's space becomes the merge's

  // the warps' carries -> shared memory (rows of the group only)
  float* wo = mrg;                                   // [4][16][D]
  float* wm = wo + kWarps * kRows * D;               // [4][16]
  float* wl = wm + kWarps * kRows;                   // [4][16]
  float* wc = wl + kWarps * kRows;                   // [4][16] the warps' weights
  float* bm = wc + kWarps * kRows;                   // [16] the block's m
  float* bl = bm + kRows;                            // [16] the block's l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = quad_sum(l[hh]);
    const int r = g + 8 * hh;
    if (r >= group) continue;
    float* dst = wo + (warp * kRows + r) * D + 2 * qd;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    if (qd == 0) {
      wm[warp * kRows + r] = m[hh];
      wl[warp * kRows + r] = lsum;
    }
  }
  __syncthreads();
  if (tid < group) {
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * kRows + tid]);
    float lb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(wm[w * kRows + tid] - mb);
      wc[w * kRows + tid] = c;
      lb += wl[w * kRows + tid] * c;
    }
    bm[tid] = mb;
    bl[tid] = lb;
  }
  __syncthreads();

  if (partials || n_live == 1) {
    // this split's own summary, or the row's only live split's answer
    for (int e = tid; e < group * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wc[w * kRows + r] * wo[(w * kRows + r) * D + c];
      if (partials)
        acc_out[mine * D + e] = a;
      else   // a row that sees nothing (l = 0) emits exact zeros
        out[row0 * D + e] = __float2bfloat16(a / fmaxf(bl[r], 1e-30f));
    }
    if (partials && tid < group) {
      m_out[mine + tid] = bm[tid];
      l_out[mine + tid] = bl[tid];
    }
    return;
  }

  // this split's summary -> scratch
  const long long n_sum = (long long)gridDim.x * splits * group;
  float* pa = part;
  float* pm = pa + n_sum * D;
  float* pl = pm + n_sum;
  for (int e = tid; e < group * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wc[w * kRows + r] * wo[(w * kRows + r) * D + c];
    pa[mine * D + e] = a;
  }
  if (tid < group) {
    pm[mine + tid] = bm[tid];
    pl[mine + tid] = bl[tid];
  }
  // the block's writes, then one thread's fence and ticket (as a grid
  // barrier orders a block's writes), then the fence that orders the
  // last block's reads after every ticket
  __syncthreads();
  bool arrived_last = false;
  if (tid == 0) {
    __threadfence();
    arrived_last = atomicAdd(tickets + bh, 1) == n_live - 1;
    __threadfence();
  }
  if (!__syncthreads_or(arrived_last)) return;

  // the last live split of (b, h) to arrive merges them all (reference
  // kernel.py:94 combine_splits): m_max over the live splits, weight
  // exp(m - m_max), l_tot = sum l w, acc_tot = sum acc w.  Every split's
  // m and l, then every split's acc, are read through L2 at once.
  const long long first = (long long)bh * splits * group;
  const int n_ml = n_live * group;
  float* sw = mrg;                                   // [n_live][group] m, then weights
  float* sl = sw + n_ml;                             // [n_live][group] l
  float* tl = sl + n_ml;                             // [group]
  for (int i = tid; i < n_ml; i += kThreads) {
    sw[i] = __ldcg(pm + first + i);
    sl[i] = __ldcg(pl + first + i);
  }
  __syncthreads();
  for (int r = tid; r < group; r += kThreads) {
    float mm = kNegInf;
    for (int i = r; i < n_ml; i += group) mm = fmaxf(mm, sw[i]);
    float lt = 0.f;
    for (int i = r; i < n_ml; i += group) {
      const float w = __expf(sw[i] - mm);
      sw[i] = w;
      lt += sl[i] * w;
    }
    tl[r] = lt;
  }
  __syncthreads();
  // float4 columns (D % 16 == 0)
  const int n4 = group * D / 4;
  const float4* pa4 = reinterpret_cast<const float4*>(pa + first * D);
  for (int j = tid; j < n4; j += kThreads) {
    const int r = 4 * j / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp) {
      const float4 x = __ldcg(pa4 + sp * n4 + j);
      const float w = sw[sp * group + r];
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    const float inv = 1.f / fmaxf(tl[r], 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + row0 * D + 4 * j);
    o2[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o2[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
  if (tid == 0) tickets[bh] = 0;       // ready for the next call
}

}  // namespace dec_tc

// The bf16 launch: one instance per head dim 16, 32, ..., 256.
struct TcLaunch {
  const void *q, *k, *v, *positions;
  void *out, *m, *l, *acc, *part, *tickets;
  int b, hq, hkv, S, d, splits, split_len, partials;
  cudaStream_t stream;

  template <int D>
  cudaError_t launch() const {
    using dec_tc::bf16;
    if (hq / hkv > dec_tc::kRows || split_len < 1) return cudaErrorInvalidValue;
    const size_t smem = dec_tc::smem_bytes(D, splits);
    auto kern = dec_tc::decode_tc_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(b * hkv, splits), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(positions),
        static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l),
        static_cast<float*>(acc), static_cast<float*>(part), static_cast<int*>(tickets),
        hq, hkv, S, split_len, partials);
    return cudaGetLastError();
  }

  template <int D = 16>
  cudaError_t run() const {
    if (d == D) return launch<D>();
    if constexpr (D < 256) return run<D + 16>();
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro_dec

// q (b, hq, d) and caches (b, S, hkv, d), all f32 or all bf16 (dtype
// code 0 / 1), contiguous and 16-byte aligned; positions (b,) int32.
// m, l (b * hkv, splits, hq / hkv) and acc (b * hkv, splits, hq / hkv, d)
// f32: the splits' summaries.
// * f32 (d % 8 == 0): the CUDA-core split kernel writes the summaries;
//   `out`, `part`, `tickets` and `partials` are ignored (the combine
//   kernel, repro_combine_splits, makes the output).
// * bf16 (d % 16 == 0, d <= 256, hq / hkv <= 16): the tensor-core
//   kernel.  With `partials` it writes the summaries (m, l, acc); without,
//   out (b, hq, d) bf16, through `part`, f32 scratch of (2 + d) * b * hq *
//   splits floats, and `tickets`, b * hkv int32 that are 0 between calls.
// Returns the CUDA error of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* positions,
                                      void* out, void* m, void* l, void* acc, void* part,
                                      void* tickets, int b, int hq, int hkv, int S, int d,
                                      int splits, int split_len, int partials, int dtype,
                                      void* stream) {
  using namespace repro_dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return static_cast<int>(TcLaunch{q, k_cache, v_cache, positions, out, m, l, acc, part,
                                     tickets, b, hq, hkv, S, d, splits, split_len,
                                     partials, s}.run());
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
