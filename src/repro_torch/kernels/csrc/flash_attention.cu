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
// the PV product (kernel.py:57), and the output is acc / max(l, 1e-30),
// so a row that sees no key is exact zeros.
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
// cores and short ones by the bytes.  Two designs, fixed by the dtype
// (the wrapper, kernels/flash_attention/ops.py `route`, mirrors it):
//
// * bf16 (every served configuration): `tc::flash_tc_kernel`, the
//   flash-style design of bf16 paged prefill (paged_prefill.cu namespace
//   tc) over contiguous K/V.  A block of 4 warps takes 64 packed rows of
//   one (batch row, kv head): packed row r is query position r / group
//   and group member r % group, as the TPU kernel's resident KV tile
//   serves its whole group (kernel.py:5-8), so each K/V byte is read
//   once per kv head, not once per query head.  K/V arrive in 64-key
//   tiles by 16-byte cp.async copies into a 2-stage ring: tile j + 1 is
//   in flight while tile j computes.  Keys past skv or past the tile's
//   causal bound are zero-filled by the copy (source size 0) and masked;
//   only tiles that cross a row's limit apply the mask.  S = Q K^T by
//   mma.sync m16n8k16 (bf16 in, f32 out) from ldmatrix loads of rows
//   padded by 16 bytes; the online softmax runs in registers (row max
//   and sum over the quad that holds a row); p becomes bf16 in registers
//   and is the A fragment of P V (V by ldmatrix.trans); O stays in
//   registers, d / 2 f32 per thread, so the head dim (multiples of 16 up
//   to 256) is a template parameter.  The causal walk stops at the last
//   key the tile's last row can see, and causal tiles are launched
//   longest walk first, so the longest blocks start in the first wave.
//   Shared memory: Q [64][d + 8], K and V [2][64][d + 8] bf16 (85 KB at
//   d 128, 105 KB at d 160: two blocks per SM).
// * f32 (taken only by the parity checks; on tensor cores it would be
//   TF32, which the port never uses): `flash_f32_kernel`, 32 x 32 tiles
//   on CUDA cores, one block per (query tile, batch row x query head).
//
// Training: `repro_flash_attention_lse` runs the same kernels and also
// writes each row's log-sum-exp m + log(l) (f32, (b, hq, sq); -inf for a
// row that sees no key), which flash_attention_bwd.cu reads to recompute
// P; the serving entry point passes no lse and writes none.
//
// Known limits, left for later work: no wgmma or TMA, and mma.sync's
// m16n8k16 tiles leave the tensor cores below their wgmma rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace repro_fa {

constexpr int kThreads = 128;   // 4 warps
constexpr float kNegInf = -1e30f;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------ tensor-core design (bf16)

namespace tc {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // packed query rows per block, 16 per warp
constexpr int kTok = 64;        // keys per K/V tile
constexpr int kStages = 2;      // K/V ring
constexpr int kPad = 8;         // bf16 elements of row padding (16 bytes)

// Shared memory, mirrored by kernels/flash_attention/ops.py
// `tc_smem_bytes`: Q [64][d + 8], then K and V [2][64][d + 8], bf16.
__host__ __device__ constexpr int ld(int d) { return d + kPad; }
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(1 + 2 * kStages) * kRows * ld(d);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int sq, int skv, int hq, int hkv, int q_offset,
                int causal) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;           // 16-byte copies per row
  constexpr int NT = kTok / 8;         // score n-tiles per warp
  constexpr int OT = D / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kStages * kTok * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int rows = sq * group;         // packed rows of this (batch row, kv head)
  // causal: the last packed tile walks the most keys, and runs first
  const int z = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = z * kRows;
  // the tile's causal bound: the last key its last row can see
  const int r_last = min(r0 + kRows, rows) - 1;
  const int kv_end = causal ? min(skv, q_offset + r_last / group + 1) : skv;
  const int n_kv = (kv_end + kTok - 1) / kTok;

  // this thread's two rows (quad row g and g + 8 of its warp's 16) and
  // the last key each sees; the smallest limit of the block marks the
  // tiles that need the mask, and the warp's largest the tiles it skips
  const int g = lane >> 2, qd = lane & 3;
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r0 + warp * 16 + g + 8 * hh;
    lim[hh] = causal ? min(skv - 1, q_offset + rr / group) : skv - 1;
  }
  const int lim_lo = causal ? min(skv - 1, q_offset + r0 / group) : skv - 1;
  const int warp_lim = __shfl_sync(0xffffffffu, lim[1], 31);

  const long long tok_stride = (long long)hkv * D;
  const bf16* kb = k + ((long long)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((long long)b * skv * hkv + hk) * D;

  // K/V copies of kv tile j into ring stage s; keys past kv_end are zeros
  auto issue = [&](int j, int s) {
    const int t0 = j * kTok;
    bf16* kd = ks + s * kTok * LD;
    bf16* vd = vs + s * kTok * LD;
    for (int i = tid; i < kTok * CPR; i += kThreads) {
      const int tt = i / CPR, e = (i - tt * CPR) * 8;
      const bool live = t0 + tt < kv_end;
      const long long off = (live ? t0 + tt : 0) * tok_stride + e;
      cp_async16(kd + tt * LD + e, kb + off, live);
      cp_async16(vd + tt * LD + e, vb + off, live);
    }
  };

  // prologue: Q (rows past the packed rows are zeros) with tile 0, one group
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, e = (i - r * CPR) * 8;
    const int rr = r0 + r;
    long long off = 0;
    if (rr < rows) {
      const int qi = rr / group, gi = rr - qi * group;
      off = (((long long)b * sq + qi) * hq + hk * group + gi) * D + e;
    }
    cp_async16(qs + r * LD + e, q + off, rr < rows);
  }
  if (n_kv > 0) issue(0, 0);
  cp_async_commit();

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1;
    if (j + 1 < n_kv) issue(j + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int kv0 = j * kTok;
    if (kv0 <= warp_lim) {
      const bf16* kt = ks + s * kTok * LD;
      const bf16* vt = vs + s * kTok * LD;

      // S = Q K^T: 16 rows x 64 keys per warp
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          uint32_t bk[4];   // (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          ldsm_x4(bk, kt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * nn], a, bk[0], bk[1]);
          mma_bf16(sc[2 * nn + 1], a, bk[2], bk[3]);
        }
      }

      // scale, mask where the tile crosses a row's limit, online softmax
      // (element e of n-tile n: row g + 8 (e / 2), key kv0 + 8 n + 2 qd + e % 2)
      const bool masked = kv0 + kTok - 1 > lim_lo;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + n * 8 + 2 * qd + (e & 1);
          const float val = !masked || key <= lim[e >> 1] ? sc[n][e] * scale : kNegInf;
          sc[n][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
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
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float val = sc[n][e];
          const float p = val > 0.5f * kNegInf ? __expf(val - m[e >> 1]) : 0.f;
          sc[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < OT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

      // O += bf16(P) V: P's C fragments are the A fragments of 16-key steps
#pragma unroll
      for (int kt2 = 0; kt2 < NT / 2; ++kt2) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kt2][0], sc[2 * kt2][1]);
        a[1] = pack_bf16(sc[2 * kt2][2], sc[2 * kt2][3]);
        a[2] = pack_bf16(sc[2 * kt2 + 1][0], sc[2 * kt2 + 1][1]);
        a[3] = pack_bf16(sc[2 * kt2 + 1][2], sc[2 * kt2 + 1][3]);
#pragma unroll
        for (int dn = 0; dn < OT / 2; ++dn) {
          uint32_t bv[4];   // (keys 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(bv, vt + (kt2 * 16 + (lane & 15)) * LD + dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
    }
    // every warp is done with stage s before the next iteration refills it
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: the quad's partial sums, then O / max(l, 1e-30) (a row that
  // saw no key has l = 0 and O = 0: exact zeros)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = quad_sum(l[hh]);
    const int rr = r0 + warp * 16 + g + 8 * hh;
    if (rr >= rows) continue;
    const int qi = rr / group, gi = rr - qi * group;
    bf16* orow = out + (((long long)b * sq + qi) * hq + hk * group + gi) * D + 2 * qd;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    // training's log-sum-exp m + log(l): -inf for a row that saw no key
    if (lse != nullptr && qd == 0)
      lse[((long long)b * hq + hk * group + gi) * sq + qi] = m[hh] + logf(lsum);
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int sq, int skv, int hq, int hkv, int q_offset, int causal,
                   cudaStream_t stream) {
  const int tiles = (sq * (hq / hkv) + kRows - 1) / kRows;
  const size_t smem = smem_bytes(D);
  auto kern = flash_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory, so two blocks fit at d <= 160
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(b * hkv, tiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, sq, skv, hq, hkv, q_offset, causal);
  return cudaGetLastError();
}

// head dims 16, 32, ..., 256, each its own register layout
template <int D = 16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                     int sq, int skv, int hq, int hkv, int d, int q_offset, int causal,
                     cudaStream_t stream) {
  if (d == D)
    return launch<D>(q, k, v, out, lse, b, sq, skv, hq, hkv, q_offset, causal, stream);
  if constexpr (D < 256)
    return dispatch<D + 16>(q, k, v, out, lse, b, sq, skv, hq, hkv, d, q_offset, causal,
                            stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ------------------------------------------------- CUDA-core design (f32)

constexpr int kBQ = 32, kBKV = 32, kPadF = 4;   // query rows, keys, row padding

__host__ __device__ inline size_t round128(size_t n) { return (n + 127) / 128 * 128; }

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

// Shared-memory carve-up, every array on a 128-byte boundary; mirrored by
// kernels/flash_attention/ops.py `smem_bytes`.
struct Layout {
  int ldq, lds, ldo;           // row strides: Q/K/V, S and P, O
  size_t q, k, v, s, o, m, l, total;

  __host__ __device__ explicit Layout(int d) {
    ldq = d + kPadF;
    lds = kBKV + 4;
    ldo = d + 4;
    q = 0;
    k = q + round128(sizeof(float) * kBQ * ldq);
    v = k + round128(sizeof(float) * kBKV * ldq);
    s = v + round128(sizeof(float) * kBKV * ldq);
    o = s + round128(sizeof(float) * kBQ * lds);
    m = o + round128(sizeof(float) * kBQ * ldo);
    l = m + round128(sizeof(float) * kBQ);
    total = l + round128(sizeof(float) * kBQ);
  }
};

// `rows` rows of d floats, `row_stride` apart in device memory, into
// shared memory at stride ld, 16 bytes per copy; rows past `valid` are
// zeros.  d % 4 == 0 and 16-byte aligned bases (wrapper).
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long row_stride, int rows, int valid, int d) {
  const int per_row = d / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int hq, int hkv, int d,
                 int q_offset, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(d);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);   // S, then P in place
  float* os = reinterpret_cast<float*>(smem + L.o);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);

  const int q0 = blockIdx.x * kBQ;
  const int bhq = blockIdx.y;
  const int b = bhq / hq, h = bhq - b * hq;
  const int hk = h / (hq / hkv);
  const int rows = min(kBQ, sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = 1.f / sqrtf(static_cast<float>(d));

  load_rows(qs, L.ldq, q + (((long long)b * sq + q0) * hq + h) * d, (long long)hq * d, kBQ,
            rows, d);
  for (int i = tid; i < kBQ * L.ldo; i += kThreads) os[i] = 0.f;
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  // the causal walk stops at the last key the tile's last row can see
  const int kv_end = causal ? min(skv, q0 + rows + q_offset) : skv;
  const float* kb = k + ((long long)b * skv * hkv + hk) * d;
  const float* vb = v + ((long long)b * skv * hkv + hk) * d;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    const int valid = min(kBKV, skv - kv0);
    load_rows(ks, L.ldq, kb + (long long)kv0 * hkv * d, (long long)hkv * d, kBKV, valid, d);
    load_rows(vs, L.ldq, vb + (long long)kv0 * hkv * d, (long long)hkv * d, kBKV, valid, d);
    __syncthreads();
    // S = Q K^T (raw dots)
    for (int i = tid; i < kBQ * kBKV; i += kThreads) {
      const int r = i / kBKV, t = i - r * kBKV;
      const float* qr = qs + r * L.ldq;
      const float* kr = ks + t * L.ldq;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      ss[r * L.lds + t] = dot;
    }
    __syncthreads();

    // fold the tile into (m, l) and rescale O: one warp per query row,
    // one lane per key; masked p is exactly 0
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const int kvpos = kv0 + lane;
      const bool ok = kvpos < skv && (!causal || kvpos <= q0 + r + q_offset);
      const float sv = ok ? ss[r * L.lds + lane] * scale : kNegInf;
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      ss[r * L.lds + lane] = p;
      const float sum = warp_sum(p);
      const float corr = expf(m_old - m_new);
      for (int c = lane; c < d; c += 32) os[r * L.ldo + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // O += P V
    for (int i = tid; i < kBQ * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const float* pr = ss + r * L.lds;
      float a = os[r * L.ldo + c];
      for (int t = 0; t < kBKV; ++t) a = fmaf(pr[t], vs[t * L.ldq + c], a);
      os[r * L.ldo + c] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    out[(((long long)b * sq + q0 + r) * hq + h) * d + c] =
        os[r * L.ldo + c] / fmaxf(ls[r], 1e-30f);
  }
  if (lse != nullptr && tid < rows)
    lse[((long long)b * hq + h) * sq + q0 + tid] = ms[tid] + logf(ls[tid]);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int b, int sq, int skv, int hq, int hkv, int d, int q_offset,
                       int causal, cudaStream_t stream) {
  const Layout L(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_f32_kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, skv, hq, hkv, d,
      q_offset, causal);
  return cudaGetLastError();
}

}  // namespace repro_fa

// q (b, sq, hq, d), k and v (b, skv, hkv, d), out (b, sq, hq, d), all f32
// or all bf16 (dtype code 0 / 1), contiguous and 16-byte aligned, d a
// multiple of 16 (bf16: up to 256); lse, when not null, (b, hq, sq) f32
// gets each row's m + log(l) (the training forward: flash_attention_bwd.cu
// reads it).  Returns the CUDA error of the launch.
extern "C" int repro_flash_attention_lse(const void* q, const void* k, const void* v,
                                         void* out, void* lse, int b, int sq, int skv, int hq,
                                         int hkv, int d, int q_offset, int causal, int dtype,
                                         void* stream) {
  using namespace repro_fa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16)
    return static_cast<int>(
        tc::dispatch(q, k, v, out, l, b, sq, skv, hq, hkv, d, q_offset, causal, s));
  if (dtype == kF32)
    return static_cast<int>(
        launch_f32(q, k, v, out, l, b, sq, skv, hq, hkv, d, q_offset, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the serving launch: the same kernels, no lse
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int sq, int skv, int hq, int hkv, int d,
                                     int q_offset, int causal, int dtype, void* stream) {
  return repro_flash_attention_lse(q, k, v, out, nullptr, b, sq, skv, hq, hkv, d, q_offset,
                                   causal, dtype, stream);
}
