// Paged chunk-prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_prefill_attention_pallas`
// (src/repro/kernels/paged_prefill/kernel.py:90): a ragged (b, c) chunk
// of queries at absolute positions start[b] + ci attends causally over
// the same block-table walk as decode, with mask kv_pos <= start[b] + ci
// AND ci < chunk_len[b]; rows past chunk_len are exact zeros.
//
// Chunk rows x query group are packed densely as in the TPU kernel
// (packed row r is chunk position r / group, group member r % group),
// and a block of 128 threads takes a tile of packed rows of one (batch
// row, kv head), so every page it loads serves the whole tile.  Bound:
// the live K/V bytes; the walk stops at the page holding the tile's
// largest visible position, the causal bound of the tile.
//
// Two designs, fixed by the (q, pages) element types in `PrefillLaunch`
// (the wrapper, kernels/paged_prefill/ops.py `route`, mirrors it and
// raises on a bf16 call the first one cannot take):
//
// * bf16 q with bf16 pages (every served configuration): the flash-style
//   tensor-core kernel below, `prefill_tc_kernel`.  64 packed rows per
//   block, 16 per warp.  KV tiles of 64 tokens (whole pages; 64-token
//   slices of a larger page) land in shared memory as bf16, unconverted,
//   by 16-byte cp.async copies into a 2-stage ring: tile j + 1's copies
//   are in flight while tile j's products run.  Skipped tokens (past the
//   tile's causal bound, POS_PAD holes, the padding of a short tile) are
//   zero-filled by the copy itself (source size 0) and never read.
//   S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 out; K rows [token][d]
//   are the col-major B operand as they lie), then 1/sqrt(d), the mask
//   and the online softmax in registers (row max and sum over the quad
//   that holds a row; m, l and the rescale in f32; p is 0 where masked,
//   so a fully masked tile leaves the carry untouched).  p is rounded to
//   bf16 in registers and reused as the A operand of P @ V (V by
//   ldmatrix.trans), as the TPU kernel rounds p to V's type
//   (paged_attention/kernel.py accumulate_block); the O accumulator
//   stays in registers.  Rows are padded by 16 bytes in shared memory,
//   so each ldmatrix phase hits 8 distinct 16-byte bank groups.  Head
//   dims: multiples of 16 up to 256 (a template parameter, so the
//   accumulators are registers).  Block-table reads run one tile ahead
//   of the copies (a 3-slot ring of per-token rows and positions).
// * f32 q, or int8 / fp8 pages: the CUDA-core machine `attend_rows`
//   (paged_common.cuh), shared with paged decode.  f32 on tensor cores
//   would be TF32, which the port never uses; quantized pages are
//   dequantised to f32 as they land.
//
// Left for later work on the tensor-core design: wgmma and TMA, a split
// over the KV length for small chunks, quantized pages on tensor cores.
#include <type_traits>

#include "paged_tc.cuh"

namespace repro {

// --------------------------------------------- CUDA-core design (f32, int8, fp8)

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                     const TKV* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ bt,
                     const int* __restrict__ start, const int* __restrict__ chunk_len,
                     const int* __restrict__ ppos, TQ* __restrict__ out,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int c, int hq, int hkv, int d, int page,
                     int max_pages, int rows_per_tile, int partials) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int R = rows_per_tile;
  Smem sm(smem, R, d, page);
  if (threadIdx.x < R) {
    const int rr = blockIdx.z * R + threadIdx.x;
    int rid = -1, lim = -1;
    if (rr < c * group) {
      const int ci = rr / group, gi = rr - ci * group;
      rid = (b * c + ci) * hq + h * group + gi;
      lim = ci < chunk_len[b] ? start[b] + ci : -1;
    }
    sm.rid[threadIdx.x] = rid;
    sm.lim[threadIdx.x] = lim;
  }
  __syncthreads();
  attend_rows<TQ, TKV>(sm, q, kp, vp, ks, vs, bt + (long long)b * max_pages,
                       ppos != nullptr ? ppos + (long long)b * max_pages : nullptr, R, d,
                       page, hkv, h, max_pages, out, acc_out, m_out, l_out, partials != 0);
}

// ------------------------------------------------ tensor-core design (bf16)

namespace tc {

constexpr int kRows = 64;        // packed query rows per block, 16 per warp
constexpr int kStages = 2;       // K/V ring

// Shared memory, mirrored by kernels/paged_prefill/ops.py `tc_smem_bytes`:
// Q [64][d + 8], K and V [2][64][d + 8] bf16, then the meta ring
// [3][64] arena rows and [3][64] positions (int32).
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(1 + 2 * kStages) * kRows * ld(d) +
         sizeof(int) * (size_t)2 * kMetaSlots * kTok;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                  const bf16* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ start, const int* __restrict__ chunk_len,
                  const int* __restrict__ ppos, bf16* __restrict__ out,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int c, int hq, int hkv, int page, int max_pages,
                  int partials) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;           // 16-byte copies per row
  constexpr int NT = kTok / 8;         // score n-tiles per warp
  constexpr int OT = D / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kStages * kTok * LD;
  int* meta_row = reinterpret_cast<int*>(vs + kStages * kTok * LD);
  int* meta_pos = meta_row + kMetaSlots * kTok;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int group = hq / hkv;
  const int rows = c * group;          // packed rows of this (batch row, kv head)
  const int st_b = start[b], clen = chunk_len[b];

  // the tile's causal bound: the largest visible position of its rows
  const int ci_lo = z * kRows / group;
  const int ci_hi = min(z * kRows + kRows - 1, rows - 1) / group;
  const int top = min(ci_hi, clen - 1);
  Walk walk;
  walk.bt = bt + (long long)b * max_pages;
  walk.ppos = ppos != nullptr ? ppos + (long long)b * max_pages : nullptr;
  walk.page = page;
  walk.hkv = hkv;
  walk.h = h;
  walk.max_lim = top >= ci_lo ? st_b + top : -1;
  walk.tp = page >= kTok ? 1 : kTok / page;
  walk.spp = page > kTok ? (page + kTok - 1) / kTok : 1;
  // default positions stop at the last page any row can see; explicit
  // positions walk every column, skipping what lies past every row's limit
  walk.n_cols = ppos != nullptr ? max_pages
                : (walk.max_lim < 0 ? 0 : min(max_pages, walk.max_lim / page + 1));
  const int n_tiles = walk.max_lim < 0 ? 0 : (walk.n_cols + walk.tp - 1) / walk.tp * walk.spp;

  // this thread's two rows (quad row g and g + 8 of its warp's 16)
  const int g = lane >> 2, qd = lane & 3;
  int lim[2], rid[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = z * kRows + warp * 16 + g + 8 * hh;
    lim[hh] = -1;
    rid[hh] = -1;
    if (rr < rows) {
      const int ci = rr / group, gi = rr - ci * group;
      rid[hh] = (b * c + ci) * hq + h * group + gi;
      if (ci < clen) lim[hh] = st_b + ci;
    }
  }
  const bool warp_live = __any_sync(0xffffffffu, lim[0] >= 0 || lim[1] >= 0);

  // K/V copies of tile t into ring stage s from meta slot t % 3
  auto issue = [&](int t, int s) {
    issue_tile<D>(meta_row + (t % kMetaSlots) * kTok, ks + s * kTok * LD, vs + s * kTok * LD,
                  kp, vp);
  };

  // prologue: meta of tiles 0 and 1, then Q with tile 0 as one group
  bool live_cur = false, live_next = false;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int row = -1, pos = kMasked;
    if (tid < kTok && t < n_tiles) {
      walk.token(t, tid, row, pos);
      meta_row[t * kTok + tid] = row;
      meta_pos[t * kTok + tid] = pos;
    }
    const bool live = __syncthreads_or(row >= 0) != 0;
    (t == 0 ? live_cur : live_next) = live;
  }
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, e = (i - r * CPR) * 8;
    const int rr = z * kRows + r;
    long long off = 0;
    if (rr < rows) {
      const int ci = rr / group, gi = rr - ci * group;
      off = (long long)((b * c + ci) * hq + h * group + gi) * D + e;
    }
    cp_async16(qs + r * LD + e, q + off, rr < rows);
  }
  if (live_cur) issue(0, 0);
  cp_async_commit();

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < n_tiles && live_next) issue(j + 1, s ^ 1);
    cp_async_commit();
    // the table reads of tile j + 2, in flight while tile j computes
    const bool meta_ahead = tid < kTok && j + 2 < n_tiles;
    int ncol = -1, nw = 0, nb0 = 0, nslot = 0;
    if (meta_ahead) ncol = walk.locate(j + 2, tid, nw);
    if (ncol >= 0) walk.read(ncol, nb0, nslot);
    cp_async_wait<1>();
    __syncthreads();

    if (live_cur && warp_live) {
      const bf16* kt = ks + s * kTok * LD;
      const bf16* vt = vs + s * kTok * LD;
      const int* pos = meta_pos + (j % kMetaSlots) * kTok;

      // S = Q K^T: 16 rows x 64 tokens per warp
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
          uint32_t bk[4];   // (tokens 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          ldsm_x4(bk, kt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * nn], a, bk[0], bk[1]);
          mma_bf16(sc[2 * nn + 1], a, bk[2], bk[3]);
        }
      }

      // scale, mask, online softmax (element e of n-tile n: row g + 8 (e / 2),
      // token 8 n + 2 qd + e % 2)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int2 pp = *reinterpret_cast<const int2*>(pos + n * 8 + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = (e & 1) ? pp.y : pp.x;
          const float v = p <= lim[e >> 1] ? sc[n][e] * scale : kNegInf;
          sc[n][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
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
          const float v = sc[n][e];
          const float p = v > 0.5f * kNegInf ? __expf(v - m[e >> 1]) : 0.f;
          sc[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < OT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

      // O += bf16(P) V: P's C fragments are the A fragments of 16-token steps
#pragma unroll
      for (int kt2 = 0; kt2 < NT / 2; ++kt2) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kt2][0], sc[2 * kt2][1]);
        a[1] = pack_bf16(sc[2 * kt2][2], sc[2 * kt2][3]);
        a[2] = pack_bf16(sc[2 * kt2 + 1][0], sc[2 * kt2 + 1][1]);
        a[3] = pack_bf16(sc[2 * kt2 + 1][2], sc[2 * kt2 + 1][3]);
#pragma unroll
        for (int dn = 0; dn < OT / 2; ++dn) {
          uint32_t bv[4];   // (tokens 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(bv, vt + (kt2 * 16 + (lane & 15)) * LD + dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
    }

    int nrow, npos;
    walk.resolve(ncol, nw, nb0, nslot, nrow, npos);
    if (meta_ahead) {
      meta_row[((j + 2) % kMetaSlots) * kTok + tid] = nrow;
      meta_pos[((j + 2) % kMetaSlots) * kTok + tid] = npos;
    }
    // every warp is done with stage s and meta slot j % 3 before they refill
    const bool live_after = __syncthreads_or(nrow >= 0) != 0;
    live_cur = live_next;
    live_next = live_after;
  }
  cp_async_wait<0>();

  // epilogue: the quad's partial sums, then O / max(l, 1e-30) or the raw carry
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = quad_sum(l[hh]);
    if (rid[hh] < 0) continue;
    const long long base = (long long)rid[hh] * D + 2 * qd;
    if (partials) {
#pragma unroll
      for (int n = 0; n < OT; ++n)
        *reinterpret_cast<float2*>(acc_out + base + n * 8) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
      if (qd == 0) {
        m_out[rid[hh]] = m[hh];
        l_out[rid[hh]] = lsum;
      }
    } else {
      // zero-l rows (fully masked) emit exact zeros
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
      for (int n = 0; n < OT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + base + n * 8) =
            __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

}  // namespace tc

struct PrefillLaunch {
  const void *q, *kp, *vp, *ks, *vs, *bt, *start, *chunk_len, *ppos;
  void *out, *m_out, *l_out;
  int b, c, hq, hkv, d, page, max_pages, rows_per_tile, partials;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  cudaError_t operator()() const {
    if constexpr (std::is_same_v<TQ, __nv_bfloat16> && std::is_same_v<TKV, __nv_bfloat16>)
      return tensor_cores();
    else
      return cuda_cores<TQ, TKV>();
  }

  template <typename TQ, typename TKV>
  cudaError_t cuda_cores() const {
    const int group = hq / hkv;
    const int tiles = (c * group + rows_per_tile - 1) / rows_per_tile;
    const size_t smem = smem_bytes(rows_per_tile, d, page);
    auto kern = paged_prefill_kernel<TQ, TKV>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(b, hkv, tiles), kThreads, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
        static_cast<const TKV*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(start), static_cast<const int*>(chunk_len),
        static_cast<const int*>(ppos), partials ? nullptr : static_cast<TQ*>(out),
        partials ? static_cast<float*>(out) : nullptr, static_cast<float*>(m_out),
        static_cast<float*>(l_out), c, hq, hkv, d, page, max_pages, rows_per_tile,
        partials);
    return cudaGetLastError();
  }

  template <int D>
  cudaError_t launch_tc() const {
    using tc::bf16;
    const int tiles = (c * (hq / hkv) + tc::kRows - 1) / tc::kRows;
    const size_t smem = tc::smem_bytes(D);
    auto kern = tc::prefill_tc_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // all of the SM's 228 KB as shared memory, so two blocks fit at d <= 160
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kern<<<dim3(b, hkv, tiles), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), static_cast<const int*>(bt),
        static_cast<const int*>(start), static_cast<const int*>(chunk_len),
        static_cast<const int*>(ppos), partials ? nullptr : static_cast<bf16*>(out),
        partials ? static_cast<float*>(out) : nullptr, static_cast<float*>(m_out),
        static_cast<float*>(l_out), c, hq, hkv, page, max_pages, partials);
    return cudaGetLastError();
  }

  // head dims 16, 32, ..., 256, each its own register layout
  template <int D = 16>
  cudaError_t tensor_cores() const {
    if (ks != nullptr || vs != nullptr) return cudaErrorInvalidValue;
    if (d == D) return launch_tc<D>();
    if constexpr (D < 256) return tensor_cores<D + 16>();
    return cudaErrorInvalidValue;
  }
};

}  // namespace repro

// q (b, c, hq, d); k/v pages (P, page, hkv, d); scales (P, page, hkv) f32
// or null; block_table/page_positions (b, max_pages) i32 (page_positions
// may be null); start/chunk_len (b,) i32.  out is (b, c, hq, d) in q's
// type, or with partials the f32 acc, beside m_out/l_out (b, c, hq).
// rows_per_tile is the CUDA-core design's tile; the tensor-core design
// (bf16 q with bf16 pages) ignores it.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* block_table, const void* start,
                                   const void* chunk_len, const void* page_positions,
                                   void* out, void* m_out, void* l_out, int b, int c, int hq,
                                   int hkv, int d, int page, int max_pages,
                                   int rows_per_tile, int q_dtype, int kv_dtype,
                                   int partials, void* stream) {
  const repro::PrefillLaunch launch{q,         k_pages,   v_pages,        k_scale,
                                    v_scale,   block_table, start,        chunk_len,
                                    page_positions, out,    m_out,        l_out,
                                    b,         c,         hq,             hkv,
                                    d,         page,      max_pages,      rows_per_tile,
                                    partials,  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(repro::dispatch_types(q_dtype, kv_dtype, launch));
}
