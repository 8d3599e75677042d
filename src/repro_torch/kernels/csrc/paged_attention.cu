// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_decode_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py:245): one decode query per
// batch row attends over a (P, page, hkv, d) page arena through a
// (b, max_pages) block table, GQA group per kv head, f32 online softmax,
// mask kv_pos <= positions[b] over per-column page positions, optional
// raw (m, l, acc) partials and int8/fp8 pages with per-token scales.
//
// Bound: the live K/V bytes.  Decode does 4 flops per K/V element pair
// and query row, far below the card's ~295 flop/byte ridge, so what
// counts is how many bytes are in flight at once.  Two designs, fixed by
// the (q, pages) element types in `DecodeLaunch` (the wrapper,
// kernels/paged_attention/ops.py `route`, mirrors it and raises on a
// bf16 call the first one cannot take):
//
// * bf16 q with bf16 pages (every served configuration):
//   `dec_tc::decode_tc_kernel`, one launch per call.
//   - Split over the KV length.  Grid (b * hkv, splits): block (bh, s)
//     takes table columns [s * pps, (s + 1) * pps), pps = max(1, 128 /
//     page) whole pages (the host picks pps and splits from max_pages
//     and page; it never reads positions).  With default page positions
//     a split wholly past its row's position exits at once and takes no
//     part in the merge; with explicit positions a split whose columns
//     all lie past the position (POS_PAD holes included) writes the
//     empty summary (m = -1e30, l = 0) and exits.
//   - A cp.async ring of bf16 K/V tiles (2 stages of kTok = 64 tokens:
//     a 128-token split is in flight at once), no f32 staging.  The
//     table walk and its one-tile-ahead meta ring are paged_tc.cuh's,
//     shared with bf16 prefill; skipped tokens are zero-filled by the
//     copy (source size 0) and get p = 0.
//   - Tensor cores over the query group: the group's rows (1, 2 or 8
//     served; at most 16) are one m16 tile, padded with zero rows.  Each
//     of the 4 warps takes 16 tokens of a tile: S = Q K^T (16 x 16, D/16
//     mma.sync steps), the online softmax in registers, p rounded to
//     bf16 and reused as the A operand of O += P V (D / 8 n-tiles), as
//     the TPU kernel rounds p to V's type.  Each warp keeps its own
//     (m, l, O) in registers; after the walk the 4 warps merge through
//     shared memory (the ring's space).
//   - The merge of the splits, in the same launch: each split writes its
//     f32 (m, l, acc) to a scratch buffer, fences, and takes a ticket
//     from its (batch row, kv head) counter; the last to arrive merges
//     the splits by log-sum-exp (reads through L2), writes the output in
//     bf16 or the merged raw carry, and resets the counter to 0 for the
//     next call.  A row with one live split writes its output directly.
//     The scratch and the counters belong to the device (ops.py), so two
//     calls in flight on two streams would share the counters; the port
//     runs one stream.
// * f32 q, or int8 / fp8 pages: the CUDA-core machine `attend_rows`
//   (paged_common.cuh), grid (b, hkv): one block per (batch row, kv
//   head) holds the whole query group and reads every live page of its
//   row once (K twice for bf16 pages under f32 q, which round as the
//   plain version does).
//
// Left for later work: wgmma and TMA, and int8/fp8 and f32 on this design.
#include <type_traits>

#include "paged_tc.cuh"

namespace repro {

// --------------------------------------------- CUDA-core design (f32, int8, fp8)

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ positions, const int* __restrict__ ppos,
                    TQ* __restrict__ out, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int hq, int hkv, int d, int page, int max_pages, int partials) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  Smem sm(smem, group, d, page);
  if (threadIdx.x < group) {
    sm.rid[threadIdx.x] = b * hq + h * group + threadIdx.x;
    sm.lim[threadIdx.x] = positions[b];
  }
  __syncthreads();
  attend_rows<TQ, TKV>(sm, q, kp, vp, ks, vs, bt + (long long)b * max_pages,
                       ppos != nullptr ? ppos + (long long)b * max_pages : nullptr,
                       group, d, page, hkv, h, max_pages, out, acc_out, m_out, l_out,
                       partials != 0);
}

// ------------------------------------------------ tensor-core design (bf16)

namespace dec_tc {

using namespace ::repro::tc;

constexpr int kRows = 16;               // query group rows, one m16 tile
constexpr int kWarps = kThreads / 32;   // each takes 16 tokens of a tile
constexpr int kStages = 2;              // K/V ring

// Shared memory, mirrored by kernels/paged_attention/ops.py
// `tc_smem_bytes`: Q [16][d + 8] bf16; the K and V ring [2][64][d + 8]
// bf16, whose space the merges take after the walk (floats: the warps'
// O [4][16][d], m, l and weights [4][16], the block's m and l [16]; then
// the splits' m (then weights) and l [splits][16], the merged m and l
// [16]); the meta ring [3][64] arena rows and [3][64] positions (int32).
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
              : sizeof(float) * merge_floats(d, splits)) +
         sizeof(int) * (size_t)2 * kMetaSlots * kTok;
}

// out / acc_out / m_out / l_out: the call's outputs (q's layout; with
// partials the f32 carry).  part: the splits' f32 scratch, 16-byte
// aligned: acc [b * hkv][splits][group][D], then m and l
// [b * hkv][splits][group].
// tickets: [b * hkv] int32, 0 between calls.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ bt,
                 const int* __restrict__ positions, const int* __restrict__ ppos,
                 bf16* __restrict__ out, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, float* part,
                 int* tickets, int hq, int hkv, int page, int max_pages, int pps,
                 int partials) {
  constexpr int LD = ld(D);
  constexpr int CPR = D / 8;           // 16-byte copies per row
  constexpr int OT = D / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kStages * kTok * LD;
  float* mrg = reinterpret_cast<float*>(ks);          // after the walk
  const size_t ring = ring_bytes(D) > sizeof(float) * merge_floats(D, gridDim.y)
                          ? ring_bytes(D)
                          : sizeof(float) * merge_floats(D, gridDim.y);
  int* meta_row = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(ks) + ring);
  int* meta_pos = meta_row + kMetaSlots * kTok;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const int group = hq / hkv;
  const int col0 = split * pps;
  const int cols = min(pps, max_pages - col0);

  Walk walk;
  walk.bt = bt + (long long)b * max_pages + col0;
  walk.ppos = ppos != nullptr ? ppos + (long long)b * max_pages + col0 : nullptr;
  walk.page = page;
  walk.hkv = hkv;
  walk.h = h;
  walk.tp = page >= kTok ? 1 : kTok / page;
  walk.spp = page > kTok ? (page + kTok - 1) / kTok : 1;
  walk.n_cols = cols;
  // the table reads of tiles 0 and 1 (and the split's first positions),
  // in flight before the row's position arrives: they need only the split
  int pcol[2], pw[2] = {0, 0}, pb0[2] = {0, 0}, pslot[2] = {0, 0};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    pcol[t] = tid < kTok ? walk.locate(t, tid, pw[t]) : -1;
    if (pcol[t] >= 0) walk.read(pcol[t], pb0[t], pslot[t]);
  }
  const int first_pos = ppos != nullptr && tid < cols ? walk.ppos[tid] : kMasked;
  const int lim = positions[b];

  int n_live;                          // splits that take part in the merge
  if (ppos == nullptr) {
    // positions relative to the split's first column; splits wholly past
    // the row's position exit (split 0 stays, to write an empty row)
    const int live_cols = lim < 0 ? 0 : min(max_pages, lim / page + 1);
    n_live = max(1, (live_cols + pps - 1) / pps);
    if (split >= n_live) return;
    walk.max_lim = lim - col0 * page;
    walk.n_cols = walk.max_lim < 0 ? 0 : min(cols, walk.max_lim / page + 1);
  } else {
    n_live = splits;
    walk.max_lim = lim;
    bool seen = first_pos <= lim;
    for (int c = tid + kThreads; c < cols; c += kThreads) seen |= walk.ppos[c] <= lim;
    walk.n_cols = __syncthreads_or(seen) ? cols : 0;
  }
  const int n_tiles = walk.n_cols == 0 ? 0 : (walk.n_cols + walk.tp - 1) / walk.tp * walk.spp;

  // K/V copies of tile t into ring stage s from meta slot t % 3
  auto issue = [&](int t, int s) {
    issue_tile<D>(meta_row + (t % kMetaSlots) * kTok, ks + s * kTok * LD, vs + s * kTok * LD,
                  kp, vp);
  };

  const int g = lane >> 2, qd = lane & 3;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // prologue: meta of tiles 0 and 1, then Q with tile 0 as one group
    bool live_cur = false, live_next = false;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int row = -1, pos = kMasked;
      if (tid < kTok && t < n_tiles) {
        walk.resolve(pcol[t], pw[t], pb0[t], pslot[t], row, pos);
        meta_row[t * kTok + tid] = row;
        meta_pos[t * kTok + tid] = pos;
      }
      const bool live = __syncthreads_or(row >= 0) != 0;
      (t == 0 ? live_cur : live_next) = live;
    }
    for (int i = tid; i < kRows * CPR; i += kThreads) {
      const int r = i / CPR, e = (i - r * CPR) * 8;
      const long long off = r < group ? (long long)(b * hq + h * group + r) * D + e : 0;
      cp_async16(qs + r * LD + e, q + off, r < group);
    }
    if (live_cur) issue(0, 0);
    cp_async_commit();
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

      // this warp's 16 tokens of the tile (element e of n-tile n: row
      // g + 8 (e / 2), token 8 n + 2 qd + e % 2)
      const int* pos = meta_pos + (j % kMetaSlots) * kTok + warp * 16;
      const int2 pp0 = *reinterpret_cast<const int2*>(pos + 2 * qd);
      const int2 pp1 = *reinterpret_cast<const int2*>(pos + 8 + 2 * qd);
      const bool mine_live = pp0.x != kMasked || pp0.y != kMasked || pp1.x != kMasked ||
                        pp1.y != kMasked;
      if (live_cur && __any_sync(0xffffffffu, mine_live)) {
        const bf16* kt = ks + (s * kTok + warp * 16) * LD;
        const bf16* vt = vs + (s * kTok + warp * 16) * LD;

        // S = Q K^T: 16 rows x 16 tokens
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[4], bk[4];
          ldsm_x4(a, qs + (lane & 15) * LD + kk + (lane >> 4) * 8);
          // (tokens 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
          ldsm_x4(bk, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[0], a, bk[0], bk[1]);
          mma_bf16(sc[1], a, bk[2], bk[3]);
        }

        // scale, mask, online softmax; every row shares the row's limit
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int2 pp = n == 0 ? pp0 : pp1;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = (e & 1) ? pp.y : pp.x;
            const float v = p <= walk.max_lim ? sc[n][e] * scale : kNegInf;
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
        for (int n = 0; n < 2; ++n)
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

        // O += bf16(P) V: P's two C fragments are one 16-token A fragment
        uint32_t a[4];
        a[0] = pack_bf16(sc[0][0], sc[0][1]);
        a[1] = pack_bf16(sc[0][2], sc[0][3]);
        a[2] = pack_bf16(sc[1][0], sc[1][1]);
        a[3] = pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
        for (int dn = 0; dn < OT / 2; ++dn) {
          uint32_t bv[4];   // (tokens 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
          ldsm_x4_trans(bv, vt + (lane & 15) * LD + dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
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

  const long long row0 = (long long)b * hq + h * group;   // first output row
  if (n_live == 1) {
    // the row's only live split: its carry is the answer
    for (int e = tid; e < group * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wc[w * kRows + r] * wo[(w * kRows + r) * D + c];
      if (partials)
        acc_out[row0 * D + e] = a;
      else   // zero-l rows (fully masked) emit exact zeros
        out[row0 * D + e] = __float2bfloat16(a / fmaxf(bl[r], 1e-30f));
    }
    if (partials && tid < group) {
      m_out[row0 + tid] = bm[tid];
      l_out[row0 + tid] = bl[tid];
    }
    return;
  }

  // this split's summary -> scratch; an empty split writes m and l only
  const long long n_sum = (long long)gridDim.x * splits * group;
  float* pa = part;
  float* pm = pa + n_sum * D;
  float* pl = pm + n_sum;
  const long long mine = ((long long)bh * splits + split) * group;
  if (n_tiles > 0) {
    for (int e = tid; e < group * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wc[w * kRows + r] * wo[(w * kRows + r) * D + c];
      pa[mine * D + e] = a;
    }
  }
  if (tid < group) {
    pm[mine + tid] = bm[tid];
    pl[mine + tid] = n_tiles > 0 ? bl[tid] : 0.f;
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

  // the last split of (b, h) to arrive merges them all (reference
  // kernel.py combine_pages): m_max over the non-empty splits, weight
  // exp(m - m_max), l_tot = sum l w, acc_tot = sum acc w.  Every split's
  // m and l, then every split's acc, are read through L2 at once.
  const long long first = (long long)bh * splits * group;
  const int n_ml = n_live * group;
  float* sw = mrg;                                   // [n_live][group] m, then weights
  float* sl = sw + n_ml;                             // [n_live][group] l
  float* tm = sl + n_ml;                             // [group]
  float* tl = tm + group;                            // [group]
  for (int i = tid; i < n_ml; i += kThreads) {
    sw[i] = __ldcg(pm + first + i);
    sl[i] = __ldcg(pl + first + i);
  }
  __syncthreads();
  for (int r = tid; r < group; r += kThreads) {
    float mm = kNegInf;
    for (int i = r; i < n_ml; i += group)
      if (sl[i] > 0.f) mm = fmaxf(mm, sw[i]);
    float lt = 0.f;
    for (int i = r; i < n_ml; i += group) {
      const float w = sl[i] > 0.f ? __expf(sw[i] - mm) : 0.f;
      sw[i] = w;
      lt += sl[i] * w;
    }
    tm[r] = mm;
    tl[r] = lt;
  }
  __syncthreads();
  // float4 columns; an empty split's acc was never written, so its
  // weight 0 selects it out rather than multiplying it
  const int n4 = group * D / 4;
  const float4* pa4 = reinterpret_cast<const float4*>(pa + first * D);
  for (int j = tid; j < n4; j += kThreads) {
    const int r = 4 * j / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp) {
      const float4 x = __ldcg(pa4 + sp * n4 + j);
      const float w = sw[sp * group + r];
      if (w != 0.f) {
        a.x += w * x.x;
        a.y += w * x.y;
        a.z += w * x.z;
        a.w += w * x.w;
      }
    }
    if (partials) {
      *reinterpret_cast<float4*>(acc_out + row0 * D + 4 * j) = a;
    } else {
      const float inv = 1.f / fmaxf(tl[r], 1e-30f);
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + row0 * D + 4 * j);
      o2[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
      o2[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
    }
  }
  if (partials && tid < group) {
    m_out[row0 + tid] = tm[tid];
    l_out[row0 + tid] = tl[tid];
  }
  if (tid == 0) tickets[bh] = 0;       // ready for the next call
}

}  // namespace dec_tc

struct DecodeLaunch {
  const void *q, *kp, *vp, *ks, *vs, *bt, *positions, *ppos;
  void *out, *m_out, *l_out, *part, *tickets;
  int b, hq, hkv, d, page, max_pages, pps, partials;
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
    const size_t smem = smem_bytes(group, d, page);
    auto kern = paged_decode_kernel<TQ, TKV>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(b, hkv), kThreads, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
        static_cast<const TKV*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(positions), static_cast<const int*>(ppos),
        partials ? nullptr : static_cast<TQ*>(out),
        partials ? static_cast<float*>(out) : nullptr, static_cast<float*>(m_out),
        static_cast<float*>(l_out), hq, hkv, d, page, max_pages, partials);
    return cudaGetLastError();
  }

  template <int D>
  cudaError_t launch_tc() const {
    using tc::bf16;
    if (hq / hkv > dec_tc::kRows || pps < 1) return cudaErrorInvalidValue;
    const int splits = (max_pages + pps - 1) / pps;
    const size_t smem = dec_tc::smem_bytes(D, splits);
    auto kern = dec_tc::decode_tc_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(b * hkv, splits), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), static_cast<const int*>(bt),
        static_cast<const int*>(positions), static_cast<const int*>(ppos),
        partials ? nullptr : static_cast<bf16*>(out),
        partials ? static_cast<float*>(out) : nullptr, static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(part), static_cast<int*>(tickets),
        hq, hkv, page, max_pages, pps, partials);
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

// q (b, hq, d); k/v pages (P, page, hkv, d); scales (P, page, hkv) f32 or
// null; block_table/page_positions (b, max_pages) i32 (page_positions may
// be null); positions (b,) i32.  out is (b, hq, d) in q's type, or with
// partials the f32 acc, beside m_out/l_out (b, hq).  The bf16 design
// (bf16 q with bf16 pages) splits the table into pages_per_split columns
// and takes `part`, f32 scratch of (2 + d) * b * hkv * splits * (hq /
// hkv) floats, and `tickets`, b * hkv int32 that are 0 between calls;
// the CUDA-core design ignores all three.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_table, const void* positions,
                                  const void* page_positions, void* out, void* m_out,
                                  void* l_out, void* part, void* tickets, int b, int hq,
                                  int hkv, int d, int page, int max_pages,
                                  int pages_per_split, int q_dtype, int kv_dtype,
                                  int partials, void* stream) {
  const repro::DecodeLaunch launch{q,        k_pages,   v_pages,   k_scale, v_scale,
                                   block_table, positions, page_positions,
                                   out,      m_out,     l_out,     part,    tickets,
                                   b,        hq,        hkv,       d,       page,
                                   max_pages, pages_per_split, partials,
                                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(repro::dispatch_types(q_dtype, kv_dtype, launch));
}
