// Paged chunk-prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_prefill_attention_pallas`
// (src/repro/kernels/paged_prefill/kernel.py): a ragged (b, c) chunk of
// queries at absolute positions start[b] + ci attends causally over the
// same block-table walk as decode, with mask kv_pos <= start[b] + ci AND
// ci < chunk_len[b]; rows past chunk_len are exact zeros.
//
// Grid (b, hkv, row tiles), 128 threads.  Chunk rows x query group are
// packed densely as in the TPU kernel (packed row r is chunk position
// r / group, group member r % group), and each block takes a tile of up
// to min(64, 4096 / d) packed rows, so every page it loads serves the
// whole tile.  Bound: the live K/V bytes; the walk stops at the page
// holding the tile's largest visible position, which is the causal
// bound of the tile.
#include "paged_common.cuh"

namespace repro {

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

struct PrefillLaunch {
  const void *q, *kp, *vp, *ks, *vs, *bt, *start, *chunk_len, *ppos;
  void *out, *m_out, *l_out;
  int b, c, hq, hkv, d, page, max_pages, rows_per_tile, partials;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  cudaError_t operator()() const {
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
};

}  // namespace repro

// q (b, c, hq, d); k/v pages (P, page, hkv, d); scales (P, page, hkv) f32
// or null; block_table/page_positions (b, max_pages) i32 (page_positions
// may be null); start/chunk_len (b,) i32.  out is (b, c, hq, d) in q's
// type, or with partials the f32 acc, beside m_out/l_out (b, c, hq).
// Returns the CUDA error of the launch (0 on success).
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
