// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `paged_decode_attention_pallas`
// (src/repro/kernels/paged_attention/kernel.py): one decode query per
// batch row attends over a (P, page, hkv, d) page arena through a
// (b, max_pages) block table, GQA group per kv head, f32 online softmax,
// mask kv_pos <= positions[b] over per-column page positions, optional
// raw (m, l, acc) partials and int8/fp8 pages with per-token scales.
//
// Grid (b, hkv), 128 threads: one block per (batch row, kv head) holds
// the whole query group and reads every live page of its row once.
// Bound: the live K/V bytes (see paged_common.cuh); the TPU version's
// (8, 128) padding and its sequential "arbitrary" grid axis have no
// counterpart here — the page walk is a loop inside the block.
#include "paged_common.cuh"

namespace repro {

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

struct DecodeLaunch {
  const void *q, *kp, *vp, *ks, *vs, *bt, *positions, *ppos;
  void *out, *m_out, *l_out;
  int b, hq, hkv, d, page, max_pages, partials;
  cudaStream_t stream;

  template <typename TQ, typename TKV>
  cudaError_t operator()() const {
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
};

}  // namespace repro

// q (b, hq, d); k/v pages (P, page, hkv, d); scales (P, page, hkv) f32 or
// null; block_table/page_positions (b, max_pages) i32 (page_positions may
// be null); positions (b,) i32.  out is (b, hq, d) in q's type, or with
// partials the f32 acc, beside m_out/l_out (b, hq).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_table, const void* positions,
                                  const void* page_positions, void* out, void* m_out,
                                  void* l_out, int b, int hq, int hkv, int d, int page,
                                  int max_pages, int q_dtype, int kv_dtype, int partials,
                                  void* stream) {
  const repro::DecodeLaunch launch{q,        k_pages,   v_pages, k_scale, v_scale,
                                   block_table, positions, page_positions,
                                   out,      m_out,     l_out,   b,       hq,
                                   hkv,      d,         page,    max_pages, partials,
                                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(repro::dispatch_types(q_dtype, kv_dtype, launch));
}
