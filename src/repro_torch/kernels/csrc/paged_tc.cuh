// The tile walk shared by the two bf16 tensor-core paged-attention
// kernels for Hopper (sm_90a): chunk prefill (paged_prefill.cu,
// `tc::prefill_tc_kernel`) and decode (paged_attention.cu,
// `dec_tc::decode_tc_kernel`).  Both read K/V tiles of kTok tokens
// through a batch row's block table into a cp.async ring of bf16 rows
// padded by kPad elements, and resolve each tile's per-token arena rows
// and positions a tile ahead of its copies (a kMetaSlots-slot ring), so
// the table read never stands between a copy and its address.
#pragma once

#include "mma_common.cuh"
#include "paged_common.cuh"

namespace repro {
namespace tc {

using namespace ::repro_mma;
using bf16 = __nv_bfloat16;

constexpr int kTok = 64;         // kv tokens per tile
constexpr int kMetaSlots = 3;    // per-token (row, position) ring, one tile ahead
constexpr int kPad = 8;          // bf16 elements of row padding (16 bytes)
constexpr int kMasked = 0x7fffffff;   // position of a token no row sees

// row stride in shared memory: 16 bytes of padding put each ldmatrix
// phase on 8 distinct 16-byte bank groups
__host__ __device__ constexpr int ld(int d) { return d + kPad; }

// The block's walk over its batch row's table: tiles of kTok tokens,
// `tp` whole page columns each (page <= 64), or `spp` 64-token slices of
// one column (page > 64).  Tokens at positions past max_lim are skipped.
struct Walk {
  const int* bt;      // table row
  const int* ppos;    // page positions row, or nullptr (column j at j * page)
  int page, hkv, h, n_cols, tp, spp, max_lim;

  // page column of tile t's token tt (-1: padding) and its offset w in the page
  __device__ __forceinline__ int locate(int t, int tt, int& w) const {
    int pj;
    if (spp == 1) {
      pj = tt / page;
      w = tt - pj * page;
      if (pj >= tp) return -1;
    } else {
      pj = 0;
      w = (t % spp) * kTok + tt;
      if (w >= page) return -1;
    }
    const int col = (t / spp) * tp + pj;
    return col < n_cols ? col : -1;
  }

  // the token's arena row (-1: skipped) and kv position (kMasked when
  // skipped), from its column's first position b0 and physical page
  __device__ __forceinline__ void resolve(int col, int w, int b0, int slot, int& row,
                                          int& pos) const {
    row = -1;
    pos = kMasked;
    if (col < 0 || b0 > max_lim - w) return;    // b0 + w > max_lim, without overflow
    row = (slot * page + w) * hkv + h;
    pos = b0 + w;
  }

  // both table reads of a column, independent of each other
  __device__ __forceinline__ void read(int col, int& b0, int& slot) const {
    b0 = ppos != nullptr ? ppos[col] : col * page;
    slot = bt[col];
  }

  __device__ __forceinline__ void token(int t, int tt, int& row, int& pos) const {
    int w = 0, b0 = 0, slot = 0;
    const int col = locate(t, tt, w);
    if (col >= 0) read(col, b0, slot);
    resolve(col, w, b0, slot, row, pos);
  }
};

// The block's 16-byte copies of one tile's K and V rows (arena rows
// `rows`, -1 for a skipped token) into a ring stage; a skipped token's
// rows are zero-filled without a read.
template <int D>
__device__ __forceinline__ void issue_tile(const int* rows, bf16* kd, bf16* vd,
                                           const bf16* __restrict__ kp,
                                           const bf16* __restrict__ vp) {
  constexpr int CPR = D / 8;           // 16-byte copies per row
  for (int i = threadIdx.x; i < kTok * CPR; i += kThreads) {
    const int tt = i / CPR, e = (i - tt * CPR) * 8;
    const int row = rows[tt];
    const long long off = (long long)(row >= 0 ? row : 0) * D + e;
    cp_async16(kd + tt * ld(D) + e, kp + off, row >= 0);
    cp_async16(vd + tt * ld(D) + e, vp + off, row >= 0);
  }
}

}  // namespace tc
}  // namespace repro
