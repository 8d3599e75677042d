"""Near-memory sharded serving: the UniMem page arena cut into one bank
per shard of a `mem` mesh (DESIGN.md §2).

Port of `repro.serve.sharded`.  Each bank holds a static share of the
pool's pages; the host allocator interleaves every sequence's logical
pages over the banks; each bank's paged kernels walk its resident pages
only (partials mode) and only the (b, hq, d)-sized online-softmax
summaries come back to the lead device, merged by the combine kernel.
On a 1-shard mesh the engine bypasses this package: every single-arena
path is unchanged.  `lowered_sharded_hlo` traces one sharded step call
(the reference's compiled-HLO probe; `launch/trace.py`).
"""
from repro_torch.serve.sharded.arena import ShardedPagedKVArena
from repro_torch.launch.mesh import MEM_AXIS
from repro_torch.serve.sharded.serve_step import (make_sharded_serve_fns,
                                                  make_sharded_verify_fn,
                                                  lowered_sharded_hlo)

__all__ = ["ShardedPagedKVArena", "MEM_AXIS", "make_sharded_serve_fns",
           "make_sharded_verify_fn", "lowered_sharded_hlo"]
