"""Continuous-batching serving engine, paged-native on the UniMem arena,
with the contiguous per-slot layout beside it.

Port of the single-arena paged path and the contiguous path of
`repro.serve.engine`; the scheduling logic is the reference's line for
line, so on the same requests the port makes the same admission,
chunking, preemption and fork decisions and emits the same tokens:

  * pages are allocated LAZILY as sequences grow — admission reserves
    only the first prefill chunk (watermark admission);
  * full prompt pages are SHARED through chained page-content hashes
    (`serve/prefix_store.py`) with copy-on-write on partial last pages:
    between in-flight requests by default, and with `prefix_cache=True`
    also after the donor retired (the persistent cache: idle pages stay
    pinned in the pool and are evicted LRU, leaf first, under pressure);
  * prefill is BATCHED and BUCKETED — one step call per tick advances
    every admitting slot by a ragged chunk whose shared width snaps up
    to a power-of-two bucket;
  * when the pool runs dry, idle cached pages are evicted first, then
    the YOUNGEST slot is preempted back to the queue
    (recompute-on-readmit, already-published tokens replayed);
  * with `host_tier_pages` a host-DRAM tier (`core/unimem.py`
    `HostTier`) sits behind the pool: a preempted slot spills its
    written pages there and readmission restores them instead of
    recomputing; evicted cache pages spill there as cold parcels that a
    later prompt can restore.  The head of the queue's parcel is
    prefetched to the card on a side stream while the tick computes;
  * an optional token budget (`prefill_decode_ratio`) splits each tick
    between prefill and decode;
  * every emitted token is a `TokenEvent`, every retirement a
    `FinishEvent`, through one emission path.

Sampling runs inside the step (`serve/serve_step.py`): the step returns
int32 tokens and reading them is the tick's one synchronisation.

With `speculate_k > 0` the paged engine decodes SPECULATIVELY
(`serve/speculative.py`): a draft model (`draft`: "self:N" or a
registered arch, default the registry's pairing) proposes a k-token
window per slot, the window is appended onto the slot's own page chain
(the shared boundary page copied on write first, tail pages fresh), ONE
batched paged-prefill verify call judges every window, and the matched
prefix plus a bonus token is emitted; the rejected page tail truncates
back off the table.  Acceptance is an exact match against the target's
own counter-keyed draw, so the stream is plain decode's; speculation
only changes how many tokens one tick yields.  Rows that opt out
(`SamplingParams.speculative=False`), replay, or lack room for k+1
positions decode plainly in the same tick.

`layout="contiguous"` keeps one (max_batch, max_seq) cache instead of
the arena: admission reserves a request's whole footprint in the pool
and prefills its prompt in one batch=1 call written straight into its
row, every tick decodes every row, and retirement zeroes the row.  It is
the default for families without a paged path (ssm); `fork` and
speculative decode need the paged layout.

vlm requests carry `num_patches` image rows (`Request.patch_embeds`)
ahead of their tokens: the rows count as prompt positions, hash into the
page contents like tokens (the same text under another image shares no
page), and ride each paged prefill chunk as its patch plane.  A family
without decode (the encoder) raises `ValueError`, as in the reference.

With `tenant_weights` (a tenant -> weight dict, even empty) the tick is
multi-tenant, as in the reference: admission takes the head request of
the tenant with the smallest weighted slot occupancy, and the prefill
chunk lengths, the decode rows and the speculative rows are capped by
each tenant's weighted max-min share of the token budget
(`serve/frontend/tenants.py`).  Contiguous admission stays first in,
first out.

Given a `mesh` (`launch/mesh.py` `make_mem_mesh`) with more than one
shard, the paged arena is SHARDED near-memory style (`serve/sharded/`):
each shard owns a bank of pages on its device, the allocator stripes
every sequence's logical pages over the banks under a per-prompt
ROTATION (a crc32 of its first page, so short prompts spread over the
banks and prefix partners share a bank stride), each bank's walk covers
its resident pages only, and the softmax summaries merge on the lead
device.  Tokens are the single arena's, up to the order of the merge's
sums; the engine keeps talking global page ids.  A 1-shard mesh takes
the single-arena path.  Families with per-slot recurrent state (hybrid)
share prompt pages but never skip their compute, and never spill to the
host tier, as in the reference.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.unimem import (HostParcel, HostTier, SequencePageTable,
                                     UniMemOOM, UniMemPool)
from repro_torch.launch.mesh import MEM_AXIS
from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.kv_cache import PagedKVArena, clear_slot, slot_view
from repro_torch.serve.prefix_store import PrefixStore
from repro_torch.serve.sampling import (SamplingParams, sample_tokens,
                                        state_for_slots)
from repro_torch.serve.serve_step import (init_cache, make_paged_serve_fns,
                                          make_paged_verify_fn,
                                          make_serve_fns)
from repro_torch.serve.speculative import DraftModel
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("engine")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 32           # legacy mirror of sampling.max_new_tokens
    eos_token: int = -1                # -1 = never; folded into sampling.stop
    tenant: str = "default"            # budget-share bucket (frontend/tenants)
    patch_embeds: np.ndarray | None = None   # vlm: (num_patches, frontend_dim)
    sampling: SamplingParams | None = None   # resolved by the engine at submit
    # tokens a preempted slot had already generated: on readmission the
    # engine REPLAYS them as forced context instead of re-sampling
    replay: list[int] | None = None

    @property
    def num_patch_tokens(self) -> int:
        return 0 if self.patch_embeds is None else len(self.patch_embeds)

    @property
    def virtual_len(self) -> int:
        """Prompt positions the cache must hold: image rows + tokens."""
        return self.num_patch_tokens + len(self.prompt)

    @property
    def max_footprint(self) -> int:
        return self.virtual_len + self.max_new_tokens

    def virtual_bytes(self, lo: int, hi: int) -> bytes:
        """Content of virtual positions [lo, hi) for page hashing: the
        image rows' bytes, then the tokens'."""
        p = self.num_patch_tokens
        parts = []
        if lo < p:
            parts.append(self.patch_embeds[lo:min(hi, p)].tobytes())
        if hi > p:
            parts.append(self.prompt[max(lo - p, 0):hi - p].tobytes())
        return b"".join(parts)


@dataclass
class Result:
    uid: int
    tokens: list[int]
    prompt_len: int
    admitted_at: float = 0.0
    finished_at: float = 0.0
    finish_reason: str = "length"      # "length" | "stop" | "cancelled"

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.admitted_at


@dataclass(frozen=True)
class TokenEvent:
    """One generated token, published as it is emitted (exactly once per
    (uid, index); a preempted slot's recompute replays silently)."""
    uid: int
    token: int
    index: int


@dataclass(frozen=True)
class FinishEvent:
    """A request retired; carries the full `Result` and why it stopped."""
    uid: int
    reason: str
    result: Result


@dataclass
class _Slot:
    request: Request
    pages: SequencePageTable
    generated: list[int] = field(default_factory=list)
    last_token: int = 0
    admitted_at: float = 0.0
    order: int = 0                           # admission sequence number
    prefill_pos: int = 0                     # prompt tokens already in pages
    page_hashes: list[int] = field(default_factory=list)
    # prefix-store hashes this slot holds a reference on
    store_refs: set[int] = field(default_factory=set)
    # speculative decode: context tokens the DRAFT cache row has consumed
    # for this slot (-1: never synced for this occupant, so the first
    # sync resets the row)
    draft_pos: int = -1

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.request.virtual_len


def _params_on(tree, device):
    if isinstance(tree, dict):
        return {k: _params_on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_on(v, device) for v in tree]
    return tree.to(device)


class ServingEngine:
    """Continuous-batching engine driven from one device (`device=None`
    means the mesh's first device, else CUDA, and raises without a
    GPU): paged by default, contiguous for families without a paged path
    or on request; with a `mesh` of several shards the paged arena is
    split into one bank per shard, each on its mesh device.

    Chunk widths snap UP to `prefill_buckets` — powers of two from 8 up
    to `prefill_chunk`, plus `prefill_chunk` itself; on the card
    `prefill_chunk` alone, so every prefill GEMM has one shape — and
    `prefill_shapes` records the (batch, width) pairs dispatched.  Rows
    with fewer remaining tokens than the bucket mask their tails, so
    bucketing never changes emitted tokens."""

    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 max_batch: int = 8, max_seq: int = 1024,
                 page_size: int = 16, pool_pages: int | None = None,
                 temperature: float = 0.0, layout: str | None = None,
                 prefill_chunk: int | None = None, mesh=None,
                 high_watermark: float | None = None,
                 prefill_decode_ratio: float | None = None,
                 tick_token_budget: int | None = None,
                 host_tier_pages: int | None = None,
                 prefix_cache: bool = False,
                 speculate_k: int = 0, draft: str | None = None,
                 tenant_weights: dict[str, float] | None = None):
        # a mesh with a >1 "mem" axis shards the arena; a 1-shard mesh is
        # the single-arena path, every code path unchanged
        self.mesh = None
        if (mesh is not None and MEM_AXIS in getattr(mesh, "axis_names", ())
                and mesh.shape[MEM_AXIS] > 1):
            self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.devices[0]
        if registry.get_family(cfg).decode_step is None:
            raise ValueError(f"family {cfg.family!r} cannot serve (no decode)")
        self._patch_frontend = cfg.frontend == "patch"
        if layout is None:
            layout = "paged" if registry.has_paged(cfg) else "contiguous"
        if layout == "paged" and not registry.has_paged(cfg):
            raise ValueError(f"family {cfg.family!r} has no paged path")
        if layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown layout {layout!r}")
        self.layout = layout
        if layout != "paged":
            self.mesh = None            # only the arena shards
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _params_on(params, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_size = page_size
        # fraction of pool pages above which the engine proactively
        # preempts youngest slots (None = preempt only on hard OOM)
        self.high_watermark = high_watermark
        # the default temperature of a request submitted without
        # SamplingParams (the legacy constructor knob)
        self.default_temperature = temperature
        # per-tenant weighted max-min budget shares: a tenant -> weight
        # dict (even {}; unnamed tenants weigh 1.0) makes admission
        # order, prefill chunk caps and decode row caps follow the
        # weighted shares inside the tick.  Shares need a budget to
        # divide, so the prefill/decode ratio defaults on
        self.tenants = None
        self.tenant_tokens: dict[str, int] = {}
        if tenant_weights is not None:
            from repro_torch.serve.frontend.tenants import TenantScheduler
            self.tenants = TenantScheduler(tenant_weights)
            if prefill_decode_ratio is None:
                prefill_decode_ratio = 0.5
        pool_pages = pool_pages or (max_batch * max_seq) // page_size
        self.max_pages = -(-max_seq // page_size)     # block-table width
        self.prefill_chunk = prefill_chunk or max(page_size * 4, 32)
        if prefill_decode_ratio is not None \
                and not 0.0 <= prefill_decode_ratio <= 1.0:
            raise ValueError(
                f"prefill_decode_ratio must be in [0, 1], got "
                f"{prefill_decode_ratio}")
        self.prefill_decode_ratio = prefill_decode_ratio
        self.tick_token_budget = (tick_token_budget
                                  or max_batch * self.prefill_chunk)
        self.prefill_buckets = sorted(
            {1 << b for b in range(3, self.prefill_chunk.bit_length())
             if (1 << b) < self.prefill_chunk} | {self.prefill_chunk})
        if self.device.type == "cuda":
            # one chunk width on the card: cuBLAS picks a GEMM by its
            # shape, so under several widths a row's bits would follow
            # its batch-mates' chunk width, and a stream would depend on
            # what it was batched and chunked with
            self.prefill_buckets = [self.prefill_chunk]
        self.prefill_shapes: set[tuple[int, int]] = set()

        if layout == "paged" and self.mesh is not None:
            from repro_torch.serve.sharded import (ShardedPagedKVArena,
                                                   make_sharded_serve_fns)
            n = self.mesh.shape[MEM_AXIS]
            pool_pages = -(-pool_pages // n) * n     # round UP: never shrink
            self.arena = ShardedPagedKVArena(cfg, num_pages=pool_pages,
                                             page_size=page_size,
                                             device=self.device,
                                             max_batch=max_batch,
                                             mesh=self.mesh)
            self.prefill_fn, self.decode_fn = make_sharded_serve_fns(
                cfg, self.mesh, pool_pages, device=self.device)
        elif layout == "paged":
            self.arena = PagedKVArena(cfg, num_pages=pool_pages,
                                      page_size=page_size,
                                      device=self.device,
                                      max_batch=max_batch)
            self.prefill_fn, self.decode_fn = make_paged_serve_fns(
                cfg, self.device)
        if layout == "paged":
            # families with contiguous per-slot state (hybrid conv/SSM)
            # can share page MEMORY but never skip prefill COMPUTE: the
            # skipped tokens' state would not exist for the new slot
            self._slot_state = self.arena.state_bytes > 0
            self.pool = self.arena.pool
            self.cache = None
            # host-DRAM cold tier: preempted slots spill their written
            # pages here instead of recomputing on readmission (families
            # with per-slot recurrent state keep the replay path)
            self.host_tier = (HostTier(host_tier_pages)
                              if host_tier_pages else None)
            # refcounted prompt-page cache keyed by chained content
            # hashes; persistent=True keeps entries at refcount 0, pinned
            # in the pool and reclaimed by LRU eviction under the
            # watermark/OOM shed paths; persistent=False (default) is
            # the donor-lifetime sharing, through the same store
            self.prefix_store = PrefixStore(
                self.pool, persistent=prefix_cache, arena=self.arena,
                host_tier=self.host_tier)
            # uid -> (parcel, device copy of its pages, copy-done event):
            # the head-of-queue prefetch in step()
            self._prefetched: dict[int, tuple] = {}
        else:
            # pages only count the reservations; the K/V (or conv/SSM
            # state) lives in one (max_batch, max_seq) cache
            self.arena = None
            self.prefix_store = None
            self.host_tier = None
            self._prefetched = {}
            self._slot_state = False
            self.cache = init_cache(cfg, max_batch, max_seq,
                                    device=self.device)
            self.cache_ax = registry.get_family(cfg).cache_axes()
            self.pool = UniMemPool(pool_pages, page_size)
            self.prefill_fn, self.decode_fn, _ = make_serve_fns(
                cfg, self.device)

        # speculative decode: a draft proposes `speculate_k`-token windows
        # and ONE batched paged-prefill verify call judges them.
        # Rewindable drafts run propose, verify and the rewind as one
        # call (`fused_fn`); state drafts, and every draft on a mesh (the
        # sharded verify), propose, verify, then roll back
        self.speculate_k = int(speculate_k or 0)
        self.draft = None
        self.verify_fn = None
        self.fused_fn = None
        self.spec_stats = dict(windows=0, draft_tokens=0, verify_calls=0,
                               accepted_tokens=0, emitted_tokens=0)
        if self.speculate_k > 0:
            if layout != "paged":
                raise ValueError("speculative decode requires the paged "
                                 "layout")
            if not registry.has_verify(cfg):
                raise ValueError(f"family {cfg.family!r} cannot be a "
                                 f"speculative-decode target")
            self.draft = DraftModel(cfg, self.params, draft,
                                    max_batch=max_batch, max_seq=max_seq,
                                    device=self.device)
            if self.mesh is not None:
                from repro_torch.serve.sharded import make_sharded_verify_fn
                self.verify_fn = make_sharded_verify_fn(
                    cfg, self.mesh, self.pool.num_pages, device=self.device)
            else:
                self.fused_fn = self.draft.fused_fn(self.speculate_k)
                if self.fused_fn is None:
                    self.verify_fn = make_paged_verify_fn(cfg, self.device)

        self.pending: list[Request] = []
        self.slots: dict[int, _Slot] = {}        # slot index -> state
        self.results: list[Result] = []
        self.steps = 0
        self.tokens_out = 0
        self.prefill_tokens = 0          # prompt tokens actually computed
        self.prefill_calls = 0           # step calls; each launches its
        self.decode_calls = 0            # attention kernel once per layer
        self.preemptions = 0
        self.cancellations = 0
        self._admitted = 0
        self._events: deque = deque()
        self._emitted: dict[int, int] = {}       # uid -> tokens published

    # ------------------------------------------------------------ intake

    def _resolve_sampling(self, request: Request) -> None:
        """Fill in `request.sampling` from the legacy fields and keep
        their mirrors coherent — the engine reads `sampling` only.  An
        `eos_token` joins the stop set, a request without params takes
        the engine's default temperature, and a non-default legacy
        `max_new_tokens` overrides a params-default budget."""
        sp = request.sampling
        if sp is None:
            stop = (request.eos_token,) if request.eos_token >= 0 else ()
            sp = SamplingParams(temperature=self.default_temperature,
                                max_new_tokens=request.max_new_tokens,
                                stop=stop)
        else:
            if request.eos_token >= 0 and request.eos_token not in sp.stop:
                sp = replace(sp, stop=sp.stop + (request.eos_token,))
            default_budget = SamplingParams().max_new_tokens
            if (request.max_new_tokens != default_budget
                    and sp.max_new_tokens == default_budget):
                sp = replace(sp, max_new_tokens=request.max_new_tokens)
        request.sampling = sp.validate()
        request.max_new_tokens = sp.max_new_tokens

    def submit(self, request: Request):
        self._resolve_sampling(request)
        if request.max_footprint > self.max_seq:
            raise ValueError(
                f"request {request.uid}: footprint {request.max_footprint} "
                f"> max_seq {self.max_seq}")
        if self._patch_frontend and (request.num_patch_tokens
                                     != self.cfg.num_patches):
            raise ValueError(
                f"request {request.uid}: {self.cfg.family} requests need "
                f"patch_embeds with {self.cfg.num_patches} rows, got "
                f"{request.num_patch_tokens}")
        self.pending.append(request)

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if i not in self.slots]

    # ---------------------------------------------------- event emission

    def _emit(self, s: _Slot, tok: int) -> None:
        """THE single token-emission path: appends to the slot, counts,
        and publishes a TokenEvent exactly once per (uid, index)."""
        s.generated.append(tok)
        s.last_token = tok
        self.tokens_out += 1
        t = s.request.tenant
        self.tenant_tokens[t] = self.tenant_tokens.get(t, 0) + 1
        idx = len(s.generated) - 1
        uid = s.request.uid
        if idx >= self._emitted.get(uid, 0):
            self._emitted[uid] = idx + 1
            self._events.append(TokenEvent(uid=uid, token=tok, index=idx))

    def _next_token(self, s: _Slot, sampled: int) -> int:
        """The step's sampled token, unless the slot is REPLAYING tokens
        it had generated before a preemption."""
        rep = s.request.replay
        if rep is not None:
            t = len(s.generated)
            if t < len(rep):
                return rep[t]
            s.request.replay = None              # replay complete
        return sampled

    def events(self) -> list:
        """Drain pending TokenEvent/FinishEvent records (FIFO)."""
        out = list(self._events)
        self._events.clear()
        return out

    def _sampling_state(self, rows: dict[int, _Slot]):
        """Per-slot SamplingState; the emission counter is the number of
        tokens generated so far."""
        return state_for_slots(
            self.max_batch,
            [(i, s.request.sampling, len(s.generated))
             for i, s in rows.items()])

    # ------------------------------------------------- prefix page cache

    def _page_hashes(self, req: Request) -> list[int]:
        """Chained content hashes of the prompt's FULL pages."""
        ps = self.page_size
        out, h = [], 0
        for i in range(req.virtual_len // ps):
            h = hash((h, req.virtual_bytes(i * ps, (i + 1) * ps)))
            out.append(h)
        return out

    def _rotation_of(self, req: Request) -> int:
        """Per-prompt bank rotation (sharded pools only): a STABLE hash
        of the first (full, if present) page's content offsets the
        sequence's logical -> bank stride, so page 0 of many short
        prompts spreads over the banks instead of piling onto bank 0.
        Content-derived, so prefix partners (same first page) rotate
        alike; crc32 (not Python's salted `hash`) keeps placement
        reproducible across processes, and equal to the reference's."""
        n = getattr(self.pool, "num_shards", 1)
        if n <= 1:
            return 0
        head = req.virtual_bytes(0, min(self.page_size, req.virtual_len))
        return zlib.crc32(head) % n

    def _match_prefix(self, req: Request):
        """Longest run of shareable full pages for this prompt, capped so
        at least one prompt position is always re-prefilled.  Returns
        (written, adopted, hashes, rot_hint, store_hashes): `written`
        pages hold published K/V the new sequence skips; `adopted` pages
        are being written by a co-prefilling slot with identical content,
        or (for per-slot-state families) are published pages it must
        still recompute through.  Store matches may come from retired
        donors (persistent cache), and even from cold host-tier parcels
        restored on the spot; `rot_hint` is the donor's bank rotation the
        follower must adopt (None without a store match), and
        `store_hashes` names the matched entries the admitting slot must
        acquire references on."""
        hashes = self._page_hashes(req)
        limit = (req.virtual_len - 1) // self.page_size
        written, adopted, store_hashes = [], [], []
        rot_hint = None
        store = self.prefix_store
        for i, h in enumerate(hashes[:limit]):
            page = store.page_of(h)
            if page is None and not adopted and not self._slot_state:
                # device miss: a cold copy may still sit in the host tier
                page = store.restore_cold(h, i)
            if page is not None:
                if rot_hint is None:
                    rot_hint = store.rotation_of(h)
                store_hashes.append(h)
                if not adopted and not self._slot_state:
                    written.append(page)
                else:                      # keep the run contiguous
                    adopted.append(page)
                continue
            page = next((s.pages.pages[i] for s in self.slots.values()
                         if s.prefilling and i < len(s.page_hashes)
                         and s.page_hashes[i] == h
                         and i < len(s.pages.pages)), None)
            if page is None:
                break
            adopted.append(page)
        return written, adopted, hashes, rot_hint, store_hashes

    def _register_prefix(self, slot: _Slot):
        """Publish the slot's fully WRITTEN prompt pages for sharing,
        each linked to its parent page's hash.  The store takes its own
        pool reference per entry and the slot acquires one for itself."""
        store = self.prefix_store
        full = min(slot.request.virtual_len, slot.prefill_pos) // self.page_size
        for i, h in enumerate(slot.page_hashes[:full]):
            if i >= len(slot.pages.pages):
                break
            mine = slot.pages.pages[i]
            page = store.page_of(h)
            if page is None:
                parent = slot.page_hashes[i - 1] if i else None
                page = store.register(h, mine, parent=parent, index=i,
                                      rotation=slot.pages.rotation)
            if page == mine and h not in slot.store_refs:
                store.acquire(h)
                slot.store_refs.add(h)

    def _absorb_shared(self, s: _Slot):
        """Late-binding prefix sharing: adopt pages another slot has
        published since this one was admitted, skipping their chunks
        (page-aligned prefill positions only).  Never for per-slot-state
        families: skipping tokens would leave the slot's conv/SSM state
        behind its page contents."""
        if self._slot_state:
            return
        ps = self.page_size
        store = self.prefix_store
        limit = (s.request.virtual_len - 1) // ps
        while s.prefill_pos % ps == 0:
            i = s.prefill_pos // ps
            if i >= limit or i >= len(s.page_hashes) \
                    or i >= len(s.pages.pages):
                break
            h = s.page_hashes[i]
            page = store.page_of(h)
            if page is None:
                break
            if page == s.pages.pages[i]:
                # co-prefill adoption: the donor has now fully written
                # the page we already hold
                if h not in s.store_refs:
                    store.acquire(h, reuse=True)
                    s.store_refs.add(h)
                s.prefill_pos += ps
                continue
            self.pool.share([page])
            self.pool.free([s.pages.pages[i]])   # ours was never written
            s.pages.pages[i] = page
            store.acquire(h, reuse=True)
            s.store_refs.add(h)
            s.prefill_pos += ps

    def _drop_store_refs(self, s: _Slot) -> None:
        """The slot's table is going away: release its store references
        (persistent entries stay, pinned idle at refcount 0)."""
        for h in s.store_refs:
            self.prefix_store.release(h)
        s.store_refs.clear()

    # ---------------------------------------------------- cache reclaim

    def _reclaim_idle(self, need: int = 1, start: int | None = None,
                      protect: set[int] | None = None) -> int:
        """LRU-evict idle (refcount-0) cached pages to make room: the
        watermark and OOM paths try this BEFORE preempting live slots,
        because a dropped cache page costs a future prefill while a
        preemption costs one now.  `start` aims the eviction at the
        banks a strided alloc at that logical index would demand
        (sharded pools); a pool-wide pass backstops it.  Returns pages
        actually freed."""
        store = self.prefix_store
        if store is None or not len(store):
            return 0
        shards = None
        n = getattr(self.pool, "num_shards", 1)
        if start is not None and n > 1:
            shards = {(start + k) % n for k in range(min(need, n))}
        freed = store.evict(need, shards=shards, protect=protect)
        if freed < need and shards is not None:
            freed += store.evict(need - freed, protect=protect)
        return freed

    def _fits_or_reclaim(self, start: int, need: int,
                         protect: set[int] | None = None) -> bool:
        """`pool.fits`, with idle cache pages counted as reclaimable
        headroom: evict and retry until the alloc fits or the idle set is
        dry (entries in `protect`, just matched, are never victims)."""
        while not self.pool.fits(start, need):
            if not self._reclaim_idle(need, start, protect=protect):
                return False
        return True

    # ------------------------------------------------------------- admit

    def _next_admission(self) -> int:
        """Index into `pending` of the next admission candidate.  First
        in, first out without tenant scheduling; with it, the head
        request of the tenant with the smallest weighted slot occupancy
        (max-min over held slots).  First in, first out within a tenant
        (a preempted request, at the queue front, keeps its priority)
        and across equal occupancies."""
        if self.tenants is None or len(self.pending) <= 1:
            return 0
        held: dict[str, int] = {}
        for s in self.slots.values():
            t = s.request.tenant
            held[t] = held.get(t, 0) + 1
        best, best_key = 0, None
        seen: set[str] = set()
        for j, r in enumerate(self.pending):
            if r.tenant in seen:
                continue
            seen.add(r.tenant)
            key = held.get(r.tenant, 0) / self.tenants.weight_of(r.tenant)
            if best_key is None or key < best_key:
                best, best_key = j, key
        return best

    def _admit_paged(self):
        """Watermark admission: a request enters as soon as the pool can
        hold its FIRST prefill chunk; the rest of the prompt's pages are
        allocated lazily, chunk by chunk, with preemption as the
        backpressure.  Shared prefix pages cost nothing extra."""
        free = self._free_slots()
        while free and self.pending:
            pidx = self._next_admission()
            req = self.pending[pidx]
            if self.host_tier is not None and req.uid in self.host_tier:
                verdict = self._restore_from_tier(req, free, pidx)
                if verdict == "restored":
                    continue
                if verdict == "wait":
                    break               # the pool must drain first
                # "recompute": the parcel was dropped; normal admission
                # (the replay pinned at preemption still replays the
                # published tokens)
            plen = req.virtual_len
            written, adopted, hashes, rot_hint, store_hashes = \
                self._match_prefix(req)
            # a store hit binds the follower to the DONOR's rotation: the
            # cached pages live in the donor's banks, and the walk
            # recovers the rotation from the table's first column
            rot = rot_hint if rot_hint is not None else self._rotation_of(req)
            shared_tokens = len(written) * self.page_size
            held = shared_tokens + len(adopted) * self.page_size
            first = min(self.prefill_chunk, plen - held)
            need = (self.pool.pages_for(held + first)
                    - len(written) - len(adopted))
            if not self._fits_or_reclaim(rot + len(written) + len(adopted),
                                         need, protect=set(store_hashes)):
                break                            # UniMem backpressure
            self.pending.pop(pidx)
            slot = free.pop(0)
            if written or adopted:
                self.pool.share(written + adopted)
            for h in store_hashes:
                self.prefix_store.acquire(h, reuse=True)
            seq = SequencePageTable(self.pool, written + adopted, held,
                                    rotation=rot)
            seq.append_tokens(first)
            s = _Slot(request=req, pages=seq, admitted_at=time.perf_counter(),
                      order=self._admitted, prefill_pos=shared_tokens,
                      page_hashes=hashes,
                      store_refs=set(store_hashes))
            self._admitted += 1
            self.slots[slot] = s
            self._register_prefix(s)    # shared pages are already written

    def _admit_contiguous(self):
        """Admission reserves the request's whole footprint, then ONE
        batch=1 prefill of its prompt writes its cache row in place (the
        row is zeroed first, so it equals the reference's fresh batch=1
        cache inserted at the slot) and its first token is sampled on
        the device."""
        free = self._free_slots()
        while free and self.pending:
            req = self.pending[0]
            if not self.pool.can_admit(req.max_footprint):
                break                            # UniMem backpressure
            self.pending.pop(0)
            slot = free.pop(0)
            pages = SequencePageTable(self.pool)
            pages.append_tokens(req.max_footprint)
            clear_slot(self.cache, slot, self.cache_ax)
            batch = {"tokens": req.prompt[None, :]}
            if req.patch_embeds is not None:
                batch["patch_embeds"] = np.asarray(req.patch_embeds,
                                                   np.float32)[None]
            _, logits = self.prefill_fn(
                self.params, batch,
                slot_view(self.cache, slot, self.cache_ax))
            self.prefill_calls += 1
            self.prefill_tokens += req.virtual_len
            s = _Slot(request=req, pages=pages,
                      admitted_at=time.perf_counter(), order=self._admitted,
                      prefill_pos=req.virtual_len)
            # the first token samples on the device (emission counter 0)
            first = sample_tokens(logits,
                                  state_for_slots(1, [(0, req.sampling, 0)]))
            self._emit(s, int(first.cpu()[0]))
            self.slots[slot] = s
            self._admitted += 1

    # ----------------------------------------------------------- prefill

    def _bucket_width(self, n: int) -> int:
        """Smallest fixed bucket >= n (n <= prefill_chunk by construction)."""
        return next(b for b in self.prefill_buckets if b >= n)

    def _prefill_token_budget(self) -> int | None:
        """This tick's prompt-token allowance (None = unlimited).  An idle
        decode share rolls over to prefill so a ratio of 0 cannot
        deadlock admission."""
        if self.prefill_decode_ratio is None:
            return None
        budget = int(self.prefill_decode_ratio * self.tick_token_budget)
        decoding = any(not s.prefilling and s.generated
                       for s in self.slots.values())
        if budget < 1 and not decoding:
            budget = self.prefill_chunk
        return budget

    def _decode_slot_budget(self) -> int | None:
        """Max slots decoded this tick (None = all active); at least one."""
        if self.prefill_decode_ratio is None:
            return None
        b = self.tick_token_budget
        return max(1, b - int(self.prefill_decode_ratio * b))

    def _prefill_tick(self):
        """Advance EVERY prefilling slot by one ragged chunk in a SINGLE
        step call.  Row i of the (max_batch, c) chunk belongs to slot i;
        rows that are decoding or empty are inert (chunk_len 0, null
        block tables).  Under a token budget the chunk lengths are capped
        oldest-first by the prefill share of `tick_token_budget`."""
        pre = [(i, s) for i, s in self.slots.items() if s.prefilling]
        for _, s in pre:
            self._absorb_shared(s)
        pre = [(i, s) for i, s in pre if s.prefilling]
        if not pre:
            return
        lens = {i: min(self.prefill_chunk,
                       s.request.virtual_len - s.prefill_pos)
                for i, s in pre}
        budget = self._prefill_token_budget()
        if budget is not None:
            caps = None
            if self.tenants is not None:
                # weighted max-min shares of the prefill budget over the
                # tenants with prefilling slots; chunk lengths then cap
                # oldest-first WITHIN each tenant's share
                demands: dict[str, int] = {}
                for i, s in pre:
                    t = s.request.tenant
                    demands[t] = demands.get(t, 0) + lens[i]
                caps = self.tenants.allocate(budget, demands,
                                             kind="prefill")
            for i, s in sorted(pre, key=lambda kv: kv[1].order):
                if caps is None:
                    lens[i] = min(lens[i], max(budget, 0))
                    budget -= lens[i]
                else:
                    t = s.request.tenant
                    lens[i] = min(lens[i], max(caps.get(t, 0), 0))
                    caps[t] = caps.get(t, 0) - lens[i]
            pre = [(i, s) for i, s in pre if lens[i] > 0]
            if not pre:
                return
        # lazy prompt-page growth: extend each table to cover this tick's
        # chunk, preempting younger slots under pool pressure — a slot
        # preempted here sits out the tick
        for i, s in pre:
            if self.slots.get(i) is not s:
                continue                         # preempted this tick
            grow = s.prefill_pos + lens[i] - s.pages.num_tokens
            if grow > 0:
                self._with_preemption(
                    s, lambda s=s, g=grow: s.pages.append_tokens(g))
        pre = [(i, s) for i, s in pre if self.slots.get(i) is s]
        if not pre:
            return
        lens = {i: lens[i] for i, _ in pre}
        b, c = self.max_batch, self._bucket_width(max(lens.values()))
        tokens = np.zeros((b, c), np.int32)
        start = np.zeros((b,), np.int32)
        clen = np.zeros((b,), np.int32)
        bt = np.full((b, self.max_pages), self.arena.null_page, np.int32)
        # vlm: the chunk's (b, c, frontend_dim) patch plane beside its
        # tokens; a row's positions below its patch count read the plane
        patches = (np.zeros((b, c, self.cfg.frontend_dim), np.float32)
                   if self._patch_frontend else None)
        for i, s in pre:
            req, n, pos = s.request, lens[i], s.prefill_pos
            p = req.num_patch_tokens
            lo = max(pos, p)                 # first text position in chunk
            if lo < pos + n:
                tokens[i, lo - pos:n] = req.prompt[lo - p:pos + n - p]
            if patches is not None and pos < p:
                hi = min(pos + n, p)
                patches[i, :hi - pos] = req.patch_embeds[pos:hi]
            start[i] = pos
            clen[i] = n
            bt[i, :len(s.pages.pages)] = s.pages.pages
        chunk = {"tokens": tokens}
        if patches is not None:
            chunk["patches"] = patches
        self.arena.kv, first = self.prefill_fn(
            self.params, chunk, self.arena.kv, bt, start, clen,
            self._sampling_state(dict(pre)))
        self.prefill_calls += 1
        self.prefill_shapes.add((b, c))
        self.prefill_tokens += int(clen.sum())
        first = first.cpu().numpy()              # the tick's one sync
        for i, s in pre:
            s.prefill_pos += int(clen[i])
            self._register_prefix(s)             # newly-written full pages
            if not s.prefilling:                 # prompt complete: the
                                                 # step sampled token 0
                self._emit(s, self._next_token(s, int(first[i])))

    # ------------------------------------------------------------- step

    def _with_preemption(self, s: _Slot, fn) -> bool:
        """Run one ATOMIC allocator step under the age-priority
        discipline: a slot may evict only YOUNGER slots; with no younger
        victim left it preempts ITSELF back to the queue (returns False).
        A lone slot that still cannot fit surfaces the OOM."""
        while True:
            try:
                fn()
                return True
            except UniMemOOM:
                # idle cached prefixes go first: reclaiming them costs a
                # future prefill, preempting a live slot costs one now
                if self._reclaim_idle():
                    continue
                if self._preempt_youngest(but=s):
                    continue
                if len(self.slots) > 1:          # yield to the elders
                    idx = next(i for i, sl in self.slots.items() if sl is s)
                    self._preempt_slot(idx, s)
                    return False
                raise

    def _grow_for_write(self, s: _Slot) -> None:
        """Lazy page growth + COW before this step's token write, each
        retried separately under pool pressure."""
        if not self._with_preemption(s, lambda: s.pages.append_tokens(1)):
            return                               # slot yielded its pages
        self._with_preemption(s, lambda: self.arena.cow_for_write(s.pages))

    def _preempt_slot(self, idx: int, victim: _Slot) -> None:
        """Kick one slot back to the queue front (recompute-on-readmit)
        and reclaim its pages."""
        log.info("engine: preempting uid=%d (pool pressure)",
                 victim.request.uid)
        self.preemptions += 1
        if len(victim.generated) > len(victim.request.replay or ()):
            victim.request.replay = list(victim.generated)
        self._spill_slot(victim)                 # host tier, if enabled
        self._drop_store_refs(victim)
        victim.pages.release()
        del self.slots[idx]
        self.pending.insert(0, victim.request)

    def _preempt_youngest(self, but: _Slot) -> bool:
        """Preempt the most recently admitted slot YOUNGER than `but`."""
        victims = [(i, s) for i, s in self.slots.items()
                   if s is not but and s.order > but.order]
        if not victims:
            return False
        idx, victim = max(victims, key=lambda kv: kv[1].order)
        self._preempt_slot(idx, victim)
        return True

    # --------------------------------------------------------- host tier

    def _spill_slot(self, victim: _Slot) -> None:
        """Copy the victim's WRITTEN KV pages to the host-DRAM tier so
        readmission restores them instead of recomputing.  Families with
        per-slot recurrent state (hybrid conv/SSM) never spill: their
        state rows cannot be rebuilt in another slot."""
        tier = self.host_tier
        if tier is None or self._slot_state:
            return
        if victim.prefilling:
            valid = victim.prefill_pos
        elif victim.generated:
            # the LAST generated token's KV is written next decode tick
            valid = victim.request.virtual_len + len(victim.generated) - 1
        else:
            valid = 0
        if valid <= 0:
            return
        npages = self.pool.pages_for(valid)
        pages = victim.pages.pages[:npages]
        if len(pages) < npages:
            return
        data = self.arena.read_pages(pages)
        meta = dict(tokens=valid, prefill_pos=victim.prefill_pos,
                    rotation=victim.pages.rotation,
                    generated=list(victim.generated),
                    last_token=victim.last_token,
                    page_hashes=list(victim.page_hashes))
        self._prefetched.pop(victim.request.uid, None)   # stale copy
        tier.put(HostParcel(uid=victim.request.uid, num_pages=npages,
                            data=data, meta=meta))

    def _restore_from_tier(self, req: Request, free: list[int],
                           pidx: int = 0) -> str:
        """Readmission fast path: rebuild the slot from its spilled
        parcel (fresh pages on the SAME rotation, so in the same banks,
        their contents written back from the
        prefetched device copy when the prefetch got to it, generation
        state resumed exactly).  Returns "restored", "wait" (the pool
        must drain first) or "recompute" (the parcel is unusable and
        dropped; the caller falls through to normal admission)."""
        tier = self.host_tier
        parcel = tier.peek(req.uid)
        rot = parcel.meta["rotation"]
        npages = parcel.num_pages
        # thrash guard: restoring straight past the shedder's limit would
        # preempt (and re-spill) somebody next tick.  Pinned idle cache
        # pages do not count: they are evicted, not preempted, on demand
        if self.high_watermark is not None and self.slots:
            limit = int(self.high_watermark * self.pool.num_pages)
            hot = (self.pool.num_pages - self.pool.free_pages
                   - self.pool.pinned_pages)
            if hot + npages > limit:
                return "wait"
        if not self._fits_or_reclaim(rot, npages):
            if self.slots:
                return "wait"
            tier.take(req.uid)          # pool genuinely too small
            self._prefetched.pop(req.uid, None)
            return "recompute"
        tier.take(req.uid)
        tier.restores += 1
        tier.restored_pages += npages
        pre = self._prefetched.pop(req.uid, None)
        self.pending.pop(pidx)
        slot = free.pop(0)
        seq = SequencePageTable(self.pool, rotation=rot)  # the same banks
        seq.append_tokens(parcel.meta["tokens"])
        if pre is not None and pre[0] is parcel:
            # the compute stream waits for the side-stream copy; dropping
            # the parcel's pinned tensors after this is safe, because the
            # caching host allocator holds a block an asynchronous copy
            # reads until that copy is done
            self.arena.write_pages(seq.pages, pre[1], ready=pre[2])
        else:
            self.arena.write_pages(seq.pages, parcel.data)
        s = _Slot(request=req, pages=seq,
                  generated=list(parcel.meta["generated"]),
                  last_token=parcel.meta["last_token"],
                  admitted_at=time.perf_counter(), order=self._admitted,
                  prefill_pos=parcel.meta["prefill_pos"],
                  page_hashes=list(parcel.meta["page_hashes"]))
        self._admitted += 1
        # KV restored byte for byte: published history needs no replay
        req.replay = None
        self.slots[slot] = s
        self._register_prefix(s)
        log.info("engine: restored uid=%d from host tier (%d pages)",
                 req.uid, npages)
        return "restored"

    def _tier_prefetch(self) -> None:
        """Start moving the head-of-queue request's parcel back to the
        device while this tick's compute runs (a side-stream copy on the
        card, `PagedKVArena.prefetch`)."""
        tier = self.host_tier
        if tier is None or not self.pending:
            return
        uid = self.pending[self._next_admission()].uid
        if uid in self._prefetched:
            return
        parcel = tier.peek(uid)
        if parcel is None:
            return
        self._prefetched[uid] = (parcel, *self.arena.prefetch(parcel.data))
        tier.prefetches += 1

    def _decode_rows(self) -> dict[int, _Slot]:
        """Active decode rows for this tick, throttled oldest-first by
        the decode share of the token budget (when a ratio is set)."""
        active = {i: s for i, s in self.slots.items() if not s.prefilling
                  and s.generated}
        # the contiguous step writes K/V and advances pos for EVERY row,
        # so excluding a row there would corrupt its cache: no budget
        budget = (self._decode_slot_budget() if self.layout == "paged"
                  else None)
        if budget is None:
            return active
        if self.tenants is not None:
            # per-tenant row shares of the decode budget (max-min,
            # weighted); rows keep oldest-first WITHIN their tenant.
            # budget >= 1 leaves some tenant a positive cap, so decode
            # always progresses
            demands: dict[str, int] = {}
            for s in active.values():
                t = s.request.tenant
                demands[t] = demands.get(t, 0) + 1
            caps = self.tenants.allocate(budget, demands, kind="decode")
            keep: dict[int, _Slot] = {}
            for i, s in sorted(active.items(), key=lambda kv: kv[1].order):
                t = s.request.tenant
                if caps.get(t, 0) > 0:
                    keep[i] = s
                    caps[t] -= 1
            return keep
        if len(active) <= budget:
            return active
        keep = sorted(active.items(), key=lambda kv: kv[1].order)[:budget]
        return dict(keep)

    def _decode_plain(self, active: dict[int, _Slot]):
        if not active:
            return
        # grow tables first (may preempt younger slots under pool pressure)
        for i, s in list(active.items()):
            if self.slots.get(i) is not s:
                continue                         # already preempted this step
            self._grow_for_write(s)
        active = {i: s for i, s in active.items() if self.slots.get(i) is s}
        if not active:
            return
        tokens = np.zeros((self.max_batch,), np.int32)
        positions = np.zeros((self.max_batch,), np.int32)
        bt = np.full((self.max_batch, self.max_pages), self.arena.null_page,
                     np.int32)
        for i, s in active.items():
            tokens[i] = s.last_token
            positions[i] = s.pages.num_tokens - 1   # slot appended above
            bt[i, :len(s.pages.pages)] = s.pages.pages
        self.arena.kv, nxt = self.decode_fn(
            self.params, self.arena.kv, bt, positions, tokens,
            self._sampling_state(active))
        self._emit_decoded(active, nxt)

    def _decode_paged(self):
        if self.draft is None:
            self._decode_plain(self._decode_rows())
            return
        spec, plain = self._partition_decode()
        self._decode_plain(plain)
        self._speculate(spec)

    # ------------------------------------------------- speculative decode

    def _partition_decode(self) -> tuple[dict[int, _Slot], dict[int, _Slot]]:
        """Split this tick's decode rows between the speculative window
        and plain one-token decode.  A row speculates when its request
        opted in (`SamplingParams.speculative`), it is not replaying
        pinned history, and its table has room for the k+1 candidate
        writes.  Under a token budget a speculating row charges k+1
        tokens against the decode share (its verify writes k+1
        positions), oldest first; the oldest row always runs."""
        k = self.speculate_k
        active = {i: s for i, s in self.slots.items()
                  if not s.prefilling and s.generated}
        budget = self._decode_slot_budget()
        rows = sorted(active.items(), key=lambda kv: kv[1].order)
        wants_map = {i: (s.request.sampling.speculative
                         and s.request.replay is None
                         and s.pages.num_tokens + k + 1 <= self.max_seq)
                     for i, s in rows}
        caps = None
        if budget is not None and self.tenants is not None:
            # the plain path's per-tenant decode shares, a speculating
            # row charging its whole k+1 window against its tenant
            demands: dict[str, int] = {}
            for i, s in rows:
                t = s.request.tenant
                demands[t] = demands.get(t, 0) + ((k + 1) if wants_map[i]
                                                  else 1)
            caps = self.tenants.allocate(budget, demands, kind="decode")
        spec: dict[int, _Slot] = {}
        plain: dict[int, _Slot] = {}
        for i, s in rows:
            wants = wants_map[i]
            if caps is not None:
                t = s.request.tenant
                if caps.get(t, 0) <= 0:
                    continue            # a granted tenant always exists
                caps[t] -= (k + 1) if wants else 1
            elif budget is not None:
                if budget <= 0 and (spec or plain):
                    continue
                budget -= (k + 1) if wants else 1
            (spec if wants else plain)[i] = s
        return spec, plain

    def _speculate(self, spec: dict[int, _Slot]):
        """One draft/verify window over the speculating rows:

          1. SYNC the draft rows with their slots' context (rows that
             decoded plainly, fresh occupants and readmitted slots lag);
          2. PROPOSE a k-token window per row with the slots' own
             counter-derived keys;
          3. grow each table for the k+1 candidate writes: copy the
             possibly shared partial boundary page on write FIRST, then
             append (the appended pages are fresh, so the truncate
             below never strands a prefix partner);
          4. VERIFY: one batched paged-prefill walk writes every
             candidate's K/V and returns the tokens plain decode would
             emit and the matched-prefix length.  For a rewindable
             draft 2 and 4 (and the draft's rewind) are one call,
             `DraftModel.fused_fn`, and the window never visits the
             host;
          5. emit the accepted prefix and the bonus token through
             `_emit`, TRUNCATE the rejected page tail, and land the
             outcome in the draft cache (`rollback`)."""
        # plain decode ran first this tick and may have preempted
        # younger speculating slots under pool pressure
        spec = {i: s for i, s in spec.items() if self.slots.get(i) is s}
        if not spec:
            return
        k = self.speculate_k
        draft = self.draft
        entries = []
        for i, s in spec.items():
            # the draft's context: every token but the newest
            # (s.last_token is the propose scan's first input)
            needed = s.request.virtual_len + len(s.generated) - 1
            reset = not 0 <= s.draft_pos <= needed
            pos = 0 if reset else s.draft_pos
            if reset or pos < needed:
                ctx = np.concatenate(
                    [np.asarray(s.request.prompt, np.int32),
                     np.asarray(s.generated[:-1], np.int32)])
                entries.append((i, ctx[pos:needed], reset))
            s.draft_pos = needed
        draft.sync(entries)

        last = np.zeros((self.max_batch,), np.int32)
        for i, s in spec.items():
            last[i] = s.last_token
        st = self._sampling_state(spec)
        proposed = (None if self.fused_fn is not None
                    else draft.propose(last, st, k))
        self.spec_stats["windows"] += len(spec)
        self.spec_stats["draft_tokens"] += len(spec) * k

        for i, s in list(spec.items()):
            if self.slots.get(i) is not s:
                continue                 # preempted growing an older slot
            if s.pages.num_tokens % self.page_size:
                # the window's first write lands in the partial last page:
                # copy it on write BEFORE appending (append-then-cow would
                # check the fresh tail page instead)
                if not self._with_preemption(
                        s, lambda s=s: self.arena.cow_for_write(s.pages)):
                    continue             # slot yielded its pages
            self._with_preemption(
                s, lambda s=s: s.pages.append_tokens(k + 1))
        live = {i: s for i, s in spec.items() if self.slots.get(i) is s}

        # rows preempted mid-window (and rows outside the window) grow
        # their draft context by 0 tokens
        n = np.zeros((self.max_batch,), np.int32)
        target = np.zeros((self.max_batch, k + 1), np.int32)
        if live:
            b = self.max_batch
            start = np.zeros((b,), np.int32)
            bt = np.full((b, self.max_pages), self.arena.null_page, np.int32)
            for i, s in live.items():
                start[i] = s.pages.num_tokens - (k + 1)
                bt[i, :len(s.pages.pages)] = s.pages.pages
            if self.fused_fn is not None:
                mask = np.zeros((b,), bool)
                mask[list(live)] = True
                self.arena.kv, target, accept = self.fused_fn(
                    self.params, last, st, self.arena.kv, bt, start, mask)
            else:
                tokens = np.zeros((b, k + 1), np.int32)
                clen = np.zeros((b,), np.int32)
                for i, s in live.items():
                    tokens[i, 0] = s.last_token
                    tokens[i, 1:] = proposed[i]
                    clen[i] = k + 1
                self.arena.kv, target, accept = self.verify_fn(
                    self.params, {"tokens": tokens}, self.arena.kv, bt,
                    start, clen, proposed, self._sampling_state(live))
            target = target.cpu().numpy()        # the window's one sync
            accept = accept.cpu().numpy()
            self.spec_stats["verify_calls"] += 1
            for i, s in live.items():
                sp = s.request.sampling
                emitted = 0
                for j in range(int(accept[i]) + 1):
                    tok = int(target[i, j])
                    self._emit(s, tok)
                    emitted += 1
                    if tok in sp.stop \
                            or len(s.generated) >= sp.max_new_tokens:
                        break            # the slot retires this tick
                # positions start..start+emitted-1 hold the K/V of [last,
                # t_0..t_{emitted-2}]; the newest token's K/V is pending.
                # The freed tail pages were appended above: never shared,
                # never registered
                s.pages.truncate(int(start[i]) + emitted)
                s.draft_pos += emitted
                n[i] = emitted
                self.spec_stats["accepted_tokens"] += int(accept[i])
                self.spec_stats["emitted_tokens"] += emitted
        if proposed is not None:
            draft.rollback(target, n)
        # the fused call already rewound live rows to pos0 + accept + 1;
        # a row that emitted fewer hit a stop or its budget and retires
        # this tick, so its stale draft row never serves again

    def _emit_decoded(self, active: dict[int, _Slot], nxt) -> None:
        """Shared tail of both decode layouts: count the call, read the
        step's tokens (the tick's one sync) and emit them."""
        self.decode_calls += 1
        nxt = nxt.cpu().numpy()
        for i, s in active.items():
            self._emit(s, self._next_token(s, int(nxt[i])))

    def _decode_contiguous(self, active: dict[int, _Slot]):
        if not active:
            return
        tokens = np.zeros((self.max_batch,), np.int32)
        for i, s in active.items():
            tokens[i] = s.last_token
        self.cache, nxt = self.decode_fn(self.params, self.cache, tokens,
                                         self._sampling_state(active))
        self._emit_decoded(active, nxt)

    def _finish_slot(self, i: int, s: _Slot, reason: str) -> Result:
        """THE single slot-retirement path (natural retire and cancel):
        emit the FinishEvent, release the prefix-store refs and free the
        pages (paged), or free the reservation and zero the cache row
        (contiguous)."""
        result = Result(
            uid=s.request.uid, tokens=list(s.generated),
            prompt_len=len(s.request.prompt),
            admitted_at=s.admitted_at, finished_at=time.perf_counter(),
            finish_reason=reason)
        self.results.append(result)
        self._events.append(FinishEvent(uid=s.request.uid, reason=reason,
                                        result=result))
        self._emitted.pop(s.request.uid, None)
        # a prefetched copy whose parcel the tier evicted meanwhile
        self._prefetched.pop(s.request.uid, None)
        if self.layout == "paged":
            self._drop_store_refs(s)
        else:
            clear_slot(self.cache, i, self.cache_ax)
        s.pages.release()
        del self.slots[i]
        return result

    def _retire(self):
        for i, s in list(self.slots.items()):
            if s.prefilling or not s.generated:
                continue
            sp = s.request.sampling
            stopped = s.generated[-1] in sp.stop
            if not stopped and len(s.generated) < sp.max_new_tokens:
                continue
            self._finish_slot(i, s, "stop" if stopped else "length")

    # ------------------------------------------------------------ cancel

    def cancel(self, uid: int) -> bool:
        """Cancel a request mid-flight, queued or active; every resource
        it holds comes back, and a FinishEvent with reason "cancelled"
        carries the tokens generated so far.  Returns False when the uid
        is unknown or already finished."""
        reason = "cancelled"
        for j, r in enumerate(self.pending):
            if r.uid != uid:
                continue
            self.pending.pop(j)
            if self.host_tier is not None:
                self.host_tier.take(uid)         # drop the cold parcel
            self._prefetched.pop(uid, None)
            result = Result(
                uid=uid, tokens=list(r.replay or ()),
                prompt_len=len(r.prompt),
                admitted_at=time.perf_counter(),
                finished_at=time.perf_counter(), finish_reason=reason)
            self.results.append(result)
            self._events.append(FinishEvent(uid=uid, reason=reason,
                                            result=result))
            self._emitted.pop(uid, None)
            self.cancellations += 1
            log.info("engine: cancelled uid=%d (queued)", uid)
            return True
        for i, s in list(self.slots.items()):
            if s.request.uid != uid:
                continue
            if self.host_tier is not None:
                self.host_tier.take(uid)         # stale parcel, if any
            self._prefetched.pop(uid, None)
            self._finish_slot(i, s, reason)
            self.cancellations += 1
            log.info("engine: cancelled uid=%d (active, %d tokens in)",
                     uid, len(s.generated))
            return True
        return False

    def _enforce_high_watermark(self):
        """Proactive backpressure: when allocation crosses the high
        watermark, shed idle cache pages first (no live slot loses work;
        the cost is a possible future prefill, softened by the host
        tier's cold spill), then preempt youngest slots (never the
        oldest) until the pool is back under."""
        if self.high_watermark is None or self.layout != "paged":
            return
        limit = int(self.high_watermark * self.pool.num_pages)

        def over():
            return (self.pool.num_pages - self.pool.free_pages) > limit

        while over() and self._reclaim_idle():
            pass
        while over() and len(self.slots) > 1:
            oldest = min(self.slots.values(), key=lambda s: s.order)
            if not self._preempt_youngest(but=oldest):
                break

    def step(self):
        if self.layout == "paged":
            self._admit_paged()
        else:
            self._admit_contiguous()
        self._tier_prefetch()       # overlaps the host-to-device copy
        self._prefill_tick()
        self._enforce_high_watermark()
        if self.layout == "paged":
            self._decode_paged()
        else:
            self._decode_contiguous(self._decode_rows())
        self.steps += 1
        self._retire()

    def stream(self, max_steps: int = 10_000):
        """Tick the engine and yield TokenEvent/FinishEvent records as
        they happen."""
        while (self.pending or self.slots) and self.steps < max_steps:
            self.step()
            yield from self.events()

    def run(self, max_steps: int = 10_000) -> list[Result]:
        """Run to completion; returns the collected Results."""
        t0 = time.perf_counter()
        for _ in self.stream(max_steps):
            pass
        dt = time.perf_counter() - t0
        if dt > 0:
            log.info("engine[%s]: %d results, %d tokens, %.1f tok/s, "
                     "pool util %.2f (peak %d pages)",
                     self.device, len(self.results), self.tokens_out,
                     self.tokens_out / dt, self.pool.stats().utilization,
                     self.pool.stats().peak_allocated_pages)
        return self.results

    # -------------------------------------------------------------- fork

    def fork(self, uid: int, new_uid: int,
             sampling: SamplingParams | None = None) -> None:
        """Branch an active sequence into a free slot: the child SHARES
        every page (refcounts, zero copies) and diverges lazily — the
        first write into the shared partial last page triggers
        copy-on-write.  `sampling` gives the child its own regime; None
        inherits the parent's.  Paged layout only."""
        if self.layout != "paged":
            raise ValueError("fork requires the paged layout")
        free = self._free_slots()
        if not free:
            raise RuntimeError("no free slot to fork into")
        src_i, src = next(((i, s) for i, s in self.slots.items()
                           if s.request.uid == uid), (None, None))
        if src is None or src.prefilling:
            raise ValueError(f"uid {uid} is not active")
        child_req = Request(uid=new_uid, prompt=src.request.prompt,
                            eos_token=src.request.eos_token,
                            patch_embeds=src.request.patch_embeds,
                            sampling=sampling or src.request.sampling)
        self._resolve_sampling(child_req)
        child = _Slot(request=child_req, pages=src.pages.fork(),
                      generated=list(src.generated),
                      last_token=src.last_token,
                      admitted_at=time.perf_counter(), order=self._admitted,
                      prefill_pos=child_req.virtual_len,
                      store_refs=set(src.store_refs))
        # the child's table references the same registered prefix pages
        # as the parent — it takes its own store refs
        for h in child.store_refs:
            self.prefix_store.acquire(h)
        self._admitted += 1
        # inherited tokens were the parent's: the child's stream starts
        # at the fork point
        self._emitted[new_uid] = len(child.generated)
        self.slots[free[0]] = child
        # state that cannot share pages (hybrid conv/SSM rows) is copied
        self.arena.copy_slot_state(src_i, free[0])
        # the child's page_hashes stay EMPTY: its pages are the parent's
        # (plus copied-on-write speculative tails), so it never publishes
        if self.draft is not None:
            self.draft.copy_row(src_i, free[0])
            child.draft_pos = src.draft_pos

    # ------------------------------------------------------------- stats

    def peak_kv_bytes(self) -> int:
        """Device bytes the cache layout ties down: the arena's page
        high-water mark plus its per-slot state (hybrid conv/SSM rows,
        zero elsewhere); the contiguous cache's full footprint, reserved
        up front."""
        if self.layout == "paged":
            return (self.pool.stats().peak_allocated_pages
                    * self.arena.page_bytes + self.arena.state_bytes)
        return sum(a.numel() * a.element_size() for a in self.cache.values())

    def stats(self) -> dict:
        out = {
            "layout": self.layout,
            "device": str(self.device),
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "prefill_tokens": self.prefill_tokens,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "active_slots": len(self.slots),
            "pending": len(self.pending),
            "admitted": self._admitted,
            "preemptions": self.preemptions,
            "cancellations": self.cancellations,
            "peak_kv_bytes": self.peak_kv_bytes(),
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_shapes": sorted(self.prefill_shapes),
            "prefill_decode_ratio": self.prefill_decode_ratio,
            "pool": self.pool.stats().__dict__,
        }
        if self.tenants is not None:            # per-tenant budget shares
            out["tenants"] = {
                t: {"weight": self.tenants.weight_of(t),
                    "tokens": self.tenant_tokens.get(t, 0)}
                for t in sorted(set(self.tenant_tokens)
                                | set(self.tenants.weights))}
        if self.prefix_store is not None:       # prompt-page reuse traffic
            out["prefix_store"] = self.prefix_store.stats()
        if self.draft is not None:              # speculative decode traffic
            sp = dict(self.spec_stats)
            sp["k"] = self.speculate_k
            sp["accept_rate"] = (sp["accepted_tokens"] / sp["draft_tokens"]
                                 if sp["draft_tokens"] else 0.0)
            sp["draft"] = self.draft.stats()
            out["speculative"] = sp
        if self.mesh is not None:               # near-memory sharded arena
            out["mesh"] = self.mesh.describe()
            out["shards"] = self.pool.shard_stats()
            out["shard_kv_bytes"] = self.arena.shard_kv_bytes()
        if self.host_tier is not None:          # DRAM cold tier traffic
            tier = self.host_tier.stats()
            tier["peak_bytes"] = (tier["peak_resident_pages"]
                                  * self.arena.page_bytes)
            out["host_tier"] = tier
        return out
