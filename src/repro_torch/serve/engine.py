"""Continuous-batching serving engine, paged-native on the UniMem arena.

Port of the single-arena paged path of `repro.serve.engine`; the
scheduling logic is the reference's line for line, so on the same
requests the port makes the same admission, chunking, preemption and
fork decisions and (greedy) emits the same tokens:

  * pages are allocated LAZILY as sequences grow — admission reserves
    only the first prefill chunk (watermark admission);
  * full prompt pages are SHARED between in-flight requests through
    chained page-content hashes (`serve/prefix_store.py`, donor
    lifetime) with copy-on-write on partial last pages;
  * prefill is BATCHED and BUCKETED — one step call per tick advances
    every admitting slot by a ragged chunk whose shared width snaps up
    to a power-of-two bucket;
  * when the pool runs dry the YOUNGEST slot is preempted back to the
    queue (recompute-on-readmit, already-published tokens replayed);
  * an optional token budget (`prefill_decode_ratio`) splits each tick
    between prefill and decode;
  * every emitted token is a `TokenEvent`, every retirement a
    `FinishEvent`, through one emission path.

Sampling runs inside the step (`serve/serve_step.py`): the step returns
int32 tokens and reading them is the tick's one synchronisation.

Options the reference has and this slice does not port raise
`NotImplementedError` naming the ROADMAP.md item that will port them:
`layout="contiguous"`, `mesh`, `host_tier_pages`, `prefix_cache=True`,
`speculate_k > 0`, `tenant_weights`, and the families not ported
(ssm, encoder, vlm).  Families with per-slot recurrent state (hybrid)
share prompt pages but never skip their compute, as in the reference.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.unimem import SequencePageTable, UniMemOOM
from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.kv_cache import PagedKVArena
from repro_torch.serve.prefix_store import PrefixStore
from repro_torch.serve.sampling import SamplingParams, state_for_slots
from repro_torch.serve.serve_step import make_paged_serve_fns
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("engine")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 32           # legacy mirror of sampling.max_new_tokens
    sampling: SamplingParams | None = None   # resolved by the engine at submit
    # tokens a preempted slot had already generated: on readmission the
    # engine REPLAYS them as forced context instead of re-sampling
    replay: list[int] | None = None

    @property
    def virtual_len(self) -> int:
        """Prompt positions the cache must hold."""
        return len(self.prompt)

    @property
    def max_footprint(self) -> int:
        return self.virtual_len + self.max_new_tokens

    def virtual_bytes(self, lo: int, hi: int) -> bytes:
        """Content of prompt positions [lo, hi) for page hashing."""
        return self.prompt[lo:hi].tobytes()


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

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.request.virtual_len


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue A "
                              f"{item}")


def _params_on(tree, device):
    if isinstance(tree, dict):
        return {k: _params_on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_on(v, device) for v in tree]
    return tree.to(device)


class ServingEngine:
    """Paged continuous-batching engine on one device (`device=None`
    means CUDA, and raises without a GPU).

    Chunk widths snap UP to `prefill_buckets` — powers of two from 8 up
    to `prefill_chunk`, plus `prefill_chunk` itself — so the set of
    prefill shapes stays bounded; `prefill_shapes` records the (batch,
    width) pairs dispatched.  Rows with fewer remaining tokens than the
    bucket mask their tails, so bucketing never changes emitted
    tokens."""

    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 max_batch: int = 8, max_seq: int = 1024,
                 page_size: int = 16, pool_pages: int | None = None,
                 layout: str | None = None,
                 prefill_chunk: int | None = None, mesh=None,
                 high_watermark: float | None = None,
                 prefill_decode_ratio: float | None = None,
                 tick_token_budget: int | None = None,
                 host_tier_pages: int | None = None,
                 prefix_cache: bool = False,
                 speculate_k: int = 0,
                 tenant_weights: dict[str, float] | None = None):
        if layout not in (None, "paged", "contiguous"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "contiguous":
            _refuse("layout='contiguous'", "item 10 (contiguous paths)")
        if mesh is not None:
            _refuse("sharded serving (mesh)", "item 12")
        if host_tier_pages:
            _refuse("the host tier (host_tier_pages)", "item 7")
        if prefix_cache:
            _refuse("the persistent prefix cache (prefix_cache=True)",
                    "item 7")
        if speculate_k:
            _refuse("speculative decode (speculate_k > 0)", "item 9")
        if tenant_weights is not None:
            _refuse("tenant budget shares (tenant_weights)", "item 11")
        if not registry.has_paged(cfg):    # raises for unported families
            raise ValueError(f"family {cfg.family!r} has no paged path")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _params_on(params, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_size = page_size
        # fraction of pool pages above which the engine proactively
        # preempts youngest slots (None = preempt only on hard OOM)
        self.high_watermark = high_watermark
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
        self.prefill_shapes: set[tuple[int, int]] = set()

        self.arena = PagedKVArena(cfg, num_pages=pool_pages,
                                  page_size=page_size, device=self.device,
                                  max_batch=max_batch)
        # families with contiguous per-slot state (hybrid conv/SSM) can
        # share page MEMORY but never skip prefill COMPUTE: the skipped
        # tokens' state would not exist for the new slot
        self._slot_state = self.arena.state_bytes > 0
        self.prefill_fn, self.decode_fn = make_paged_serve_fns(cfg,
                                                               self.device)
        self.pool = self.arena.pool
        self.prefix_store = PrefixStore(self.pool)

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
        """Fill in `request.sampling` (greedy when absent; a non-default
        legacy `max_new_tokens` overrides a params-default budget) and
        keep the legacy mirror coherent — the engine reads `sampling`
        only."""
        sp = request.sampling
        if sp is None:
            sp = SamplingParams(max_new_tokens=request.max_new_tokens)
        else:
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

    def _match_prefix(self, req: Request):
        """Longest run of shareable full pages for this prompt, capped so
        at least one prompt position is always re-prefilled.  Returns
        (written, adopted, hashes, store_hashes): `written` pages hold
        published K/V the new sequence skips; `adopted` pages are being
        written by a co-prefilling slot with identical content, or (for
        per-slot-state families) are published pages it must still
        recompute through."""
        hashes = self._page_hashes(req)
        limit = (req.virtual_len - 1) // self.page_size
        written, adopted, store_hashes = [], [], []
        store = self.prefix_store
        for i, h in enumerate(hashes[:limit]):
            page = store.page_of(h)
            if page is not None:
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
        return written, adopted, hashes, store_hashes

    def _register_prefix(self, slot: _Slot):
        """Publish the slot's fully WRITTEN prompt pages for sharing."""
        store = self.prefix_store
        full = min(slot.request.virtual_len, slot.prefill_pos) // self.page_size
        for i, h in enumerate(slot.page_hashes[:full]):
            if i >= len(slot.pages.pages):
                break
            mine = slot.pages.pages[i]
            page = store.page_of(h)
            if page is None:
                page = store.register(h, mine)
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
        for h in s.store_refs:
            self.prefix_store.release(h)
        s.store_refs.clear()

    # ------------------------------------------------------------- admit

    def _admit_paged(self):
        """Watermark admission: a request enters as soon as the pool can
        hold its FIRST prefill chunk; the rest of the prompt's pages are
        allocated lazily, chunk by chunk, with preemption as the
        backpressure.  Shared prefix pages cost nothing extra."""
        free = self._free_slots()
        while free and self.pending:
            req = self.pending[0]
            plen = req.virtual_len
            written, adopted, hashes, store_hashes = self._match_prefix(req)
            shared_tokens = len(written) * self.page_size
            held = shared_tokens + len(adopted) * self.page_size
            first = min(self.prefill_chunk, plen - held)
            need = (self.pool.pages_for(held + first)
                    - len(written) - len(adopted))
            if not self.pool.fits(need):
                break                            # UniMem backpressure
            self.pending.pop(0)
            slot = free.pop(0)
            if written or adopted:
                self.pool.share(written + adopted)
            for h in store_hashes:
                self.prefix_store.acquire(h, reuse=True)
            seq = SequencePageTable(self.pool, written + adopted, held)
            seq.append_tokens(first)
            s = _Slot(request=req, pages=seq, admitted_at=time.perf_counter(),
                      order=self._admitted, prefill_pos=shared_tokens,
                      page_hashes=hashes,
                      store_refs=set(store_hashes))
            self._admitted += 1
            self.slots[slot] = s
            self._register_prefix(s)    # shared pages are already written

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
            for i, s in sorted(pre, key=lambda kv: kv[1].order):
                lens[i] = min(lens[i], max(budget, 0))
                budget -= lens[i]
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
        for i, s in pre:
            req, n, pos = s.request, lens[i], s.prefill_pos
            tokens[i, :n] = req.prompt[pos:pos + n]
            start[i] = pos
            clen[i] = n
            bt[i, :len(s.pages.pages)] = s.pages.pages
        self.arena.kv, first = self.prefill_fn(
            self.params, {"tokens": tokens}, self.arena.kv, bt, start, clen,
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

    def _decode_rows(self) -> dict[int, _Slot]:
        """Active decode rows for this tick, throttled oldest-first by
        the decode share of the token budget (when a ratio is set)."""
        active = {i: s for i, s in self.slots.items() if not s.prefilling
                  and s.generated}
        budget = self._decode_slot_budget()
        if budget is None or len(active) <= budget:
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
        self.decode_calls += 1
        nxt = nxt.cpu().numpy()                  # the tick's one sync
        for i, s in active.items():
            self._emit(s, self._next_token(s, int(nxt[i])))

    def _finish_slot(self, i: int, s: _Slot, reason: str) -> Result:
        """THE single slot-retirement path (natural retire and cancel):
        emit the FinishEvent, release the prefix-store refs, free the
        pages."""
        result = Result(
            uid=s.request.uid, tokens=list(s.generated),
            prompt_len=len(s.request.prompt),
            admitted_at=s.admitted_at, finished_at=time.perf_counter(),
            finish_reason=reason)
        self.results.append(result)
        self._events.append(FinishEvent(uid=s.request.uid, reason=reason,
                                        result=result))
        self._emitted.pop(s.request.uid, None)
        self._drop_store_refs(s)
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
            self._finish_slot(i, s, reason)
            self.cancellations += 1
            log.info("engine: cancelled uid=%d (active, %d tokens in)",
                     uid, len(s.generated))
            return True
        return False

    def _enforce_high_watermark(self):
        """Proactive backpressure: when allocation crosses the high
        watermark, preempt youngest slots (never the oldest) until the
        pool is back under."""
        if self.high_watermark is None:
            return
        limit = int(self.high_watermark * self.pool.num_pages)
        while ((self.pool.num_pages - self.pool.free_pages) > limit
               and len(self.slots) > 1):
            oldest = min(self.slots.values(), key=lambda s: s.order)
            if not self._preempt_youngest(but=oldest):
                break

    def step(self):
        self._admit_paged()
        self._prefill_tick()
        self._enforce_high_watermark()
        self._decode_plain(self._decode_rows())
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
        inherits the parent's."""
        free = self._free_slots()
        if not free:
            raise RuntimeError("no free slot to fork into")
        src_i, src = next(((i, s) for i, s in self.slots.items()
                           if s.request.uid == uid), (None, None))
        if src is None or src.prefilling:
            raise ValueError(f"uid {uid} is not active")
        child_req = Request(uid=new_uid, prompt=src.request.prompt,
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

    # ------------------------------------------------------------- stats

    def peak_kv_bytes(self) -> int:
        """Device bytes the arena ties down: the page high-water mark
        plus the per-slot state (hybrid conv/SSM rows, zero elsewhere)."""
        return (self.pool.stats().peak_allocated_pages
                * self.arena.page_bytes + self.arena.state_bytes)

    def stats(self) -> dict:
        return {
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
            "prefix_store": self.prefix_store.stats(),
        }
