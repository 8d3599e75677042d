"""Speculative decode: a draft proposes k tokens, ONE paged walk verifies.

Port of `repro.serve.speculative`.  A cheap draft model proposes a
k-token window per slot; the target writes all k+1 candidates into the
slot's pages and judges them in one ragged paged-prefill call
(`serve_step.make_paged_verify_fn`), and the matched prefix plus one
bonus token is emitted.  Token t of a slot is a pure function of (target
logits at t, fold_in(key(seed), t)), so acceptance is an exact match
against the token plain decode would emit (`sampling.verify_tokens`),
and the draft proposes with the same counter-derived keys, so its
agreement tracks how close its logits are to the target's.

Two draft shapes, one class:

* **truncated self-draft** (`"self:N"`): the target's first N layers
  with its embed, final norm and head (`registry.self_draft_params`, no
  extra weights).  Its contiguous KV cache REWINDS: rejected positions
  are dropped by resetting `pos` (decode attention masks everything
  past it).
* **paired draft** (e.g. `"mamba2-130m"`, `registry.DRAFT_PAIRS`): an
  independent small model with seeded weights.  Recurrent state cannot
  rewind, so `rollback` replays the accepted tokens from the
  pre-propose checkpoint.

The draft serves from its own contiguous cache (never the page arena);
row i mirrors engine slot i.  The family hooks update that cache IN
PLACE for every row, where the reference's pytrees are immutable, so
the masked advance (`_advance`) pins the `pos` of rows that sit a step
out and restores, at the end, what the steps wrote into them: the K/V
slot at their pinned position and their whole state rows.  `propose`
checkpoints `pos` alone for a rewindable draft and clones every leaf
for a state draft.

For rewindable drafts `fused_fn` runs propose, verify, accept and the
rewind as one call with the window kept on the device, as the
reference's fused jit does (with its optimistic rewind `pos0 + accept +
1` on live rows); state drafts take propose, verify and `rollback`.
On one arena the engine never calls `propose` and `rollback` on a
rewindable draft; on a mesh it takes them for every draft: the sharded
verify (`serve/sharded/serve_step.py` `make_sharded_verify_fn`) is a
call of its own between them, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.kv_cache import batch_axis_index, clear_slot
from repro_torch.serve.sampling import (SamplingState, device_knobs,
                                        expand_state, host_knobs,
                                        sample_tokens, verify_tokens)
from repro_torch.serve.serve_step import to_device

# widest single masked-advance call during sync; longer catch-ups loop
SYNC_CHUNK = 128


def _bucket(n: int) -> int:
    """Power-of-two width bucket, capped at SYNC_CHUNK."""
    r = 1
    while r < n:
        r *= 2
    return min(r, SYNC_CHUNK)


class DraftModel:
    """The draft side of speculative decode, engine-slot addressed:
    batch row i of the draft cache mirrors engine slot i."""

    def __init__(self, cfg: ModelConfig, params, spec: str | None = None, *,
                 max_batch: int, max_seq: int, device):
        self.target_cfg = cfg
        self.spec = spec = spec or registry.default_draft(cfg)
        self.cfg = dcfg = registry.draft_config(cfg, spec)
        self.fam = fam = registry.get_family(dcfg)
        self.device = torch.device(device)
        if registry.is_self_draft(cfg, dcfg):
            self.params = registry.self_draft_params(params, dcfg)
        else:
            self.params = fam.init(0, dcfg, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = fam.init_cache(dcfg, max_batch, max_seq,
                                    device=self.device)
        self._axes = fam.cache_axes()
        # KV caches rewind (pos masks the garbage tail); recurrent state
        # leaves (conv/ssm) replay from a checkpoint instead
        self.rewindable = set(self.cache) <= {"k", "v", "pos"}
        self._ckpt = None
        self._last = None
        self.steps = 0                  # draft decode steps run, all rows

    # ------------------------------------------------------------ bodies

    def _scan(self, tokens, st: SamplingState, knobs, r: int):
        """r decode steps of every row: consume [last, d_0..d_{r-2}],
        emit [d_0..d_{r-1}] drawn at emission indices step..step+r-1.
        The r-th proposal only advances the cache, so a fully accepted
        window needs no catch-up.  Returns (b, r) int32 on the device."""
        out = []
        for j in range(r):
            _, logits = self.fam.decode_step(self.params, self.cfg,
                                             self.cache, tokens)
            self.steps += 1
            kn = None if knobs is None else knobs._replace(
                step=knobs.step + j)
            tokens = sample_tokens(logits, st, kn)
            out.append(tokens)
        return torch.stack(out, dim=1)

    def _rows(self, a, name: str, rows, pos):
        """Index of what a decode step writes in leaf `a` for `rows`
        held at positions `pos`: the K/V slot at pos (clamped into the
        cache, as the write is) or the whole state row."""
        axes = tuple(self._axes[name])
        v = a.movedim(batch_axis_index(axes), 0)
        if "act_kv_seq" not in axes:
            return v, (rows,)
        seq = axes.index("act_kv_seq")
        seq += seq < batch_axis_index(axes)
        v = v.movedim(seq, 1)
        return v, (rows, torch.clamp(pos, max=v.shape[1] - 1).long())

    def _advance(self, tokens: np.ndarray, n: np.ndarray) -> None:
        """Masked advance: row i consumes tokens[i, :n[i]]; every leaf of
        a row ends as it was after its n[i] steps (rows with n 0
        unchanged).  A row past its n stays pinned at its final `pos`,
        and what the later steps write into it (the K/V slot there, its
        state rows) is saved when it stops and put back at the end."""
        steps = int(n.max(initial=0))
        if steps == 0:
            return
        cache = self.cache
        held = np.minimum(n[None, :],
                          np.arange(steps, dtype=np.int32)[:, None])
        tok, n_t, held_t = to_device(self.device, tokens[:, :steps], n, held)
        pos0 = cache["pos"].clone()
        saved = []
        for j in range(steps):
            stop = np.nonzero(n == j)[0]
            if len(stop):
                rows = torch.from_numpy(stop).to(self.device)
                at = pos0[rows] + n_t[rows]
                for name, a in cache.items():
                    if name != "pos":
                        v, idx = self._rows(a, name, rows, at)
                        saved.append((v, idx, v[idx].clone()))
            cache["pos"].copy_(pos0 + held_t[j])
            self.fam.decode_step(self.params, self.cfg, cache, tok[:, j])
            self.steps += 1
        for v, idx, old in saved:
            v[idx] = old
        cache["pos"].copy_(pos0 + n_t)

    # -------------------------------------------------------- engine API

    @torch.inference_mode()
    def sync(self, entries) -> None:
        """Catch rows up with their slots' context.  `entries` is a list
        of (row, suffix_tokens, reset): the row consumes `suffix_tokens`
        (np int32, the context past its current draft position); `reset`
        zeroes the row first (a fresh occupant or a readmission)."""
        if not entries:
            return
        for row, _, reset in entries:
            if reset:
                clear_slot(self.cache, row, self._axes)
        b = self.max_batch
        offset = 0
        remaining = max(len(t) for _, t, _ in entries)
        while offset < remaining:
            width = _bucket(remaining - offset)
            toks = np.zeros((b, width), np.int32)
            n = np.zeros((b,), np.int32)
            for row, t, _ in entries:
                part = t[offset:offset + width]
                toks[row, :len(part)] = part
                n[row] = len(part)
            self._advance(toks, n)
            offset += width

    @torch.inference_mode()
    def propose(self, last_tokens, st: SamplingState, k: int) -> np.ndarray:
        """A k-token window per row: last_tokens (b,) int32 (each row's
        newest emitted token, the draft's next input), st the slots'
        SamplingState with step = next emission index.  Returns (b, k)
        np.int32 and checkpoints the cache for `rollback`."""
        if self.rewindable:
            self._ckpt = {"pos": self.cache["pos"].clone()}
        else:
            self._ckpt = {n: a.clone() for n, a in self.cache.items()}
        last, *knobs = to_device(self.device, last_tokens, *host_knobs(st))
        window = self._scan(last, st, device_knobs(knobs), k + 1)
        self._last = np.asarray(last_tokens, np.int32)
        return window[:, :k].cpu().numpy()

    @torch.inference_mode()
    def rollback(self, target, n) -> None:
        """Land the verify outcome: row i's draft context grows by n[i]
        tokens (accepted + bonus; 0 for rows that sat the window out).
        target: (b, k+1) the verify step's tokens; n: (b,) np int32.
        Rewindable drafts keep the K/V the propose scan wrote (the
        accepted prefix's inputs matched by construction) and reset
        `pos`; state drafts replay the accepted tokens from the
        checkpoint."""
        n = np.asarray(n, np.int32)
        if self.rewindable:
            n_t, = to_device(self.device, n)
            self.cache["pos"].copy_(self._ckpt["pos"] + n_t)
        else:
            replay = np.concatenate([self._last[:, None],
                                     np.asarray(target)[:, :-1]], axis=1)
            self.cache = self._ckpt
            self._advance(replay.astype(np.int32), n)
        self._ckpt = None

    def fused_fn(self, k: int):
        """One call per window for REWINDABLE drafts: the propose scan,
        the target's ragged verify walk, accept/reject and the draft
        rewind, with the window kept on the device (the host reads
        nothing between propose and verify).

        fused(target_params, last (b,), st, arena, block_table, start,
              live (b,) bool) -> (arena, target (b, k+1), accept (b,))

        The rewind is the reference's optimistic `pos = pos0 + accept +
        1` on live rows: a row that emits fewer tokens hit a stop or its
        budget and retires this tick, so its draft row is dead either
        way.  Rows outside `live` keep pos.  Returns None for state
        drafts, whose rollback replays from a checkpoint."""
        if not self.rewindable:
            return None
        tfam, tcfg, r = registry.get_family(self.target_cfg), \
            self.target_cfg, k + 1

        @torch.inference_mode()
        def fused(tparams, last, st: SamplingState, arena, block_table,
                  start, live):
            clen = np.where(live, r, 0).astype(np.int32)
            draw = host_knobs(st)
            last_t, bt, st_t, cl, *knobs = to_device(
                self.device, last, block_table, start, clen, *draw,
                *host_knobs(expand_state(st, r)))
            pos0 = self.cache["pos"].clone()
            window = self._scan(last_t, st, device_knobs(knobs[:len(draw)]),
                                r)
            draft = window[:, :k]
            chunk = {"tokens": torch.cat([last_t[:, None], draft], dim=1)}
            arena, logits = tfam.paged_verify(tparams, tcfg, chunk, arena,
                                              bt, st_t, cl)
            target, accept = verify_tokens(logits, draft, st,
                                           device_knobs(knobs[len(draw):]))
            self.cache["pos"].copy_(
                pos0 + torch.where(cl > 0, accept + 1, 0).to(pos0.dtype))
            return arena, target, accept

        return fused

    @torch.inference_mode()
    def copy_row(self, src: int, dst: int) -> None:
        """fork(): the child slot adopts the parent's draft state."""
        for name, a in self.cache.items():
            bi = batch_axis_index(tuple(self._axes[name]))
            a.select(bi, dst).copy_(a.select(bi, src))

    @torch.inference_mode()
    def clear_row(self, row: int) -> None:
        """Zero a row's state (the next occupant resets it anyway)."""
        clear_slot(self.cache, row, self._axes)

    def stats(self) -> dict:
        return dict(spec=self.spec, family=self.cfg.family,
                    num_layers=self.cfg.num_layers,
                    rewindable=self.rewindable)
