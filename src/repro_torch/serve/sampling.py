"""Per-request sampling inside the serving step.

Port of `repro.serve.sampling`.  `SamplingParams` (the request-level
description) and `SamplingState` (its per-slot struct-of-arrays
lowering, batch row i == engine slot i) are copied; `sample_tokens`
runs on the logits' device and returns int32 tokens, so the (b, vocab)
logits never reach the host.

Greedy rows take the exact argmax, as in the reference.  Sampled rows
apply the reference's temperature scaling, masked top-k and top-p
(`filter_logits`, sampling.py:176-193), then draw exactly as the
reference does: `categorical(fold_in(key(seed), step), logits)` under
partitionable threefry, ported in `serve/prng.py`.  The threefry bits
and the uniforms are bit-exact with `jax.random`; the Gumbel noise
`-log(-log(u))` may differ from XLA's by an ulp of `log`, so a token
could differ only where two candidates tie within that ulp.  Tokens are
a pure function of (prompt, SamplingParams), independent of batch
composition and slot order, as DESIGN.md §6 requires.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.serve import prng

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """How one request wants its tokens drawn.

    temperature: 0.0 = greedy argmax (the default); > 0 scales logits.
    top_k:       keep only the k highest logits (0 = off).
    top_p:       nucleus sampling — keep the smallest prefix of the
                 sorted distribution with cumulative mass >= top_p
                 (1.0 = off).
    seed:        per-request seed; token t is drawn with the threefry key
                 fold_in(key(seed), t), so a (prompt, params) pair
                 replays identically.
    max_new_tokens / stop: generation budget and stop-token set.
    speculative: opt-in flag for speculative decode (carried for wire
                 compatibility; this port has no speculative decode yet).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 32
    stop: tuple[int, ...] = ()
    speculative: bool = True

    def validate(self) -> "SamplingParams":
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        return self

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    # ------------------------------------------------------ wire codec

    def to_wire(self) -> dict:
        """JSON-safe dict with every field explicit."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed,
                "max_new_tokens": self.max_new_tokens,
                "stop": list(self.stop), "speculative": self.speculative}

    @classmethod
    def from_wire(cls, d: dict) -> "SamplingParams":
        """Strict inverse of `to_wire`: unknown keys are an error,
        missing keys take the dataclass defaults, the result is
        validated."""
        if not isinstance(d, dict):
            raise ValueError(f"params must be an object, got {type(d).__name__}")
        known = {"temperature", "top_k", "top_p", "seed",
                 "max_new_tokens", "stop", "speculative"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown sampling params: {sorted(unknown)}")
        kw = dict(d)
        if "stop" in kw:
            kw["stop"] = tuple(int(t) for t in kw["stop"])
        return cls(**kw).validate()


class SamplingState(NamedTuple):
    """Per-slot struct-of-arrays lowering of `SamplingParams` (host
    numpy, batch row i == engine slot i).  Rows without a live request
    stay greedy-inert (temperature 0)."""
    temperature: np.ndarray         # (b,) f32; <= 0 -> greedy argmax
    top_k: np.ndarray               # (b,) i32; 0 -> off
    top_p: np.ndarray               # (b,) f32; >= 1 -> off
    seed: np.ndarray                # (b,) u32 seed
    step: np.ndarray                # (b,) i32 emission counter


def state_for_slots(batch: int, entries) -> SamplingState:
    """Lower per-slot (row, SamplingParams, emitted_count) triples into
    one SamplingState.  Rows not named stay greedy-inert."""
    t = np.zeros((batch,), np.float32)
    k = np.zeros((batch,), np.int32)
    p = np.ones((batch,), np.float32)
    seed = np.zeros((batch,), np.uint32)
    step = np.zeros((batch,), np.int32)
    for row, sp, emitted in entries:
        t[row] = sp.temperature
        k[row] = sp.top_k
        p[row] = sp.top_p
        seed[row] = np.uint32(sp.seed & 0xFFFFFFFF)
        step[row] = emitted
    return SamplingState(t, k, p, seed, step)


def greedy_state(batch: int) -> SamplingState:
    """All-greedy state (the `SamplingParams()` default for every row)."""
    return state_for_slots(batch, ())


class DeviceKnobs(NamedTuple):
    """What the sampled rows' draws read on the device: the per-row
    filter knobs of every batch row, the threefry inputs of every row,
    and the indices of the rows that sample."""
    temperature: torch.Tensor       # (b,) f32
    top_k: torch.Tensor             # (b,) i32
    top_p: torch.Tensor             # (b,) f32
    seed: torch.Tensor              # (b,) i32 bits of the u32 seed
    step: torch.Tensor              # (b,) i32 emission counter
    rows: torch.Tensor              # (r,) i32 rows with temperature > 0


def host_knobs(state: SamplingState) -> tuple[np.ndarray, ...]:
    """The knobs the draw reads on the device, as int32 host arrays
    (f32 and u32 fields bit-cast) to ride in the step's one host->device
    copy; () when every row is greedy, since then nothing of them is
    read."""
    if not (state.temperature > 0.0).any():
        return ()
    return _knob_arrays(state)


def _knob_arrays(state: SamplingState) -> tuple[np.ndarray, ...]:
    rows = np.nonzero(state.temperature > 0.0)[0]
    return (np.ascontiguousarray(state.temperature, np.float32).view(np.int32),
            np.asarray(state.top_k, np.int32),
            np.ascontiguousarray(state.top_p, np.float32).view(np.int32),
            np.ascontiguousarray(state.seed, np.uint32).view(np.int32),
            np.asarray(state.step, np.int32),
            rows.astype(np.int32))


def device_knobs(arrays) -> DeviceKnobs | None:
    """Inverse of `host_knobs` on the device tensors it became, or None
    for ()."""
    if not arrays:
        return None
    t, k, p, seed, step, rows = arrays
    return DeviceKnobs(t.view(torch.float32), k, p.view(torch.float32),
                       seed, step, rows)


def filter_logits(logits, state: SamplingState, knobs=None):
    """Temperature scaling, masked top-k, then masked top-p over the
    renormalized top-k survivors — sampling.py:176-193 of the reference,
    row-vectorized.  `knobs` are the state's `DeviceKnobs` already on
    the logits' device (`device_knobs`); None copies them from
    `state`.  Returns the scaled logits with cut entries at NEG_INF
    (f32, logits' device)."""
    logits = logits.float()
    b, V = logits.shape
    if knobs is None:
        knobs = _knobs_on(state, logits.device)
    temperature, top_k, top_p = knobs[:3]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    neg = torch.full_like(scaled, NEG_INF)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    kth = torch.gather(desc, 1, torch.clamp(k_eff[:, None].long() - 1, 0, V - 1))
    scaled = torch.where(scaled < kth, neg, scaled)
    probs = torch.softmax(scaled, dim=-1)
    psort = torch.sort(probs, dim=-1, descending=True).values
    keep = torch.cumsum(psort, dim=-1) - psort < top_p[:, None]
    thr = torch.where(keep, psort, torch.full_like(psort, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    nucleus = (top_p < 1.0)[:, None]
    return torch.where(nucleus & (probs < thr), neg, scaled)


def _knobs_on(state: SamplingState, device) -> DeviceKnobs:
    return device_knobs([torch.from_numpy(a).to(device)
                         for a in _knob_arrays(state)])


def sample_tokens(logits, state: SamplingState, knobs=None):
    """(b, V) logits + per-slot SamplingState -> (b,) int32 tokens on
    the logits' device.  An all-greedy tick (the default) is one argmax;
    the filter and the draws run only when some row samples (decided on
    the host state, so no device sync), and the draws only for the rows
    that sample.  `knobs` as in `filter_logits`."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (state.temperature > 0.0).any():
        return greedy
    if knobs is None:
        knobs = _knobs_on(state, logits.device)
    scaled = filter_logits(logits, state, knobs)
    rows = knobs.rows.long()
    k0, k1 = prng.fold_in(knobs.seed[rows].long() & prng.MASK32,
                          knobs.step[rows].long())
    out = greedy.clone()
    out[rows] = prng.categorical(k0, k1, scaled[rows]).to(torch.int32)
    return out
