"""The public streaming serve API: `LLMServer.generate` -> a token stream.

Port of `repro.serve.api`.  One `LLMServer` owns one engine; each
`generate(prompt, params)` call submits a request with its own
`SamplingParams` and returns a `GenerationStream` — a lazy iterator of
`TokenEvent`s terminated by a `FinishEvent`.  Iterating a stream TICKS
the shared engine, so concurrent streams interleave.

    server = LLMServer(cfg, max_batch=8, max_seq=512)   # cuda by default
    stream = server.generate(prompt, SamplingParams(temperature=0.8,
                                                    top_p=0.9, seed=7))
    for ev in stream:
        print(ev.token)
    result = stream.result

`stream.fork(params)` branches the in-flight sequence through the
engine's copy-on-write page fork under its own sampling regime.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.engine import (Request, Result, ServingEngine,
                                      TokenEvent)
from repro_torch.serve.sampling import SamplingParams
from repro_torch.utils.device import resolve_device


class GenerationStream:
    """Per-request view of the engine's event stream: yields the
    request's TokenEvents in order and finally its FinishEvent."""

    def __init__(self, server: "LLMServer", uid: int,
                 params: SamplingParams, tokens_prefix=()):
        self._server = server
        self.uid = uid
        self.params = params
        self.tokens: list[int] = list(tokens_prefix)
        self.finished = False
        self.result: Result | None = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.finished:
            raise StopIteration
        ev = self._server._next_event(self.uid)
        if ev is None:                      # engine drained without finish
            self.finished = True
            raise StopIteration
        if isinstance(ev, TokenEvent):
            self.tokens.append(ev.token)
        else:
            self.finished = True
            self.result = ev.result
            self._server._buffers.pop(self.uid, None)
        return ev

    def drain(self) -> Result:
        """Consume the rest of the stream; returns the final Result."""
        for _ in self:
            pass
        if self.result is None:
            raise RuntimeError(
                f"stream uid={self.uid} ended without a FinishEvent "
                "(engine max_steps exhausted?)")
        return self.result

    def cancel(self) -> Result | None:
        """Abort this generation mid-flight and reclaim what it holds.
        Returns the Result with the tokens emitted so far; None if the
        stream had already finished."""
        if self.finished:
            return None
        self._server.cancel(self.uid)
        for _ in self:
            pass
        return self.result

    def fork(self, params: SamplingParams | None = None
             ) -> "GenerationStream":
        """Branch this in-flight generation under its own sampling
        regime (None inherits); the child shares every page decoded so
        far and its `tokens` starts with the shared generated prefix."""
        if self.finished:
            raise ValueError(f"uid {self.uid} already finished; submit a "
                             "fresh generate() instead of forking")
        slot = self._server._pump_until_decoding(self.uid)
        return self._server._fork(self.uid, params,
                                  tokens_prefix=list(slot.generated))


class LLMServer:
    """One engine, many concurrent token streams.

    `params=None` draws seeded random parameters (`seed`) on the
    server's device.  `device=None` means CUDA and raises without a GPU.
    Engine keyword arguments (`max_batch`, `max_seq`, `page_size`,
    `prefill_chunk`, `prefill_decode_ratio`, ...) pass through.
    `max_steps` bounds the engine ticks over the server's lifetime."""

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 seed: int = 0, max_steps: int = 100_000, **engine_kw):
        device = resolve_device(device)
        if params is None:
            params = registry.get_family(cfg).init(seed, cfg, device)
        self.engine = ServingEngine(cfg, params, device=device, **engine_kw)
        self.max_steps = max_steps
        self._buffers: dict[int, deque] = {}
        self._next_uid = 0

    # ------------------------------------------------------------ public

    def generate(self, prompt, params: SamplingParams | None = None, *,
                 uid: int | None = None) -> GenerationStream:
        """Submit one prompt under its own `SamplingParams` (default:
        greedy) and return its token stream.  Nothing runs until a
        stream is iterated (or `run()` is called)."""
        params = params or SamplingParams()
        uid = self._next_uid if uid is None else uid
        if uid in self._buffers:
            raise ValueError(f"uid {uid} already streaming")
        self._next_uid = max(self._next_uid, uid + 1)
        self._buffers[uid] = deque()
        self.engine.submit(Request(
            uid=uid, prompt=np.asarray(prompt, np.int32), sampling=params))
        return GenerationStream(self, uid, params)

    def cancel(self, uid: int) -> bool:
        """Cancel a stream by uid; its iterator then yields the
        FinishEvent (reason "cancelled") and stops."""
        if not self.engine.cancel(uid):
            return False
        for ev in self.engine.events():
            self._buffers.setdefault(ev.uid, deque()).append(ev)
        return True

    def run(self) -> list[Result]:
        """Drive every submitted request to completion; per-stream events
        stay consumable."""
        while self._pump():
            pass
        return self.engine.results

    @property
    def stats(self) -> dict:
        return self.engine.stats()

    # ---------------------------------------------------------- plumbing

    def _pump(self) -> bool:
        """One engine tick; route its events to per-uid buffers.  False
        when the engine has no work left or `max_steps` is exhausted."""
        if not (self.engine.pending or self.engine.slots):
            return False
        if self.engine.steps >= self.max_steps:
            return False
        self.engine.step()
        for ev in self.engine.events():
            self._buffers.setdefault(ev.uid, deque()).append(ev)
        return True

    def _next_event(self, uid: int):
        buf = self._buffers[uid]
        while not buf:
            if not self._pump():
                return None
        return buf.popleft()

    def _pump_until_decoding(self, uid: int):
        """Tick until `uid` holds a decoding slot (fork needs the prompt
        prefilled); raises if the request already finished."""
        while True:
            slot = next((s for s in self.engine.slots.values()
                         if s.request.uid == uid), None)
            if slot is not None and slot.generated and not slot.prefilling:
                return slot
            if slot is None and not any(r.uid == uid
                                        for r in self.engine.pending):
                raise ValueError(f"uid {uid} is not in flight")
            if not self._pump():
                raise ValueError(f"uid {uid} never reached decode")

    def _fork(self, uid: int, params: SamplingParams | None,
              tokens_prefix) -> GenerationStream:
        new_uid = self._next_uid
        self._next_uid += 1
        self.engine.fork(uid, new_uid, sampling=params)
        self._buffers[new_uid] = deque()
        child = next(s for s in self.engine.slots.values()
                     if s.request.uid == new_uid)
        return GenerationStream(self, new_uid, child.request.sampling,
                                tokens_prefix=tokens_prefix)
