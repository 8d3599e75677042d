"""Async network front over the port's serving engine.

Port of `repro.serve.frontend`: lifts `LLMServer` onto TCP with stdlib
asyncio only — hand-rolled HTTP/1.1 + server-sent events, no new
dependencies, the reference's bytes on the wire:

* `protocol` — the wire schema (submit body, SSE frames, HTTP framing).
* `server`   — `FrontendServer`: engine tick loop on a dedicated
  thread, per-connection streaming, disconnect -> mid-flight cancel
  that frees pages and prefix refs, fanout forks over one socket.
* `client`   — `ServeClient` (asyncio) and `collect()` (sync one-shot).
* `tenants`  — `TenantScheduler`: weighted max-min token-budget shares,
  enforced inside the engine tick (wired via
  `ServingEngine(tenant_weights=...)`).

Tokens over the wire equal in-process serving's: sampling is
counter-derived (serve/sampling.py), so a (prompt, SamplingParams)
pair replays the same stream regardless of transport.
"""
from repro_torch.serve.frontend.client import (RemoteStream, ServeClient,
                                               collect)
from repro_torch.serve.frontend.protocol import (ProtocolError, SSEDecoder,
                                                 Submit, parse_submit,
                                                 sse_encode)
from repro_torch.serve.frontend.server import FrontendServer
from repro_torch.serve.frontend.tenants import TenantScheduler

__all__ = [
    "FrontendServer", "ServeClient", "RemoteStream", "collect",
    "TenantScheduler", "ProtocolError", "SSEDecoder", "Submit",
    "parse_submit", "sse_encode",
]
