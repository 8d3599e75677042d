"""Wire protocol for the network serving front (schema version 1).

Stdlib only: hand-rolled HTTP/1.1 framing + server-sent events (SSE) —
no new dependencies, and every byte on the wire is visible in this one
module.  The engine's TokenEvent/FinishEvent stream maps 1:1 onto SSE
frames; nothing is batched, re-ordered or summarized in flight.

HTTP surface (see frontend/server.py):

    POST /v1/generate     submit; response is an SSE stream
    POST /v1/cancel       {"uid": N} — explicit mid-flight cancel
    GET  /v1/stats        engine + frontend counters as JSON

Submit body (JSON)::

    {"prompt": [int, ...],                  # token ids
     "tenant": "name",                      # optional, default "default"
     "params": {...},                       # optional SamplingParams.to_wire
     "fanout": [{...}, ...]}                # optional: fork the stream
                                            # under extra sampling regimes

`params` carries the FULL SamplingParams schema — temperature / top_k /
top_p / seed / max_new_tokens / stop / speculative — so a request can
pin itself to plain decode (speculative=false) or opt into anything an
in-process caller could.  `fanout` lists additional SamplingParams:
once the prompt is prefilled and the first token decoded, the server
forks the sequence through the engine's COW page fork, and every stream
(parent sid 0, children sid 1..n) multiplexes over the SAME SSE
connection, tagged by `sid`.

SSE frames (server -> client), in `event:`/`data:` framing, data JSON::

    start   {"uid": N, "sid": 0, "tenant": t, "schema": 1}
    token   {"sid": S, "t": token, "i": emission_index}
    finish  {"sid": S, "reason": "length|stop|cancelled",
             "tokens": [...], "prompt_len": N}
    error   {"sid": S | null, "code": str, "message": str}

The response uses `Connection: close` (EOF-delimited body) — the
simplest legal HTTP/1.1 streaming framing, and exactly what makes
client disconnect DETECTABLE: the server watches the request socket for
EOF and propagates it as a mid-flight cancel that frees pages and
prefix-store refs through the engine's retire path.
"""
from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.sampling import SamplingParams

SCHEMA = 1
MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 16 * 1024 * 1024


class ProtocolError(ValueError):
    """Malformed request or frame; carries a wire-level error code."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


# ------------------------------------------------------------------ submit

@dataclass
class Submit:
    """Validated submit request (the server-side view)."""
    prompt: np.ndarray                        # (plen,) int32
    tenant: str = "default"
    params: SamplingParams = field(default_factory=SamplingParams)
    fanout: list[SamplingParams] = field(default_factory=list)

    def to_wire(self) -> dict:
        out = {"prompt": [int(t) for t in self.prompt],
               "tenant": self.tenant, "params": self.params.to_wire()}
        if self.fanout:
            out["fanout"] = [p.to_wire() for p in self.fanout]
        return out


def parse_submit(body: dict) -> Submit:
    """Validate a submit body.  Strict: unknown top-level keys and
    malformed fields raise ProtocolError rather than being ignored —
    a silently-dropped knob would produce a stream the client did not
    ask for."""
    if not isinstance(body, dict):
        raise ProtocolError("bad_request", "submit body must be a JSON object")
    unknown = set(body) - {"prompt", "tenant", "params", "fanout"}
    if unknown:
        raise ProtocolError("bad_request",
                            f"unknown submit fields: {sorted(unknown)}")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ProtocolError("bad_request",
                            "prompt must be a non-empty list of token ids")
    tenant = body.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant or len(tenant) > 256:
        raise ProtocolError("bad_request", "tenant must be a short string")
    try:
        params = SamplingParams.from_wire(body.get("params", {}))
        fanout = [SamplingParams.from_wire(p)
                  for p in body.get("fanout", [])]
    except ValueError as e:
        raise ProtocolError("bad_params", str(e)) from None
    if len(fanout) > 8:
        raise ProtocolError("bad_request", "fanout limited to 8 children")
    return Submit(prompt=np.asarray(prompt, np.int32), tenant=tenant,
                  params=params, fanout=fanout)


# --------------------------------------------------------------- SSE frames

def sse_encode(event: str, data: dict) -> bytes:
    """One SSE frame: event name + single-line JSON payload."""
    payload = json.dumps(data, separators=(",", ":"), default=int)
    return f"event: {event}\ndata: {payload}\n\n".encode()


class SSEDecoder:
    """Incremental SSE parser: feed() raw bytes (any chunking), get back
    completed (event, data) pairs.  Tolerates \\r\\n line endings and
    ignores comment/heartbeat lines per the SSE spec."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes) -> list[tuple[str, dict]]:
        self._buf += chunk
        out = []
        while True:
            # frame boundary: blank line (either line-ending convention)
            cut = None
            for sep in (b"\n\n", b"\r\n\r\n"):
                j = self._buf.find(sep)
                if j != -1 and (cut is None or j < cut[0]):
                    cut = (j, len(sep))
            if cut is None:
                return out
            raw, self._buf = self._buf[:cut[0]], self._buf[cut[0] + cut[1]:]
            event, datas = "message", []
            for line in raw.decode("utf-8", "replace").splitlines():
                if line.startswith(":"):
                    continue                       # heartbeat/comment
                key, _, val = line.partition(":")
                val = val[1:] if val.startswith(" ") else val
                if key == "event":
                    event = val
                elif key == "data":
                    datas.append(val)
            if not datas:
                continue
            try:
                out.append((event, json.loads("\n".join(datas))))
            except json.JSONDecodeError as e:
                raise ProtocolError("bad_frame",
                                    f"undecodable SSE data: {e}") from None


# ------------------------------------------------------------- HTTP framing

@dataclass
class HTTPRequest:
    method: str
    path: str
    headers: dict[str, str]
    body: bytes

    def json(self) -> dict:
        try:
            return json.loads(self.body or b"{}")
        except json.JSONDecodeError as e:
            raise ProtocolError("bad_json", f"request body: {e}") from None


async def read_http_request(reader) -> HTTPRequest | None:
    """Parse one HTTP/1.1 request from an asyncio StreamReader.  Returns
    None on a clean EOF before any bytes (client opened and closed).
    Body framing: Content-Length only (no chunked uploads — submit
    bodies are small)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError("bad_http", "truncated request head") from None
    except asyncio.LimitOverrunError:
        raise ProtocolError("bad_http", "request head too large") from None
    if len(head) > MAX_HEADER_BYTES:
        raise ProtocolError("bad_http", "request head too large")
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise ProtocolError("bad_http",
                            f"malformed request line: {lines[0]!r}") from None
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length < 0 or length > MAX_BODY_BYTES:
        raise ProtocolError("bad_http", f"bad content-length {length}")
    body = await reader.readexactly(length) if length else b""
    return HTTPRequest(method=method, path=path, headers=headers, body=body)


def http_response(status: int, reason: str, content_type: str,
                  body: bytes = b"", *, close: bool = True,
                  stream: bool = False) -> bytes:
    """Response head (+ body unless streaming).  Streaming responses
    (`stream=True`) are EOF-delimited: Connection: close, no
    Content-Length — the SSE framing above delimits the events."""
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            "Cache-Control: no-store"]
    if stream:
        head.append("Connection: close")
    else:
        head.append(f"Content-Length: {len(body)}")
        head.append("Connection: close" if close else "Connection: keep-alive")
    out = ("\r\n".join(head) + "\r\n\r\n").encode()
    return out + (b"" if stream else body)


def json_response(status: int, reason: str, obj: dict) -> bytes:
    return http_response(status, reason, "application/json",
                         json.dumps(obj, default=str).encode() + b"\n")


def sse_response_head() -> bytes:
    return http_response(200, "OK", "text/event-stream", stream=True)
