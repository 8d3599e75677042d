"""Client for the network serving front (frontend/server.py).

Two surfaces over the same wire protocol (frontend/protocol.py):

* `ServeClient` — asyncio.  `submit()` opens one POST /v1/generate
  connection and returns a `RemoteStream`: an async iterator of
  (event, data) wire frames, with `abort()` to drop the socket
  mid-flight (the server detects the EOF and cancels the generation,
  freeing its pages).  `cancel(uid)` / `stats()` hit the side
  endpoints.

* `collect(...)` — one-call sync wrapper: runs a submit on a private
  event loop and returns the per-sid token lists + finish reasons.
  This is what examples/ and tests use when they don't need
  concurrency.

Stdlib only (asyncio + the repo's own SSE decoder) — a client needs
nothing beyond the Python that runs the server.
"""
from __future__ import annotations

import asyncio
import json

from repro_torch.serve.frontend.protocol import (MAX_HEADER_BYTES,
                                                 ProtocolError, SSEDecoder)
from repro_torch.serve.sampling import SamplingParams


def _encode_post(path: str, host: str, body: dict) -> bytes:
    payload = json.dumps(body).encode()
    return (f"POST {path} HTTP/1.1\r\n"
            f"Host: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n").encode() + payload


async def _read_response_head(reader: asyncio.StreamReader
                              ) -> tuple[int, dict[str, str]]:
    head = await reader.readuntil(b"\r\n\r\n")
    if len(head) > MAX_HEADER_BYTES:
        raise ProtocolError("bad_http", "response head too large")
    lines = head.decode("latin-1").split("\r\n")
    try:
        _version, status, _reason = lines[0].split(" ", 2)
    except ValueError:
        raise ProtocolError("bad_http",
                            f"malformed status line: {lines[0]!r}") from None
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if line:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
    return int(status), headers


class RemoteStream:
    """One in-flight generation: async-iterate to get (event, data)
    frames in wire order ("start", "token", "finish", "error"); the
    iterator ends when every sid of the submit has finished.  `uid` is
    available after the first frame.  `abort()` closes the socket —
    the server-side disconnect path then cancels the generation."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._decoder = SSEDecoder()
        self._frames: list[tuple[str, dict]] = []
        self._eof = False
        self.uid: int | None = None
        self.aborted = False

    def __aiter__(self):
        return self

    async def __anext__(self) -> tuple[str, dict]:
        while not self._frames:
            if self._eof:
                raise StopAsyncIteration
            chunk = await self._reader.read(65536)
            if not chunk:
                self._eof = True
                continue
            self._frames.extend(self._decoder.feed(chunk))
        event, data = self._frames.pop(0)
        if event == "start" and data.get("sid") == 0:
            self.uid = data.get("uid")
        return event, data

    async def abort(self) -> None:
        """Drop the connection mid-flight (simulates a client crash —
        the cancel signal is the TCP EOF itself, no frame is sent)."""
        self.aborted = True
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        self._eof = True


class ServeClient:
    """Async client bound to one frontend (host, port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8400):
        self.host = host
        self.port = port

    async def submit(self, prompt, params: SamplingParams | None = None, *,
                     tenant: str = "default",
                     fanout: list[SamplingParams] | None = None
                     ) -> RemoteStream:
        """Open a generation stream.  Raises ProtocolError if the server
        rejects the submit (error JSON instead of an SSE stream)."""
        body: dict = {"prompt": [int(t) for t in prompt], "tenant": tenant,
                      "params": (params or SamplingParams()).to_wire()}
        if fanout:
            body["fanout"] = [p.to_wire() for p in fanout]
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.write(_encode_post("/v1/generate", self.host, body))
        await writer.drain()
        status, headers = await _read_response_head(reader)
        if status != 200:
            err = await self._read_json_body(reader, headers)
            writer.close()
            raise ProtocolError(err.get("code", "error"),
                                err.get("message", f"HTTP {status}"))
        return RemoteStream(reader, writer)

    async def cancel(self, uid: int) -> bool:
        obj = await self._call("/v1/cancel", {"uid": int(uid)})
        return bool(obj.get("cancelled"))

    async def stats(self) -> dict:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.write((f"GET /v1/stats HTTP/1.1\r\nHost: {self.host}\r\n"
                      "Connection: close\r\n\r\n").encode())
        await writer.drain()
        _status, headers = await _read_response_head(reader)
        obj = await self._read_json_body(reader, headers)
        writer.close()
        return obj

    async def _call(self, path: str, body: dict) -> dict:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.write(_encode_post(path, self.host, body))
        await writer.drain()
        _status, headers = await _read_response_head(reader)
        obj = await self._read_json_body(reader, headers)
        writer.close()
        return obj

    @staticmethod
    async def _read_json_body(reader, headers) -> dict:
        length = int(headers.get("content-length", "0") or "0")
        body = (await reader.readexactly(length) if length
                else await reader.read())
        try:
            return json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise ProtocolError("bad_json", f"response body: {e}") from None


def collect(host: str, port: int, prompt,
            params: SamplingParams | None = None, *,
            tenant: str = "default",
            fanout: list[SamplingParams] | None = None) -> dict:
    """Synchronous one-shot: submit, drain the stream, return
    `{"uid": N, "streams": {sid: {"tokens": [...], "reason": str}}}`.
    Tokens per sid arrive in emission order; for sid 0 the list is
    exactly what `LLMServer.generate(...).drain()` would produce."""

    async def go():
        client = ServeClient(host, port)
        stream = await client.submit(prompt, params, tenant=tenant,
                                     fanout=fanout)
        streams: dict[int, dict] = {}
        async for event, data in stream:
            sid = data.get("sid")
            if event == "token":
                streams.setdefault(sid, {"tokens": [], "reason": None})
                streams[sid]["tokens"].append(data["t"])
            elif event == "finish":
                streams.setdefault(sid, {"tokens": [], "reason": None})
                streams[sid]["reason"] = data["reason"]
                streams[sid]["final_tokens"] = data["tokens"]
            elif event == "error":
                raise ProtocolError(data.get("code", "error"),
                                    data.get("message", ""))
        return {"uid": stream.uid, "streams": streams}

    return asyncio.run(go())
