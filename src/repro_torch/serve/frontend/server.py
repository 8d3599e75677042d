"""The network serving front: asyncio sockets over the engine tick loop.

Port of `repro.serve.frontend.server`.  `FrontendServer` lifts the
port's `LLMServer` (serve/api.py) onto TCP with two threads and one
bridge:

  * the ENGINE THREAD owns the `LLMServer` exclusively — it drains a
    thread-safe op queue (submit / cancel / stats), ticks the engine
    whenever work is pending, routes each uid's TokenEvent/FinishEvent
    buffer onto its connection's asyncio queue via
    `loop.call_soon_threadsafe`, and performs deferred fanout forks the
    moment the parent sequence reaches decode.  Every kernel launch,
    and every `.cpu()` read of the step's tokens, happens here, on the
    default CUDA stream; token events carry Python ints.

  * the EVENT LOOP (its own thread under `start()`, or the caller's
    under `serve_async()`) speaks HTTP/1.1 + SSE (frontend/protocol.py)
    and never touches a tensor: one connection per generation, frames
    forwarded 1:1 from the bridge queue, a concurrent reader watching
    the request socket so a client disconnect — EOF or reset — is seen
    MID-STREAM and posted back to the engine thread as a cancel op,
    which frees pages and prefix-store refs through the engine's retire
    path (cancel-reclaim latency is one tick, not one token budget).

Scheduling quality is the engine's (serve/engine.py): per-tenant
weighted max-min budget shares (frontend/tenants.py) run INSIDE the
tick; the front only names the tenant on each request.  Tokens over the
wire equal in-process serving's because nothing here touches sampling:
tokens are a function of (prompt, params).

A tick that raises turns into `engine_error` frames on every open
stream and the server keeps serving (the protocol); the failure's
traceback is kept in `tick_errors` for a caller that must not accept
one.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import queue
import threading
import traceback

from repro_torch.serve.api import LLMServer
from repro_torch.serve.engine import FinishEvent, TokenEvent
from repro_torch.serve.frontend import protocol
from repro_torch.serve.frontend.protocol import (ProtocolError, Submit,
                                                 json_response, parse_submit,
                                                 sse_encode,
                                                 sse_response_head)
from repro_torch.utils.logging import get_logger

log = get_logger("frontend")


class _Conn:
    """Bridge state for one generate connection: the asyncio queue its
    handler consumes, and how many of its streams (parent + fanout
    children) are still running."""

    __slots__ = ("queue", "remaining", "uids", "closed")

    def __init__(self, q: asyncio.Queue, remaining: int):
        self.queue = q
        self.remaining = remaining
        self.uids: set[int] = set()
        self.closed = False


class FrontendServer:
    """One engine, many network clients.

    Engine keyword arguments (`device`: CUDA unless "cpu" is named;
    `max_batch`, `max_seq`, `speculate_k`, `prefix_cache`,
    `tenant_weights`, `mesh`, ...) pass through to `LLMServer`.  `start()`
    spawns the engine thread and an event-loop thread, binds (host,
    port) — port 0 picks a free one, read it back from `self.port` —
    and returns; `stop()` tears both down.  For a caller that already
    runs asyncio, `serve_async()` starts the engine thread and serves on
    the current loop instead."""

    def __init__(self, cfg, params=None, *, host: str = "127.0.0.1",
                 port: int = 0, **engine_kw):
        # the network front serves forever: never let LLMServer's
        # batch-mode tick bound end streams mid-flight
        engine_kw.setdefault("max_steps", 1 << 62)
        self.llm = LLMServer(cfg, params, **engine_kw)
        self.host = host
        self.port = port
        self._ops: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._engine_thread: threading.Thread | None = None
        self._loop_thread: threading.Thread | None = None
        # engine-thread state: uid -> (conn, sid); uid -> deferred forks
        self._routes: dict[int, tuple[_Conn, int]] = {}
        self._forks: dict[int, tuple[_Conn, list]] = {}
        self.counters = dict(submitted=0, completed=0, cancelled=0,
                             rejected=0, forks=0)
        self.tick_errors: list[str] = []      # tracebacks of failed ticks

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FrontendServer":
        """Bind and serve on background threads; returns once the port
        is listening (self.port is then the bound port)."""
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="frontend-engine", daemon=True)
        self._engine_thread.start()
        started: "concurrent.futures.Future" = concurrent.futures.Future()

        def runner():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                server = loop.run_until_complete(asyncio.start_server(
                    self._handle_conn, self.host, self.port))
            except OSError as e:
                started.set_exception(e)
                return
            self._server = server
            self.port = server.sockets[0].getsockname()[1]
            started.set_result(None)
            try:
                loop.run_forever()
            finally:
                server.close()
                loop.run_until_complete(server.wait_closed())
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.close()

        self._loop_thread = threading.Thread(
            target=runner, name="frontend-loop", daemon=True)
        self._loop_thread.start()
        started.result(timeout=30)
        log.info("frontend: serving on http://%s:%d", self.host, self.port)
        return self

    async def serve_async(self) -> asyncio.AbstractServer:
        """Serve on the CALLER's event loop (engine thread still spawns);
        await `server.serve_forever()` on the result to block."""
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="frontend-engine", daemon=True)
        self._engine_thread.start()
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("frontend: serving on http://%s:%d", self.host, self.port)
        return self._server

    def stop(self) -> None:
        self._stop.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=10)
        if self._loop is not None and self._loop_thread is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=10)

    # --------------------------------------------------------- engine thread

    def _engine_loop(self) -> None:
        llm = self.llm
        while not self._stop.is_set():
            busy = bool(llm.engine.pending or llm.engine.slots)
            try:
                # block (briefly) only when the engine is idle: ops are
                # the sole source of new work then
                op = (self._ops.get_nowait() if busy
                      else self._ops.get(timeout=0.02))
            except queue.Empty:
                op = None
            while op is not None:
                self._handle_op(op)
                try:
                    op = self._ops.get_nowait()
                except queue.Empty:
                    op = None
            if llm.engine.pending or llm.engine.slots:
                try:
                    llm._pump()
                except Exception:
                    log.exception("frontend: engine tick failed")
                    self.tick_errors.append(traceback.format_exc())
                    self._fail_all("engine_error", "engine tick failed")
                    continue
            self._maybe_fork()
            self._route_events()

    def _handle_op(self, op) -> None:
        kind, payload, fut = op
        try:
            if kind == "submit":
                self._op_submit(payload, fut)
            elif kind == "cancel_conn":
                self._op_cancel_conn(payload)
            elif kind == "cancel_uid":
                ok = self.llm.cancel(int(payload))
                if fut is not None:
                    fut.set_result(ok)
            elif kind == "stats":
                fut.set_result(self._stats())
        except Exception as e:                    # surface, don't kill the
            log.exception("frontend: op %s failed", kind)
            if fut is not None and not fut.done():  # tick thread
                fut.set_exception(e)

    def _op_submit(self, payload, fut) -> None:
        conn, sub = payload
        try:
            stream = self.llm.generate(sub.prompt, sub.params,
                                       tenant=sub.tenant)
        except ValueError as e:
            self.counters["rejected"] += 1
            fut.set_exception(ProtocolError("rejected", str(e)))
            return
        uid = stream.uid
        conn.uids.add(uid)
        self._routes[uid] = (conn, 0)
        if sub.fanout:
            self._forks[uid] = (conn, [(sid + 1, p) for sid, p
                                       in enumerate(sub.fanout)])
        self.counters["submitted"] += 1
        fut.set_result(dict(uid=uid, tenant=sub.tenant))

    def _op_cancel_conn(self, conn: _Conn) -> None:
        """Client went away: cancel every stream still routed to the
        connection and drop the routes (frames would hit a dead socket).
        The engine frees pages + prefix refs via its cancel path."""
        conn.closed = True
        for uid in list(conn.uids):
            if uid in self._forks:
                del self._forks[uid]
            if uid in self._routes:
                del self._routes[uid]
                if self.llm.cancel(uid):
                    self.counters["cancelled"] += 1
                self.llm._buffers.pop(uid, None)
            conn.uids.discard(uid)

    def _maybe_fork(self) -> None:
        """Deferred fanout: fork the parent the moment it holds a
        decoding slot with at least one token (the engine's fork
        precondition).  A full batch retries next tick; a parent that
        finished (or was cancelled) before forking errors the child
        sids out instead."""
        llm = self.llm
        for uid in list(self._forks):
            conn, pending = self._forks[uid]
            slot = next((s for s in llm.engine.slots.values()
                         if s.request.uid == uid and s.generated
                         and not s.prefilling), None)
            if slot is None:
                in_flight = (uid in self._routes
                             or any(r.uid == uid
                                    for r in llm.engine.pending)
                             or any(s.request.uid == uid
                                    for s in llm.engine.slots.values()))
                if not in_flight:
                    for sid, _p in pending:
                        conn.remaining -= 1
                        self._post(conn, ("error", {
                            "sid": sid, "code": "fork_failed",
                            "message": "parent finished before fork"}))
                    self._finish_conn(conn)
                    del self._forks[uid]
                continue
            done = []
            for sid, params in pending:
                try:
                    child = llm._fork(uid, params,
                                      tokens_prefix=list(slot.generated))
                except RuntimeError:
                    break                         # no free slot yet: retry
                conn.uids.add(child.uid)
                self._routes[child.uid] = (conn, sid)
                self.counters["forks"] += 1
                self._post(conn, ("start", {
                    "uid": child.uid, "sid": sid, "schema": protocol.SCHEMA}))
                done.append((sid, params))
            pending = [fp for fp in pending if fp not in done]
            if pending:
                self._forks[uid] = (conn, pending)
            else:
                del self._forks[uid]

    def _route_events(self) -> None:
        """Move each routed uid's buffered engine events onto its
        connection's asyncio queue, translated to wire frames."""
        llm = self.llm
        for uid in list(self._routes):
            buf = llm._buffers.get(uid)
            if not buf:
                continue
            conn, sid = self._routes[uid]
            while buf:
                ev = buf.popleft()
                if isinstance(ev, TokenEvent):
                    self._post(conn, ("token", {"sid": sid, "t": ev.token,
                                                "i": ev.index}))
                elif isinstance(ev, FinishEvent):
                    self._post(conn, ("finish", {
                        "sid": sid, "reason": ev.reason,
                        "tokens": list(ev.result.tokens),
                        "prompt_len": ev.result.prompt_len}))
                    del self._routes[uid]
                    conn.uids.discard(uid)
                    conn.remaining -= 1
                    self.counters["completed"] += 1
                    llm._buffers.pop(uid, None)
                    self._finish_conn(conn)
                    break

    def _finish_conn(self, conn: _Conn) -> None:
        if conn.remaining <= 0 and not conn.closed:
            self._post(conn, ("done", {}))

    def _post(self, conn: _Conn, frame) -> None:
        if conn.closed or self._loop is None:
            return
        try:
            self._loop.call_soon_threadsafe(conn.queue.put_nowait, frame)
        except RuntimeError:
            pass                                  # loop shut down

    def _fail_all(self, code: str, message: str) -> None:
        for uid in list(self._routes):
            conn, sid = self._routes.pop(uid)
            self._post(conn, ("error", {"sid": sid, "code": code,
                                        "message": message}))
            self._post(conn, ("done", {}))
        self._forks.clear()

    def _stats(self) -> dict:
        return {"schema": protocol.SCHEMA,
                "frontend": dict(self.counters,
                                 open_routes=len(self._routes)),
                "engine": self.llm.stats}

    # ------------------------------------------------------------ event loop

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                req = await protocol.read_http_request(reader)
            except ProtocolError as e:
                writer.write(json_response(400, "Bad Request", {
                    "code": e.code, "message": e.message}))
                await writer.drain()
                return
            if req is None:
                return
            if req.method == "POST" and req.path == "/v1/generate":
                await self._handle_generate(req, reader, writer)
            elif req.method == "POST" and req.path == "/v1/cancel":
                await self._handle_cancel(req, writer)
            elif req.method == "GET" and req.path == "/v1/stats":
                await self._handle_stats(writer)
            else:
                writer.write(json_response(404, "Not Found", {
                    "code": "no_route",
                    "message": f"{req.method} {req.path}"}))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _ask_engine(self, kind: str, payload):
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._ops.put((kind, payload, fut))
        return await asyncio.wrap_future(fut)

    async def _handle_stats(self, writer) -> None:
        stats = await self._ask_engine("stats", None)
        writer.write(json_response(200, "OK", stats))
        await writer.drain()

    async def _handle_cancel(self, req, writer) -> None:
        body = req.json()
        uid = body.get("uid")
        if not isinstance(uid, int):
            writer.write(json_response(400, "Bad Request", {
                "code": "bad_request", "message": "cancel needs {'uid': int}"}))
        else:
            ok = await self._ask_engine("cancel_uid", uid)
            writer.write(json_response(200, "OK", {"cancelled": bool(ok)}))
        await writer.drain()

    async def _handle_generate(self, req, reader, writer) -> None:
        try:
            sub: Submit = parse_submit(req.json())
        except ProtocolError as e:
            writer.write(json_response(400, "Bad Request", {
                "code": e.code, "message": e.message}))
            await writer.drain()
            return
        conn = _Conn(asyncio.Queue(), remaining=1 + len(sub.fanout))
        try:
            info = await self._ask_engine("submit", (conn, sub))
        except ProtocolError as e:
            writer.write(json_response(400, "Bad Request", {
                "code": e.code, "message": e.message}))
            await writer.drain()
            return
        writer.write(sse_response_head())
        writer.write(sse_encode("start", {
            "uid": info["uid"], "sid": 0, "tenant": info["tenant"],
            "schema": protocol.SCHEMA}))
        await writer.drain()

        # a second task watches the REQUEST socket: EOF/reset there is
        # the client abandoning the stream — the disconnect signal that
        # must propagate mid-flight
        watcher = asyncio.create_task(self._watch_disconnect(reader))
        aborted = False
        try:
            while True:
                getter = asyncio.create_task(conn.queue.get())
                done, _ = await asyncio.wait(
                    {getter, watcher},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    aborted = True
                    break
                event, data = getter.result()
                if event == "done":
                    break
                writer.write(sse_encode(event, data))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            aborted = True
        finally:
            watcher.cancel()
            if aborted:
                self._ops.put(("cancel_conn", conn, None))

    @staticmethod
    async def _watch_disconnect(reader: asyncio.StreamReader) -> None:
        """Resolve when the peer closes its end (EOF) or resets."""
        try:
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            return
