"""Lightweight asyncio RPC transport for the control/object plane.

Parity target: the reference's gRPC scaffolding (src/ray/rpc/, 6k LoC C++) —
request/response services plus one-way pushes. grpcio is not a baked-in dep of
this image, so the transport is asyncio TCP with length-prefixed pickle5
frames (out-of-band buffers => large tensors are written to the socket without
an extra pickle copy).

Frame layout (everything little-endian):
    [8B total_len][4B nbufs][8B header_len][header pickle][ (8B len, raw)* ]

Counterpart: ray_tpu/_private/rpc.py (copied; unix sockets live under the
temp dir that TMPDIR names).
"""

from __future__ import annotations

import asyncio
import socket
import struct
import threading
import time
import traceback
import weakref
from typing import Awaitable, Callable, Optional

from ray_tpu_torch._private.serialization import dumps_oob, loads_oob

_HDR = struct.Struct("<Q")


# Write-coalescing knobs live in the rtconfig registry like every other
# runtime flag (env RT_RPC_COALESCE / RT_RPC_WBUF_HIGH_BYTES /
# RT_RPC_JOIN_BYTES, or init(_system_config={...}) — the resolved table is
# propagated cluster-wide at registration). Connections cache the values at
# construction; see the README "Transport" section.
from ray_tpu_torch._private.rtconfig import CONFIG as _CONFIG  # noqa: E402


def _set_nodelay(writer) -> None:
    """Assert TCP_NODELAY on TCP sockets. asyncio sets it by default on TCP
    transports, but the coalesced write path depends on it (a batched burst
    must not sit in the Nagle window), so assert it explicitly."""
    try:
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (socket.AF_INET,
                                                socket.AF_INET6):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except Exception:
        pass


# ------------------------------------------------------- fault injection
# Deterministic chaos layer for tests (reference: Ray's testing_asio
# delay/failure injection, src/ray/common/test/testing_asio.h role).
# Connections carry a `label` naming their class ("node" for the
# controller<->agent link, "lease" for worker<->worker lease pipes, ...);
# rules match (label, direction, method) and apply on deterministic frame
# schedules. The transport pays ONE module-global None check per frame when
# injection is off; nothing else changes.


class FaultRule:
    """One injection rule. Frames are counted per rule (under a lock, so
    the schedule is deterministic): the first `after` matching frames pass
    untouched, the next `times` (None = all) get `action` applied.

    Actions: "drop" (frame vanishes; LATER frames still flow), "delay"
    (frame waits `delay_s`), "dup" (frame is delivered twice), "sever" (the
    connection is closed as if the TCP link reset — both sides observe a
    normal close), "hang" (the matched frame — and, per FIFO link
    semantics, everything behind it — is held FOREVER while the socket
    stays healthy: the silent-stall chaos primitive; neither side observes
    a close, calls never resolve)."""

    __slots__ = ("label", "action", "direction", "methods", "after", "times",
                 "delay_s", "match", "hits", "applied")

    def __init__(self, label, action, direction="both", methods=None,
                 after=0, times=None, delay_s=0.0, match=None):
        assert action in ("drop", "delay", "dup", "sever", "hang"), action
        assert direction in ("send", "recv", "both"), direction
        self.label = label
        self.action = action
        self.direction = direction
        self.methods = set(methods) if methods else None
        self.after = after
        self.times = times
        self.delay_s = delay_s
        self.match = match  # optional fn(msg_dict) -> bool
        self.hits = 0      # matching frames seen (before after/times gating)
        self.applied = 0   # frames the action actually hit


class FaultInjector:
    """Registry of live connections + active fault rules (tests only).

    Enable with `enable_fault_injection()` (or RT_FAULT_INJECTION=1 /
    `_system_config={"fault_injection": True}`) BEFORE the connections
    under test are created; disable with `disable_fault_injection()`.
    `stats` counts applied actions so tests can assert the schedule fired.
    """

    def __init__(self):
        self._conns: "weakref.WeakSet" = weakref.WeakSet()
        self._rules: list[FaultRule] = []
        self._lock = threading.Lock()
        self.stats: dict[str, int] = {}

    # -- connection registry ----------------------------------------------
    def track(self, conn) -> None:
        # Connections register from their event-loop threads while tests
        # iterate from the main thread: both sides take the lock.
        with self._lock:
            self._conns.add(conn)

    def connections(self, label: str | None = None) -> list:
        with self._lock:
            conns = list(self._conns)
        return [c for c in conns
                if not c.closed
                and (label is None or getattr(c, "label", None) == label)]

    def sever(self, label: str | None = None, match=None,
              count: int | None = None) -> int:
        """Close matching live connections (a simulated TCP reset): both
        endpoints observe an ordinary connection close. `match` further
        filters on the connection object (e.g. by conn.meta["node_id"]).
        Returns how many connections were severed. Callable from any
        thread — the close is marshalled onto each connection's loop."""
        n = 0
        for conn in self.connections(label):
            if match is not None and not match(conn):
                continue
            self.sever_conn(conn)
            n += 1
            if count is not None and n >= count:
                break
        with self._lock:
            self.stats["sever"] = self.stats.get("sever", 0) + n
        return n

    @staticmethod
    def sever_conn(conn) -> None:
        loop = getattr(conn, "loop", None)
        if loop is not None and loop.is_running():
            asyncio.run_coroutine_threadsafe(conn.close(), loop)
        else:  # not started yet / loop gone: best-effort direct close
            conn.closed = True

    # -- rules -------------------------------------------------------------
    def add_rule(self, label: str | None, action: str, *, direction="both",
                 methods=None, after: int = 0, times: int | None = None,
                 delay_s: float = 0.0, match=None) -> FaultRule:
        rule = FaultRule(label, action, direction, methods, after, times,
                         delay_s, match)
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove_rule(self, rule: FaultRule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self.stats.clear()

    def pick(self, conn, direction: str, msg: dict) -> Optional[FaultRule]:
        """First rule whose filter matches AND whose after/times schedule
        admits this frame. Counting happens under the lock, so a schedule
        like after=2,times=1 hits exactly the third matching frame."""
        if not self._rules:
            return None
        label = getattr(conn, "label", None)
        with self._lock:
            for r in self._rules:
                if r.label is not None and r.label != label:
                    continue
                if r.direction != "both" and r.direction != direction:
                    continue
                if r.methods is not None and msg.get("m") not in r.methods:
                    continue
                if r.match is not None and not r.match(msg):
                    continue
                r.hits += 1
                if r.hits <= r.after:
                    continue
                if r.times is not None and r.applied >= r.times:
                    continue
                r.applied += 1
                self.stats[r.action] = self.stats.get(r.action, 0) + 1
                return r
        return None


_INJECTOR: Optional[FaultInjector] = None


def enable_fault_injection() -> FaultInjector:
    global _INJECTOR
    if _INJECTOR is None:
        _INJECTOR = FaultInjector()
    return _INJECTOR


def disable_fault_injection() -> None:
    global _INJECTOR
    _INJECTOR = None


def fault_injector() -> Optional[FaultInjector]:
    return _INJECTOR


import os as _os  # noqa: E402

if _os.environ.get("RT_FAULT_INJECTION", "").lower() in ("1", "true", "yes"):
    enable_fault_injection()


# ----------------------------------------------------------- flight recorder
# Frame-level hook for the stall watchdog's flight recorder (see
# _private/watchdog.py): records "rpc_send"/"rpc_recv" events with the frame
# method. None (the default) keeps the hot path at exactly one module-global
# check per frame — the same zero-cost-when-off pattern as _INJECTOR.
_FLIGHT = None


def set_flight_hook(fn) -> None:
    global _FLIGHT
    _FLIGHT = fn


# ------------------------------------------------------------- trace hook
# Frame-level hook for the distributed tracing plane (see
# _private/tracing.py): fires ("rpc_send"/"rpc_recv", method) per frame and
# ("rpc_call", method, rtt_seconds) per completed request round trip. None
# (the default — RT_TRACING unset) keeps the hot path at exactly one
# module-global check per frame, the same zero-cost-when-off pattern as
# _INJECTOR and _FLIGHT. The hook itself discards events outside a sampled
# trace context, so an armed-but-unsampled frame costs one contextvar read.
_TRACE = None


def set_trace_hook(fn) -> None:
    global _TRACE
    _TRACE = fn


async def _hang_forever():
    """Park this coroutine permanently (injected 'hang': the frame — and the
    FIFO stream behind it — never moves, but the socket stays open)."""
    await asyncio.Event().wait()


class RpcError(Exception):
    pass


def _log_push_failure(f):
    """Done-callback for fire-and-forget pushes: peer-close races are benign,
    anything else (unpicklable payload, write error) must be surfaced — the
    consumer of the lost message would otherwise just hang."""
    if f.cancelled():
        return
    exc = f.exception()
    if exc is not None and not isinstance(
            exc, (ConnectionClosed, ConnectionResetError, BrokenPipeError)):
        import logging

        logging.getLogger(__name__).warning("fire-and-forget push failed: %r", exc)


class ConnectionClosed(RpcError):
    pass


class RemoteCallError(RpcError):
    def __init__(self, method: str, traceback_str: str):
        self.method = method
        self.traceback_str = traceback_str
        super().__init__(f"RPC {method} failed remotely:\n{traceback_str}")


def _encode(msg: dict) -> list:
    header, buffers = dumps_oob(msg)
    parts = [struct.pack("<IQ", len(buffers), len(header)), header]
    for b in buffers:
        parts.append(struct.pack("<Q", len(b)))
        parts.append(b)
    total = sum(len(p) for p in parts)
    return [_HDR.pack(total), *parts]


async def _read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError) as e:
        raise ConnectionClosed(str(e)) from None


async def _read_msg(reader: asyncio.StreamReader) -> dict:
    (total,) = _HDR.unpack(await _read_exact(reader, 8))
    payload = await _read_exact(reader, total)
    mv = memoryview(payload)
    nbufs, hlen = struct.unpack_from("<IQ", mv, 0)
    off = 12
    header = mv[off : off + hlen]
    off += hlen
    buffers = []
    for _ in range(nbufs):
        (blen,) = struct.unpack_from("<Q", mv, off)
        off += 8
        buffers.append(mv[off : off + blen])
        off += blen
    return loads_oob(bytes(header), buffers)


class Connection:
    """One bidirectional peer link. Both sides can issue requests and pushes."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._next_id = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._wlock = asyncio.Lock()
        # Adaptive frame coalescing (reference: gRPC's writev-style batched
        # stream writes): _write appends encoded frames to _wbuf; ONE
        # flusher per burst writes everything buffered and drains once.
        # Strict per-connection FIFO is preserved (appends happen in _write
        # call order, the single flusher writes in append order).
        self._coalesce = _CONFIG.rpc_coalesce
        self._whigh = _CONFIG.rpc_wbuf_high_bytes
        self._wjoin = _CONFIG.rpc_join_bytes
        self._wbuf: list = []  # bytes/memoryview parts + float delay markers
        self._wbuf_bytes = 0
        self._wflushing = False
        self._wdrain_evt: Optional[asyncio.Event] = None
        self.on_request: Optional[Callable[["Connection", str, dict], Awaitable]] = None
        self.on_push: Optional[Callable[["Connection", str, dict], Awaitable]] = None
        self.on_close: Optional[Callable[["Connection"], None]] = None
        self.closed = False
        self.meta: dict = {}  # server-side: who is this peer (set by register)
        self.label: Optional[str] = None  # fault-injection connection class
        self._read_task: Optional[asyncio.Task] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    def start(self):
        self.loop = asyncio.get_running_loop()
        if _INJECTOR is not None:
            _INJECTOR.track(self)
        self._read_task = asyncio.ensure_future(self._read_loop())

    @property
    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None

    async def _write(self, msg: dict):
        # Fault injection applies to the LOGICAL frame here, before any
        # coalescing: drop removes exactly this frame from the stream, dup
        # enqueues it twice, delay inserts a hold-the-line marker, sever
        # kills the connection (frames already buffered may be lost with it,
        # like a TCP reset).
        repeat, delay = 1, 0.0
        if _FLIGHT is not None:
            _FLIGHT("rpc_send", msg.get("m") or msg["k"])
        if _TRACE is not None:
            _TRACE("rpc_send", msg.get("m") or msg["k"])
        if _INJECTOR is not None:
            rule = _INJECTOR.pick(self, "send", msg)
            if rule is not None:
                if rule.action == "drop":
                    return
                if rule.action == "delay":
                    delay = rule.delay_s
                elif rule.action == "hang":
                    # Infinite delay, NOT a close: the frame (and the FIFO
                    # stream behind it) wedges while the socket stays
                    # healthy — the silent-stall primitive.
                    delay = float("inf")
                elif rule.action == "dup":
                    repeat = 2
                elif rule.action == "sever":
                    try:
                        self.writer.close()
                    except Exception:
                        pass
                    raise ConnectionClosed("fault injection: connection severed")
        parts = _encode(msg)
        if not self._coalesce:
            # Legacy path (RT_RPC_COALESCE=0): one drain per frame.
            async with self._wlock:
                if delay == float("inf"):
                    await _hang_forever()
                if delay:
                    # Sleep INSIDE the write lock: a delayed frame must hold
                    # up younger frames like a slow link would —
                    # per-connection reordering is a fault TCP cannot
                    # produce.
                    await asyncio.sleep(delay)
                for _ in range(repeat):
                    for p in parts:
                        self.writer.write(p)
                await self.writer.drain()
            return
        if self.closed:
            raise ConnectionClosed("connection closed")
        if delay:
            # float() pins the flusher's delay-marker type check even when
            # a rule was built with an int delay_s.
            self._wbuf.append(float(delay))
        n = 0
        for p in parts:
            n += len(p)
        for _ in range(repeat):
            self._wbuf.extend(parts)
        self._wbuf_bytes += n * repeat
        if not self._wflushing:
            self._wflushing = True
            asyncio.ensure_future(self._a_wflush())
        if self._wbuf_bytes >= self._whigh:
            # Backpressure: park until the flusher catches up (the legacy
            # path got the same bound from its per-frame drain).
            while self._wbuf_bytes >= self._whigh and not self.closed:
                if self._wdrain_evt is None:
                    self._wdrain_evt = asyncio.Event()
                self._wdrain_evt.clear()
                await self._wdrain_evt.wait()

    async def _a_wflush(self):
        """Single writer per burst: drains whatever accumulated while the
        previous socket write was in flight — frames buffered by N
        concurrent _write()s ride one write+drain."""
        w = self.writer
        try:
            while True:
                buf = self._wbuf
                if not buf:
                    self._wflushing = False
                    return
                self._wbuf = []
                self._wbuf_bytes = 0
                if self._wdrain_evt is not None:
                    self._wdrain_evt.set()
                small: list = []
                small_n = 0
                for item in buf:
                    if type(item) is float:
                        # Injected delay marker: flush everything older,
                        # then hold the line — younger frames wait behind
                        # the delayed one like on a slow link. An infinite
                        # marker (injected 'hang') parks the flusher for
                        # good with the connection still open.
                        if small:
                            w.write(small[0] if len(small) == 1
                                    else b"".join(small))
                            small, small_n = [], 0
                        await w.drain()
                        if item == float("inf"):
                            await _hang_forever()
                        await asyncio.sleep(item)
                        continue
                    if len(item) <= self._wjoin:
                        small.append(item)
                        small_n += len(item)
                        if small_n >= self._whigh:
                            w.write(b"".join(small))
                            small, small_n = [], 0
                    else:
                        # Large part (zero-copy tensor buffer): write
                        # uncopied, flanked by the joined small parts.
                        if small:
                            w.write(small[0] if len(small) == 1
                                    else b"".join(small))
                            small, small_n = [], 0
                        w.write(item)
                if small:
                    w.write(small[0] if len(small) == 1 else b"".join(small))
                await w.drain()
        except (ConnectionResetError, BrokenPipeError, ConnectionClosed,
                OSError, asyncio.CancelledError):
            pass
        except Exception:
            traceback.print_exc()
        # Write side died under buffered frames: surface via the normal
        # close path and wake writers parked on backpressure.
        self.closed = True
        self._wflushing = False
        self._wbuf.clear()
        self._wbuf_bytes = 0
        if self._wdrain_evt is not None:
            self._wdrain_evt.set()
        try:
            w.close()
        except Exception:
            pass

    async def call(self, method: str, _timeout: float | None = None, **payload):
        # Fail fast on a dead connection: the read loop already rejected
        # and CLEARED _pending, so a future registered now would never
        # resolve — the caller would await forever (observed: a lease
        # request wedging its class's `requesting` flag permanently after
        # a controller restart).
        if self.closed:
            raise ConnectionClosed("connection already closed")
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        tr = _TRACE
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            await self._write({"k": "req", "id": rid, "m": method, "a": payload})
            if self.closed and not fut.done():
                # Raced the close between registration and the write (the
                # reader's sweep may have missed this future).
                raise ConnectionClosed("connection closed during call")
            if _timeout is not None:
                return await asyncio.wait_for(fut, _timeout)
            return await fut
        finally:
            self._pending.pop(rid, None)
            if tr is not None:
                tr("rpc_call", method, time.monotonic() - t0)

    async def call_start(self, method: str, **payload) -> asyncio.Future:
        """Write a request and return the reply future WITHOUT awaiting it.

        Lets a caller serialize request *ordering* (the frame is queued on
        the connection's FIFO write buffer before this returns, and the
        single flusher writes strictly in queue order) while overlapping
        many in-flight replies — the mechanism
        behind ordered-but-pipelined actor calls (reference: sequence numbers
        in core_worker/transport/sequential_actor_submit_queue.h).
        The caller must consume the future (and pop it from _pending on error).
        """
        if self.closed:
            raise ConnectionClosed("connection already closed")
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self._write({"k": "req", "id": rid, "m": method, "a": payload})
        except Exception:
            self._pending.pop(rid, None)
            raise
        if self.closed and not fut.done():
            self._pending.pop(rid, None)
            raise ConnectionClosed("connection closed during call")
        def _done(f, rid=rid):
            self._pending.pop(rid, None)
        fut.add_done_callback(_done)
        return fut

    async def push(self, method: str, **payload):
        await self._write({"k": "push", "m": method, "a": payload})

    def push_threadsafe(self, method: str, **payload):
        """Fire-and-forget push usable from ANY thread. Enqueued onto the
        connection's loop via call_soon_threadsafe, which is FIFO per calling
        thread — so pushes issued before a later call() from the same thread
        are written to the socket first (the ordering the put->submit fast
        path relies on). Saves the ~2 thread handoffs of io.run(push(...))."""
        if self.loop is None:
            raise RpcError("connection not started")
        fut = asyncio.run_coroutine_threadsafe(self.push(method, **payload), self.loop)
        fut.add_done_callback(_log_push_failure)

    async def _handle_request(self, msg: dict):
        rid = msg["id"]
        try:
            if self.on_request is None:
                raise RpcError("no request handler installed")
            value = await self.on_request(self, msg["m"], msg["a"])
            reply = {"k": "rep", "id": rid, "ok": True, "v": value}
        except Exception:
            reply = {"k": "rep", "id": rid, "ok": False, "m": msg["m"], "v": traceback.format_exc()}
        try:
            await self._write(reply)
        except (ConnectionClosed, ConnectionResetError, BrokenPipeError):
            pass

    def _dispatch_msg(self, msg: dict):
        kind = msg["k"]
        if kind == "req":
            asyncio.ensure_future(self._handle_request(msg))
        elif kind == "rep":
            fut = self._pending.get(msg["id"])
            if fut is not None and not fut.done():
                if msg["ok"]:
                    fut.set_result(msg["v"])
                else:
                    fut.set_exception(RemoteCallError(msg.get("m", "?"), msg["v"]))
        elif kind == "push":
            if self.on_push is not None:
                asyncio.ensure_future(self.on_push(self, msg["m"], msg["a"]))

    async def _read_loop(self):
        try:
            while True:
                msg = await _read_msg(self.reader)
                if _FLIGHT is not None:
                    _FLIGHT("rpc_recv", msg.get("m") or msg["k"])
                if _TRACE is not None:
                    _TRACE("rpc_recv", msg.get("m") or msg["k"])
                if _INJECTOR is not None:
                    rule = _INJECTOR.pick(self, "recv", msg)
                    if rule is not None:
                        if rule.action == "drop":
                            continue
                        if rule.action == "hang":
                            # Hold the read loop (and every later frame on
                            # this FIFO link) forever; the socket stays open.
                            await _hang_forever()
                        if rule.action == "delay":
                            await asyncio.sleep(rule.delay_s)
                        elif rule.action == "sever":
                            raise ConnectionClosed(
                                "fault injection: connection severed")
                        elif rule.action == "dup":
                            self._dispatch_msg(msg)
                self._dispatch_msg(msg)
        except (ConnectionClosed, asyncio.CancelledError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            self.closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionClosed("peer went away"))
            self._pending.clear()
            if self._wdrain_evt is not None:
                self._wdrain_evt.set()  # unblock writers parked on backpressure
            try:
                self.writer.close()
            except Exception:
                pass
            if self.on_close is not None:
                try:
                    self.on_close(self)
                except Exception:
                    traceback.print_exc()

    async def close(self):
        if self._read_task is not None:
            self._read_task.cancel()
        # Graceful close drains frames _write already accepted: with
        # coalescing, push() returns once the frame is buffered, so a
        # push-then-close sequence (e.g. a worker's final task_done before
        # disconnect) must not drop the buffered frame. Bounded wait — a
        # dead peer can't hold the close hostage. Best-effort only: the
        # cancelled read task's teardown may set `closed` first and win
        # the race. A caller that NEEDS every buffered frame delivered
        # must ack at the protocol layer before closing (the way
        # PushStreamWriter awaits its s_close reply) — reordering this
        # drain ahead of the cancel leaves the connection half-open for
        # up to 2s, which was observed to race the worker-death path into
        # lost object-fetch wakeups (chaos shuffle test hang).
        if (self._wbuf or self._wflushing) and not self.closed:
            try:
                await asyncio.wait_for(self._a_wait_flushed(), 2.0)
            except Exception:
                pass
        self.closed = True
        self._wbuf.clear()
        self._wbuf_bytes = 0
        if self._wdrain_evt is not None:
            self._wdrain_evt.set()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass

    async def _a_wait_flushed(self):
        while (self._wbuf or self._wflushing) and not self.closed:
            await asyncio.sleep(0.005)


def _uds_dir() -> Optional[str]:
    """Per-user 0700 directory for unix sockets (predictable
    world-writable temp-dir paths would let another local user pre-create a
    socket and serve pickled replies = code execution; reference Ray keeps
    sockets in a per-session user-owned dir). Both the server (create) and the
    client (connect) verify the directory is a non-symlink dir owned by this
    uid with mode 0700 — anything else disables the UDS fast path (TCP-only
    is always correct)."""
    import os
    import stat
    import tempfile

    path = os.path.join(tempfile.gettempdir(), f"rt_uds_{os.geteuid()}")
    try:
        os.mkdir(path, 0o700)
    except FileExistsError:
        pass
    except OSError:
        return None
    try:
        st = os.lstat(path)
    except OSError:
        return None
    if (not stat.S_ISDIR(st.st_mode) or st.st_uid != os.geteuid()
            or stat.S_IMODE(st.st_mode) != 0o700):
        return None
    return path


def _uds_path(port: int) -> Optional[str]:
    d = _uds_dir()
    if d is None:
        return None
    return f"{d}/{port}.sock"


_created_socks: list[str] = []


def cleanup_sockets():
    """Unlink this process's unix-socket files. Registered atexit and called
    from SIGTERM handlers (workers are killed with terminate(), which would
    otherwise strand one socket file per worker in /tmp)."""
    import os

    while _created_socks:
        try:
            os.unlink(_created_socks.pop())
        except OSError:
            pass


import atexit as _atexit  # noqa: E402

_atexit.register(cleanup_sockets)


class RpcServer:
    """TCP server (+ a same-host unix-socket listener on the same logical
    port — loopback TCP costs measurably more per frame than UDS on the
    asyncio hot path); dispatches per-connection requests/pushes to
    handlers."""

    def __init__(
        self,
        on_request: Callable[[Connection, str, dict], Awaitable],
        on_push: Optional[Callable[[Connection, str, dict], Awaitable]] = None,
        on_close: Optional[Callable[[Connection], None]] = None,
        label: str | None = None,
    ):
        self._on_request = on_request
        self._on_push = on_push
        self._on_close = on_close
        # Fault-injection connection class stamped on every ACCEPTED
        # connection: client ends get theirs from connect(label=...), but
        # without this the server side of the same link is unaddressable
        # by FaultInjector rules (e.g. recv-direction drops on a stream
        # hub's inbound frames).
        self._label = label
        self._server: Optional[asyncio.AbstractServer] = None
        self._uds_server: Optional[asyncio.AbstractServer] = None
        self.connections: set = set()
        self.port: int = 0
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._server = await asyncio.start_server(self._accept, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.loop = asyncio.get_running_loop()
        _LOCAL_SERVERS[self.port] = self
        try:
            import os

            path = _uds_path(self.port)
            if path is None:
                raise OSError("no private uds dir")
            if os.path.exists(path):
                os.unlink(path)
            self._uds_server = await asyncio.start_unix_server(self._accept, path)
            os.chmod(path, 0o600)
            _created_socks.append(path)
        except Exception:
            self._uds_server = None  # TCP-only is always correct
        return self.port

    async def _accept(self, reader, writer):
        _set_nodelay(writer)
        conn = Connection(reader, writer)
        conn.label = self._label
        conn.on_request = self._on_request
        conn.on_push = self._on_push
        conn.on_close = self._conn_closed
        self.connections.add(conn)
        conn.start()

    def _conn_closed(self, conn: Connection):
        self.connections.discard(conn)
        if self._on_close is not None:
            self._on_close(conn)

    async def stop(self):
        if _LOCAL_SERVERS.get(self.port) is self:
            del _LOCAL_SERVERS[self.port]
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
        if self._uds_server is not None:
            self._uds_server.close()
            try:
                await self._uds_server.wait_closed()
            except Exception:
                pass
            import os

            path = _uds_path(self.port)
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        for conn in list(self.connections):
            await conn.close()


# port -> RpcServer hosted by THIS process. Lets connect() bypass sockets and
# serialization entirely for same-process peers (driver <-> controller <->
# head agent share one process in local mode — cf. bootstrap.HeadNode). The
# reference gets the same effect from its in-process CoreWorkerMemoryStore and
# direct C++ calls between colocated components.
_LOCAL_SERVERS: dict[int, "RpcServer"] = {}


class LocalConnection:
    """In-process peer link with Connection's API but no sockets/pickling.

    Messages are delivered as live Python objects via call_soon_threadsafe
    (FIFO per sending thread — same ordering contract as a socket write).
    Handlers MUST treat received payloads as read-only, which they already do
    for the RPC path (payloads there are fresh unpickled copies)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop  # loop this endpoint's callbacks run on
        self.peer: Optional["LocalConnection"] = None
        self.on_request: Optional[Callable] = None
        self.on_push: Optional[Callable] = None
        self.on_close: Optional[Callable] = None
        self.closed = False
        self.meta: dict = {}
        self.label: Optional[str] = None  # fault-injection connection class
        # Injected 'hang': once set, every later message is swallowed
        # silently (it is "in the pipe" behind the held frame) while the
        # link still looks healthy — calls simply never resolve.
        self._hung = False
        if _INJECTOR is not None:
            _INJECTOR.track(self)

    @property
    def peername(self):
        return ("local", id(self.peer))

    # -- outgoing ---------------------------------------------------------
    def _deliver(self, kind: str, method: str, payload: dict, reply_to=None):
        peer = self.peer
        if peer is None or peer.closed:
            raise ConnectionClosed("local peer went away")
        if self._hung:
            return  # wedged behind a held frame; link still "healthy"
        if _FLIGHT is not None:
            _FLIGHT("rpc_send", method)
        if _TRACE is not None:
            _TRACE("rpc_send", method)
        if _INJECTOR is not None:
            # The in-process transport has no frames; model the message
            # itself as one (send direction only — there is no reader side).
            rule = _INJECTOR.pick(
                self, "send", {"k": kind, "m": method, "a": payload})
            if rule is not None:
                if rule.action == "drop":
                    if reply_to is not None:
                        loop, fut = reply_to
                        loop.call_soon_threadsafe(
                            _fut_set_exc, fut,
                            ConnectionClosed("fault injection: frame dropped"))
                    return
                if rule.action == "sever":
                    self._close_both()
                    raise ConnectionClosed(
                        "fault injection: connection severed")
                if rule.action == "hang":
                    self._hung = True
                    return  # this frame and everything after it wedge
                if rule.action == "delay":
                    peer.loop.call_soon_threadsafe(
                        peer.loop.call_later, rule.delay_s, peer._dispatch,
                        kind, method, payload, reply_to)
                    return
                if rule.action == "dup":
                    peer.loop.call_soon_threadsafe(
                        peer._dispatch, kind, method, payload, None)
        peer.loop.call_soon_threadsafe(peer._dispatch, kind, method, payload, reply_to)

    async def call(self, method: str, _timeout: float | None = None, **payload):
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        tr = _TRACE
        t0 = time.monotonic() if tr is not None else 0.0
        self._deliver("req", method, payload, (asyncio.get_running_loop(), fut))
        try:
            if _timeout is not None:
                return await asyncio.wait_for(fut, _timeout)
            return await fut
        finally:
            if tr is not None:
                tr("rpc_call", method, time.monotonic() - t0)

    async def call_start(self, method: str, **payload) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._deliver("req", method, payload, (asyncio.get_running_loop(), fut))
        return fut

    async def push(self, method: str, **payload):
        self._deliver("push", method, payload)

    def push_threadsafe(self, method: str, **payload):
        self._deliver("push", method, payload)

    # -- incoming (runs on self.loop) -------------------------------------
    def _dispatch(self, kind: str, method: str, payload: dict, reply_to):
        if self.closed:
            if reply_to is not None:
                loop, fut = reply_to
                loop.call_soon_threadsafe(_fut_set_exc, fut, ConnectionClosed("local peer closed"))
            return
        asyncio.ensure_future(self._run_handler(kind, method, payload, reply_to))

    async def _run_handler(self, kind: str, method: str, payload: dict, reply_to):
        if kind == "push":
            if self.on_push is not None:
                try:
                    await self.on_push(self, method, payload)
                except Exception:
                    traceback.print_exc()
            return
        try:
            if self.on_request is None:
                raise RpcError("no request handler installed")
            value = await self.on_request(self, method, payload)
            err = None
        except Exception:
            value = None
            err = RemoteCallError(method, traceback.format_exc())
        if reply_to is None:
            return  # fault-injected duplicate of a request: reply discarded
        loop, fut = reply_to
        if err is None:
            loop.call_soon_threadsafe(_fut_set_result, fut, value)
        else:
            loop.call_soon_threadsafe(_fut_set_exc, fut, err)

    async def close(self):
        self._close_both()

    def _close_both(self):
        for end in (self, self.peer):
            if end is None or end.closed:
                continue
            end.closed = True
            if end.on_close is not None:
                end.loop.call_soon_threadsafe(_safe_on_close, end)


def _fut_set_result(fut, value):
    if not fut.done():
        fut.set_result(value)


def _fut_set_exc(fut, err):
    if not fut.done():
        fut.set_exception(err)


def _safe_on_close(end):
    try:
        end.on_close(end)
    except Exception:
        traceback.print_exc()


async def connect(
    host: str,
    port: int,
    on_request=None,
    on_push=None,
    on_close=None,
    timeout: float = 30.0,
    label: str | None = None,
) -> Connection:
    server = _LOCAL_SERVERS.get(port) if host in ("127.0.0.1", "localhost") else None
    if server is not None and server.loop is not None:
        client = LocalConnection(asyncio.get_running_loop())
        serv_end = LocalConnection(server.loop)
        client.peer, serv_end.peer = serv_end, client
        client.label = label
        client.on_request, client.on_push, client.on_close = on_request, on_push, on_close
        serv_end.label = server._label
        serv_end.on_request = server._on_request
        serv_end.on_push = server._on_push
        serv_end.on_close = server._conn_closed
        server.connections.add(serv_end)
        return client
    reader = writer = None
    if host in ("127.0.0.1", "localhost"):
        import os

        path = _uds_path(port)
        if path is not None and os.path.exists(path):
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(path), timeout)
            except Exception:
                reader = writer = None  # fall back to TCP
    if reader is None:
        reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
        _set_nodelay(writer)
    conn = Connection(reader, writer)
    conn.label = label
    conn.on_request = on_request
    conn.on_push = on_push
    conn.on_close = on_close
    conn.start()
    return conn


class EventLoopThread:
    """A dedicated asyncio loop in a daemon thread; sync code bridges via run().

    Parity note: plays the role of the reference's per-process asio io_service
    (src/ray/common/asio/) — all network IO for a process funnels through one
    event loop while user code stays synchronous.
    """

    def __init__(self, name: str = "rt-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()

    def run(self, coro, timeout: float | None = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        def _cancel_all():
            for t in asyncio.all_tasks(self.loop):
                t.cancel()
            self.loop.call_soon(self.loop.stop)

        try:
            self.loop.call_soon_threadsafe(_cancel_all)
            self._thread.join(timeout=2.0)
        except Exception:
            pass
