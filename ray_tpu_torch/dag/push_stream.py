"""Push-stream: the StreamRing record contract generalized onto rpc.

README "Cross-host streaming & multi-proxy": a replica on another host
cannot attach the proxy's /dev/shm StreamRing, and before this module
existed it nakked the handshake and degraded to the per-item classic
reply path — one ObjectRef round trip per token batch. The push-stream
keeps the ring's contract (variable-length pickled records, bounded
producer-side buffering, batch-per-wakeup consumer drains, RingClosed at
end-of-stream) but carries the records over the rpc transport:

- **producer** (`PushStreamWriter`, replica side): `write(value,
  timeout)` appends a record to a bounded send window; a dedicated flush
  task coalesces every record buffered since the last flush into ONE
  `s_data` frame (the rpc write-coalescing idiom, one level up the
  stack). The window is credit-based: at most `window` un-acked record
  bytes may be in flight, and a stalled consumer parks the writer —
  bounded buffering, never unbounded queueing, exactly like a full ring.
- **consumer** (`PushStreamHub` + `PushStreamReader`, proxy side): one
  rpc server per proxy process; frames route by stream id to a reader
  whose `read_batch(timeout)` drains every buffered record in one wakeup
  and credits the drained bytes back to the producer.

Fault attribution: frames carry per-stream sequence numbers, so a
duplicated frame is discarded (byte-identical outcome) and a dropped
frame is detected as a gap and surfaces as `StreamSevered` (attributed
outcome) — never silent corruption. A severed connection (replica death,
injected sever) also raises `StreamSevered` on the reader and wakes any
parked writer. The FaultInjector sees these connections under the
label "stream".

Counterpart: ray_tpu/dag/push_stream.py (copied).
"""

from __future__ import annotations

import asyncio
import pickle
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch.dag.stream import RingClosed

#: FaultInjector connection class for every push-stream link.
STREAM_LABEL = "stream"


class StreamSevered(Exception):
    """The stream link was lost (connection closed or a frame gap was
    detected) before the producer's end-of-stream record arrived."""


def _mint(records: int, nbytes: int) -> None:
    """Producer-side metric mints (counters ride the existing flusher)."""
    try:
        from ray_tpu_torch.util import metrics as _m

        _m.STREAM_PUSH_RECORDS.inc(records)
        _m.STREAM_PUSH_BYTES.inc(nbytes)
    except Exception:
        pass


def _mint_park() -> None:
    try:
        from ray_tpu_torch.util import metrics as _m

        _m.STREAM_PUSH_PARKS.inc(1)
    except Exception:
        pass


# --------------------------------------------------------------- consumer
class PushStreamReader:
    """Consumer end of one push-stream: the proxy's drain loop calls
    `read_batch` from an executor thread (same calling convention as
    StreamRing.read_batch), frames arrive on the hub's event loop."""

    def __init__(self, hub: "PushStreamHub", stream_id: str, window: int):
        self._hub = hub
        self.stream_id = stream_id
        self.window = window
        self._recs: deque = deque()  # (blob_len, value)
        self._cond = threading.Condition()
        self._conn = None  # producer's connection, set at s_open
        self._expect_seq = 0
        self._closed = False  # producer sent s_close (clean end)
        self._severed: Optional[str] = None  # link lost / frame gap

    # -- hub side (event-loop thread) -------------------------------------
    def _on_open(self, conn) -> None:
        with self._cond:
            self._conn = conn
            self._cond.notify_all()

    def _on_data(self, seq: int, blobs: list) -> None:
        with self._cond:
            if self._severed is not None:
                return  # stream already attributed dead: drop strays
            # NOTE: records arriving around s_close are NOT dropped — the
            # reader raises RingClosed only once everything is drained.
            if seq < self._expect_seq:
                return  # duplicated frame (injected dup / resend): discard
            if seq > self._expect_seq:
                # A frame was lost on the wire: the byte stream can no
                # longer be reproduced — attribute, never silently skip.
                self._severed = (f"push-stream frame gap (expected seq "
                                 f"{self._expect_seq}, got {seq})")
                self._cond.notify_all()
                return
            self._expect_seq += 1
            for b in blobs:
                self._recs.append((len(b), pickle.loads(b)))
            self._cond.notify_all()

    def _on_close_conn(self) -> None:
        with self._cond:
            if not self._closed and self._severed is None:
                self._severed = "push-stream connection severed"
            self._cond.notify_all()

    def _on_stream_close(self, seq: Optional[int] = None) -> None:
        with self._cond:
            if (seq is not None and seq != self._expect_seq
                    and self._severed is None):
                # s_close carries the producer's final frame count: a tail
                # frame lost on the wire has no successor to expose its
                # gap, so the close record is what catches it — silent
                # truncation is never a clean end.
                self._severed = (f"push-stream lost tail frames (expected "
                                 f"seq {self._expect_seq}, producer sent "
                                 f"{seq})")
            self._closed = True
            self._cond.notify_all()

    # -- proxy side (executor thread) -------------------------------------
    def read_batch(self, timeout: float | None = None,
                   max_bytes: int | None = None) -> list:
        """Block until at least one record arrived, then return every
        buffered record (one wakeup drains the burst) and credit the
        drained bytes back to the producer. Raises TimeoutError when
        nothing arrives in time, RingClosed once the producer closed and
        everything is drained, StreamSevered on a lost link/frame."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while not self._recs:
                if self._severed is not None:
                    raise StreamSevered(self._severed)
                if self._closed:
                    raise RingClosed("push stream closed and drained")
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError("push stream read timed out")
                self._cond.wait(timeout=left)
            out = []
            drained = 0
            budget = max_bytes if max_bytes is not None else float("inf")
            while self._recs and drained < budget:
                n, v = self._recs.popleft()
                out.append(v)
                drained += n
            conn = self._conn
        # Credit OUTSIDE the lock: push_threadsafe marshals onto the hub
        # loop and must not run under the reader condition.
        if conn is not None and drained:
            try:
                conn.push_threadsafe("s_credit", sid=self.stream_id,
                                     n=drained)
            except Exception:
                pass  # producer gone: its own close path handles it
        return out

    def close(self, unlink: bool = False) -> None:
        """Unregister from the hub (signature mirrors StreamRing.close so
        proxy teardown code treats both transports alike)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._hub._readers.pop(self.stream_id, None)


class PushStreamHub:
    """Per-process stream acceptor: ONE rpc server per proxy process;
    every producer frame routes by stream id to its reader. Create with
    `await PushStreamHub.ensure(...)` from the proxy's event loop."""

    def __init__(self):
        self.host = "127.0.0.1"
        self.port = 0
        self._server = None
        self._readers: dict[str, PushStreamReader] = {}

    async def start(self, host: str = "127.0.0.1") -> int:
        from ray_tpu_torch._private.rpc import RpcServer

        self.host = host
        self._server = RpcServer(self._on_request, on_push=self._on_push,
                                 on_close=self._on_conn_close,
                                 label=STREAM_LABEL)
        self.port = await self._server.start(host, 0)
        return self.port

    def open(self, stream_id: str, window: int) -> PushStreamReader:
        r = PushStreamReader(self, stream_id, window)
        self._readers[stream_id] = r
        return r

    def spec(self, stream_id: str, window: int) -> dict:
        """Wire form the producer connects back with (rides the stream
        handshake next to the shm ring spec)."""
        return {"host": self.host, "port": self.port,
                "stream_id": stream_id, "window": int(window)}

    async def _on_request(self, conn, method: str, a: dict):
        if method == "s_open":
            r = self._readers.get(a["sid"])
            if r is None:
                return {"ok": False}
            r._on_open(conn)
            return {"ok": True}
        if method == "s_close":
            # End-of-stream is a CALL, not a push: the reply acks that the
            # hub processed it — and, by per-connection FIFO, every s_data
            # frame before it. Without the ack the producer's socket close
            # races its own tail bytes: an unread s_credit in the
            # producer's receive buffer turns close() into an RST, and RST
            # makes the consumer's kernel DISCARD received-but-unread
            # data — the last frames of a cleanly-drained stream.
            r = self._readers.get(a.get("sid"))
            if r is not None:
                r._on_stream_close(a.get("seq"))
            return {"ok": r is not None}
        raise ValueError(f"unknown stream method {method!r}")

    async def _on_push(self, conn, method: str, a: dict):
        r = self._readers.get(a.get("sid"))
        if r is None:
            return
        if method == "s_data":
            r._on_data(a["seq"], a["recs"])

    def _on_conn_close(self, conn) -> None:
        # One producer connection per stream: a close before s_close means
        # the producer process (or the link) died mid-stream. Pushed
        # frames are dispatched as queued tasks while this callback runs
        # inline from the read loop's teardown — when s_close and EOF
        # arrive in the same segment (a graceful producer close) the
        # close callback would overtake the s_close task still sitting in
        # the ready queue, severing a cleanly-ended stream. Queue the
        # sever BEHIND those tasks; _on_close_conn is a no-op once the
        # reader saw s_close.
        def _sever():
            for r in list(self._readers.values()):
                if r._conn is conn:
                    r._on_close_conn()

        try:
            asyncio.get_running_loop().call_soon(_sever)
        except RuntimeError:
            _sever()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None
        for r in list(self._readers.values()):
            r._on_close_conn()
        self._readers.clear()


# --------------------------------------------------------------- producer
_IO = None
_IO_LOCK = threading.Lock()


def _io():
    """Shared per-process event-loop thread for producer connections (one
    loop carries every outbound stream, like the reference's per-process
    io_service)."""
    global _IO
    with _IO_LOCK:
        if _IO is None:
            from ray_tpu_torch._private.rpc import EventLoopThread

            _IO = EventLoopThread(name="rt-stream-io")
        return _IO


class PushStreamWriter:
    """Producer end: StreamRing's write/close calling convention (sync,
    callable from the replica's pump threads) over an rpc connection.

    Records buffer locally and a loop-side flusher sends everything
    buffered since its last run as ONE s_data frame — a burst of writes
    while a flush is in flight coalesces into the next single frame.
    Credit accounting bounds un-acked bytes at `window`; when the buffer
    alone reaches the window the writer PARKS in write() until the
    consumer drains (or the timeout trips), so a stalled consumer can
    never make the producer buffer unboundedly.
    """

    def __init__(self, spec: dict, connect_timeout: float = 10.0):
        from ray_tpu_torch._private import rpc as _rpc

        self.stream_id = spec["stream_id"]
        self.window = int(spec["window"])
        self._credit = self.window
        self._pending: list[bytes] = []
        self._pending_bytes = 0
        self._seq = 0
        self._inflight = 0  # s_data pushes not yet buffered on the wire
        self._severed: Optional[str] = None
        self._closed = False
        self._flush_scheduled = False
        self._cond = threading.Condition()
        io = _io()
        self._loop = io.loop
        self._conn = io.run(
            _rpc.connect(spec["host"], int(spec["port"]),
                         on_push=self._on_push, on_close=self._on_close,
                         timeout=connect_timeout, label=STREAM_LABEL),
            timeout=connect_timeout + 5)
        rep = io.run(self._conn.call("s_open", sid=self.stream_id,
                                     _timeout=connect_timeout),
                     timeout=connect_timeout + 5)
        if not (isinstance(rep, dict) and rep.get("ok")):
            io.run(self._conn.close(), timeout=5)
            raise ConnectionError(
                f"stream hub refused stream {self.stream_id!r}")

    # -- event-loop side ---------------------------------------------------
    async def _on_push(self, conn, method: str, a: dict):
        if method == "s_credit" and a.get("sid") == self.stream_id:
            with self._cond:
                self._credit += int(a["n"])
                self._cond.notify_all()
            self._flush_on_loop()

    def _on_close(self, conn) -> None:
        with self._cond:
            if self._severed is None:
                self._severed = "push-stream connection severed"
            self._cond.notify_all()

    def _flush_on_loop(self) -> None:
        """Runs on the IO loop: drain as much of the pending buffer as
        credit allows into ONE frame. Blobs ride the rpc frame's raw
        buffer lanes (no re-pickling of already-pickled records)."""
        with self._cond:
            self._flush_scheduled = False
            if (self._severed is not None or not self._pending
                    or self._credit <= 0):
                return
            take: list[bytes] = []
            taken = 0
            while self._pending and taken < self._credit:
                b = self._pending[0]
                if take and taken + len(b) > self._credit:
                    break  # next record exceeds credit: next frame
                take.append(self._pending.pop(0))
                taken += len(b)
            self._pending_bytes -= taken
            self._credit -= taken
            seq = self._seq
            self._seq += 1
            self._inflight += 1
            self._cond.notify_all()  # buffer shrank: unpark writers
        try:
            coro = self._conn.push("s_data", sid=self.stream_id, seq=seq,
                                   recs=take)
            asyncio.ensure_future(self._guard(coro))
        except Exception:
            self._guard_done()
            self._on_close(self._conn)
        _mint(len(take), taken)

    async def _guard(self, coro):
        try:
            await coro
        except Exception:
            self._on_close(self._conn)
        finally:
            self._guard_done()

    def _guard_done(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()  # close() waits for inflight == 0

    def _schedule_flush(self) -> None:
        with self._cond:
            if self._flush_scheduled:
                return  # records accreting behind a scheduled flush
            self._flush_scheduled = True
        self._loop.call_soon_threadsafe(self._flush_on_loop)

    # -- pump-thread side --------------------------------------------------
    def write(self, value, timeout: float | None = None) -> None:
        """Append one record; parks while the send window is exhausted
        (consumer backpressure). Raises TimeoutError on a stalled
        consumer, ValueError on a record too large to ever fit,
        StreamSevered on a lost link, RingClosed after close()."""
        blob = pickle.dumps(value, protocol=5)
        if len(blob) > self.window // 2:
            raise ValueError(
                f"record {len(blob)}B exceeds push-stream record cap "
                f"({self.window // 2}B for a {self.window}B window)")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            if self._closed:
                raise RingClosed("push stream is closed for writing")
            parked = False
            while self._pending_bytes + len(blob) > self.window:
                if self._severed is not None:
                    raise StreamSevered(self._severed)
                if not parked:
                    parked = True
                    _mint_park()
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError(
                        "push stream write timed out (consumer stalled)")
                self._cond.wait(timeout=left)
            if self._severed is not None:
                raise StreamSevered(self._severed)
            self._pending.append(blob)
            self._pending_bytes += len(blob)
        self._schedule_flush()

    def close(self, unlink: bool = False) -> None:
        """Flush what remains, send end-of-stream, drop the connection.
        Sync and idempotent; signature mirrors StreamRing.close so the
        replica's teardown treats both transports alike."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
        self._schedule_flush()
        # Wait until the tail frames are BUFFERED ON THE WIRE (inflight
        # counts push() coroutines not yet completed), not merely popped
        # from _pending — otherwise the s_close below could overtake the
        # final s_data frame and the consumer would drop the last burst.
        deadline = time.monotonic() + 5.0
        with self._cond:
            while ((self._pending or self._inflight)
                   and self._severed is None
                   and time.monotonic() < deadline):
                self._cond.wait(timeout=0.05)
        try:
            # End-of-stream is a CALL: the reply proves the hub processed
            # s_close and (per-connection FIFO) every data frame before
            # it, so the socket close below cannot race its own tail
            # bytes (see the hub-side comment). seq tells the consumer
            # how many frames to expect — a lost TAIL frame has no
            # successor, so the close record is the gap detector of last
            # resort.
            asyncio.run_coroutine_threadsafe(
                self._conn.call("s_close", sid=self.stream_id,
                                seq=self._seq, _timeout=5.0),
                self._loop).result(timeout=6)
        except Exception:
            pass
        try:
            asyncio.run_coroutine_threadsafe(
                self._conn.close(), self._loop).result(timeout=5)
        except Exception:
            pass
