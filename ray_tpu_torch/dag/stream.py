"""Token-batch stream ring: the decode hot loop's reply transport.

Grown from the compiled-graph shm channel (experimental/channel.py — the
~22us futex-ring round-trip primitive) into a **multi-record bounded byte
ring** for token streams: where the SPSC Channel carries exactly one
in-flight message (seq/ack, capacity-1 backpressure), StreamRing lays
variable-length records head-to-tail in a circular byte region so

- the producer appends without waiting for the consumer to ack each
  record (it parks only when the ring is FULL — bounded buffering, never
  unbounded), and
- the consumer drains EVERY complete record in one wakeup (`read_batch`),
  so a token stream costs one reader wakeup per burst, not one per token.

This is the serve→engine reply path of README "Serving hot loop": the
replica's token pump writes SSE chunk records, the HTTP proxy reads
batches and coalesces them into single socket flushes — zero per-token
RPC, zero per-token ObjectRef. The same record contract is generalized
onto the rpc transport for cross-host streams by dag/push_stream.py
(PushStreamWriter/Reader: identical write/read_batch/close semantics,
credit-window backpressure instead of ring-full parking); the serve
handshake picks shm ring when it can attach, push-stream otherwise. Writers may be multiple threads of ONE
process (engine emit thread + pump + error paths): writes serialize on an
in-process lock. Cross-process stays single-producer/single-consumer,
like the Channel it grows from.

Layout (header 64B, must stay self-consistent — nothing else maps it):

    [wpos u64][rpos u64][closed u32][pad ...]  then `capacity` data bytes

wpos/rpos are MONOTONIC byte offsets (position in ring = offset %
capacity); a record is [len u32][payload], never wrapping: when the tail
can't fit the header+payload contiguously, a pad marker (len=0xFFFFFFFF)
skips to the next wrap. Publish order matters: payload bytes first, then
the wpos store — same discipline as the Channel's size-then-seq.

Counterpart: ray_tpu/dag/stream.py (copied; segments are named
"rtring_torch_<name>").
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import threading
import time

_HDR = struct.Struct("<QQI")
_DATA = 64
_LEN = struct.Struct("<I")
_PAD = 0xFFFFFFFF

#: Poll interval while parked (write-full / read-empty). The futex-backed
#: Channel sleeps in the kernel; this ring poll-sleeps the same way the
#: Channel's pure-Python fallback does — a parked end costs ~60us of wake
#: latency, orders below the per-token RPC round trip it replaces.
_POLL_S = 0.000005

#: Segment name prefix. The JAX package names its rings "rtring_"; the
#: port's differ, so one package's ring sweeps and globs never see the
#: other's segments on a shared host.
RING_PREFIX = "rtring_torch_"


class RingClosed(Exception):
    """The writer closed the ring and every record has been drained."""


class StreamRing:
    """Named bounded stream ring over /dev/shm. Both ends open by name;
    the handle pickles as (name, capacity) so it can ride request
    metadata to the producing process."""

    def __init__(self, name: str, capacity: int = 1 << 20,
                 _create: bool = True):
        if capacity < 4096:
            raise ValueError(f"ring capacity {capacity} < 4096B")
        self.name = name
        self.capacity = capacity
        self._path = os.path.join("/dev/shm", f"{RING_PREFIX}{name}")
        total = _DATA + capacity
        exists = os.path.exists(self._path)
        if not _create and not exists:
            raise FileNotFoundError(f"stream ring {name!r} does not exist")
        fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            if not exists:
                os.ftruncate(fd, total)
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._wlock = threading.Lock()  # multi-thread producers, one process

    # ------------------------------------------------------------- header
    def _load(self) -> tuple[int, int, int]:
        return _HDR.unpack_from(self._mm, 0)

    def _store_wpos(self, wpos: int) -> None:
        struct.pack_into("<Q", self._mm, 0, wpos)

    def _store_rpos(self, rpos: int) -> None:
        struct.pack_into("<Q", self._mm, 8, rpos)

    # -------------------------------------------------------------- write
    def write(self, value, timeout: float | None = None) -> None:
        """Append one record; parks while the ring lacks space (consumer
        backpressure — the producer NEVER buffers unboundedly). Raises
        TimeoutError on a stalled consumer, ValueError on a record too
        large to ever fit, RingClosed after close_write()."""
        blob = pickle.dumps(value, protocol=5)
        need = _LEN.size + len(blob)
        # A record must fit contiguously even in the worst wrap position.
        if need > self.capacity // 2:
            raise ValueError(
                f"record {len(blob)}B exceeds ring record cap "
                f"({self.capacity // 2 - _LEN.size}B for a "
                f"{self.capacity}B ring)")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._wlock:
            wpos, rpos, closed = self._load()
            if closed:
                raise RingClosed("stream ring is closed for writing")
            off = wpos % self.capacity
            tail = self.capacity - off
            pad = tail if tail < need else 0  # record would wrap: skip tail
            while (wpos + pad + need) - rpos > self.capacity:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "stream ring write timed out (consumer stalled)")
                time.sleep(_POLL_S)
                rpos = self._load()[1]
            if pad:
                if tail >= _LEN.size:
                    _LEN.pack_into(self._mm, _DATA + off, _PAD)
                # tail < 4B: too small for even a marker; the reader skips
                # sub-header tails unconditionally.
                wpos += pad
                off = 0
            start = _DATA + off
            self._mm[start + _LEN.size:start + need] = blob
            _LEN.pack_into(self._mm, start, len(blob))
            self._store_wpos(wpos + need)

    def close_write(self) -> None:
        """End-of-stream: readers drain what remains, then read_batch
        raises RingClosed. Idempotent."""
        with self._wlock:
            struct.pack_into("<I", self._mm, 16, 1)

    # --------------------------------------------------------------- read
    def read_batch(self, timeout: float | None = None,
                   max_bytes: int | None = None) -> list:
        """Block until at least one record is available, then return EVERY
        complete record currently in the ring (one consumer wakeup drains
        the burst). Raises TimeoutError when nothing arrives in time and
        RingClosed once the writer closed and the ring is drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wpos, rpos, closed = self._load()
            if wpos > rpos:
                break
            if closed:
                raise RingClosed("stream ring closed and drained")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("stream ring read timed out")
            time.sleep(_POLL_S)
        out: list = []
        budget = self.capacity if max_bytes is None else max_bytes
        pos = rpos
        while pos < wpos and budget > 0:
            off = pos % self.capacity
            tail = self.capacity - off
            if tail < _LEN.size:
                pos += tail  # sub-header tail: always padding
                continue
            n = _LEN.unpack_from(self._mm, _DATA + off)[0]
            if n == _PAD:
                pos += tail
                continue
            start = _DATA + off + _LEN.size
            out.append(pickle.loads(self._mm[start:start + n]))
            pos += _LEN.size + n
            budget -= _LEN.size + n
        # ONE rpos publish per batch: the producer sees the whole burst's
        # space freed at once (fewer parked-writer wakeups).
        self._store_rpos(pos)
        return out

    # ---------------------------------------------------------- lifecycle
    def close(self, unlink: bool = False) -> None:
        try:
            self._mm.close()
        except Exception:
            pass
        if unlink:
            try:
                os.unlink(self._path)
            except OSError:
                pass

    def __reduce__(self):
        return (StreamRing, (self.name, self.capacity, False))

    def spec(self) -> dict:
        """Wire form for request metadata (the consumer creates the ring,
        the producer attaches by spec)."""
        return {"name": self.name, "capacity": self.capacity}

    @classmethod
    def attach(cls, spec: dict) -> "StreamRing":
        return cls(spec["name"], int(spec["capacity"]), _create=False)
