"""Mutable shared-memory channels: the zero-copy low-latency substrate.

Parity target: reference experimental/channel/shared_memory_channel.py
backed by src/ray/core_worker/experimental_mutable_object_manager.h —
fixed shm segments REUSED for every message, so steady-state transfer does
no allocation, no RPC, and no scheduling. SPSC with a seq/ack pair in the
header: the writer blocks until the reader acked the previous message
(capacity-1 backpressure), the reader blocks until seq advances.

Blocking strategy: when the native library (ray_tpu_torch/_native/ring.cc) is
available both ends sleep in the kernel on futex words embedded in the
header — the reference's C++ mutable-object waiter, TPU-host edition. The
pure-Python fallback sleep-polls the same header layout, so mixed
native/Python endpoints interoperate (native waits are bounded, so a peer
that never calls futex_wake only costs ~2 ms of latency, not a hang).

Counterpart: ray_tpu/experimental/channel.py (copied). Segments are
`/dev/shm/rtch_torch_<name>` (`CHANNEL_PREFIX`), so the two packages'
channels never share a name.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
import time

# header (64B): [seq u64][ack u64][size u64][wseq u32][wack u32][reserved]
# data starts at _DATA. Must match ray_tpu_torch/_native/ring.cc::Hdr.
_HDR = struct.Struct("<QQQII")
_DATA = 64
#: /dev/shm name prefix of every channel segment of this package.
CHANNEL_PREFIX = "rtch_torch_"


def _native():
    from ray_tpu_torch._native import get_lib

    return get_lib()


class Channel:
    """One named SPSC channel over /dev/shm. Both ends open by name; the
    handle pickles as (name, size) so it can ride task/actor args."""

    def __init__(self, name: str, size: int = 1 << 20, _create: bool = True):
        self.name = name
        self.size = size
        self._path = os.path.join("/dev/shm", f"{CHANNEL_PREFIX}{name}")
        total = _DATA + size
        if _create:
            exists = os.path.exists(self._path)
            fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                if not exists or os.fstat(fd).st_size != total:
                    # Fresh segment, or a stale same-named file from a
                    # crashed run whose size disagrees: (re)size it. The
                    # creator owns the layout.
                    os.ftruncate(fd, total)
            except Exception:
                os.close(fd)
                raise
        else:
            # Attach STRICTLY: no O_CREAT. An attacher racing a teardown
            # unlink must fail loudly instead of silently re-creating an
            # orphan segment nobody will ever unlink again.
            fd = os.open(self._path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._lib = _native()
        self._view = (ctypes.c_char * total).from_buffer(self._mm)
        self._addr = ctypes.addressof(self._view)
        # Reader joins at the ACK point: a message written before this end
        # attached is still pending and must be delivered (the head would
        # silently skip it and deadlock the backpressured writer).
        self._last_read = self._ack()

    # ------------------------------------------------------------- header
    def _seq(self) -> int:
        return _HDR.unpack_from(self._mm, 0)[0]

    def _ack(self) -> int:
        return _HDR.unpack_from(self._mm, 0)[1]

    def _set(self, seq=None, ack=None, size=None):
        s, a, z, _, _ = _HDR.unpack_from(self._mm, 0)
        s = s if seq is None else seq
        a = a if ack is None else ack
        z = z if size is None else size
        # Futex mirror words ride along so native peers' kernel waits see
        # the transition (they re-check at a bounded interval regardless).
        _HDR.pack_into(self._mm, 0, s, a, z,
                       s & 0xFFFFFFFF, a & 0xFFFFFFFF)

    # -------------------------------------------------------------- write
    def write(self, value, timeout: float | None = None):
        blob = pickle.dumps(value, protocol=5)
        if len(blob) > self.size:
            raise ValueError(f"message {len(blob)}B > channel size {self.size}B")
        if self._lib is not None:
            ns = -1 if timeout is None else int(timeout * 1e9)
            rc = self._lib.rt_ring_write(self._addr, self.size, blob,
                                         len(blob), ns)
            if rc == -1:
                raise TimeoutError("channel write timed out (reader stalled)")
            if rc != 0:
                raise ValueError(f"channel write failed (rc={rc})")
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        seq = self._seq()
        # backpressure: previous message must be consumed
        while self._ack() < seq:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("channel write timed out (reader stalled)")
            time.sleep(0.000005)
        self._mm[_DATA:_DATA + len(blob)] = blob
        # Publish order matters for native readers (they wake on the seq
        # transition and then load size): size first, then seq.
        struct.pack_into("<Q", self._mm, 16, len(blob))
        self._set(seq=seq + 1)

    # --------------------------------------------------------------- read
    def read(self, timeout: float | None = None):
        if self._lib is not None:
            ns = -1 if timeout is None else int(timeout * 1e9)
            n = self._lib.rt_ring_wait(self._addr, self._last_read, ns)
            if n == -1:
                raise TimeoutError("channel read timed out")
            blob = bytes(self._mm[_DATA:_DATA + n])
            self._last_read = self._seq()
            self._lib.rt_ring_ack(self._addr)
            return pickle.loads(blob)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            seq = self._seq()
            if seq > self._last_read:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("channel read timed out")
            time.sleep(0.000005)
        size = _HDR.unpack_from(self._mm, 0)[2]
        blob = bytes(self._mm[_DATA:_DATA + size])
        self._last_read = seq
        self._set(ack=seq)
        return pickle.loads(blob)

    def close(self, unlink: bool = False):
        # The ctypes from_buffer view must die before mmap.close() accepts.
        self._view = None
        self._addr = None
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
        return (Channel, (self.name, self.size, False))
