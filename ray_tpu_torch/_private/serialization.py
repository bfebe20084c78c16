"""Serialization with zero-copy buffer support.

Parity target: reference python/ray/_private/serialization.py
(SerializationContext:122, serialize:544) — cloudpickle + pickle protocol 5
out-of-band buffers so numpy/jax arrays are not copied into the pickle stream.

Wire format of a serialized object:
    header: pickle5 stream (with buffer placeholders)
    buffers: list of raw memoryviews (concatenated on the wire, lengths in meta)

ObjectRefs embedded in a value are swapped for `_RefPlaceholder` during
serialization and re-hydrated on deserialization, with the set of contained
refs reported to the caller (needed for borrowed-ref tracking, cf. reference
ReferenceCounter borrower protocol reference_count.h:72).

Counterpart: ray_tpu/_private/serialization.py (copied).
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass

import cloudpickle


@dataclass
class SerializedObject:
    header: bytes
    buffers: list  # list of bytes-like (memoryview/bytes)
    contained_refs: list  # list of ObjectRef

    def total_bytes(self) -> int:
        return len(self.header) + sum(len(b) for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten to a single contiguous blob (for inline/wire payloads).
        Layout: [4B nrefs][nrefs * (2B len + oid hex)] [4B nbufs][8B hlen]
        [header][ (8B len, raw)* ]. Contained refs are stored by id so a
        deserializer in another process can re-hydrate borrowed ObjectRefs.
        Single source of truth for the layout is to_parts()."""
        if not self.buffers and not self.contained_refs:
            # Tiny-result fast path (every scalar actor/task return):
            # [nrefs=0][nbufs=0][hlen][header] in one concat.
            return struct.pack("<IIQ", 0, 0, len(self.header)) + self.header
        return b"".join(
            p if isinstance(p, (bytes, bytearray)) else bytes(p)
            for p in self.to_parts())

    def to_parts_meta(self) -> bytes:
        """The fixed-size prefix of the wire layout (ref table + counts +
        header length) — the single source of truth shared by to_parts()
        and the store's serialize-into-shm put_serialized()."""
        ref_oids = [r.hex() if hasattr(r, "hex") else r for r in self.contained_refs]
        meta = [struct.pack("<I", len(ref_oids))]
        for h in ref_oids:
            hb = h.encode()
            meta.append(struct.pack("<H", len(hb)))
            meta.append(hb)
        meta.append(struct.pack("<I", len(self.buffers)))
        meta.append(struct.pack("<Q", len(self.header)))
        return b"".join(meta)

    def to_parts(self) -> list:
        """Same byte stream as to_bytes() but as a list of parts, so the shm
        store can write each raw buffer straight into the mmap — one copy
        total on the put path (reference plasma writes once into shm;
        joining everything first would cost two extra full copies)."""
        parts = [self.to_parts_meta(), self.header]
        for b in self.buffers:
            parts.append(struct.pack("<Q", len(b)))
            parts.append(b)
        return parts

    @staticmethod
    def from_buffer(buf) -> "SerializedObject":
        """Zero-copy parse from a contiguous blob (memoryview over shm).
        `contained_refs` comes back as a list of oid hex strings."""
        mv = memoryview(buf)
        (nrefs,) = struct.unpack_from("<I", mv, 0)
        off = 4
        ref_oids = []
        for _ in range(nrefs):
            (rlen,) = struct.unpack_from("<H", mv, off)
            off += 2
            ref_oids.append(bytes(mv[off : off + rlen]).decode())
            off += rlen
        (nbufs,) = struct.unpack_from("<I", mv, off)
        off += 4
        (hlen,) = struct.unpack_from("<Q", mv, off)
        off += 8
        header = bytes(mv[off : off + hlen])
        off += hlen
        buffers = []
        for _ in range(nbufs):
            (blen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            buffers.append(mv[off : off + blen])  # zero-copy slice
            off += blen
        return SerializedObject(header=header, buffers=buffers, contained_refs=ref_oids)


def inline_header_blob(header: bytes) -> bytes:
    """Wrap a bare pickle-5 header in the standard inline wire layout
    ([nrefs=0][nbufs=0][hlen][header], the to_bytes() tiny-result shape).
    Used to inline DEVICE-REF PLACEHOLDERS (_private/device_store._DeviceRef)
    in args/returns: the placeholder rides every existing blob path —
    including the no-refs/no-bufs fast deserialize — and unpickling it
    resolves the array through the device plane's tier ladder."""
    return struct.pack("<IIQ", 0, 0, len(header)) + header


class _RefPlaceholder:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class _RefPickler(cloudpickle.Pickler):
    """cloudpickle pickler that swaps ObjectRefs for persistent ids."""

    def __init__(self, f, ref_class, contained_refs, **kw):
        super().__init__(f, **kw)
        self._ref_class = ref_class
        self._contained_refs = contained_refs

    def persistent_id(self, obj):  # noqa: N802
        if isinstance(obj, self._ref_class):
            self._contained_refs.append(obj)
            return ("rt_ref", len(self._contained_refs) - 1)
        return None


class _RefUnpickler(pickle.Unpickler):
    def __init__(self, f, resolve_ref, **kw):
        super().__init__(f, **kw)
        self._resolve_ref = resolve_ref

    def persistent_load(self, pid):  # noqa: N802
        tag, idx = pid
        if tag == "rt_ref" and self._resolve_ref is not None:
            return self._resolve_ref(idx)
        raise pickle.UnpicklingError(f"unknown persistent id {pid}")


# Exact types that can never contain an ObjectRef (or an oob buffer):
# results of this shape skip the cloudpickle ref-scanning pickler entirely —
# the dominant case for actor-method replies (None / status scalars).
_ATOMIC_TYPES = (type(None), bool, int, float)


def serialize(value, ref_class=None) -> SerializedObject:
    t = type(value)
    if t in _ATOMIC_TYPES or (t in (str, bytes) and len(value) < 4096):
        return SerializedObject(
            header=pickle.dumps(value, protocol=5), buffers=[], contained_refs=[])

    buffers: list = []
    contained_refs: list = []

    def buffer_callback(pb: pickle.PickleBuffer):
        buffers.append(pb.raw())
        return False  # out-of-band

    if ref_class is not None:
        f = io.BytesIO()
        p = _RefPickler(f, ref_class, contained_refs, protocol=5,
                        buffer_callback=buffer_callback)
        p.dump(value)
        header = f.getvalue()
    else:
        header = cloudpickle.dumps(value, protocol=5, buffer_callback=buffer_callback)
    return SerializedObject(header=header, buffers=buffers, contained_refs=contained_refs)


def deserialize(sobj: SerializedObject, resolve_ref=None):
    """resolve_ref(index) -> ObjectRef for persistent-id re-hydration."""
    if not sobj.contained_refs:
        # No persistent ids in the stream: C-level loads, no Unpickler object.
        return pickle.loads(sobj.header, buffers=sobj.buffers)
    up = _RefUnpickler(io.BytesIO(sobj.header), resolve_ref, buffers=sobj.buffers)
    return up.load()


def dumps_oob(value) -> tuple[bytes, list]:
    """Plain pickle5 dump with out-of-band buffers (no ref tracking).

    Uses stdlib pickle (much faster than cloudpickle on this hot path — every
    RPC frame goes through here); RPC payloads only contain importable types
    (TaskSpec, primitives, bytes). User functions/closures go through
    serialize() above, which keeps the cloudpickle pickler. Falls back to
    cloudpickle for the rare unpicklable-by-reference value (e.g. a user
    exception instance embedded in an error blob)."""
    buffers: list = []
    cb = lambda pb: (buffers.append(pb.raw()), False)[1]  # noqa: E731
    try:
        header = pickle.dumps(value, protocol=5, buffer_callback=cb)
    except Exception:
        buffers.clear()
        header = cloudpickle.dumps(value, protocol=5, buffer_callback=cb)
    return header, buffers


def loads_oob(header: bytes, buffers: list):
    return pickle.loads(header, buffers=buffers)
