"""Shared-memory object store (plasma-equivalent) with disk spilling.

Parity target: reference object_manager/plasma/ (PlasmaStore store.h:55,
dlmalloc-on-shm, LRU EvictionPolicy, fallback-to-disk) and
raylet/local_object_manager.h:42 (spill/restore via external storage,
python/ray/_private/external_storage.py:72).

TPU-era design: instead of one store daemon with a dlmalloc heap, each object
is a file-backed mmap in /dev/shm named `rt_{session}_{oid}`. All processes on
a host share the namespace, so same-host reads attach the segment zero-copy
(numpy/jax arrays deserialize as views over the mapping via pickle5 oob
buffers). Cross-host reads go over the RPC object plane and materialize a
local secondary copy. Over-capacity stores spill LRU segments to disk and
restore on demand.

Counterpart: ray_tpu/_private/object_store.py (copied).
"""

from __future__ import annotations

import mmap
import os
import threading
import time


class _SpareLost(Exception):
    """A recycled spare segment vanished (session purge) between fill and
    rename; the caller re-runs the fill against a cold segment."""


class _StreamWriter:
    """Chunk sink for LocalStore.begin_stream (remote object fetch)."""

    __slots__ = ("_store", "oid", "_tmp", "_mm", "total", "_cap", "_done")

    def __init__(self, store: "LocalStore", oid: str, tmp: str, mm, total: int,
                 cap: int):
        self._store = store
        self.oid = oid
        self._tmp = tmp
        self._mm = mm
        self.total = total
        self._cap = cap
        self._done = False

    def write(self, offset: int, data) -> None:
        # Same copy machinery as put(): multi-MB fetch chunks use the
        # native threaded memcpy when available (the fetch pipeline calls
        # this off the event loop, overlapping the copy with socket recv).
        LocalStore._copy_in(self._mm, offset, data)

    def seal(self) -> bool:
        self._done = True
        return self._store._finish_stream(self.oid, self._tmp, self._mm,
                                          self.total, self._cap)

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        self._store._abort_stream(self._tmp, self._mm, self.total)


class LocalStore:
    def __init__(self, session_id: str, capacity_bytes: int, spill_dir: str, shm_dir: str = "/dev/shm"):
        self.session = session_id[:8]
        self.capacity = capacity_bytes
        self.spill_dir = os.path.join(spill_dir, self.session)
        self.shm_dir = shm_dir
        self._lock = threading.RLock()
        # oid -> {"size": int, "cap": int, "where": "shm"|"spill",
        #         "last_used": float, "mv": memoryview|None, "mm": mmap|None,
        #         "created": bool, "pin": str|None}
        self._objects: dict[str, dict] = {}
        self._used = 0
        # Warm-segment pool (the reference gets this from plasma's dlmalloc
        # arena: freed memory is re-handed to the next Create without giving
        # pages back to the kernel — cold tmpfs page faults cost ~4x warm
        # memcpy). Recycling a host-shared segment is only safe when no other
        # process can still read it, so readers hardlink a `.p{pid}` pin next
        # to the primary file before attaching; at free time the owner renames
        # the primary away (no new pins possible) and recycles only when
        # st_nlink shows no pins and the local memoryview releases cleanly.
        self._pool: list[dict] = []  # {"cap", "path", "mm"}
        self._pool_bytes = 0
        self._spare_seq = 0
        # Pins are named per (pid, store instance): two stores in one process
        # (driver + head agent share a process in local mode) must not share
        # a pin, or one store's clean delete would strip the other's guard.
        self._uid = f"{os.getpid()}x{id(self) & 0xFFFF:x}"
        self._pending_spare = None  # spare being filled by put_serialized

    # -- naming ------------------------------------------------------------
    def _path(self, oid: str) -> str:
        return os.path.join(self.shm_dir, f"rt_{self.session}_{oid}")

    def _spill_path(self, oid: str) -> str:
        return os.path.join(self.spill_dir, oid)

    # -- write -------------------------------------------------------------
    def _take_spare(self, total: int):
        """Best-fit warm segment with cap in [total, 4*total+1MB]."""
        best = None
        for i, sp in enumerate(self._pool):
            if total <= sp["cap"] <= 4 * total + (1 << 20):
                if best is None or sp["cap"] < self._pool[best]["cap"]:
                    best = i
        if best is None:
            return None
        sp = self._pool.pop(best)
        self._pool_bytes -= sp["cap"]
        return sp

    def _drop_spare(self, sp: dict):
        """Unlink+close a spare already removed (and deducted) from the pool."""
        try:
            os.unlink(sp["path"])
        except OSError:
            pass
        try:
            sp["mm"].close()
        except (BufferError, ValueError):
            pass

    @staticmethod
    def _copy_in(mm, off: int, p) -> int:
        """One part into the segment; multi-MB buffers use the native
        threaded memcpy (ray_tpu_torch/_native) when available — on many-core TPU
        hosts a single-threaded copy leaves most of the memory bandwidth on
        the table (cf. reference plasma's threaded CreateAndSeal copies)."""
        if not isinstance(p, (bytes, bytearray)):
            p = memoryview(p).cast("B")  # write raw buffer, no copy
        n = len(p)
        if n >= (8 << 20) and (os.cpu_count() or 1) > 2:
            try:
                from ray_tpu_torch import _native

                if _native.parallel_memcpy(memoryview(mm)[off:off + n], p):
                    return n
            except Exception:
                pass  # fall back to the plain slice copy
        mm[off : off + n] = p
        return n

    @staticmethod
    def _copy_buffers(mm, off: int, big_threshold: int, parts) -> int:
        """Copy `parts` into the mapping starting at `off`. Buffers at or
        above `big_threshold` take the native threaded memcpy directly (the
        per-part 8MB gate in _copy_in understates the win when one PUT
        carries many medium out-of-band buffers)."""
        native = None
        if big_threshold < (8 << 20) and (os.cpu_count() or 1) > 2:
            try:
                from ray_tpu_torch import _native

                if _native.get_lib() is not None:
                    native = _native
            except Exception:
                native = None
        for p in parts:
            if not isinstance(p, (bytes, bytearray)):
                p = memoryview(p).cast("B")
            n = len(p)
            copied = False
            if native is not None and n >= big_threshold:
                try:
                    copied = bool(native.parallel_memcpy(
                        memoryview(mm)[off:off + n], p))
                except Exception:
                    copied = False
            if not copied:
                off += LocalStore._copy_in(mm, off, p)
            else:
                off += n
        return off

    def put_serialized(self, oid: str, sobj) -> int:
        """Serialize-into-shm put: lay a SerializedObject's wire format
        (see serialization.to_parts — single source of truth for the
        layout) directly into the destination mmap. The pickle-5
        out-of-band buffer views captured by serialize()'s buffer_callback
        are each written straight into the segment — no intermediate parts
        list, no joined blob, ONE pass over the payload bytes total — and
        a put carrying several medium buffers still gets the native
        threaded memcpy per buffer (put GB/s was at 0.587x of the memcpy
        ceiling with the old per-part 8MB gate). Returns total size."""
        import struct

        meta = sobj.to_parts_meta()
        total = len(meta) + len(sobj.header) + sum(
            8 + len(b) for b in sobj.buffers)
        with self._lock:
            ent = self._objects.get(oid)
            if ent is not None:
                return ent["size"]
            # Threaded copies pay off once the whole put is large: then
            # even ~1MB buffers ride the pool (faults + memcpy overlap).
            big = (8 << 20) if total < (8 << 20) else (1 << 20)
            while True:
                mm = self._make_segment(oid, total)
                off = self._copy_buffers(mm, 0, (8 << 20),
                                         (meta, sobj.header))
                for b in sobj.buffers:
                    off += LocalStore._copy_in(
                        mm, off, struct.pack("<Q", len(b)))
                    off = self._copy_buffers(mm, off, big, (b,))
                try:
                    self._commit_segment(oid, mm, total)
                    return total
                except _SpareLost:
                    continue  # purge raced the spare; rewrite cold

    def _make_segment(self, oid: str, total: int):
        """Allocate (or recycle) the backing mmap for a new object of
        `total` bytes — the shared front half of put()/put_serialized().
        Must be called under self._lock; returns the writable mmap."""
        path = self._path(oid)
        cap = max(total, 1)
        # Take a spare BEFORE evicting: reuse adds no net pages, so under
        # pressure the warm segment must not be the eviction victim.
        sp = self._take_spare(cap)
        self._maybe_evict(total)
        mm = None
        if sp is not None:
            try:
                # Grow the (possibly shrunk) spare back to this object's
                # size; data is written while it is still at the spare
                # name; _commit_segment renames it into place.
                if sp["cap"] != cap:
                    os.truncate(sp["path"], cap)
                mm = sp["mm"]
                self._pending_spare = sp
            except OSError:
                self._drop_spare(sp)
                sp = None
        if mm is None:
            self._pending_spare = None
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
            try:
                os.ftruncate(fd, cap)
                mm = mmap.mmap(fd, cap)
            finally:
                os.close(fd)
        return mm

    def _commit_segment(self, oid: str, mm, total: int):
        """Publish a segment filled by the caller (under self._lock):
        rename a recycled spare into place, register the entry. Returns the
        (possibly re-created) mapping."""
        path = self._path(oid)
        sp = getattr(self, "_pending_spare", None)
        self._pending_spare = None
        if sp is not None:
            try:
                os.rename(sp["path"], path)
            except OSError:
                # Lost the race with a session purge: the caller must
                # rewrite into a cold segment. Signalled via ValueError so
                # put_serialized stays rare-path simple.
                self._drop_spare(sp)
                raise _SpareLost()
        self._objects[oid] = {
            "size": total,
            "cap": max(total, 1),
            "where": "shm",
            "last_used": time.monotonic(),
            "mm": mm,
            "mv": memoryview(mm)[:total],
            "created": True,
            "pin": None,
        }
        self._used += total

    def put(self, oid: str, parts: list) -> int:
        """Write a flattened object blob (list of bytes-like) into shm.
        Returns total size. Idempotent per oid."""
        total = sum(p.nbytes if isinstance(p, memoryview) else len(p) for p in parts)
        with self._lock:
            if oid in self._objects:
                return self._objects[oid]["size"]
            path = self._path(oid)
            mm = None
            cap = max(total, 1)
            # Take a spare BEFORE evicting: reuse adds no net pages, so under
            # pressure the warm segment must not be the eviction victim.
            sp = self._take_spare(cap)
            self._maybe_evict(total)
            if sp is not None:
                try:
                    # Grow the (possibly shrunk) spare back to this object's
                    # size; write the data while it is still at the spare
                    # name, and only then rename — a sibling attach must
                    # never observe the previous object's bytes under the
                    # new oid (attachers probe /dev/shm with no lock).
                    if sp["cap"] != cap:
                        os.truncate(sp["path"], cap)
                    mm = sp["mm"]
                except OSError:
                    self._drop_spare(sp)
                    sp = None
            if mm is None:
                fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
                try:
                    os.ftruncate(fd, cap)
                    mm = mmap.mmap(fd, cap)
                finally:
                    os.close(fd)
            off = 0
            for p in parts:
                off += self._copy_in(mm, off, p)
            if sp is not None:
                try:
                    os.rename(sp["path"], path)
                except OSError:
                    # Lost the race with a session purge: fall back cold.
                    self._drop_spare(sp)
                    fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
                    try:
                        os.ftruncate(fd, cap)
                        mm = mmap.mmap(fd, cap)
                    finally:
                        os.close(fd)
                    off = 0
                    for p in parts:
                        off += self._copy_in(mm, off, p)
            self._objects[oid] = {
                "size": total,
                "cap": cap,
                "where": "shm",
                "last_used": time.monotonic(),
                "mm": mm,
                "mv": memoryview(mm)[:total],
                "created": True,
                "pin": None,
            }
            self._used += total
            return total

    def begin_stream(self, oid: str, total: int):
        """Start writing an object of known size that arrives in chunks
        (remote fetch): bytes land in a uniquely-named temp segment that is
        renamed into place at seal, so same-host attachers can never observe
        a half-written object. Returns None if the oid is already local."""
        with self._lock:
            if oid in self._objects:
                return None
            self._maybe_evict(total)
            # Reserve NOW: concurrent streams/puts must see these bytes as
            # committed or they over-commit the store during the transfer.
            self._used += total
            self._spare_seq += 1
            seq = self._spare_seq
        tmp = os.path.join(self.shm_dir,
                           f"rt_{self.session}_in{os.getpid()}_{seq}")
        cap = max(total, 1)
        try:
            fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
            try:
                os.ftruncate(fd, cap)
                mm = mmap.mmap(fd, cap)
            finally:
                os.close(fd)
        except OSError:
            with self._lock:
                self._used -= total
            raise
        return _StreamWriter(self, oid, tmp, mm, total, cap)

    def _finish_stream(self, oid: str, tmp: str, mm, total: int, cap: int) -> bool:
        """Seal a streamed segment (commits the reservation taken by
        begin_stream). Returns False if another copy won the race or the
        rename failed; the temp and the reservation are dropped."""
        def _drop():
            self._used -= total
            try:
                os.unlink(tmp)
            except OSError:
                pass
            try:
                mm.close()
            except (BufferError, ValueError):
                pass

        with self._lock:
            if oid in self._objects:
                _drop()
                return False
            try:
                os.rename(tmp, self._path(oid))
            except OSError:
                _drop()
                return False
            self._objects[oid] = {
                "size": total, "cap": cap, "where": "shm",
                "last_used": time.monotonic(), "mm": mm,
                "mv": memoryview(mm)[:total], "created": True, "pin": None,
            }
            return True

    def _abort_stream(self, tmp: str, mm, total: int) -> None:
        with self._lock:
            self._used -= total
        try:
            os.unlink(tmp)
        except OSError:
            pass
        try:
            mm.close()
        except (BufferError, ValueError):
            pass

    def detach(self, oid: str) -> None:
        """Drop our mapping but leave the file for other readers (used by
        executing workers after storing task results: the agent is the
        advertised holder, so keeping the producer's mapping alive would pin
        freed pages until the worker exits)."""
        with self._lock:
            ent = self._objects.pop(oid, None)
            if ent is None or ent["where"] != "shm":
                return
            if ent["created"]:
                self._used -= ent["size"]
            self._release_mapping(ent)


    # -- read --------------------------------------------------------------
    def get(self, oid: str):
        """Return a zero-copy memoryview of the blob, or None if absent.
        Attaches a segment created by another same-host process if needed;
        restores from spill if the segment was spilled."""
        with self._lock:
            ent = self._objects.get(oid)
            if ent is not None:
                ent["last_used"] = time.monotonic()
                if ent["where"] == "shm":
                    return ent["mv"]
                return self._restore(oid, ent)
            # Attach a segment created by a sibling process on this host.
            # The pin hardlink (created BEFORE opening) tells the creator's
            # free path that this segment must not be recycled; link() on a
            # path the owner already renamed away fails -> no stale attach.
            path = self._path(oid)
            if not os.path.exists(path):
                # Cheap miss: probing absent objects (every get() racing its
                # producer) must cost one stat, not a failed link() — link
                # is several times pricier on some kernels/containers.
                return None
            pin = f"{path}.p{self._uid}"
            try:
                os.link(path, pin)
            except FileExistsError:
                # Stale pin from an earlier attach by this store (possibly
                # referencing a pre-spill inode): re-link so the pin is
                # guaranteed to name the CURRENT primary inode.
                try:
                    os.unlink(pin)
                    os.link(path, pin)
                except OSError:
                    return None
            except OSError:
                return None
            try:
                fd = os.open(path, os.O_RDONLY)
            except FileNotFoundError:
                try:
                    os.unlink(pin)
                except OSError:
                    pass
                return None
            try:
                size = os.fstat(fd).st_size
                mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
            finally:
                os.close(fd)
            self._objects[oid] = {
                "size": size,
                "cap": size,
                "where": "shm",
                "last_used": time.monotonic(),
                "mm": mm,
                "mv": memoryview(mm),
                "created": False,
                "pin": pin,
            }
            return self._objects[oid]["mv"]

    def contains(self, oid: str) -> bool:
        with self._lock:
            if oid in self._objects:
                return True
            return os.path.exists(self._path(oid))

    # -- spill/restore -----------------------------------------------------
    def _maybe_evict(self, incoming: int) -> None:
        if self._used + self._pool_bytes + incoming <= self.capacity:
            return
        # Spares are instantly reclaimable: drain the pool before spilling.
        while self._pool and self._used + self._pool_bytes + incoming > self.capacity:
            sp = self._pool.pop(0)
            self._pool_bytes -= sp["cap"]
            self._drop_spare(sp)
        if self._used + incoming <= self.capacity:
            return
        victims = sorted(
            (o for o, e in self._objects.items() if e["where"] == "shm" and e["created"]),
            key=lambda o: self._objects[o]["last_used"],
        )
        for oid in victims:
            if self._used + incoming <= self.capacity:
                break
            self._spill(oid)

    def _spill(self, oid: str) -> None:
        ent = self._objects[oid]
        os.makedirs(self.spill_dir, exist_ok=True)
        with open(self._spill_path(oid), "wb") as f:
            f.write(ent["mv"])
        self._release_mapping(ent)
        try:
            os.unlink(self._path(oid))
        except FileNotFoundError:
            pass
        ent["where"] = "spill"
        self._used -= ent["size"]

    def _restore(self, oid: str, ent: dict):
        self._maybe_evict(ent["size"])
        with open(self._spill_path(oid), "rb") as f:
            data = f.read()
        path = self._path(oid)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, max(len(data), 1))
            mm = mmap.mmap(fd, max(len(data), 1))
        finally:
            os.close(fd)
        mm[: len(data)] = data
        ent.update(where="shm", mm=mm, mv=memoryview(mm)[: len(data)], created=True,
                   cap=max(len(data), 1))
        self._used += ent["size"]
        try:
            os.unlink(self._spill_path(oid))
        except FileNotFoundError:
            pass
        return ent["mv"]

    # -- delete ------------------------------------------------------------
    @staticmethod
    def _release_mapping(ent: dict) -> bool:
        """Release the local view+mapping; True if fully released (no live
        deserialized views)."""
        clean = True
        if ent.get("mv") is not None:
            try:
                ent["mv"].release()
                ent["mv"] = None
            except BufferError:
                clean = False  # a deserialized array still views it
        if clean and ent.get("mm") is not None:
            try:
                ent["mm"].close()
                ent["mm"] = None
            except BufferError:
                clean = False
        return clean

    def _unlink_pins(self, oid: str) -> None:
        # scandir + startswith instead of glob: glob compiles a regex per
        # call, and this runs on every purge.
        prefix = os.path.basename(self._path(oid)) + ".p"
        try:
            with os.scandir(self.shm_dir) as it:
                victims = [e.path for e in it if e.name.startswith(prefix)]
        except OSError:
            return
        for p in victims:
            try:
                os.unlink(p)
            except OSError:
                pass

    def delete(self, oid: str) -> None:
        with self._lock:
            ent = self._objects.pop(oid, None)
            if ent is None:
                return
            if ent["where"] != "shm":
                try:
                    os.unlink(self._spill_path(oid))
                except FileNotFoundError:
                    pass
                self._release_mapping(ent)
                return
            if not ent["created"]:
                # Attached copy: drop our pin only once no local views remain
                # (a live pin keeps the creator from recycling under us).
                if self._release_mapping(ent) and ent.get("pin"):
                    try:
                        os.unlink(ent["pin"])
                    except OSError:
                        pass
                return
            self._used -= ent["size"]
            path = self._path(oid)
            # Recycle: possible only if no local views remain. Rename the
            # primary away first (atomically stops new pins), then st_nlink
            # == 1 proves no reader ever pinned it.
            mv_clean = True
            if ent.get("mv") is not None:
                try:
                    ent["mv"].release()
                    ent["mv"] = None
                except BufferError:
                    mv_clean = False
            if mv_clean and ent.get("mm") is not None and len(self._pool) < 32 \
                    and self._pool_bytes + ent["cap"] <= self.capacity // 2:
                self._spare_seq += 1
                spare = os.path.join(
                    self.shm_dir, f"rt_{self.session}_sp{os.getpid()}_{self._spare_seq}")
                try:
                    os.rename(path, spare)
                except OSError:
                    self._release_mapping(ent)  # purged by another process
                    return
                try:
                    pinned = os.stat(spare).st_nlink != 1
                except OSError:
                    pinned = True
                if not pinned:
                    self._pool.append({"cap": ent["cap"], "path": spare, "mm": ent["mm"]})
                    self._pool_bytes += ent["cap"]
                    return
                try:
                    os.unlink(spare)
                except OSError:
                    pass
                self._unlink_pins(oid)
                self._release_mapping(ent)
                return
            # Not recyclable: free the names; pinned/viewing readers keep the
            # inode alive through their own mappings.
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            self._unlink_pins(oid)
            self._release_mapping(ent)

    def used_bytes(self) -> int:
        return self._used

    def shm_dir_usage(self) -> int:
        """Ground-truth bytes of this session's segments in the shm dir —
        unlike _used, counts worker-produced segments their creator already
        detached (the node agent reports this in heartbeats for the
        cluster's backpressure accounting)."""
        prefix = f"rt_{self.session}_"
        total = 0
        try:
            with os.scandir(self.shm_dir) as it:
                for e in it:
                    if e.name.startswith(prefix):
                        try:
                            total += e.stat().st_size
                        except OSError:
                            pass
        except OSError:
            pass
        return total

    def num_objects(self) -> int:
        return len(self._objects)

    def purge(self, oid: str) -> None:
        """Remove an object's file names (primary + reader pins) whether or
        not this store holds an entry — used by the node agent on `free`
        pushes for segments created by its (possibly exited) workers."""
        with self._lock:
            if oid in self._objects:
                # delete() on an attached entry (created=False — the normal
                # agent state after serving fetch_object for a worker-produced
                # result) only drops our pin; the producing worker has already
                # detach()ed, so nobody else will ever unlink the primary.
                # Fall through and remove the names ourselves. Safe for
                # created entries too: the recycle path renames the primary
                # away before pooling it, so this unlink is a no-op there.
                self.delete(oid)
            try:
                os.unlink(self._path(oid))
            except OSError:
                pass
            self._unlink_pins(oid)

    def shutdown(self) -> None:
        with self._lock:
            for oid, ent in list(self._objects.items()):
                if ent.get("pin"):
                    try:
                        os.unlink(ent["pin"])  # process exiting; views moot
                    except OSError:
                        pass
                self.delete(oid)
            while self._pool:
                sp = self._pool.pop()
                self._pool_bytes -= sp["cap"]
                self._drop_spare(sp)
