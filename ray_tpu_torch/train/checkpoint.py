"""Checkpoints: URI-addressed directories + the async sharded engine.

Parity target: reference python/ray/train/_checkpoint.py (Checkpoint =
directory + filesystem URI) for the `Checkpoint` class, and Orbax-style
async sharded checkpointing (Check-N-Run-style overlapped saves) for the
engine: `save_async(state, dir)` snapshots tensors device->host
synchronously (an owned host copy, so an optimizer's next in-place step
cannot reach a save still being written), then a background writer
streams each host's shards (pickle5 out-of-band) through the pluggable
storage backend (`ray_tpu_torch/storage/`), and a global MANIFEST.json is
written LAST via atomic rename — the commit point. `restore(dir,
device=...)` gives numpy leaves, or tensors on `device`.

Layout of a committed checkpoint dir (flat, any backend):

    a0003_001_r0.bin      array leaf 3, shard 1, written by rank 0
                          (SerializedObject wire layout: pickle5 header +
                          raw out-of-band buffers)
    tree_r0.bin           pickled tree skeleton + non-array leaves (rank 0)
    _wmeta_r{K}.json      rank K's shard metadata + digests (the storage-
                          mediated commit barrier: rank 0 merges these)
    MANIFEST.json         step, per-leaf shape/dtype/sharding, shard->file
                          map, content digests. Present == committed.

Retention (`RT_CKPT_KEEP`) and GC of uncommitted partials run after each
commit; checkpoints pinned via `pin()` (e.g. a PBT clone's restore donor)
survive until every owner unpins.

Counterpart: ray_tpu/train/checkpoint.py (ported). A `torch.Tensor` leaf is
saved as the reference saves an `np.ndarray` leaf: one full shard,
`sharding: "host"`. bf16 is written as its uint16 bits under the manifest
dtype "bfloat16", the name the JAX package writes, so a checkpoint crosses
between the packages on the same format (MANIFEST, shard files, digests).
Resharding on load onto a device mesh is not ported: `restore` takes no
mesh or shardings.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Callable, Optional

from ray_tpu_torch import storage
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch.storage import StorageNotFoundError, StorageTransientError

logger = logging.getLogger(__name__)

MANIFEST = "MANIFEST.json"
_FORMAT = 1


# --------------------------------------------------------------------------
# Checkpoint: the directory handle (reference _checkpoint.py), now URI-aware.
# --------------------------------------------------------------------------
class Checkpoint:
    def __init__(self, path: str, metadata: Optional[dict] = None):
        if storage.is_local(path):
            path = os.path.abspath(storage.local_path(path) or path)
        self.path = path
        self._metadata = metadata

    @property
    def uri(self) -> str:
        return self.path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rt_ckpt_")
        local = storage.local_path(self.path)
        if local is not None:
            if os.path.abspath(dest) != local:
                shutil.copytree(local, dest, dirs_exist_ok=True)
            return dest
        _materialize(self.path, dest)
        return dest

    @contextmanager
    def as_directory(self):
        local = storage.local_path(self.path)
        if local is not None:
            yield local
            return
        dest = tempfile.mkdtemp(prefix="rt_ckpt_")
        try:
            _materialize(self.path, dest)
            yield dest
        finally:
            shutil.rmtree(dest, ignore_errors=True)

    def get_metadata(self) -> dict:
        if self._metadata is not None:
            return self._metadata
        try:
            return json.loads(
                storage.get_bytes(storage.join(self.path, ".metadata.json")))
        except (StorageNotFoundError, ValueError):
            return {}

    def set_metadata(self, metadata: dict):
        self._metadata = metadata
        storage.put(storage.join(self.path, ".metadata.json"),
                    json.dumps(metadata).encode())

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path, self._metadata))


def _materialize(uri: str, dest: str) -> None:
    """Download every object under a (flat or directory-kind) checkpoint
    URI into a local directory."""
    os.makedirs(dest, exist_ok=True)
    man = None
    mpath = storage.join(uri, MANIFEST)
    if storage.exists(mpath):
        man = json.loads(storage.get_bytes(mpath))
    if man and man.get("kind") == "directory":
        names = list(man["files"]) + [MANIFEST]
    else:
        names = storage.listdir(uri)
    for name in names:
        blob = storage.get_bytes(storage.join(uri, name))
        target = os.path.join(dest, name)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as f:
            f.write(blob)


# --------------------------------------------------------------------------
# Tree walking: dict/list/tuple/namedtuple containers, everything else a
# leaf. Array leaves (torch.Tensor / np.ndarray) become shard files; other
# leaves ride pickled inside the tree skeleton file.
# --------------------------------------------------------------------------
class _ArrayStub:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_ArrayStub, (self.index,))


#: The stub class as a tree file names it. The on-disk format is the JAX
#: package's, whose tree files pickle its own `_ArrayStub` by this global,
#: so the port writes the same name (a tree file crosses between the
#: packages, byte for byte for the same inputs) and maps it back to its
#: own class when it reads. The port never imports the module named here.
_STUB_GLOBAL = ("ray_tpu.train.checkpoint", "_ArrayStub")


class _TreePickler(pickle._Pickler):
    """Pickles a tree skeleton as stdlib pickle does, naming `_ArrayStub`
    by the format's global."""

    def save_global(self, obj, name=None):
        if obj is not _ArrayStub:
            return super().save_global(obj, name)
        self.save(_STUB_GLOBAL[0])
        self.save(_STUB_GLOBAL[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _TreeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _STUB_GLOBAL:
            return _ArrayStub
        return super().find_class(module, name)


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _walk_extract(tree, path: tuple, arrays: list) -> Any:
    """Return a skeleton copy of `tree` with array leaves replaced by
    _ArrayStub markers; appends (path_str, array) to `arrays`."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _walk_extract(v, path + (str(k),), arrays)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_walk_extract(v, path + (str(i),), arrays)
                for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return kids
        if hasattr(tree, "_fields"):  # namedtuple (optax states etc.)
            return type(tree)(*kids)
        return tuple(kids)
    if _is_tensor(tree) or isinstance(tree, np.ndarray):
        arrays.append(("/".join(path) or ".", tree))
        return _ArrayStub(len(arrays) - 1)
    return tree


def _walk_fill(tree, arrays: list) -> Any:
    """Inverse of _walk_extract: replace stubs with restored arrays."""
    if isinstance(tree, _ArrayStub):
        return arrays[tree.index]
    if isinstance(tree, dict):
        return {k: _walk_fill(v, arrays) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk_fill(v, arrays) for v in tree]
    if isinstance(tree, tuple):
        kids = [_walk_fill(v, arrays) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return tuple(kids)
    return tree


def _norm_index(idx, shape) -> list[list[int]]:
    """Normalize a tuple of slices (a shard's position in the global
    array) to [[start, stop], ...] over `shape`."""
    out = []
    for s, dim in zip(idx, shape):
        start = 0 if s.start is None else int(s.start)
        stop = dim if s.stop is None else int(s.stop)
        out.append([start, stop])
    return out


def _snapshot_leaf(path: str, arr) -> dict:
    """Host snapshot of one array leaf, taken now: an owned copy (a D2H
    copy for a CUDA tensor, a clone for a CPU tensor or numpy array) as one
    full shard. bf16, which numpy lacks, is kept as its uint16 bits under
    the dtype name "bfloat16"."""
    import numpy as np

    if isinstance(arr, np.ndarray):
        # Mutable host array: copy now — "snapshot" semantics.
        nd, dtype = np.array(arr, copy=True), str(arr.dtype)
    else:
        import torch

        host = arr.detach().to("cpu", copy=True).contiguous()
        if host.dtype == torch.bfloat16:
            nd, dtype = host.view(torch.uint16).numpy(), "bfloat16"
        else:
            nd = host.numpy()
            dtype = str(nd.dtype)
    return {"path": path, "shape": list(nd.shape), "dtype": dtype,
            "sharding": "host",
            "shards": [{"index": _norm_index(
                tuple(slice(0, d) for d in nd.shape), nd.shape),
                "data": nd}]}


# --------------------------------------------------------------------------
# Retry: transient storage failures back off and retry (sim:// chaos, real
# network blips). Fatal StorageErrors propagate immediately.
# --------------------------------------------------------------------------
def _retried(fn: Callable, what: str, stats: Optional[dict] = None):
    from ray_tpu_torch._private.rtconfig import CONFIG

    attempts = max(1, int(CONFIG.ckpt_retries) + 1)
    delay = CONFIG.ckpt_retry_base_s
    for i in range(attempts):
        try:
            return fn()
        except StorageTransientError:
            if stats is not None:
                stats["retries"] = stats.get("retries", 0) + 1
            if i == attempts - 1:
                raise
            logger.warning("checkpoint: transient storage failure on %s "
                           "(attempt %d/%d), backing off %.2fs",
                           what, i + 1, attempts, delay)
            time.sleep(delay)
            delay *= 2


def _dump_tree(skeleton) -> tuple[bytes, list]:
    buffers: list = []
    out = io.BytesIO()
    _TreePickler(out, protocol=5,
                 buffer_callback=lambda pb: buffers.append(pb.raw())).dump(
        skeleton)
    return out.getvalue(), buffers


def _blob_parts(value, dumps=None) -> tuple[list, int, str]:
    """pickle5-oob parts for one payload, with total size and sha1."""
    from ray_tpu_torch._private.serialization import SerializedObject, dumps_oob

    header, buffers = (dumps or dumps_oob)(value)
    parts = SerializedObject(header=header, buffers=buffers,
                             contained_refs=[]).to_parts()
    h = hashlib.sha1()
    n = 0
    for p in parts:
        h.update(p)
        n += len(p)
    return parts, n, h.hexdigest()


def _load_blob(blob: bytes):
    from ray_tpu_torch._private.serialization import SerializedObject, loads_oob

    sobj = SerializedObject.from_buffer(blob)
    return loads_oob(sobj.header, list(sobj.buffers))


def _load_tree(blob: bytes):
    from ray_tpu_torch._private.serialization import SerializedObject

    sobj = SerializedObject.from_buffer(blob)
    return _TreeUnpickler(io.BytesIO(sobj.header),
                          buffers=list(sobj.buffers)).load()


# --------------------------------------------------------------------------
# Save
# --------------------------------------------------------------------------
_writer_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None


def _writer_pool() -> ThreadPoolExecutor:
    """ONE background writer per process: saves commit in FIFO order, so a
    later checkpoint can never become visible before an earlier one."""
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rt-ckpt-writer")
        return _writer


class SaveHandle:
    """Future for an in-flight (or completed) save. `result()` returns the
    commit info dict; raises if the save failed. `stats` counts retries."""

    def __init__(self, uri: str, step, rank: int, fut: Future, stats: dict):
        self.uri = uri
        self.step = step
        self.rank = rank
        self._fut = fut
        self.stats = stats

    def result(self, timeout: Optional[float] = None) -> dict:
        return self._fut.result(timeout)

    def done(self) -> bool:
        return self._fut.done()

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)


def save_async(state, dir_uri: str, *, step=None, rank: int = 0,
               world_size: int = 1) -> SaveHandle:
    """Snapshot `state` (device->host, synchronous) and write it to
    `dir_uri` off the caller's path. Every rank of a multi-host save calls
    this with the SAME dir; each writes only its local shards and rank 0
    commits the manifest once all ranks' metadata has landed in storage.
    With RT_CKPT_ASYNC=0 the write+commit run inline (byte-identical
    output), and result() is already resolved on return."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    arrays: list = []
    # Stage 1 of the traced save: the synchronous device->host snapshot
    # (the only part on the caller's step path when async).
    with _tracing.span("ckpt.snapshot", "ckpt",
                       {"step": step, "rank": rank}):
        skeleton = _walk_extract(state, (), arrays)
        plan = {
            "kind": "state",
            "dir": dir_uri,
            "step": step,
            "rank": rank,
            "world": world_size,
            "leaves": [_snapshot_leaf(p, a) for p, a in arrays],
            "skeleton": skeleton if rank == 0 else None,
            "start": time.time(),
        }
    # The writer thread carries no contextvar: hand it the caller's trace
    # context so write/commit stages land in the same trace.
    plan["trace"] = _tracing.current() if _tracing.enabled() else None
    stats: dict = {}
    if CONFIG.ckpt_async:
        fut = _writer_pool().submit(_write_plan, plan, stats)
    else:
        fut = Future()
        try:
            fut.set_result(_write_plan(plan, stats))
        except BaseException as e:
            fut.set_exception(e)
    return SaveHandle(dir_uri, step, rank, fut, stats)


def save(state, dir_uri: str, *, step=None, rank: int = 0,
         world_size: int = 1) -> dict:
    """Synchronous save: blocks until committed (rank 0) / durable
    (other ranks). Same bytes as save_async."""
    plan_stats: dict = {}
    arrays: list = []
    with _tracing.span("ckpt.snapshot", "ckpt",
                       {"step": step, "rank": rank}):
        skeleton = _walk_extract(state, (), arrays)
        plan = {
            "kind": "state", "dir": dir_uri, "step": step, "rank": rank,
            "world": world_size,
            "leaves": [_snapshot_leaf(p, a) for p, a in arrays],
            "skeleton": skeleton if rank == 0 else None,
            "start": time.time(),
        }
    plan["trace"] = _tracing.current() if _tracing.enabled() else None
    return _write_plan(plan, plan_stats)


def upload_directory_async(src_dir: str, dest_uri: str, *,
                           step=None) -> SaveHandle:
    """Directory checkpoint through the same seam: file contents are
    buffered in RAM synchronously (the source is often a TemporaryDirectory
    deleted right after report()), then streamed + manifest-committed in
    the background."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    files: dict[str, bytes] = {}
    src_dir = os.path.abspath(src_dir)
    for root, _dirs, names in os.walk(src_dir):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, src_dir).replace(os.sep, "/")
            with open(full, "rb") as f:
                files[rel] = f.read()
    plan = {"kind": "directory", "dir": dest_uri, "step": step,
            "rank": 0, "world": 1, "files": files, "start": time.time()}
    plan["trace"] = _tracing.current() if _tracing.enabled() else None
    stats: dict = {}
    if CONFIG.ckpt_async:
        fut = _writer_pool().submit(_write_plan, plan, stats)
    else:
        fut = Future()
        try:
            fut.set_result(_write_plan(plan, stats))
        except BaseException as e:
            fut.set_exception(e)
    return SaveHandle(dest_uri, step, 0, fut, stats)


def upload_directory(src_dir: str, dest_uri: str, *, step=None) -> dict:
    h = upload_directory_async(src_dir, dest_uri, step=step)
    return h.result()


def _write_plan(plan: dict, stats: dict) -> dict:
    """The background half of a save: stream files through the backend
    (with transient-failure retry), land per-rank metadata, and — on the
    committing rank — merge + write MANIFEST.json last, then run
    retention/GC and mint metrics."""
    t0 = time.perf_counter()
    tctx = plan.get("trace")
    t_write = time.time()
    d = plan["dir"]
    rank, world = plan["rank"], plan["world"]
    marker = storage.join(d, f"_inprogress_r{rank}")
    _retried(lambda: storage.put(marker, json.dumps(
        {"start": plan["start"], "rank": rank, "world": world}).encode()),
        marker, stats)

    total = 0
    if plan["kind"] == "directory":
        files_meta: dict[str, dict] = {}
        for rel, blob in plan["files"].items():
            h = hashlib.sha1(blob).hexdigest()
            uri = storage.join(d, rel)
            _retried(lambda u=uri, b=blob: storage.put(u, b), uri, stats)
            files_meta[rel] = {"bytes": len(blob), "sha1": h}
            total += len(blob)
        manifest = {"format": _FORMAT, "kind": "directory",
                    "step": plan["step"], "created": time.time(),
                    "world_size": 1, "files": files_meta, "bytes": total}
        _tracing.record_span_in(tctx, "ckpt.write", "ckpt", t_write,
                                time.time(),
                                {"step": plan["step"], "bytes": total})
        t_c = time.time()
        _commit(d, rank, manifest, t0, stats)
        _tracing.record_span_in(tctx, "ckpt.commit", "ckpt", t_c,
                                time.time(), {"step": plan["step"]})
        return manifest

    # ---- state checkpoint: shard files + tree + wmeta ---------------------
    leaves_meta: dict[str, dict] = {}
    for li, leaf in enumerate(plan["leaves"]):
        shard_meta = []
        # Host numpy leaves are replicated by convention: rank 0 writes the
        # canonical copy, other ranks contribute metadata only (the merge
        # would dedup identical coverage anyway — this skips the upload).
        shards = leaf["shards"] if (rank == 0 or leaf["sharding"] != "host") \
            else []
        for si, sh in enumerate(shards):
            fname = f"a{li:04d}_{si:03d}_r{rank}.bin"
            parts, nbytes, digest = _blob_parts(sh["data"])
            uri = storage.join(d, fname)
            _retried(lambda u=uri, p=parts: storage.put(u, p), uri, stats)
            shard_meta.append({"file": fname, "index": sh["index"],
                               "bytes": nbytes, "sha1": digest,
                               "rank": rank})
            total += nbytes
        leaves_meta[str(li)] = {"path": leaf["path"], "shape": leaf["shape"],
                                "dtype": leaf["dtype"],
                                "sharding": leaf["sharding"],
                                "shards": shard_meta}
    wmeta: dict[str, Any] = {"rank": rank, "world": world,
                             "leaves": leaves_meta, "bytes": total}
    if rank == 0:
        tree_file = "tree_r0.bin"
        parts, nbytes, digest = _blob_parts(plan["skeleton"], _dump_tree)
        _retried(lambda: storage.put(storage.join(d, tree_file), parts),
                 tree_file, stats)
        total += nbytes
        wmeta["bytes"] = total
        wmeta["tree_file"] = tree_file
        wmeta["tree_sha1"] = digest
        wmeta["tree_bytes"] = nbytes
    wmeta_uri = storage.join(d, f"_wmeta_r{rank}.json")
    _retried(lambda: storage.put(wmeta_uri, json.dumps(wmeta).encode()),
             wmeta_uri, stats)
    _tracing.record_span_in(tctx, "ckpt.write", "ckpt", t_write, time.time(),
                            {"step": plan["step"], "rank": rank,
                             "bytes": total})

    if rank != 0:
        # This rank's shards are durable; rank 0 owns the commit.
        try:
            storage.delete(marker)
        except Exception:
            pass
        return wmeta

    manifest = _merge_and_commit(plan, wmeta, t0, stats)
    return manifest


def _merge_and_commit(plan: dict, wmeta0: dict, t0: float,
                      stats: dict) -> dict:
    """Rank 0: wait (via storage, not RPC) for every rank's wmeta, merge
    shard maps, write the manifest LAST via atomic rename."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    d = plan["dir"]
    world = plan["world"]
    metas = {0: wmeta0}
    deadline = time.monotonic() + CONFIG.ckpt_commit_timeout_s
    for r in range(1, world):
        uri = storage.join(d, f"_wmeta_r{r}.json")
        while True:
            if storage.exists(uri):
                metas[r] = json.loads(storage.get_bytes(uri))
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint commit: rank {r}'s shard metadata never "
                    f"appeared in {d} (worker died mid-save?); not "
                    f"committing — the partial will be GC'd")
            time.sleep(0.05)

    leaves: list[dict] = []
    total = 0
    li = 0
    while str(li) in wmeta0["leaves"]:
        base = dict(wmeta0["leaves"][str(li)])
        shards: list[dict] = []
        seen = set()
        for r in sorted(metas):
            for sh in metas[r]["leaves"].get(str(li), {}).get("shards", []):
                key = json.dumps(sh["index"])
                if key in seen:
                    continue  # defensively drop duplicate coverage
                seen.add(key)
                shards.append(sh)
        base["shards"] = shards
        leaves.append(base)
        li += 1
    for r, m in metas.items():
        total += m.get("bytes", 0)
    manifest = {"format": _FORMAT, "kind": "state", "step": plan["step"],
                "created": time.time(), "world_size": world,
                "tree_file": wmeta0.get("tree_file"),
                "tree_sha1": wmeta0.get("tree_sha1"),
                "leaves": leaves, "bytes": total}
    t_c = time.time()
    _commit(d, 0, manifest, t0, stats)
    _tracing.record_span_in(plan.get("trace"), "ckpt.commit", "ckpt", t_c,
                            time.time(),
                            {"step": plan["step"], "world": world})
    return manifest


def _commit(d: str, rank: int, manifest: dict, t0: float,
            stats: dict) -> None:
    from ray_tpu_torch._private.rtconfig import CONFIG

    tmp = storage.join(d, MANIFEST + ".tmp")
    _retried(lambda: storage.put(tmp, json.dumps(manifest).encode()),
             tmp, stats)
    _retried(lambda: storage.rename(tmp, storage.join(d, MANIFEST)),
             MANIFEST, stats)
    for r in range(manifest.get("world_size", 1)):
        try:
            storage.delete(storage.join(d, f"_inprogress_r{r}"))
        except Exception:
            pass
    elapsed = time.perf_counter() - t0
    stats["commit_s"] = elapsed
    _mint_metrics(manifest, elapsed)
    _register_with_controller(d, manifest)
    from ray_tpu_torch._private.events import emit_event

    try:
        emit_event("checkpoint_commit",
                   f"checkpoint committed at {d} (step "
                   f"{manifest.get('step')}, {manifest.get('bytes')} bytes)",
                   entity=(d,),
                   attrs={"step": manifest.get("step"),
                          "bytes": manifest.get("bytes"),
                          "commit_s": round(elapsed, 3)})
    except Exception:
        pass
    parent = storage.parent(d)
    keep = CONFIG.ckpt_keep
    if keep:
        try:
            deleted = retention(parent, keep)
            if deleted:
                emit_event("checkpoint_gc",
                           f"retention deleted {len(deleted)} checkpoint(s) "
                           f"under {parent} (keep-last-{keep})",
                           entity=(parent,),
                           attrs={"deleted": len(deleted)})
        except Exception:
            logger.exception("checkpoint retention failed under %s", parent)
    try:
        gc_partials(parent)
    except Exception:
        logger.exception("checkpoint partial-GC failed under %s", parent)


def _mint_metrics(manifest: dict, elapsed: float) -> None:
    try:
        from ray_tpu_torch._private.rtconfig import CONFIG
        from ray_tpu_torch.util import metrics as _m

        mode = "async" if CONFIG.ckpt_async else "sync"
        _m.CHECKPOINT_SAVE_SECONDS.observe(elapsed, tags={"mode": mode})
        if manifest.get("bytes"):
            _m.CHECKPOINT_BYTES.inc(manifest["bytes"])
        _m.CHECKPOINT_COMMITTED.inc()
    except Exception:
        pass


def _register_with_controller(uri: str, manifest: dict) -> None:
    """Best-effort observability row: committed checkpoints show up in
    `util.state.list_checkpoints()` and the CLI via the controller KV."""
    try:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        if w is None or getattr(w, "_shutdown", False):
            return
        info = {"uri": uri, "step": manifest.get("step"),
                "kind": manifest.get("kind"),
                "bytes": manifest.get("bytes"),
                "world_size": manifest.get("world_size"),
                "created": manifest.get("created")}
        w.kv("put", ns="_checkpoints", key=uri,
             value=json.dumps(info).encode())
    except Exception:
        pass


# --------------------------------------------------------------------------
# Restore (with resharding)
# --------------------------------------------------------------------------
def restore(dir_uri: str, *, device=None, verify: bool = True):
    """Load a committed state checkpoint. With `device=None` every array
    leaf comes back as a host numpy array (fully assembled from its saved
    shards), except a bf16 leaf, which numpy lacks: it comes back as a CPU
    bf16 tensor. With a device, every array leaf is a tensor there.

    A bf16 leaf that the JAX package wrote is an ml_dtypes array in its
    shard file: it restores only where ml_dtypes can be imported, and
    raises naming the leaf elsewhere."""
    man = load_manifest(dir_uri)
    if man is None:
        raise StorageNotFoundError(
            f"no committed checkpoint at {dir_uri} (MANIFEST.json missing)")
    if man.get("kind") != "state":
        raise ValueError(
            f"{dir_uri} is a {man.get('kind')!r} checkpoint; use "
            f"Checkpoint(...).as_directory() for directory checkpoints")
    tree_blob = storage.get_bytes(storage.join(dir_uri, man["tree_file"]))
    if verify and man.get("tree_sha1"):
        if hashlib.sha1(tree_blob).hexdigest() != man["tree_sha1"]:
            raise storage.StorageError(
                f"checkpoint {dir_uri}: tree file digest mismatch")
    skeleton = _load_tree(tree_blob)
    arrays = [_restore_leaf(dir_uri, leaf, device, verify)
              for leaf in man["leaves"]]
    return _walk_fill(skeleton, arrays)


def _restore_leaf(dir_uri: str, leaf: dict, device, verify: bool):
    import numpy as np

    shape = tuple(leaf["shape"])
    bf16 = leaf["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16) if bf16 else np.dtype(leaf["dtype"])
    cache: dict[str, Any] = {}

    def load(sh: dict):
        if sh["file"] not in cache:
            blob = storage.get_bytes(storage.join(dir_uri, sh["file"]))
            if verify and hashlib.sha1(blob).hexdigest() != sh["sha1"]:
                raise storage.StorageError(
                    f"checkpoint {dir_uri}: shard {sh['file']} digest "
                    f"mismatch (corrupt or truncated)")
            try:
                data = _load_blob(blob)
            except ModuleNotFoundError as e:
                raise ModuleNotFoundError(
                    f"checkpoint {dir_uri}: leaf {leaf['path']!r} "
                    f"({leaf['dtype']}) needs the module {e.name!r} to "
                    f"restore", name=e.name) from e
            if bf16 and data.dtype != np.uint16:
                data = data.view(np.uint16)  # an ml_dtypes bfloat16 array
            cache[sh["file"]] = data
        return cache[sh["file"]]

    out = np.empty(shape, dtype)
    for sh in leaf["shards"]:
        sl = tuple(slice(a, b) for a, b in sh["index"])
        out[sl] = load(sh)
    if not bf16 and device is None:
        return out
    import torch

    t = torch.from_numpy(out)
    if bf16:
        t = t.view(torch.bfloat16)
    return t if device is None else t.to(device)


# --------------------------------------------------------------------------
# Listing / retention / pins / GC
# --------------------------------------------------------------------------
def load_manifest(dir_uri: str) -> Optional[dict]:
    try:
        return json.loads(storage.get_bytes(storage.join(dir_uri, MANIFEST)))
    except (StorageNotFoundError, ValueError):
        return None


def list_checkpoints(parent_uri: str) -> list[dict]:
    """Rows for every checkpoint dir under `parent_uri`: committed ones
    carry manifest fields; uncommitted partials are flagged."""
    rows = []
    for name in storage.listdir(parent_uri):
        if name.endswith(".refs") or name == MANIFEST:
            continue
        d = storage.join(parent_uri, name)
        man = load_manifest(d)
        if man is not None:
            rows.append({"uri": d, "name": name, "committed": True,
                         "step": man.get("step"), "kind": man.get("kind"),
                         "bytes": man.get("bytes"),
                         "world_size": man.get("world_size"),
                         "created": man.get("created"),
                         "pins": pins(d)})
        elif any(n.startswith("_inprogress_r")
                 for n in storage.listdir(d)):
            rows.append({"uri": d, "name": name, "committed": False,
                         "step": None, "kind": None, "bytes": None,
                         "world_size": None, "created": None,
                         "pins": pins(d)})
    # Order by COMMIT TIME, not step: the train session's step counter
    # resets on every restart attempt, so a post-restart checkpoint (step
    # 1) is newer than the pre-crash step 3 — retention and
    # latest_checkpoint must see it that way or keep-last-K would delete
    # the run's actual latest checkpoint.
    rows.sort(key=lambda r: (r["created"] is None,  # partials last
                             r["created"] or 0, r["name"]))
    return rows


def latest_checkpoint(parent_uri: str) -> Optional[str]:
    committed = [r for r in list_checkpoints(parent_uri) if r["committed"]]
    return committed[-1]["uri"] if committed else None


def pin(ckpt_uri: str, owner: str) -> None:
    """Refcount a checkpoint dir: it survives retention/GC until every
    owner unpins (the PBT clone-from-donor hazard fix — marker files on
    the shared backend, visible across processes)."""
    storage.put(storage.join(ckpt_uri + ".refs", owner), b"1")


def unpin(ckpt_uri: str, owner: str) -> None:
    try:
        storage.delete(storage.join(ckpt_uri + ".refs", owner))
    except Exception:
        pass


def pins(ckpt_uri: str) -> list[str]:
    try:
        return storage.listdir(ckpt_uri + ".refs")
    except Exception:
        return []


def delete_checkpoint(ckpt_uri: str, *, force: bool = False) -> bool:
    """Remove a checkpoint dir unless pinned (force overrides)."""
    if not force and pins(ckpt_uri):
        return False
    storage.delete_prefix(ckpt_uri)
    storage.delete_prefix(ckpt_uri + ".refs")
    return True


def retention(parent_uri: str, keep: int) -> list[str]:
    """Keep the newest `keep` committed checkpoints under `parent_uri`;
    delete the rest except pinned ones. Returns deleted URIs."""
    if not keep or keep <= 0:
        return []
    committed = [r for r in list_checkpoints(parent_uri) if r["committed"]]
    deleted = []
    for row in committed[:-keep]:
        if delete_checkpoint(row["uri"]):
            deleted.append(row["uri"])
    return deleted


def gc_partials(parent_uri: str, grace_s: Optional[float] = None) -> list[str]:
    """Collect uncommitted checkpoint dirs (in-progress markers, no
    manifest) older than the grace window — the debris of a worker killed
    or a backend severed mid-save."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    if grace_s is None:
        grace_s = CONFIG.ckpt_partial_grace_s
    now = time.time()
    deleted = []
    for name in storage.listdir(parent_uri):
        if name.endswith(".refs") or name == MANIFEST:
            continue
        d = storage.join(parent_uri, name)
        names = storage.listdir(d)
        markers = [n for n in names if n.startswith("_inprogress_r")]
        if not markers or MANIFEST in names:
            continue
        newest = 0.0
        for m in markers:
            try:
                newest = max(newest, json.loads(
                    storage.get_bytes(storage.join(d, m)))["start"])
            except Exception:
                pass
        if now - newest > grace_s:
            if delete_checkpoint(d):
                deleted.append(d)
    return deleted
