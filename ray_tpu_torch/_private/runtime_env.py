"""Runtime environments: working_dir / py_modules packaging + activation.

Parity target: reference python/ray/_private/runtime_env/ (working_dir.py,
py_modules.py, packaging.py:  zip the directory, content-address it as
gcs://_ray_pkg_<sha>.zip in the GCS KV, download+extract on the worker
node, chdir / sys.path-insert). env_vars are handled separately by the
worker pool (baked for dedicated workers, apply+restore per task for
pooled ones). pip/conda/container isolation is intentionally out of scope
(no package installs in the target environment); specifying them raises.

Counterpart: ray_tpu/_private/runtime_env.py (copied).
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import threading
import zipfile

_MAX_PKG_BYTES = 200 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

_pack_cache: dict = {}  # abspath -> (stamp, sha)
_pack_lock = threading.Lock()

_UNSUPPORTED = ("pip", "conda", "container", "uv")


def validate(runtime_env: dict | None) -> None:
    for k in _UNSUPPORTED:
        if runtime_env and runtime_env.get(k):
            raise ValueError(
                f"runtime_env[{k!r}] is not supported in this environment "
                f"(no network package installs); bake dependencies into the "
                f"image or use py_modules/working_dir")


def _zip_dir(root: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                try:
                    zf.write(full, rel)
                except OSError:
                    continue  # vanished mid-walk
            if buf.tell() > _MAX_PKG_BYTES:
                raise ValueError(
                    f"runtime_env package {root!r} exceeds "
                    f"{_MAX_PKG_BYTES >> 20} MiB")
    return buf.getvalue()


def _dir_stamp(root: str) -> tuple:
    """Cheap change detector so repeat submissions don't re-zip."""
    latest = 0.0
    count = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
        for fn in filenames:
            try:
                latest = max(latest, os.stat(os.path.join(dirpath, fn)).st_mtime)
            except OSError:
                pass
            count += 1
    return (latest, count)


def package(worker, runtime_env: dict | None) -> dict | None:
    """Driver side: replace local working_dir / py_modules paths with
    content-addressed package ids uploaded to the controller KV."""
    validate(runtime_env)
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)

    def _upload(path: str) -> str:
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise ValueError(f"runtime_env path {path!r} is not a directory")
        stamp = _dir_stamp(path)
        with _pack_lock:
            cached = _pack_cache.get(path)
            if cached is not None and cached[0] == stamp:
                return cached[1]
        blob = _zip_dir(path)
        sha = hashlib.sha256(blob).hexdigest()[:32]
        worker.kv("put", ns="pkg", key=sha, value=blob, overwrite=False)
        with _pack_lock:
            _pack_cache[path] = (stamp, sha)
        return sha

    wd = out.get("working_dir")
    if wd:
        out["working_dir_pkg"] = _upload(wd)
        del out["working_dir"]
    mods = out.get("py_modules")
    if mods:
        out["py_modules_pkgs"] = [_upload(m) for m in mods]
        del out["py_modules"]
    return out


# ---------------------------------------------------------------- executor
_extract_lock = threading.Lock()


def _extract(worker, sha: str) -> str:
    """Fetch a package from the controller KV and extract it (cached per
    node in the session dir)."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    dest = os.path.join(CONFIG.session_dir, worker.session_id, "pkg", sha)
    done = dest + ".done"
    with _extract_lock:
        if os.path.exists(done):
            return dest
        rep = worker.kv("get", ns="pkg", key=sha)
        blob = rep["value"]
        if blob is None:
            raise RuntimeError(f"runtime_env package {sha} not found in KV")
        os.makedirs(dest, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
            zf.extractall(dest)
        open(done, "w").close()
        return dest


def apply(worker, runtime_env: dict | None):
    """Executor side: activate working_dir/py_modules for the current task
    or actor. Returns an undo callable (pooled workers restore between
    tasks; dedicated workers never call it)."""
    if not runtime_env:
        return lambda: None
    undo_ops: list = []
    wd_sha = runtime_env.get("working_dir_pkg")
    if wd_sha:
        path = _extract(worker, wd_sha)
        prev_cwd = os.getcwd()
        os.chdir(path)
        sys.path.insert(0, path)
        undo_ops.append(lambda: (os.chdir(prev_cwd),
                                 path in sys.path and sys.path.remove(path)))
    for sha in runtime_env.get("py_modules_pkgs") or ():
        path = _extract(worker, sha)
        sys.path.insert(0, path)
        undo_ops.append(lambda p=path: p in sys.path and sys.path.remove(p))

    def undo():
        for op in reversed(undo_ops):
            try:
                op()
            except Exception:
                pass

    return undo
