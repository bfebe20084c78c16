"""Public state API: list cluster entities.

Parity target: reference python/ray/util/state/api.py (list_tasks,
list_actors, list_objects, list_nodes, list_workers — the StateApiClient
surface, backed here by controller queries instead of the dashboard's
aggregator).

Counterpart: ray_tpu/util/state.py (copied).
"""

from __future__ import annotations

from ray_tpu_torch._private.worker import global_worker


def _call(method: str, **kw):
    w = global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    return w.io.run(w.controller.call(method, **kw), timeout=30)


class TruncatedList(list):
    """A plain list plus a `truncated` flag: the uniform limit contract of
    every list API — when the controller dropped rows beyond `limit=` the
    flag is True instead of the caller silently seeing a short list."""

    truncated: bool = False


def _rows(rep: dict, key: str) -> TruncatedList:
    rows = TruncatedList(rep[key])
    rows.truncated = bool(rep.get("truncated"))
    return rows


def list_tasks(limit: int = 1000) -> list[dict]:
    """Executed tasks (from the task-event ring) plus live queued/running
    ones; each row has task_id/name/kind/state/node/worker/timestamps.
    Rows beyond `limit` drop oldest-first; the returned list's
    `.truncated` is True when that happened."""
    return _rows(_call("list_tasks", limit=limit), "tasks")


def list_objects(limit: int = 1000) -> list[dict]:
    """Directory entries known to the controller. Each row carries a
    `plane` field: "host" for store/inline objects, "device" for entries
    whose payload is pinned in the producing worker's DeviceObjectTable
    (README "Device objects"); device residency totals are the
    `rt_device_objects_{count,bytes}` gauges in `metrics()`. `.truncated`
    on the returned list marks a limit-clipped reply."""
    return _rows(_call("list_objects", limit=limit), "objects")


def list_actors(limit: int = 1000) -> list[dict]:
    snap = _call("state_snapshot")
    out = [{"actor_id": aid, **info} for aid, info in snap["actors"].items()]
    return out[:limit]


def list_nodes() -> list[dict]:
    snap = _call("state_snapshot")
    return [{"node_id": nid, **info} for nid, info in snap["nodes"].items()]


def list_placement_groups() -> list[dict]:
    snap = _call("state_snapshot")
    return [{"pg_id": pid, **info} for pid, info in snap.get("pgs", {}).items()]


def list_checkpoints(path: str | None = None, limit: int = 1000) -> list[dict]:
    """Committed checkpoints. With `path` (any storage-plane URI), the
    directory is scanned directly — committed AND in-flight partial rows,
    no cluster needed. Without it, the cluster-wide registry is queried:
    every engine commit registers best-effort in the controller KV
    (`_checkpoints` namespace), so rows survive the saving worker."""
    if path is not None:
        from ray_tpu_torch.train import checkpoint as ckpt_mod

        return ckpt_mod.list_checkpoints(path)[:limit]
    import json

    rows = []
    for key in _call("kv_keys", ns="_checkpoints", prefix="")["keys"][:limit]:
        val = _call("kv_get", ns="_checkpoints", key=key)["value"]
        if val is None:
            continue
        try:
            rows.append(json.loads(val))
        except ValueError:
            pass
    rows.sort(key=lambda r: r.get("created") or 0)
    return rows


def list_stalls(limit: int = 1000) -> list[dict]:
    """StallReports the controller has aggregated (README "Stall detection
    & watchdogs"): one row per escalation stage crossed anywhere in the
    cluster — worker watchdogs (stage warn/dump/kill), agent backstops
    (beacons stopped), and train group-stall kills. Rows carry the task,
    where it ran, how long it was silent, the flight-recorder tail, and
    (dump/kill) the storage path of the persisted flight dump."""
    return _rows(_call("list_stalls", limit=limit), "stalls")


def list_events(entity: str | None = None, kind: str | None = None,
                severity: str | None = None, since: int | None = None,
                limit: int = 1000) -> list[dict]:
    """Cluster lifecycle events (README "Cluster events"): one row per
    transition the runtime observed — node register/suspect/dead, worker
    start/exit (with normalized cause), actor create/restart/death, lease
    failover and dedup replay, device-object producer loss, checkpoint
    commit/GC, train group restarts, serve deploy/scale/replica death,
    job start/stop, and every stall-escalation stage (carrying the stalled
    task's trace_id). Rows are seq-ordered (controller arrival order).
    `entity=` prefix-matches ANY of an event's entity ids (actor/worker/
    task/lease/node/job ids); `since=` is a seq (exclusive) for follow-
    style polling; `.truncated` marks a limit-clipped reply."""
    kw: dict = {"limit": limit}
    if entity is not None:
        kw["entity"] = entity
    if kind is not None:
        kw["kind"] = kind
    if severity is not None:
        kw["severity"] = severity
    if since is not None:
        kw["since"] = since
    return _rows(_call("list_events", **kw), "events")


def list_traces(limit: int = 1000) -> list[dict]:
    """Traces the controller has indexed (README "Tracing & timeline"):
    one row per trace_id — root name, start/end, span count, and whether
    the root span has landed (`complete`). Arm the plane with RT_TRACING=1
    (+ RT_TRACE_SAMPLE for head-based sampling); export any row with
    `ray-tpu timeline --trace <id>` or `get_trace()`. `.truncated` marks
    a limit-clipped reply."""
    return _rows(_call("list_traces", limit=limit), "traces")


def list_profiles(limit: int = 1000) -> list[dict]:
    """Captured worker profiles (README "Telemetry & profiling"): one
    metadata row per `ray-tpu profile` / `profile_worker` capture, newest
    last — worker/node, mode (cpu|jax), sample counts, and the storage
    path of the persisted document (`/api/profiles?name=` fetches it)."""
    return _rows(_call("list_profiles", limit=limit), "profiles")


def timeseries(series: str | None = None, node_id: str | None = None,
               since: float | None = None) -> list[dict]:
    """Telemetry timeseries rows (README "Telemetry & profiling"): each is
    {node_id, series, worker_id, points=[[ts, value], ...]} with strictly
    monotone timestamps. `series` matches exactly or as a prefix
    ("node." selects the family). Needs RT_TELEMETRY_INTERVAL_S set."""
    kw: dict = {}
    if series is not None:
        kw["series"] = series
    if node_id is not None:
        kw["node_id"] = node_id
    if since is not None:
        kw["since"] = since
    return _call("timeseries", **kw)["series"]


def cluster_utilization() -> dict:
    """Latest telemetry sample per node/worker plus controller self-stats
    (event-loop lag, table sizes) — the data behind `ray-tpu top`.
    {nodes: {node_id: {alive, liveness, beat_age, node: {cpu, mem, ...},
    workers: {wid: {rss, cpu, hbm_used, ...}}}}, controller: {...}}."""
    return _call("cluster_utilization")


def get_trace(trace_id: str) -> dict:
    """Full span list of one trace (unique id prefixes accepted). Falls
    back to the storage plane for traces evicted from the controller ring.
    Returns {found, trace_id, name, start, end, complete, spans}."""
    return _call("get_trace", trace_id=trace_id)


def metrics() -> list[dict]:
    """Aggregated application metrics (ray_tpu_torch.util.metrics Counter/
    Gauge/Histogram series, reference `ray metrics` / Prometheus export)."""
    return _call("get_metrics")["metrics"]


def summarize_tasks() -> dict:
    """Counts by (name, state) — reference `ray summary tasks`."""
    out: dict = {}
    for t in list_tasks(limit=100_000):
        key = (t["name"], t["state"])
        out[key] = out.get(key, 0) + 1
    return {f"{name}:{state}": n for (name, state), n in out.items()}
