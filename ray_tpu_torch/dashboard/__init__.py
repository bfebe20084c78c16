"""Dashboard: HTTP/JSON view of cluster state.

Parity target: reference python/ray/dashboard/head.py:46 (DashboardHead —
an aiohttp server aggregating GCS state for the web UI) with the module
endpoints that matter operationally (dashboard/modules/{node,actor,job,
state,reporter}): nodes, actors, tasks, objects, jobs, cluster status, and
a chrome-trace timeline. JSON only — point curl/a browser at it; the
reference's React frontend is intentionally out of scope.

Counterpart: ray_tpu/dashboard/__init__.py (copied; its title and
/api/version name ray_tpu_torch, and traces render through the port's
CLI).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

from ray_tpu_torch._private import rpc

logger = logging.getLogger(__name__)

# Single-file live UI (the miniature of the reference's React dashboard
# client): vanilla JS polling the JSON APIs below, no build step, no deps.
_INDEX_HTML = """<!doctype html><html><head><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:ui-monospace,Menlo,monospace;margin:1.2rem;background:#101418;color:#d8dee6}
 h1{font-size:1.1rem} h2{font-size:.95rem;margin:1.2rem 0 .4rem;color:#8ab4f8}
 table{border-collapse:collapse;width:100%;font-size:.8rem}
 th,td{text-align:left;padding:.25rem .6rem;border-bottom:1px solid #2a3138}
 th{color:#9aa6b2;font-weight:600} .ok{color:#7ee787} .bad{color:#ff7b72}
 #meta{color:#9aa6b2;font-size:.8rem} a{color:#8ab4f8}
 .pill{display:inline-block;padding:0 .45rem;border-radius:.6rem;background:#1d2630;margin-right:.6rem}
 .spark{display:inline-block;margin:0 1rem .3rem 0}
 .spark svg{vertical-align:middle;background:#161c22;border-radius:3px}
 .spark .lbl{color:#9aa6b2;font-size:.75rem;margin-right:.3rem}
 .spark .val{color:#7ee787;font-size:.75rem;margin-left:.3rem}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<div id="meta"></div>
<div id="res"></div>
<div id="util"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Recent events</h2><table id="events"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<p><a href="/api/timeline">timeline</a> (chrome trace; load in Perfetto) &middot;
<a href="/api/traces">traces</a> (causal spans; RT_TRACING=1) &middot;
<a href="/api/events">events</a> (lifecycle history; ray-tpu-torch events) &middot;
<a href="/api/timeseries">timeseries</a> (RT_TELEMETRY_INTERVAL_S) &middot;
<a href="/api/profiles">profiles</a> (ray-tpu-torch profile) &middot;
<a href="/metrics">prometheus /metrics</a></p>
<script>
const esc=(v)=>String(v).replace(/&/g,"&amp;").replace(/</g,"&lt;")
  .replace(/>/g,"&gt;").replace(/"/g,"&quot;");
const fmt=(o)=>esc(typeof o==="object"?JSON.stringify(o):o);
function table(el,rows,cols){
  let h="<tr>"+cols.map(c=>"<th>"+c+"</th>").join("")+"</tr>";
  for(const r of rows) h+="<tr>"+cols.map(c=>{
    let v=fmt(r[c]??"");
    if(c==="alive"||c==="status"||c==="state"){
      const good=(v===true||v==="true"||v==="ALIVE"||v==="RUNNING"||v==="SUCCEEDED");
      v="<span class='"+(good?"ok":"bad")+"'>"+v+"</span>";}
    return "<td>"+v+"</td>";}).join("")+"</tr>";
  document.getElementById(el).innerHTML=h;
}
async function j(u){const r=await fetch(u);return r.json()}
function spark(pts,w,h){ // inline SVG polyline over [[ts,v],...]
  if(!pts.length) return "";
  const t0=pts[0][0],t1=pts[pts.length-1][0]||t0+1;
  let hi=Math.max(...pts.map(p=>p[1]),1e-9),lo=Math.min(...pts.map(p=>p[1]),0);
  if(hi===lo) hi=lo+1;
  const xy=pts.map(p=>((p[0]-t0)/Math.max(1e-9,t1-t0)*(w-2)+1).toFixed(1)+","+
    ((h-1)-(p[1]-lo)/(hi-lo)*(h-2)).toFixed(1)).join(" ");
  return "<svg width='"+w+"' height='"+h+"'><polyline fill='none' "+
    "stroke='#8ab4f8' stroke-width='1' points='"+xy+"'/></svg>";
}
async function util(){ // live sparkline row (RT_TELEMETRY_INTERVAL_S armed)
  try{
    // no since= (browser clocks skew vs the controller host); prefix
    // filters keep per-worker series out of the 2s poll entirely, and we
    // window the tail client-side against the server's own clock.
    const [tn,tc]=await Promise.all([
      j("/api/timeseries?series=node."),
      j("/api/timeseries?series=ctrl.loop_lag_s")]);
    const ts={now:tn.now,series:(tn.series||[]).concat(tc.series||[])};
    const rows=ts.series.filter(r=>!r.worker_id&&
      ["node.cpu","node.mem","node.rss","node.tasks_running",
       "ctrl.loop_lag_s"].includes(r.series));
    let h="";
    for(const r of rows){
      const pts=r.points.filter(p=>p[0]>ts.now-120).slice(-120);
      if(!pts.length) continue;
      const last=pts[pts.length-1][1];
      h+="<span class='spark'><span class='lbl'>"+esc(r.node_id.slice(0,8))+
        " "+esc(r.series)+"</span>"+spark(pts,120,24)+
        "<span class='val'>"+esc(typeof last==="number"?
        (last>=1e6?(last/1048576).toFixed(0)+"M":last):last)+"</span></span>";
    }
    document.getElementById("util").innerHTML=h;
  }catch(e){}
}
async function tick(){
  util();
  try{
    const [st,nodes,actors,jobs,tasks,events]=await Promise.all([
      j("/api/cluster_status"),j("/api/nodes"),j("/api/actors"),
      j("/api/jobs"),j("/api/tasks?limit=25"),j("/api/events?limit=15")]);
    document.getElementById("meta").textContent=
      "updated "+new Date().toLocaleTimeString();
    const tot=st.total||{},av=st.available||{};
    document.getElementById("res").innerHTML=Object.keys(tot).map(k=>
      "<span class='pill'>"+k+" "+(av[k]??0)+"/"+tot[k]+"</span>").join("");
    table("nodes",nodes.nodes||[],["node_id","alive","address","total","available"]);
    table("actors",actors.actors||[],["actor_id","class","state","name","node_id","restarts_used"]);
    table("jobs",jobs.jobs||[],["submission_id","status","entrypoint","message"]);
    const erows=(events.events||[]).slice(-15).reverse().map(e=>({...e,
      time:new Date((e.ts||0)*1000).toLocaleTimeString(),
      entity:(e.entity||[]).map(x=>String(x).slice(0,12)).join(",")}));
    table("events",erows,["seq","time","sev","kind","entity","msg"]);
    const trows=(tasks.tasks||[]).slice(-25).reverse().map(t=>({...t,
      duration_ms:(t.end&&t.start)?Math.round((t.end-t.start)*1000):""}));
    table("tasks",trows,["name","kind","state","duration_ms","node_id"]);
  }catch(e){document.getElementById("meta").textContent="refresh failed: "+e}
}
tick();setInterval(tick,2000);
</script></body></html>"""


def render_prometheus(metrics: list[dict]) -> str:
    """Prometheus text exposition from aggregated metric entries.

    Grouped per family FIRST so `# HELP`/`# TYPE` are emitted exactly once
    per metric name even when series with different tag sets interleave in
    the input (and HELP comes from whichever series carries a description,
    not just the first seen). Histogram cumulative buckets: the `+Inf`
    bucket equals `_count` by construction — the finite loop consumes
    buckets[:-1] and the overflow bucket buckets[-1] is added exactly once
    (pinned against empty AND non-empty overflow buckets in
    tests/test_telemetry.py)."""

    def esc(v) -> str:
        # Prometheus label-value escaping: backslash, quote, newline.
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    families: dict[str, dict] = {}
    for m in metrics:
        name = m["name"].replace(".", "_").replace("-", "_")
        fam = families.setdefault(name, {"kind": m["kind"], "desc": "",
                                         "series": []})
        if m.get("desc") and not fam["desc"]:
            fam["desc"] = m["desc"]
        fam["series"].append(m)
    lines: list[str] = []
    for name, fam in families.items():
        kind = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}.get(fam["kind"], "untyped")
        if fam["desc"]:
            lines.append(f"# HELP {name} {esc(fam['desc'])}")
        lines.append(f"# TYPE {name} {kind}")
        for m in fam["series"]:
            tag_str = ",".join(f'{k}="{esc(v)}"'
                               for k, v in sorted(m["tags"].items()))
            label = f"{{{tag_str}}}" if tag_str else ""
            if m["kind"] == "histogram" and m.get("buckets") is not None:
                cum = 0
                sep = "," if tag_str else ""
                for bound, n in zip(m["boundaries"], m["buckets"]):
                    cum += n
                    lines.append(
                        f'{name}_bucket{{{tag_str}{sep}le="{bound}"}} {cum}')
                cum += m["buckets"][-1]
                lines.append(f'{name}_bucket{{{tag_str}{sep}le="+Inf"}} {cum}')
                lines.append(f"{name}_sum{label} {m['sum']}")
                lines.append(f"{name}_count{label} {m['count']}")
            else:
                lines.append(f"{name}{label} {m['value']}")
    return "\n".join(lines) + "\n"


class Dashboard:
    """Serves cluster state as JSON over HTTP. Runs its own event-loop
    thread and a single controller connection; safe to start from any
    process that can reach the controller."""

    def __init__(self, address: str, host: str = "127.0.0.1", port: int = 8265):
        chost, cport = address.rsplit(":", 1)
        self._ctrl_addr = (chost, int(cport))
        self.host, self.port = host, port
        self._io = rpc.EventLoopThread(name="dashboard")
        self._conn: Optional[rpc.Connection] = None
        self._conn_lock: Optional[asyncio.Lock] = None
        self._runner = None

    async def _a_call(self, method: str, **kw):
        # Retry ONCE on a closed/severed controller connection: a
        # controller restart (or a mid-poll sever) must cost one failed
        # call, not a 500 on every panel until the dashboard process is
        # bounced (chaos-pinned in tests/test_chaos_telemetry.py).
        last_exc: Exception | None = None
        for attempt in range(2):
            if self._conn_lock is None:
                self._conn_lock = asyncio.Lock()
            async with self._conn_lock:  # concurrent handlers share one conn
                if self._conn is None or self._conn.closed:
                    self._conn = await rpc.connect(*self._ctrl_addr,
                                                   label="dashboard")
                    await self._conn.call("register", kind="client",
                                          worker_id=f"dashboard-{os.getpid()}",
                                          address=None)
                conn = self._conn
            try:
                return await conn.call(method, **kw)
            except (rpc.ConnectionClosed, ConnectionError, OSError) as e:
                last_exc = e
                async with self._conn_lock:
                    if self._conn is conn:  # don't drop a fresher reconnect
                        self._conn = None
        raise last_exc

    # ------------------------------------------------------------ server
    def start(self) -> int:
        """Bind and serve; returns the bound port."""

        async def _up():
            from aiohttp import web

            app = web.Application()
            app.router.add_get("/", self._index)
            app.router.add_get("/api/version", self._version)
            app.router.add_get("/api/cluster_status", self._cluster_status)
            app.router.add_get("/api/nodes", self._nodes)
            app.router.add_get("/api/actors", self._actors)
            app.router.add_get("/api/tasks", self._tasks)
            app.router.add_get("/api/objects", self._objects)
            app.router.add_get("/api/jobs", self._jobs)
            app.router.add_get("/api/events", self._events)
            app.router.add_get("/api/timeline", self._timeline)
            app.router.add_get("/api/timeseries", self._timeseries)
            app.router.add_get("/api/profiles", self._profiles)
            app.router.add_get("/api/traces", self._traces)
            app.router.add_get("/api/stacks", self._stacks)
            app.router.add_get("/api/metrics", self._metrics_json)
            app.router.add_get("/metrics", self._metrics_prom)
            runner = web.AppRunner(app, access_log=None)
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            self._runner = runner
            for s in site._server.sockets:  # resolve port=0
                self.port = s.getsockname()[1]
            return self.port

        return self._io.run(_up(), timeout=30)

    def stop(self):
        if self._runner is not None:
            async def _down():
                await self._runner.cleanup()
                if self._conn is not None:
                    await self._conn.close()

            try:
                self._io.run(_down(), timeout=10)
            except Exception:
                pass
        self._io.stop()

    # ---------------------------------------------------------- handlers
    async def _index(self, request):
        from aiohttp import web

        return web.Response(text=_INDEX_HTML, content_type="text/html")

    async def _version(self, request):
        from aiohttp import web

        import ray_tpu_torch

        return web.json_response(
            {"ray_tpu_torch": getattr(ray_tpu_torch, "__version__", "dev"),
             "time": time.time()})

    async def _cluster_status(self, request):
        from aiohttp import web

        res = await self._a_call("cluster_resources")
        dem = await self._a_call("resource_demand")
        return web.json_response({
            "total": res["total"], "available": res["available"],
            "demand": dem["demand"], "pg_demand": dem["pg_demand"],
        })

    async def _nodes(self, request):
        from aiohttp import web

        snap = await self._a_call("state_snapshot")
        return web.json_response({"nodes": [
            {"node_id": nid, **info} for nid, info in snap["nodes"].items()]})

    async def _actors(self, request):
        from aiohttp import web

        snap = await self._a_call("state_snapshot")
        return web.json_response({"actors": [
            {"actor_id": aid, **info} for aid, info in snap["actors"].items()]})

    async def _tasks(self, request):
        from aiohttp import web

        limit = int(request.query.get("limit", 1000))
        rep = await self._a_call("list_tasks", limit=limit)
        return web.json_response({"tasks": rep["tasks"]})

    async def _objects(self, request):
        from aiohttp import web

        limit = int(request.query.get("limit", 1000))
        rep = await self._a_call("list_objects", limit=limit)
        return web.json_response({"objects": rep["objects"]})

    async def _jobs(self, request):
        from aiohttp import web

        rep = await self._a_call("list_jobs")
        return web.json_response({"jobs": rep["jobs"]})

    async def _stacks(self, request):
        """Live thread stacks of a worker:
        /api/stacks?worker_id=...[&node_id=...] (reference: the reporter
        agent's py-spy endpoints, dashboard/modules/reporter/)."""
        from aiohttp import web

        wid = request.query.get("worker_id")
        if not wid:
            return web.json_response(
                {"error": "worker_id query param required"}, status=400)
        rep = await self._a_call("worker_stacks", worker_id=wid,
                                 node_id=request.query.get("node_id"))
        return web.json_response(rep)

    async def _events(self, request):
        """Cluster event plane (README "Cluster events"):
        /api/events?entity=&kind=&severity=&since=&limit= — lifecycle
        history with seq-cursor polling (`next_seq` in the reply)."""
        from aiohttp import web

        kw: dict = {"limit": int(request.query.get("limit", 1000))}
        for key in ("entity", "kind", "severity"):
            if request.query.get(key):
                kw[key] = request.query[key]
        if request.query.get("since"):
            kw["since"] = int(request.query["since"])
        rep = await self._a_call("list_events", **kw)
        return web.json_response(rep)

    async def _timeseries(self, request):
        """Telemetry timeseries (README "Telemetry & profiling"):
        /api/timeseries?series=&node_id=&since= — series match exactly or
        by prefix (`node.` = family); needs a cluster running with
        RT_TELEMETRY_INTERVAL_S set."""
        from aiohttp import web

        kw = {}
        if request.query.get("series"):
            kw["series"] = request.query["series"]
        if request.query.get("node_id"):
            kw["node_id"] = request.query["node_id"]
        if request.query.get("since"):
            kw["since"] = float(request.query["since"])
        rep = await self._a_call("timeseries", **kw)
        return web.json_response(rep)

    async def _profiles(self, request):
        """Captured worker profiles: /api/profiles lists the registry;
        /api/profiles?name=<name-or-prefix> fetches one persisted profile
        document (collapsed stacks + Chrome-trace events)."""
        from aiohttp import web

        name = request.query.get("name")
        if not name:
            limit = int(request.query.get("limit", 1000))
            rep = await self._a_call("list_profiles", limit=limit)
            return web.json_response(rep)
        rep = await self._a_call("get_profile", name=name)
        if not rep.get("found"):
            return web.json_response(rep, status=404)
        return web.json_response(rep)

    async def _metrics_json(self, request):
        from aiohttp import web

        rep = await self._a_call("get_metrics")
        return web.json_response({"metrics": rep["metrics"]})

    async def _metrics_prom(self, request):
        """Prometheus exposition text (reference: the dashboard's metrics
        endpoint scraped by Prometheus)."""
        from aiohttp import web

        rep = await self._a_call("get_metrics")
        return web.Response(text=render_prometheus(rep["metrics"]),
                            content_type="text/plain")

    async def _traces(self, request):
        """Distributed-tracing index (README "Tracing & timeline"):
        /api/traces lists indexed traces; /api/traces?trace_id=... returns
        one trace rendered as Chrome-trace-event JSON (load the
        `traceEvents` doc in Perfetto), plus the raw spans."""
        from aiohttp import web

        tid = request.query.get("trace_id")
        if not tid:
            limit = int(request.query.get("limit", 1000))
            rep = await self._a_call("list_traces", limit=limit)
            return web.json_response({"traces": rep["traces"]})
        rep = await self._a_call("get_trace", trace_id=tid)
        if not rep.get("found"):
            return web.json_response(
                {"error": f"trace {tid!r} not found"}, status=404)
        from ray_tpu_torch.scripts.cli import _chrome_trace_events

        events = _chrome_trace_events(rep["spans"])
        events.sort(key=lambda e: e.get("ts", 0.0))
        return web.json_response({
            "trace_id": rep.get("trace_id"), "name": rep.get("name"),
            "start": rep.get("start"), "end": rep.get("end"),
            "complete": rep.get("complete"), "spans": rep["spans"],
            "traceEvents": events, "displayTimeUnit": "ms"})

    async def _timeline(self, request):
        from aiohttp import web

        rep = await self._a_call("get_task_events")
        # Same chrome-trace shaping as ray_tpu_torch.timeline() (reference
        # _private/state.py:965), rendered server-side for curl users.
        events = rep["events"]
        node_pid: dict[str, int] = {}
        trace: list[dict] = []
        for ev in events:
            pid = node_pid.setdefault(ev["node_id"], len(node_pid) + 1)
            trace.append({
                "ph": "X", "name": ev["name"], "cat": ev["kind"],
                "pid": pid, "tid": int(ev["pid"]),
                "ts": ev["start"] * 1e6,
                "dur": max(1.0, (ev["end"] - ev["start"]) * 1e6),
                "args": {"task_id": ev["task_id"], "ok": ev["ok"],
                         "attempt": ev["attempt"]},
            })
        return web.json_response(trace)


def start_dashboard(address: Optional[str] = None, host: str = "127.0.0.1",
                    port: int = 8265) -> Dashboard:
    """Start a dashboard against `address` (or the current driver's
    cluster). Returns the running Dashboard (stop() when done)."""
    if address is None:
        address = os.environ.get("RT_ADDRESS")
    if address is None:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        if w is not None:
            address = f"{w.controller_addr[0]}:{w.controller_addr[1]}"
    if address is None:
        raise ValueError("no address: pass one, set RT_ADDRESS, or init() first")
    d = Dashboard(address, host, port)
    d.start()
    return d
