"""A torch.profiler Chrome trace's device time charged to the port's layer
spans.

The port's `Transformer` opens a `tf.*` span (`tracing.device_span`, a
`user_annotation` in the trace) around each layer's forward work, and the
engine opens `engine.*` spans around its device phases. A device event (kernel,
copy, memset) is tied by its `correlation` to the runtime call that
launched it, and that call to the host ops open around it on its thread;
the innermost of these that says where the work belongs decides:

- a span of the port's: that span, forward;
- a backward op (`autograd::engine::evaluate_function: XBackward0`): the
  span of the forward op with the same `Sequence number` (the op that made
  the autograd node), backward; a leaf's `AccumulateGrad` that of the
  backward op that fed it;
- torch's own `Optimizer.step#Adam.step` annotation: `adam`;
- none of these, or a backward op whose forward lies in no span:
  `unattributed`.

"bwd" is work launched inside autograd's backward, "fwd" the rest. A trace
with no device events (a CPU run) charges each host op's self time the same
way, at its start. Idle gaps of the first card are named as the work is, by
what the host was in at each gap's middle, on whichever thread entered it
last.
"""

from __future__ import annotations

from harness import trace

#: where a device event belongs: the port's spans' prefixes, torch's
#: optimizer annotation
PREFIXES = ("tf.", "engine.")
ADAM = "Optimizer.step#Adam.step"
BACKWARD = "autograd::engine::evaluate_function: "
UNATTRIBUTED = "unattributed"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STACK_CATS = ("cpu_op", "user_annotation")

#: the per-layer metrics of a training step: device ms per step of these
#: spans, forward and backward summed
METRICS = {
    "train.products_ms": ("tf.attn.proj", "tf.mlp.proj"),
    "train.norm_ms": ("tf.norm",),
    "train.rope_ms": ("tf.attn.rope",),
    "train.cast_ms": ("tf.cast",),
    "train.mlp_act_ms": ("tf.mlp.act",),
    "train.head_loss_ms": ("tf.head", "tf.loss"),
    "train.adam_ms": ("adam",),
}


def _seq(e: dict):
    return e.get("args", {}).get("Sequence number")


def _fed_seq(e: dict):
    """A backward op's sequence number; for a leaf's gradient accumulation
    (`AccumulateGrad`, which has none) that of the backward op before it on
    its thread, whose gradient it takes: the engine runs it first once it
    is ready."""
    seq = _seq(e)
    return seq if seq is not None else e.get("_fed_by")


def _where(stack: list) -> tuple:
    """(kind, value, entered) of the innermost event of a host stack that
    says where work belongs: ("span", name), ("bwd", sequence number) or
    ("adam", None); ("none", None, None) where none does."""
    for e in reversed(stack):
        name = e["name"]
        if e.get("cat") == "user_annotation" and name.startswith(PREFIXES):
            return "span", name, e["ts"]
        if name.startswith(BACKWARD) and _fed_seq(e) is not None:
            return "bwd", _fed_seq(e), e["ts"]
        if name == ADAM:
            return "adam", None, e["ts"]
    return "none", None, None


def _sweep(events: list, queries: list) -> list:
    """For each query (ts, tag) on one thread, in time order, the host ops
    open at ts, innermost last: [(tag, stack, in_backward)]. `events` are
    the thread's host ops sorted by start, parents first; each gets
    `_child_us`, the time of its direct children."""
    out, stack = [], []

    def pop_ended(ts):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ts:
            stack.pop()

    def push(e):
        pop_ended(e["ts"])
        if stack:
            stack[-1]["_child_us"] += e["dur"]
        e["_child_us"] = 0.0
        stack.append(e)

    todo = iter(events)
    e = next(todo, None)
    for ts, tag in sorted(queries, key=lambda q: q[0]):
        while e is not None and e["ts"] <= ts:
            push(e)
            e = next(todo, None)
        pop_ended(ts)
        bwd = any(x["name"].startswith(BACKWARD) for x in stack)
        out.append((tag, list(stack), bwd))
    while e is not None:  # the children of ops after the last query
        push(e)
        e = next(todo, None)
    return out


def reduce(doc: dict, steps: int) -> dict:
    """Per profiled step: `device_ms`, and under `spans` for each span name
    (and `adam`, `unattributed`) `ms` and `kernels`, with `fwd_ms`,
    `bwd_ms`, `fwd_kernels`, `bwd_kernels`; `idle_ms` by span name."""
    events = [dict(e) for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    for e in events:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    by_tid: dict = {}
    for e in events:
        if e.get("cat") in STACK_CATS:
            by_tid.setdefault(e.get("tid"), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        last = None
        for e in evs:
            if e["name"].startswith(BACKWARD):
                if _seq(e) is None:
                    e["_fed_by"] = last
                else:
                    last = _seq(e)
    dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    # what to place: device events at their launches, else (a CPU run)
    # every host op at its start; forward ops with a sequence number too
    queries: dict = {tid: [] for tid in by_tid}
    stray = []  # device events launched from no host op
    if dev:
        for d in dev:
            call = launch.get(d.get("args", {}).get("correlation"))
            if call is None or call.get("tid") not in queries:
                stray.append(d)
            else:
                queries[call["tid"]].append((float(call["ts"]),
                                             ("item", d)))
    else:
        for tid, evs in by_tid.items():
            queries[tid] += [(e["ts"], ("item", e)) for e in evs
                             if e.get("cat") == "cpu_op"]
    for tid, evs in by_tid.items():
        queries[tid] += [(e["ts"], ("fwd", e)) for e in evs
                         if e.get("cat") == "cpu_op"
                         and _seq(e) is not None
                         and not e["name"].startswith(BACKWARD)]
    placed = []
    span_of_seq: dict = {}
    for tid, evs in by_tid.items():
        for (kind, e), stack, bwd in _sweep(evs, queries[tid]):
            if kind == "item":
                placed.append((e, stack, bwd))
            elif not bwd:
                # in time order, so the last op to carry n wins: the one
                # that made node n (an op that makes none carries the
                # number the next node will take)
                where = _where(stack)
                span_of_seq[_seq(e)] = where[1] if where[0] == "span" \
                    else None
    spans: dict = {}

    def charge(name, bwd, us):
        s = spans.setdefault(name, {"fwd_ms": 0.0, "bwd_ms": 0.0,
                                    "fwd_kernels": 0, "bwd_kernels": 0})
        d = "bwd" if bwd else "fwd"
        s[f"{d}_ms"] += us * 1e-3
        s[f"{d}_kernels"] += 1

    def name_of(where) -> str:
        kind, value, _ = where
        if kind == "span":
            return value
        if kind == "bwd":
            return span_of_seq.get(value) or UNATTRIBUTED
        return "adam" if kind == "adam" else UNATTRIBUTED

    for d in stray:
        charge(UNATTRIBUTED, False, d["dur"])
    for e, stack, bwd in placed:
        us = e["dur"] if dev else e["dur"] - e["_child_us"]
        charge(name_of(_where(stack)), bwd, us)
    out_spans = {}
    for name, s in sorted(spans.items()):
        out_spans[name] = {k: v / steps for k, v in s.items()}
        out_spans[name]["ms"] = (s["fwd_ms"] + s["bwd_ms"]) / steps
        out_spans[name]["kernels"] = (
            s["fwd_kernels"] + s["bwd_kernels"]) / steps
    total_us = sum((e["dur"] if dev else e["dur"] - e["_child_us"])
                   for e in (dev or [e for e, _, _ in placed]))
    return {"steps": steps, "device_ms": total_us * 1e-3 / steps,
            "spans": out_spans,
            "idle_ms": _idle(events, dev, by_tid, name_of, steps)}


def _idle(events, dev, by_tid, name_of, steps: int) -> dict:
    """The first card's idle gaps over the traced window, per step, named
    by where the host was at each gap's middle."""
    if not dev:
        return {}
    card = dev[0].get("args", {}).get("device", dev[0].get("pid"))
    busy = trace._union(
        (e["ts"], e["ts"] + e["dur"]) for e in dev
        if e.get("args", {}).get("device", e.get("pid")) == card)
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    # each gap's middle on every thread; the thread that entered its
    # deciding op last names it
    named: dict = {gap: ("none", None, None) for gap in gaps}
    for evs in by_tid.values():
        for gap, stack, _ in _sweep(evs, [((s + e) / 2, (s, e))
                                          for s, e in gaps]):
            where = _where(stack)
            if where[0] != "none" and (named[gap][0] == "none"
                                       or where[2] > named[gap][2]):
                named[gap] = where
    out: dict = {}
    for (s, e), where in named.items():
        name = "none" if where[0] == "none" else name_of(where)
        out[name] = out.get(name, 0.0) + (e - s) * 1e-3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def metric(red, name: str):
    """A metric of METRICS from a reduction: None without one, or where
    the trace holds none of the metric's spans (a program without them)."""
    if not red:
        return None
    got = [red["spans"][s]["ms"] for s in METRICS[name]
           if s in red["spans"]]
    return sum(got) if got else None
