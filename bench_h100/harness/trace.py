"""A torch.profiler Chrome trace reduced to what the metrics read.

- The traced window: from the first event's start to the last event's end,
  host and device events alike.
- Device busy time: the union of the intervals in which a kernel, a copy
  or a memset ran on the card (annotations drawn on the device's timeline
  are not work and are left out), averaged over the cards in the trace.
- Kernel time and count by name.
- Idle gaps: the intervals of the window in which nothing ran on the
  card, each named by the innermost host operation running at its middle,
  summed by that name.
"""

from __future__ import annotations

import json
import zipfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    kernel_us: dict = field(default_factory=dict)
    kernel_count: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def n_kernels(self) -> int:
        return sum(self.kernel_count.values())

    def kernels(self, fragment: str) -> tuple[float, int]:
        """(seconds, launches) of every kernel whose name holds
        `fragment`."""
        names = [n for n in self.kernel_us if fragment in n]
        return (sum(self.kernel_us[n] for n in names) * 1e-6,
                sum(self.kernel_count[n] for n in names))

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def load(path: str) -> dict:
    """A Chrome trace from a .json file or a zip archive holding
    trace.json (the runtime's torch captures)."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            return json.loads(z.read("trace.json"))
    with open(path) as f:
        return json.load(f)


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and its parameter list (the
    parenthesis that closes the name and the one that opens it)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i] or name
    return name


def reduce(doc: dict, top: int = 10) -> Reduced:
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError("the trace holds no events")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_card: dict = {}
    for e in dev:
        card = e.get("args", {}).get("device", e.get("pid"))
        by_card.setdefault(card, []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    busy_us = (sum(sum(b - a for a, b in _union(iv))
                   for iv in by_card.values()) / len(by_card)
               if by_card else 0.0)
    red = Reduced(window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6)
    for e in dev:
        if e.get("cat") != "kernel":
            continue
        name = _short(e["name"])
        red.kernel_us[name] = red.kernel_us.get(name, 0.0) + float(e["dur"])
        red.kernel_count[name] = red.kernel_count.get(name, 0) + 1
    by_op: dict = {}
    for e in dev:
        name = _short(e["name"]) if e.get("cat") == "kernel" else e["cat"]
        by_op[name] = by_op.get(name, 0.0) + float(e["dur"]) * 1e-6
    red.device_ops = [[n[:160], s] for n, s in
                      sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]
    # idle gaps of the first card, named by the host's innermost op
    busy = _union(next(iter(by_card.values()))) if by_card else []
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    by_gap: dict = {}
    # a sweep over the gaps' middles in time order: `open_` holds the host
    # ops begun so far, the latest begun on top; an op ended before the
    # current middle has ended for every later one too
    open_, i = [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            open_.append(host[i])
            i += 1
        while open_ and open_[-1][1] <= mid:
            open_.pop()
        name = open_[-1][2] if open_ else "no host op"
        by_gap[name] = by_gap.get(name, 0.0) + (e - s) * 1e-6
    red.idle_gaps = [[n[:160], s] for n, s in
                     sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]]
    return red
