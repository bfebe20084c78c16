"""Run one cell of the H100 benchmark of ray_tpu_torch once.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the port
(`ray_tpu_torch`). The cell's configuration, traffic mix, limits and
metric readers are found by name (harness/spec.py). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`check`, each compared number beside its limit; the same numbers are the
last lines of standard error.

It exits non-zero and prints no result when CUDA is not available or has
fewer cards than the cell asks for, when the run loaded a module of JAX
or of the JAX package, when it left a file of the runtime in /dev/shm, or
when anything fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def process_start() -> float:
    """When this process started, on the wall clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(readings: dict, check: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit: `max` (at most) or `min` (at
    least)."""
    out, ok = {}, True
    for name, lim in check["limits"].items():
        value = readings.get(name)
        if value is None or (isinstance(value, float) and math.isnan(value)):
            ok = False
            out[name] = {"value": None, **_limit(lim)}
            continue
        if "max" in lim:
            ok = ok and value <= lim["max"]
        else:
            ok = ok and value >= lim["min"]
        out[name] = {"value": value, **_limit(lim)}
    return ok, out


def _limit(lim: dict) -> dict:
    return {"max": lim["max"]} if "max" in lim else {"min": lim["min"]}


def _finite(x):
    """A number as JSON holds it: not-a-number and infinities as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None, *, device: str = "cuda", root: str = ROOT) -> int:
    args = parse(argv)
    sys.path.insert(0, BENCH_DIR)
    from harness import guards

    guards.set_environment(root)
    from harness import spec

    cell = spec.load_cell(root, args.workload)
    if device == "cuda":
        from harness import device as hdev

        hdev.require_cards(int(cell.entry["chips"]))
        card = hdev.power_limit()
    else:
        card = "cpu"
    shm_before = guards.shm_files()
    kind = cell.kind_module()
    res = kind.run(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    rec = res["record"]
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = spec.reader(m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, check = judge(res["readings"], cell.check)
    left = guards.shm_files() - shm_before
    if left:
        print(f"bench_h100: the run left {sorted(left)} in /dev/shm",
              file=sys.stderr)
        return 3
    bad = guards.forbidden_modules()
    if bad:
        print(f"bench_h100: the run loaded {bad}", file=sys.stderr)
        return 4
    if device == "cuda":
        from harness import device as hdev

        dev = hdev.describe(int(cell.entry["chips"]))
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev.update(res["device"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    line["check"] = check
    print(json.dumps({"card": card, "setup_s": rec.get("setup_s"),
                      "reference_s": res.get("reference_s"),
                      "detail": res.get("detail")}, default=str),
          file=sys.stderr)
    for name, c in check.items():
        bound = (f"limit at most {c['max']}" if "max" in c
                 else f"limit at least {c['min']}")
        print(f"check {name}: {c['value']} ({bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - the entry's boundary: report
        traceback.print_exc()
        sys.exit(1)
