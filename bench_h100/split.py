"""A training cell's step on the card, split by the port's layer spans.

    python3 bench_h100/split.py --workload <name> --seed <n> \\
        [--port DIR] [--out FILE]

from the root of a checkout, on the card. It builds the cell's program as
the benchmark does (`kinds/train_batches.py`), runs the check's steps to
warm every shape, times PLAIN_STEPS steps with no profiler, then
profiles the mix's `profile_steps` steps and reduces the trace by
`harness/spans.py`.
One JSON line: the card and its power limit, the step's milliseconds by
the host clock with no profiler and under it, and per profiled step the
device's busy milliseconds, each span's device milliseconds and kernels
(forward and backward), the idle gaps by span and the training metrics of
`spans.METRICS`. `--port DIR` imports the port from another checkout (a
parent commit's, to compare the two in one call); a port with no spans
leaves them out. That checkout is written to: the port builds its kernels
into `DIR/build/ray_tpu_torch`, and the compilers' caches go to
`DIR/build/bench_h100`, as in a run of the benchmark there.

It stands until `kinds/train_batches.py::_profile` returns the same
reduction (PERF.md, section 7); `run.py --trace 1` then does its work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: steps timed with no profiler, after the check's steps have warmed them
PLAIN_STEPS = 10


def main(argv=None, *, device: str = "cuda", root: str = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--port", default=root)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, BENCH_DIR)
    from harness import guards

    port = os.path.abspath(args.port)
    guards.set_environment(port)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness import device as hdev
    from harness import spans, spec, trace

    cuda = device == "cuda"
    if cuda:
        hdev.require_cards(1)
    cell = spec.load_cell(root, args.workload)
    kind = cell.kind_module()
    mix = cell.traffic
    w = kind.widths(cell.config)
    pool = kind.batches(mix, w["vocab_size"], args.seed, mix["pool"])
    _model, _opt, step = kind._program(cell.config, mix, args.seed, device)
    toks = torch.as_tensor(pool, device=device)

    def timed(n: int, offset: int) -> float:
        t0 = time.perf_counter()
        for k in range(n):
            step(toks[(offset + k) % len(pool)])
        if cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    timed(mix["check_steps"], 0)
    plain_ms = timed(PLAIN_STEPS, 0)
    n = mix["profile_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        traced_ms = timed(n, PLAIN_STEPS)
    path = os.path.join(tempfile.mkdtemp(prefix="bench_h100_split_"),
                        "trace.json")
    prof.export_chrome_trace(path)
    doc = trace.load(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    red = spans.reduce(doc, n)
    busy_ms = trace.reduce(doc).busy_s * 1e3 / n
    loaded = sys.modules["ray_tpu_torch"].__file__
    line = {"card": hdev.power_limit() if cuda else "cpu",
            "torch": torch.__version__,
            "port": os.path.dirname(os.path.dirname(loaded)),
            "seed": args.seed, "plain_step_ms": plain_ms,
            "traced_step_ms": traced_ms, "busy_ms": busy_ms,
            "unattributed_share_of_device": (
                red["spans"].get(spans.UNATTRIBUTED, {}).get("ms", 0.0)
                / red["device_ms"]),
            "metrics": {m: spans.metric(red, m) for m in spans.METRICS},
            **red}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
