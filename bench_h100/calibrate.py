"""Read the numbers a cell's limits are set from, on the card, at the
cell's own size, in one process.

    python3 bench_h100/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 15 [--out FILE]

For each seed it runs the cell once with a short window (the sizes, the
batch and the load of the cell, as the benchmark runs them) and prints the
program's compared numbers: the lower readings. For each control seed it
also computes the control, the reference in float8, in the program's
place, and for a training cell the reference over half of each batch
(half of the batch left out, the mean taken over the rest): the upper
readings. The benchmark's own runs never compute them.

Each reading goes through the comparison that decides `correct`
(`run.judge` against `checks/<cell>.json`), and the row prints its
verdict: `correct` for the program, the control and each fault. The
control and a fault take the program's place in the compared numbers they
read; the run's other numbers (requests unanswered, tokens judged) are the
program's, since the control reads the same positions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _release_card(device: str) -> None:
    """Give the reference's cached memory back before the next seed."""
    import gc

    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()


def main(argv=None, *, device: str = "cuda", root: str = ROOT) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, BENCH_DIR)
    from harness import guards

    guards.set_environment(root)
    from harness import spec
    from run import judge

    cell = spec.load_cell(root, args.workload)
    kind = cell.kind_module()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        t0 = time.time()
        res = kind.run(cell, seed, args.seconds, False, device, t0,
                       control=seed in controls)
        prog = res["readings"]
        ctl = res.get("control_readings")
        faults = res.get("fault_readings") or {}
        verdicts = {"program": judge(prog, cell.check)[0]}
        if ctl is not None:
            verdicts["control"] = judge({**prog, **ctl}, cell.check)[0]
        for name, read in faults.items():
            verdicts[name] = judge({**prog, **read}, cell.check)[0]
        row = {"workload": args.workload, "seed": seed,
               "correct": verdicts, "program": prog, "control": ctl,
               "faults": faults or None,
               "setup_s": res["record"]["setup_s"],
               "reference_s": res["reference_s"],
               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
               "seconds": time.time() - t0}
        del res
        _release_card(device)
        line = json.dumps(row, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
