"""Detached head process: controller + local node agent.

Spawned by `ray-tpu-torch start --head` (ray_tpu_torch/scripts/cli.py);
runs until SIGTERM/SIGINT. Writes the session file the CLI and joining
nodes read.

Counterpart: ray_tpu/scripts/head_main.py (copied; `--num-gpus` in place of
`--num-tpus`).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6380)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--session-dir", required=True)
    p.add_argument("--session", default=None,
                   help="restart into an existing session id (controller FT)")
    args = p.parse_args()

    from ray_tpu_torch._private.bootstrap import HeadNode

    head = HeadNode(num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                    resources=json.loads(args.resources),
                    host=args.host, port=args.port, session_id=args.session)
    addr = head.start()
    os.makedirs(args.session_dir, exist_ok=True)
    with open(os.path.join(args.session_dir, "head.json"), "w") as f:
        json.dump({"address": f"{addr[0]}:{addr[1]}", "pid": os.getpid(),
                   "session": head.session_id}, f)
    print(f"ray-tpu-torch head up at {addr[0]}:{addr[1]}", flush=True)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    head.stop()


if __name__ == "__main__":
    sys.exit(main())
