#!/usr/bin/env python3
"""Two choices the port makes at the wider head dims, timed on one NVIDIA GPU.

    python3 chip_width_probe.py

from the root of a checkout (builds into build/ray_tpu_torch/probe/). It
prints the card's name and power limit, then one JSON line per case:

1. The bf16 flash forward at D = 80 and 96 (Phi-2's and Phi-3-mini's
   heads) through their exact instances, `flash_attention_wgmma_kernel<80>`
   and `<96>`, and through the runtime-width instance of the tile of 128
   that every other D from 72 to 128 runs, built from a copy of
   ops/csrc/flash_attention.cu without the exact D 80/96 dispatch. Both
   are timed in turns (exact, runtime, runtime, exact), each as
   chip_smoke.py phase 2 times a kernel (CUDA events, L2 flushed, median
   of 20), and their outputs and logsumexps must agree bitwise.
2. The decode kernel at long context with few items (one sequence of
   32,768 rows), under `split_plan` as the wrapper runs it (at most
   MAX_SPLITS chunks of a sequence) and with that cap lifted, in turns;
   both held against the plain version.

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
FORWARD_SHAPES = [  # b, s, hq, hkv, d: phase 2's and a multi-query one
    (2, 2048, 32, 32, 80), (2, 2048, 32, 32, 96),
    (2, 2048, 8, 1, 80), (2, 2048, 8, 1, 96)]
DECODE_SHAPES = [  # b, hq, kv, d, s (each sequence full)
    (1, 8, 1, 64, 32768), (1, 1, 1, 64, 32768), (1, 8, 1, 128, 32768),
    (1, 8, 1, 96, 32768), (1, 8, 8, 256, 8192), (1, 8, 1, 256, 32768)]


def _runtime_only_forward(kernels):
    """A Kernel whose library is the forward built from a copy of its
    source whose dispatch has no exact D 80/96 case, so those widths take
    the tile of 128."""
    import ctypes

    lines = (kernels.CSRC / "flash_attention.cu").read_text().splitlines()
    kept = [ln for ln in lines
            if not re.match(r"\s*case (80|96): return", ln)]
    if len(kept) != len(lines) - 2:
        raise AssertionError("the forward's dispatch has no exact D 80/96 "
                             "cases to drop")
    probe = kernels.BUILD_DIR / "probe"
    probe.mkdir(parents=True, exist_ok=True)
    copy = probe / "flash_attention_runtime_only.cu"
    copy.write_text("\n".join(kept) + "\n")
    lib = probe / "flash_attention_runtime_only.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    f"-I{kernels.CSRC}", "-o", str(lib), str(copy)],
                   check=True, capture_output=True, text=True)
    kernel = kernels.Kernel("flash_attention", "flash_attention.cu",
                            "rt_flash_attention",
                            kernels.FLASH_ATTENTION.argtypes)
    handle = ctypes.CDLL(str(lib))
    kernel._fn = handle.rt_flash_attention
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._err = handle.rt_flash_attention_error
    kernel._err.argtypes, kernel._err.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return kernel


def forward_cases(kernels, smoke, flush, gen) -> list[dict]:
    import torch

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    runtime = _runtime_only_forward(kernels)
    exact = kernels.FLASH_ATTENTION
    recs = []
    for b, s, hq, hkv, d in FORWARD_SHAPES:
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()

        def call():
            return fa.flash_attention_cuda(q, k, v, True, with_lse=True)

        outs, times = {}, {"exact": [], "runtime": []}
        for kind in ("exact", "runtime", "runtime", "exact"):
            kernels.FLASH_ATTENTION = exact if kind == "exact" else runtime
            try:
                outs[kind] = call()
                times[kind].append(smoke._timed_ms(call, flush))
            finally:
                kernels.FLASH_ATTENTION = exact
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(outs["exact"],
                                                     outs["runtime"])):
            raise AssertionError(f"D{d}: the two instances disagree")
        rec = {"case": f"forward B{b} S{s} Hq{hq} Hkv{hkv} D{d} bf16 causal "
                       "with lse",
               "exact_ms": statistics.median(times["exact"]),
               "runtime_tile128_ms": statistics.median(times["runtime"]),
               "runs": times}
        rec["runtime_over_exact"] = rec["runtime_tile128_ms"] / rec["exact_ms"]
        print("forward " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def decode_cases(smoke, flush, gen) -> list[dict]:
    import torch

    da = importlib.import_module("ray_tpu_torch.ops.decode_attention")
    shipped = da.MAX_SPLITS
    recs = []
    for b, hq, kv, d, s in DECODE_SHAPES:
        q = torch.randn(b, hq, d, generator=gen, device="cuda").bfloat16()
        kc = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
        vc = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        ref = da._reference_decode_attention(q, kc, vc, lens)

        def call():
            return da.decode_attention_cuda(q, kc, vc, lens)

        rec = {"case": f"decode B{b} Hq{hq} KV{kv} D{d} S{s} bf16"}
        times = {"capped": [], "uncapped": []}
        for kind in ("capped", "uncapped", "uncapped", "capped"):
            da.MAX_SPLITS = shipped if kind == "capped" else 1 << 30
            try:
                smoke._max_err(call(), ref, "bfloat16")
                rec[f"{kind}_plan"] = da.split_plan(b, hq, kv, s, d,
                                                    2)._asdict()
                times[kind].append(smoke._timed_ms(call, flush))
            finally:
                da.MAX_SPLITS = shipped
        rec.update(capped_ms=statistics.median(times["capped"]),
                   uncapped_ms=statistics.median(times["uncapped"]),
                   runs=times)
        print("decode " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_width_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from ray_tpu_torch._private import kernels

    kernels.build_all()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    forward_cases(kernels, smoke, flush, gen)
    decode_cases(smoke, flush, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
