#!/usr/bin/env python3
"""Where the flash-attention backward's time goes, on one NVIDIA GPU.

    python3 chip_bwd_probe.py
    python3 chip_bwd_probe.py --rows [--tree DIR]

from the root of a checkout (builds into build/ray_tpu_torch/probe/).

With no argument, at the training shape (B4 S1024 H16 D64 bf16 causal,
chip_smoke.py's BWD_MAIN) and phase 2's GQA row, the kernel in turns with
copies of it that each change one thing (VARIANTS), each timed like phase
2 (CUDA events, median of 20, L2 flushed by a 256 MB write before each
launch): without the dQ reduce-adds (dQ is still staged in shared memory),
without the named barrier between the two consumer warpgroups (their
results are then wrong: timing only), and with a two-stage Q / dO ring.

With --rows, every backward row of PERF.md's kernel table (chip_smoke.py's
BWD_TABLE), each held to the plain backward and timed like phase 2, one
JSON line a row, using the ray_tpu_torch of the checkout DIR (default:
this one) and building only its flash kernels: so two checkouts can be
timed in turns in one call on one card.

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import statistics
import sys

from chip_decode_probe import _build, _smi, _smoke

REPO = os.path.dirname(os.path.abspath(__file__))
PROBE_ROWS = ("backward B4 S1024 H16 D64 bf16 causal",
              "backward GQA Hq16 Hkv4 Sq512 < Sk1024 d64 bf16 causal")

# Copies of the kernel that each change one thing, timed beside it: name ->
# [(text, replacement)] applied to ops/csrc/flash_attention_bwd.cu.
VARIANTS = {
    "no dQ reduce-adds": [
        ("                                   tid == 0 && cols > 0);",
         "                                   false);")],
    "no warpgroup barrier": [
        ("          named_bar_sync(1, 2 * kWgThreads);\n", "")],
    "two-stage ring": [
        ("  return DT == 256 ? 2 : 3;\n", "  return 2;\n")],
}


def _kernel_from(handle, kernels):
    """A Kernel whose launches go to `handle`'s rt_flash_attention_bwd."""
    kernel = kernels.Kernel("flash_attention_bwd", "flash_attention_bwd.cu",
                            "rt_flash_attention_bwd",
                            kernels.FLASH_ATTENTION_BWD.argtypes)
    kernel._fn = handle.rt_flash_attention_bwd
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._err = handle.rt_flash_attention_bwd_error
    kernel._err.argtypes, kernel._err.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return kernel


def _inputs(row, gen):
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_attention_cuda

    b, sq, sk, hq, hkv, d, dtype, causal = row
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    dout = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
    return q, k, v, out, dout, lse, causal


def rows(tree: str) -> int:
    """--rows: every backward row of the table through `tree`'s kernel."""
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    smoke = _smoke()
    from ray_tpu_torch._private import kernels
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    if not fa.__file__.startswith(tree):
        raise SystemExit(f"ray_tpu_torch came from {fa.__file__}, not {tree}")
    for k in (kernels.FLASH_ATTENTION, kernels.FLASH_ATTENTION_BWD):
        k._load()
    print(_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, row in smoke.BWD_TABLE.items():
        args = _inputs(row, gen)

        def call():
            return fa.flash_attention_backward_cuda(*args)

        grads, refs = call(), fa._reference_flash_attention_backward(*args)
        err = max(smoke._max_err(g, r, row[6]) for g, r in zip(grads, refs))
        print("row " + json.dumps({
            "tree": tree, "case": name, "max_abs_err": err,
            "ms": smoke._timed_ms(call, flush)}), flush=True)
        del args, grads, refs
    return 0


def probe() -> int:
    import torch

    sys.path.insert(0, REPO)
    smoke = _smoke()
    from ray_tpu_torch._private import kernels
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    for k in (kernels.FLASH_ATTENTION, kernels.FLASH_ATTENTION_BWD):
        k._load()
    print(_smi(), flush=True)
    shipped = kernels.FLASH_ATTENTION_BWD
    source = (kernels.CSRC / "flash_attention_bwd.cu").read_text()
    sources = {}
    for i, edits in enumerate(VARIANTS.values()):
        src = source
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant text not in the kernel: {old!r}")
            src = src.replace(old, new)
        sources[f"bwd_variant{i}"] = src
    libs = _build(sources, kernels)
    variants = {name: _kernel_from(libs[f"bwd_variant{i}"], kernels)
                for i, name in enumerate(VARIANTS)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name in PROBE_ROWS:
        row = smoke.BWD_TABLE[name]
        args = _inputs(row, gen)

        def call():
            return fa.flash_attention_backward_cuda(*args)

        kinds = ["kernel", *variants]
        times = {kind: [] for kind in kinds}
        for turn in range(2):
            for kind in (kinds if turn == 0 else kinds[::-1]):
                kernels.FLASH_ATTENTION_BWD = shipped if kind == "kernel" \
                    else variants[kind]
                try:
                    times[kind].append(smoke._timed_ms(call, flush))
                finally:
                    kernels.FLASH_ATTENTION_BWD = shipped
        print("variants " + json.dumps({
            "case": name, **{kind: statistics.median(ts)
                             for kind, ts in times.items()}}), flush=True)
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", action="store_true")
    parser.add_argument("--tree", default=REPO)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_bwd_probe: CUDA is not available", file=sys.stderr)
        return 1
    return rows(args.tree) if args.rows else probe()


if __name__ == "__main__":
    sys.exit(main())
