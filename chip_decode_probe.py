#!/usr/bin/env python3
"""Where the decode kernel's time goes, on one NVIDIA GPU.

    python3 chip_decode_probe.py [--plans]
    python3 chip_decode_probe.py --rows [--tree DIR]

from the root of a checkout (builds into build/ray_tpu_torch/probe/).

With no argument, at chip_smoke.py's decode rows named in PROBE_ROWS (the
serving width B8 Hq16 KV16 D64 S1024 bf16, one query head a block on
CUDA cores; the long-context row B1 Hq8 KV1 D64 S32768, 8 heads a block
on tensor cores and both levels of the merge tree; Gemma-2B's and
Phi-3-mini's rows; a small f32 one), it prints:

1. The kernel in turns with copies of it that each change one thing
   (VARIANTS), each timed like phase 2 (CUDA events, median of 20, L2
   flushed by a 256 MB write before each launch). One copy is the read
   floor: its consumer warps release each stage as soon as it lands (the
   bulk copies, the ring, the block's combine and the merge tree, with no
   arithmetic on the rows). At D64 with 16 KV heads also a kernel that
   loads the same rows through registers, 16 bytes a lane (the previous
   design's way of reading).
2. With --plans, at D <= 64 with several KV heads, the kernel under other
   split plans: blocks per SM (BLOCKS_PER_SM) and rows a chunk holds at
   least (MIN_CHUNK_ROWS) of ops/decode_attention.py.
3. For the rows marked so, a per-block timeline of one launch: a copy of
   the kernel with %globaltimer stamps at its phase boundaries (start,
   barriers set up and length read, rows streamed, the chunk's partial
   written, the first and the second level of the merge written), as
   percentiles over the blocks.

With --rows, every decode row of PERF.md's kernel table (chip_smoke.py's
DECODE_TABLE), each held to the plain version and timed like phase 2,
with the wrapper's host microseconds per call, one JSON line a row, using
the ray_tpu_torch of the checkout DIR (default: this one) and building
only its decode kernel: so two checkouts can be timed in turns in one call
on one card.

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PROBE_ROWS = [  # (name in chip_smoke.DECODE_TABLE, with the timeline)
    ("serving B8 Hq16 KV16 D64 S1024 bf16", True),
    ("tp=2 per rank B8 Hq8 KV8 D64 S1024 bf16", False),
    ("serving heads B8 Hq16 KV16 D32 S1024 bf16", False),
    ("Phi-2 B8 Hq32 KV32 D80 S2048 bf16", False),
    ("f32 B2 Hq4 KV4 D16 S64", True),
    ("long context B1 Hq8 KV1 D64 S32768 bf16", True),
    ("Gemma-2B MQA B8 Hq8 KV1 D256 S8192 bf16", False),
    ("Phi-3-mini B8 Hq32 KV32 D96 S4096 bf16", False),
    ("Gemma-2B served B8 Hq8 KV8 D256 S8192 bf16", False),
]

READ_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// One block per (b, kv head, 128-row chunk below the length): loads the
// chunk's K and V rows, 16 bytes a lane, and folds them into one word.
__global__ void read_rows(const uint4* k, const uint4* v, const int* lens,
                          int* out, int S, int KV, int pieces) {
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int r0 = blockIdx.y * 128, len = min(lens[b], S);
  if (r0 >= len) return;
  const int lane = threadIdx.x % pieces, sub = threadIdx.x / pieces;
  const int rows_at_once = blockDim.x / pieces;
  uint32_t acc = 0;
  for (int r = r0 + sub; r < min(r0 + 128, len); r += rows_at_once) {
    const size_t o = (((size_t)b * S + r) * KV + h) * pieces + lane;
    const uint4 a = k[o], c = v[o];
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ c.x ^ c.y ^ c.z ^ c.w;
  }
  if (acc == 0x9e3779b9u) out[0] = 1;
}
extern "C" int run_read_rows(const void* k, const void* v, const void* lens,
                             void* out, int B, int S, int KV, int D,
                             void* stream) {
  const int pieces = D / 8;
  read_rows<<<dim3(B * KV, (S + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)k, (const uint4*)v, (const int*)lens, (int*)out, S, KV,
      pieces);
  return (int)cudaGetLastError();
}
"""

# The consumers' stage loop in both consumer functions of the kernel.
STAGE_ANCHOR = ("    const int n = min(kTile, w.row_end - (w.row_begin + it * "
                "kTile));\n")
READ_ONLY = STAGE_ANCHOR + """    if (n > 0) {  // read floor: release the stage unread
      __syncwarp();
      mbar_arrive_if(bars + 8 * (stages + slot), lane == 0);
      continue;
    }
"""

# Copies of the kernel that each change one thing, timed beside it: name ->
# [(text, replacement)] applied to ops/csrc/decode_attention.cu.
VARIANTS = {
    "bulk-copy floor": [(STAGE_ANCHOR, READ_ONLY)],
    # CUDA-core stages of 8 KB of K up to DT = 64 too (64 rows at D64 bf16)
    "8 KB stages": [
        ("  return GAP ? (DT < 256 ? 16384 : 8192) : (DT <= 64 ? 2048 : 8192);",
         "  return GAP ? (DT < 256 ? 16384 : 8192) : 8192;")],
    # a partial stage among several KV heads by one tensor copy, rows past
    # the length included (the kernel copies only rows below it)
    "partial stages copied whole": [
        ("    } else if (GAP == 0 && KV > 1 && n == kTile) {",
         "    } else if (GAP == 0 && KV > 1) {"),
        ("      mbar_expect_tx(full, swizzled ? 2 * n_panels * kPanelBytes : "
         "2 * n * rb);",
         "      mbar_expect_tx(full, swizzled ? 2 * n_panels * kPanelBytes : "
         "GAP == 0 && KV > 1 ? 2 * kTile * rb : 2 * n * rb);")],
    # the merge's batches of partials at 8 on CUDA cores too
    "CUDA-core merge batches of 8": [("  finish<T, REP, 4>(", "  finish<T, REP, 8>(")],
    "2 rows in flight": [
        ("  constexpr int kUnroll = NV * VEC * REP <= 8 ? 4 : "
         "NV * VEC * REP <= 32 ? 2 : 1;",
         "  constexpr int kUnroll = NV * VEC * REP <= 32 ? 2 : 1;")],
    # the other split order (lowest first on CUDA cores, highest first on
    # tensor cores)
    "other split order": [
        ("  w.split = kLowestFirst ? blockIdx.y : n_splits - 1 - blockIdx.y;",
         "  w.split = kLowestFirst ? n_splits - 1 - blockIdx.y : blockIdx.y;")],
    # no minimum of blocks an SM (so no register cap) on tensor cores
    "no tensor-core register cap": [
        ("__global__ void __launch_bounds__(kThreads, (DT == 256 ? 2 : 3))",
         "__global__ void __launch_bounds__(kThreads)")],
}

# Stamps inserted into a copy of the kernel: (anchor, text put before or
# after it). A stamp is thread 0's %globaltimer in slot i of its block.
N_STAMPS = 6
STAMPS = [
    ("  const Work w =\n      work_of<", "  TR(0)\n", "before"),
    ("  if (!has_rows(w, out, d)) return;\n", "  TR(1)\n", "after"),
    ("  __syncthreads();\n  finish<", "  TR(2)\n", "inside"),
    ("  if (n_active == 1) return;\n\n  const int grp", "  TR(3)\n", "before"),
    ("  if (threadIdx.x == 0) *c1 = 0;", "  TR(4)\n", "before"),
    ("  if (threadIdx.x == 0) *c2 = 0;", "  TR(5)\n", "before"),
]
TRACE_HEADER = r"""
__device__ unsigned long long g_trace[65536 * 6];
#define TR(i) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 6 + (i)] = t_; }
"""
TRACE_FOOTER = r"""
extern "C" int rt_trace_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, n * 8);
}
extern "C" int rt_trace_clear(int n) {
  void* p;
  cudaGetSymbolAddress(&p, g_trace);
  return (int)cudaMemset(p, 0, n * 8);
}
"""


def _build(sources: dict, kernels) -> dict:
    """{name: CDLL} of {name: CUDA source}, one nvcc each, all at once."""
    out_dir = os.path.join(REPO, "build", "ray_tpu_torch", "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(source)
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC), "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the probe's {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _kernel_from(handle, kernels):
    """A Kernel whose launches go to `handle`'s rt_decode_attention."""
    kernel = kernels.Kernel("decode_attention", "decode_attention.cu",
                            "rt_decode_attention",
                            kernels.DECODE_ATTENTION.argtypes)
    kernel._fn = handle.rt_decode_attention
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._err = handle.rt_decode_attention_error
    kernel._err.argtypes, kernel._err.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return kernel


def _patched(kernels, edits) -> str:
    src = (kernels.CSRC / "decode_attention.cu").read_text()
    for anchor, text, where in edits:
        if anchor not in src:
            raise SystemExit(f"anchor not in the kernel: {anchor!r}")
        if where == "before":
            src = src.replace(anchor, text + anchor)
        elif where == "after":
            src = src.replace(anchor, anchor + text)
        else:  # "inside": after the anchor's first line
            head, tail = anchor.split("\n", 1)
            src = src.replace(anchor, f"{head}\n{text}{tail}")
    return src


def _smoke():
    """chip_smoke.py of this checkout (its decode table and timers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_probe", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _inputs(row, gen):
    import torch

    b, hq, kv, d, s, dtype, lengths = row
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def rows(tree: str) -> int:
    """--rows: every decode row of the table through `tree`'s kernel."""
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    smoke = _smoke()
    from ray_tpu_torch._private import kernels
    da = importlib.import_module("ray_tpu_torch.ops.decode_attention")
    if not da.__file__.startswith(tree):
        raise SystemExit(f"ray_tpu_torch came from {da.__file__}, not {tree}")
    kernels.DECODE_ATTENTION._load()
    print(_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, row in smoke.DECODE_TABLE.items():
        q, k, v, lens = _inputs(row, gen)

        def call():
            return da.decode_attention_cuda(q, k, v, lens)

        err = smoke._max_err(call(), da._reference_decode_attention(
            q, k, v, lens), row[5])
        print("row " + json.dumps({
            "tree": tree, "case": name, "max_abs_err": err,
            "ms": smoke._timed_ms(call, flush),
            "host_us_per_call": smoke._host_us_per_call(call)}), flush=True)
    return 0


def probe(plans: bool) -> int:
    import torch

    sys.path.insert(0, REPO)
    smoke = _smoke()
    from ray_tpu_torch._private import kernels
    da = importlib.import_module("ray_tpu_torch.ops.decode_attention")
    kernels.DECODE_ATTENTION._load()
    print(_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shipped = kernels.DECODE_ATTENTION
    source = (kernels.CSRC / "decode_attention.cu").read_text()
    if source.count(STAGE_ANCHOR) != 2:
        raise SystemExit("the consumers' stage anchor is not in the kernel "
                         "twice")
    sources = {"read_rows": READ_PROBE,
               "decode_traced": _patched(kernels, STAMPS).replace(
                   "namespace {\n", "namespace {\n" + TRACE_HEADER, 1)
               + TRACE_FOOTER}
    for i, edits in enumerate(VARIANTS.values()):
        src = source
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant text not in the kernel: {old!r}")
            src = src.replace(old, new)
        sources[f"decode_variant{i}"] = src
    libs = _build(sources, kernels)
    variants = {name: _kernel_from(libs[f"decode_variant{i}"], kernels)
                for i, name in enumerate(VARIANTS)}
    regs = libs["read_rows"]
    regs.run_read_rows.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    traced = libs["decode_traced"]
    traced.rt_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    for name, with_timeline in PROBE_ROWS:
        row = smoke.DECODE_TABLE[name]
        b, hq, kv, d, s, dtype, lengths = row
        q, k, v, lens = _inputs(row, gen)
        elem = 2 if dtype == "bfloat16" else 4
        nbytes = 2 * sum(lengths) * kv * d * elem

        def decode():
            return da.decode_attention_cuda(q, k, v, lens)

        kinds = ["kernel", *variants]
        times = {kind: [] for kind in kinds}
        times["register-load floor"] = []
        for turn in range(2):
            for kind in (kinds if turn == 0 else kinds[::-1]):
                kernels.DECODE_ATTENTION = shipped if kind == "kernel" \
                    else variants[kind]
                try:
                    times[kind].append(smoke._timed_ms(decode, flush))
                finally:
                    kernels.DECODE_ATTENTION = shipped
            if kv == 16 and d == 64:
                times["register-load floor"].append(smoke._timed_ms(
                    lambda: regs.run_read_rows(
                        k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                        sink.data_ptr(), b, s, kv, d, stream), flush))
        rec = {"case": name, "mbytes": nbytes / 1e6,
               "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
               "plan": da.split_plan(b, hq, kv, s, d, elem, sms)._asdict()}
        for kind, ts in times.items():
            if ts:
                rec[kind] = statistics.median(ts)
        print("floor " + json.dumps(rec), flush=True)

        saved = (da.BLOCKS_PER_SM, da.MIN_CHUNK_ROWS)
        for bps in (1, 2, 4, 8) if plans and kv > 1 and d <= 64 else ():
            for mcr in (64, 128, 256):
                da.BLOCKS_PER_SM, da.MIN_CHUNK_ROWS = bps, mcr
                da.split_plan.cache_clear()
                plan = da.split_plan(b, hq, kv, s, d, elem, sms)
                print("plan " + json.dumps({
                    "case": name, "blocks_per_sm": bps,
                    "min_chunk_rows": mcr, "chunk": plan.chunk,
                    "n_splits": plan.n_splits,
                    "ms": smoke._timed_ms(decode, flush)}), flush=True)
        da.BLOCKS_PER_SM, da.MIN_CHUNK_ROWS = saved
        da.split_plan.cache_clear()

        if with_timeline:
            _timeline(name, decode, traced, kernels, da, row, sms, flush)
    return 0


def _timeline(name, decode, traced, kernels, da, row, sms, flush):
    import torch

    b, hq, kv, d, s, dtype, _ = row
    plan = da.split_plan(b, hq, kv, s, d, 2 if dtype == "bfloat16" else 4,
                         sms)
    n = plan.items * plan.n_splits * N_STAMPS
    shipped = kernels.DECODE_ATTENTION
    kernels.DECODE_ATTENTION = _kernel_from(traced, kernels)
    spans = []
    try:
        for _ in range(6):
            decode()
            traced.rt_trace_clear(n)
            flush.zero_()
            decode()
            torch.cuda.synchronize()
            buf = np.zeros(n, np.uint64)
            traced.rt_trace_read(buf.ctypes.data, n)
            tr = buf.reshape(-1, N_STAMPS).astype(np.int64)
            t0 = tr[:, 0][tr[:, 0] > 0].min()
            act = tr[:, 1] > 0
            l1, l2 = tr[:, 4] > 0, tr[:, 5] > 0
            end = max(tr[act, 3].max(), tr[:, 4].max(), tr[:, 5].max())
            spans.append((end - t0) / 1e3)
    finally:
        kernels.DECODE_ATTENTION = shipped
    pct = lambda x: np.round(np.percentile(x / 1e3, (50, 90, 100)), 2) \
        if len(x) else []  # noqa: E731
    print(f"timeline {name} (us, median / p90 / max over blocks; span "
          f"median {statistics.median(spans):.2f} us over {len(spans)} "
          f"launches; {int(act.sum())} active blocks of {len(tr)}, "
          f"{int(l1.sum())} first-level and {int(l2.sum())} second-level "
          f"mergers):")
    print("  start -> barriers set   ", pct(tr[act, 1] - tr[act, 0]))
    print("  barriers -> streamed    ", pct(tr[act, 2] - tr[act, 1]))
    print("  streamed -> partial     ", pct(tr[act, 3] - tr[act, 2]))
    print("  partial -> level 1 done ", pct(tr[l1, 4] - tr[l1, 3]))
    print("  level 1 -> level 2 done ", pct(tr[l2, 5] - tr[l2, 4]))
    print("  streamed at             ", pct(tr[act, 2] - t0))
    print("  level 1 written at      ", pct(tr[l1, 4] - t0))
    print("  level 2 written at      ", pct(tr[l2, 5] - t0), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", action="store_true")
    parser.add_argument("--tree", default=REPO)
    parser.add_argument("--plans", action="store_true",
                        help="also time the kernel under other split plans")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_decode_probe: CUDA is not available", file=sys.stderr)
        return 1
    return rows(args.tree) if args.rows else probe(args.plans)


if __name__ == "__main__":
    sys.exit(main())
