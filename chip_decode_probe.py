#!/usr/bin/env python3
"""Where the decode kernel's time goes, on one NVIDIA GPU.

    python3 chip_decode_probe.py

from the root of a checkout (builds into build/ray_tpu_torch/probe/).
At the serving shape of chip_smoke.py phase 2 (B8 Hq16 KV16 D64 S1024
bf16, ragged lengths) it prints:

1. The read floor: a read-only kernel that loads the same K and V rows the
   decode kernel needs (and nothing else), timed like phase 2 (CUDA
   events, median of 20) after a write flush of the L2 (phase 2's
   `zero_` of 256 MB) and after a read flush, beside the decode kernel
   under both flushes; then the decode kernel at other chunk lengths of
   the split plan (write flush).
2. A per-block timeline of one decode launch: a copy of
   ops/csrc/decode_attention.cu with %globaltimer stamps at its phase
   boundaries (length read, rows streamed and merged across the block's
   warps, ticket taken, merge written), as percentiles over the blocks.

It imports nothing of JAX and exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = dict(b=8, hq=16, kv=16, d=64, s=1024)
RAGGED = [1, 1024, 517, 64, 300, 900, 128, 777]

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

# Stamps inserted into a copy of the decode kernel: (anchor line, stamp).
STAMPS = [
    ("  const int item = blockIdx.x;", "TR(0)"),
    ("  const int row_end = min(row_begin + chunk, len);", "TR(1)"),
    ("  // Merge the warps into this chunk's", "TR(2)"),
    ("  if (!sm_last) return;", "TR(3)"),
    ("  if (threadIdx.x == 0) counters[item] = 0;", "TR(4)"),
]
TRACE_HEADER = r"""
__device__ unsigned long long g_trace[65536 * 5];
#define TR(i) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 5 + (i)] = t_; }
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


def _build(name: str, source: str, kernels) -> ctypes.CDLL:
    out_dir = os.path.join(REPO, "build", "ray_tpu_torch", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"{name}.so")
    with open(src, "w") as f:
        f.write(source)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels.CSRC), "-o", lib, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _traced_source(kernels) -> str:
    src = (kernels.CSRC / "decode_attention.cu").read_text()
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in the kernel: {anchor!r}")
        src = src.replace(anchor, f"  {stamp}\n{anchor}")
    src = src.replace("namespace {\n", "namespace {\n" + TRACE_HEADER, 1)
    return src + TRACE_FOOTER


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ray_tpu_torch._private import kernels
    da = importlib.import_module("ray_tpu_torch.ops.decode_attention")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    b, hq, kv, d, s = (SHAPE[x] for x in ("b", "hq", "kv", "d", "s"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    big = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    big_f = big.view(torch.float32)
    total = torch.empty(1, device="cuda")
    flushes = {"write": big.zero_,
               "read": lambda: torch.sum(big_f, dim=0, out=total[0])}
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, flush, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    probe = _build("read_rows", READ_PROBE, kernels)
    probe.run_read_rows.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    read = lambda: probe.run_read_rows(  # noqa: E731
        k.data_ptr(), v.data_ptr(), lens.data_ptr(), sink.data_ptr(), b, s,
        kv, d, stream)
    decode = lambda: da.decode_attention_cuda(q, k, v, lens)  # noqa: E731
    nbytes = 2 * sum(RAGGED) * kv * d * 2
    for order in ("write", "read", "read", "write"):
        r_ms, d_ms = timed(read, flushes[order]), timed(decode, flushes[order])
        print(f"{order} flush: read-only rows {r_ms:.4f} ms "
              f"({nbytes / r_ms / 1e6:.0f} GB/s), decode kernel {d_ms:.4f} ms")

    rounds = da.MIN_ROUNDS
    for r in (1, 2, 4, 8):
        da.MIN_ROUNDS = r
        chunk = da.split_plan(b, hq, kv, s, d, 2).chunk
        print(f"chunks of {chunk} rows (at least {r} rounds of loads): "
              f"decode kernel {timed(decode, flushes['write']):.4f} ms")
    da.MIN_ROUNDS = rounds

    traced = _build("decode_traced", _traced_source(kernels), kernels)
    fn = traced.rt_decode_attention
    fn.argtypes, fn.restype = kernels.DECODE_ATTENTION.argtypes, ctypes.c_int
    traced.rt_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels.DECODE_ATTENTION._fn = fn  # this process only: the traced copy
    plan = da.split_plan(b, hq, kv, s, d, 2)
    n = plan.items * plan.n_splits * 5
    spans = []
    for rep in range(6):
        decode()
        traced.rt_trace_clear(n)
        big.zero_()
        decode()
        torch.cuda.synchronize()
        buf = np.zeros(n, np.uint64)
        traced.rt_trace_read(buf.ctypes.data, n)
        tr = buf.reshape(-1, 5).astype(np.int64)
        t0 = tr[:, 0].min()
        act, tick, last = tr[:, 1] > 0, tr[:, 3] > 0, tr[:, 4] > 0
        spans.append((tr[last, 4].max() - t0) / 1e3)
    pct = lambda x: np.round(np.percentile(x / 1e3, (50, 90, 100)), 2)  # noqa
    print(f"timeline (us, median / p90 / max over blocks; span median "
          f"{statistics.median(spans):.2f} us over {len(spans)} launches, "
          f"{int(act.sum())} active blocks of {len(tr)}):")
    print("  start -> length read   ", pct(tr[act, 1] - tr[act, 0]))
    print("  length -> rows streamed", pct(tr[act, 2] - tr[act, 1]))
    print("  rows streamed -> ticket", pct(tr[tick, 3] - tr[tick, 2]))
    print("  ticket -> merge written", pct(tr[last, 4] - tr[last, 3]))
    print("  rows streamed at       ", pct(tr[act, 2] - t0))
    print("  merge written at       ", pct(tr[last, 4] - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
