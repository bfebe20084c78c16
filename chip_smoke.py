#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. Phases, each of which raises on failure
(exit code 1, no result line):

1. Device: the card's name and power limit, torch's version, and the
   build of every CUDA kernel from the checkout's sources (one nvcc per
   source, started together) into build/ray_tpu_torch/.
2. Kernels against their plain PyTorch versions on the same inputs, at the
   main path's shapes and a few others: max abs error within the stated
   tolerance, median device time over CUDA events with L2 flushed (a spin
   kernel covers the host's dispatch of the call), the plain
   version's time, the least time the card could take (bound), and the
   time of one PyTorch call computing the same function (timed only; the
   port never calls it): `scaled_dot_product_attention` pinned to a named
   backend (flash for unmasked or causal cases, memory-efficient where a
   mask is needed; the next that runs if one refuses, printed), timed in
   turns with the kernel (kernel, library, library, kernel). The flash
   forward is also timed with its logsumexp written (the training path).
   The flash backward kernel is held to the plain backward on the same o,
   dO and logsumexp, and its library yardstick is the backward alone of
   `scaled_dot_product_attention` (`torch.autograd.grad` of its output).
   The card's SM clock, power draw and temperature are sampled with
   nvidia-smi while the phase runs.
3. Golden parity: the tiny float32 model of tests/data/torch_port_golden.npz
   (weights, logits, greedy tokens and one step's loss and gradients of the
   JAX package) through the kernels, TF32 off: logits within 1e-4, greedy
   tokens equal, loss within 1e-5 and every gradient within
   1e-4 * max(1, |ref|).
4. Serving at full width (vocab 32000, d_model 1024, 8 layers, 16 heads,
   max_seq 1024, bf16, max_batch 8, decode_chunk 16, seeded random
   weights): OpenAIServer answers concurrent completions, a stream, a chat
   and a repeated greedy prompt; the decode kernel's launch count must
   cover every layer of every decode step.
5. Full-sequence forward at full width (B4 x S1024, bf16) through the flash
   kernel, once per layer, against the same model on the plain attention
   path.
6. Training at full width: the serving widths (8 layers) with a fresh
   seeded model, f32 params, bf16 compute, one fixed batch [4, 1025] and
   torch.optim.Adam(lr=1e-3). The first step's gradients against the same
   model on the plain attention path (relative norm per parameter tensor),
   then 10 timed steps (CUDA events): losses finite and falling, the flash
   forward and backward kernels launched once per layer per step. One
   profiled step gives the device's busy share and the shares of device
   time of the two flash kernels and the products. Then the MoE variant
   (4 experts, 2 layers) for 2 steps.
7. Serving over HTTP: `ray_tpu_torch.init(num_cpus=4)` (the node must
   count 1 GPU), then `serve.run(build_openai_app(...,
   ray_actor_options={"num_gpus": 1}))` on a free port: the HTTP proxy,
   the router and a replica actor in its own worker process, which holds
   the card. First the golden file's float32 model: its greedy token_ids
   over HTTP equal the JAX package's, and /v1/stats names a replica pid
   that is not this process's, with CUDA memory of its own, while
   nvidia-smi lists the pid or, where its pids are another PID
   namespace's, one more compute app than with this process alone.
   Then the serving model of phase 4: /v1/models, a lone greedy
   completion equal to phase 4's in-process answer for the same prompt,
   two SSE streams (chunks arrive one by one, then [DONE]; time to first
   token of the second, after the first paid the stream set-up), one
   chat and 6 concurrent completions from threads with phase 4's mix
   (generated tokens/s, wall ms per decode step). The decode kernel's
   launch count is read from the replica (/v1/stats). Then
   serve.shutdown() and ray_tpu_torch.shutdown(), which must leave no
   rt_* segment in /dev/shm.

Launch counts: the decode kernel's from phase 4, the flash forward's from
phases 5 and 6, the flash backward's from phase 6, each path's counts set
to 0 just before it and read just after; the decode row also carries the
replica's count from phase 7 (`replica_launches`: a fresh process, read
after its requests).

It prints the device line of `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`, one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a call
# is max(bytes / HBM rate, flops / peak rate of its type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Tolerances of a kernel against its plain version on the same inputs.
# Both keep softmax state in f32 and differ in summation order; a bf16
# output may then round to the neighbouring bf16 value (one ulp: 1/128 of
# the magnitude's power of two), so bf16 is held to 2e-2 * max(1, |ref|).
# The backward's dq, dk and dv are held to the same: the plain backward
# rounds P and dS to bf16 where the kernel does and takes Delta from the
# same returned O, so the two differ by f32 summation order, by exp2 against
# exp (which can move a rounded P or dS to its neighbouring bf16 value) and
# by the final rounding to bf16.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# The library yardstick's SDPA backends, in order of preference
# (torch.nn.attention.SDPBackend names).
UNMASKED_SDPA = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
MASKED_SDPA = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             max_seq=1024, dtype="bfloat16", seed=0)
TRAIN_STEPS = 10
# About 1 ms at the H100's 1980 MHz: longer than the host takes to enqueue
# any call phase 2 times.
SPIN_CYCLES = 2_000_000
# Phase 6: the first step's gradient of each parameter tensor against the
# plain attention path, as ||g - g_ref|| / ||g_ref||. Both paths compute in
# bf16 and differ only in attention's rounding: the kernels round P to bf16
# for the PV product and P and dS for the backward's products, the plain
# path keeps them in f32. On an NVIDIA H100 80GB HBM3 (700 W) the worst
# tensor read 2.7%, and SDPA's flash backend, whose bf16 kernels round P
# too, read the same 2.7% against the same plain path on the same step
# (phase 6 prints both). 5e-2 leaves room for other seeds while a gradient
# term dropped or misrouted (tens of percent) still fails.
TRAIN_GRAD_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


class _Request:
    """The request object OpenAIServer.__call__ reads: .path and .json()."""

    def __init__(self, path: str, body: dict | None = None):
        self.path = path
        self._body = body

    def json(self):
        return self._body


def _timed_ms(fn, flush, reps: int = 20) -> float:
    """Median milliseconds of fn() over CUDA events, L2 flushed before each
    launch (the serving path finds each layer's cache cold). A spin kernel
    of SPIN_CYCLES between the flush and the start event keeps the card
    busy while the host enqueues fn's launches, so the events time the
    device's work and not the host's dispatch (an autograd call's can
    outlast the flush)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed_in_turns(kernel_fn, make_library, backends, flush):
    """Kernel and library call timed in turns (kernel, library, library,
    kernel), the library pinned to the first of `backends` that runs it:
    `make_library()`, called under that backend, returns the call to time.
    Returns (kernel ms, library ms, backend name), each the median over
    both of its runs."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (getattr(SDPBackend, name) for name in backends):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # why a backend refuses
                library_fn = make_library()
                library_fn()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        break
    else:
        raise AssertionError(f"no SDPA backend of {backends} runs the case")
    kernel_ms, library_ms = [], []
    for kind in ("kernel", "library", "library", "kernel"):
        if kind == "kernel":
            kernel_ms.append(_timed_ms(kernel_fn, flush))
        else:
            with sdpa_kernel(backend):
                library_ms.append(_timed_ms(library_fn, flush))
    return (statistics.median(kernel_ms), statistics.median(library_ms),
            backend.name)


@contextlib.contextmanager
def _smi_sampler(period_ms: int = 200):
    """Sample the card's SM clock, power draw, power limit and temperature
    with nvidia-smi while the block runs; yields a dict that holds their
    min / median / max once the block ends. The sampler is stopped on the
    way out, also when the block raises."""
    proc = subprocess.Popen(
        ["nvidia-smi",
         "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader,nounits", f"-lms={period_ms}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    summary: dict = {}
    try:
        yield summary
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    rows = [r for r in rows if len(r) == 4]
    summary["samples"] = len(rows)
    for i, name in enumerate(("sm_clock_mhz", "power_draw_w", "power_limit_w",
                              "temperature_c")):
        col = sorted(r[i] for r in rows)
        if col:
            summary[name] = [col[0], statistics.median(col), col[-1]]


def _max_err(out, ref, dtype_name: str) -> float:
    """Max abs error; raises when it passes the stated tolerance."""
    import torch

    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().clamp(min=1.0) if dtype_name == "bfloat16" \
        else torch.ones_like(err)
    if not torch.isfinite(out.float()).all():
        raise AssertionError("kernel output has non-finite values")
    worst = float((err / scale).max())
    if worst > TOL[dtype_name]:
        raise AssertionError(
            f"kernel disagrees with its plain version: scaled error {worst} "
            f"> {TOL[dtype_name]}")
    return float(err.max())


# ------------------------------------------------------------- phase 2
def _decode_case(name, b, hq, kv, d, s, dtype, lengths, flush, gen):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import (
        _reference_decode_attention, decode_attention_cuda)

    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lens)
    ref = _reference_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    err = _max_err(out, ref, dtype)
    # library yardstick: SDPA with a length mask, [B, H, S, D] views
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    gqa = {"enable_gqa": True} if hq != kv else {}
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=mask, **gqa)
    rows = int(sum(lengths))
    elem = torch.finfo(dt).bits // 8
    nbytes = (2 * b * hq * d + 2 * rows * kv * d) * elem + 4 * b
    flops = 4 * rows * hq * d
    ms, library_ms, backend = _timed_in_turns(
        lambda: decode_attention_cuda(q, k, v, lens), lambda: lib,
        MASKED_SDPA, flush)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
        "plain_ms": _timed_ms(
            lambda: _reference_decode_attention(q, k, v, lens), flush),
        "library_ms": library_ms, "library_backend": backend,
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS[dtype] else "operations"),
        "gb_per_s": nbytes / ms / 1e6, "share_of_bound": bound_ms / ms,
    }
    log("decode " + json.dumps(rec))
    return rec


def _flash_case(name, b, sq, sk, hq, hkv, d, dtype, causal, flush, gen):
    import torch

    from ray_tpu_torch.ops.flash_attention import (
        _reference_flash_attention, flash_attention_cuda)

    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    out = flash_attention_cuda(q, k, v, causal)
    ref = _reference_flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    err = _max_err(out, ref, dtype)
    sdpa, backends = _sdpa_call(q, k, v, causal)
    pairs = _visible_pairs(sq, sk, causal)
    elem = torch.finfo(dt).bits // 8
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elem
    flops = 4 * b * hq * d * pairs
    ms, library_ms, backend = _timed_in_turns(
        lambda: flash_attention_cuda(q, k, v, causal), lambda: sdpa,
        backends, flush)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
        "ms_with_lse": _timed_ms(
            lambda: flash_attention_cuda(q, k, v, causal, with_lse=True),
            flush),
        "plain_ms": _timed_ms(
            lambda: _reference_flash_attention(q, k, v, causal), flush),
        "library_ms": library_ms, "library_backend": backend,
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS[dtype] else "operations"),
        "tflop_per_s": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
    }
    log("flash " + json.dumps(rec))
    return rec


def _visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(row, key) pairs the function computes: key j <= i + sk - sq, j < sk
    when causal."""
    if not causal:
        return sq * sk
    return int(np.clip(np.arange(sq) + sk - sq + 1, 0, sk).sum())


def _sdpa_call(q, k, v, causal):
    """A call of scaled_dot_product_attention computing the port's function
    over [B, H, S, D] views of its [B, S, H, D] tensors, and the SDPA
    backends to try: SDPA's is_causal aligns top-left, so an Sk - Sq offset
    needs a mask, which the flash backend refuses."""
    import torch
    import torch.nn.functional as F

    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal and sq != sk:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
    kwargs = {"attn_mask": mask, "is_causal": causal and mask is None}
    if q.shape[2] != k.shape[2]:
        kwargs["enable_gqa"] = True
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return (lambda: F.scaled_dot_product_attention(*args, **kwargs),
            MASKED_SDPA if mask is not None else UNMASKED_SDPA)


def _flash_bwd_case(name, b, sq, sk, hq, hkv, d, dtype, causal, flush, gen):
    """The backward kernel against the plain backward on the same o, dO and
    logsumexp. Bound: the 5 products the gradient needs (S, dP, dV, dK, dQ:
    10 * B * Hq * D flops per visible pair; the bf16 kernel computes each
    once), against reading q, k, v, o, dO and lse once and writing dq, dk
    and dv once. Library: the backward alone of SDPA, torch.autograd.grad of
    its output (the forward runs once, outside the timing)."""
    import torch

    from ray_tpu_torch.ops.flash_attention import (
        _reference_flash_attention_backward, flash_attention_backward_cuda,
        flash_attention_cuda)

    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
    dout = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)

    def kernel():
        return flash_attention_backward_cuda(q, k, v, out, dout, lse, causal)

    def plain():
        return _reference_flash_attention_backward(q, k, v, out, dout, lse,
                                                   causal)

    grads, refs = kernel(), plain()
    torch.cuda.synchronize()
    err = max(_max_err(g, r, dtype) for g, r in zip(grads, refs))
    if causal and sq > sk and not bool((grads[0][:, :sq - sk] == 0).all()):
        raise AssertionError("rows without a visible key got dq != 0")

    def make_library():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = _sdpa_call(*leaves, causal)[0]()
        do = dout.transpose(1, 2)
        return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

    backends = _sdpa_call(q, k, v, causal)[1]
    ms, library_ms, backend = _timed_in_turns(kernel, make_library, backends,
                                              flush)
    pairs = _visible_pairs(sq, sk, causal)
    elem = torch.finfo(dt).bits // 8
    nbytes = (4 * b * sq * hq * d + 4 * b * sk * hkv * d) * elem \
        + 4 * b * hq * sq
    flops = 10 * b * hq * d * pairs
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
        "plain_ms": _timed_ms(plain, flush),
        "library_ms": library_ms, "library_backend": backend,
        "library_call": "torch.autograd.grad of SDPA's output",
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS[dtype] else "operations"),
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "tflop_per_s": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
    }
    log("flash_bwd " + json.dumps(rec))
    return rec


def phase_kernels():
    """Returns the record of each kernel at the main path's shape."""
    with _smi_sampler() as card:
        recs = _kernel_cases()
    log("card during phase 2 (min, median, max) " + json.dumps(card))
    return recs


def _kernel_cases():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ragged = [1, 1024, 517, 64, 300, 900, 128, 777]
    decode_main = _decode_case("serving B8 Hq16 KV16 D64 S1024 bf16",
                               8, 16, 16, 64, 1024, "bfloat16", ragged,
                               flush, gen)
    _decode_case("GQA B8 Hq16 KV4 D64 S1024 bf16", 8, 16, 4, 64, 1024,
                 "bfloat16", ragged, flush, gen)
    _decode_case("f32 B8 Hq16 KV16 D64 S1024", 8, 16, 16, 64, 1024,
                 "float32", ragged, flush, gen)
    _decode_case("D128 GQA rep 16 B4 Hq32 KV2 S600 bf16", 4, 32, 2, 128,
                 600, "bfloat16", [1, 600, 333, 17], flush, gen)
    flash_main = _flash_case("forward B4 S1024 H16 D64 bf16 causal",
                             4, 1024, 1024, 16, 16, 64, "bfloat16", True,
                             flush, gen)
    for causal in (True, False):
        _flash_case(f"bench b4 s2048 h8 d128 bf16 causal={causal}", 4, 2048,
                    2048, 8, 8, 128, "bfloat16", causal, flush, gen)
    _flash_case("GQA Sq512 < Sk1024 Hq8 Hkv2 d128 bf16 causal", 2, 512, 1024,
                8, 2, 128, "bfloat16", True, flush, gen)
    _flash_case("ragged Sq=Sk=1000 h8 d64 bf16 causal", 2, 1000, 1000, 8, 8,
                64, "bfloat16", True, flush, gen)
    _flash_case("f32 s256 h4 d64 causal", 1, 256, 256, 4, 4, 64, "float32",
                True, flush, gen)
    bwd_main = _flash_bwd_case("backward B4 S1024 H16 D64 bf16 causal",
                               4, 1024, 1024, 16, 16, 64, "bfloat16", True,
                               flush, gen)
    for causal in (True, False):
        _flash_bwd_case(f"backward bench b4 s2048 h8 d128 bf16 causal="
                        f"{causal}", 4, 2048, 2048, 8, 8, 128, "bfloat16",
                        causal, flush, gen)
    _flash_bwd_case("backward GQA Hq16 Hkv4 Sq512 < Sk1024 d64 bf16 causal",
                    2, 512, 1024, 16, 4, 64, "bfloat16", True, flush, gen)
    _flash_bwd_case("backward ragged Sq=Sk=1000 h8 d64 bf16 causal", 2, 1000,
                    1000, 8, 8, 64, "bfloat16", True, flush, gen)
    _flash_bwd_case("backward f32 s256 h4 d64 causal", 1, 256, 256, 4, 4, 64,
                    "float32", True, flush, gen)
    _flash_bwd_case("backward Sq1024 > Sk512 h8 d64 bf16 causal", 1, 1024,
                    512, 8, 8, 64, "bfloat16", True, flush, gen)
    del flush
    return decode_main, flash_main, bwd_main


# ------------------------------------------------------------- phase 3
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")


def _golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _subtree(g: dict, prefix: str) -> dict:
    """The nested flax tree stored under `prefix` ("params/", "grad/")."""
    tree: dict = {}
    for key, arr in g.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _golden_config(g: dict):
    """LLMConfig of the golden model, float32, with its weights."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models.convert import params_from_flax

    vocab, d_model, n_layers, n_heads, max_seq = (int(x) for x in g["config"])
    return LLMConfig(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                     n_heads=n_heads, max_seq=max_seq, dtype="float32",
                     params=params_from_flax(_subtree(g, "params/")))


def phase_golden() -> None:
    import torch

    from ray_tpu_torch.llm.engine import (ContinuousEngine, SamplingParams,
                                          model_config)
    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.models.transformer import Transformer, loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = _golden()
    lcfg = _golden_config(g)
    model = Transformer(model_config(lcfg), device="cuda")
    model.load_state_dict(lcfg.params)
    with torch.no_grad():
        logits = model(torch.from_numpy(g["tokens"]).long().cuda())
    err = float(np.abs(logits.cpu().numpy() - g["logits"]).max())
    log(f"golden logits max abs err {err} (tol 1e-4, f32, TF32 off)")
    if not err <= 1e-4:
        raise AssertionError(f"golden logits differ by {err}")
    eng = ContinuousEngine(lcfg, max_batch=2, decode_chunk=4, device="cuda")
    try:
        streams = [eng.submit(g[f"prompt_{i}"].tolist(), SamplingParams(
            temperature=0.0, max_tokens=g["greedy"].shape[1]))
            for i in range(g["greedy"].shape[0])]
        greedy = np.asarray([s.tokens() for s in streams])
    finally:
        eng.shutdown()
    if not np.array_equal(greedy, g["greedy"]):
        raise AssertionError(f"golden greedy tokens differ:\n{greedy}\n"
                             f"{g['greedy']}")
    log(f"golden greedy tokens equal ({greedy.size} tokens)")

    loss = loss_fn(model, torch.from_numpy(g["train_tokens"]).long().cuda())
    loss.backward()
    loss_err = abs(loss.item() - float(g["train_loss"]))
    ref = params_from_flax(_subtree(g, "grad/"))
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        r = ref[name].cuda()
        e = float(((p.grad - r).abs() / r.abs().clamp(min=1.0)).max())
        if e > worst:
            worst, worst_name = e, name
    log(f"golden training step: loss err {loss_err} (tol 1e-5), worst "
        f"gradient err {worst} at {worst_name} (tol 1e-4 * max(1, |ref|))")
    if not (loss_err <= 1e-5 and worst <= 1e-4):
        raise AssertionError("golden loss or gradients differ from JAX's")


# ------------------------------------------------------------- phase 4
def phase_serve(server, kernels) -> tuple[dict, tuple]:
    import torch

    rng = np.random.RandomState(0)
    vocab = SERVE["vocab_size"]

    def prompt(n):
        return rng.randint(0, vocab, n).tolist()

    def call(body, path="/v1/completions"):
        return server(_Request(path, body))

    eng = server.engine
    # warm-up request (allocator, cuBLAS handles) before the counted run
    call({"prompt": prompt(16), "temperature": 0.0, "max_tokens": 4})
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    steps0 = eng.decode_steps
    # concurrent completions that join a running batch: greedy and sampled
    bodies = []
    for i, n in enumerate((64, 128, 256, 64, 128, 256)):
        body = {"prompt": prompt(n), "max_tokens": 96 + 16 * i,
                "temperature": 0.0 if i % 2 == 0 else 0.8}
        if i % 2:
            body.update(top_p=0.9, top_k=50, seed=i)
        bodies.append(body)
    results = [None] * len(bodies)

    def worker(i):
        results[i] = call(bodies[i])

    t0 = time.perf_counter()
    threads = []
    for i in range(len(bodies)):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        time.sleep(0.05)  # staggered: later requests join the batch
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    n_tokens = 0
    for body, out in zip(bodies, results):
        if out is None:
            raise AssertionError("a concurrent completion did not finish")
        toks = out["token_ids"]
        n_tokens += len(toks)
        if len(toks) != body["max_tokens"] or \
                out["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"completion returned {len(toks)} tokens, "
                                 f"{out['choices'][0]['finish_reason']}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError("token id out of the vocabulary")
    # streaming request: time to first token
    t_s = time.perf_counter()
    gen = call({"prompt": prompt(128), "temperature": 0.0, "max_tokens": 64,
                "stream": True})
    chunks = [next(gen)]
    ttft = time.perf_counter() - t_s
    chunks.extend(gen)
    streamed = [t for c in chunks for t in c["token_ids"]]
    if len(streamed) != 64 or chunks[-1]["choices"][0]["finish_reason"] != \
            "length":
        raise AssertionError(f"stream returned {len(streamed)} tokens")
    chat = call({"messages": [{"role": "user", "content": "hello there"}],
                 "temperature": 0.0, "max_tokens": 32},
                path="/v1/chat/completions")
    if chat["object"] != "chat.completion" or len(chat["token_ids"]) != 32:
        raise AssertionError(f"chat answer malformed: {chat['object']}, "
                             f"{len(chat['token_ids'])} tokens")
    same = {"prompt": prompt(200), "temperature": 0.0, "max_tokens": 48}
    a, b = call(same)["token_ids"], call(same)["token_ids"]
    if a != b:
        raise AssertionError("the same greedy prompt gave two answers")
    lone = (same, a)
    profile = _profile_decode(call, prompt, eng)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    total_steps = eng.decode_steps - steps0
    need = SERVE["n_layers"] * total_steps
    log(f"serve: decode launches {counts['decode_attention']}, decode steps "
        f"{total_steps} x {SERVE['n_layers']} layers = {need}; flash "
        f"launches {counts['flash_attention']}")
    if counts["decode_attention"] < need or total_steps == 0:
        raise AssertionError("the decode kernel did not run every layer of "
                             "every decode step")
    rec = {"concurrent_requests": len(bodies), "generated_tokens": n_tokens,
           "wall_s": wall, "tokens_per_s": n_tokens / wall,
           "decode_steps": steps, "ms_per_decode_step_wall": 1e3 * wall / steps,
           "stream_ttft_ms": 1e3 * ttft,
           "decode_launches": counts["decode_attention"], **profile}
    log("serve " + json.dumps(rec))
    return rec, lone


def _profile_decode(call, prompt, eng) -> dict:
    """Where a decode step's time goes: 8 concurrent greedy requests under
    torch.profiler; the device's busy share of the window's wall time
    (kernel time on the card / wall), and the decode kernel's share of the
    device time. The profiler itself adds host time, so these are for
    ranking, not for the step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    bodies = [{"prompt": prompt(64), "temperature": 0.0, "max_tokens": 48}
              for _ in range(8)]
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(b,)) for b in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, n_kernels = _kernel_times_us(prof)
    kernel_us = sum(by_name.values())
    steps = max(eng.decode_steps - steps0, 1)
    if kernel_us == 0.0:
        return {"profiled_device_busy_share": "not measured"}
    decode_us = sum(t for n, t in by_name.items()
                    if "decode_attention_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"profiled_steps": steps,
            "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
            "profiled_device_busy_share": kernel_us / wall_us,
            "profiled_device_ms_per_step": kernel_us / 1e3 / steps,
            "profiled_kernels_per_step": n_kernels / steps,
            "profiled_decode_kernel_share_of_device": decode_us / kernel_us,
            "profiled_top_kernels_share": [[n[:80], t / kernel_us]
                                           for n, t in top]}


# ------------------------------------------------------------- phase 5
@contextlib.contextmanager
def _plain_attention():
    """The model's attention swapped for the flash kernel's plain version
    (for the comparison run only)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops.flash_attention import _reference_flash_attention

    saved = transformer.dot_product_attention
    transformer.dot_product_attention = (
        lambda q, k, v, causal=True: _reference_flash_attention(q, k, v,
                                                                 causal))
    try:
        yield
    finally:
        transformer.dot_product_attention = saved


@contextlib.contextmanager
def _library_attention():
    """The model's attention swapped for SDPA pinned to its flash backend
    (for the yardstick of phase 6's gradient comparison only; the port
    never calls it)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ray_tpu_torch.models import transformer

    def sdpa(q, k, v, causal=True):  # Sq == Sk in the model
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal).transpose(1, 2)

    saved = transformer.dot_product_attention
    transformer.dot_product_attention = sdpa
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            yield
    finally:
        transformer.dot_product_attention = saved


def phase_forward(model, kernels) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, SERVE["vocab_size"], (4, 1024), generator=gen,
                           device="cuda")
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = model(tokens)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    with torch.no_grad(), _plain_attention():
        ref = model(tokens)
    if tuple(logits.shape) != (*tokens.shape, SERVE["vocab_size"]) or \
            logits.dtype != torch.float32:
        raise AssertionError(f"forward gave {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not torch.isfinite(logits).all():
        raise AssertionError("forward logits are not finite")
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    rec = {"flash_launches": counts["flash_attention"],
           "decode_launches": counts["decode_attention"],
           "max_abs_err_vs_plain": err, "max_abs_logit": scale,
           "argmax_agreement": agree}
    log("forward " + json.dumps(rec))
    if counts["flash_attention"] != SERVE["n_layers"]:
        raise AssertionError("the flash kernel did not run once per layer")
    # bf16 through 8 layers: the two attention paths round differently;
    # hold the logits to 5% of their largest magnitude.
    if not err <= 0.05 * max(1.0, scale):
        raise AssertionError(f"forward logits differ from the plain path by "
                             f"{err} (largest logit {scale})")
    return rec


# ------------------------------------------------------------- phase 6
def _kernel_times_us(prof) -> tuple[dict, int]:
    """Device time of each kernel name in a torch.profiler run, and the
    number of kernels. Annotations on the device's timeline (the optimizer's
    step range, for one) span kernels and are not counted."""
    import torch

    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            n_kernels += 1
    return by_name, n_kernels


PRODUCT_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "Gemm")


def _profile_train_step(step) -> dict:
    """One training step under torch.profiler: the device's busy share of
    the step's wall time, and the shares of device time of the flash
    backward kernels (prep, the wgmma kernel and convert), the flash forward
    kernel and the products (cuBLAS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, n_kernels = _kernel_times_us(prof)
    kernel_us = sum(by_name.values())
    if kernel_us == 0.0:
        return {"profiled_device_busy_share": "not measured"}

    def share(pred):
        return sum(t for n, t in by_name.items() if pred(n)) / kernel_us

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "profiled_device_ms": kernel_us / 1e3,
        "profiled_device_busy_share": kernel_us / wall_us,
        "profiled_kernels": n_kernels,
        "flash_bwd_share_of_device": share(lambda n: "flash_bwd" in n),
        "flash_fwd_share_of_device": share(
            lambda n: "flash_attention_wgmma_kernel" in n),
        "products_share_of_device": share(
            lambda n: any(p in n for p in PRODUCT_KERNELS)),
        "top_kernels_share": [[n[:80], t / kernel_us] for n, t in top]}


def phase_train(kernels) -> dict:
    import dataclasses

    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import model_config
    from ray_tpu_torch.models.transformer import Transformer, loss_fn

    cfg = model_config(LLMConfig(**SERVE))
    n_layers = cfg.n_layers
    tokens = torch.randint(0, cfg.vocab_size, (4, 1025),
                           generator=torch.Generator().manual_seed(2)).cuda()
    model = Transformer(cfg, device="cuda", seed=1)

    def backward_with(context):
        model.zero_grad(set_to_none=True)
        with context():
            loss_fn(model, tokens).backward()

    def rel_errs(ref):
        return {n: float((p.grad - ref[n]).norm() / ref[n].norm())
                for n, p in model.named_parameters()}

    backward_with(_plain_attention)
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    backward_with(_library_attention)
    library_rel = rel_errs(ref)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        return loss.detach()

    # first step (the warm-up): its gradients against the plain path
    opt.zero_grad(set_to_none=True)
    kernels.reset_launch_counts()
    loss0 = loss_fn(model, tokens)
    loss0.backward()
    torch.cuda.synchronize()
    first_counts = kernels.launch_counts()
    rel = rel_errs(ref)
    worst_name = max(rel, key=rel.get)
    lib_worst = max(library_rel, key=library_rel.get)

    def by_kind(errs):  # worst relative error per kind of parameter
        out: dict = {}
        for n, e in errs.items():
            kind = n.split(".")[-1] if n.startswith("layers.") else n
            out[kind] = max(out.get(kind, 0.0), e)
        return out

    opt.step()
    del ref

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(TRAIN_STEPS):
        starts[i].record()
        losses.append(step())
        ends[i].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    losses = [loss0.item()] + [x.item() for x in losses]
    profile = _profile_train_step(step)
    ms = statistics.median(step_ms)
    rec = {"steps": TRAIN_STEPS, "ms_per_step": ms,
           "ms_per_step_min_max": [min(step_ms), max(step_ms)],
           "tokens_per_s": tokens[:, 1:].numel() / ms * 1e3,
           "wall_s_timed_steps": wall_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses,
           "flash_launches": counts["flash_attention"],
           "flash_bwd_launches": counts["flash_attention_bwd"],
           "first_step_launches": first_counts,
           "worst_grad_rel_err_vs_plain": [worst_name, rel[worst_name]],
           "grad_rel_err_vs_plain_by_kind": by_kind(rel),
           "library_worst_grad_rel_err_vs_plain": [
               lib_worst, library_rel[lib_worst]],
           "library_grad_rel_err_vs_plain_by_kind": by_kind(library_rel),
           **profile}
    log("train " + json.dumps(rec))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = n_layers * TRAIN_STEPS
    if counts["flash_attention"] != want or \
            counts["flash_attention_bwd"] != want or \
            first_counts["flash_attention_bwd"] != n_layers:
        raise AssertionError(f"flash kernels not launched once per layer "
                             f"per step: {counts} over {TRAIN_STEPS} steps")
    if not rel[worst_name] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"gradient of {worst_name} differs from the "
                             f"plain path by {rel[worst_name]}")
    del model, opt

    moe_cfg = dataclasses.replace(cfg, n_layers=2, moe_experts=4)
    moe = Transformer(moe_cfg, device="cuda", seed=2)
    moe_opt = torch.optim.Adam(moe.parameters(), lr=1e-3)
    kernels.reset_launch_counts()
    moe_losses = []
    for _ in range(2):
        moe_opt.zero_grad(set_to_none=True)
        loss = loss_fn(moe, tokens)
        loss.backward()
        moe_opt.step()
        moe_losses.append(loss.item())
    torch.cuda.synchronize()
    moe_counts = kernels.launch_counts()
    rec_moe = {"moe_losses": moe_losses, "moe_launches": moe_counts}
    log("train_moe " + json.dumps(rec_moe))
    if not all(np.isfinite(moe_losses)) or \
            moe_counts["flash_attention"] != 4 or \
            moe_counts["flash_attention_bwd"] != 4:
        raise AssertionError(f"MoE training failed: {rec_moe}")
    return rec


# ------------------------------------------------------------- phase 7
def _rt_segments() -> set:
    """The runtime's shared-memory segments: object store (rt_*) and
    stream rings (rtring_*)."""
    return {f for f in os.listdir("/dev/shm") if f.startswith("rt")}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body: dict | None = None, timeout: float = 300):
    """GET (no body) or POST a JSON body; returns the parsed reply."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_stream(url: str, body: dict) -> tuple[list, list]:
    """POST a streaming request; returns the SSE data events (None for
    [DONE]) and each one's arrival time (perf_counter)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    events, arrival = [], []
    with urllib.request.urlopen(req, timeout=300) as r:
        if not r.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError(f"stream answered {r.headers['Content-Type']}")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            arrival.append(time.perf_counter())
            if line == "data: [DONE]":
                events.append(None)
                break
            events.append(json.loads(line[len("data: "):]))
    return events, arrival


def _compute_apps() -> list[tuple[int, int]]:
    """(pid, used MiB) of every process nvidia-smi lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [(int(a), int(b)) for a, b in
            (line.split(",") for line in out.strip().splitlines())]


def _replica_holds_card(stats: dict, driver_apps: list) -> str:
    """Raise unless the replica that answered `stats` is another process
    than this one and holds the card: it reports CUDA memory of its own,
    and nvidia-smi lists its pid or, where nvidia-smi's pids come from
    another PID namespace than this process's, one more compute app than
    with this process alone (`driver_apps`)."""
    pid = stats["pid"]
    if pid == os.getpid():
        raise AssertionError("the engine runs in the driver, not a replica")
    if not stats["device"].startswith("cuda") or stats["device_bytes"] <= 0:
        raise AssertionError(f"the replica holds no CUDA memory: {stats}")
    apps = _compute_apps()
    if pid in [p for p, _ in apps]:
        return f"nvidia-smi lists the replica's pid {pid}: {apps}"
    if len(apps) <= len(driver_apps):
        raise AssertionError(f"nvidia-smi lists compute apps {apps}, no "
                             f"more than the driver's alone {driver_apps}")
    return (f"nvidia-smi lists compute apps {apps} against {driver_apps} "
            f"with the driver alone (its pids are not this namespace's)")


def _wait_gpu_free(rt, timeout: float = 60.0) -> None:
    """A deleted replica's GPU returns to the node once its process is
    gone; wait for it before the next replica asks for it."""
    deadline = time.monotonic() + timeout
    while rt.available_resources().get("GPU", 0.0) < 1.0:
        if time.monotonic() > deadline:
            raise AssertionError("the deleted replica's GPU was not released")
        time.sleep(0.2)


def phase_http(lone) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import build_openai_app

    shm_before = _rt_segments()
    t_phase = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        res = rt.cluster_resources()
        log(f"http: node resources {json.dumps(res)}")
        if res.get("GPU") != 1.0:
            raise AssertionError(f"the node counts {res.get('GPU')} GPUs, "
                                 f"not 1")
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        driver_apps = _compute_apps()

        # golden: the JAX package's greedy tokens, over HTTP
        g = _golden()
        t0 = time.perf_counter()
        serve.run(build_openai_app(_golden_config(g), name="golden", max_batch=2,
                                   decode_chunk=4,
                                   ray_actor_options={"num_gpus": 1}),
                  port=port)
        golden_deploy_s = time.perf_counter() - t0
        greedy = [_http(f"{base}/v1/completions", {
            "prompt": g[f"prompt_{i}"].tolist(), "temperature": 0.0,
            "max_tokens": g["greedy"].shape[1]})["token_ids"]
            for i in range(g["greedy"].shape[0])]
        if not np.array_equal(np.asarray(greedy), g["greedy"]):
            raise AssertionError(f"golden greedy tokens over HTTP differ:\n"
                                 f"{greedy}\n{g['greedy']}")
        stats = _http(f"{base}/v1/stats")
        held = _replica_holds_card(stats, driver_apps)
        log(f"http: golden greedy tokens equal over HTTP "
            f"({np.asarray(greedy).size} tokens); replica pid "
            f"{stats['pid']} (driver {os.getpid()}) on {stats['device']} "
            f"with {stats['device_bytes']} B allocated; {held}; decode "
            f"launches in the replica "
            f"{stats['kernel_launches']['decode_attention']}; deployed in "
            f"{golden_deploy_s:.1f} s")
        serve.delete("golden")
        _wait_gpu_free(rt)

        # the serving model of phase 4
        t0 = time.perf_counter()
        serve.run(build_openai_app(LLMConfig(**SERVE), max_batch=8,
                                   decode_chunk=16, default_max_tokens=64,
                                   ray_actor_options={"num_gpus": 1}),
                  port=port)
        deploy_s = time.perf_counter() - t0
        models = _http(f"{base}/v1/models")
        if models["data"][0]["id"] != "ray-tpu-llm":
            raise AssertionError(f"/v1/models answered {models}")
        body, want = lone
        got = _http(f"{base}/v1/completions", body)["token_ids"]
        if got != want:
            raise AssertionError("the lone greedy completion over HTTP "
                                 "differs from the in-process server's")
        stats = _http(f"{base}/v1/stats")
        log(f"http: replica pid {stats['pid']}: "
            f"{_replica_holds_card(stats, driver_apps)}")

        rng = np.random.RandomState(7)

        def stream():
            t_s = time.perf_counter()
            events, arrival = _http_stream(f"{base}/v1/completions", {
                "prompt": rng.randint(0, SERVE["vocab_size"], 128).tolist(),
                "temperature": 0.0, "max_tokens": 64, "stream": True})
            return t_s, events, arrival

        # The first stream also pays the proxy's one-time stream set-up
        # (its ring hub, the replica's pump threads); TTFT is the second's,
        # as phase 4's comes after warm requests.
        t_cold, events, arrival = stream()
        ttft_cold = next(t for e, t in zip(events, arrival)
                         if e and e["token_ids"]) - t_cold
        t_s, events, arrival = stream()
        if events[-1] is not None:
            raise AssertionError("the stream did not end with [DONE]")
        with_tokens = [(e, t) for e, t in zip(events, arrival)
                       if e and e["token_ids"]]
        streamed = [t for e, _ in with_tokens for t in e["token_ids"]]
        if len(streamed) != 64 or len(with_tokens) < 2 \
                or with_tokens[-1][1] <= with_tokens[0][1]:
            raise AssertionError(f"the stream gave {len(streamed)} tokens in "
                                 f"{len(with_tokens)} events")
        ttft = with_tokens[0][1] - t_s
        chat = _http(f"{base}/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello there"}],
            "temperature": 0.0, "max_tokens": 32})
        if chat["object"] != "chat.completion" or \
                len(chat["token_ids"]) != 32:
            raise AssertionError(f"chat answer malformed: {chat['object']}")

        bodies = []
        for i, n in enumerate((64, 128, 256, 64, 128, 256)):
            b = {"prompt": rng.randint(0, SERVE["vocab_size"], n).tolist(),
                 "max_tokens": 96 + 16 * i,
                 "temperature": 0.0 if i % 2 == 0 else 0.8}
            if i % 2:
                b.update(top_p=0.9, top_k=50, seed=i)
            bodies.append(b)
        results = [None] * len(bodies)

        def worker(i):
            results[i] = _http(f"{base}/v1/completions", bodies[i])

        steps0 = _http(f"{base}/v1/stats")["decode_steps"]
        t0 = time.perf_counter()
        threads = []
        for i in range(len(bodies)):
            threads.append(threading.Thread(target=worker, args=(i,)))
            threads[-1].start()
            time.sleep(0.05)  # staggered, as in phase 4
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        stats = _http(f"{base}/v1/stats")
        steps = stats["decode_steps"] - steps0
        n_tokens = 0
        for b, out in zip(bodies, results):
            if out is None or len(out["token_ids"]) != b["max_tokens"]:
                raise AssertionError("a concurrent completion over HTTP "
                                     "did not finish")
            n_tokens += len(out["token_ids"])
        launches = stats["kernel_launches"]["decode_attention"]
        if launches == 0 or stats["pid"] == os.getpid():
            raise AssertionError("the replica never launched the decode "
                                 "kernel")
        rec = {"replica_pid": stats["pid"], "deploy_s": deploy_s,
               "golden_deploy_s": golden_deploy_s,
               "concurrent_requests": len(bodies),
               "generated_tokens": n_tokens, "wall_s": wall,
               "tokens_per_s": n_tokens / wall, "decode_steps": steps,
               "ms_per_decode_step_wall": 1e3 * wall / max(steps, 1),
               "stream_ttft_ms": 1e3 * ttft,
               "first_stream_ttft_ms": 1e3 * ttft_cold,
               "stream_events": len(with_tokens),
               "replica_decode_launches": launches,
               "replica_decode_steps": stats["decode_steps"]}
    finally:
        serve.shutdown()
        rt.shutdown()
    left = _rt_segments() - shm_before
    if left:
        raise AssertionError(f"shutdown left shm segments {sorted(left)}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log("http " + json.dumps(rec))
    return rec


def _ptxas_summary(build_log: str) -> list[str]:
    """One line per kernel instance from nvcc -Xptxas -v: its name and
    template arguments, registers, shared memory and spills, plus any
    performance warning."""
    out, name, spill = [], "?", ""
    for line in build_log.splitlines():
        m = re.search(
            r"Compiling entry function '\w*?\d+([a-z_][a-z0-9_]*_kernel)I(\w+?)EEv",
            line)
        if m:
            args = [a or ("f32" if f else "bf16") for f, _, a in re.findall(
                r"(?<![a-z_])(f)(?=L|E)|(13__nv_bfloat16)|Li(\d+)E", m.group(2))]
            name = f"{m.group(1)}<{','.join(args)}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "Performance Loss" in line or "setmaxnreg" in line:
            out.append(line.split(":", 1)[1].strip()[:160])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import OpenAIServer

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"device {kind} | power limit {smi.split(',')[-1].strip()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernel build "
        f"{build_s:.1f} s")
    for k in kernels.KERNELS:
        if k.build_log.exists():
            for line in _ptxas_summary(k.build_log.read_text()):
                log(f"ptxas {k.name}: {line}")

    decode_rec, flash_rec, bwd_rec = phase_kernels()
    phase_golden()

    server = OpenAIServer(LLMConfig(**SERVE), max_batch=8, decode_chunk=16,
                          default_max_tokens=64, device="cuda")
    try:
        serve_rec, lone = phase_serve(server, kernels)
        forward_rec = phase_forward(server.engine.model, kernels)
    finally:
        server.shutdown()
    del server
    torch.cuda.empty_cache()
    train_rec = phase_train(kernels)
    http_rec = phase_http(lone)
    if serve_rec["decode_launches"] == 0 or forward_rec["flash_launches"] == 0 \
            or train_rec["flash_bwd_launches"] == 0 \
            or http_rec["replica_decode_launches"] == 0:
        raise AssertionError("a kernel of the main path never launched")

    def line(kernel, rec, launches, replaces):
        return {"name": kernel.name, "route": "cuda",
                "source": str(kernel.source.relative_to(REPO)),
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    log(json.dumps({"kernels": [
        {**line(kernels.DECODE_ATTENTION, decode_rec,
                serve_rec["decode_launches"],
                "ray_tpu/ops/decode_attention.py:33"),
         "replica_launches": http_rec["replica_decode_launches"]},
        line(kernels.FLASH_ATTENTION, flash_rec,
             forward_rec["flash_launches"] + train_rec["flash_launches"],
             "ray_tpu/ops/flash_attention.py:74"),
        line(kernels.FLASH_ATTENTION_BWD, bwd_rec,
             train_rec["flash_bwd_launches"],
             "gradient of ray_tpu/ops/flash_attention.py:74 (no Pallas "
             "counterpart)"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
