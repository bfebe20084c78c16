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
   tolerance, median time over CUDA events with L2 flushed, the plain
   version's time, the least time the card could take (bound), and the
   time of one PyTorch call computing the same function (timed only; the
   port never calls it).
3. Golden parity: the tiny float32 model of tests/data/torch_port_golden.npz
   (weights, logits and greedy tokens of the JAX package) through the
   kernels, TF32 off: logits within 1e-4, greedy tokens equal.
4. Serving at full width (vocab 32000, d_model 1024, 8 layers, 16 heads,
   max_seq 1024, bf16, max_batch 8, decode_chunk 16, seeded random
   weights): OpenAIServer answers concurrent completions, a stream, a chat
   and a repeated greedy prompt; the decode kernel's launch count must
   cover every layer of every decode step.
5. Full-sequence forward at full width (B4 x S1024, bf16) through the flash
   kernel, once per layer, against the same model on the plain attention
   path.

It prints the device line of `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`, one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a call
# is max(bytes / HBM rate, flops / peak rate of its type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Tolerances of a kernel against its plain version on the same inputs.
# Both keep softmax state in f32 and differ in summation order; a bf16
# output may then round to the neighbouring bf16 value (one ulp: 1/128 of
# the magnitude's power of two), so bf16 is held to 2e-2 * max(1, |ref|).
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             max_seq=1024, dtype="bfloat16", seed=0)


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
    launch (the serving path finds each layer's cache cold)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype],
        "ms": _timed_ms(lambda: decode_attention_cuda(q, k, v, lens), flush),
        "plain_ms": _timed_ms(
            lambda: _reference_decode_attention(q, k, v, lens), flush),
        "library_ms": _timed_ms(lib, flush),
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              flops / PEAK_FLOPS[dtype]),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS[dtype] else "operations"),
    }
    log("decode " + json.dumps(rec))
    return rec


def _flash_case(name, b, sq, sk, hq, hkv, d, dtype, causal, flush, gen):
    import torch
    import torch.nn.functional as F

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
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if causal and sq != sk:  # SDPA's is_causal aligns top-left
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device="cuda").tril(diagonal=sk - sq)
    gqa = {"enable_gqa": True} if hq != hkv else {}
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None, **gqa)
    if causal:  # visible (row, key) pairs: key j <= i + sk - sq, j < sk
        i = np.arange(sq)
        pairs = int(np.clip(i + sk - sq + 1, 0, sk).sum())
    else:
        pairs = sq * sk
    elem = torch.finfo(dt).bits // 8
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elem
    flops = 4 * b * hq * d * pairs
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype],
        "ms": _timed_ms(lambda: flash_attention_cuda(q, k, v, causal), flush),
        "plain_ms": _timed_ms(
            lambda: _reference_flash_attention(q, k, v, causal), flush),
        "library_ms": _timed_ms(lib, flush),
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              flops / PEAK_FLOPS[dtype]),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS[dtype] else "operations"),
    }
    log("flash " + json.dumps(rec))
    return rec


def phase_kernels():
    """Returns the record of each kernel at the main path's shape."""
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
    del flush
    return decode_main, flash_main


# ------------------------------------------------------------- phase 3
def phase_golden(path: str) -> None:
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import (ContinuousEngine, SamplingParams,
                                          model_config)
    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.models.transformer import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(path) as f:
        g = {k: f[k] for k in f.files}
    tree: dict = {}
    for key, arr in g.items():
        if key.startswith("params/"):
            node = tree
            *parents, leaf = key.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    vocab, d_model, n_layers, n_heads, max_seq = (int(x) for x in g["config"])
    lcfg = LLMConfig(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                     n_heads=n_heads, max_seq=max_seq, dtype="float32",
                     params=params_from_flax(tree))
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


# ------------------------------------------------------------- phase 4
def phase_serve(server, kernels) -> dict:
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
    return rec


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
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            n_kernels += 1
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
            for line in k.build_log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {k.name}: {line.strip()}")

    decode_rec, flash_rec = phase_kernels()
    phase_golden(os.path.join(REPO, "tests", "data", "torch_port_golden.npz"))

    server = OpenAIServer(LLMConfig(**SERVE), max_batch=8, decode_chunk=16,
                          default_max_tokens=64, device="cuda")
    try:
        serve_rec = phase_serve(server, kernels)
        forward_rec = phase_forward(server.engine.model, kernels)
    finally:
        server.shutdown()
    if serve_rec["decode_launches"] == 0 or forward_rec["flash_launches"] == 0:
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
        line(kernels.DECODE_ATTENTION, decode_rec,
             serve_rec["decode_launches"],
             "ray_tpu/ops/decode_attention.py:33"),
        line(kernels.FLASH_ATTENTION, flash_rec,
             forward_rec["flash_launches"],
             "ray_tpu/ops/flash_attention.py:74"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
