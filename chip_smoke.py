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
   nvidia-smi while the phase runs. The same at the reference's own head
   widths, D = 16 and 32 (`_narrow_cases`): decode at the serving heads
   and GQA in bf16 and a small f32 case, and the flash forward and
   backward at B4 S1024 H16 D32, entry()'s B2 S128 H8 D32, the dryrun's
   f32 B8 S32 H8 D16, GQA Sq512 < Sk1024 D16 and ragged Sq=Sk=1000 D32.
   A bound is the largest of bytes, operations and exponentials (one per
   visible score at 16 per clock per SM on 132 SMs, at nvidia-smi's
   maximum SM clock); at D = 16 and 32 the exponentials set it. Every
   decode row of PERF.md's kernel table (`DECODE_TABLE`) is among the
   cases, each with the wrapper's host microseconds per call beside the
   previous design's (`PARENT_HOST_US`); so is every forward row
   (`FWD_TABLE`: the golden heads file's f32 batches at D = 96 and 256
   too), each f32 forward called twice more with its logsumexp and held
   to bitwise equal results. The RMSNorm kernels, forward and backward,
   at the training cell's rows and a narrow width (`NORM_TABLE`), against
   the plain forward and closed-form backward, the backward twice and
   bitwise equal, timed beside their byte bounds and the plain versions.
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
   forward and backward kernels launched once per layer per step, the
   RMSNorm kernels once per norm per step each way. One
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
8. Training on the runtime: a second `ray_tpu_torch.init(num_cpus=4)`
   (1 GPU), then `TorchTrainer` with one worker (`use_gpu=True`,
   `FailureConfig(max_failures=1)`) over `data.from_numpy` of 48 int32
   rows [1025] (the first four are phase 6's batch). The worker builds
   phase 6's model from its seed on the card with Adam(lr=1e-3), takes
   one batch of 4 per step for 12 steps and reports each loss, reports an
   async checkpoint of the model and Adam state at step 5, and on its
   first attempt exits (os._exit) after step 7's report. The restarted
   worker restores the checkpoint on the card and runs steps 6-11. Step
   0's loss equals phase 6's first within 1e-4 relative, steps 6 and 7
   equal the first attempt's within 2e-3 relative (dQ's f32 atomics vary
   the last bits), the group restarted once, the final checkpoint
   restores in this process as numpy with the model's parameters and
   Adam's two moments in f32, and each attempt's worker launched each
   flash kernel once per layer per step it ran.
9. Batch inference through `data`, on the same runtime: `batch_inference`
   of the golden file's prompts on the float32 golden model gives the JAX
   package's greedy tokens; then 8 prompts of 128 tokens, 32 new tokens,
   in batches of 4 on phase 4's model, through the same `map_batches`
   call with a predictor that also reads the actor's decode launch
   count, equal to an in-process `LLMEngine` on the same batches. Then
   ray_tpu_torch.shutdown(), which must leave no rt_* segment.
10. Pipelined serving over HTTP, on a third `ray_tpu_torch.init(num_cpus=4)`
   (1 GPU): `build_openai_app(..., pipeline_stages=2)` puts a
   `PipelinedEngine` in the replica, whose two `PipelineStage` actors,
   processes of their own, hold 4 layers each on the card and run decode
   invocations (one microbatch of 2 rows each) stage0 -> stage1 through
   the compiled DAG. First the golden float32 model: its greedy token_ids
   over HTTP equal the JAX package's. Then phase 4's model and request
   mix: a lone greedy completion (against phase 4's answer for the same
   prompt; where the tokens differ, the first differing position and the
   first decode step's logits of the two stage nets at 2 rows against the
   full model at 8 rows, held at phase 5's bf16 tolerance), two SSE
   streams (time to first token of the second), a chat and 6 concurrent
   completions from threads (tokens/s, wall ms per decode invocation,
   each stage's busy share of the wall), and each stage's own host ms,
   device ms and kernels per decode invocation, stepped directly in this
   process (torch.profiler). /v1/stats carries each stage's
   pid (neither the replica's nor this process's), CUDA memory, decode
   invocations and decode launches (equal to its 4 layers times its
   invocations), and its resolve counters: no export or fetch RPC after
   warm-up. Then serve.shutdown().
11. Tune on the card, on the same runtime: a `Tuner` over `TorchTrainer`
   with one worker (`use_gpu=True`), phase 6's widths cut to 2 layers,
   one batch [4, 1025], 3 Adam steps, `grid_search` over two learning
   rates: 2 trials, whose workers take the one card in turn. Losses
   finite, `get_best_result` the trial with the lower last loss, each
   worker's flash forward and backward launched once per layer per step.
   Then ray_tpu_torch.shutdown(), which must leave no rt_* (nor
   rtch_torch_*) segment.
12. The parallelism layer, with rank processes that share the one card
   (each computes on it through the port's kernels at its per-rank
   shapes; their collectives go through pinned host memory over gloo, so
   nothing here measures multi-GPU scaling). (c) runs on phase 10's
   runtime before its shutdown: `TorchTrainer` with 2 workers of half the
   card each and `torch_distributed=True` (the backend follows the
   workers' devices: gloo), phase 6's model and batch over a tp=2 mesh of
   the workers' group (`global_mesh_from_distributed`): the first step's
   gradient boxes against the unsharded model's, the step-0 loss against
   phase 6's within TP_LOSS_REL_TOL, 3 timed Adam steps, the flash
   kernels once per layer per step on each rank. Then 2 spawned ranks
   (`parallel.dryrun.run_ranks`, a `file://` rendezvous): (a) the golden
   float32 model's greedy tokens over tp=2 equal the JAX package's;
   (b) the serving model of phase 4 over tp=2: its logits against the
   unsharded model's at every step of phase 4's lone prompt and tokens,
   teacher-forced through the slot cache, in f32 (TP_F32_LOGIT_TOL) and in
   bf16 (phase 5's tolerance); then the engine on that prompt (agreement
   with phase 4's tokens reported) and on its 6-request mix (tokens/s,
   wall ms per decode step, the share of the wall in the host-staged
   collectives), every greedy token of both a near-argmax of the unsharded
   model on the same prefix, each rank's decode launches equal to its 8
   layers times its decode steps; (d) ring and Ulysses attention
   over sp=2 at B4 S1024 H16 D64 bf16, causal, gathered and held against
   the flash kernel's full-sequence output at the bf16 tolerance. Then
   (e) `parallel.dryrun.dryrun_ranks(4, device="cuda")`: 4 ranks, the
   dp.sp2.tp2, fsdp2.tp2 and ep2 MoE training steps, GPipe over pp=2 and
   tp=4 generation at the reference's widths (heads of 16), each against
   its unsharded twin, every kernel launched at D = 16 on the ranks; and
   (f) each kernel
   at its per-rank shape against its plain version (decode B8 Hq8 KV8,
   flash forward and backward B4 S1024 H8, which is also Ulysses' per-rank
   head slice).
13. rllib, its learners on the card and its env runners as CPU actors
   (about 2 minutes). (a) The PPO, IMPALA and DQN learners against
   tests/data/torch_port_rllib_golden.npz (the JAX package's losses,
   V-trace outputs, gradients and parameters after an update, at seed 0,
   on seeded inputs), TF32 off, at RLLIB_GOLDEN_TOL. On a runtime of 4
   CPUs: (b) PPO on CartPole at `_bench_rllib_ppo`'s shape (2 runners x
   8 envs x 64 steps, the default learner), starting from the golden
   file's seed-0 weights: env-steps/s over 5 iterations after the first,
   the learner's wall and CUDA-event ms per update, its kernels and the
   card's busy share in one profiled update, and the reference test's
   bar over 25 iterations; (c) IMPALA and DQN at their reference tests'
   configs and bars, with the learner's ms per update; (d) multi-agent
   PPO for 2 iterations (both policies' learners on the card), and PPO
   as a `tune` class trainable, 2 trials over lr {3e-4, 1e-6} taking the
   card in turn (`resources_per_trial` GPU 1), the best trial 3e-4. Then
   ray_tpu_torch.shutdown(), which must leave no rt_* segment. Phase 13
   launches none of the port's kernels: its networks are 64-wide MLPs.
14. The ops plane, through the port's CLI (`python -m
   ray_tpu_torch.scripts.cli`, with RT_TRACING=1 and
   RT_TELEMETRY_INTERVAL_S=0.5, in a temporary session dir): (a) `start
   --head --num-gpus 0`, then `start --address ... --num-gpus 1` starts
   the node that owns the card (the head advertises none, or the card
   would count twice); `status` shows 2 ALIVE nodes and 1 GPU, on that
   node. (b) `job submit` runs a script written to the temp dir whose
   driver (attached through RT_ADDRESS) runs a num_gpus=1 actor with phase
   4's serving model; `job logs` shows the GPU node's id, phase 4's lone
   greedy tokens and decode launches of at least 8 layers x the decode
   steps. (c) This process attaches (`init(address=...)`) and a GPU
   actor (whose runtime env alone sets RT_PROFILER_PREP=1, so that it
   takes its first profiler session once it has initialised CUDA)
   decodes a 700-token stream while `top --once` shows the GPU
   node's memory (neither "-" nor 0, at most the actor's own
   max_memory_allocated plus the display's rounding, COMPILE_S "-"),
   `profile --worker ... --seconds 2 --mode torch` persists a trace whose
   decode kernel events (by symbol name) number at least 8 per decode
   step of the engine.dispatch_chunk spans inside the window, `timeline
   --trace` of the request holds engine.prefill, engine.dispatch_chunk
   and engine.host_sync (host syncs within ceil(700/16) + 7), and the
   `dashboard`'s /metrics counts decode-step observations. (d) `stop`
   leaves no process, head.json or /dev/shm segment of the session.
   (e) Beside (a) and (b), from their start (the two clusters share
   only the card), on a fresh head with 0 GPUs, a num_gpus=1 task that
   holds the decode kernel to its plain version at phase 2's serving
   shape and tolerance stays pending until `Autoscaler` over
   `LocalNodeProvider(node_shape={"CPU": 1, "GPU": 1})` launches a node,
   runs there (RT_NODE_ID) on the card, and the idle node is reaped
   within 60 s. Each part's seconds are logged; the phase must take
   at most 120 s.
15. The reference's widths, run right after phase 3 (under 60 s): (a)
   tests/data/torch_port_golden_heads.npz, the dryrun's training model
   (8 heads of 16) and entry()'s (8 heads of 32), f32, TF32 off: logits
   within 1e-4, the engines' greedy tokens equal to the JAX package's,
   and the training model's loss within 1e-5 and its kept gradient
   entries within 1e-4 * max(1, |ref|); (b) entry()'s model as
   __graft_entry__.py defines it (vocab 2048, d_model 256, 2 layers, 8
   heads, d_ff 688), bf16, seeded tokens [2, 128]: its forward through
   the flash kernel at D = 32 and one backward through the backward
   kernel against the plain attention path on the card, as relative
   norms within TRAIN_GRAD_REL_TOL; (c) each kernel's launches by head
   dim on (a) and (b): every kernel at D = 16 and at D = 32.
16. The other head widths the JAX package's kernels take (every multiple
   of 8 from 8 to 256), run right after phase 15 (about 80-100 s): (0)
   the golden heads file's 2-layer f32 models at D = 8, 80, 96 and 256
   (TF32 off) under phase 15's bounds, loss and gradients included; (a)
   Phi-3-mini's widths (PHI3_MINI, D = 96, 32 layers, about 3.8 B seeded
   weights) served over HTTP by a `build_openai_app` replica holding the
   card: a greedy prompt and phase 4's 6-request mix, each answered with
   finish reason "length"; (b) Gemma-2B's attention width (GEMMA_2B, D =
   256, 18 layers) served in process by OpenAIServer, the same mix; (c)
   for each, a greedy prompt's first 4 decode steps through the slot
   cache against the same weights on the decode kernel's plain version,
   each within 2% relative norm (for Phi-3-mini an in-process engine of
   the same seed, built while the replica deploys); (d) both
   TransformerConfigs cut to 2 layers (Gemma's multi-query, n_kv_heads=1)
   on one seeded batch [2, 2049]: loss and gradients against the plain
   attention path within TRAIN_GRAD_REL_TOL, then 3 Adam steps; every
   kernel must launch at each of D = 8, 80, 96 and 256 on these paths.
   Phase 2 times the new instances at phase 16's shapes (`_wide_cases`).

Launch counts: the decode kernel's from phase 4, the flash forward's from
phases 5 and 6, the flash backward's from phase 6, each path's counts set
to 0 just before it and read just after; the decode row also carries the
replica's count from phase 7 (`replica_launches`: a fresh process, read
after its requests) and the map actor's from phase 9 (`batch_launches`),
and the flash rows the training workers' from phase 8
(`trainer_launches`, the sum over both attempts, each counted from 0 in
its worker). The decode row also carries the stage actors' counts from
phase 10 (`pipeline_launches`, the sum over the two stages), and the
flash rows the tune trials' workers' from phase 11 (`tune_launches`, the
sum over the trials). Each row also carries phase 12's: its kernel at the
per-rank shape (`per_rank_shape`) and `tp_launches`, the decode launches
of (b) and the flash launches of (c), summed over the ranks. The decode
row also carries `ops_launches`, phase 14's: the job's actor (b), the
traced stream's actor (c) and the autoscaled node's task (e), summed.
Each row also carries `narrow_heads`: phase 2's D = 16 and 32 cases of
its kernel, its launches by head dim on phase 15's paths (`launches`)
and in phase 12 (e)'s dryrun, summed over the ranks
(`dryrun_launches`), and `wide_heads`: phase 2's cases at D = 8, 40, 80,
96, 120 and 256 and its launches by head dim on phase 16's paths.

It prints the device line of `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`, one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import ast
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
# The exponentials of a softmax run on the SMs' special function units, 16
# per clock per SM on the H100's 132 SMs (at the SM clock nvidia-smi
# reports as its maximum): at head dims 16 and 32 they, not the products,
# bound the flash kernels.
EXP_PER_CLOCK_PER_SM = 16
SMS = 132
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


_SM_CLOCK_HZ: list = []


def _max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi (read once)."""
    if not _SM_CLOCK_HZ:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        _SM_CLOCK_HZ.append(float(out.splitlines()[0]) * 1e6)
    return _SM_CLOCK_HZ[0]


def _bound(nbytes: float, flops: float, exps: float, dtype: str) -> tuple:
    """(bound ms, what bounds it): the largest of the bytes over the HBM
    rate, the flops over the peak rate of their type and the exponentials
    over the special function units' rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": flops / PEAK_FLOPS[dtype],
             "exponentials": exps / (EXP_PER_CLOCK_PER_SM * SMS
                                     * _max_sm_clock_hz())}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


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
# Phase 2's ragged cache lengths (the serving mix's), and the same stretched
# over a longer cache.
RAGGED = [1, 1024, 517, 64, 300, 900, 128, 777]


def _spread(s: int) -> list:
    return [max(1, n * s // 1024) for n in RAGGED]


# The decode rows of PERF.md's kernel table, all timed in phase 2 (and by
# chip_decode_probe.py --rows): name -> (b, hq, kv, d, s, dtype, lengths).
DECODE_TABLE = {
    "serving B8 Hq16 KV16 D64 S1024 bf16":
        (8, 16, 16, 64, 1024, "bfloat16", RAGGED),
    "tp=2 per rank B8 Hq8 KV8 D64 S1024 bf16":
        (8, 8, 8, 64, 1024, "bfloat16", RAGGED),
    "serving heads B8 Hq16 KV16 D32 S1024 bf16":
        (8, 16, 16, 32, 1024, "bfloat16", RAGGED),
    "GQA B8 Hq16 KV4 D16 S1024 bf16": (8, 16, 4, 16, 1024, "bfloat16", RAGGED),
    "f32 B2 Hq4 KV4 D16 S64": (2, 4, 4, 16, 64, "float32", [64, 17]),
    "Phi-3-mini B8 Hq32 KV32 D96 S4096 bf16":
        (8, 32, 32, 96, 4096, "bfloat16", _spread(4096)),
    "Gemma-2B MQA B8 Hq8 KV1 D256 S8192 bf16":
        (8, 8, 1, 256, 8192, "bfloat16", _spread(8192)),
    "Gemma-2B served B8 Hq8 KV8 D256 S8192 bf16":
        (8, 8, 8, 256, 8192, "bfloat16", _spread(8192)),
    "long context B1 Hq8 KV1 D64 S32768 bf16":
        (1, 8, 1, 64, 32768, "bfloat16", [32768]),
    "Phi-2 B8 Hq32 KV32 D80 S2048 bf16":
        (8, 32, 32, 80, 2048, "bfloat16", _spread(2048)),
    "GQA B8 Hq16 KV4 D8 S1024 bf16": (8, 16, 4, 8, 1024, "bfloat16", RAGGED),
    "f32 B2 Hq8 KV1 D256 S512": (2, 8, 1, 256, 512, "float32", [512, 77]),
    "runtime width B8 Hq16 KV4 D120 S1024 bf16":
        (8, 16, 4, 120, 1024, "bfloat16", RAGGED),
}
# The decode wrapper's host microseconds per call under the previous
# design (split-K on CUDA cores, rows staged in registers): the median over
# DECODE_TABLE's rows of chip_decode_probe.py --rows on that design's
# checkout, two runs on an NVIDIA H100 80GB HBM3 at 700 W in one call with
# this design's two runs (whose median was 27.5).
PARENT_HOST_US = 28.6
_DECODE_RECORDS: list = []  # every decode case's record, in order


def _host_us_per_call(fn, calls: int = 100, reps: int = 7) -> float:
    """Microseconds of host time per call of fn, enqueued back to back (the
    card keeps up at these sizes, so this is the wrapper's own cost): the
    median over `reps` runs of `calls` calls, as the host's clock is shared
    with other work."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def _decode_row(name, flush, gen):
    return _decode_case(name, *DECODE_TABLE[name], flush, gen)


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
    bound_ms, bound_by = _bound(nbytes, flops, rows * hq, dtype)
    rec = {
        "case": name, "d": d, "max_abs_err": err, "tol": TOL[dtype],
        "ms": ms,
        "plain_ms": _timed_ms(
            lambda: _reference_decode_attention(q, k, v, lens), flush),
        "library_ms": library_ms, "library_backend": backend,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gb_per_s": nbytes / ms / 1e6, "share_of_bound": bound_ms / ms,
        "host_us_per_call": _host_us_per_call(
            lambda: decode_attention_cuda(q, k, v, lens)),
    }
    log("decode " + json.dumps(rec))
    _DECODE_RECORDS.append(rec)
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
    if dtype == "float32":  # every sum of the f32 path is in a fixed order
        again = [flash_attention_cuda(q, k, v, causal, with_lse=True)
                 for _ in range(2)]
        if not (torch.equal(again[0][0], out)
                and all(torch.equal(a, b) for a, b in zip(*again))):
            raise AssertionError(f"{name}: two f32 calls differ")
    sdpa, backends = _sdpa_call(q, k, v, causal)
    flops = 4 * b * hq * d * _visible_pairs(sq, sk, causal)
    ms, library_ms, backend = _timed_in_turns(
        lambda: flash_attention_cuda(q, k, v, causal), lambda: sdpa,
        backends, flush)
    bound_ms, bound_by = _flash_bound(b, sq, sk, hq, hkv, d, dtype, causal)
    rec = {
        "case": name, "d": d, "max_abs_err": err, "tol": TOL[dtype],
        "ms": ms,
        "ms_with_lse": _timed_ms(
            lambda: flash_attention_cuda(q, k, v, causal, with_lse=True),
            flush),
        "plain_ms": _timed_ms(
            lambda: _reference_flash_attention(q, k, v, causal), flush),
        "library_ms": library_ms, "library_backend": backend,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "tflop_per_s": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
    }
    log("flash " + json.dumps(rec))
    return rec


def _flash_bound(b, sq, sk, hq, hkv, d, dtype, causal) -> tuple:
    """The forward's bound (ms, what bounds it): reading q, k and v and
    writing the output once, 4 B Hq D flops and B Hq exponentials per
    visible pair."""
    elem = 4 if dtype == "float32" else 2
    pairs = _visible_pairs(sq, sk, causal)
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elem
    return _bound(nbytes, 4 * b * hq * d * pairs, b * hq * pairs, dtype)


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
    bound_ms, bound_by = _bound(nbytes, flops, b * hq * pairs, dtype)
    rec = {
        "case": name, "d": d, "max_abs_err": err, "tol": TOL[dtype],
        "ms": ms,
        "plain_ms": _timed_ms(plain, flush),
        "library_ms": library_ms, "library_backend": backend,
        "library_call": "torch.autograd.grad of SDPA's output",
        "bound_ms": bound_ms, "bound_by": bound_by,
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
    host = [r["host_us_per_call"] for r in _DECODE_RECORDS
            if r["case"] in DECODE_TABLE]
    log(f"decode wrapper host us per call, median over the table's "
        f"{len(host)} rows: {statistics.median(host):.1f} (previous design "
        f"{PARENT_HOST_US})")
    return recs


def _kernel_cases():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    decode_main = _decode_row("serving B8 Hq16 KV16 D64 S1024 bf16", flush,
                              gen)
    _decode_row("tp=2 per rank B8 Hq8 KV8 D64 S1024 bf16", flush, gen)
    _decode_case("GQA B8 Hq16 KV4 D64 S1024 bf16", 8, 16, 4, 64, 1024,
                 "bfloat16", RAGGED, flush, gen)
    _decode_case("f32 B8 Hq16 KV16 D64 S1024", 8, 16, 16, 64, 1024,
                 "float32", RAGGED, flush, gen)
    _decode_case("D128 GQA rep 16 B4 Hq32 KV2 S600 bf16", 4, 32, 2, 128,
                 600, "bfloat16", [1, 600, 333, 17], flush, gen)
    # long context, one item: the most chunks per sequence, both levels of
    # the merge tree
    _decode_row("long context B1 Hq8 KV1 D64 S32768 bf16", flush, gen)
    flash_main = _flash_row(FWD_MAIN, flush, gen)
    for name in FWD_PHASE2:
        _flash_row(name, flush, gen)
    bwd_main = _flash_bwd_row(BWD_MAIN, flush, gen)
    for name in BWD_PHASE2:
        _flash_bwd_row(name, flush, gen)
    norm = [_norm_case(name, *args, flush, gen)
            for name, args in NORM_TABLE.items()]
    narrow = _narrow_cases(flush, gen)
    wide = _wide_cases(flush, gen)
    del flush
    return decode_main, flash_main, bwd_main, norm, narrow, wide


# The RMSNorm rows of PERF.md's kernel table, timed in phase 2: name ->
# (shape, dtype). The training cell's rows (B4 S4096 of Phi-3-medium's
# 5120), and a width of 65 vectors, whose row groups of 96 threads leave
# 31 idle.
NORM_TABLE = {
    "norm training B4 S4096 d5120 bf16": ((4, 4096, 5120), "bfloat16"),
    "norm narrow 16384 rows d520 bf16": ((16384, 520), "bfloat16"),
}
NORM_EPS = 1e-6
# dscale against the plain backward's, as a relative norm: both sum in f32,
# the kernel over blocks' partials, the plain version in torch's order.
NORM_DSCALE_REL_TOL = 1e-5


def _norm_case(name, shape, dtype, flush, gen):
    """The RMSNorm kernels against the plain forward and closed-form
    backward, the backward as a residual block runs it (adding the
    residual's gradient dres into dx). Bound: reading x and writing y and
    r once (forward); reading x, dy, dres and r and writing dx and dscale
    once (backward); the f32 arithmetic (4 and 11 flops an element) at
    the f32 peak."""
    import torch

    from ray_tpu_torch.ops.rms_norm import (_reference_rms_norm,
                                            _reference_rms_norm_backward,
                                            rms_norm_backward_cuda,
                                            rms_norm_cuda)

    dt = getattr(torch, dtype)
    x = (torch.randn(*shape, generator=gen, device="cuda") * 3).to(dt)
    scale = torch.randn(shape[-1], generator=gen, device="cuda")
    dy = torch.randn(*shape, generator=gen, device="cuda").to(dt)
    dres = torch.randn(*shape, generator=gen, device="cuda").to(dt)
    y, r = rms_norm_cuda(x, scale, NORM_EPS, with_r=True)
    dx, ds = rms_norm_backward_cuda(x, scale, r, dy, dres)
    ref_y, ref_r = _reference_rms_norm(x, scale, NORM_EPS)
    ref_dx, ref_ds = _reference_rms_norm_backward(x, scale, ref_r, dy, dres)
    torch.cuda.synchronize()
    err = max(_max_err(y, ref_y, dtype), _max_err(dx, ref_dx, dtype))
    ds_rel = float((ds - ref_ds).norm() / ref_ds.norm())
    if not ds_rel <= NORM_DSCALE_REL_TOL:
        raise AssertionError(f"{name}: dscale differs from the plain "
                             f"backward's by {ds_rel}")
    again = rms_norm_backward_cuda(x, scale, r, dy, dres)
    if not (torch.equal(again[0], dx) and torch.equal(again[1], ds)):
        raise AssertionError(f"{name}: two backward calls differ")
    n, d = x.numel(), shape[-1]
    rows, elem = n // d, x.element_size()
    fwd_bound = _bound(2 * n * elem + 4 * rows + 4 * d, 4 * n, 0, "float32")
    bwd_bound = _bound(4 * n * elem + 4 * rows + 8 * d, 11 * n, 0, "float32")
    ms = _timed_ms(lambda: rms_norm_cuda(x, scale, NORM_EPS, with_r=True),
                   flush)
    bwd_ms = _timed_ms(
        lambda: rms_norm_backward_cuda(x, scale, r, dy, dres), flush)
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype],
        "dscale_rel_err": ds_rel, "ms": ms,
        "plain_ms": _timed_ms(
            lambda: _reference_rms_norm(x, scale, NORM_EPS), flush),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "share_of_bound": fwd_bound[0] / ms, "bwd_ms": bwd_ms,
        "bwd_plain_ms": _timed_ms(
            lambda: _reference_rms_norm_backward(x, scale, ref_r, dy, dres),
            flush),
        "bwd_bound_ms": bwd_bound[0], "bwd_share_of_bound":
            bwd_bound[0] / bwd_ms, "library_ms": None}
    log("rms_norm " + json.dumps(rec))
    return rec


# Phase 2's flash forward and backward cases at the reference's own head
# widths, D = 16 and 32: name, b, sq, sk, hq, hkv, d, dtype (causal).
NARROW_SHAPES = [
    ("B4 S1024 H16 D32 bf16 causal", 4, 1024, 1024, 16, 16, 32, "bfloat16"),
    ("entry() B2 S128 H8 D32 bf16 causal", 2, 128, 128, 8, 8, 32,
     "bfloat16"),
    ("dryrun training f32 B8 S32 H8 D16 causal", 8, 32, 32, 8, 8, 16,
     "float32"),
    ("GQA Hq8 Hkv2 Sq512 < Sk1024 D16 bf16 causal", 2, 512, 1024, 8, 2, 16,
     "bfloat16"),
    ("ragged Sq=Sk=1000 H8 D32 bf16 causal", 2, 1000, 1000, 8, 8, 32,
     "bfloat16")]
# ... and at the other head widths the JAX package's kernels take.
WIDE_SHAPES = [
    ("Phi-3-mini B2 S2048 H32 D96 bf16 causal", 2, 2048, 2048, 32, 32, 96,
     "bfloat16"),
    ("Gemma-2B MQA B2 S2048 Hq8 Hkv1 D256 bf16 causal", 2, 2048, 2048, 8, 1,
     256, "bfloat16"),
    ("Phi-2 B2 S2048 H32 D80 bf16 causal", 2, 2048, 2048, 32, 32, 80,
     "bfloat16"),
    ("f32 B2 S256 H4 D8 causal", 2, 256, 256, 4, 4, 8, "float32"),
    ("runtime width B2 S2048 H16 D40 bf16 causal", 2, 2048, 2048, 16, 16, 40,
     "bfloat16")]
# The forward rows of PERF.md's kernel table, all timed in phase 2 (and by
# chip_fwd_probe.py --rows): name -> (b, sq, sk, hq, hkv, d, dtype, causal).
# The f32 rows at the tiles of 128 and 256 are the golden heads file's
# training batches at D = 96 and 256 (HEADS_MODELS: B2, 64 tokens).
FWD_MAIN = "forward B4 S1024 H16 D64 bf16 causal"
FWD_PHASE2 = {
    "bench b4 s2048 h8 d128 bf16 causal=True":
        (4, 2048, 2048, 8, 8, 128, "bfloat16", True),
    "bench b4 s2048 h8 d128 bf16 causal=False":
        (4, 2048, 2048, 8, 8, 128, "bfloat16", False),
    "GQA Sq512 < Sk1024 Hq8 Hkv2 d128 bf16 causal":
        (2, 512, 1024, 8, 2, 128, "bfloat16", True),
    "ragged Sq=Sk=1000 h8 d64 bf16 causal":
        (2, 1000, 1000, 8, 8, 64, "bfloat16", True),
    "f32 s256 h4 d64 causal": (1, 256, 256, 4, 4, 64, "float32", True),
    "f32 golden d96 B2 S64 H3 D96 causal": (2, 64, 64, 3, 3, 96, "float32",
                                            True),
    "f32 golden d256 B2 S64 H2 D256 causal": (2, 64, 64, 2, 2, 256,
                                              "float32", True)}
FWD_TABLE = {
    FWD_MAIN: (4, 1024, 1024, 16, 16, 64, "bfloat16", True),
    **FWD_PHASE2,
    **{f"forward {n}": (*a, True) for n, *a in NARROW_SHAPES + WIDE_SHAPES}}
# The backward rows of PERF.md's kernel table, all timed in phase 2 but
# the tp=2 per-rank one (phase 12 (f)), and by chip_bwd_probe.py --rows:
# name -> (b, sq, sk, hq, hkv, d, dtype, causal).
BWD_MAIN = "backward B4 S1024 H16 D64 bf16 causal"
BWD_PHASE2 = {
    "backward bench b4 s2048 h8 d128 bf16 causal=True":
        (4, 2048, 2048, 8, 8, 128, "bfloat16", True),
    "backward bench b4 s2048 h8 d128 bf16 causal=False":
        (4, 2048, 2048, 8, 8, 128, "bfloat16", False),
    "backward GQA Hq16 Hkv4 Sq512 < Sk1024 d64 bf16 causal":
        (2, 512, 1024, 16, 4, 64, "bfloat16", True),
    "backward ragged Sq=Sk=1000 h8 d64 bf16 causal":
        (2, 1000, 1000, 8, 8, 64, "bfloat16", True),
    "backward f32 s256 h4 d64 causal": (1, 256, 256, 4, 4, 64, "float32",
                                        True),
    "backward Sq1024 > Sk512 h8 d64 bf16 causal":
        (1, 1024, 512, 8, 8, 64, "bfloat16", True)}
BWD_TABLE = {
    BWD_MAIN: (4, 1024, 1024, 16, 16, 64, "bfloat16", True),
    "tp=2 per rank backward B4 S1024 H8 D64 bf16 causal":
        (4, 1024, 1024, 8, 8, 64, "bfloat16", True),
    **BWD_PHASE2,
    **{f"backward {n}": (*a, True) for n, *a in NARROW_SHAPES + WIDE_SHAPES}}


def _flash_row(name, flush, gen):
    return _flash_case(name, *FWD_TABLE[name], flush, gen)


def _flash_bwd_row(name, flush, gen):
    return _flash_bwd_case(name, *BWD_TABLE[name], flush, gen)


def _narrow_cases(flush, gen) -> dict:
    """Phase 2 at the reference's own head widths, D = 16 and 32: each
    kernel's records by name."""
    decode = [_decode_row(name, flush, gen) for name in (
        "serving heads B8 Hq16 KV16 D32 S1024 bf16",
        "GQA B8 Hq16 KV4 D16 S1024 bf16", "f32 B2 Hq4 KV4 D16 S64")]
    flash = [_flash_row(f"forward {n}", flush, gen)
             for n, *_ in NARROW_SHAPES]
    bwd = [_flash_bwd_row(f"backward {n}", flush, gen)
           for n, *_ in NARROW_SHAPES]
    return {"decode_attention": decode, "flash_attention": flash,
            "flash_attention_bwd": bwd}


def _wide_cases(flush, gen) -> dict:
    """Phase 2 at the other head widths the JAX package's kernels take:
    Phi-3-mini's D = 96 and Gemma-2B's D = 256 at phase 16's shapes (the
    serving caches ragged over S, Gemma's both as trained, multi-query, and
    as served, 8 KV heads; the training step's B2 S2048), Phi-2's
    D = 80, D = 8, D = 256 in f32, and widths no listed model uses (D = 120
    decode, D = 40 forward and backward: the runtime-width instances of
    tiles 128 and 64). Each kernel's records by name."""
    decode = [_decode_row(name, flush, gen) for name in (
        "Phi-3-mini B8 Hq32 KV32 D96 S4096 bf16",
        "Gemma-2B MQA B8 Hq8 KV1 D256 S8192 bf16",
        "Gemma-2B served B8 Hq8 KV8 D256 S8192 bf16",
        "Phi-2 B8 Hq32 KV32 D80 S2048 bf16", "GQA B8 Hq16 KV4 D8 S1024 bf16",
        "f32 B2 Hq8 KV1 D256 S512",
        "runtime width B8 Hq16 KV4 D120 S1024 bf16")]
    flash = [_flash_row(f"forward {n}", flush, gen)
             for n, *_ in WIDE_SHAPES]
    bwd = [_flash_bwd_row(f"backward {n}", flush, gen)
           for n, *_ in WIDE_SHAPES]
    return {"decode_attention": decode, "flash_attention": flash,
            "flash_attention_bwd": bwd}


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


# ------------------------------------------------ the reference's widths
GOLDEN_HEADS = os.path.join(REPO, "tests", "data",
                            "torch_port_golden_heads.npz")
#: The JAX package's own configurations at its own head widths, as
#: LLMConfig derives a model from them (d_ff = int(8/3 d_model) // 8 * 8):
#: the dryrun's training model (__graft_entry__.py:90-93, d_model 128 in 8
#: heads, so D = 16; its TransformerConfig has d_ff 344, this 336) and
#: entry()'s model (__graft_entry__.py:21, d_model 256 in 8 heads, so
#: D = 32; d_ff 688 there, 680 here). Attention, the part these check, is
#: the same in both forms.
#: Phase 16's small models at the other widths the JAX package's kernels
#: take (D = 8, 80, 96 and 256), 2 layers each, as LLMConfig derives them.
HEADS_MODELS = {
    "train": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=8,
                  max_seq=64),
    "entry": dict(vocab_size=2048, d_model=256, n_layers=2, n_heads=8,
                  max_seq=256),
    "d8": dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4,
               max_seq=64),
    "d80": dict(vocab_size=256, d_model=160, n_layers=2, n_heads=2,
                max_seq=64),
    "d96": dict(vocab_size=256, d_model=288, n_layers=2, n_heads=3,
                max_seq=64),
    "d256": dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2,
                 max_seq=64),
}
#: The models of phase 15 (the reference's widths) and of phase 16.
REFERENCE_HEADS = ("train", "entry")
WIDE_HEADS = ("d8", "d80", "d96", "d256")
#: Models whose training step (loss and sampled gradients) the file holds.
HEADS_TRAINED = ("train", *WIDE_HEADS)
HEADS_SEED = 21
#: Each model's weight seed (train and entry as the file had them first).
HEADS_SEEDS = {"entry": 21, "train": 22, "d8": 23, "d80": 24, "d96": 25,
               "d256": 26}
HEADS_PROMPTS = ([5, 17, 250, 3, 99], [1, 2, 3, 4, 5, 6, 7, 8, 9])
HEADS_MAX_TOKENS = 12
#: Gradient entries the file keeps per parameter tensor (all of a smaller
#: tensor), at indices drawn from the seed: the whole gradient of the
#: training model would be 1.8 MB. The CPU test holds every entry of the
#: port's gradient to the JAX package's, recomputed.
HEADS_GRAD_SAMPLES = 1024


def heads_params(name: str) -> dict:
    """Flax param tree (numpy f32) of HEADS_MODELS[name], drawn with numpy
    from HEADS_SEED (the layout of tests/test_torch_golden.py's)."""
    cfg = HEADS_MODELS[name]
    rng = np.random.RandomState(HEADS_SEEDS[name])
    d, h = cfg["d_model"], cfg["n_heads"]
    hd, ff = d // h, int(d * 8 / 3) // 8 * 8

    def normal(shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def norm():
        return {"scale": (1.0 + 0.1 * rng.randn(d)).astype(np.float32)}

    # the tied head's logits then have unit scale, so each greedy step
    # has a clear top-1
    tree = {"tok_emb": normal((cfg["vocab_size"], d), d)}
    for i in range(cfg["n_layers"]):
        tree[f"layer_{i}"] = {
            "attn_norm": norm(),
            "attn": {"wq": {"kernel": normal((d, h, hd), d)},
                     "wk": {"kernel": normal((d, h, hd), d)},
                     "wv": {"kernel": normal((d, h, hd), d)},
                     "wo": {"kernel": normal((h, hd, d), d)}},
            "mlp_norm": norm(),
            "mlp": {"w_gate": {"kernel": normal((d, ff), d)},
                    "w_up": {"kernel": normal((d, ff), d)},
                    "w_down": {"kernel": normal((ff, d), ff)}},
        }
    tree["final_norm"] = norm()
    return tree


def heads_tokens(name: str) -> np.ndarray:
    """Seeded tokens [2, 32] whose full-forward logits the file holds."""
    return np.random.RandomState(HEADS_SEED + 10).randint(
        0, HEADS_MODELS[name]["vocab_size"], size=(2, 32)).astype(np.int32)


def heads_train_tokens(name: str = "train") -> np.ndarray:
    """A trained model's batch: [2, max_seq + 1] seeded tokens."""
    cfg = HEADS_MODELS[name]
    return np.random.RandomState(HEADS_SEED + 20).randint(
        0, cfg["vocab_size"], size=(2, cfg["max_seq"] + 1)).astype(np.int32)


def heads_flat(tree, prefix: str = "") -> dict:
    """A flax tree as {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(heads_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def heads_grad_index(key: str, size: int) -> np.ndarray:
    """The flat indices of one gradient tensor that the file keeps."""
    if size <= HEADS_GRAD_SAMPLES:
        return np.arange(size)
    rng = np.random.RandomState(HEADS_SEED + sum(map(ord, key)))
    return np.sort(rng.choice(size, HEADS_GRAD_SAMPLES, replace=False))


def heads_port_outputs(device, names=REFERENCE_HEADS) -> dict:
    """The port at the file's weights on `device` (float32; TF32 off on
    the card): each named model's full-forward logits and its
    ContinuousEngine's greedy tokens, and each trained model's loss and
    sampled gradients of one step, keyed as in the file."""
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import (ContinuousEngine, SamplingParams,
                                          model_config)
    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.models.transformer import Transformer, loss_fn

    out = {}
    for name in names:
        cfg = HEADS_MODELS[name]
        tree = heads_params(name)
        lcfg = LLMConfig(**cfg, dtype="float32",
                         params=params_from_flax(tree))
        model = Transformer(model_config(lcfg), device=device)
        model.load_state_dict(lcfg.params)
        with torch.no_grad():
            out[f"{name}/logits"] = model(torch.from_numpy(
                heads_tokens(name)).long().to(device)).cpu().numpy()
        eng = ContinuousEngine(lcfg, max_batch=2, decode_chunk=4,
                               device=device)
        try:
            streams = [eng.submit(p, SamplingParams(
                temperature=0.0, max_tokens=HEADS_MAX_TOKENS))
                for p in HEADS_PROMPTS]
            out[f"{name}/greedy"] = np.asarray([s.tokens() for s in streams],
                                               np.int32)
        finally:
            eng.shutdown()
        if name not in HEADS_TRAINED:
            continue
        loss = loss_fn(model, torch.from_numpy(
            heads_train_tokens(name)).long().to(device))
        loss.backward()
        out[f"{name}/loss"] = np.float32(loss.item())
        grads = {n: p.grad.detach().cpu().numpy()
                 for n, p in model.named_parameters()}
        for key, leaf in heads_flat(tree).items():
            g = grads[_port_name(key)]
            assert g.shape == leaf.shape, (key, g.shape, leaf.shape)
            g = g.reshape(-1)
            out[f"{name}/grad/{key}"] = g[heads_grad_index(key, g.size)]
    return out


def _port_name(key: str) -> str:
    """A flax key ("layer_0/attn/wq/kernel") as the port's parameter name
    ("layers.0.attn.wq"); models/convert.py keeps every leaf's shape."""
    return re.sub(r"^layer_(\d+)", r"layers.\1",
                  key.removesuffix("/kernel")).replace("/", ".")


def heads_check(g: dict, out: dict, names=REFERENCE_HEADS) -> dict:
    """Hold the port's outputs of the named models to the file: logits
    within 1e-4, greedy tokens equal, and for the trained ones loss within
    1e-5 and every kept gradient entry within 1e-4 * max(1, |ref|) (f32,
    other summation order). Returns the worst errors; raises on a miss."""
    rec = {}
    for name in names:
        rec[f"{name}_logit_err"] = float(np.abs(
            out[f"{name}/logits"] - g[f"{name}/logits"]).max())
        if not np.array_equal(out[f"{name}/greedy"], g[f"{name}/greedy"]):
            raise AssertionError(
                f"{name}: greedy tokens differ from the JAX package's:\n"
                f"{out[f'{name}/greedy']}\n{g[f'{name}/greedy']}")
        if not rec[f"{name}_logit_err"] <= 1e-4:
            raise AssertionError(f"{name}: logits differ by "
                                 f"{rec[f'{name}_logit_err']}")
        if name not in HEADS_TRAINED:
            continue
        loss_err = abs(float(out[f"{name}/loss"]) - float(g[f"{name}/loss"]))
        worst = max(float((np.abs(out[k] - g[k])
                           / np.maximum(1.0, np.abs(g[k]))).max())
                    for k in g if k.startswith(f"{name}/grad/"))
        rec[f"{name}_loss_err"], rec[f"{name}_grad_err"] = loss_err, worst
        if not (loss_err <= 1e-5 and worst <= 1e-4):
            raise AssertionError(f"{name}: training step differs from the "
                                 f"JAX package's: {rec}")
    return rec


#: Phase 15 (b): entry()'s model as __graft_entry__.py:21 defines it (d_model
#: 256 in 8 heads, so D = 32, d_ff 688), in bf16, on seeded tokens [2, 128].
ENTRY_MODEL = dict(vocab_size=2048, d_model=256, n_layers=2, n_heads=8,
                   n_kv_heads=8, d_ff=688, max_seq=256)


def phase_widths(device: str = "cuda") -> dict:
    """Phase 15: the reference's own head widths on the card. (a) the
    golden file at D = 16 and 32 (heads_port_outputs / heads_check, f32,
    TF32 off); (b) entry()'s model in bf16: its forward through the flash
    kernel at D = 32 and one backward through the backward kernel against
    the plain attention path on the card, as relative norms within
    TRAIN_GRAD_REL_TOL; (c) each kernel's launches by head dim on (a) and
    (b), none of the six (kernel, D) pairs at 0. `device="cpu"` rehearses
    it with the plain versions (where (b) and (c) find no launches)."""
    import torch

    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig, loss_fn)

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(GOLDEN_HEADS) as f:
        g = {k: f[k] for k in f.files}
    kernels.reset_launch_counts()
    golden = heads_check(g, heads_port_outputs(device))
    launches = kernels.launch_counts_by_head_dim()
    rec = {"golden": golden, "golden_launches": launches}
    log("widths golden " + json.dumps(rec))

    cfg = TransformerConfig(**ENTRY_MODEL, dtype=torch.bfloat16)
    model = Transformer(cfg, device=device, seed=0)
    tokens = torch.from_numpy(np.random.RandomState(HEADS_SEED).randint(
        0, cfg.vocab_size, (2, 128))).to(device)

    def run(context):
        model.zero_grad(set_to_none=True)
        with context():
            with torch.no_grad():
                logits = model(tokens)
            loss_fn(model, tokens).backward()
        return logits, {n: p.grad.clone()
                        for n, p in model.named_parameters()}

    kernels.reset_launch_counts()
    logits, grads = run(contextlib.nullcontext)
    entry_launches = kernels.launch_counts_by_head_dim()
    ref_logits, ref_grads = run(_plain_attention)
    if not torch.isfinite(logits).all():
        raise AssertionError("entry() logits are not finite")
    rel = {n: float((grads[n] - r).norm() / r.norm())
           for n, r in ref_grads.items()}
    worst = max(rel, key=rel.get)
    rec["entry"] = {
        "logits_rel_err_vs_plain": float((logits - ref_logits).norm()
                                         / ref_logits.norm()),
        "worst_grad_rel_err_vs_plain": [worst, rel[worst]],
        "launches": entry_launches}
    log("widths entry() " + json.dumps(rec["entry"]))
    want = {"flash_attention": {32: 2 * cfg.n_layers},
            "flash_attention_bwd": {32: cfg.n_layers}}
    for name, by_d in want.items():
        if entry_launches[name] != by_d:
            raise AssertionError(f"entry(): {name} launched "
                                 f"{entry_launches[name]}, want {by_d}")
    if not (rec["entry"]["logits_rel_err_vs_plain"] <= TRAIN_GRAD_REL_TOL
            and rel[worst] <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"entry() differs from the plain path: "
                             f"{rec['entry']}")

    for name, by_d in entry_launches.items():
        for d, n in by_d.items():
            launches[name][d] = launches[name].get(d, 0) + n
    rec["launches"] = launches
    missing = [(name, d) for name in launches for d in (16, 32)
               if launches[name].get(d, 0) == 0]
    if missing:
        raise AssertionError(f"never launched on phase 15's paths: {missing}")
    rec["phase_s"] = time.perf_counter() - t0
    log(f"phase 15 (the reference's widths): {rec['phase_s']:.1f} s, "
        f"launches by head dim {json.dumps(launches)}")
    return rec


# ------------------------------------------------- the other head widths
#: Phase 16 (a): Phi-3-mini's widths, microsoft/Phi-3-mini-4k-instruct's
#: config.json (hidden_size 3072, 32 heads and 32 KV heads, so D = 96,
#: intermediate_size 8192, 32 layers, vocab_size 32064, 4096 positions);
#: LLMConfig derives the same d_ff (8192) and KV heads. About 3.8 B
#: parameters (7.6 GB in bf16) and 12.9 GB of slot caches at max_batch 8.
PHI3_MINI = dict(vocab_size=32064, d_model=3072, n_layers=32, n_heads=32,
                 max_seq=4096, dtype="bfloat16", seed=0)
#: (b): Gemma-2B's attention width, google/gemma-2b's config.json
#: (hidden_size 2048, 8 heads of 256, 18 layers, vocab_size 256000, 8192
#: positions). LLMConfig derives the rest, so it differs from Gemma-2B in
#: two ways: 8 KV heads where Gemma has 1 (multi-query), and a SwiGLU
#: d_ff of 5456 where Gemma has GeGLU at 16384. The port adds nothing the
#: JAX package lacks; (d) trains the multi-query form (n_kv_heads=1), so
#: the group-8 backward runs.
GEMMA_2B = dict(vocab_size=256000, d_model=2048, n_layers=18, n_heads=8,
                max_seq=8192, dtype="bfloat16", seed=0)
#: (d): both models' TransformerConfig with depth cut to this many layers,
#: one batch [2, 2049], this many Adam steps.
WIDE_TRAIN_LAYERS = 2
WIDE_TRAIN_STEPS = 3
#: (c): a greedy prompt's first decode steps, logits of the kernels against
#: the same model on the plain attention functions, as ||got - want|| /
#: ||want|| per step: both compute in bf16 and differ in attention's
#: rounding only.
WIDE_DECODE_STEPS = 4
WIDE_LOGIT_REL_TOL = 2e-2


@contextlib.contextmanager
def _plain_decode():
    """The model's decode attention swapped for the decode kernel's plain
    version (for the comparison run only)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops.decode_attention import _reference_decode_attention

    saved = transformer.decode_attention
    transformer.decode_attention = _reference_decode_attention
    try:
        yield
    finally:
        transformer.decode_attention = saved


def _wide_logits(model, prompt, tokens, other=None) -> dict:
    """(c): the prefill and WIDE_DECODE_STEPS decode steps of `prompt`
    followed by a server's greedy `tokens`, teacher forced through a 1-slot
    cache, with the decode kernel and with its plain version. Each decode
    step's relative norm is held to WIDE_LOGIT_REL_TOL. The server chose
    its tokens on a cache of 8 slots, whose split plan sums attention in
    another order, so a near-tie can round apart: each token must be the
    plain path's largest logit, or below it by at most twice the larger of
    the row's kernel-vs-plain difference and one bf16 step (2^-7) of the
    row's largest |logit|. `other`, greedy tokens of the same prompt from
    another engine, is held to the same rule where it first departs from
    `tokens` (past that its prefix differs)."""
    import torch

    toks = list(tokens[:WIDE_DECODE_STEPS + 1])
    got = _teacher_forced_logits(model, prompt, toks)
    with _plain_decode():
        want = _teacher_forced_logits(model, prompt, toks)
    if not torch.isfinite(got).all():
        raise AssertionError("decode logits are not finite")
    rel = [float((g - w).norm() / w.norm()) for g, w in zip(got[1:], want[1:])]
    allowed = 2 * torch.maximum((got - want).abs().amax(dim=1),
                                2.0 ** -7 * want.abs().amax(dim=1))

    def gap(row, token):
        return float(want[row].max() - want[row, token])

    gaps = [gap(i, t) for i, t in enumerate(toks)]
    shares = [g / float(allowed[i]) for i, g in enumerate(gaps)]
    rec = {"decode_steps": len(rel), "logits_rel_err_vs_plain": rel,
           "argmax_equal_steps": int((got.argmax(1) == want.argmax(1)).sum()),
           "tokens_plain_argmax": sum(g == 0 for g in gaps),
           "worst_gap": max(gaps), "allowed_gaps": allowed.tolist()}
    if other is not None:
        other = list(other[:len(toks)])
        same = [a == b for a, b in zip(toks, other)]
        first = same.index(False) if False in same else len(same)
        rec["other_tokens"], rec["other_equal_prefix"] = other, first
        if first < len(toks):
            rec["other_gap_where_it_departs"] = gap(first, other[first])
            shares.append(rec["other_gap_where_it_departs"]
                          / float(allowed[first]))
    rec["worst_share_of_allowed"] = max(shares)
    if len(rel) != WIDE_DECODE_STEPS or max(rel) > WIDE_LOGIT_REL_TOL:
        raise AssertionError(f"decode logits differ from the plain path: "
                             f"{rec}")
    if rec["worst_share_of_allowed"] > 1.0:
        raise AssertionError(f"a greedy token is no near-argmax of the "
                             f"plain path: {rec}")
    return rec


def _check_answers(bodies, results, vocab: int) -> int:
    """Every request answered with its tokens and finish reason "length";
    returns the tokens generated."""
    n = 0
    for body, out in zip(bodies, results):
        if out is None:
            raise AssertionError("a completion was not answered")
        toks = out["token_ids"]
        reason = out["choices"][0]["finish_reason"]
        if len(toks) != body["max_tokens"] or reason != "length" or \
                not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"completion gave {len(toks)} tokens of "
                                 f"{body['max_tokens']}, finish {reason}")
        n += len(toks)
    return n


def _concurrent(call, bodies) -> tuple[list, float]:
    """Phase 4's staggered concurrent requests through `call`; (answers,
    wall seconds)."""
    results = [None] * len(bodies)

    def worker(i):
        results[i] = call(bodies[i])

    t0 = time.perf_counter()
    threads = []
    for i in range(len(bodies)):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    return results, time.perf_counter() - t0


def _wide_serve(name: str, widths: dict, call, stats) -> tuple[dict, tuple]:
    """(a) or (b): a greedy prompt, then phase 4's 6-request mix (prompts
    of 64 to 256 tokens) through `call`; every request answered with its
    finish reason. `stats()` gives (decode steps, decode launches)."""
    rng = np.random.RandomState(16)
    vocab = widths["vocab_size"]

    def prompt(n):
        return rng.randint(0, vocab, n).tolist()

    lone = {"prompt": prompt(128), "temperature": 0.0,
            "max_tokens": WIDE_DECODE_STEPS + 1}
    t0 = time.perf_counter()
    first = call(lone)
    _check_answers([lone], [first], vocab)
    first_s = time.perf_counter() - t0
    steps0, launches0 = stats()
    bodies = _serve_mix(prompt)
    results, wall = _concurrent(call, bodies)
    n_tokens = _check_answers(bodies, results, vocab)
    steps, launches = stats()
    steps, launches = steps - steps0, launches - launches0
    need = widths["n_layers"] * steps
    if launches < need or steps == 0:
        raise AssertionError(f"{name}: the decode kernel launched {launches} "
                             f"times for {steps} steps of "
                             f"{widths['n_layers']} layers")
    rec = {"model": name, "d": widths["d_model"] // widths["n_heads"],
           "lone_prompt_s": first_s, "concurrent_requests": len(bodies),
           "generated_tokens": n_tokens, "wall_s": wall,
           "tokens_per_s": n_tokens / wall, "decode_steps": steps,
           "ms_per_decode_step_wall": 1e3 * wall / steps,
           "decode_launches": launches}
    return rec, (lone["prompt"], first["token_ids"])


def _wide_phi3_http() -> tuple[dict, tuple, dict]:
    """(a): Phi-3-mini served through build_openai_app by a replica actor
    that holds the card: its record, its greedy prompt and tokens, and the
    replica's launches by head dim."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import build_openai_app

    rt.init(num_cpus=4)
    try:
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        serve.run(build_openai_app(LLMConfig(**PHI3_MINI), max_batch=8,
                                   decode_chunk=16, default_max_tokens=64,
                                   ray_actor_options={"num_gpus": 1}),
                  port=port)
        deploy_s = time.perf_counter() - t0

        def stats():
            st = _http(f"{base}/v1/stats")
            return st["decode_steps"], st["kernel_launches"]["decode_attention"]

        rec, lone = _wide_serve(
            "Phi-3-mini", PHI3_MINI,
            lambda body: _http(f"{base}/v1/completions", body), stats)
        st = _http(f"{base}/v1/stats")
        if st["pid"] == os.getpid():
            raise AssertionError("Phi-3-mini was not served by a replica")
        rec.update(deploy_s=deploy_s, replica_pid=st["pid"],
                   replica_device_bytes=st["device_bytes"])
        by_d = {name: {int(d): n for d, n in c.items()}
                for name, c in st["kernel_launches_by_head_dim"].items()}
    finally:
        serve.shutdown()
        rt.shutdown()
    return rec, lone, by_d


def _wide_train(name: str, widths: dict, n_kv_heads: int, kernels) -> dict:
    """(d): the model's TransformerConfig cut to WIDE_TRAIN_LAYERS layers,
    f32 parameters and bf16 compute, one seeded batch [2, 2049]: the first
    step's loss and gradients against the plain attention path (relative
    norms within TRAIN_GRAD_REL_TOL), then WIDE_TRAIN_STEPS Adam steps with
    the flash kernels once per layer per step."""
    import dataclasses

    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import model_config
    from ray_tpu_torch.models.transformer import Transformer, loss_fn

    cfg = dataclasses.replace(model_config(LLMConfig(**widths)),
                              n_layers=WIDE_TRAIN_LAYERS,
                              n_kv_heads=n_kv_heads)
    model = Transformer(cfg, device="cuda", seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2049),
                           generator=torch.Generator().manual_seed(16)).cuda()

    def grads(context):
        model.zero_grad(set_to_none=True)
        with context():
            loss = loss_fn(model, tokens)
            loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    ref_loss, ref = grads(_plain_attention)
    kernels.reset_launch_counts()
    loss0, got = grads(contextlib.nullcontext)
    rel = {n: float((got[n] - r).norm() / r.norm()) for n, r in ref.items()}
    del ref, got
    worst = max(rel, key=rel.get)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(WIDE_TRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    by_d = kernels.launch_counts_by_head_dim()
    d = cfg.head_dim
    rec = {"model": name, "d": d, "n_kv_heads": n_kv_heads,
           "layers": WIDE_TRAIN_LAYERS,
           "loss_rel_err_vs_plain": abs(loss0 - ref_loss) / abs(ref_loss),
           "worst_grad_rel_err_vs_plain": [worst, rel[worst]],
           "losses": losses, "launches": by_d}
    log("wide train " + json.dumps(rec))
    want = WIDE_TRAIN_LAYERS * (WIDE_TRAIN_STEPS + 1)
    if by_d["flash_attention"] != {d: want} or \
            by_d["flash_attention_bwd"] != {d: want}:
        raise AssertionError(f"{name}: flash kernels not launched once per "
                             f"layer per step at D = {d}: {by_d}")
    if not (rec["loss_rel_err_vs_plain"] <= TRAIN_GRAD_REL_TOL
            and rel[worst] <= TRAIN_GRAD_REL_TOL
            and all(np.isfinite(losses))):
        raise AssertionError(f"{name}: training differs from the plain "
                             f"path: {rec}")
    del model, opt
    torch.cuda.empty_cache()
    return rec


def phase_wide() -> dict:
    """Phase 16: the other head widths the JAX package's kernels take, at
    full width through the normal entry points. (0) the golden heads
    file's models at D = 8, 80, 96 and 256 (f32, TF32 off): logits,
    greedy tokens, loss and kept gradient entries under phase 15's
    bounds; (a) Phi-3-mini (D = 96) served over HTTP by a replica actor
    holding the card, with phase 4's request mix; (b) Gemma-2B's attention
    width (D = 256) served in process by OpenAIServer, the same mix; (c)
    for each, the server's greedy tokens of a prompt teacher forced
    through the kernels and through the plain attention path on the same
    weights (`_wide_logits`; for Phi-3-mini an in-process engine from the
    same seed with a 1-slot cache, whose own greedy tokens are held to
    the same rule where they depart from the replica's); (d) both
    TransformerConfigs cut to 2 layers (Gemma's multi-query,
    n_kv_heads=1) trained 3 Adam steps
    against the plain attention path; every kernel must launch at each of
    D = 8, 80, 96 and 256 on these paths."""
    import torch

    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams
    from ray_tpu_torch.llm.openai import OpenAIServer

    t_phase = time.perf_counter()
    rec, launches = {}, {k.name: {} for k in kernels.HEAD_DIM_KERNELS}

    def add(by_d):
        for name, counts in by_d.items():
            for d, n in counts.items():
                launches[name][d] = launches[name].get(d, 0) + n

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(GOLDEN_HEADS) as f:
        g = {k: f[k] for k in f.files}
    kernels.reset_launch_counts()
    rec["golden"] = heads_check(g, heads_port_outputs("cuda", WIDE_HEADS),
                                WIDE_HEADS)
    add(kernels.launch_counts_by_head_dim())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    log("wide golden " + json.dumps(rec["golden"]))

    # (a) Phi-3-mini over HTTP from a replica while an engine of the same
    # seed is built in this process for (c) (each draws 3.8 B weights on
    # the host, so the two overlap) and decodes the same prompt
    t0 = time.perf_counter()
    prompt = np.random.RandomState(16).randint(
        0, PHI3_MINI["vocab_size"], 128).tolist()
    local: dict = {}

    def in_process():
        try:
            eng = ContinuousEngine(LLMConfig(**PHI3_MINI), max_batch=1,
                                   decode_chunk=4, device="cuda")
            try:
                kernels.reset_launch_counts()
                local["tokens"] = eng.submit(prompt, SamplingParams(
                    temperature=0.0,
                    max_tokens=WIDE_DECODE_STEPS + 1)).tokens()
                local["model"] = eng.model  # kept for (c)
            finally:
                eng.shutdown()
        except BaseException as e:  # re-raised below, in this thread
            local["error"] = e

    worker = threading.Thread(target=in_process)
    worker.start()
    try:
        phi3, (lone_prompt, toks), by_d = _wide_phi3_http()
        worker.join()
        if "error" in local:
            raise local["error"]
        if lone_prompt != prompt:
            raise AssertionError("(a) and (c) took different prompts")
        # (c) on the replica's own tokens, and on the in-process engine's
        # (a cache of 1 slot) where they first depart from the replica's
        phi3["logits"] = _wide_logits(local["model"], prompt, toks,
                                      other=local["tokens"])
        add(kernels.launch_counts_by_head_dim())
    finally:
        worker.join()
        local.clear()
    torch.cuda.empty_cache()
    add(by_d)
    phi3["phase_s"] = time.perf_counter() - t0
    log("wide serve " + json.dumps(phi3))
    rec["phi3_mini"] = phi3

    # (b) Gemma-2B's width in process, then (c) on the server's own model
    t0 = time.perf_counter()
    server = OpenAIServer(LLMConfig(**GEMMA_2B), max_batch=8, decode_chunk=16,
                          default_max_tokens=64, device="cuda")
    try:
        eng = server.engine
        kernels.reset_launch_counts()
        gemma, (prompt, toks) = _wide_serve(
            "Gemma-2B", GEMMA_2B,
            lambda body: server(_Request("/v1/completions", body)),
            lambda: (eng.decode_steps,
                     kernels.launch_counts()["decode_attention"]))
        gemma["logits"] = _wide_logits(eng.model, prompt, toks)
        add(kernels.launch_counts_by_head_dim())
    finally:
        server.shutdown()
    del server, eng
    torch.cuda.empty_cache()
    gemma["phase_s"] = time.perf_counter() - t0
    log("wide serve " + json.dumps(gemma))
    rec["gemma_2b"] = gemma

    # (d) training at both widths
    for name, widths, kv in (("Phi-3-mini", PHI3_MINI, PHI3_MINI["n_heads"]),
                             ("Gemma-2B", GEMMA_2B, 1)):
        train = _wide_train(name, widths, kv, kernels)
        add(train["launches"])
        rec[f"train_{name}"] = train

    rec["launches"] = launches
    missing = [(name, d) for name in launches for d in (8, 80, 96, 256)
               if launches[name].get(d, 0) == 0]
    if missing:
        raise AssertionError(f"never launched on phase 16's paths: {missing}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16 (the other head widths): {rec['phase_s']:.1f} s, "
        f"launches by head dim {json.dumps(launches)}")
    return rec


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
    bodies = _serve_mix(prompt)
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


def _serve_mix(prompt) -> list[dict]:
    """Phase 4's concurrent completions that join a running batch, greedy
    and sampled, their prompts drawn by `prompt(n)`."""
    bodies = []
    for i, n in enumerate((64, 128, 256, 64, 128, 256)):
        body = {"prompt": prompt(n), "max_tokens": 96 + 16 * i,
                "temperature": 0.0 if i % 2 == 0 else 0.8}
        if i % 2:
            body.update(top_p=0.9, top_k=50, seed=i)
        bodies.append(body)
    return bodies


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
           "norm_launches": counts["rms_norm"],
           "norm_bwd_launches": counts["rms_norm_bwd"],
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
    norms = (2 * n_layers + 1) * TRAIN_STEPS
    if counts["rms_norm"] != norms or counts["rms_norm_bwd"] != norms:
        raise AssertionError(f"RMSNorm kernels not launched once per norm "
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


# ------------------------------------------------------- phases 8 and 9
RUNTIME_TRAIN = dict(steps=12, save_at=5, die_at=7, batch=4)


def _runtime_train_loop(config):
    """Phase 8's train_loop_per_worker: phase 6's model from its seed on
    the card, Adam(lr=1e-3), one batch of the dataset shard per step, the
    loss reported every step, the model and Adam state checkpointed at
    `save_at` through the async engine, and on the first attempt a crash
    (os._exit) after step `die_at` has reported."""
    import statistics
    import time

    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import model_config
    from ray_tpu_torch.models.transformer import Transformer, loss_fn
    from ray_tpu_torch.train import checkpoint as ck

    loop_start = time.time()
    session = train.get_session()
    attempt = session.restart_index
    model = Transformer(model_config(LLMConfig(**config["cfg"])),
                        device="cuda", seed=1)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    extra = {"loop_start_unix": loop_start, "restore_s": None,
             "n_params": sum(p.numel() for p in model.parameters())}
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = ck.restore(ckpt.path, device="cuda")
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])
        torch.cuda.synchronize()
        extra["restore_s"] = time.perf_counter() - t0
        start = state["step"] + 1
    kernels.reset_launch_counts()
    step_ms = []
    batches = train.get_dataset_shard("train").iter_batches(
        batch_size=config["batch"])
    for step, batch in enumerate(batches):
        if step == config["steps"]:
            break
        # The controller re-splits the dataset on a restart, from its
        # first row: skip the batches of the steps already taken, so step
        # k sees the same batch in both attempts.
        if step < start:
            continue
        tokens = torch.from_numpy(batch["data"]).long().cuda()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        end.record()
        metrics = {"step": step, "loss": loss.item(), "attempt": attempt}
        step_ms.append(begin.elapsed_time(end))
        dies = attempt == 0 and step == config["die_at"]
        if dies or step == config["steps"] - 1:
            metrics.update(extra, launches=kernels.launch_counts(),
                           ms_per_step=statistics.median(step_ms),
                           steps_run=len(step_ms), end_unix=time.time())
        if step == config["save_at"]:
            t0, t_unix = time.perf_counter(), time.time()
            train.report(metrics, checkpoint={
                "model": model.state_dict(), "optim": opt.state_dict(),
                "step": step})
            extra.update(save_sync_s=time.perf_counter() - t0,
                         save_start_unix=t_unix)
        else:
            train.report(metrics)
        if dies:
            # Crash only once the controller has this step's report and the
            # checkpoint before it has committed.
            session.flush_checkpoints()
            deadline = time.monotonic() + 120
            while session.reports and time.monotonic() < deadline:
                time.sleep(0.05)
            os._exit(1)


def phase_runtime_train(phase6_loss0: float, phase6_ms: float) -> dict:
    """Phase 8: TorchTrainer on the runtime, one worker holding the card."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch import data
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.train import checkpoint as ck

    cfg = RUNTIME_TRAIN
    vocab = SERVE["vocab_size"]
    first = torch.randint(0, vocab, (4, 1025),
                          generator=torch.Generator().manual_seed(2))
    rest = np.random.RandomState(8).randint(
        0, vocab, (cfg["steps"] * cfg["batch"] - 4, 1025))
    rows = np.concatenate([first.numpy(), rest]).astype(np.int32)
    storage = tempfile.mkdtemp(prefix="rt_train_")
    try:
        t_fit = time.time()
        result = TorchTrainer(
            _runtime_train_loop, train_loop_config={**cfg, "cfg": SERVE},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="phase8", storage_path=storage,
                failure_config=FailureConfig(max_failures=1)),
            datasets={"train": data.from_numpy(rows)}).fit()
        fit_s = time.time() - t_fit
        if result.error is not None:
            raise AssertionError(f"TorchTrainer failed: {result.error}")
        hist = result.metrics_history
        loss = {(m["attempt"], m["step"]): m["loss"] for m in hist}
        ends = {m["attempt"]: m for m in hist if "launches" in m}
        t0 = time.perf_counter()
        state = ck.restore(result.checkpoint.path)
        driver_restore_s = time.perf_counter() - t0
        man = ck.load_manifest(result.checkpoint.path)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    attempts = sorted({a for a, _ in loss})
    steps = {a: sorted(s for b, s in loss if b == a) for a in attempts}
    rel0 = abs(loss[(0, 0)] - phase6_loss0) / abs(phase6_loss0)
    resumed_rel = {s: abs(loss[(1, s)] - loss[(0, s)]) / abs(loss[(0, s)])
                   for s in (6, 7) if (1, s) in loss and (0, s) in loss}
    model_numel = sum(v.size for v in state["model"].values())
    f32_numel = sum(v.size for v in _array_leaves(state)
                    if v.dtype == np.float32)
    save_end = man["created"]
    first_end = ends.get(0, {})
    rec = {"fit_s": fit_s, "attempts": attempts, "steps": steps,
           "losses": {f"{a}/{s}": v for (a, s), v in sorted(loss.items())},
           "step0_loss": loss[(0, 0)], "phase6_step0_loss": phase6_loss0,
           "step0_rel_err": rel0, "resumed_rel_err": resumed_rel,
           "launches": {a: e["launches"] for a, e in ends.items()},
           "steps_run": {a: e["steps_run"] for a, e in ends.items()},
           "ms_per_step": {a: e["ms_per_step"] for a, e in ends.items()},
           "phase6_ms_per_step": phase6_ms,
           "tokens_per_s": {a: cfg["batch"] * 1024 / e["ms_per_step"] * 1e3
                            for a, e in ends.items()},
           "save_sync_s": first_end.get("save_sync_s"),
           "save_total_s": (save_end - first_end["save_start_unix"]
                            if "save_start_unix" in first_end else None),
           "save_bytes": man["bytes"], "checkpoint_step": state["step"],
           "restore_s_in_worker": ends.get(1, {}).get("restore_s"),
           "restore_s_in_driver_numpy": driver_restore_s,
           "worker_start_s": (first_end["loop_start_unix"] - t_fit
                              if first_end else None),
           "restart_start_s": (ends[1]["loop_start_unix"]
                               - first_end["end_unix"]
                               if 1 in ends and first_end else None),
           "n_params": first_end.get("n_params"),
           "checkpoint_model_numel": model_numel,
           "checkpoint_f32_numel": f32_numel}
    log("runtime_train " + json.dumps(rec))
    if attempts != [0, 1]:
        raise AssertionError(f"the group ran attempts {attempts}, not one "
                             f"restart")
    if steps[0] != list(range(cfg["die_at"] + 1)) or \
            steps[1] != list(range(cfg["save_at"] + 1, cfg["steps"])):
        raise AssertionError(f"steps run per attempt: {steps}")
    if not rel0 <= 1e-4:
        raise AssertionError(f"step 0's loss {loss[(0, 0)]} differs from "
                             f"phase 6's {phase6_loss0}")
    if len(resumed_rel) != 2 or not max(resumed_rel.values()) <= 2e-3:
        raise AssertionError(f"resumed losses differ: {resumed_rel}")
    if state["step"] != cfg["save_at"] or \
            model_numel != first_end.get("n_params") or \
            f32_numel < 3 * model_numel:
        raise AssertionError("the final checkpoint does not hold the model "
                             "and Adam state of step "
                             f"{cfg['save_at']}")
    n_layers = SERVE["n_layers"]
    for a, e in ends.items():
        want = n_layers * e["steps_run"]
        got = e["launches"]
        if got["flash_attention"] != want or \
                got["flash_attention_bwd"] != want:
            raise AssertionError(f"attempt {a}: flash kernels launched "
                                 f"{got}, not {want} each")
    if set(ends) != {0, 1}:
        raise AssertionError("an attempt did not report its kernel counts")
    return rec


def _array_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _array_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _array_leaves(v)
    elif isinstance(tree, np.ndarray):
        yield tree


def _counting_predictor():
    """LLMPredictor that adds a column: the decode kernel's launch count in
    the actor's process after the batch."""
    from ray_tpu_torch.llm import LLMPredictor

    class CountingPredictor(LLMPredictor):
        def __call__(self, batch):
            from ray_tpu_torch._private import kernels

            out = super().__call__(batch)
            out["decode_launches"] = np.full(
                len(out["generated"]), kernels.DECODE_ATTENTION.launches)
            return out

    return CountingPredictor


def phase_batch() -> dict:
    """Phase 9: batch_inference through `data`, a map actor on the card."""
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, batch_inference

    g = _golden()
    gcfg = _golden_config(g)
    n_new = g["greedy"].shape[1]
    gcfg.max_new_tokens = n_new
    prompts = [g[f"prompt_{i}"] for i in range(g["greedy"].shape[0])]
    rows = batch_inference(
        data.from_items([{"tokens": p} for p in prompts],
                        parallelism=len(prompts)),
        gcfg, device="cuda").take_all()
    got = {tuple(r["tokens"]): r["generated"][len(r["tokens"]):]
           for r in rows}
    for p, want in zip(prompts, g["greedy"]):
        if not np.array_equal(got.get(tuple(p)), want):
            raise AssertionError(f"batch_inference golden tokens differ for "
                                 f"prompt {p.tolist()}: {got.get(tuple(p))} "
                                 f"vs {want}")
    log(f"batch: golden greedy tokens equal through batch_inference "
        f"({g['greedy'].size} tokens)")

    n_rows, plen, new, per_batch = 8, 128, 32, 4
    cfg = LLMConfig(**SERVE, max_new_tokens=new)
    prompts = np.random.RandomState(9).randint(
        0, SERVE["vocab_size"], (n_rows, plen)).astype(np.int32)
    ds = data.from_items([{"tokens": p} for p in prompts],
                         parallelism=n_rows // per_batch)
    t0 = time.perf_counter()
    # the same map_batches call batch_inference makes, with a predictor
    # that also reads the actor's decode launch count
    out = ds.map_batches(_counting_predictor(), concurrency=1,
                         fn_constructor_args=(cfg,),
                         fn_constructor_kwargs={"device": "cuda"}).take_all()
    wall = time.perf_counter() - t0
    eng = LLMEngine(cfg, device="cuda")
    want = np.concatenate([eng.generate(prompts[i:i + per_batch])
                           for i in range(0, n_rows, per_batch)])
    del eng
    got = {tuple(r["tokens"]): r["generated"] for r in out}
    same = sum(np.array_equal(got.get(tuple(p)), w)
               for p, w in zip(prompts, want))
    launches = max(int(r["decode_launches"]) for r in out)
    rec = {"rows": n_rows, "prompt_len": plen, "new_tokens": new,
           "rows_equal_in_process": same, "wall_s": wall,
           "rows_per_s": n_rows / wall,
           "generated_tokens_per_s": n_rows * new / wall,
           "actor_decode_launches": launches}
    log("batch " + json.dumps(rec))
    if same != n_rows:
        raise AssertionError(f"{n_rows - same} rows of batch inference "
                             f"differ from the in-process LLMEngine")
    want_launches = SERVE["n_layers"] * (new - 1) * (n_rows // per_batch)
    if launches < want_launches:
        raise AssertionError(f"the actor launched the decode kernel "
                             f"{launches} times, fewer than the "
                             f"{want_launches} layer-steps")
    return rec


def phase_runtime(train_rec: dict) -> tuple[dict, dict]:
    """Phases 8 and 9 on one runtime (the node counting 1 GPU), which must
    leave no rt_* segment in /dev/shm."""
    import ray_tpu_torch as rt

    shm_before = _rt_segments()
    rt.init(num_cpus=4)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError("the node does not count 1 GPU")
        t0 = time.perf_counter()
        runtime_train_rec = phase_runtime_train(train_rec["losses"][0],
                                                train_rec["ms_per_step"])
        runtime_train_rec["phase_s"] = time.perf_counter() - t0
        _wait_gpu_free(rt)
        t0 = time.perf_counter()
        batch_rec = phase_batch()
        batch_rec["phase_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = _rt_segments() - shm_before
    if left:
        raise AssertionError(f"shutdown left shm segments {sorted(left)}")
    log(f"runtime phases: train {runtime_train_rec['phase_s']:.1f} s, "
        f"batch {batch_rec['phase_s']:.1f} s")
    return runtime_train_rec, batch_rec


# ------------------------------------------------------ phases 10 and 11
def _stage_rows(stats: dict) -> list[dict]:
    """The pipeline's per-stage rows of a /v1/stats answer."""
    stages = stats.get("pipeline", {}).get("stages", [])
    if stats.get("pipeline_stages") != 2 or len(stages) != 2:
        raise AssertionError(f"/v1/stats names no 2-stage pipeline: {stats}")
    return stages


def _check_stages(stats: dict) -> list[dict]:
    """Raise unless each stage is a process of its own (neither the
    replica nor this one), holds CUDA memory, and launched the decode
    kernel once per layer of each decode invocation it ran."""
    stages = _stage_rows(stats)
    pids = {s["pid"] for s in stages}
    if len(pids) != 2 or stats["pid"] in pids or os.getpid() in pids:
        raise AssertionError(f"stage pids {pids}, replica {stats['pid']}, "
                             f"driver {os.getpid()}")
    for s in stages:
        if not s["device"].startswith("cuda") or s["device_bytes"] <= 0:
            raise AssertionError(f"stage {s['stage']} holds no CUDA memory")
        want = len(s["layers"]) * s["decode_steps"]
        if s["decode_steps"] == 0 or \
                s["kernel_launches"]["decode_attention"] != want:
            raise AssertionError(
                f"stage {s['stage']} launched the decode kernel "
                f"{s['kernel_launches']['decode_attention']} times for "
                f"{s['decode_steps']} invocations of {len(s['layers'])} "
                f"layers")
    return stages


def _first_decode_logits(body: dict) -> dict:
    """The first decode step's logits of `body`'s prompt, in this process:
    the full model at ContinuousEngine's batch (8 rows) against the two
    stage nets at the pipeline's microbatch (2 rows), row 0 holding the
    request in both. Held at phase 5's bf16 tolerance."""
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import (make_stage_net, model_config,
                                          stage_layer_split,
                                          stage_param_slice)
    from ray_tpu_torch.models.transformer import Transformer

    mcfg = model_config(LLMConfig(**SERVE))
    model = Transformer(mcfg, device="cuda", seed=SERVE["seed"])
    sd = model.state_dict()
    nets = []
    for s, layers in enumerate(stage_layer_split(SERVE["n_layers"], 2)):
        net = make_stage_net(mcfg, layers, s == 0, s == 1, device="cuda")
        net.load_state_dict(stage_param_slice(sd, layers, s == 0, s == 1))
        nets.append(net.to(torch.bfloat16).eval())
    model.to(torch.bfloat16).eval()
    prompt = torch.tensor(body["prompt"], device="cuda")[None]
    plen = prompt.shape[1]
    with torch.no_grad():
        # one prefill at batch 1, placed into row 0 of both batches' caches
        prefilled = model.new_cache(1, plen)
        first = int(model(prompt, torch.arange(plen, device="cuda")[None],
                          cache=prefilled)[0, -1].argmax())

        def decode_row0(rows, run):
            cache = model.new_cache(rows)
            for (big_k, big_v), (k, v) in zip(cache, prefilled):
                big_k[0, :plen].copy_(k[0])
                big_v[0, :plen].copy_(v[0])
            toks = torch.zeros((rows, 1), dtype=torch.long, device="cuda")
            toks[0, 0] = first
            pos = torch.zeros((rows, 1), dtype=torch.long, device="cuda")
            pos[0, 0] = plen
            return run(toks, pos, cache)[0, -1]

        def run_stages(toks, pos, cache):
            n0 = len(nets[0].layers)
            x = nets[0](toks, pos, cache=cache[:n0])
            return nets[1](x, pos, cache=cache[n0:])

        single = decode_row0(8, lambda t, p, c: model(t, p, cache=c))
        staged = decode_row0(2, run_stages)
    err = float((single - staged).abs().max())
    scale = float(single.abs().max())
    return {"max_abs_err": err, "max_abs_logit": scale,
            "argmax_equal": int(single.argmax()) == int(staged.argmax()),
            "within_tol": err <= 0.05 * max(1.0, scale)}


def _stage_step_times(reps: int = 20) -> dict:
    """Each stage's own cost per decode invocation, in this process: the
    two `PipelineStage`s of phase 10's engine (the same shards, 2-row
    microbatches) stepped directly, without the DAG. Host ms per step()
    (median; the last stage's ends in its token copy to the host), and
    device ms and kernels per step from torch.profiler over `reps` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import (model_config, stage_layer_split,
                                          stage_param_slice)
    from ray_tpu_torch.llm.pipeline import PipelineStage
    from ray_tpu_torch.models.transformer import Transformer

    cfg = LLMConfig(**SERVE)
    state = Transformer(model_config(cfg), device="cpu",
                        seed=cfg.seed).state_dict()
    splits = stage_layer_split(SERVE["n_layers"], 2)
    stages = [PipelineStage(
        cfg, s, 2, layers, s == 0, s == 1,
        {k: v.numpy() for k, v in stage_param_slice(
            state, layers, s == 0, s == 1).items()}, 2, 4, device="cuda")
        for s, layers in enumerate(splits)]
    del state
    toks = np.array([17, 42], np.int64)
    lens = np.array([200, 150], np.int64)

    def run(s):
        out = stages[0].step(("d", 0, toks, lens, True))
        return out if s == 0 else stages[1].step(out)

    mid = run(0)
    rec = {}
    for s, stage in enumerate(stages):
        msg = ("d", 0, toks, lens, True) if s == 0 else mid
        for _ in range(3):
            stage.step(msg)
        torch.cuda.synchronize()
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            stage.step(msg)
            host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                stage.step(msg)
            torch.cuda.synchronize()
        by_name, n_kernels = _kernel_times_us(prof)
        rec[stage.name] = {"host_ms": statistics.median(host),
                           "device_ms": sum(by_name.values()) / reps / 1e3,
                           "kernels": n_kernels / reps}
    del stages, mid
    torch.cuda.empty_cache()
    return rec


def phase_pipeline(lone) -> dict:
    """Phase 10: pipelined serving over HTTP, two stage actors on the
    card."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import build_openai_app

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    g = _golden()
    t0 = time.perf_counter()
    serve.run(build_openai_app(_golden_config(g), name="golden", max_batch=2,
                               pipeline_stages=2), port=port)
    golden_deploy_s = time.perf_counter() - t0
    greedy = [_http(f"{base}/v1/completions", {
        "prompt": g[f"prompt_{i}"].tolist(), "temperature": 0.0,
        "max_tokens": g["greedy"].shape[1]})["token_ids"]
        for i in range(g["greedy"].shape[0])]
    if not np.array_equal(np.asarray(greedy), g["greedy"]):
        raise AssertionError(f"golden greedy tokens over the pipeline "
                             f"differ:\n{greedy}\n{g['greedy']}")
    stages = _check_stages(_http(f"{base}/v1/stats"))
    log(f"pipeline: golden greedy tokens equal over HTTP through 2 stages "
        f"({np.asarray(greedy).size} tokens); stages "
        + json.dumps([{k: s[k] for k in ("stage", "pid", "device_bytes",
                                         "decode_steps", "kernel_launches")}
                      for s in stages]))
    serve.delete("golden")

    t0 = time.perf_counter()
    serve.run(build_openai_app(LLMConfig(**SERVE), max_batch=8,
                               default_max_tokens=64, pipeline_stages=2),
              port=port)
    deploy_s = time.perf_counter() - t0
    body, want = lone
    got = _http(f"{base}/v1/completions", body)["token_ids"]
    lone_rec = {"equal": got == want}
    if got != want:
        first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        lone_rec.update(first_differing_position=first,
                        **_first_decode_logits(body))
        log(f"pipeline: the lone greedy answer differs from phase 4's at "
            f"position {first}: {json.dumps(lone_rec)}")
        if not lone_rec["within_tol"]:
            raise AssertionError("the first decode step's logits of the "
                                 "pipeline differ from the single engine's "
                                 "beyond the bf16 tolerance")
    rng = np.random.RandomState(7)

    def stream():
        t_s = time.perf_counter()
        events, arrival = _http_stream(f"{base}/v1/completions", {
            "prompt": rng.randint(0, SERVE["vocab_size"], 128).tolist(),
            "temperature": 0.0, "max_tokens": 64, "stream": True})
        return t_s, events, arrival

    stream()  # the first pays the proxy's stream set-up
    t_s, events, arrival = stream()
    with_tokens = [(e, t) for e, t in zip(events, arrival)
                   if e and e["token_ids"]]
    streamed = [t for e, _ in with_tokens for t in e["token_ids"]]
    if events[-1] is not None or len(streamed) != 64:
        raise AssertionError(f"the stream gave {len(streamed)} tokens")
    ttft = with_tokens[0][1] - t_s
    chat = _http(f"{base}/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello there"}],
        "temperature": 0.0, "max_tokens": 32})
    if chat["object"] != "chat.completion" or len(chat["token_ids"]) != 32:
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

    before = _http(f"{base}/v1/stats")  # after warm-up
    t0 = time.perf_counter()
    threads = []
    for i in range(len(bodies)):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        time.sleep(0.05)  # staggered, as in phase 4
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    after = _http(f"{base}/v1/stats")
    n_tokens = 0
    for b, out in zip(bodies, results):
        if out is None or len(out["token_ids"]) != b["max_tokens"]:
            raise AssertionError("a concurrent completion over the pipeline "
                                 "did not finish")
        n_tokens += len(out["token_ids"])
    stages = _check_stages(after)
    invocations = after["decode_steps"] - before["decode_steps"]
    rpcs = (after["pipeline"]["resolve_rpcs"]
            - before["pipeline"]["resolve_rpcs"])
    pins = after["pipeline"]["edge_pins"] - before["pipeline"]["edge_pins"]
    busy = {s1["stage"]: (s1["busy_s"] - s0["busy_s"]) / wall
            for s0, s1 in zip(_stage_rows(before), stages)}
    rec = {"deploy_s": deploy_s, "golden_deploy_s": golden_deploy_s,
           "lone_greedy": lone_rec, "concurrent_requests": len(bodies),
           "generated_tokens": n_tokens, "wall_s": wall,
           "tokens_per_s": n_tokens / wall,
           "decode_invocations": invocations,
           "ms_per_decode_invocation_wall": 1e3 * wall / max(invocations, 1),
           "stream_ttft_ms": 1e3 * ttft, "stage_busy_share": busy,
           "edge_pins": pins, "resolve_rpcs": rpcs,
           "stage_decode_launches": {
               s["stage"]: s["kernel_launches"]["decode_attention"]
               for s in stages},
           "stage_decode_steps": {s["stage"]: s["decode_steps"]
                                  for s in stages},
           "stage_device_bytes": {s["stage"]: s["device_bytes"]
                                  for s in stages},
           "pipeline_launches": sum(s["kernel_launches"]["decode_attention"]
                                    for s in stages),
           "stage_step_in_process": _stage_step_times()}
    log("pipeline " + json.dumps(rec))
    if rpcs != 0 or pins == 0:
        raise AssertionError(f"steady-state decode took {rpcs} resolve RPCs "
                             f"({pins} edge pins)")
    serve.shutdown()
    return rec


TUNE = dict(n_layers=2, batch=4, steps=3, lrs=(1e-3, 3e-4))


def _tune_train_loop(config):
    """Phase 11's train_loop_per_worker: phase 6's widths cut to 2 layers
    on the card, Adam at the trial's learning rate, one fixed batch
    [4, 1025], the loss reported every step and this worker's kernel
    launch counts with the last."""
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import model_config
    from ray_tpu_torch.models.transformer import Transformer, loss_fn

    cfg = {**config["cfg"], "n_layers": config["n_layers"]}
    model = Transformer(model_config(LLMConfig(**cfg)), device="cuda", seed=1)
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"])
    tokens = torch.randint(0, cfg["vocab_size"], (config["batch"], 1025),
                           generator=torch.Generator().manual_seed(2)).cuda()
    kernels.reset_launch_counts()
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        metrics = {"step": step, "loss": loss.item(), "lr": config["lr"]}
        if step == config["steps"] - 1:
            torch.cuda.synchronize()
            metrics["launches"] = kernels.launch_counts()
        train.report(metrics)


def phase_tune() -> dict:
    """Phase 11: Tuner over TorchTrainer, 2 trials on the one card."""
    import math
    import shutil
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    storage = tempfile.mkdtemp(prefix="rt_tune_")
    try:
        trainer = TorchTrainer(
            _tune_train_loop,
            train_loop_config={**{k: v for k, v in TUNE.items()
                                  if k != "lrs"}, "cfg": SERVE},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=storage))
        t0 = time.perf_counter()
        grid = tune.Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(TUNE["lrs"]))}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=RunConfig(storage_path=storage, name="phase11")).fit()
        fit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    trials = [{"lr": r.config["train_loop_config"]["lr"],
               "error": r.error, "metrics": r.metrics} for r in grid]
    log("tune " + json.dumps({"fit_s": fit_s, "trials": trials}))
    if len(grid) != 2 or grid.num_errors:
        raise AssertionError(f"tune ran {len(grid)} trials, "
                             f"{grid.num_errors} failed")
    want = TUNE["n_layers"] * TUNE["steps"]
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    for t in trials:
        m = t["metrics"]
        if not math.isfinite(m["loss"]) or m["step"] != TUNE["steps"] - 1:
            raise AssertionError(f"trial lr={t['lr']} ended with {m}")
        for name in launches:
            if m["launches"][name] != want:
                raise AssertionError(f"trial lr={t['lr']} launched {name} "
                                     f"{m['launches'][name]} times, not "
                                     f"{want}")
            launches[name] += m["launches"][name]
    best = grid.get_best_result()
    lowest = min(trials, key=lambda t: t["metrics"]["loss"])
    if best.config["train_loop_config"]["lr"] != lowest["lr"]:
        raise AssertionError("get_best_result is not the trial with the "
                             "lower last loss")
    return {"fit_s": fit_s, "best_lr": lowest["lr"],
            "last_loss": {str(t["lr"]): t["metrics"]["loss"] for t in trials},
            "tune_launches": launches}


def phase_pipeline_and_tune(lone, phase6_loss0) -> tuple[dict, dict, dict]:
    """Phases 10, 11 and 12 (c) on one runtime (the node counting 1 GPU),
    which must leave no rt_* or rtch_torch_* segment in /dev/shm."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    shm_before = _rt_segments()
    rt.init(num_cpus=4)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError("the node does not count 1 GPU")
        t0 = time.perf_counter()
        try:
            pipe_rec = phase_pipeline(lone)
        finally:
            serve.shutdown()
        pipe_rec["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tune_rec = phase_tune()
        tune_rec["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_train_rec = phase_tp_train(phase6_loss0)
        tp_train_rec["phase_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = _rt_segments() - shm_before
    if left:
        raise AssertionError(f"shutdown left shm segments {sorted(left)}")
    log(f"pipeline, tune and tp=2 train phases: {pipe_rec['phase_s']:.1f} s, "
        f"{tune_rec['phase_s']:.1f} s and {tp_train_rec['phase_s']:.1f} s")
    return pipe_rec, tune_rec, tp_train_rec


# ------------------------------------------------------------- phase 12
#: Phase 12's rank processes share the one card; their collectives go
#: through pinned host memory (gloo). Nothing in phase 12 measures
#: multi-GPU scaling.
TP = 2
#: phase 12 (d): ring and Ulysses attention over sp=2
SP_SHAPE = (4, 1024, 16, 64)
TP_TRAIN_STEPS = 3
# Phase 12 (c): the tp=2 step's loss against phase 6's unsharded step-0
# loss on the same model and batch. Both compute in bf16; under tp each
# row-parallel product is two bf16 partial sums added after rounding, so
# the residual stream differs from the unsharded one by bf16 rounding. On
# an NVIDIA H100 80GB HBM3 (700 W) it read 2.1e-5 relative; held to 1e-3.
# At initialisation the loss sits near ln(32000) whatever the logits, so
# this bound alone catches little: the step's gradients carry the check,
# each rank's box of every gradient against the unsharded model's on the
# same batch, as a relative norm, within phase 6's TRAIN_GRAD_REL_TOL (a
# dropped psum or a misrouted shard is off by tens of percent or more).
TP_LOSS_REL_TOL = 1e-3
# Phase 12 (b): the sharded serving model's logits against the unsharded
# model's at every teacher-forced step, relative to max(1, the largest
# |logit|). In bf16 phase 5's tolerance; in f32 (tf32 off, where every
# kernel computes in f32) the two differ only in the order of the tp
# partial sums, some 1e-6 of the logits, and a cache row written at the
# wrong position or head is off by the logits' own size.
TP_BF16_LOGIT_TOL = 0.05
TP_F32_LOGIT_TOL = 1e-3


def _teacher_forced_logits(model, prompt, tokens):
    """f32 logits [len(tokens), vocab]: row i is the model's prediction of
    tokens[i] after the prompt and tokens[:i]. The prompt is prefilled into
    a slot cache and each token then fed as one cached decode step, the
    engine's paths; the tokens are given, not each model's own argmax, so
    two models that round a near-tie apart still decode the same input."""
    import torch

    cache = model.new_cache(1)
    n = len(prompt)
    with torch.no_grad():
        rows = [model(torch.tensor([prompt], device="cuda"),
                      positions=torch.arange(n, device="cuda")[None],
                      cache=cache)[0, -1]]
        for i, t in enumerate(tokens[:-1]):
            rows.append(model(torch.tensor([[t]], device="cuda"),
                              positions=torch.tensor([[n + i]], device="cuda"),
                              cache=cache)[0, -1])
    return torch.stack(rows).float()


def _logit_errors(got, want, tol: float) -> dict:
    """Row by row max |got - want| against tol * max(1, largest |want|):
    the prefill row's, the first decode step's and the worst step's."""
    err = (got - want).abs().amax(dim=1)
    allowed = tol * want.abs().amax(dim=1).clamp(min=1.0)
    ratio = err / allowed
    worst = int(ratio.argmax())
    return {"steps": int(err.numel()), "tol": tol,
            "prefill_max_abs_err": float(err[0]),
            "first_step_max_abs_err": float(err[1]),
            "worst_step": worst, "worst_max_abs_err": float(err[worst]),
            "worst_max_abs_logit": float(want[worst].abs().max()),
            "worst_share_of_tol": float(ratio[worst]),
            "argmax_equal_steps": int((got.argmax(1) == want.argmax(1)).sum())}


def _greedy_gaps(model, prompt, toks):
    """For each token an engine chose greedily after the prompt and the
    tokens before it: (the largest logit less the chosen token's, the
    largest |logit|), from `model`'s one forward over that sequence."""
    import torch

    seq = torch.tensor([list(prompt) + list(toks[:-1])], device="cuda")
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:]
    chosen = logits.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
    return logits.amax(dim=1) - chosen, logits.abs().amax(dim=1)


def _tp_rank(rank: int, lone, bodies) -> dict:
    """Phase 12 (a), (b) and (d) on one of TP rank processes sharing the
    card: each holds its shards and runs the port's kernels at its
    per-rank shapes."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import (ContinuousEngine, SamplingParams,
                                          model_config)
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.ops.flash_attention import flash_attention_cuda
    from ray_tpu_torch.parallel.collectives import all_gather_invariant
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(dp=-1, tp=TP))
    out = {"rank": rank, "transport": mesh.backend}

    # (a) golden parity: the float32 golden model over tp=2
    g = _golden()
    eng = ContinuousEngine(_golden_config(g), max_batch=2, decode_chunk=4,
                           mesh=mesh, device="cuda")
    if rank == 0:
        try:
            streams = [eng.submit(g[f"prompt_{i}"].tolist(), SamplingParams(
                temperature=0.0, max_tokens=g["greedy"].shape[1]))
                for i in range(g["greedy"].shape[0])]
            greedy = np.asarray([st.tokens() for st in streams])
        finally:
            eng.shutdown()
        if not np.array_equal(greedy, g["greedy"]):
            raise AssertionError(f"tp={TP} golden greedy tokens differ from "
                                 f"the JAX package's:\n{greedy}\n"
                                 f"{g['greedy']}")
        out["golden_tokens_equal"] = int(greedy.size)
    else:
        eng.follow()

    # (b) full-width serving. First the sharded model against the unsharded
    # one on phase 4's lone prompt and tokens, teacher-forced through the
    # slot cache at every step, in f32 (tf32 off) and in bf16; then the
    # engine.
    cfg = LLMConfig(**SERVE)
    body, phase4_tokens = lone
    out["teacher_forced"] = {}
    full = None
    for dtype, tol in (("float32", TP_F32_LOGIT_TOL),
                       ("bfloat16", TP_BF16_LOGIT_TOL)):
        mcfg = model_config(LLMConfig(**{**SERVE, "dtype": dtype}))
        sharded = Transformer(mcfg, device="cuda", seed=cfg.seed, mesh=mesh)
        logits = _teacher_forced_logits(sharded.to(mcfg.dtype).eval(),
                                        body["prompt"], phase4_tokens)
        del sharded
        if rank != 0:
            continue
        full = Transformer(mcfg, device="cuda", seed=cfg.seed)
        full = full.to(mcfg.dtype).eval()
        errs = _logit_errors(logits, _teacher_forced_logits(
            full, body["prompt"], phase4_tokens), tol)
        out["teacher_forced"][dtype] = errs
        if errs["worst_share_of_tol"] > 1.0:
            raise AssertionError(
                f"tp={TP} {dtype} logits at teacher-forced step "
                f"{errs['worst_step']} differ from the unsharded model's by "
                f"{errs['worst_max_abs_err']} (largest logit "
                f"{errs['worst_max_abs_logit']}, tolerance {tol} of it)")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    stats0 = dict(mesh.stats)
    t_life = time.perf_counter()
    eng = ContinuousEngine(cfg, max_batch=8, decode_chunk=16, mesh=mesh,
                           device="cuda")
    if rank == 0:
        try:
            vocab = cfg.vocab_size
            eng.submit(body["prompt"][:16], SamplingParams(
                temperature=0.0, max_tokens=4)).tokens()  # warm-up
            got = eng.submit(body["prompt"], SamplingParams(
                temperature=0.0, max_tokens=body["max_tokens"])).tokens()
            same = next((i for i, (a, b) in enumerate(zip(got, phase4_tokens))
                         if a != b), len(got))
            out["lone"] = {"tokens": len(got), "equal_prefix": same,
                           "all_equal": got == phase4_tokens}
            steps0, mix0 = eng.decode_steps, dict(mesh.stats)
            results = [None] * len(bodies)

            def worker(i):
                b = bodies[i]
                results[i] = eng.submit(b["prompt"], SamplingParams(
                    temperature=b["temperature"], max_tokens=b["max_tokens"],
                    top_p=b.get("top_p", 1.0), top_k=b.get("top_k", 0),
                    seed=b.get("seed", 0))).tokens()

            threads = []
            t0 = time.perf_counter()
            for i in range(len(bodies)):
                threads.append(threading.Thread(target=worker, args=(i,)))
                threads[-1].start()
                time.sleep(0.05)  # staggered, as in phase 4
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            steps = eng.decode_steps - steps0
            for b, toks in zip(bodies, results):
                if toks is None or len(toks) != b["max_tokens"] or \
                        not all(0 <= t < vocab for t in toks):
                    raise AssertionError(f"tp={TP} completion gave "
                                         f"{None if toks is None else len(toks)}"
                                         f" tokens, not {b['max_tokens']}")
            n_tokens = sum(len(t) for t in results)
            out["mix"] = {
                "requests": len(bodies), "generated_tokens": n_tokens,
                "wall_s": wall, "tokens_per_s": n_tokens / wall,
                "decode_steps": steps,
                "ms_per_decode_step_wall": 1e3 * wall / steps,
                "collective_s": mesh.stats["seconds"] - mix0["seconds"],
                "collective_calls": mesh.stats["calls"] - mix0["calls"],
                "collective_share_of_wall":
                    (mesh.stats["seconds"] - mix0["seconds"]) / wall}
        finally:
            eng.shutdown()
    else:
        eng.follow()
    torch.cuda.synchronize()
    life = time.perf_counter() - t_life
    out["engine"] = {
        "decode_steps": eng.decode_steps,
        "decode_launches": kernels.launch_counts()["decode_attention"],
        "collective_s": mesh.stats["seconds"] - stats0["seconds"],
        "collective_calls": mesh.stats["calls"] - stats0["calls"],
        "collective_mb": (mesh.stats["bytes"] - stats0["bytes"]) / 1e6,
        "lifetime_s": life,
        "collective_share_of_lifetime":
            (mesh.stats["seconds"] - stats0["seconds"]) / life}
    del eng
    if rank == 0:
        # Every token the engine chose greedily, the lone prompt's and the
        # mix's greedy requests' (several slots live), must be a near-argmax
        # of the unsharded bf16 model on the same prefix. A token the sharded
        # logits rank first is at most twice the logit tolerance below the
        # unsharded maximum.
        greedy = [(body["prompt"], got)] + [
            (b["prompt"], t) for b, t in zip(bodies, results)
            if b["temperature"] == 0.0]
        gaps, scales = zip(*(_greedy_gaps(full, p, t) for p, t in greedy))
        gap, scale = torch.cat(gaps), torch.cat(scales)
        ratio = gap / (2 * TP_BF16_LOGIT_TOL * scale.clamp(min=1.0))
        out["greedy_check"] = {
            "requests": len(greedy), "tokens": int(gap.numel()),
            "unsharded_argmax": int((gap == 0).sum()),
            "worst_gap": float(gap.max()),
            "worst_share_of_tol": float(ratio.max())}
        if float(ratio.max()) > 1.0:
            raise AssertionError(
                f"tp={TP} engine chose a greedy token {float(gap.max())} "
                f"below the unsharded model's largest logit: "
                f"{out['greedy_check']}")
    del full
    torch.cuda.empty_cache()

    # (d) ring and Ulysses attention over sp=2 against the flash kernel's
    # full-sequence output
    sp = build_mesh(MeshConfig(dp=-1, sp=TP))
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(*SP_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    blocks = [t.chunk(TP, dim=1)[rank].contiguous() for t in (q, k, v)]
    rec = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        kernels.reset_launch_counts()
        times = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = fn(*blocks, axis_name="sp", mesh=sp, causal=True)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            whole = all_gather_invariant(o, "sp", sp, dim=1)
        rec[name] = {"ms_host_median_of_3": statistics.median(times),
                     "flash_launches": kernels.launch_counts()[
                         "flash_attention"]}
        if rank == 0:
            ref = flash_attention_cuda(q, k, v, True)
            torch.cuda.synchronize()
            rec[name]["max_abs_err"] = _max_err(whole, ref, "bfloat16")
    out["sequence_parallel"] = rec
    return out


def _tp_train_loop(config):
    """Phase 12 (c)'s train_loop_per_worker (2 workers sharing the card,
    torch_distributed=True): phase 6's model and batch, sharded over a tp
    mesh of the workers' process group; the first step's gradient boxes
    against the unsharded model's, then TP_TRAIN_STEPS timed Adam steps."""
    import statistics
    import time

    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.engine import model_config
    from ray_tpu_torch.models.transformer import (Transformer, loss_fn,
                                                  param_specs)
    from ray_tpu_torch.train.torch_utils import global_mesh_from_distributed

    mesh = global_mesh_from_distributed(("tp",))
    cfg = model_config(LLMConfig(**config["cfg"]))
    tokens = torch.randint(0, cfg.vocab_size, (4, 1025),
                           generator=torch.Generator().manual_seed(2)).cuda()
    ref = Transformer(cfg, device="cuda", seed=1)
    loss_fn(ref, tokens).backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref
    model = Transformer(cfg, device="cuda", seed=1, mesh=mesh)
    specs = param_specs(ref_grads)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    kernels.reset_launch_counts()
    stats0 = dict(mesh.stats)
    losses, ms, rel = [], [], {}
    for step in range(config["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if step == 0:
            counts0 = kernels.launch_counts()
            for n, p in model.named_parameters():
                box = mesh.local_box(ref_grads[n].shape, specs[n])
                r = ref_grads[n][tuple(slice(a, b) for a, b in box)]
                rel[n] = float((p.grad - r).norm() / r.norm())
    worst = max(rel, key=rel.get)
    train.report({
        "tp": mesh.index("tp"), "backend": mesh.backend, "losses": losses,
        "ms_per_step": ms, "first_step_launches": counts0,
        "launches": kernels.launch_counts(),
        "collective_s": mesh.stats["seconds"] - stats0["seconds"],
        "collective_mb": (mesh.stats["bytes"] - stats0["bytes"]) / 1e6,
        "worst_grad_rel_err": [worst, rel[worst]],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_tp_train(phase6_loss0: float) -> dict:
    """Phase 12 (c): one tp=2 step through TorchTrainer, 2 workers with
    half the card each (the node counts 1 GPU)."""
    import shutil
    import tempfile

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    storage = tempfile.mkdtemp(prefix="rt_tp_train_")
    try:
        t0 = time.perf_counter()
        result = TorchTrainer(
            _tp_train_loop,
            train_loop_config={"cfg": SERVE, "steps": TP_TRAIN_STEPS},
            scaling_config=ScalingConfig(
                num_workers=TP, use_gpu=True, torch_distributed=True,
                resources_per_worker={"CPU": 1, "GPU": 1 / TP}),
            run_config=RunConfig(name="phase12", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    if result.error is not None:
        raise AssertionError(f"tp=2 TorchTrainer failed: {result.error}")
    reps = sorted(result.metrics_history, key=lambda m: m["tp"])
    loss0 = reps[0]["losses"][0]
    rel0 = abs(loss0 - phase6_loss0) / abs(phase6_loss0)
    rec = {"fit_s": fit_s, "step0_loss": loss0,
           "phase6_step0_loss": phase6_loss0, "step0_rel_err": rel0,
           "tol": TP_LOSS_REL_TOL, "ranks": reps}
    log("tp_train " + json.dumps(rec))
    n_layers = SERVE["n_layers"]
    if [m["tp"] for m in reps] != list(range(TP)) or \
            {m["backend"] for m in reps} != {"gloo"}:
        raise AssertionError(f"the workers' meshes: {reps}")
    if len({tuple(m["losses"]) for m in reps}) != 1 or \
            not all(np.isfinite(reps[0]["losses"])):
        raise AssertionError("the ranks' losses differ or are not finite")
    if not rel0 <= TP_LOSS_REL_TOL:
        raise AssertionError(f"tp=2 step-0 loss {loss0} differs from phase "
                             f"6's {phase6_loss0} by {rel0} relative")
    for m in reps:
        if not m["worst_grad_rel_err"][1] <= TRAIN_GRAD_REL_TOL:
            raise AssertionError(f"rank {m['tp']}: gradient of "
                                 f"{m['worst_grad_rel_err']} differs from "
                                 f"the unsharded step's")
        for name in ("flash_attention", "flash_attention_bwd"):
            if m["first_step_launches"][name] != n_layers or \
                    m["launches"][name] != n_layers * TP_TRAIN_STEPS:
                raise AssertionError(f"rank {m['tp']}: {name} launched "
                                     f"{m['launches'][name]} times")
    return rec


def phase_tensor_parallel(lone) -> dict:
    """Phase 12 (a), (b), (d), (e) and (f): TP rank processes sharing the
    card for golden parity, full-width tensor-parallel serving and
    sequence-parallel attention; the dryrun configurations on 4 ranks; the
    kernels at their per-rank shapes against their plain versions."""
    import torch

    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.parallel.dryrun import dryrun_ranks, run_ranks

    rng = np.random.RandomState(0)

    def prompt(n):
        return rng.randint(0, SERVE["vocab_size"], n).tolist()

    prompt(16)  # phase 4's warm-up prompt, drawn first there
    bodies = _serve_mix(prompt)
    t0 = time.perf_counter()
    ranks = run_ranks(_tp_rank, TP, lone, bodies)
    ranks_s = time.perf_counter() - t0
    lead = ranks[0]
    rec = {"ranks_s": ranks_s, "transport": lead["transport"],
           "golden_tokens_equal": lead["golden_tokens_equal"],
           "teacher_forced": lead["teacher_forced"],
           "greedy_check": lead["greedy_check"],
           "lone": lead["lone"], "mix": lead["mix"],
           "engine_per_rank": [r["engine"] for r in ranks],
           "sequence_parallel": [r["sequence_parallel"] for r in ranks]}
    log("tensor_parallel " + json.dumps(rec))
    for r in ranks:
        e = r["engine"]
        if e["decode_steps"] == 0 or \
                e["decode_launches"] != SERVE["n_layers"] * e["decode_steps"]:
            raise AssertionError(f"rank {r['rank']}: {e['decode_launches']} "
                                 f"decode launches for {e['decode_steps']} "
                                 f"steps of {SERVE['n_layers']} layers")
        if r["sequence_parallel"]["ulysses"]["flash_launches"] != 3:
            raise AssertionError("Ulysses did not run the flash kernel once "
                                 "per call")
    t0 = time.perf_counter()
    dryrun = dryrun_ranks(4, device="cuda")
    launches = {k.name: {} for k in kernels.HEAD_DIM_KERNELS}
    for r in dryrun:
        for name, by_d in r["launches"].items():
            for d, n in by_d.items():
                launches[name][d] = launches[name].get(d, 0) + n
    rec["dryrun"] = {"labels": [label for label, _ in dryrun[0]["runs"]],
                     "s": time.perf_counter() - t0,
                     "launches_by_head_dim": launches}
    log("dryrun on the card " + json.dumps(rec["dryrun"]))
    # the reference's configurations: heads of 16 in training and generation
    if any(by_d.get(16, 0) == 0 for by_d in launches.values()):
        raise AssertionError(f"the dryrun did not launch every kernel at "
                             f"head dim 16: {launches}")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ragged = [1, 1024, 517, 64, 300, 900, 128, 777]
    rec["kernels"] = {
        "decode": _decode_case(f"tp={TP} per rank B8 Hq8 KV8 D64 S1024 bf16",
                               8, 8, 8, 64, 1024, "bfloat16", ragged, flush,
                               gen),
        "flash": _flash_case(f"tp={TP} and Ulysses sp={TP} per rank B4 S1024 "
                             f"H8 D64 bf16 causal", 4, 1024, 1024, 8, 8, 64,
                             "bfloat16", True, flush, gen),
        "flash_bwd": _flash_bwd_row(f"tp={TP} per rank backward B4 S1024 H8 "
                                    f"D64 bf16 causal", flush, gen)}
    del flush
    return rec


# ------------------------------------------------------------- phase 13
RLLIB_GOLDEN = os.path.join(REPO, "tests", "data",
                            "torch_port_rllib_golden.npz")
#: Phase 13 (a): the port's learners against the JAX package's on the
#: golden file, TF32 off. Losses, their statistics, V-trace's outputs, |td|
#: and every gradient within "value" of the array's largest magnitude.
#: Parameters after an update within "after", absolute: XLA and torch sum
#: in different orders, so two gradients differ in their last bits, and
#: Adam divides each by its own root mean square, which turns a relative
#: 1e-6 into about lr * 1e-6 per step but can move an element whose
#: gradient is near 1e-8 (Adam's eps) by up to lr. On the CPU the port
#: reads PPO 1.6e-7 after its 32 steps (lr 3e-4), IMPALA 6.0e-8 and DQN
#: 1.2e-7 after one step (lr 5e-4 and 1e-3), and at most 2.2e-6 of an
#: array's largest magnitude for the rest; 1e-5 leaves the card room for
#: its own summation order and stays a 30th of the smallest Adam step.
RLLIB_GOLDEN_TOL = {"value": 1e-5, "after": 1e-5}


def _flax_flat(prefix: str, named) -> dict:
    """{"fc0.weight": [out, in], "fc0.bias": ...} (tensors) -> flat flax
    keys {prefix + "fc0/kernel": [in, out], ...} (numpy)."""
    out = {}
    for key, t in named.items():
        name, kind = key.split(".")
        a = t.detach().cpu().numpy()
        out[f"{prefix}{name}/{'kernel' if kind == 'weight' else 'bias'}"] = (
            a.T if kind == "weight" else a)
    return out


def rllib_golden_outputs(g: dict, device) -> dict:
    """The port's PPO, IMPALA and DQN learners on the golden file's
    inputs and starting weights, on `device`, under the file's keys."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.rllib import (DQNLearner, DQNLearnerConfig,
                                     IMPALALearner, IMPALALearnerConfig,
                                     PPOLearner, PPOLearnerConfig, RLModule,
                                     RLModuleSpec)
    from ray_tpu_torch.rllib.learner import batch_to
    from ray_tpu_torch.rllib.rl_module import params_from_flax

    dev = torch.device(device)
    spec = RLModuleSpec(observation_dim=4, action_dim=2)
    init = params_from_flax(_subtree(g, "policy_init/"))

    def batch(prefix):
        return {k[len(prefix):]: v for k, v in g.items()
                if k.startswith(prefix)}

    def grads(prefix, net):
        return _flax_flat(prefix, {k: p.grad
                                   for k, p in net.named_parameters()})

    out = {}
    ppo = PPOLearner(RLModule(spec), PPOLearnerConfig(), device=dev)
    ppo.net.load_state_dict(init)
    b = batch_to(batch("ppo/batch/"), dev)
    loss, aux = ppo._loss({k: v[:128] for k, v in b.items()})
    loss.backward()
    out["ppo/loss"] = loss.item()
    out.update({f"ppo/aux/{k}": v.item() for k, v in aux.items()})
    out.update(grads("ppo/grad/", ppo.net))
    stats = ppo._update(b, torch.from_numpy(g["ppo/perms"]))
    out.update(_flax_flat("ppo/after/", dict(ppo.net.named_parameters())))
    out.update({f"ppo/stats/{k}": v for k, v in stats.items()})

    imp = IMPALALearner(RLModule(spec), IMPALALearnerConfig(), device=dev)
    imp.net.load_state_dict(init)
    b = batch_to(batch("impala/batch/"), dev)
    T, N = b["obs"].shape[:2]
    with torch.no_grad():
        logits, values = imp.net(b["obs"].reshape(T * N, -1))
        logp = F.log_softmax(logits.reshape(T, N, -1), dim=-1).gather(
            -1, b["actions"][..., None])[..., 0]
        _, last_value = imp.net(b["last_obs"])
        vs, pg = imp._vtrace(values.reshape(T, N), last_value, b["rewards"],
                             b["dones"], torch.exp(logp - b["logp_old"]))
    out["impala/vs"], out["impala/pg_adv"] = vs.cpu().numpy(), \
        pg.cpu().numpy()
    loss, _ = imp._loss(b)
    loss.backward()
    out["impala/loss"] = loss.item()
    out.update(grads("impala/grad/", imp.net))
    imp._update(b)
    out.update(_flax_flat("impala/after/", dict(imp.net.named_parameters())))

    dqn = DQNLearner(spec, DQNLearnerConfig(), device=dev)
    sd = params_from_flax(_subtree(g, "dqn/init/"))
    dqn.net.load_state_dict(sd)
    dqn.target_net.load_state_dict(sd)
    raw = batch("dqn/batch/")
    loss, td = dqn._loss(batch_to(raw, dev),
                         torch.as_tensor(g["dqn/weights"], device=dev))
    loss.backward()
    out["dqn/loss"] = loss.item()
    out["dqn/abs_td"] = td.detach().abs().cpu().numpy()
    out.update(grads("dqn/grad/", dqn.net))
    dqn.update(raw, g["dqn/weights"])
    out.update(_flax_flat("dqn/after/", dict(dqn.net.named_parameters())))
    return out


def rllib_golden_check(g: dict, out: dict) -> dict:
    """Each output against the file at RLLIB_GOLDEN_TOL; raises on the
    first algorithm out of tolerance. -> {algo: {"value_rel": worst error
    over the array's largest magnitude, "after_abs": worst absolute error
    of the parameters after the update}}."""
    worst: dict = {}
    for key, val in out.items():
        ref = np.asarray(g[key], np.float64)
        err = float(np.abs(np.asarray(val, np.float64) - ref).max())
        algo = key.split("/")[0]
        w = worst.setdefault(algo, {"value_rel": 0.0, "after_abs": 0.0})
        if "/after/" in key:
            w["after_abs"] = max(w["after_abs"], err)
        else:
            w["value_rel"] = max(w["value_rel"],
                                 err / max(float(np.abs(ref).max()), 1e-30))
    missing = {k for k in g if "/" in k and k.split("/")[1] in (
        "loss", "aux", "grad", "after", "stats", "vs", "pg_adv", "abs_td")
               } - set(out)
    bad = {a: w for a, w in worst.items()
           if not (w["value_rel"] <= RLLIB_GOLDEN_TOL["value"]
                   and w["after_abs"] <= RLLIB_GOLDEN_TOL["after"])}
    if missing or bad:
        raise AssertionError(f"rllib golden: out of tolerance {bad}, "
                             f"missing {sorted(missing)}")
    return worst


#: Phase 13 (b): `_bench_rllib_ppo`'s shape (bench.py:1878-1881) with the
#: default learner, and the bar of the reference's PPO test
#: (tests/test_rllib.py:57-74) over its 25 iterations; env-steps/s over
#: RLLIB_TIMED iterations after the first, as the bench times them.
RLLIB_PPO_RUNNERS = dict(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
RLLIB_PPO_ITERS = 25
RLLIB_TIMED = 5


class _LearnerTimer:
    """Stands in for a learner's `update`: each call's host wall ms (the
    update ends in a host read of its stats, so the card has finished) and
    the span between CUDA events recorded around it on the stream, which
    includes the card's idle gaps. Keeps the last call's arguments for a
    profiled repeat."""

    def __init__(self, learner):
        self._update = learner.update
        self.wall_ms: list = []
        self.event_ms: list = []
        self.last_args = None
        learner.update = self

    def __call__(self, *args):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self._update(*args)
        end.record()
        end.synchronize()
        self.wall_ms.append(1e3 * (time.perf_counter() - t0))
        self.event_ms.append(start.elapsed_time(end))
        self.last_args = args
        return out

    def summary(self, calls=slice(None)) -> dict:
        wall, ev = self.wall_ms[calls], self.event_ms[calls]
        return {"updates": len(wall),
                "learner_wall_ms_median": statistics.median(wall),
                "learner_wall_ms_min_max": [min(wall), max(wall)],
                "learner_event_ms_median": statistics.median(ev)}

    def profile(self) -> dict:
        """One more update on the last call's batch under torch.profiler
        (phase 6's reading): kernels launched, their summed device time
        and that time's share of the update's wall (the card's busy
        share)."""
        return _profile_train_step(lambda: self._update(*self.last_args))


def _finite(rets) -> list:
    return [r for r in rets if r == r]


def _on_card(learner) -> bool:
    """Whether the learner's parameters live on the card."""
    return next(learner.net.parameters()).is_cuda


def _cpu_learner_ms(learner, args, reps: int = 3) -> float:
    """Median wall ms of the same PPO update on this machine's CPU (torch's
    default thread count), from the card learner's weights: a yardstick
    for the card's learner, not a path of the port."""
    from ray_tpu_torch.rllib import PPOLearner

    cpu = PPOLearner(learner.module, learner.cfg, device="cpu")
    cpu.net.load_state_dict(learner.net.state_dict())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cpu.update(*args)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _rllib_ppo(g: dict) -> dict:
    """Phase 13 (b). The learner starts from the golden file's
    `policy_init` (the JAX package's seed-0 weights, where the reference
    test starts: tests/test_torch_rllib.py says why)."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.rl_module import params_from_flax

    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(**RLLIB_PPO_RUNNERS)
            .training(lr=3e-4, minibatch_size=128).build())
    try:
        if not _on_card(algo.learner):
            raise AssertionError(f"PPO learner on {algo.learner.device}")
        algo.learner.net.load_state_dict(
            params_from_flax(_subtree(g, "policy_init/")))
        timer = _LearnerTimer(algo.learner)
        t_first = time.perf_counter()
        first = algo.train()
        first_s = time.perf_counter() - t_first
        returns = [first["episode_return_mean"]]
        steps = 0
        t0 = time.perf_counter()
        for _ in range(RLLIB_TIMED):
            m = algo.train()
            steps += m["num_env_steps_sampled"]
            returns.append(m["episode_return_mean"])
        timed_s = time.perf_counter() - t0
        for _ in range(RLLIB_PPO_ITERS - 1 - RLLIB_TIMED):
            returns.append(algo.train()["episode_return_mean"])
        prof = timer.profile()
        prof["cpu_learner_wall_ms_median"] = _cpu_learner_ms(
            algo.learner, timer.last_args)
    finally:
        algo.stop()
    rec = {"env_steps_per_s": steps / timed_s,
           "timed_iteration_ms": 1e3 * timed_s / RLLIB_TIMED,
           "first_iteration_s": first_s,
           "steps_per_iteration": first["num_env_steps_sampled"],
           "timed": timer.summary(slice(1, 1 + RLLIB_TIMED)),
           "all": timer.summary(), **prof,
           "returns": returns}
    rec["learner_share_of_timed_iteration"] = (
        rec["timed"]["learner_wall_ms_median"] / rec["timed_iteration_ms"])
    log("rllib ppo " + json.dumps(rec))
    log(f"rllib ppo: {rec['env_steps_per_s']:.1f} env-steps/s (CartPole, "
        f"2 runners x 8 envs x 64 steps, learner on the card), learner "
        f"{rec['timed']['learner_wall_ms_median']:.2f} ms per update (wall; "
        f"events {rec['timed']['learner_event_ms_median']:.2f} ms), "
        f"{prof.get('profiled_kernels')} kernels per update")
    if first["num_env_steps_sampled"] != 2 * 8 * 64:
        raise AssertionError(f"PPO sampled {first['num_env_steps_sampled']}")
    if not (max(returns[-5:]) > 2 * returns[0] and max(returns) >= 45):
        raise AssertionError(f"PPO missed the reference bar: {returns}")
    return rec


def _rllib_impala() -> dict:
    """Phase 13 (c): the reference IMPALA test's config and bar
    (tests/test_rllib.py:109-137)."""
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(updates_per_iteration=4).build())
    try:
        timer = _LearnerTimer(algo.learner)
        t0 = time.perf_counter()
        first = algo.train()
        returns = [algo.train()["episode_return_mean"] for _ in range(24)]
        run_s = time.perf_counter() - t0
    finally:
        algo.stop()
    best = max(_finite(returns), default=-1.0)
    rec = {"run_s": run_s, "best_return": best, **timer.summary(),
           "returns": returns}
    log("rllib impala " + json.dumps(rec))
    if first["num_env_steps_sampled"] != 4 * 64 * 8 or not best > 55:
        raise AssertionError(f"IMPALA missed the reference bar: {rec}")
    return rec


def _rllib_dqn() -> dict:
    """Phase 13 (c): the reference DQN test's config and bar
    (tests/test_rllib.py:166-193), its horizon adaptive up to 60."""
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(lr=5e-4, train_batch_size=128, num_learner_updates=24)
            .build())
    try:
        timer = _LearnerTimer(algo.learner)
        returns = []
        t0 = time.perf_counter()
        for _ in range(60):
            m = algo.train()
            returns.append(m["episode_return_mean"])
            if m["episode_return_mean"] >= 60:
                break
        run_s = time.perf_counter() - t0
    finally:
        algo.stop()
    best = max(_finite(returns), default=-1.0)
    rec = {"run_s": run_s, "iterations": len(returns), "best_return": best,
           "num_transitions": m["num_transitions"], "epsilon": m["epsilon"],
           **timer.summary()}
    log("rllib dqn " + json.dumps(rec))
    if not (m["num_transitions"] > 5000 and best >= 60
            and m["epsilon"] < 0.3):
        raise AssertionError(f"DQN missed the reference bar: {rec}")
    return rec


def _rllib_multi_agent() -> dict:
    """Phase 13 (d): multi-agent PPO, 2 iterations, both policies'
    learners on the card (the reference test's config)."""
    import math

    from ray_tpu_torch.rllib import MultiAgentPPOConfig

    algo = (MultiAgentPPOConfig().multi_agent(num_agents=2)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64).build())
    try:
        on_card = [_on_card(lr) for lr in algo.learners.values()]
        t0 = time.perf_counter()
        ms = [algo.train() for _ in range(2)]
        run_s = time.perf_counter() - t0
    finally:
        algo.stop()
    losses = {k: v for k, v in ms[-1].items() if k.startswith("learner/")}
    rec = {"run_s": run_s, "learners_on_card": on_card, "losses": losses,
           "steps": [m["num_env_steps_sampled"] for m in ms]}
    log("rllib multi_agent " + json.dumps(rec))
    if on_card != [True, True] or len(losses) != 2 or not all(
            math.isfinite(v) for v in losses.values()) or \
            rec["steps"] != [2 * 2 * 4 * 64] * 2:
        raise AssertionError(f"multi-agent PPO: {rec}")
    return rec


class _PPOTrainable:
    """Phase 13 (d): the reference's tune case (tests/test_rllib.py:77-106)
    as a class trainable whose learner takes the card."""

    def setup(self, config):
        from ray_tpu_torch.rllib import PPOConfig

        self.algo = (PPOConfig().environment("CartPole-v1")
                     .env_runners(num_env_runners=1,
                                  num_envs_per_env_runner=8,
                                  rollout_fragment_length=32)
                     .training(lr=config["lr"], minibatch_size=64).build())

    def step(self):
        m = self.algo.train()
        m["learner_on_cuda"] = float(_on_card(self.algo.learner))
        return m


def _rllib_tune() -> dict:
    import shutil
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    storage = tempfile.mkdtemp(prefix="rt_rllib_tune_")
    try:
        t0 = time.perf_counter()
        grid = tune.Tuner(
            _PPOTrainable,
            param_space={"lr": tune.grid_search([3e-4, 1e-6])},
            tune_config=tune.TuneConfig(
                metric="episode_return_mean", mode="max",
                resources_per_trial={"CPU": 1, "GPU": 1}),
            run_config=RunConfig(storage_path=storage,
                                 stop={"training_iteration": 8})).fit()
        fit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    trials = [{"lr": r.config["lr"], "error": r.error,
               **{k: (r.metrics or {}).get(k) for k in (
                   "episode_return_mean", "training_iteration",
                   "learner_on_cuda")}} for r in grid]
    rec = {"fit_s": fit_s, "trials": trials,
           "best_lr": grid.get_best_result().config["lr"]}
    log("rllib tune " + json.dumps(rec, default=str))
    if grid.num_errors or len(trials) != 2 or rec["best_lr"] != 3e-4 or \
            any(t["learner_on_cuda"] != 1.0 or t["training_iteration"] != 8
                for t in trials):
        raise AssertionError(f"tune over PPO: {rec}")
    return rec


def phase_rllib() -> dict:
    """Phase 13: rllib with its learners on the card and its env runners
    as CPU actors."""
    import torch

    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(RLLIB_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    rec = {"golden": rllib_golden_check(g, rllib_golden_outputs(g, "cuda"))}
    log("rllib golden (TF32 off) " + json.dumps(rec["golden"]))
    shm_before = _rt_segments()
    rt.init(num_cpus=4)
    try:
        for name, run in (("ppo", lambda: _rllib_ppo(g)),
                          ("impala", _rllib_impala), ("dqn", _rllib_dqn),
                          ("multi_agent", _rllib_multi_agent),
                          ("tune", _rllib_tune)):
            t0 = time.perf_counter()
            rec[name] = run()
            rec[name]["part_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = _rt_segments() - shm_before
    if left:
        raise AssertionError(f"shutdown left shm segments {sorted(left)}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: {rec['phase_s']:.1f} s (" + ", ".join(
        f"{k} {rec[k]['part_s']:.1f} s" for k in
        ("ppo", "impala", "dqn", "multi_agent", "tune")) + ")")
    return rec


# ------------------------------------------------------------- phase 14
# A stream long enough to outlast `top --once` and the 2 s profile window,
# which closes some 5 s after the stream starts (on an NVIDIA H100 80GB
# HBM3, 700.00 W, 700 tokens took 23.9 s at 34 ms per step while
# observed, and the profile CLI 19.9 s, most of it exporting the trace).
OPS_STREAM = dict(prompt_len=64, max_tokens=700)
OPS_PROFILE_S = 2
OPS_PHASE_LIMIT_S = 120
# The autoscaler reaps an idle node within the reference test's 60 s.
OPS_REAP_S = 60
OPS_JOB_SCRIPT = """import sys
sys.path.insert(0, {repo!r})
import chip_smoke
sys.exit(chip_smoke.ops_job(sys.argv[1]))
"""


class _OpsServer:
    """Phase 14's GPU actor: phase 4's serving model behind OpenAIServer,
    on the card of the node it lands on."""

    def __init__(self, widths: dict, device: str):
        from ray_tpu_torch.llm import LLMConfig
        from ray_tpu_torch.llm.openai import OpenAIServer

        self.device = device
        self.server = OpenAIServer(LLMConfig(**widths), max_batch=8,
                                   decode_chunk=16, default_max_tokens=64,
                                   device=device)

    def info(self) -> dict:
        import torch

        return {"worker_id": os.environ["RT_WORKER_ID"],
                "node_id": os.environ["RT_NODE_ID"], "pid": os.getpid(),
                "card": (torch.cuda.get_device_name(0)
                         if self.device == "cuda" else "cpu")}

    def complete(self, body: dict) -> dict:
        """One completion (streamed when the body asks): its tokens, the
        decode steps and decode launches it took, its wall-clock window,
        the trace it ran in and this process's peak CUDA memory."""
        import torch

        from ray_tpu_torch._private import kernels, tracing

        eng = self.server.engine
        kernels.reset_launch_counts()
        steps0 = eng.decode_steps
        t0 = time.time()
        out = self.server(_Request("/v1/completions", body))
        if body.get("stream"):
            toks = [t for chunk in out for t in chunk["token_ids"]]
        else:
            toks = out["token_ids"]
        return {
            "tokens": toks, "decode_steps": eng.decode_steps - steps0,
            "decode_launches": kernels.launch_counts()["decode_attention"],
            "t0": t0, "t1": time.time(),
            "trace_id": tracing.current_trace_id(),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if self.device == "cuda" else 0)}

    def shutdown(self) -> None:
        self.server.shutdown()


def ops_job(config_path: str) -> int:
    """Phase 14 (b)'s job: a driver attached through RT_ADDRESS runs one
    num_gpus=1 `_OpsServer` on the cluster and prints, on a line of its
    own after "OPS_JOB ", the node it ran on, the card's name, the lone
    prompt's greedy tokens and the actor's decode launches and steps."""
    import ray_tpu_torch as rt

    with open(config_path) as f:
        cfg = json.load(f)
    rt.init()
    try:
        server = rt.remote(num_gpus=1)(_OpsServer).remote(cfg["widths"],
                                                          cfg["device"])
        info = rt.get(server.info.remote(), timeout=600)
        rec = rt.get(server.complete.remote(cfg["body"]), timeout=600)
        rt.get(server.shutdown.remote(), timeout=60)
    finally:
        rt.shutdown()
    print("OPS_JOB " + json.dumps({
        "node_id": info["node_id"], "card": info["card"],
        "tokens": rec["tokens"], "decode_steps": rec["decode_steps"],
        "decode_launches": rec["decode_launches"]}), flush=True)
    return 0


def _ops_decode_check(device: str) -> dict:
    """Phase 14 (e)'s num_gpus=1 task: the decode wrapper at phase 2's
    serving shape against its plain version, phase 2's tolerance (on the
    card the wrapper launches the kernel)."""
    import torch

    from ray_tpu_torch._private import kernels
    from ray_tpu_torch.ops.decode_attention import (
        _reference_decode_attention, decode_attention)

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a num_gpus=1 task found no CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    b, hq, kv, d, s = 8, 16, 16, 64, 1024
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    k = torch.randn(b, s, kv, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, s, kv, d, generator=gen, device=device).bfloat16()
    lens = torch.tensor([1, 1024, 517, 64, 300, 900, 128, 777],
                        dtype=torch.int32, device=device)
    kernels.reset_launch_counts()
    out = decode_attention(q, k, v, lens)
    launches = kernels.launch_counts()["decode_attention"]
    err = _max_err(out, _reference_decode_attention(q, k, v, lens),
                   "bfloat16")
    return {"node_id": os.environ["RT_NODE_ID"], "max_abs_err": err,
            "decode_launches": launches,
            "card": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu")}


def _session_pids(session: str) -> list[int]:
    """Live processes of a runtime session: node agents name it on their
    command line, workers and job drivers carry it in RT_SESSION."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
            with open(f"/proc/{pid}/environ", "rb") as f:
                environ = f.read().split(b"\0")
        except OSError:
            continue
        if (session.encode() in cmdline
                or f"RT_SESSION={session}".encode() in environ):
            found.append(int(pid))
    return found


def _session_segments(session: str) -> list[str]:
    """The session's /dev/shm segments (rt_<session[:8]>_*,
    rtch_torch_<session>_*)."""
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith("rt") and session[:8] in f)


def _parse_bytes(text: str) -> tuple[float, float]:
    """A size as `top` prints it (e.g. "786M") -> (bytes, half a display
    unit: the most its rounding can hide)."""
    units = {"B": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    unit = units[text[-1]]
    return float(text[:-1]) * unit, unit / 2


class _OpsCluster:
    """A cluster started through the port's CLI in `session_dir`; `stop()`
    stops it and checks that it left no process, no head.json and no
    /dev/shm segment of its session."""

    def __init__(self, session_dir: str, env: dict):
        self.sdir = session_dir
        self.env = env

    def cli(self, *args, timeout: float = 120) -> str:
        r = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
             "--session-dir", self.sdir, *args],
            capture_output=True, text=True, timeout=timeout, env=self.env)
        if r.returncode != 0:
            raise AssertionError(
                f"ray-tpu-torch {' '.join(args)} exited {r.returncode}:\n"
                f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        return r.stdout

    def start_head(self, num_cpus: int) -> dict:
        self.cli("start", "--head", "--num-cpus", str(num_cpus),
                 "--num-gpus", "0", "--port", "0")
        with open(os.path.join(self.sdir, "head.json")) as f:
            self.head = json.load(f)
        return self.head

    def stop(self) -> float:
        t0 = time.perf_counter()
        out = self.cli("stop")
        session = self.head["session"]
        deadline = time.monotonic() + 30
        while _session_pids(session) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = _session_pids(session)
        if left:
            raise AssertionError(f"stop left processes {left} of session "
                                 f"{session[:8]} ({out.strip()})")
        if os.path.exists(os.path.join(self.sdir, "head.json")):
            raise AssertionError("stop left head.json")
        if _session_segments(session):
            raise AssertionError(f"stop left /dev/shm segments "
                                 f"{_session_segments(session)}")
        return time.perf_counter() - t0


def _profile_window(trace: dict) -> tuple[float, float]:
    """A torch.profiler Chrome trace's window on the wall clock: its
    baseTimeNanoseconds plus the profiler event's microsecond times."""
    window = next(e for e in trace["traceEvents"] if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("PyTorch Profiler"))
    w0 = trace["baseTimeNanoseconds"] / 1e9 + window["ts"] / 1e6
    return w0, w0 + window["dur"] / 1e6


def _ops_profile_window(trace: dict, spans: list, n_layers: int) -> dict:
    """Phase 14 (c): the decode kernel's device events in a `profile
    --mode torch` window (by the kernel's symbol name) against the decode
    steps of the engine.dispatch_chunk spans that fall inside the window
    (the last 50 ms are left for the device to finish)."""
    w0, w1 = _profile_window(trace)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "decode_attention_kernel" in e["name"]]
    inside = [s for s in spans if s["name"] == "engine.dispatch_chunk"
              and s["ts"] / 1e6 >= w0 and (s["ts"] + s["dur"]) / 1e6
              <= w1 - 0.05]
    steps = sum(s["args"]["tokens"] for s in inside)
    rec = {"window_s": w1 - w0, "decode_kernel_events": len(kernels),
           "decode_steps_in_window": steps,
           "kernel_events": sum(1 for e in events
                                if e.get("cat") == "kernel")}
    if steps == 0 or len(kernels) < n_layers * steps:
        raise AssertionError(
            f"the profile window holds {len(kernels)} decode kernel events "
            f"for {steps} decode steps of {n_layers} layers: {rec}")
    return rec


def _ops_timeline(cluster, trace_id: str, tmp: str) -> list:
    """The request's spans as `timeline --trace` exports them, once the
    engine's spans have arrived (they ride the workers' 1 Hz metrics
    flush) and two exports agree."""
    out = os.path.join(tmp, "timeline.json")
    names = ("engine.prefill", "engine.dispatch_chunk", "engine.host_sync")
    last, deadline = None, time.monotonic() + 30
    while time.monotonic() < deadline:
        cluster.cli("timeline", "--trace", trace_id, "-o", out)
        with open(out) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"]
        have = {e["name"] for e in spans}
        if all(n in have for n in names) and last == len(spans):
            return spans
        last = len(spans)
        time.sleep(1.0)
    raise AssertionError(f"timeline --trace {trace_id[:12]} never held "
                         f"{names} in two equal exports")


def _prom_count(port: int, name: str) -> float:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    counts = [float(line.split()[-1]) for line in text.splitlines()
              if line.startswith(f"{name}_count")]
    return sum(counts)


def phase_ops(lone, widths: dict = SERVE, device: str = "cuda") -> dict:
    """Phase 14: the ops plane. A cluster started through the port's CLI
    whose joined node owns the card serves phase 4's lone prompt through a
    submitted job, and a GPU actor's stream is observed by `top`, `profile
    --mode torch`, `timeline` and the dashboard's /metrics; `stop` leaves
    nothing behind. Beside the job, on a second cluster, the autoscaler
    launches a GPU node for a pending num_gpus=1 task holding the decode
    kernel to its plain version, and reaps it."""
    import concurrent.futures
    import tempfile
    import zipfile

    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rt_ops_")
    env = dict(os.environ, RT_TELEMETRY_INTERVAL_S="0.5", RT_TRACING="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    n_layers = widths["n_layers"]
    rec: dict = {}
    secs: dict = {}

    cluster = _OpsCluster(os.path.join(tmp, "session"), env)

    def start_and_job() -> str:
        # (a) a head without GPUs, and a node that owns the card
        t0 = time.perf_counter()
        head = cluster.start_head(num_cpus=2)
        cluster.cli("start", "--address", head["address"], "--num-cpus",
                    "2", "--num-gpus", "1")
        with open(os.path.join(cluster.sdir, "nodes.json")) as f:
            gpu_node = json.load(f)[0]["node_id"]
        status = cluster.cli("status")
        totals = {m[0]: ast.literal_eval(m[1]) for m in re.findall(
            r"node (\w+) ALIVE total=(\{.*?\}) available=", status)}
        if len(totals) != 2 or sum(t.get("GPU", 0.0)
                                   for t in totals.values()) != 1.0 \
                or totals.get(gpu_node[:8], {}).get("GPU") != 1.0:
            raise AssertionError(f"status is not 2 ALIVE nodes with the one "
                                 f"GPU on {gpu_node[:8]}:\n{status}")
        secs["start"] = time.perf_counter() - t0
        log(f"ops: head {head['address']} (0 GPUs), GPU node "
            f"{gpu_node[:8]}: {totals}")

        # (b) a submitted job serves phase 4's lone prompt on that node
        t0 = time.perf_counter()
        cfg_path = os.path.join(tmp, "ops_job.json")
        with open(cfg_path, "w") as f:
            json.dump({"widths": widths, "device": device,
                       "body": lone[0]}, f)
        script = os.path.join(tmp, "ops_job.py")
        with open(script, "w") as f:
            f.write(OPS_JOB_SCRIPT.format(repo=REPO))
        out = cluster.cli("job", "submit", "--submission-id", "ops-lone",
                          "--", sys.executable, script, cfg_path,
                          timeout=600)
        if "job ops-lone: SUCCEEDED" not in out:
            raise AssertionError(f"the job did not succeed:\n{out[-3000:]}")
        secs["job"] = time.perf_counter() - t0
        logs = cluster.cli("job", "logs", "ops-lone")
        job = json.loads(logs.split("OPS_JOB ", 1)[1].splitlines()[0])
        if job["node_id"] != gpu_node:
            raise AssertionError(f"the job's actor ran on "
                                 f"{job['node_id'][:8]}, not the GPU node")
        if job["tokens"] != lone[1]:
            raise AssertionError("the job's greedy tokens differ from "
                                 "phase 4's lone answer")
        # (on the CPU, which only rehearses this phase, nothing launches)
        if job["decode_steps"] == 0 or device == "cuda" and \
                job["decode_launches"] < n_layers * job["decode_steps"]:
            raise AssertionError(f"the job's actor launched the decode "
                                 f"kernel {job['decode_launches']} times "
                                 f"for {job['decode_steps']} steps")
        rec["job"] = {k: job[k] for k in ("card", "decode_steps",
                                          "decode_launches")}
        rec["job"]["job_s"] = secs["job"]
        log(f"ops job: {json.dumps(rec['job'])}")
        return gpu_node

    # (a) and (b) drive their cluster through the CLI from a thread while
    # this process attaches to (e)'s: the two clusters share nothing but
    # the card, and each part waits mostly on a GPU worker's start-up.
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            first = pool.submit(start_and_job)
            rec["autoscaler"] = _ops_autoscaler(tmp, env, device, secs)
        log(f"ops autoscaler: {json.dumps(rec['autoscaler'])}")
        gpu_node = first.result()
        head = cluster.head

        # (c) a traced GPU actor's stream, seen by top, profile, timeline
        # and the dashboard
        t0 = time.perf_counter()
        dash_port = _free_port()
        dash = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
             "--session-dir", cluster.sdir, "dashboard", "--port",
             str(dash_port)], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        rt.init(address=head["address"])
        try:
            # The profiled actor alone takes its first torch.profiler
            # session once it has initialised CUDA (the `profiler_prep`
            # flag in its runtime env), so the capture opens its window
            # while the stream decodes; no other worker runs one.
            server = rt.remote(num_gpus=1, runtime_env={"env_vars": {
                "RT_PROFILER_PREP": "1"}})(_OpsServer).remote(widths, device)
            info = rt.get(server.info.remote(), timeout=600)
            if info["node_id"] != gpu_node:
                raise AssertionError("the GPU actor is not on the GPU node")
            secs["actor"] = time.perf_counter() - t0
            rt.get(server.complete.remote(
                {"prompt": lone[0]["prompt"][:16], "temperature": 0.0,
                 "max_tokens": 4}), timeout=600)  # warm-up
            secs["warmup"] = time.perf_counter() - t0 - secs["actor"]
            prompt = lone[0]["prompt"][:OPS_STREAM["prompt_len"]]
            ref = server.complete.remote(
                {"prompt": prompt, "temperature": 0.0, "stream": True,
                 "max_tokens": OPS_STREAM["max_tokens"]})
            time.sleep(1.0)  # the stream is decoding
            t_top = time.time()
            top = cluster.cli("top", "--once")
            t_prof = time.time()
            prof = cluster.cli("profile", "--worker", info["worker_id"],
                               "--seconds", str(OPS_PROFILE_S), "--mode",
                               "torch", timeout=120)
            t_prof_end = time.time()
            secs["top_cli"] = t_prof - t_top
            secs["profile_cli"] = t_prof_end - t_prof
            stream = rt.get(ref, timeout=600)
            if len(stream["tokens"]) != OPS_STREAM["max_tokens"]:
                raise AssertionError(f"the stream gave "
                                     f"{len(stream['tokens'])} tokens")
            row = next(line.split() for line in top.splitlines()
                       if line.startswith(gpu_node[:8]))
            mem, compile_s = row[5], row[6]
            used = mem.split("/")[0]
            if device == "cuda":
                used_b, slack = _parse_bytes(used)
                peak = stream["max_memory_allocated"]
                if used_b <= 0 or used_b > peak + slack:
                    raise AssertionError(
                        f"top shows the GPU node's memory as {mem}; the "
                        f"actor's peak is {peak} bytes")
            if compile_s != "-":
                raise AssertionError(f"top printed COMPILE_S {compile_s}")
            rec["top"] = {"gpu_mem": mem, "actor_peak_bytes":
                          stream["max_memory_allocated"]}
            archive = prof.split("trace archive:")[1].split()[0]
            with zipfile.ZipFile(archive) as z:
                trace = json.loads(z.read("trace.json"))
            if not (stream["t0"] < t_top
                    and _profile_window(trace)[1] < stream["t1"]):
                raise AssertionError("the stream did not span top and the "
                                     "profile window")
            spans = _ops_timeline(cluster, stream["trace_id"], tmp)
            names = {s["name"] for s in spans}
            syncs = sum(1 for s in spans if s["name"] == "engine.host_sync")
            bound = -(-OPS_STREAM["max_tokens"] // 16) + 7
            if syncs > bound:
                raise AssertionError(f"{syncs} host_sync spans for "
                                     f"{OPS_STREAM['max_tokens']} tokens "
                                     f"(bound {bound})")
            rec["timeline"] = {
                "spans": len(spans), "host_sync": syncs, "bound": bound,
                "engine_spans": sorted(n for n in names
                                       if n.startswith("engine."))}
            if device == "cuda":
                rec["profile"] = _ops_profile_window(trace, spans, n_layers)
            line = prof.split("startup_s:")[1].splitlines()[0]
            rec["profile_startup_s"] = float(line.split()[0])
            rec["profile_first_session_s"] = (
                float(line.split("took")[1].split()[0]) if "took" in line
                else None)
            deadline = time.monotonic() + 30
            count = 0.0
            while count <= 0 and time.monotonic() < deadline:
                try:
                    count = _prom_count(dash_port, "rt_decode_step_seconds")
                except OSError:
                    pass  # the dashboard is still binding
                if count <= 0:
                    time.sleep(0.5)
            if count <= 0:
                raise AssertionError("the dashboard's /metrics shows no "
                                     "decode-step observation")
            rec["metrics"] = {"rt_decode_step_seconds_count": count}
            rec["stream"] = {
                "tokens": len(stream["tokens"]),
                "decode_steps": stream["decode_steps"],
                "decode_launches": stream["decode_launches"],
                "s": stream["t1"] - stream["t0"]}
            rt.get(server.shutdown.remote(), timeout=60)
        finally:
            rt.shutdown()
            dash.terminate()
            dash.wait(timeout=30)
        secs["observe"] = time.perf_counter() - t0
        log("ops observe: " + json.dumps(
            {k: rec.get(k) for k in (
                "top", "profile", "profile_startup_s",
                "profile_first_session_s", "timeline", "metrics",
                "stream")}))
    finally:
        if hasattr(cluster, "head"):
            # (d) stop: no process, head.json or segment of the session
            # left
            secs["stop"] = cluster.stop()

    rec["ops_launches"] = (rec["job"]["decode_launches"]
                           + rec["stream"]["decode_launches"]
                           + rec["autoscaler"]["decode_launches"])
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["seconds"] = secs
    log(f"phase 14: {rec['phase_s']:.1f} s {json.dumps(secs)}")
    if rec["phase_s"] > OPS_PHASE_LIMIT_S:
        raise AssertionError(f"phase 14 took {rec['phase_s']:.1f} s, over "
                             f"its {OPS_PHASE_LIMIT_S} s")
    return rec


def _ops_autoscaler(tmp: str, env: dict, device: str, secs: dict) -> dict:
    """Phase 14 (e): on a fresh head with no GPU, a pending num_gpus=1 task
    holding the decode kernel to its plain version gets an autoscaled GPU
    node, runs there and the idle node is reaped; `stop` leaves nothing
    of that session. Returns the task's check with the scale-up and reap
    seconds; the seconds of the part and of its stop go into `secs`."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider

    t0 = time.perf_counter()
    cluster2 = _OpsCluster(os.path.join(tmp, "session2"), env)
    head2 = cluster2.start_head(num_cpus=1)
    try:
        rt.init(address=head2["address"])
        try:
            ref = rt.remote(num_gpus=1)(_ops_decode_check).remote(device)
            ready, _ = rt.wait([ref], timeout=3.0)
            if ready:
                raise AssertionError("the num_gpus=1 task ran with no GPU "
                                     "in the cluster")
            provider = LocalNodeProvider(head2["address"], head2["session"],
                                         node_shape={"CPU": 1, "GPU": 1})
            scaler = Autoscaler(head2["address"], provider, min_workers=0,
                                max_workers=1, idle_timeout_s=3.0,
                                interval_s=0.5)
            scaler.start()
            try:
                t_up = time.perf_counter()
                check = rt.get(ref, timeout=600)
                up_s = time.perf_counter() - t_up
                launched = provider.non_terminated_nodes()
                if check["node_id"] not in launched:
                    raise AssertionError("the task did not run on the "
                                         "autoscaled node")
                t_down = time.perf_counter()
                while provider.non_terminated_nodes():
                    if time.perf_counter() - t_down > OPS_REAP_S:
                        raise AssertionError("the idle GPU node was not "
                                             f"reaped in {OPS_REAP_S} s")
                    time.sleep(0.2)
                down_s = time.perf_counter() - t_down
            finally:
                scaler.stop()
                for nid in provider.non_terminated_nodes():  # on failure
                    provider.terminate_node(nid)
        finally:
            rt.shutdown()
    finally:
        secs["stop2"] = cluster2.stop()
    secs["autoscaler"] = time.perf_counter() - t0
    return {**check, "scale_up_s": up_s, "reap_s": down_s}


def _instance(mangled: str) -> str:
    """A kernel instance's name and template arguments from its mangled
    name ("flash_attention_wgmma_kernel<80>",
    "decode_attention_kernel<bf16,64,1>"):
    the identifier whose length prefix matches, past the anonymous
    namespace's hash."""
    m = re.search(r"\d+([a-z_][a-z0-9_]*_kernel)(?:I(\w+?)EEv|E)", mangled)
    if not m:
        return "?"
    name = m.group(1)
    for run in re.finditer(r"\d+", name):
        rest = name[run.end():]
        if any(int(run.group()[i:]) == len(rest)
               for i in range(len(run.group()))):
            name = rest
            break
    args = [a or ("f32" if f else "bf16") for f, _, a in re.findall(
        r"(?<![a-z_])(f)(?=L|E)|(13__nv_bfloat16)|Li(\d+)E", m.group(2) or "")]
    return f"{name}<{','.join(args)}>"


def _ptxas_summary(build_log: str) -> list[str]:
    """One line per kernel instance from nvcc -Xptxas -v: its name and
    template arguments, registers, shared memory and spills, plus any
    performance warning with the instance it names."""
    out, name, spill = [], "?", ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _instance(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "Performance Loss" in line or "setmaxnreg" in line:
            fn = re.search(r"function '(\w+)'", line)
            text = line.split(":", 1)[1].split(" for the function")[0].strip()
            out.append(f"{_instance(fn.group(1)) if fn else name}: {text[:160]}")
    return out


def _decode_smem(kernels) -> None:
    """Phase 1: the dynamic shared memory each decode row of the table
    launches with (ptxas reports static shared memory only), from the
    built library's rt_decode_attention_smem."""
    import ctypes

    import torch

    from ray_tpu_torch.ops.decode_attention import split_plan

    fn = ctypes.CDLL(str(kernels.DECODE_ATTENTION.library)) \
        .rt_decode_attention_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, hq, kv, d, s, dtype, _) in DECODE_TABLE.items():
        elem = 2 if dtype == "bfloat16" else 4
        plan = split_plan(b, hq, kv, s, d, elem, sms)
        smem = fn(d, 1 if elem == 2 else 0, plan.group, plan.chunk)
        log(f"decode smem {name}: {smem} B dynamic (group {plan.group}, "
            f"chunk {plan.chunk}, {plan.n_splits} splits)")


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
    for k in {k.source: k for k in kernels.KERNELS}.values():
        if k.build_log.exists():
            for line in _ptxas_summary(k.build_log.read_text()):
                log(f"ptxas {k.name}: {line}")
    _decode_smem(kernels)

    decode_rec, flash_rec, bwd_rec, norm_recs, narrow_recs, wide_recs = \
        phase_kernels()
    phase_golden()
    widths_rec = phase_widths()
    wide_rec = phase_wide()

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
    runtime_train_rec, batch_rec = phase_runtime(train_rec)
    pipe_rec, tune_rec, tp_train_rec = phase_pipeline_and_tune(
        lone, train_rec["losses"][0])
    t0 = time.perf_counter()
    tp_rec = phase_tensor_parallel(lone)
    log(f"phase 12: {tp_train_rec['phase_s'] + time.perf_counter() - t0:.1f} "
        f"s (its TorchTrainer part {tp_train_rec['phase_s']:.1f} s)")
    phase_rllib()
    ops_rec = phase_ops(lone)
    trainer_launches = {
        name: sum(c[name] for c in runtime_train_rec["launches"].values())
        for name in ("flash_attention", "flash_attention_bwd")}
    tune_launches = tune_rec["tune_launches"]
    # phase 12: per rank, summed over the ranks sharing the card
    tp_launches = {
        "decode_attention": sum(e["decode_launches"]
                                for e in tp_rec["engine_per_rank"]),
        **{name: sum(m["launches"][name] for m in tp_train_rec["ranks"])
           for name in ("flash_attention", "flash_attention_bwd")}}
    if serve_rec["decode_launches"] == 0 or forward_rec["flash_launches"] == 0 \
            or train_rec["flash_bwd_launches"] == 0 \
            or http_rec["replica_decode_launches"] == 0 \
            or 0 in trainer_launches.values() \
            or batch_rec["actor_decode_launches"] == 0 \
            or pipe_rec["pipeline_launches"] == 0 \
            or 0 in tune_launches.values() \
            or 0 in tp_launches.values() \
            or ops_rec["ops_launches"] == 0:
        raise AssertionError("a kernel of the main path never launched")

    def line(kernel, rec, launches, replaces):
        return {"name": kernel.name, "route": "cuda",
                "source": str(kernel.source.relative_to(REPO)),
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    def narrow_heads(name):
        """Phase 2's D = 16 and 32 cases of the kernel, its launches by head
        dim on phase 15's paths and in phase 12 (e)'s dryrun."""
        return {"narrow_heads": {
            "cases": [{k: r[k] for k in (
                "case", "d", "max_abs_err", "ms", "bound_ms", "bound_by",
                "plain_ms", "library_ms")} for r in narrow_recs[name]],
            "launches": widths_rec["launches"][name],
            "dryrun_launches": tp_rec["dryrun"]["launches_by_head_dim"][name]}}

    def wide_heads(name):
        """Phase 2's cases of the kernel at D = 8, 80, 96, 120 (decode),
        40 (flash) and 256, and its launches by head dim on phase 16's
        paths."""
        return {"wide_heads": {
            "cases": [{k: r[k] for k in (
                "case", "d", "max_abs_err", "ms", "bound_ms", "bound_by",
                "plain_ms", "library_ms", "library_backend")}
                for r in wide_recs[name]],
            "launches": wide_rec["launches"][name]}}

    def per_rank(name, rec):
        """Phase 12: the kernel at its per-rank shape, and its launches in
        phase 12's ranks (summed over them)."""
        return {"per_rank_shape": {
            k: rec[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")},
            "tp_launches": tp_launches[name]}

    log(json.dumps({"kernels": [
        {**line(kernels.DECODE_ATTENTION, decode_rec,
                serve_rec["decode_launches"],
                "ray_tpu/ops/decode_attention.py:33"),
         "replica_launches": http_rec["replica_decode_launches"],
         "batch_launches": batch_rec["actor_decode_launches"],
         "pipeline_launches": pipe_rec["pipeline_launches"],
         "ops_launches": ops_rec["ops_launches"],
         **per_rank("decode_attention", tp_rec["kernels"]["decode"]),
         **narrow_heads("decode_attention"),
         **wide_heads("decode_attention")},
        {**line(kernels.FLASH_ATTENTION, flash_rec,
                forward_rec["flash_launches"] + train_rec["flash_launches"],
                "ray_tpu/ops/flash_attention.py:74"),
         "trainer_launches": trainer_launches["flash_attention"],
         "tune_launches": tune_launches["flash_attention"],
         **per_rank("flash_attention", tp_rec["kernels"]["flash"]),
         **narrow_heads("flash_attention"),
         **wide_heads("flash_attention")},
        {**line(kernels.FLASH_ATTENTION_BWD, bwd_rec,
                train_rec["flash_bwd_launches"],
                "gradient of ray_tpu/ops/flash_attention.py:74 (no Pallas "
                "counterpart)"),
         "trainer_launches": trainer_launches["flash_attention_bwd"],
         "tune_launches": tune_launches["flash_attention_bwd"],
         **per_rank("flash_attention_bwd", tp_rec["kernels"]["flash_bwd"]),
         **narrow_heads("flash_attention_bwd"),
         **wide_heads("flash_attention_bwd")},
        {**line(kernels.RMS_NORM, norm_recs[0], train_rec["norm_launches"],
                "none (XLA fuses ray_tpu/models/transformer.py's RMSNorm)"),
         "narrow": norm_recs[1]},
        {**line(kernels.RMS_NORM_BWD, {
            **norm_recs[0], "ms": norm_recs[0]["bwd_ms"],
            "plain_ms": norm_recs[0]["bwd_plain_ms"],
            "bound_ms": norm_recs[0]["bwd_bound_ms"]},
            train_rec["norm_bwd_launches"],
            "none (the gradient of the RMSNorm)")},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
