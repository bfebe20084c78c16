"""The training step, driven by batches of seeded token ids.

Set-up builds one object, the port's `Transformer` with its
`torch.optim.Adam`, and drives it through the check's first steps (which
also warm every shape) with the same call the window makes. Then the
window dispatches steps back to back with no host read and ends on a
device synchronise: the tokens of every step dispatched over the window's
seconds. With tracing on, a few more steps run under torch.profiler after
the window, and the optimizer step is timed with CUDA events.

Once the window has closed and the program's state is freed, the
reference follows the first steps (`reference.trained`).

The mix's parameters: `batch`, `seq_len` (the model runs at seq_len;
each row holds seq_len + 1 ids), `lr`, `pool` (distinct batches, cycled
through the window), `check_steps`, `profile_steps`, `optimizer_reps`.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np

from harness import device as hdev
from harness import roofline, trace
from reference import trained
from reference.model import Widths

WIDTH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
             "vocab_size")


def widths(config: dict) -> dict:
    """The port's widths, from the configuration's `run` block."""
    return {k: config["run"][k] for k in WIDTH_KEYS}


def batches(traffic: dict, vocab: int, seed: int, count: int) -> np.ndarray:
    """count batches [count, batch, seq_len + 1] of token ids from the
    seed; every row differs."""
    rng = np.random.default_rng([seed, 0x7A1])
    return rng.integers(0, vocab, size=(count, traffic["batch"],
                                        traffic["seq_len"] + 1),
                        dtype=np.int64)


def _program(config: dict, traffic: dict, seed: int, device: str):
    import torch

    from ray_tpu_torch.models import transformer as T

    run = config["run"]
    mcfg = T.TransformerConfig(
        vocab_size=run["vocab_size"], d_model=run["d_model"],
        n_layers=run["n_layers"], n_heads=run["n_heads"],
        n_kv_heads=run["n_kv_heads"], d_ff=run["d_ff"],
        max_seq=run["max_seq"], rope_theta=run["rope_theta"],
        dtype=getattr(torch, run["compute_dtype"]),
        param_dtype=getattr(torch, run["param_dtype"]))
    model = T.Transformer(mcfg, device=device, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=traffic["lr"])

    def step(tokens):
        # looked up at each call, so a test can plant a fault in the
        # program underneath
        loss = T.loss_fn(model, tokens)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    return model, opt, step


def run(cell, seed: int, seconds: float, trace_on: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    import torch

    cfg, mix = cell.config, cell.traffic
    w = widths(cfg)
    cuda = device == "cuda"
    pool = batches(mix, w["vocab_size"], seed, mix["pool"])
    model, opt, step = _program(cfg, mix, seed, device)
    toks = torch.as_tensor(pool, device=device)
    beta1 = opt.param_groups[0]["betas"][0]
    # the check's first steps, through the window's own call and feed
    prog = {"losses": [], "grad_norms": {}}
    for i in range(mix["check_steps"]):
        prog["losses"].append(float(step(toks[i]).detach()))
        if i == 0:
            # a step that left no moment behind read as no gradient
            prog["grad_norms"] = {
                n: float(opt.state[p]["exp_avg"].double().norm()) / (1 - beta1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for n, p in model.named_parameters()}
    # the weights after them, read before the window moves them on; the
    # copy is the check's and is taken out of set-up
    t_copy = time.time()
    after = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    copy_s = time.time() - t_copy
    if cuda:
        torch.cuda.synchronize()
    # the window
    t0 = time.perf_counter()
    setup_s = time.time() - t_start - copy_s
    n, i = 0, mix["check_steps"]
    while time.perf_counter() - t0 < seconds:
        step(toks[i % len(pool)])
        i += 1
        n += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    last_loss = float(step(toks[i % len(pool)]).detach())
    tokens_per_step = mix["batch"] * mix["seq_len"]
    rec = {"kind": "train_batches", "setup_s": setup_s,
           "train": {"steps": n, "window_s": window_s,
                     "tokens_per_s": n * tokens_per_step / window_s,
                     "step_flops": roofline.train_step_flops(
                         w, mix["batch"], mix["seq_len"]),
                     "batch": mix["batch"], "seq_len": mix["seq_len"],
                     "widths": w}}
    dev = {"memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    breakdown = None
    if trace_on:
        rec["profile"], breakdown = _profile(step, toks, mix, cuda)
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["window_s"]
        if cuda:
            flush = torch.empty(64 << 20, dtype=torch.int8, device=device)
            rec["train"]["optimizer_ms"] = _optimizer_ms(model, opt, toks,
                                                         flush, mix)
    del model, opt, step, toks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, once the program's state is freed
    ref_w = Widths(vocab_size=w["vocab_size"], d_model=w["d_model"],
                   n_layers=w["n_layers"], n_heads=w["n_heads"],
                   n_kv_heads=w["n_kv_heads"], d_ff=w["d_ff"],
                   rope_theta=cfg["run"]["rope_theta"])
    first = [pool[k] for k in range(mix["check_steps"])]
    t_ref = time.perf_counter()
    ref = trained.reference_steps(ref_w, seed, first, mix["lr"], device)
    prog["change_norms"] = trained.change_norms(after, ref["p0"], device)
    read = trained.readings(prog, ref)
    out = {"record": rec, "device": dev, "breakdown": breakdown,
           "attempted": n, "failed": 0 if np.isfinite(last_loss) else 1,
           "readings": read, "reference_s": time.perf_counter() - t_ref,
           "detail": {"program_losses": prog["losses"],
                      "reference_losses": ref["losses"],
                      "copy_s": copy_s}}
    if control:
        ctl = trained.reference_steps(ref_w, seed, first, mix["lr"], device,
                                      precision="fp8")
        out["control_readings"] = trained.readings(ctl, ref)
        # the faults, planted in the reference put in the program's place:
        # half of each batch left out, the mean taken over the rest; a step
        # that leaves the state unchanged (no update)
        half = trained.reference_steps(
            ref_w, seed, [b[:len(b) // 2] for b in first], mix["lr"], device)
        frozen = trained.reference_steps(ref_w, seed, first, 0.0, device)
        out["fault_readings"] = {"half_batch": trained.readings(half, ref),
                                 "frozen_step": trained.readings(frozen, ref)}
    return out


def _profile(step, toks, mix: dict, cuda: bool) -> tuple[dict, dict]:
    """A few steps under torch.profiler, reduced from its trace: the
    device's busy time over the traced window, the flash kernels' times per
    call, the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for k in range(mix["profile_steps"]):
            step(toks[k % len(toks)])
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(), "bench_h100",
                        "train_trace.json")
    prof.export_chrome_trace(path)
    red = trace.reduce(trace.load(path))
    os.remove(path)
    if cuda and red.n_kernels == 0:
        raise RuntimeError("the profile holds no kernel events")

    def per_call(name: str, calls: str):
        """Seconds of every kernel whose name holds `name`, per launch of
        the one whose name holds `calls`."""
        n = red.kernels(calls)[1]
        return red.kernels(name)[0] / n if n else None

    return ({"busy_s": red.busy_s, "window_s": red.window_s,
             "steps": mix["profile_steps"], "kernels": red.n_kernels,
             "flash_fwd_s": per_call("flash_attention_wgmma",
                                     "flash_attention_wgmma"),
             "flash_bwd_s": per_call("flash_bwd", "flash_bwd_wgmma")},
            red.breakdown())


def _optimizer_ms(model, opt, toks, flush, mix: dict) -> float:
    """Device milliseconds of one `opt.step()` on a step's gradients, by
    CUDA events (the copy of the repository's event timing)."""
    import torch

    from ray_tpu_torch.models import transformer as T

    T.loss_fn(model, toks[0]).backward()
    ms = hdev.timed_ms(opt.step, flush, reps=mix["optimizer_reps"])
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return ms
