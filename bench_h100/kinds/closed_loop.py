"""Clients of the OpenAI HTTP surface in a closed loop: each client sends
its next streamed completion as soon as its last one ended, with no think
time.

The schedule is a function of the seed and the request's index: the i-th
request sent (by any client) has the same prompt length, output length,
sampling and token ids in every run of a seed. The lengths of every seed
follow the same stratified draw (an additive sequence over the quantiles
of the mix's log-uniform ranges, shifted by the seed), so seeds differ in
order and ids, not in the work they ask for. The first request of each
client asks for a share of its output length (client c of n: (c + 1) / n),
so that the clients' ends spread from the start.

A run: deploy the configuration with the port's Serve (`build_openai_app`,
one replica holding the card), warm every shape the mix uses (each prefill
bucket, a greedy and a sampled decode chunk) over HTTP, start the clients,
let the ramp pass, then measure for the window's seconds. Requests sent in
the window are waited for until their first token (a minute at most), and
the clients are then stopped. With tracing on, the replica's own profile
capture (the runtime's `profile_worker`, torch mode) covers the window's
last `profile_s`; counters are read over the part of the window before
it. The capture is short because the replica writes its trace out while
it serves, and a long trace keeps it from answering Serve's health check
(5 s), which then replaces it.

Once the runtime has stopped and the card is free, the reference judges a
sample of the greedy requests served (`reference.served`).

The mix's parameters: `clients`, `prompt_tokens` and `output_tokens`
(`low`, `high` of a log-uniform range), `greedy_every` (one request in that
many is greedy, the others sample at `sampling`), `ramp_s`, `drain_s`,
`profile_s`, `check_requests`.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import socket
import subprocess
import time
from dataclasses import dataclass

import numpy as np

from harness import device as hdev
from harness import roofline, trace
from harness.stats import (RequestRecord, Window, longest_silence,
                           serving_summary, timeline)
from reference import served
from reference.model import Widths

_PHI = (math.sqrt(5.0) - 1.0) / 2.0
_SQRT2 = math.sqrt(2.0) - 1.0


@dataclass(frozen=True)
class Request:
    index: int
    prompt: tuple
    max_tokens: int
    greedy: bool
    seed: int

    def body(self, sampling: dict) -> dict:
        body = {"prompt": list(self.prompt), "max_tokens": self.max_tokens,
                "stream": True, "seed": self.seed}
        if self.greedy:
            body["temperature"] = 0.0
        else:
            body.update(sampling)
        return body


class Schedule:
    """The i-th request of a seed's closed loop."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        rng = np.random.default_rng([seed, 0xC10])
        self.shift = rng.random(2)
        self.greedy_phase = int(rng.integers(mix["greedy_every"]))

    @staticmethod
    def _log_uniform(u: float, rng: dict) -> int:
        lo, hi = rng["low"], rng["high"]
        return int(round(math.exp(math.log(lo) + u * math.log(hi / lo))))

    def __call__(self, i: int) -> Request:
        mix = self.mix
        u = (self.shift[0] + i * _PHI) % 1.0
        v = (self.shift[1] + i * _SQRT2) % 1.0
        plen = self._log_uniform(u, mix["prompt_tokens"])
        out = self._log_uniform(v, mix["output_tokens"])
        if i < mix["clients"]:
            out = max(1, round(out * (i + 1) / mix["clients"]))
        rng = np.random.default_rng([self.seed, 0x1D5, i])
        ids = tuple(int(t) for t in rng.integers(0, self.vocab, plen))
        return Request(i, ids, out,
                       i % mix["greedy_every"] == self.greedy_phase,
                       int(rng.integers(1 << 31)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _llm_config(config: dict, seed: int):
    from ray_tpu_torch.llm import LLMConfig

    run = config["run"]
    return LLMConfig(vocab_size=run["vocab_size"], d_model=run["d_model"],
                     n_layers=run["n_layers"], n_heads=run["n_heads"],
                     max_seq=run["max_seq"], dtype=run["dtype"], seed=seed)


def _served_widths(config: dict) -> dict:
    """The widths the port derives from its LLMConfig (`model_config`):
    KV heads equal to heads, d_ff = 8/3 d_model rounded down to 8."""
    run = config["run"]
    return {"vocab_size": run["vocab_size"], "d_model": run["d_model"],
            "n_layers": run["n_layers"], "n_heads": run["n_heads"],
            "n_kv_heads": run["n_heads"],
            "d_ff": int(run["d_model"] * 8 / 3) // 8 * 8}


class Clients:
    """The closed loop's clients on one asyncio loop."""

    def __init__(self, base: str, schedule: Schedule, sampling: dict):
        self.base, self.schedule, self.sampling = base, schedule, sampling
        self.records: list[RequestRecord] = []
        self.requests: dict[int, Request] = {}
        self.sending = True
        self._next = 0
        self._tasks: list = []
        self.session = None

    async def open(self):
        import aiohttp

        self.session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=None))

    def start(self, n: int):
        self._tasks = [asyncio.create_task(self._client()) for _ in range(n)]

    async def stream(self, req: Request, rec: RequestRecord):
        """One streamed completion, recorded as its client sees it."""
        try:
            async with self.session.post(f"{self.base}/v1/completions",
                                         json=req.body(self.sampling)) as r:
                if r.status != 200:
                    rec.error = f"HTTP {r.status}: {(await r.text())[:200]}"
                    return
                async for line in r.content:
                    if not line.startswith(b"data: "):
                        continue
                    data = line[6:].strip()
                    if data == b"[DONE]":
                        break
                    ev = json.loads(data)
                    toks = ev.get("token_ids") or []
                    if toks:
                        rec.chunks.append((time.perf_counter(), len(toks)))
                        rec.tokens.extend(toks)
                    finish = ev["choices"][0].get("finish_reason")
                    if finish:
                        rec.finish_reason = finish
        except asyncio.CancelledError:
            rec.given_up = time.perf_counter()
            raise
        except Exception as e:  # noqa: BLE001 - a failed request is data
            rec.error = repr(e)[:300]
            rec.given_up = time.perf_counter()

    async def _client(self):
        while self.sending:
            i = self._next
            self._next += 1
            req = self.schedule(i)
            self.requests[i] = req
            rec = RequestRecord(index=i, prompt_len=len(req.prompt),
                                max_tokens=req.max_tokens, greedy=req.greedy,
                                sent=time.perf_counter())
            self.records.append(rec)
            await self.stream(req, rec)

    async def stop(self):
        self.sending = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        await self.session.close()


async def _get_json(session, url: str) -> dict:
    async with session.get(url) as r:
        return await r.json(content_type=None)


def _replica_worker_id(pid: int) -> str:
    """The runtime's id of the worker process `pid` (the replica's), from
    this driver's in-process head."""
    from ray_tpu_torch._private import api

    for wid, slot in api._head.agent.workers.items():
        if slot.proc.pid == pid:
            return wid
    raise RuntimeError(f"no worker of this head has pid {pid}")


def _capture(worker_id: str, seconds: float) -> dict:
    """The replica's torch.profiler capture through the runtime's
    `profile_worker` path; returns the persisted profile's metadata."""
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    timeout = telemetry.profile_timeout(seconds, "client")
    rep = w.io.run(w.controller.call(
        "profile_worker", worker_id=worker_id, seconds=seconds,
        mode="torch", _timeout=timeout), timeout=timeout + 5)
    if not rep.get("found"):
        raise RuntimeError(f"the replica's profile failed: {rep.get('error')}")
    return rep["profile"]


def _compute_apps() -> int:
    """How many processes nvidia-smi lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return len(out.strip().splitlines())


def _wait_card_free(before: int, timeout: float = 60.0) -> None:
    """Wait until nvidia-smi lists no more processes on the card than
    before the replica started."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _compute_apps() <= before:
            return
        time.sleep(0.5)
    raise RuntimeError("the replica's process still holds the card")


async def _warm(clients: Clients, mix: dict, vocab: int, seed: int):
    """Every prefill bucket the mix reaches and both decode paths, over
    HTTP: a greedy request alone (an all-greedy chunk), then one sampled
    request per remaining bucket at once (sampled chunks)."""
    rng = np.random.default_rng([seed, 0x3A2])
    lens = mix["warm_prompt_tokens"]

    def req(plen, greedy):
        ids = tuple(int(t) for t in rng.integers(0, vocab, plen))
        return Request(-1, ids, mix["warm_output_tokens"], greedy, 0)

    async def one(r):
        rec = RequestRecord(-1, len(r.prompt), r.max_tokens, r.greedy,
                            time.perf_counter())
        await clients.stream(r, rec)
        if rec.error or len(rec.tokens) != r.max_tokens:
            raise RuntimeError(f"a warm-up request failed: {rec.error}, "
                               f"{len(rec.tokens)} tokens")

    await one(req(lens[0], True))
    await asyncio.gather(*(one(req(n, False)) for n in lens[1:]))


async def _drive(base: str, mix: dict, schedule: Schedule, vocab: int,
                 seed: int, seconds: float, trace_on: bool, t_start: float):
    clients = Clients(base, schedule, mix["sampling"])
    await clients.open()
    try:
        return await _measure(clients, base, mix, vocab, seed, seconds,
                              trace_on, t_start)
    finally:
        await clients.stop()


async def _measure(clients: Clients, base: str, mix: dict, vocab: int,
                   seed: int, seconds: float, trace_on: bool,
                   t_start: float):
    stats_url = f"{base}/v1/stats"
    pid = (await _get_json(clients.session, stats_url))["pid"]
    if trace_on:
        # The replica's first profiler session (CUPTI's start, seconds
        # long) stalls the process; under load it then misses Serve's
        # health check and is replaced. A first, empty capture taken while
        # the replica is idle waits for that session (the `profiler_prep`
        # lock).
        await asyncio.to_thread(_capture, _replica_worker_id(pid), 0.05)
    await _warm(clients, mix, vocab, seed)
    clients.start(mix["clients"])
    await asyncio.sleep(mix["ramp_s"])
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    s0 = await _get_json(clients.session, stats_url)
    cap = None
    if trace_on:
        await asyncio.sleep(max(0.0, seconds - mix["profile_s"]
                                - (time.perf_counter() - t0)))
        t_cap = time.perf_counter()
        s_cap = await _get_json(clients.session, stats_url)
        if s_cap["pid"] != pid:
            raise RuntimeError("the replica was replaced during the run")
        cap = asyncio.create_task(asyncio.to_thread(
            _capture, _replica_worker_id(pid), mix["profile_s"]))
    await asyncio.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
    t1 = time.perf_counter()
    clients.sending = False
    window = Window(t0, t1)
    # requests sent in the window: wait for their first token
    deadline = t1 + mix["drain_s"]
    while time.perf_counter() < deadline and any(
            window.holds(r.sent) and r.first is None and r.error is None
            for r in clients.records):
        await asyncio.sleep(0.05)
    out = {"records": clients.records, "requests": clients.requests,
           "window": window, "setup_s": setup_s, "stats0": s0}
    if trace_on:
        out.update(pre=Window(t0, t_cap), stats_cap=s_cap,
                   profile=await cap)
    return out


def _pre_window(run: dict, widths: dict, max_batch: int) -> dict:
    """Counter readings over the part of the window before the capture:
    decode steps from the replica's /v1/stats, tokens and model FLOPs from
    the clients' records (prompts whose first token came inside it, and
    each generated token at its context length)."""
    pre = run["pre"]
    summ = serving_summary(run["records"], pre)
    steps = run["stats_cap"]["decode_steps"] - run["stats0"]["decode_steps"]
    flops = 0.0
    for r in run["records"]:
        k = 0
        for t, n in r.chunks:
            for j in range(k, k + n):
                if not pre.holds(t):
                    continue
                flops += (roofline.prefill_flops(widths, r.prompt_len)
                          if j == 0 else
                          roofline.decode_flops(widths, r.prompt_len + j))
            k += n
    summ.update(decode_steps=steps, max_batch=max_batch, model_flops=flops)
    return summ


def _judged(run: dict, mix: dict, seed: int) -> list:
    """The greedy requests the reference judges: the longest finished one
    (prompt and served tokens) and others drawn from the seed, among those
    served in the window first, then before it; the clients' first
    requests, cut short to spread the start, only where there are too few
    others."""
    window = run["window"]
    done = [r for r in run["records"] if r.greedy and r.finished
            and len(r.tokens) == r.max_tokens]
    later = [r for r in done if r.index >= mix["clients"]]
    if len(later) >= mix["check_requests"]:
        done = later
    done.sort(key=lambda r: (not window.holds(r.first), r.index))
    if not done:
        return []
    pick = [max(done, key=lambda r: r.prompt_len + len(r.tokens))]
    rest = [r for r in done if r is not pick[0]]
    inside = [r for r in rest if window.holds(r.first)]
    pool = inside if len(inside) >= mix["check_requests"] - 1 else rest
    rng = np.random.default_rng([seed, 0x5E1])
    n = min(len(pool), mix["check_requests"] - 1)
    pick += [pool[k] for k in sorted(rng.choice(len(pool), n, replace=False))]
    return pick


def run(cell, seed: int, seconds: float, trace_on: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.openai import build_openai_app

    cfg, mix = cell.config, cell.traffic
    dep = cfg["deployment"]
    cuda = device == "cuda"
    vocab = cfg["run"]["vocab_size"]
    widths = _served_widths(cfg)
    schedule = Schedule(mix, vocab, seed)
    opts = {"num_gpus": 1} if cuda else {}
    if trace_on:
        # the replica alone takes its first profiler session at start-up
        opts["runtime_env"] = {"env_vars": {"RT_PROFILER_PREP": "1"}}
    port = _free_port()
    apps_before = _compute_apps() if cuda else 0
    if cuda:
        # the port builds its kernels at first use; built here, before the
        # replica starts, a first run's build does not stall the replica
        # past Serve's health check
        from ray_tpu_torch._private import kernels

        kernels.build_all()
    smi = hdev.smi_sampler() if cuda else contextlib.nullcontext({})
    with smi as card:
        rt.init(num_cpus=dep["num_cpus"])
        try:
            serve.run(build_openai_app(
                _llm_config(cfg, seed), max_batch=dep["max_batch"],
                decode_chunk=dep["decode_chunk"],
                max_ongoing_requests=dep["max_ongoing_requests"],
                ray_actor_options=opts, device=device),
                port=port, timeout_s=dep["deploy_timeout_s"])
            driven = asyncio.run(_drive(
                f"http://127.0.0.1:{port}", mix, schedule, vocab, seed,
                seconds, trace_on, t_start))
        finally:
            try:
                serve.shutdown()
            finally:
                rt.shutdown()
    window = driven["window"]
    summ = serving_summary(driven["records"], window)
    rec = {"kind": "closed_loop", "setup_s": driven["setup_s"],
           "summary": summ, "widths": widths}
    dev = {"memory_peak_bytes": (int(card["memory_used_mib"][2]) << 20
                                 if cuda else 0)}
    breakdown = None
    if trace_on:
        rec["pre"] = _pre_window(driven, widths, dep["max_batch"])
        doc = trace.load(driven["profile"]["archive_path"])
        red = trace.reduce(doc)
        if cuda and red.n_kernels == 0:
            raise RuntimeError("the replica's capture holds no kernel events")
        dec_s, dec_n = red.kernels("decode_attention")
        rec["capture"] = {"busy_s": red.busy_s, "window_s": red.window_s,
                          "decode_kernel_s": dec_s, "decode_launches": dec_n,
                          "kernels": red.n_kernels}
        dev["busy_s"], dev["window_s"] = red.busy_s, red.window_s
        breakdown = red.breakdown()
    sent = [r for r in driven["records"] if window.holds(r.sent)]
    unanswered = [r for r in sent if not r.answered]
    judged = _judged(driven, mix, seed)
    if cuda:
        _wait_card_free(apps_before)
    ref_w = Widths(vocab_size=widths["vocab_size"], d_model=widths["d_model"],
                   n_layers=widths["n_layers"], n_heads=widths["n_heads"],
                   n_kv_heads=widths["n_kv_heads"], d_ff=widths["d_ff"],
                   rope_theta=cfg["run"]["rope_theta"])
    t_ref = time.perf_counter()
    seqs = [(driven["requests"][r.index].prompt, r.tokens) for r in judged]
    verdict = (served.judge(ref_w, seed, seqs, device, control=control)
               if seqs else {"program_gap": math.inf, "tokens": 0})
    readings = {"greedy_gap": verdict["program_gap"],
                "unanswered": len(unanswered),
                "judged_tokens": verdict["tokens"]}
    out = {"record": rec, "device": dev, "breakdown": breakdown,
           "attempted": len(sent), "failed": len(unanswered),
           "readings": readings, "reference_s": time.perf_counter() - t_ref,
           "detail": {"window": summ, "judged": verdict.get("per_request"),
                      "card": card if cuda else None,
                      "longest_silence_s": longest_silence(
                          driven["records"], window),
                      "tokens_per_s_timeline": timeline(
                          driven["records"], window)}}
    if control:
        out["control_readings"] = {"greedy_gap": verdict.get("control_gap")}
    return out

