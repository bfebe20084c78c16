"""Pipeline-parallel LLM decode on the compiled DAG plane.

The ContinuousEngine (engine.py) is one process: the whole model, the
whole KV cache, one device. This module cuts the SAME model at layer
boundaries into N pipeline stages — each a long-lived actor bound into
one compiled DAG (`stage0.step -> stage1.step -> ...`) — and runs decode
iterations as DAG invocations:

- **Stage slicing**: engine.stage_layer_split / stage_param_slice /
  make_stage_net keep per-layer module names GLOBAL (`layers.{i}.`), so a
  stage's params are a strict subset of the full state_dict and the
  pipelined model is bit-compatible with the single-process one.
- **Microbatched occupancy**: the batch splits into `n_mb` microbatches;
  each decode invocation steps ONE microbatch through all stages, and
  the driver keeps every microbatch's invocation in flight at once, so
  stage k works on microbatch j while stage k+1 works on microbatch j-1
  — classic GPipe-style bubble filling, bounded by RT_DAG_MAX_INFLIGHT.
- **Zero-RPC activation edges**: stage outputs are (tag, mb, activation,
  ...) tuples; the DAG edge publisher pins the activation tensors
  (RT_DAG_EDGE_MIN_BYTES, far below the general device-object threshold)
  and ships ~200B placeholders through the shm channels, eagerly
  exported so a same-host consumer's resolve is a store hit — the steady
  state moves tokens, not activations, and pays no per-token RPC.
- **On-device sampling**: the LAST stage holds the tied head and the
  per-slot sampling mirrors (temperature/top-k/top-p, the request's key
  and its step counter), so only sampled token ids cross back to the
  driver.
- **Failure contract** (mirrors the DAG plane's): a stage killed
  mid-generation fails every open GenStream with the attributed
  DagStageError (stage name, invocation, node), then the engine tears
  the graph down, rebuilds fresh stages, and resumes from the request
  queue — consumers see a typed error or tokens, never a hang.

Drop-in: PipelinedEngine exposes the ContinuousEngine surface
(`submit() -> GenStream`, `generate`, `shutdown`, `num_active`), so the
serve/OpenAI layer runs unchanged on top of it.

Counterpart: ray_tpu/llm/pipeline.py. Each stage is the port's stage net
on `device` ("cuda" by default: its decode steps run the decode kernel,
once per layer); a stage that finds no CUDA raises in its constructor,
and the engine raises that as the stage's DagStageError. The driver never
touches the device: it builds the full state_dict on the CPU and ships
each stage its shard as numpy. A sampled draw is the port's sampler on
(stream_key(seed, request_id), token index), as in ContinuousEngine, so
the same request draws the same tokens from the same logits in both
engines.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
import uuid
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.llm.engine import (GenStream, SamplingParams, _load_params,
                                      _sample, _Slot, make_stage_net,
                                      model_config, stage_layer_split,
                                      stage_param_slice, stream_key)

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- occupancy
#: Cumulative per-stage busy time in THIS process (stage actors record into
#: it from step()). telemetry's WorkerSampler and the metrics drain hook
#: read windowed busy fractions via occupancy_snapshot — the pipeline
#: bubble is (1 - occupancy) of the busiest window.
_occ_lock = threading.Lock()
_occ: dict[str, list] = {}  # stage name -> [busy_seconds, steps]
_occ_marks: dict[str, dict] = {}  # consumer -> stage -> (t, busy_seconds)


def _occ_record(stage: str, busy_s: float) -> None:
    with _occ_lock:
        ent = _occ.setdefault(stage, [0.0, 0])
        ent[0] += busy_s
        ent[1] += 1


def occupancy_snapshot(consumer: str = "telemetry") -> dict:
    """Per-stage busy fraction of wall time since this consumer's previous
    call (first call anchors the window and reports 0.0). Empty dict when
    no pipeline stage lives in this process."""
    now = time.monotonic()
    out: dict[str, float] = {}
    with _occ_lock:
        marks = _occ_marks.setdefault(consumer, {})
        for stage, ent in _occ.items():
            busy = ent[0]
            prev = marks.get(stage)
            marks[stage] = (now, busy)
            if prev is None or now <= prev[0]:
                out[stage] = 0.0
            else:
                out[stage] = min(1.0, max(0.0,
                                          (busy - prev[1]) / (now - prev[0])))
    return out


# ------------------------------------------------------------- stage actor
class PipelineStage:
    """One pipeline stage: a contiguous layer range of the serving model
    plus its OWN per-microbatch KV caches, bound into the compiled DAG via
    `step`. The first stage embeds token ids; the last holds final_norm,
    the tied head, and the sampling state, returning token ids only.

    Messages (the DAG invocation payloads):
      ("d", mb, toks|x, lens, greedy)  one decode step for microbatch `mb`
      ("p", row, toks|x, plen, samp)   prefill one request into batch row
    Mid-pipeline, toks becomes the activation x — a torch.Tensor the edge
    publisher replaces with a device-object placeholder.
    """

    def __init__(self, cfg, stage_idx: int, n_stages: int, layers: tuple,
                 first: bool, last: bool, shard: dict, mb_size: int,
                 n_mb: int, device="cuda"):
        # The first touch of the device is here, in the stage's process.
        from ray_tpu_torch._private.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = f"pp{stage_idx}"
        self.first, self.last = bool(first), bool(last)
        self.layers = tuple(layers)
        self.mb_size, self.n_mb = int(mb_size), int(n_mb)
        mcfg = model_config(cfg)
        self.mcfg = mcfg
        self.net = make_stage_net(mcfg, self.layers, self.first, self.last,
                                  device=self.device)
        self.net.load_state_dict(
            {k: torch.tensor(np.asarray(v)) for k, v in shard.items()},
            strict=True)
        if mcfg.dtype == torch.bfloat16:
            self.net.to(torch.bfloat16)  # as ContinuousEngine casts
        self.net.eval()
        self._caches = [self.net.new_cache(self.mb_size)
                        for _ in range(self.n_mb)]
        #: decode invocations this stage ran
        self.decode_steps = 0
        if self.last:
            # Per-microbatch sampling mirrors, set at prefill: decode
            # sampling reads them on device, so the driver never ships
            # sampling state in the steady state.
            def mirror(value, dtype):
                return [torch.full((self.mb_size,), value, dtype=dtype,
                                   device=self.device)
                        for _ in range(self.n_mb)]

            self._temps = mirror(0.0, torch.float32)
            self._topks = mirror(0, torch.int64)
            self._topps = mirror(1.0, torch.float32)
            self._keys = mirror(0, torch.int64)
            self._steps = mirror(0, torch.int64)

    # -------------------------------------------------------------- step
    def step(self, msg):
        t0 = time.monotonic()
        try:
            kind = msg[0]
            # Grad mode is per thread, and step runs on the DAG loop's.
            with torch.no_grad():
                if kind == "d":
                    return self._step_decode(msg)
                if kind == "p":
                    return self._step_prefill(msg)
            raise ValueError(f"unknown pipeline message kind {kind!r}")
        finally:
            _occ_record(self.name, time.monotonic() - t0)

    def _rows(self, array) -> torch.Tensor:
        """Host int array -> int64 [mb_size, 1] on this stage's device."""
        t = torch.as_tensor(np.asarray(array, np.int64).reshape(
            self.mb_size, 1))
        return t.to(self.device)

    def _step_decode(self, msg):
        _k, mb, x, lens, greedy = msg
        mb = int(mb)
        if self.first:
            x = self._rows(x)
        positions = self._rows(lens)
        y = self.net(x, positions, cache=self._caches[mb])
        self.decode_steps += 1
        if not self.last:
            return ("d", mb, y, lens, greedy)
        logits = y[:, -1]
        if greedy:
            toks = torch.argmax(logits, dim=-1)
        else:
            toks = _sample(logits, self._keys[mb], self._steps[mb],
                           self._temps[mb], self._topks[mb], self._topps[mb],
                           self.cfg.vocab_size)
            self._steps[mb] += 1
        # The ONE device->host sync per invocation: token ids, not logits,
        # cross back to the driver.
        return ("d", mb, toks.cpu().numpy())

    def _step_prefill(self, msg):
        _k, row, x, plen, samp = msg
        mb, r = divmod(int(row), self.mb_size)
        if self.first:
            x = torch.as_tensor(np.asarray(x, np.int64)).to(self.device)
        lb = x.shape[1]
        positions = torch.arange(lb, device=self.device)[None]
        cache_slice = self.net.new_cache(1, lb)
        y = self.net(x, positions, cache=cache_slice)
        for (big_k, big_v), (k, v) in zip(self._caches[mb], cache_slice):
            big_k[r, :lb].copy_(k[0])
            big_v[r, :lb].copy_(v[0])
        if not self.last:
            return ("p", row, y, plen, samp)
        key = stream_key(int(samp["seed"]), int(samp["rid"]))

        def col(value, dtype):
            return torch.full((1,), value, dtype=dtype, device=self.device)

        first = _sample(y[0, int(plen) - 1].to(torch.float32)[None],
                        col(key, torch.int64), col(0, torch.int64),
                        col(samp["temperature"], torch.float32),
                        col(samp["top_k"], torch.int64),
                        col(samp["top_p"], torch.float32),
                        self.cfg.vocab_size)[0]
        self._keys[mb][r] = key
        self._steps[mb][r] = 1  # token index of the next draw
        self._temps[mb][r] = float(samp["temperature"])
        self._topks[mb][r] = int(samp["top_k"])
        self._topps[mb][r] = float(samp["top_p"])
        return ("p", row, int(first))

    # --------------------------------------------------------------- RPC
    def pid(self) -> int:
        return os.getpid()

    def server_addr(self) -> tuple:
        from ray_tpu_torch._private.worker import global_worker

        return tuple(global_worker().server_addr)

    def join_group(self, world_size: int, rank: int, addrs: dict,
                   group_name: str) -> bool:
        """Join the driver-pushed stage group: no KV rendezvous, no
        polling — the address map was negotiated at engine build time,
        exactly like the DAG's channels."""
        from ray_tpu_torch.util import collective

        collective.init_prenegotiated_group(
            world_size, rank,
            {int(k): tuple(v) for k, v in addrs.items()},
            group_name=group_name, connect=True)
        return True

    def edge_stats(self) -> dict:
        """This stage's device-edge resolve counters, busy time, decode
        invocations, and this process's kernel launch counts and device
        memory (the zero-RPC proof and the launch check read these)."""
        from ray_tpu_torch._private import device_store, kernels

        with _occ_lock:
            ent = _occ.get(self.name, [0.0, 0])
            busy, steps = float(ent[0]), int(ent[1])
        dev = self.device
        return {"stage": self.name, "pid": os.getpid(), "device": str(dev),
                "device_bytes": (torch.cuda.memory_allocated(dev)
                                 if dev.type == "cuda" else 0),
                "layers": list(self.layers),
                "resolve": device_store.resolve_stats(),
                "busy_s": busy, "steps": steps,
                "decode_steps": self.decode_steps,
                "kernel_launches": kernels.launch_counts()}

    def reset_stats(self) -> bool:
        from ray_tpu_torch._private import device_store, kernels

        device_store.reset_resolve_stats()
        kernels.reset_launch_counts()
        self.decode_steps = 0
        with _occ_lock:
            _occ.pop(self.name, None)
        return True


# ------------------------------------------------------------------ engine
class PipelinedEngine:
    """Pipeline-parallel ContinuousEngine drop-in: same submit()/GenStream
    surface, decode executed as compiled-DAG invocations across N stage
    actors (module docstring has the full design). `device` is the stages'
    ("cuda" by default); the driver itself stays on the CPU."""

    def __init__(self, cfg, *, n_stages: int = 2, max_batch: int = 8,
                 microbatch: int = 0, stall_timeout_s: float = 120.0,
                 device="cuda"):
        from ray_tpu_torch.models.transformer import Transformer

        self.cfg = cfg
        self.device = torch.device(device)
        self.n_stages = int(n_stages)
        if self.n_stages < 1:
            raise ValueError(f"n_stages ({n_stages}) must be >= 1")
        mb = int(microbatch) or int(CONFIG.pp_microbatch)
        if mb <= 0:
            # Auto: 2 microbatches per stage keeps every stage busy while
            # its neighbours work (the GPipe occupancy rule of thumb).
            mb = max(1, int(max_batch) // (2 * self.n_stages))
        self.mb_size = mb
        self.n_mb = max(2, -(-int(max_batch) // mb))
        self.max_batch = self.mb_size * self.n_mb
        self._stall_s = float(stall_timeout_s)

        if cfg.params is not None:
            state = _load_params(cfg.params)
        else:
            state = Transformer(model_config(cfg), device="cpu",
                                seed=cfg.seed).state_dict()
        self._splits = stage_layer_split(cfg.n_layers, self.n_stages)
        # Shards ship as numpy (cheap pickles); stage actors place them.
        self._shards = [
            {k: np.asarray(torch.as_tensor(v).detach().cpu())
             for k, v in stage_param_slice(
                 state, layers, s == 0, s == self.n_stages - 1).items()}
            for s, layers in enumerate(self._splits)]
        self._stage_cfg = (dataclasses.replace(cfg, params=None)
                           if cfg.params is not None else cfg)
        del state
        #: decode invocations completed (each steps one microbatch through
        #: every stage)
        self.decode_steps = 0

        # Host scheduler state (mirrors ContinuousEngine's).
        self._lock = threading.Condition()
        self._pending: "queue.Queue" = queue.Queue()
        self._slots: list[Optional[_Slot]] = [None] * self.max_batch
        self._streams: set = set()
        self._req_counter = itertools.count()
        self._n_active = 0
        self._running = True
        self._rebuilds = 0
        self._mb_toks = np.zeros((self.n_mb, self.mb_size), np.int64)
        self._mb_lens = np.zeros((self.n_mb, self.mb_size), np.int64)
        self._mb_active: list[set] = [set() for _ in range(self.n_mb)]
        self._mb_inflight = [False] * self.n_mb
        self._prefilling: dict[int, tuple] = {}  # slot -> (stream, s, plen)
        self._fifo: collections.deque = collections.deque()
        self._dag = None
        self._actors: list = []
        self._group_name: Optional[str] = None
        self._build_graph()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rt-llm-pp")
        self._thread.start()

    # -------------------------------------------------------------- graph
    def _build_graph(self):
        import ray_tpu_torch
        from ray_tpu_torch import dag as _dag
        from ray_tpu_torch.exceptions import DagStageError

        stage_cls = ray_tpu_torch.remote(num_cpus=0)(PipelineStage)
        actors = []
        for s, layers in enumerate(self._splits):
            actors.append(stage_cls.remote(
                self._stage_cfg, s, self.n_stages, tuple(layers),
                s == 0, s == self.n_stages - 1, self._shards[s],
                self.mb_size, self.n_mb, self.device))
        # A stage whose constructor raised (no CUDA, a bad shard) fails
        # the build with its error, named as the DAG names the stage.
        for s, a in enumerate(actors):
            try:
                ray_tpu_torch.get(a.pid.remote(), timeout=300)
            except Exception as e:
                for b in actors:
                    try:
                        ray_tpu_torch.kill(b)
                    except Exception:
                        pass
                raise DagStageError(
                    f"pipeline stage 'step[{s}]' (layers "
                    f"{self._splits[s][0]}-{self._splits[s][-1]}) failed "
                    f"to start: {e}", stage=f"step[{s}]") from e
        # Pre-negotiated stage collective group: the driver gathers every
        # stage's listen address and pushes the full rank->addr map at
        # build time (compile-time wiring, like the DAG's channels) —
        # device_store's peer-conn tier then reuses the established conns.
        try:
            addrs = {s: tuple(ray_tpu_torch.get(a.server_addr.remote(),
                                                timeout=60))
                     for s, a in enumerate(actors)}
            gname = f"pp-{uuid.uuid4().hex[:8]}"
            ray_tpu_torch.get([a.join_group.remote(len(actors), s, addrs,
                                                   gname)
                               for s, a in enumerate(actors)], timeout=60)
            self._group_name = gname
        except Exception:
            logger.exception(
                "pipeline stage-group pre-negotiation failed (stages fall "
                "back to on-demand peer conns)")
        with _dag.InputNode() as inp:
            node = actors[0].step.bind(inp)
            for a in actors[1:]:
                node = a.step.bind(node)
        self._dag = _dag.compile(node)
        self._actors = actors

    def _teardown_graph(self):
        import ray_tpu_torch

        dag, self._dag = self._dag, None
        if dag is not None:
            try:
                dag.teardown()
            except Exception:
                logger.exception("pipeline DAG teardown failed")
        actors, self._actors = self._actors, []
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass

    # -------------------------------------------------------------- public
    def submit(self, prompt_tokens,
               sampling: Optional[SamplingParams] = None) -> GenStream:
        """Queue one request; returns its token stream immediately."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            # an out-of-range id would fault the embedding gather on the card
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size})")
        if len(prompt) + sampling.max_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens "
                f"({sampling.max_tokens}) exceeds max_seq "
                f"({self.cfg.max_seq})")
        stream = GenStream(next(self._req_counter), len(prompt))
        # Atomic vs shutdown's flag flip (see ContinuousEngine.submit).
        with self._lock:
            if not self._running:
                raise RuntimeError("engine is shut down")
            self._streams.add(stream)
            self._pending.put((prompt, sampling, stream))
            self._lock.notify_all()
        return stream

    def generate(self, prompts,
                 sampling: Optional[SamplingParams] = None
                 ) -> list[list[int]]:
        streams = [self.submit(p, sampling) for p in prompts]
        return [s.tokens() for s in streams]

    def shutdown(self):
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._pending.put(None)
        self._thread.join(timeout=20)
        self._teardown_graph()
        self._drain_all_streams()

    @property
    def num_active(self) -> int:
        return self._n_active

    def pipeline_stats(self) -> dict:
        """Aggregated per-stage counters: device-edge pins, resolve tiers
        (the zero-RPC proof: resolve_rpcs stays 0 in steady state), and
        per-stage busy time, decode invocations and kernel launches."""
        import ray_tpu_torch

        per = []
        for a in list(self._actors):
            try:
                per.append(ray_tpu_torch.get(a.edge_stats.remote(),
                                             timeout=30))
            except Exception:
                pass
        agg = {"edge_pins": 0, "store_hits": 0, "tier0": 0,
               "resolve_rpcs": 0, "stages": per}
        for p in per:
            r = p.get("resolve", {})
            agg["edge_pins"] += int(r.get("edge_pins", 0))
            agg["store_hits"] += int(r.get("store_hit", 0))
            agg["tier0"] += int(r.get("tier0", 0))
            agg["resolve_rpcs"] += (int(r.get("export_rpc", 0))
                                    + int(r.get("fetch", 0)))
        return agg

    def reset_pipeline_stats(self) -> None:
        import ray_tpu_torch

        for a in list(self._actors):
            try:
                ray_tpu_torch.get(a.reset_stats.remote(), timeout=30)
            except Exception:
                pass

    # ----------------------------------------------------------- scheduler
    def _bucket(self, plen: int) -> int:
        b = 8
        while b < plen:
            b *= 2
        return min(b, self.cfg.max_seq)

    def _cap(self) -> int:
        # Outstanding invocations stay under the DAG's own inflight bound,
        # so execute() never blocks the scheduler on the semaphore.
        return max(2, min(int(CONFIG.dag_max_inflight), self.n_mb + 2))

    def _loop(self):
        """Scheduler wrapper: an unexpected scheduler death surfaces an
        attributed error on every open stream — never a hang."""
        error: Optional[Exception] = None
        try:
            self._run_scheduler()
        except Exception as e:  # noqa: BLE001 - terminal: loop is dead
            logger.exception("pipelined llm engine scheduler died")
            error = RuntimeError(
                f"pipelined llm engine scheduler died: {e!r}")
        finally:
            with self._lock:
                self._running = False
            self._drain_all_streams(error)
            self._teardown_graph()

    def _run_scheduler(self):
        while self._running:
            self._admit()
            self._issue_decodes()
            if not self._fifo:
                with self._lock:
                    if self._running and self._pending.empty():
                        self._lock.wait(timeout=0.05)
                continue
            # Fulfill strictly in issue order: the DAG is itself FIFO, so
            # the head ref is always the next to complete.
            kind, ref, meta = self._fifo[0]
            try:
                out = self._get_head(ref)
            except Exception as e:
                self._on_graph_failure(e)
                continue
            if out is None:  # shutdown raced the wait
                continue
            self._fifo.popleft()
            self._rebuilds = 0  # a completed invocation resets the budget
            if kind == "p":
                self._on_prefill_done(out, meta)
            else:
                self._on_decode_done(out, meta)

    def _get_head(self, ref):
        """Head-of-line result wait in shutdown-checked slices; a stall
        past the deadline is a graph failure (never-a-hang)."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        deadline = time.monotonic() + self._stall_s
        while True:
            if not self._running:
                return None
            try:
                return ref.get(timeout=0.25)
            except GetTimeoutError:
                if time.monotonic() > deadline:
                    raise

    def _admit(self):
        cap = self._cap()
        while len(self._fifo) < cap:
            free = next(
                (i for i in range(self.max_batch)
                 if self._slots[i] is None and i not in self._prefilling),
                None)
            if free is None:
                break
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            prompt, sampling, stream = item
            if stream.closed:
                stream.finish_reason = "cancelled"
                self._finish_stream(stream)
                continue
            plen = len(prompt)
            lb = self._bucket(plen)
            toks = np.zeros((1, lb), np.int64)
            toks[0, :plen] = prompt
            samp = {"temperature": float(sampling.temperature),
                    "top_k": int(sampling.top_k),
                    "top_p": float(sampling.top_p),
                    "seed": int(sampling.seed),
                    "rid": int(stream.request_id)}
            try:
                ref = self._dag.execute(("p", free, toks, plen, samp),
                                        timeout=30.0)
            except Exception as e:
                # The graph died before this request started: requeue it
                # (it resumes after the rebuild) and run the failure path.
                self._pending.put((prompt, sampling, stream))
                self._on_graph_failure(e)
                return
            self._prefilling[free] = (stream, sampling, plen)
            self._fifo.append(("p", ref, free))

    def _issue_decodes(self):
        cap = self._cap()
        pre_mbs = {s // self.mb_size for s in self._prefilling}
        for mb in range(self.n_mb):
            if len(self._fifo) >= cap:
                break
            # A microbatch with a prefill in flight must not decode: the
            # decode would land at the stages AFTER the prefill and step
            # the fresh row's cache with a stale position.
            if (self._mb_inflight[mb] or not self._mb_active[mb]
                    or mb in pre_mbs):
                continue
            greedy = all(
                self._slots[mb * self.mb_size + r].sampling.temperature
                <= 0.0 for r in self._mb_active[mb])
            msg = ("d", mb, self._mb_toks[mb].copy(),
                   self._mb_lens[mb].copy(), bool(greedy))
            try:
                ref = self._dag.execute(msg, timeout=30.0)
            except Exception as e:
                self._on_graph_failure(e)
                return
            self._mb_inflight[mb] = True
            self._fifo.append(("d", ref, mb))

    def _on_prefill_done(self, out, slot: int):
        stream, sampling, plen = self._prefilling.pop(slot)
        first = int(out[2])
        if stream.closed:
            stream.finish_reason = "cancelled"
            self._finish_stream(stream)
            return
        st = _Slot(stream, sampling)
        self._slots[slot] = st
        self._n_active += 1
        mb, r = divmod(slot, self.mb_size)
        self._mb_toks[mb][r] = first
        self._mb_lens[mb][r] = plen
        self._deliver(slot, [first])
        if self._slots[slot] is not None:
            self._mb_active[mb].add(r)

    def _on_decode_done(self, out, mb: int):
        self._mb_inflight[mb] = False
        self.decode_steps += 1
        toks = np.asarray(out[2]).reshape(-1)
        for r in sorted(self._mb_active[mb]):
            slot = mb * self.mb_size + r
            tok = int(toks[r])
            self._mb_toks[mb][r] = tok
            self._mb_lens[mb][r] += 1
            self._deliver(slot, [tok])

    def _on_graph_failure(self, e: Exception):
        """The failure contract: fail every open stream with the
        ATTRIBUTED error, tear down, rebuild fresh stages, resume from the
        request queue. Consecutive failures beyond RT_PP_REBUILD_MAX kill
        the engine (the wrapper drains with the terminal error)."""
        logger.warning("pipeline graph failure (%s: %s); rebuilding",
                       type(e).__name__, e)
        self._fifo.clear()
        for slot in list(self._prefilling):
            stream, _s, _p = self._prefilling.pop(slot)
            self._finish_stream(stream, e)
        for i, st in enumerate(self._slots):
            if st is not None:
                self._slots[i] = None
                self._n_active -= 1
                self._finish_stream(st.stream, e)
        for mb in range(self.n_mb):
            self._mb_active[mb].clear()
            self._mb_inflight[mb] = False
        self._mb_toks[:] = 0
        self._mb_lens[:] = 0
        self._teardown_graph()
        self._rebuilds += 1
        limit = max(1, int(CONFIG.pp_rebuild_max))
        if self._rebuilds > limit:
            raise RuntimeError(
                f"pipeline graph failed {self._rebuilds} consecutive times "
                f"(RT_PP_REBUILD_MAX={limit}); last: {e!r}") from e
        self._build_graph()

    # ------------------------------------------------------------ delivery
    def _deliver(self, slot: int, toks: list):
        st = self._slots[slot]
        if st is None:
            return
        if st.stream.closed:
            st.stream.finish_reason = "cancelled"
            self._retire(slot)
            return
        out = toks[:max(0, st.remaining)]
        finish = None
        stop = st.sampling.stop_token
        if stop is not None and stop in out:
            out = out[:out.index(stop) + 1]
            finish = "stop"
        st.remaining -= len(out)
        if finish is None and st.remaining <= 0:
            finish = "length"
        if out:
            st.stream._q.put(out)
        if finish is not None:
            st.stream.finish_reason = finish
            self._retire(slot)

    def _retire(self, slot: int):
        st = self._slots[slot]
        self._finish_stream(st.stream)
        self._slots[slot] = None
        self._n_active -= 1
        mb, r = divmod(slot, self.mb_size)
        self._mb_active[mb].discard(r)
        # The retired row's cache is garbage until the next prefill places
        # over it; in-flight decodes step it harmlessly (driver discards).

    def _finish_stream(self, stream: GenStream,
                       error: Optional[Exception] = None):
        if error is not None:
            stream._q.put(error)
        stream._q.put(GenStream._DONE)
        with self._lock:
            self._streams.discard(stream)

    def _drain_all_streams(self, error: Optional[Exception] = None):
        while True:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            _p, _s, stream = item
            self._finish_stream(stream, error)
        with self._lock:
            streams = list(self._streams)
            self._streams.clear()
        for stream in streams:
            if error is not None:
                stream._q.put(error)
            stream._q.put(GenStream._DONE)
