"""Continuous-batching LLM engine on PyTorch: the serving core of the port.

Counterpart: ray_tpu/llm/engine.py. The scheduler's contracts are the
reference's; the mechanisms are PyTorch's:

- **Slot KV cache**: preallocated per-layer [max_batch, max_seq, KV, D]
  tensors; each in-flight request owns one slot. A request's bucketed
  prefill fills its own [1, bucket] cache slice, which is copied into row
  `slot` at a chunk boundary (`_splice`); a decode step writes each slot's
  new k/v row in place at its position. Requests join and leave
  independently — no lockstep.
- **Chunked decode**: between admission points the engine runs up to
  `decode_chunk` single-token steps back to back (a Python loop where the
  reference had one lax.scan); on the card every step's attention is the
  decode kernel (ops/decode_attention.py).
- **On-device sampling**: temperature / top-k / top-p / greedy are per-slot
  tensors on the device, so mixed request settings share a batch. The
  random draw is Gumbel-max over a counter-based hash of (seed,
  request_id, token index): a request's draws never depend on its batch
  neighbours. (They cannot match JAX's threefry bits.)
- **Pipelined hot loop**: up to `pipeline_depth` chunks stay in flight,
  chained on the device through device-resident mirrors (next token,
  lengths, sampling params). Each chunk's token block is copied into a
  pinned host buffer with `non_blocking=True` at dispatch, with a CUDA
  event the drain waits on; the drain reads one chunk per iteration while
  younger chunks execute, and reads at once tokens already on the host
  (dispatch itself costs host time per step here, unlike one lax.scan
  call). Prefill runs on its own lane thread.
- **One stream**: the prefill lane and the decode loop issue work on the
  same CUDA stream, so device program order keeps a splice after its
  prefill and a slot's reuse after every chunk that stepped it.
- **Tensor parallelism** (`mesh=`, parallel/mesh.py): every rank of the
  mesh constructs the engine; each holds its shards of the weights
  (`param_specs`) and its kv heads of the slot caches (`n_kv_heads / tp`,
  the decode kernel runs at the per-rank head counts). Rank 0 owns the
  scheduler, the streams and the sampler's host side, with the prefill
  lane off so all device work issues from one thread. Before each unit it
  dispatches (an admission: prefill and splice; a decode chunk) it
  broadcasts a small plan (slot, prompt, sampling settings, request id;
  chunk length), and the other ranks, in `follow()`, run the same unit
  on their shards, so every rank issues the same collectives in the same
  order. The logits are gathered over tp, so every rank samples the same
  tokens from the same `(seed, request_id, index)` keys and the
  device-resident mirrors stay equal. Replicas over dp follow the same
  plans.
- **Tracing** (RT_TRACING): as the reference's, each request captures its
  trace context at submit, and the scheduler records `engine.prefill`,
  `engine.dispatch_chunk` and `engine.host_sync` spans against the oldest
  traced request in flight; each traced host sync is also observed in
  `DECODE_STEP_SECONDS`. Off, it issues no other device work. The same
  three names mark the device work of a prefill, a chunk's dispatch and
  the host-sync reads in a torch profiler's trace (`tracing.device_span`),
  beside the kernels: a replica's `profile --mode torch` capture records
  every thread, the scheduler's included.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.parallel.collectives import broadcast_object

logger = logging.getLogger(__name__)

#: Cumulative tokens delivered to GenStream consumers across every engine
#: in this process: the source of the `llm.tokens_per_s` telemetry series
#: (telemetry.WorkerSampler reads the per-tick rate through
#: tokens_per_s_snapshot, only where this module is imported).
_tok_lock = threading.Lock()
_tok_count = 0
_tok_rate_state: list = [None, 0]  # [last snapshot monotonic, last count]


def _count_tokens(n: int) -> None:
    global _tok_count
    with _tok_lock:
        _tok_count += n


def tokens_per_s_snapshot() -> float:
    """Tokens delivered per second since the previous snapshot (the
    telemetry tick); the first call anchors the window and reports 0."""
    with _tok_lock:
        c = _tok_count
    now = time.monotonic()
    t0, c0 = _tok_rate_state
    _tok_rate_state[0], _tok_rate_state[1] = now, c
    if t0 is None or now <= t0:
        return 0.0
    return (c - c0) / (now - t0)


@dataclass
class SamplingParams:
    """reference vllm SamplingParams subset (the fields the serve layer
    forwards; vllm_engine.py maps OpenAI body fields onto these)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    max_tokens: int = 16
    stop_token: Optional[int] = None
    seed: int = 0


class GenStream:
    """Host-side token stream of one request: iterate to receive token ids
    as the engine emits them; ends with StopIteration (or raises the
    engine's error).

    Delivery is BATCHED: the engine enqueues one token-id list per decode
    chunk, so a blocked reader wakes once per chunk. `next_batch()` drains
    every token currently available in one call; `__next__`/`next()` keep
    the one-token-at-a-time surface on top of the same queue."""

    _DONE = object()

    def __init__(self, request_id: int, prompt_len: int):
        self.request_id = request_id
        self.prompt_len = prompt_len
        self._q: "queue.Queue" = queue.Queue()
        self._buf: collections.deque = collections.deque()
        self._exc: Optional[Exception] = None  # deferred: tokens first
        self.finish_reason: Optional[str] = None
        self.closed = False
        # Trace context captured at submit: the scheduler thread parents
        # its spans (prefill, chunk dispatch, host-sync readback) to the
        # submitting request's trace.
        self.trace: Optional[tuple] = None

    def close(self):
        """Consumer abandoned the request (client disconnect): the engine
        retires the slot at its next emit instead of decoding the full
        max_tokens for nobody."""
        self.closed = True

    def __iter__(self):
        return self

    def _pop(self, timeout: Optional[float] = None):
        """One token; blocks on the batch queue. Raises StopIteration at
        end of stream, queue.Empty on timeout, or the engine's error."""
        while True:
            if self._buf:
                return self._buf.popleft()
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            item = self._q.get(timeout=timeout)
            if item is GenStream._DONE:
                self._q.put(GenStream._DONE)  # idempotent re-next
                raise StopIteration
            if isinstance(item, Exception):
                raise item
            if isinstance(item, list):
                self._buf.extend(item)
            else:
                return item

    def __next__(self):
        return self._pop()

    def next(self, timeout: Optional[float] = None):
        try:
            return self._pop(timeout=timeout)
        except queue.Empty:
            raise GetTimeoutError(
                f"request {self.request_id} yielded no token within "
                f"{timeout}s") from None

    def next_batch(self, timeout: Optional[float] = None) -> list[int]:
        """Every token currently available, blocking only for the first.
        Raises StopIteration at end of stream and GetTimeoutError when
        nothing arrives in time."""
        out = [self.next(timeout=timeout)]
        while True:
            if self._buf:
                out.append(self._buf.popleft())
                continue
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return out
            if item is GenStream._DONE:
                self._q.put(GenStream._DONE)  # next call raises Stop
                return out
            if isinstance(item, Exception):
                self._exc = item  # tokens in hand first; raise next call
                return out
            if isinstance(item, list):
                self._buf.extend(item)
            else:
                out.append(item)

    def tokens(self) -> list[int]:
        """Drain the stream to completion."""
        return list(self)


# ------------------------------------------------------------ sampling
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 32-bit values held in int64 tensors (or Python
    ints), split so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """lowbias32 integer hash of 32-bit values (int64 tensors or ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_key(seed: int, request_id: int) -> int:
    """A request's 32-bit sampling key, from its seed and id only."""
    return _hash32(_hash32(seed & _M32) ^ (request_id & _M32))


def _gumbel(keys, steps, vocab: int):
    """Gumbel noise [B, vocab] (f32): slot b's row is a function of
    (keys[b], steps[b]) only."""
    ctr = _hash32(keys ^ _hash32(steps & _M32))
    idx = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    bits = _hash32((ctr[:, None] + idx[None, :]) & _M32)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def _mask_logits(logits, temp, top_k, top_p, vocab: int):
    """Temperature, then top-k and top-p masking to -inf, line for line as
    the reference's sampler (engine.py, _make_sampler). temp <= 0 is
    greedy (handled by the caller); top_k <= 0 and top_p >= 1 disable."""
    lt = logits / torch.clamp(temp, min=1e-6)[:, None]
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, vocab), 1, vocab)
    kth = torch.gather(sorted_lt, -1, (k_eff - 1)[:, None].to(torch.int64))
    lt = torch.where(lt < kth, float("-inf"), lt)
    probs = torch.softmax(lt, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    # smallest prefix whose mass reaches top_p (always keeps the top
    # token: csum - sp is 0 for it). top_p >= 1 keeps every token exactly:
    # in float, the prefix sums of probabilities that add up to slightly
    # over 1 can otherwise reach 1 before the tail and drop it.
    keep = ((csum - sp) < top_p[:, None]) | (top_p[:, None] >= 1.0)
    min_keep = torch.min(torch.where(keep, sp, float("inf")), dim=-1,
                         keepdim=True).values
    return torch.where(probs < min_keep, float("-inf"), lt)


def _sample(logits, keys, steps, temp, top_k, top_p, vocab: int):
    """logits [B, V] f32; keys/steps [B] int64; temp/top_p [B] f32; top_k
    [B] int. Returns [B] int64 token ids."""
    greedy = torch.argmax(logits, dim=-1)
    lt = _mask_logits(logits, temp, top_k, top_p, vocab)
    sampled = torch.argmax(lt + _gumbel(keys, steps, vocab), dim=-1)
    return torch.where(temp <= 0.0, greedy, sampled)


class _Slot:
    __slots__ = ("stream", "sampling", "remaining")

    def __init__(self, stream: GenStream, sampling: SamplingParams):
        self.stream = stream
        self.sampling = sampling
        self.remaining = sampling.max_tokens


class _HostCopy:
    """A device tensor's copy into host memory, started now and awaited
    at `numpy()`: on CUDA a pinned buffer filled with non_blocking=True and
    an event recorded after the copy on the current stream."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def ready(self) -> bool:
        """True when numpy() will not wait."""
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# ------------------------------------------------------- stage slicing
def model_config(cfg):
    """LLMConfig -> TransformerConfig, the single place the serving model
    shape is derived."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_heads, d_ff=int(cfg.d_model * 8 / 3) // 8 * 8,
        max_seq=cfg.max_seq, dtype=getattr(torch, cfg.dtype))


def stage_layer_split(n_layers: int, n_stages: int) -> list[tuple[int, ...]]:
    """Contiguous, balanced layer ranges, one per pipeline stage (the
    remainder layers go to the EARLIEST stages: the last stage already
    carries final_norm + the tied head + the sampler)."""
    if not (1 <= n_stages <= n_layers):
        raise ValueError(
            f"n_stages ({n_stages}) must be in [1, n_layers ({n_layers})]")
    base, rem = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        n = base + (1 if s < rem else 0)
        out.append(tuple(range(start, start + n)))
        start += n
    return out


def stage_param_slice(state_dict: dict, layers: tuple, first: bool,
                      last: bool) -> dict:
    """This stage's shard of a full Transformer state_dict. Layer keys keep
    their GLOBAL names (`layers.{i}.`) so a shard is a strict subset of the
    full checkpoint; the embedding rides along on the first stage (embed)
    and the last (tied output head)."""
    prefixes = tuple(f"layers.{i}." for i in layers)
    out = {}
    for key, value in state_dict.items():
        if key == "tok_emb":
            keep = first or last
        elif key.startswith("final_norm."):
            keep = last
        else:
            keep = key.startswith(prefixes)
        if keep:
            out[key] = value
    return out


def make_stage_net(mcfg, layers: tuple, first: bool, last: bool, *,
                   device="cuda"):
    """nn.Module computing one pipeline stage's slice of the Transformer:
    embed (first stage) -> layers[a:b] -> final_norm + tied head (last
    stage). Its layers sit in a ModuleDict keyed by their GLOBAL index, so
    its state_dict keys are the full model's (`layers.{i}.`) and
    stage_param_slice's output loads into it with strict=True; a 1-stage
    net computes exactly what the full Transformer computes. Parameters
    are left uninitialised: load a shard before use."""
    from ray_tpu_torch.models.transformer import Block, RMSNorm, _param

    dev = resolve_device(device)

    class _StageNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cfg = mcfg
            self.device = dev
            self.first, self.last = bool(first), bool(last)
            if first or last:
                self.tok_emb = _param((mcfg.vocab_size, mcfg.d_model),
                                      mcfg.param_dtype, dev)
            self.layers = torch.nn.ModuleDict(
                {str(i): Block(mcfg, device=dev) for i in layers})
            if last:
                self.final_norm = RMSNorm(mcfg.d_model, device=dev)

        def new_cache(self, batch: int, length: int | None = None):
            """Zeroed slot caches of this stage's layers, in their order:
            a list of (k, v), each [batch, length or max_seq, KV, D]."""
            shape = (batch, length or mcfg.max_seq, mcfg.n_kv_heads,
                     mcfg.head_dim)
            return [(torch.zeros(shape, dtype=mcfg.dtype, device=dev),
                     torch.zeros(shape, dtype=mcfg.dtype, device=dev))
                    for _ in self.layers]

        def forward(self, x, positions, cache=None):
            """First stage: token ids [B, S]; later stages: the activation
            [B, S, d_model]. Returns the activation, or f32 logits
            [B, S, vocab] on the last stage. `cache` is new_cache's list."""
            if self.first:
                x = self.tok_emb[x].to(mcfg.dtype)
            for j, block in enumerate(self.layers.values()):
                x = block(x, positions,
                          cache=None if cache is None else cache[j])
            if not self.last:
                return x
            x = self.final_norm(x)
            return torch.matmul(
                x, self.tok_emb.to(mcfg.dtype).t()).to(torch.float32)

    return _StageNet()


def _load_params(params) -> dict:
    """LLMConfig.params -> the port's state_dict: a flax tree (nested
    dicts of arrays) is converted, a state_dict passes through."""
    tree = params.get("params", params)
    if any(isinstance(v, dict) for v in tree.values()):
        from ray_tpu_torch.models.convert import params_from_flax

        return params_from_flax(tree)
    return dict(params)


class ContinuousEngine:
    """In-flight-batching engine over the flagship Transformer.

    `device` defaults to "cuda" (raises without CUDA); the tests pass
    "cpu", where attention runs the plain PyTorch versions. With `mesh`
    (tensor parallelism over its tp axis), every rank constructs the
    engine; `submit`, `generate` and `shutdown` are rank 0's, and every
    other rank calls `follow()`, which runs rank 0's plans until rank 0's
    engine shuts down."""

    def __init__(self, cfg, *, max_batch: int = 8, decode_chunk: int = 8,
                 pipeline_depth: int = 4, mesh=None, device="cuda"):
        from ray_tpu_torch.models.transformer import Transformer, param_specs
        from ray_tpu_torch.parallel.mesh import shard_params

        if mesh is not None and (mesh.size("sp") > 1 or mesh.size("pp") > 1):
            raise ValueError(f"the engine shards over tp only, not {mesh}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.decode_chunk = decode_chunk
        self.pipeline_depth = max(1, pipeline_depth)
        self.mesh = mesh
        self._leader = mesh is None or mesh.rank == 0
        mcfg = model_config(cfg)
        self.model = Transformer(mcfg, device=self.device, seed=cfg.seed,
                                 mesh=mesh)
        if cfg.params is not None:
            state = _load_params(cfg.params)
            if mesh is not None:
                state = shard_params(state, param_specs(state), mesh)
            self.model.load_state_dict(state)
        if mcfg.dtype == torch.bfloat16:
            # Inference needs no f32 master weights: cast once so every
            # decode step reads half the bytes.
            self.model.to(torch.bfloat16)
        self.model.eval()
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        #: single-token decode steps dispatched (each runs every layer once)
        self.decode_steps = 0

        # Host scheduler state.
        self._lock = threading.Condition()
        self._pending: "queue.Queue" = queue.Queue()
        self._slots: list[Optional[_Slot]] = [None] * max_batch
        self._lengths = np.zeros(max_batch, np.int64)  # next write position
        # Device-resident mirrors: steady-state chunk dispatch transfers
        # nothing host->device (slot updates are device-side fills).
        dev = self.device
        self._temps_dev = torch.zeros(max_batch, dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._topps_dev = torch.ones(max_batch, dtype=torch.float32, device=dev)
        self._keys_dev = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._steps_dev = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._toks_dev = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._lens_dev = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._cache = None  # created lazily at first admit
        self._req_counter = itertools.count()
        self._n_active = 0
        # Pipelining state: FIFO of dispatched-but-unread chunks, per-slot
        # counts of dispatched-but-unemitted tokens, and slots that must
        # not be re-admitted until every in-flight chunk stepping them
        # lands.
        self._q_chunks: list = []  # [(_HostCopy, active, n, tag), ...]
        self._pending_firsts: list = []  # [(slot, _HostCopy), ...]
        self._pending_toks = np.zeros(max_batch, np.int64)
        self._cooling: dict[int, Any] = {}
        # Every GenStream not yet _DONE, independent of slot state: the
        # scheduler-death safety net terminates these with an attributed
        # error even when the slot table itself is the casualty.
        self._streams: set = set()
        self._running = True
        # Prefill lane: admissions prefill on their own thread and splice
        # at chunk boundaries via _ready. Off = inline admission (always
        # under a mesh: one thread issues the collectives).
        self._prefill_lane = bool(CONFIG.llm_prefill_lane) and mesh is None
        self._ready: collections.deque = collections.deque()
        self._threads = []
        if not self._leader:
            return  # the caller's thread runs follow()
        if self._prefill_lane:
            t = threading.Thread(target=self._prefill_loop, daemon=True,
                                 name="rt-llm-prefill")
            t.start()
            self._threads.append(t)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rt-llm-engine")
        self._thread.start()
        self._threads.append(self._thread)

    @contextlib.contextmanager
    def _device_scope(self):
        """No autograd, and the engine's one stream (both are per thread)."""
        with torch.no_grad(), (torch.cuda.stream(self._stream)
                               if self._stream is not None
                               else contextlib.nullcontext()):
            yield

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned
        staging, non_blocking)."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -------------------------------------------------------------- public
    def submit(self, prompt_tokens, sampling: Optional[SamplingParams] = None
               ) -> GenStream:
        """Queue one request; returns its token stream immediately."""
        if not self._leader:
            raise RuntimeError("requests go to the engine of the mesh's "
                               "rank 0")
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
                f"prompt ({len(prompt)}) + max_tokens ({sampling.max_tokens}) "
                f"exceeds max_seq ({self.cfg.max_seq})")
        stream = GenStream(next(self._req_counter), len(prompt))
        if _tracing.enabled():
            stream.trace = _tracing.current()
        # The _running check and the enqueue must be ONE atomic step
        # against shutdown()'s flag flip, or a stream could be queued after
        # the scheduler's final drain and never see _DONE.
        with self._lock:
            if not self._running:
                raise RuntimeError("engine is shut down")
            self._streams.add(stream)
            self._pending.put((prompt, sampling, stream))
            self._lock.notify_all()
        return stream

    def generate(self, prompts, sampling: Optional[SamplingParams] = None
                 ) -> list[list[int]]:
        """Batch convenience: submit all, drain all."""
        streams = [self.submit(p, sampling) for p in prompts]
        return [s.tokens() for s in streams]

    def shutdown(self):
        if not self._leader:
            raise RuntimeError("a follower rank's engine stops with rank 0's: "
                               "call follow()")
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._pending.put(None)  # wake the prefill lane past its get()
        for t in self._threads:
            t.join(timeout=10)
        # If a join timed out (thread wedged in a device call), queued
        # streams would hang their consumers: terminate them here. Done
        # markers are idempotent.
        self._drain_all_streams()

    def _drain_all_streams(self, error: Optional[Exception] = None):
        """Terminate every stream that has not seen _DONE: queued, ready,
        slotted, or otherwise tracked. The error, when given, lands before
        the marker."""
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

    def _finish_stream(self, stream: GenStream,
                       error: Optional[Exception] = None):
        if error is not None:
            stream._q.put(error)
        stream._q.put(GenStream._DONE)
        with self._lock:
            self._streams.discard(stream)

    @property
    def num_active(self) -> int:
        return self._n_active

    # ----------------------------------------------------------- scheduler
    def _bucket(self, plen: int) -> int:
        b = 8
        while b < plen:
            b *= 2
        return min(b, self.cfg.max_seq)

    def _prefill_dispatch(self, prompt, sampling, stream):
        """Issue the bucketed prefill and the first token's sample, and
        start the first token's host copy, without waiting on the device:
        returns (first_token_copy, cache_slice, key, first_token_dev).
        Touches no scheduler state, so it runs on the lane thread."""
        t_adm = time.time()
        cache_slice, key, first = self._prefill(prompt, sampling,
                                                stream.request_id)
        _tracing.record_span_in(
            stream.trace, "engine.prefill", "engine", t_adm, time.time(),
            {"prompt_len": len(prompt)})
        return _HostCopy(first[None]), cache_slice, key, first

    def _prefill(self, prompt, sampling, request_id: int):
        """The device work of an admission: the bucketed prefill into a
        fresh cache slice and the first token's sample. Returns
        (cache_slice, key, first_token_dev)."""
        plen = len(prompt)
        lb = self._bucket(plen)
        toks = np.zeros((1, lb), np.int64)
        toks[0, :plen] = prompt
        key = stream_key(sampling.seed, request_id)

        def col(value, dtype):
            return torch.full((1,), value, dtype=dtype, device=self.device)

        with _tracing.device_span("engine.prefill"):
            toks_dev = self._to_device(toks)
            positions = torch.arange(lb, device=self.device)[None]
            cache_slice = self.model.new_cache(1, lb)
            logits = self.model(toks_dev, positions=positions,
                                cache=cache_slice)
            last = logits[0, plen - 1].to(torch.float32)[None]
            first = _sample(last, col(key, torch.int64), col(0, torch.int64),
                            col(sampling.temperature, torch.float32),
                            col(sampling.top_k, torch.int64),
                            col(sampling.top_p, torch.float32),
                            self.cfg.vocab_size)[0]
        return cache_slice, key, first

    def _prefill_loop(self):
        """The prefill lane: drains submits, dispatches their prefills,
        and parks the device-resident results in _ready for the scheduler
        to splice at the next chunk boundary."""
        with self._device_scope():
            while True:
                try:
                    item = self._pending.get(timeout=0.25)
                except queue.Empty:
                    if not self._running:
                        return
                    continue
                if item is None:  # shutdown wakeup
                    if not self._running:
                        return
                    continue
                prompt, sampling, stream = item
                if not self._running:
                    # Shutdown raced the pop: terminate the stream instead
                    # of dispatching a prefill nobody will consume.
                    self._finish_stream(stream)
                    continue
                if stream.closed:
                    stream.finish_reason = "cancelled"
                    self._finish_stream(stream)
                    continue
                try:
                    entry = (len(prompt), sampling, stream,
                             *self._prefill_dispatch(prompt, sampling, stream))
                except Exception as e:  # bad request or device failure
                    self._finish_stream(stream, e)
                    continue
                with self._lock:
                    self._ready.append(entry)
                    self._lock.notify_all()

    def _splice(self, slot: int, plen: int, sampling, stream, first_copy,
                cache_slice, key, first):
        """Install one prefilled request into batch row `slot` (scheduler
        thread only — the chunk-boundary splice point): copy the cache
        slice into the slot, set the device mirrors, book the slot."""
        self._install(slot, plen, sampling, cache_slice, key, first)
        st = _Slot(stream, sampling)
        self._slots[slot] = st
        self._n_active += 1
        self._lengths[slot] = plen
        self._pending_toks[slot] = 0
        self._pending_firsts.append((slot, first_copy))

    def _install(self, slot: int, plen: int, sampling, cache_slice, key,
                 first):
        """The device side of a splice: the cache slice into row `slot`,
        and the slot's device mirrors."""
        if self._cache is None:
            self._cache = self.model.new_cache(self.max_batch)
        lb = cache_slice[0][0].shape[1]
        for (big_k, big_v), (k, v) in zip(self._cache, cache_slice):
            big_k[slot, :lb].copy_(k[0])
            big_v[slot, :lb].copy_(v[0])
        self._temps_dev[slot] = sampling.temperature
        self._topks_dev[slot] = sampling.top_k
        self._topps_dev[slot] = sampling.top_p
        self._keys_dev[slot] = key
        self._steps_dev[slot] = 1  # token index of the next draw
        self._toks_dev[slot] = first
        self._lens_dev[slot] = plen

    def _admit_async(self, slot: int, prompt, sampling, stream):
        """Inline admission (prefill lane off): prefill, first-token sample
        and splice for one slot, without reading the result back."""
        self._plan(("admit", slot, prompt, sampling, stream.request_id))
        self._splice(slot, len(prompt), sampling, stream,
                     *self._prefill_dispatch(prompt, sampling, stream))

    # ------------------------------------------------- tensor parallelism
    def _plan(self, plan: tuple):
        """Leader: send the next unit of device work to the other ranks."""
        if self.mesh is not None:
            broadcast_object(plan, self.mesh)

    def follow(self):
        """A follower rank's serving loop, in the caller's thread: run each
        unit rank 0 plans, on this rank's shards, until rank 0's engine
        shuts down. Raises what a unit raised."""
        if self._leader:
            raise RuntimeError("rank 0's engine schedules; only the other "
                               "ranks of its mesh follow it")
        with self._device_scope():
            while True:
                plan = broadcast_object(None, self.mesh)
                if plan[0] == "stop":
                    return
                if plan[0] == "admit":
                    _op, slot, prompt, sampling, request_id = plan
                    self._install(slot, len(prompt), sampling,
                                  *self._prefill(prompt, sampling, request_id))
                else:
                    _op, n, greedy = plan
                    self._decode_chunk(n, greedy)

    def _decode_chunk(self, n: int, greedy: bool) -> torch.Tensor:
        """n single-token steps for every slot; returns tokens [B, n]. The
        device mirrors chain the steps, so nothing is read back. greedy
        skips the sampler's two full-vocab sorts when no active slot
        samples."""
        out = torch.empty((self.max_batch, n), dtype=torch.int64,
                          device=self.device)
        toks, lens = self._toks_dev, self._lens_dev
        last_pos = self.cfg.max_seq - 1
        with _tracing.device_span("engine.dispatch_chunk"):
            for j in range(n):
                # Retired slots keep stepping garbage; clamping keeps their
                # writes inside the cache (active slots never reach
                # max_seq).
                pos = torch.clamp(lens, max=last_pos)[:, None]
                logits = self.model(toks[:, None], positions=pos,
                                    cache=self._cache)[:, -1]
                if greedy:
                    toks = torch.argmax(logits, dim=-1)
                else:
                    toks = _sample(logits, self._keys_dev, self._steps_dev,
                                   self._temps_dev, self._topks_dev,
                                   self._topps_dev, self.cfg.vocab_size)
                    self._steps_dev += 1
                out[:, j] = toks
                lens = lens + 1
        self._toks_dev, self._lens_dev = toks, lens
        self.decode_steps += n
        return out

    def _ready_copies(self):
        """The host copies the next drain reads: the oldest in-flight
        chunk's and the pending first tokens'."""
        if self._q_chunks:
            yield self._q_chunks[0][0]
        for _slot, copy in self._pending_firsts:
            yield copy

    def _free_slot(self) -> Optional[int]:
        return next((i for i, s in enumerate(self._slots)
                     if s is None and i not in self._cooling), None)

    def _deliver(self, slot: int, toks: list):
        """Hand one chunk's tokens for `slot` to its stream as ONE queue
        put, applying stop-token / length truncation host-side."""
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
            _count_tokens(len(out))
        if finish is not None:
            st.stream.finish_reason = finish
            self._retire(slot)

    def _retire(self, slot: int):
        st = self._slots[slot]
        self._finish_stream(st.stream)
        self._slots[slot] = None
        self._n_active -= 1
        self._lengths[slot] = 0
        # (device-side sampling mirrors keep stale values for retired
        # slots; the slot decodes garbage that deliver discards)
        if self._q_chunks and slot in self._q_chunks[-1][1]:
            # Already-dispatched chunks still step this slot; it must not
            # be re-admitted until the NEWEST of them is emitted (stream
            # order makes the cache safe — this guards only the host-side
            # slot bookkeeping).
            self._cooling[slot] = self._q_chunks[-1][3]

    def _loop(self):
        """Scheduler wrapper: an unexpected scheduler death must surface
        an attributed error on EVERY open stream (queued, ready, or
        decoding). Normal exit drains the same way without the error."""
        error: Optional[Exception] = None
        try:
            with self._device_scope():
                self._run_scheduler()
        except Exception as e:  # noqa: BLE001 - terminal: loop is dead
            logger.exception("llm engine scheduler loop died")
            error = RuntimeError(f"llm engine scheduler died: {e!r}")
        finally:
            with self._lock:
                self._running = False
            try:
                self._plan(("stop",))
            except Exception:  # noqa: BLE001 - the followers' group failed
                logger.exception("llm engine could not stop its followers")
            self._drain_all_streams(error)

    def _run_scheduler(self):
        """Scheduler with depth-D software pipelining: up to
        `pipeline_depth` decode chunks stay in flight with their inputs
        chained on the device; each chunk's tokens start their host copy at
        dispatch and are read one chunk per iteration, while the younger
        chunks execute. The host only avoids re-admitting a slot that an
        in-flight chunk still steps (the _cooling set)."""
        while self._running:
            # ---- 1. admissions: splice prefilled requests at the chunk
            # boundary (prefill lane), or admit inline (lane off). Nothing
            # here waits on the device.
            if self._prefill_lane:
                while self._n_active < self.max_batch:
                    free = self._free_slot()
                    if free is None:
                        break
                    with self._lock:
                        if not self._ready:
                            break
                        entry = self._ready.popleft()
                    plen, sampling, stream = entry[:3]
                    if stream.closed:
                        stream.finish_reason = "cancelled"
                        self._finish_stream(stream)
                        continue
                    try:
                        self._splice(free, *entry)
                    except Exception as e:
                        self._finish_stream(stream, e)
            else:
                while self._n_active < self.max_batch:
                    free = self._free_slot()
                    if free is None:
                        break
                    try:
                        item = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:
                        continue
                    prompt, sampling, stream = item
                    try:
                        self._admit_async(free, prompt, sampling, stream)
                    except Exception as e:  # bad request or engine failure
                        self._finish_stream(stream, e)
            # First tokens are NOT read at admission: they join the next
            # drain. Idle: sleep until a submit or a finished prefill
            # notifies (a busy loop here would starve the lane thread of
            # the interpreter lock between its eager ops).
            if (self._n_active == 0 and not self._q_chunks
                    and not self._pending_firsts):
                with self._lock:
                    if self._running and not self._ready and (
                            self._prefill_lane or self._pending.empty()):
                        self._lock.wait(timeout=0.1)
                continue
            # ---- 2. fill the pipeline: dispatch up to pipeline_depth
            # chunks back to back (dispatch is asynchronous; only the
            # readback waits)
            while len(self._q_chunks) < self.pipeline_depth:
                if (self._prefill_lane and self._ready
                        and self._n_active < self.max_batch
                        and self._free_slot() is not None):
                    # A prefilled request waits and a slot is open: splice
                    # at this chunk boundary instead of queueing more of
                    # the old batch — join latency stays a few tokens.
                    break
                if any(c.ready() for c in self._ready_copies()):
                    # Tokens already on the host: deliver them now. Here a
                    # chunk's dispatch costs host time per step (eager
                    # launches), so filling the whole pipeline first would
                    # hold back first tokens by depth * chunk steps.
                    break
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                if not active:
                    break
                budget = int(min(
                    min(self._slots[i].remaining - self._pending_toks[i]
                        for i in active),
                    min(self.cfg.max_seq - int(self._lengths[i])
                        for i in active)))
                if budget < 1:
                    break  # every active slot's fate is already in flight
                # Any chunk length up to decode_chunk: eager PyTorch has no
                # per-length compile (the reference's power-of-2 rule).
                n = min(self.decode_chunk, budget)
                greedy = all(
                    self._slots[i].sampling.temperature <= 0.0
                    for i in active)
                # Bind the chunk's span to the oldest active traced
                # request: with one request, every dispatch and host sync
                # lands in its timeline.
                tctx = next((self._slots[i].stream.trace for i in active
                             if self._slots[i].stream.trace is not None),
                            None)
                try:
                    t_disp = time.time()
                    self._plan(("chunk", n, greedy))
                    toks_out = self._decode_chunk(n, greedy)
                    copy = _HostCopy(toks_out)
                    _tracing.record_span_in(
                        tctx, "engine.dispatch_chunk", "engine", t_disp,
                        time.time(), {"tokens": n, "active": len(active)})
                    # Mirror lengths on host (every slot steps n times —
                    # deterministic, no read needed).
                    self._lengths = self._lengths + n
                    for i in active:
                        self._pending_toks[i] += n
                    self._q_chunks.append((copy, active, n, object()))
                except Exception as e:
                    logger.exception("llm engine decode chunk failed")
                    for i in active:
                        self._slots[i].stream._q.put(e)
                        self._retire(i)
                    break
            # ---- 3. drain: read the OLDEST in-flight chunk (plus any
            # admission wave's first tokens), leaving the younger chunks
            # executing.
            if self._q_chunks or self._pending_firsts:
                q = self._q_chunks[:1]
                del self._q_chunks[:1]
                firsts, self._pending_firsts = self._pending_firsts, []
                # The host-sync readback, once per chunk: span it against
                # the oldest traced request in the drained set, and observe
                # the decode-step histogram.
                sync_ctx = None
                if _tracing.enabled():
                    sync_ctx = next(
                        (self._slots[i].stream.trace
                         for _c, p_active, _n, _tag in q for i in p_active
                         if self._slots[i] is not None
                         and self._slots[i].stream.trace is not None),
                        None)
                    if sync_ctx is None:
                        sync_ctx = next(
                            (self._slots[s].stream.trace
                             for s, _c in firsts
                             if self._slots[s] is not None
                             and self._slots[s].stream.trace is not None),
                            None)
                t_sync = time.time()
                try:
                    with _tracing.device_span("engine.host_sync"):
                        first_vals = [(slot, int(c.numpy()[0]))
                                      for slot, c in firsts]
                        chunk_vals = [(c.numpy(), p_active, pn)
                                      for c, p_active, pn, _tag in q]
                except Exception as e:
                    for slot, _c in firsts:
                        if self._slots[slot] is not None:
                            self._slots[slot].stream._q.put(e)
                            self._retire(slot)
                    for _c, p_active, _n, _tag in q:
                        for i in p_active:
                            if self._slots[i] is not None:
                                self._slots[i].stream._q.put(e)
                                self._retire(i)
                    first_vals, chunk_vals = [], []
                else:
                    if sync_ctx is not None:
                        t_end = time.time()
                        _tracing.record_span_in(
                            sync_ctx, "engine.host_sync", "engine", t_sync,
                            t_end, {"chunks": len(q),
                                    "cols": int(bool(firsts)) + sum(
                                        pn for _v, _a, pn in chunk_vals)})
                        from ray_tpu_torch.util import metrics as _metrics

                        _metrics.DECODE_STEP_SECONDS.observe(t_end - t_sync)
                for slot, tok in first_vals:
                    if self._slots[slot] is not None:  # else retired
                        self._deliver(slot, [tok])
                for vals, p_active, pn in chunk_vals:
                    for i in p_active:
                        self._pending_toks[i] = max(
                            0, self._pending_toks[i] - pn)
                        if self._slots[i] is not None:  # else tail garbage
                            self._deliver(i, [int(t) for t in vals[i]])
                for _c, _a, _n, tag in q:
                    self._cooling = {s: t for s, t in self._cooling.items()
                                     if t is not tag}
