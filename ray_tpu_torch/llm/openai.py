"""OpenAI-compatible serving surface for the port's continuous-batching
engine.

Counterpart: ray_tpu/llm/openai.py. `OpenAIServer.__call__` serves
/v1/models, /v1/completions and /v1/chat/completions (with SSE-style
streaming as a generator of chunk dicts) for any request object with
`.path` and `.json()`; `build_openai_app` deploys it on the port's Serve
(HTTP proxy, router, replica actor). Prompts are strings (byte-level
tokenizer) or raw token lists. `pipeline_stages` > 1 (or RT_PP_STAGES)
serves through the pipelined engine (llm/pipeline.py): stage actors
bound into one compiled DAG, each holding its layers on `device`.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.llm import LLMConfig
from ray_tpu_torch.llm.engine import ContinuousEngine, GenStream, SamplingParams


class ByteTokenizer:
    """Byte-level tokenizer: token = byte value; BOS=256, EOS=257. Needs
    vocab_size >= 258."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        toks = list(text.encode("utf-8"))
        return ([self.BOS] if bos else []) + toks

    def decode(self, tokens) -> str:
        data = bytes(t for t in tokens if 0 <= t < 256)
        return data.decode("utf-8", "replace")


def _sampling_from_body(body: dict, default_max: int) -> SamplingParams:
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        max_tokens=int(body.get("max_tokens", default_max)),
        stop_token=body.get("stop_token"),
        seed=int(body.get("seed", 0)),
    )


class OpenAIServer:
    """Callable serving the OpenAI routes from one local engine. `device`
    defaults to "cuda" and raises without it."""

    def __init__(self, cfg: LLMConfig, model_id: str = "ray-tpu-llm",
                 max_batch: int = 8, decode_chunk: int = 8,
                 default_max_tokens: int = 64,
                 pipeline_stages: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.model_id = model_id
        self.default_max_tokens = default_max_tokens
        self.tok = ByteTokenizer()
        stages = (int(CONFIG.pp_stages) if pipeline_stages is None
                  else int(pipeline_stages))
        # pipeline_stages > 1 swaps in the pipeline-parallel engine; None
        # defers to RT_PP_STAGES. The two engines share the
        # submit()/GenStream surface, so every route is engine-agnostic.
        if stages > 1:
            from ray_tpu_torch.llm.pipeline import PipelinedEngine

            self.engine = PipelinedEngine(
                cfg, n_stages=stages, max_batch=max_batch, device=device)
        else:
            self.engine = ContinuousEngine(
                cfg, max_batch=max_batch, decode_chunk=decode_chunk,
                device=device)

    # ------------------------------------------------------------ helpers
    def _encode_prompt(self, body: dict) -> list[int]:
        if "messages" in body:  # chat form
            text = "".join(
                f"<{m.get('role', 'user')}>{m.get('content', '')}"
                for m in body["messages"])
            return self.tok.encode(text)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            return [int(t) for t in prompt]  # raw token ids
        return self.tok.encode(str(prompt))

    def _completion_body(self, req_id: str, text: str, tokens: list[int],
                         finish: Optional[str], chat: bool,
                         stream_delta: bool = False) -> dict:
        if chat:
            key = "delta" if stream_delta else "message"
            choice = {"index": 0, key: {"role": "assistant", "content": text},
                      "finish_reason": finish}
            obj = ("chat.completion.chunk" if stream_delta
                   else "chat.completion")
        else:
            choice = {"index": 0, "text": text, "finish_reason": finish}
            obj = "text_completion"
        return {"id": req_id, "object": obj, "created": int(time.time()),
                "model": self.model_id, "choices": [choice],
                "token_ids": tokens}

    # ------------------------------------------------------------- routes
    def __call__(self, request):
        path = request.path
        if path.endswith("/v1/models") or path.endswith("/models"):
            return {"object": "list",
                    "data": [{"id": self.model_id, "object": "model",
                              "owned_by": "ray_tpu_torch"}]}
        if path.endswith("/v1/stats") or path.endswith("/stats"):
            # Which process hosts the engine, on which device and with how
            # many bytes allocated there, how many slots are live, its
            # decode steps so far, and this process's kernel launch counts
            # (the replica's, when served through build_openai_app). A
            # pipelined engine's device work is its stages': the replica
            # holds no device memory, and each stage's own counters ride
            # under "pipeline".
            dev = self.engine.device
            stages = getattr(self.engine, "n_stages", 0)
            out = {"pid": os.getpid(), "active": self.engine.num_active,
                   "running": self.engine._running,
                   "device": str(dev),
                   "device_bytes": (torch.cuda.memory_allocated(dev)
                                    if dev.type == "cuda" and not stages
                                    else 0),
                   "decode_steps": self.engine.decode_steps,
                   "kernel_launches": kernels.launch_counts(),
                   "kernel_launches_by_head_dim":
                       kernels.launch_counts_by_head_dim()}
            if stages:
                out["pipeline_stages"] = stages
                out["pipeline"] = self.engine.pipeline_stats()
            return out
        body = request.json() or {}
        chat = "chat" in path or "messages" in body
        prompt = self._encode_prompt(body)
        sampling = _sampling_from_body(body, self.default_max_tokens)
        req_id = f"cmpl-{int(time.time() * 1e6):x}"
        stream = self.engine.submit(prompt, sampling)
        if body.get("stream"):
            return self._stream_chunks(req_id, stream, chat)
        toks = stream.tokens()
        return self._completion_body(
            req_id, self.tok.decode(toks), toks, stream.finish_reason, chat)

    def _stream_chunks(self, req_id: str, stream: GenStream, chat: bool):
        """Generator of OpenAI SSE chunk dicts — one per token batch
        (GenStream.next_batch drains every token available per wakeup)."""
        def gen():
            try:
                while True:
                    try:
                        toks = stream.next_batch()
                    except StopIteration:
                        break
                    yield self._completion_body(
                        req_id, self.tok.decode(toks), toks, None, chat,
                        stream_delta=True)
                yield self._completion_body(
                    req_id, "", [], stream.finish_reason or "length", chat,
                    stream_delta=True)
            finally:
                # Consumer gone: free the engine slot instead of decoding
                # to max_tokens for nobody.
                stream.close()
        return gen()

    def check_health(self):
        if not self.engine._running:
            raise RuntimeError("llm engine stopped")

    def shutdown(self):
        self.engine.shutdown()

    def __del__(self):
        try:
            self.engine.shutdown()
        except Exception:
            pass


def build_openai_app(cfg: LLMConfig, *, name: str = "llm",
                     model_id: str = "ray-tpu-llm", num_replicas: int = 1,
                     max_batch: int = 8, decode_chunk: int = 8,
                     default_max_tokens: int = 64,
                     ray_actor_options: Optional[dict] = None,
                     max_ongoing_requests: int = 16,
                     max_queued_requests: int = -1,
                     queue_deadline_s: Optional[float] = None,
                     pipeline_stages: Optional[int] = None,
                     device="cuda"):
    """Serve application exposing the OpenAI surface (reference
    build_openai_app, application_builders.py). The admission budgets
    pass straight through to the deployment: cap ongoing requests near
    max_batch so excess load sheds fast 429s at the proxy instead of
    stacking onto the engine's queue. Each replica builds its engine on
    `device` ("cuda" by default: give the replica a card with
    `ray_actor_options={"num_gpus": 1}`)."""
    from ray_tpu_torch import serve

    dep = serve.deployment(
        OpenAIServer, name=name, num_replicas=num_replicas,
        ray_actor_options=ray_actor_options,
        max_ongoing_requests=max_ongoing_requests,
        max_queued_requests=max_queued_requests,
        queue_deadline_s=queue_deadline_s)
    return dep.bind(cfg, model_id=model_id, max_batch=max_batch,
                    decode_chunk=decode_chunk,
                    default_max_tokens=default_max_tokens,
                    pipeline_stages=pipeline_stages, device=device)
