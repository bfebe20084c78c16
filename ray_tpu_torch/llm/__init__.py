"""ray_tpu_torch.llm — LLM batch inference and serving on the port.

Counterpart: ray_tpu/llm/__init__.py. `LLMConfig`, the greedy
`LLMEngine` (prefill, then single-token cached steps through the port's
`Transformer`: the decode kernel on the card), `LLMPredictor` and
`build_llm_deployment` (a Serve application over HTTP). The
continuous-batching engine is `llm/engine.py`, the OpenAI surface
`llm/openai.py` (`build_openai_app`). Not ported yet: `batch_inference`,
which runs on the data library, and the pipelined engine, which runs on
the compiled DAG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class LLMConfig:
    """reference llm_config.py (model_loading_config + engine args)."""

    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 8
    max_seq: int = 256
    max_new_tokens: int = 16
    seed: int = 0
    #: "bfloat16" halves cache/activation bytes; float32 keeps CPU-test
    #: numerics exact.
    dtype: str = "float32"
    #: optional trained weights: the port's state_dict, or a flax param
    #: tree of the reference (numpy leaves); random init otherwise
    params: Any = None


class LLMEngine:
    """Greedy-decoding engine over the flagship Transformer (the seat the
    reference gives vLLM). Prefill fills per-layer slot caches in one pass,
    then every generated token is one single-token step attending over the
    cache. `device` defaults to "cuda" and raises without it."""

    def __init__(self, cfg: LLMConfig, device="cuda"):
        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.llm.engine import _load_params, model_config
        from ray_tpu_torch.models.transformer import Transformer

        self.cfg = cfg
        self.device = resolve_device(device)
        mcfg = model_config(cfg)
        self.model = Transformer(mcfg, device=self.device, seed=cfg.seed)
        if cfg.params is not None:
            self.model.load_state_dict(_load_params(cfg.params))
        if mcfg.dtype == torch.bfloat16:
            self.model.to(torch.bfloat16)
        self.model.eval()

    def generate(self, prompts: np.ndarray,
                 max_new_tokens: Optional[int] = None) -> np.ndarray:
        """prompts: [B, S] int32 -> [B, S + new] (greedy, KV-cached)."""
        import torch

        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        n = max_new_tokens or self.cfg.max_new_tokens
        if s + n > self.cfg.max_seq:
            # The KV cache is a fixed [B, max_seq] buffer; requests past it
            # must fail loudly, not silently return fewer tokens.
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({n}) exceeds the engine's "
                f"max_seq ({self.cfg.max_seq})")
        dev = self.device
        with torch.no_grad():
            toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
            cache = self.model.new_cache(b)
            positions = torch.arange(s, device=dev).expand(b, s)
            logits = self.model(toks, positions=positions, cache=cache)
            nxt = logits[:, -1].argmax(-1)
            out = [nxt]
            for i in range(n - 1):
                pos = torch.full((b, 1), s + i, dtype=torch.long, device=dev)
                logits = self.model(nxt[:, None], positions=pos, cache=cache)
                nxt = logits[:, -1].argmax(-1)
                out.append(nxt)
            gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return np.concatenate([prompts, gen], axis=1)


class LLMPredictor:
    """map_batches callable class (reference batch processor's stateful
    UDF): the engine loads once per actor."""

    def __init__(self, cfg: LLMConfig, device="cuda"):
        self.engine = LLMEngine(cfg, device=device)

    def __call__(self, batch: dict) -> dict:
        out = self.engine.generate(np.asarray(batch["tokens"]))
        return {"tokens": batch["tokens"], "generated": out}


def __getattr__(name):
    # Lazy: the engine and the OpenAI surface import the model and torch.
    if name in ("ContinuousEngine", "SamplingParams", "GenStream"):
        from ray_tpu_torch.llm import engine as _e

        return getattr(_e, name)
    if name in ("build_openai_app", "OpenAIServer", "ByteTokenizer"):
        from ray_tpu_torch.llm import openai as _o

        return getattr(_o, name)
    raise AttributeError(name)


def build_llm_deployment(cfg: LLMConfig, *, name: str = "llm",
                         num_replicas: int = 1,
                         ray_actor_options: Optional[dict] = None,
                         device="cuda"):
    """A Serve application serving generate() over HTTP/handle (reference
    llm_server.py build_llm_deployment). Each replica builds its engine
    on `device`."""
    from ray_tpu_torch import serve

    @serve.deployment(name=name, num_replicas=num_replicas,
                      ray_actor_options=ray_actor_options)
    class LLMServer:
        def __init__(self, llm_cfg: LLMConfig, device):
            self.engine = LLMEngine(llm_cfg, device=device)

        def __call__(self, request):
            body = request.json()
            prompts = np.asarray(body["tokens"], np.int32)
            if prompts.ndim == 1:
                prompts = prompts[None]
            out = self.engine.generate(
                prompts, body.get("max_new_tokens"))
            return {"generated": out.tolist()}

    return LLMServer.bind(cfg, device)
