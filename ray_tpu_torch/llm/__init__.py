"""ray_tpu_torch.llm — LLM serving on the port.

Counterpart: ray_tpu/llm/__init__.py. This slice has `LLMConfig`, the
continuous-batching engine (`llm/engine.py`) and the OpenAI surface
(`llm/openai.py`, served through `OpenAIServer.__call__`). `LLMEngine`,
`batch_inference`, `build_llm_deployment`, `build_openai_app` and the
pipelined engine are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


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


def __getattr__(name):
    # Lazy: the engine and the OpenAI surface import the model and torch.
    if name in ("ContinuousEngine", "SamplingParams", "GenStream"):
        from ray_tpu_torch.llm import engine as _e

        return getattr(_e, name)
    if name in ("OpenAIServer", "ByteTokenizer"):
        from ray_tpu_torch.llm import openai as _o

        return getattr(_o, name)
    raise AttributeError(name)
