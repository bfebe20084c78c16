"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

It sits beside the JAX package (`ray_tpu`), which stays the reference it is
held against, and imports nothing of it: no jax, flax, optax or ray_tpu
module. Every Pallas kernel of the reference on a ported path is a CUDA
kernel written by hand for Hopper (`ops/csrc/`), built at first use.

Entry points take `device=`, default to "cuda" and raise where CUDA is
missing; pass device="cpu" to run the plain PyTorch versions instead.

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import OpenAIServer
"""

__version__ = "0.1.0"
