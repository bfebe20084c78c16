"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

It sits beside the JAX package (`ray_tpu`), which stays the reference it is
held against, and imports nothing of it: no jax, flax, optax or ray_tpu
module. Every Pallas kernel of the reference on a ported path is a CUDA
kernel written by hand for Hopper (`ops/csrc/`), built at first use; so is
the gradient of flash attention, which training runs.

Entry points take `device=`, default to "cuda" and raise where CUDA is
missing; pass device="cpu" to run the plain PyTorch versions instead.

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm.openai import OpenAIServer, build_openai_app
    from ray_tpu_torch.models import MLP, Transformer, loss_fn

The distributed runtime (tasks, actors, objects) and Serve are the
reference's, copied: `ray_tpu_torch.init()`, `remote`, `get`, `put`,
`wait`, `kill`, `get_actor`, `method`, `shutdown`, and
`ray_tpu_torch.serve`. Those names load on first use, so importing the
models or the kernels starts no runtime module.
"""

__version__ = "0.1.0"

from ray_tpu_torch import exceptions  # noqa: F401,E402

#: Names served by `_private/api.py` (the counterpart of ray_tpu/__init__.py).
_API = frozenset({
    "init", "shutdown", "is_initialized", "remote", "put", "get", "wait",
    "cancel", "kill", "get_actor", "method", "ObjectRef",
    "ObjectRefGenerator", "ActorHandle", "cluster_resources",
    "available_resources", "nodes", "timeline",
})


def __getattr__(name):
    if name in _API:
        from ray_tpu_torch._private import api

        return getattr(api, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
