"""Models of the port. Counterpart: ray_tpu/models/."""

from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              loss_fn)

__all__ = ["MLP", "Transformer", "TransformerConfig", "loss_fn"]
