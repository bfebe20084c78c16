"""Compute kernels of the port: plain PyTorch versions and hand-written
CUDA kernels for Hopper, behind one surface the models call.

Counterpart: ray_tpu/ops/__init__.py.
"""

from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.decode_attention import decode_attention
from ray_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["decode_attention", "dot_product_attention", "flash_attention"]
