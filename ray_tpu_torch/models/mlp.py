"""Small MLP (MNIST-class), the minimum end-to-end training model.

Counterpart: ray_tpu/models/mlp.py. Three dense layers with biases and ReLU
between them, kept in the flax layout (kernel [in, out], bias [out]) so
`convert.mlp_params_from_flax` carries JAX weights across by renaming.
Unlike flax, which infers the input width at init, the port takes it as
`in_features`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device


class Dense(nn.Module):
    """x @ kernel + bias, kernel [in, out] (flax's nn.Dense)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """x [B, ...] (flattened per example) -> logits [B, n_classes].

    Kernels start lecun-normal from `seed` (drawn on the CPU, the same on
    every device), biases at zero. `device` defaults to "cuda" and raises
    where there is no CUDA."""

    def __init__(self, in_features: int, hidden: int = 128,
                 n_classes: int = 10, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        widths = (in_features, hidden, hidden, n_classes)
        self.dense = nn.ModuleList(Dense(a, b, device=dev)
                                   for a, b in zip(widths, widths[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.dense:
                w = layer.kernel
                w.copy_(torch.empty(w.shape).normal_(
                    0.0, w.shape[0] ** -0.5, generator=gen))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)


def loss_fn(model: MLP, batch):
    """Mean cross entropy of the logits of x against the int labels y."""
    x, y = batch
    logp = F.log_softmax(model(x), dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()
