"""Carry weights from the JAX package's flax models to the port.

`params_from_flax` takes the tree that `ray_tpu.models.transformer.
Transformer.init` returns, as numpy arrays (with or without the outer
"params" key), and returns a `state_dict` for
`ray_tpu_torch.models.transformer.Transformer`. The port keeps the flax
layouts, so the conversion is a renaming:

    tok_emb                      -> tok_emb            [vocab, d_model]
    layer_{i}/attn_norm/scale    -> layers.{i}.attn_norm.scale
    layer_{i}/attn/w{q,k,v}/kernel -> layers.{i}.attn.w{q,k,v} [d_model, H, hd]
    layer_{i}/attn/wo/kernel     -> layers.{i}.attn.wo  [H, hd, d_model]
    layer_{i}/mlp_norm/scale     -> layers.{i}.mlp_norm.scale
    layer_{i}/mlp/w_*/kernel     -> layers.{i}.mlp.w_*  [in, out]
    layer_{i}/moe/router         -> layers.{i}.moe.router [d_model, E]
    layer_{i}/moe/w_{gate,up}    -> layers.{i}.moe.w_*  [E, d_model, d_ff]
    layer_{i}/moe/w_down         -> layers.{i}.moe.w_down [E, d_ff, d_model]
    final_norm/scale             -> final_norm.scale

`mlp_params_from_flax` does the same for `ray_tpu.models.mlp.MLP` and
`ray_tpu_torch.models.mlp.MLP`: Dense_{i}/{kernel,bias} -> dense.{i}.*.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)$")


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True))


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state_dict (CPU
    tensors of the leaves' dtypes; load_state_dict moves them)."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def put(key, leaf):
        out[key] = _tensor(leaf)

    for name, sub in tree.items():
        if name == "tok_emb":
            put("tok_emb", sub)
        elif name == "final_norm":
            put("final_norm.scale", sub["scale"])
        elif (m := _LAYER.match(name)):
            prefix = f"layers.{m.group(1)}"
            for part, mod in sub.items():
                if part in ("attn_norm", "mlp_norm"):
                    put(f"{prefix}.{part}.scale", mod["scale"])
                elif part in ("attn", "mlp"):
                    for w, leaves in mod.items():
                        put(f"{prefix}.{part}.{w}", leaves["kernel"])
                elif part == "moe":  # raw params, not Dense kernels
                    for w, leaf in mod.items():
                        put(f"{prefix}.moe.{w}", leaf)
                else:
                    raise ValueError(f"unsupported flax module {name}/{part}")
        else:
            raise ValueError(f"unknown flax param {name!r}")
    return out


def mlp_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax MLP param tree (numpy leaves; Dense_0..Dense_2, each a kernel
    [in, out] and a bias [out]) -> the port MLP's state_dict."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for name, leaves in tree.items():
        m = re.fullmatch(r"Dense_(\d+)", name)
        if m is None:
            raise ValueError(f"unknown flax MLP param {name!r}")
        for leaf in ("kernel", "bias"):
            out[f"dense.{m.group(1)}.{leaf}"] = _tensor(leaves[leaf])
    return out
