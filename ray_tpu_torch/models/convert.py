"""Carry weights from the JAX package's flax Transformer to the port.

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
    final_norm/scale             -> final_norm.scale
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)$")


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state_dict (CPU
    tensors of the leaves' dtypes; load_state_dict moves them)."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def put(key, leaf):
        out[key] = torch.from_numpy(np.array(leaf, copy=True))

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
                else:
                    raise ValueError(
                        f"unsupported flax module {name}/{part} (MoE is not "
                        f"ported)")
        else:
            raise ValueError(f"unknown flax param {name!r}")
    return out
