"""The comparison that judges a training step.

The reference follows the program's first three steps from the same seeded
weights on the same batches: next-token cross entropy (mean over every
position of the batch), its gradient, and Adam (lr from the mix, betas
0.9 / 0.999, eps 1e-8, bias-corrected), in float32 with TF32 off. It runs a
row of the batch at a time, each layer recomputed in the backward
(checkpointed), so that it fits beside nothing else on the card.

Three numbers are compared, each as the gap between the program's and the
reference's reading, not the size of their difference:

- `loss`: the largest relative gap of the three steps' losses;
- `grad`: over the leaves, the largest gap between the norms of the first
  gradient (as the optimizer got it: its first moment after one step over
  1 - beta1), relative to the reference leaf's norm or the median leaf's,
  whichever is larger;
- `change`: the same for the norm of each leaf's change after three
  steps. Leaves whose reference gradient is under a thousandth of the
  median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.model import (Precision, Widths, WeightStream, block, logits,
                             tf32_off)

BETAS = (0.9, 0.999)
EPS = 1e-8
#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of `change`
TINY_GRAD = 1e-3


def reference_steps(w: Widths, seed: int, batches: list, lr: float, device,
                    precision: str = "f32") -> dict:
    """Three (or len(batches)) Adam steps of the reference. Returns the
    losses, the first gradient's norm per leaf, each leaf's change norm,
    and the initial weights (host) the changes are taken from."""
    tf32_off()
    prec = Precision(precision)
    p0 = WeightStream(w, seed).all()
    params = {k: v.to(device, copy=True).requires_grad_(True)
              for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    layers = [{name: params[f"layers.{i}.{name}"] for name in
               [k.split(".", 2)[2] for k in params
                if k.startswith(f"layers.{i}.")]}
              for i in range(w.n_layers)]
    losses, grad_norms = [], {}
    for t, toks in enumerate(batches, 1):
        toks = torch.as_tensor(toks, device=device)
        total = toks.shape[0] * (toks.shape[1] - 1)
        loss_sum = 0.0
        for row in toks:
            x = params["tok_emb"][row[:-1]]
            for lp in layers:
                x = checkpoint(lambda h, lp=lp: block(h, lp, w, prec), x,
                               use_reentrant=False)
            lg = logits(x, params["final_norm.scale"], params["tok_emb"], w,
                        prec)
            nll = F.cross_entropy(lg, row[1:], reduction="sum")
            (nll / total).backward()
            loss_sum += float(nll.detach())
            del x, lg, nll
        losses.append(loss_sum / total)
        with torch.no_grad():
            if t == 1:
                grad_norms = {k: float(p.grad.double().norm())
                              for k, p in params.items()}
            bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            for k, p in params.items():
                g = p.grad
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                p.sub_(lr * (m[k] / bc1) / ((v2[k] / bc2).sqrt() + EPS))
                p.grad = None
    with torch.no_grad():
        change = {k: float((p.detach() - p0[k].to(device)).double().norm())
                  for k, p in params.items()}
    del params, m, v2
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "p0": p0}


def change_norms(after: dict, p0: dict, device) -> dict:
    """Each leaf's change norm from the initial weights `p0` to `after`
    (host tensors), taken a leaf at a time on the card."""
    with torch.no_grad():
        return {k: float((after[k].to(device) - p0[k].to(device))
                         .double().norm()) for k in p0}


def _worst(got: dict, want: dict, keys) -> tuple[float, str]:
    """The largest |got - want| / max(want, median of want) over keys."""
    med = statistics.median(want[k] for k in keys)
    worst, leaf = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def readings(program: dict, ref: dict) -> dict:
    """The three compared numbers of `program` (losses, grad_norms,
    change_norms) against the reference's."""
    steps = [abs(a - b) / abs(b)
             for a, b in zip(program["losses"], ref["losses"])]
    keys = sorted(ref["grad_norms"])
    grad, grad_leaf = _worst(program["grad_norms"], ref["grad_norms"], keys)
    med = statistics.median(ref["grad_norms"][k] for k in keys)
    moved = [k for k in keys if ref["grad_norms"][k] >= TINY_GRAD * med]
    change, change_leaf = _worst(program["change_norms"],
                                 ref["change_norms"], moved)
    return {"loss": max(steps), "loss_steps": steps, "grad": grad,
            "change": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(keys) - set(moved))}
