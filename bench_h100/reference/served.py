"""The comparison that judges a served model's greedy tokens.

For each judged request the reference runs once over its prompt and its
served tokens (teacher-forced, float32, TF32 off) and reads, at every
position that produced a served token, how far that token's logit lies
below the reference's best there. The reading is the widest such gap.

With `control`, the same pass is also computed in float8 (the control, the
reference in the precision below the served bfloat16), and its reading is
the widest gap of the token the control puts first at each of those
positions, judged by the float32 logits.

The weights are streamed: each layer is drawn on the host, moved to the
card, applied to every judged sequence and dropped, so the reference holds
one layer at a time.
"""

from __future__ import annotations

import torch

from reference.model import (Precision, Widths, WeightStream, block, logits,
                             tf32_off)


def judge(w: Widths, seed: int, seqs: list, device, control: bool = False,
          q_block: int = 512) -> dict:
    """seqs: [(prompt ids, served ids), ...] of greedy requests. Returns
    the widest gap of the served tokens (`program_gap`), per request, and
    with `control` the control's (`control_gap`)."""
    tf32_off()
    precs = {"reference": Precision("f32")}
    if control:
        precs["control"] = Precision("fp8")
    stream = WeightStream(w, seed)
    with torch.no_grad():
        emb = stream.embedding().to(device)
        hs = {}
        for key in precs:
            hs[key] = [emb[torch.as_tensor(list(p) + list(s[:-1]),
                                           device=device)] for p, s in seqs]
        for i in range(w.n_layers):
            p = {k: v.to(device) for k, v in stream.layer(i).items()}
            for key, prec in precs.items():
                hs[key] = [block(x, p, w, prec, q_block) for x in hs[key]]
            del p
        final = torch.ones(w.d_model, device=device)
        out = {"program_gap": 0.0, "tokens": 0, "per_request": []}
        if control:
            out["control_gap"] = 0.0
        for j, (prompt, served) in enumerate(seqs):
            rows = slice(len(prompt) - 1, len(prompt) - 1 + len(served))
            ref = logits(hs["reference"][j][rows], final, emb, w,
                         precs["reference"])
            best = ref.max(dim=-1).values
            got = torch.as_tensor(list(served), device=device)[:, None]
            gap = float((best - ref.gather(1, got)[:, 0]).max())
            row = {"prompt_len": len(prompt), "served": len(served),
                   "gap": gap}
            out["program_gap"] = max(out["program_gap"], gap)
            if control:
                ctl = logits(hs["control"][j][rows], final, emb, w,
                             precs["control"])
                first = ctl.argmax(dim=-1)[:, None]
                cgap = float((best - ref.gather(1, first)[:, 0]).max())
                row["control_gap"] = cgap
                out["control_gap"] = max(out["control_gap"], cgap)
            out["tokens"] += len(served)
            out["per_request"].append(row)
    return out
