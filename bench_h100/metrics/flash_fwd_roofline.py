"""flash_fwd_roofline (%): the flash forward's bound at the cell's shape
(harness/roofline.py) over its device time per launch in the profile."""

from harness import roofline


def read(run: dict):
    tr, prof = run.get("train"), run.get("profile")
    if not prof or not prof.get("flash_fwd_s"):
        return None
    w = tr["widths"]
    hd = w["d_model"] // w["n_heads"]
    b = roofline.flash_forward(tr["batch"], tr["seq_len"], tr["seq_len"],
                               w["n_heads"], w["n_kv_heads"], hd)
    return 100.0 * b["bound_s"] / prof["flash_fwd_s"]
