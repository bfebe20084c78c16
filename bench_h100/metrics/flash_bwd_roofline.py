"""flash_bwd_roofline (%): the flash backward's bound at the cell's shape
(four products, harness/roofline.py) over the device time per call of its
kernels (prep, main, conversions) in the profile."""

from harness import roofline


def read(run: dict):
    tr, prof = run.get("train"), run.get("profile")
    if not prof or not prof.get("flash_bwd_s"):
        return None
    w = tr["widths"]
    hd = w["d_model"] // w["n_heads"]
    b = roofline.flash_backward(tr["batch"], tr["seq_len"], tr["seq_len"],
                                w["n_heads"], w["n_kv_heads"], hd)
    return 100.0 * b["bound_s"] / prof["flash_bwd_s"]
