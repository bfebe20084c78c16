"""mfu.train (%): a step's model FLOPs (6 x matmul parameters x tokens and
the attention's forward products three times) times the steps of the
window, over the window, against 989 TFLOP/s of bf16."""

from harness.roofline import BF16_FLOPS


def read(run: dict):
    tr = run.get("train")
    if not tr or not tr["steps"]:
        return None
    return 100.0 * tr["step_flops"] * tr["steps"] / tr["window_s"] / BF16_FLOPS
