"""mfu.chat (%): the model FLOPs of what was served before the profile
capture (each prompt whose first token came then, with no bucket padding,
and each generated token at its context length; no step of a retired
slot) over that time, against 989 TFLOP/s of bf16."""

from harness.roofline import BF16_FLOPS


def read(run: dict):
    pre = run.get("pre")
    if not pre or not pre["model_flops"]:
        return None
    return 100.0 * pre["model_flops"] / pre["window_s"] / BF16_FLOPS
