"""decode_attention.ms_per_step: the decode kernel's device time in the
replica's profile over the decode steps in it (its launches over the
layers: one launch a layer a step)."""


def read(run: dict):
    cap = run.get("capture")
    if not cap or not cap["decode_launches"]:
        return None
    steps = cap["decode_launches"] / run["widths"]["n_layers"]
    return 1e3 * cap["decode_kernel_s"] / steps
