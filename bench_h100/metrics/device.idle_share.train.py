"""device.idle_share.train (%): the share of the profiled training steps'
window in which no kernel, copy or memset ran on the card."""


def read(run: dict):
    prof = run.get("profile")
    if not prof or run.get("kind") != "train_batches":
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
