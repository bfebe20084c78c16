"""device.idle_share.chat (%): the share of the replica's profiled window
in which no kernel, copy or memset ran on the card."""


def read(run: dict):
    cap = run.get("capture")
    if not cap or run.get("kind") != "closed_loop":
        return None
    return 100.0 * (1.0 - cap["busy_s"] / cap["window_s"])
