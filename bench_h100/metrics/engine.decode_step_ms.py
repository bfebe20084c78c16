"""engine.decode_step_ms: the part of the window before the profile
capture, over the decode steps the replica's /v1/stats counted in it."""


def read(run: dict):
    pre = run.get("pre")
    if not pre or not pre["decode_steps"]:
        return None
    return 1e3 * pre["window_s"] / pre["decode_steps"]
