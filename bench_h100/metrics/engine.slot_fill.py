"""engine.slot_fill (%): tokens delivered to clients before the profile
capture, over the decode steps in that time times the engine's slots."""


def read(run: dict):
    pre = run.get("pre")
    if not pre or not pre["decode_steps"]:
        return None
    return 100.0 * pre["tokens"] / (pre["decode_steps"] * pre["max_batch"])
