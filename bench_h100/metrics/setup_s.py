"""setup_s: seconds from the process's start to the window's opening,
build, weights, warm-up and (serving) the clients' ramp included."""


def read(run: dict):
    return run.get("setup_s")
