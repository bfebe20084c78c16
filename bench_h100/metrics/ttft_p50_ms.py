"""ttft_p50_ms: the median time to first token at the client, over the
requests sent in the part of the window before the profile capture."""


def read(run: dict):
    pre = run.get("pre")
    return pre.get("ttft_p50_ms") if pre else None
