"""tpot_p90_ms.chat: the 90th percentile of (last token - first token) /
(tokens - 1) at the client, over the requests that finished in the part of
the window before the profile capture."""


def read(run: dict):
    pre = run.get("pre")
    return pre.get("tpot_p90_ms") if pre else None
