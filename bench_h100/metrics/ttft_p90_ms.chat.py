"""ttft_p90_ms.chat: the 90th percentile of the time from send to first
token at the client, over the requests sent in the part of the window
before the profile capture; a request that failed or never answered
counts until the client gave up on it."""


def read(run: dict):
    pre = run.get("pre")
    return pre.get("ttft_p90_ms") if pre else None
