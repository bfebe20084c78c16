"""Quantiles, and the reduction of a serving window's client records.

Every rate is the work of the whole window over the window's seconds, and
every tail is over every request the window holds: a stall anywhere in
the window moves them. A request that failed, or never answered, counts
with the time until the client gave up on it, so it misses any limit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def quantile(values, q: float) -> float:
    """The q-quantile (0 <= q <= 1) by linear interpolation between the
    order statistics (numpy's "linear", statistics.quantiles' "inclusive").
    Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class RequestRecord:
    """One request as its client saw it (times on one host clock, in
    seconds)."""

    index: int
    prompt_len: int
    max_tokens: int
    greedy: bool
    sent: float
    #: arrival time and token count of each streamed event with tokens
    chunks: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    finish_reason: str | None = None
    #: set when the request failed or the client gave up on it
    error: str | None = None
    given_up: float | None = None

    @property
    def first(self) -> float | None:
        return self.chunks[0][0] if self.chunks else None

    @property
    def last(self) -> float | None:
        return self.chunks[-1][0] if self.chunks else None

    @property
    def finished(self) -> bool:
        return self.error is None and self.finish_reason is not None

    @property
    def answered(self) -> bool:
        """It streamed a first token and no error."""
        return self.first is not None and self.error is None

    def ttft(self) -> float:
        """Send to first token; a request with no first token counts until
        the client gave up on it."""
        if self.first is not None:
            return self.first - self.sent
        return (self.given_up or self.sent) - self.sent


@dataclass
class Window:
    """[start, end) on the clients' clock."""

    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def holds(self, t: float | None) -> bool:
        return t is not None and self.start <= t < self.end


def tokens_in(records, window: Window) -> int:
    """Tokens of every event that reached a client inside the window."""
    return sum(n for r in records for t, n in r.chunks if window.holds(t))


def sent_in(records, window: Window) -> list:
    return [r for r in records if window.holds(r.sent)]


def finished_in(records, window: Window) -> list:
    """Requests whose last token arrived inside the window, complete."""
    return [r for r in records if r.finished and window.holds(r.last)]


def tpot(r: RequestRecord) -> float | None:
    """(last token - first token) / (tokens - 1), at the client."""
    n = len(r.tokens)
    if n < 2:
        return None
    return (r.last - r.first) / (n - 1)


def timeline(records, window: Window, bin_s: float = 1.0) -> list:
    """Tokens that reached the clients in each bin_s of the window."""
    bins = [0] * max(1, math.ceil(window.seconds / bin_s))
    for r in records:
        for t, n in r.chunks:
            if window.holds(t):
                bins[min(len(bins) - 1, int((t - window.start) / bin_s))] += n
    return bins


def longest_silence(records, window: Window) -> float:
    """The longest stretch of the window in which no client received a
    token, in seconds."""
    times = sorted(t for r in records for t, _ in r.chunks if window.holds(t))
    edges = [window.start] + times + [window.end]
    return max(b - a for a, b in zip(edges, edges[1:]))


def serving_summary(records, window: Window) -> dict:
    """The end-to-end readings of a serving window and their sample
    counts."""
    sent = sent_in(records, window)
    done = finished_in(records, window)
    ttfts = [r.ttft() for r in sent]
    tpots = [x for x in (tpot(r) for r in done) if x is not None]
    out = {
        "window_s": window.seconds,
        "tokens": tokens_in(records, window),
        "sent": len(sent),
        "failed": sum(1 for r in sent if not r.answered),
        "finished": len(done),
        "ttft_samples": len(ttfts),
        "tpot_samples": len(tpots),
    }
    out["output_tokens_per_s"] = out["tokens"] / window.seconds
    if ttfts:
        out["ttft_p50_ms"] = 1e3 * quantile(ttfts, 0.5)
        out["ttft_p90_ms"] = 1e3 * quantile(ttfts, 0.9)
    if tpots:
        out["tpot_p50_ms"] = 1e3 * quantile(tpots, 0.5)
        out["tpot_p90_ms"] = 1e3 * quantile(tpots, 0.9)
    return out
